"""Build the port's native sources into shared libraries at first use.

Each ``csrc/*.cu`` file has a plain C entry point and is compiled by ``nvcc``
for ``sm_90a``; the host JPEG decoder ``native/jpeg_decoder.cc`` is
compiled by ``g++`` against libjpeg. Both land in ``build/pcgan_tpu_torch/``
at the repo root and are loaded with ctypes. A library is keyed by the hash
of its source and flags, so an edit rebuilds and an unchanged source is
reused. A file lock serializes concurrent first uses. There is no fallback:
a missing compiler or library, or a failed build, raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "pcgan_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
GXX_FLAGS = ("-O2", "-shared", "-fPIC")
GXX_LIBS = ("-ljpeg", "-lpthread")


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found (not on PATH, nor under CUDA_HOME); "
                       "the port's CUDA kernels are built from source at "
                       "first use")


def find_gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found on PATH; the port's JPEG decoder "
                       "(pcgan_tpu_torch/native/jpeg_decoder.cc) is built "
                       "from source at first use and needs g++ and libjpeg "
                       "(jpeglib.h, libjpeg.so)")


def _compile(name: str, src: str, compiler, flags, libs=()) -> str:
    """``lib<name>_<hash>.so`` of ``src`` built by ``compiler()`` with
    ``flags`` unless it is already built; returns the library path. The
    compiler's output (for nvcc, ``-Xptxas -v``'s registers, shared memory
    and spills) goes to ``<library>.log``."""
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(flags + libs).encode())
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, f"lib{name}_{key.hexdigest()[:16]}.so")
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.isfile(lib):
            tmp = f"{lib}.{os.getpid()}.tmp"
            r = subprocess.run([compiler(), *flags, "-o", tmp, src, *libs],
                               capture_output=True, text=True)
            with open(lib + ".log", "w") as log:
                log.write(r.stdout + r.stderr)
            if r.returncode != 0:
                raise RuntimeError(f"{os.path.basename(compiler())} failed "
                                   f"on {src} (exit {r.returncode}):\n"
                                   f"{r.stderr}")
            os.replace(tmp, lib)
    return lib


def build(name: str, source: str) -> str:
    """Compile ``csrc/<source>`` with nvcc; returns the library path."""
    return _compile(name, os.path.join(CSRC_DIR, source), find_nvcc,
                    NVCC_FLAGS)


def build_host(name: str, path: str) -> str:
    """Compile the host C++ file ``path`` (relative to the package) with
    g++ against libjpeg; returns the library path."""
    return _compile(name, os.path.join(_PKG_DIR, path), find_gxx, GXX_FLAGS,
                    GXX_LIBS)


def load(name: str, source: str) -> ctypes.CDLL:
    return ctypes.CDLL(build(name, source))
