"""Environment diagnostic (counterpart of ``tools/doctor.py``): is this
machine ready to train and serve with the port?

    python -m pcgan_tpu_torch.tools.doctor [training flags] [--device cpu]

Reports, in order: the versions of python, torch, CUDA, cuDNN and numpy;
the devices, the card's name, total memory and power limit (from
``nvidia-smi``); where ``nvcc`` is and the build of both hand kernels (B1
``csrc/preprocess.cu``, B2 ``csrc/wgrad.cu``; a failed build raises with
the compiler's error, so the command exits non-zero); the JPEG decoder's
build and the libjpeg it links (the host's or Pillow's wheel's), or that
the host has none; host decode workers against the usable cores; the world
size (``WORLD_SIZE`` under torchrun, else 1) and the mesh (``{axis:
size}``) the flags would build over it, or why they cannot; under a
spatial axis > 1 the band plan (each layer height's rows a rank and its conv's halo rows); the
XLA-only flags, which raise in the port; and a device check: one small
matmul on the device and, on the card, one launch of B1 against its plain
version. Prints one human block and ONE final JSON line. On the CPU the
kernels are not built: the plain versions run there.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

XLA_ONLY = ("--xla_opt", "--compile_cache", "--profile_server")


def _power_limit():
    """nvidia-smi's ``name, power.limit`` line, or None without the tool."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    r = subprocess.run([smi, "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def _decoder() -> str:
    from pcgan_tpu_torch import native
    from pcgan_tpu_torch.ops import _build
    try:
        lib = native.load()
    except native.JpegUnavailable as e:
        return f"unavailable (no libjpeg on this host; PNG folders only): {e}"
    route = ("Pillow's wheel libjpeg " + os.path.basename(
        _build.wheel_libjpeg()) if "_wheel_" in os.path.basename(lib._name)
        else "the host's libjpeg (-ljpeg)")
    return f"ok, libjpeg ABI {native.jpeg_abi()}, linked to {route}"


def _device_check(torch, device) -> str:
    v = float((torch.ones(8, 8, device=device)
               @ torch.ones(8, 8, device=device)).sum())
    if v != 512.0:
        return f"unexpected value {v}"
    if device.type != "cuda":
        return "ok"
    from pcgan_tpu_torch.ops.cuda_preprocess import preprocess_batch_cuda
    from pcgan_tpu_torch.ops.preprocess import preprocess_batch
    g = torch.Generator().manual_seed(0)
    imgs = torch.randint(0, 256, (2, 20, 20, 3), dtype=torch.uint8,
                         generator=g)
    cy, cx = torch.tensor([0, 2]), torch.tensor([1, 0])
    flip = torch.tensor([False, True])
    want = preprocess_batch(imgs, cy, cx, flip, 18, 16)
    got = preprocess_batch_cuda(imgs.to(device), cy, cx, flip, 18, 16).cpu()
    err = float((got - want).abs().max())
    return "ok" if err <= 2e-5 else f"B1 off its plain version by {err:.3g}"


def main(argv=None) -> dict:
    from pcgan_tpu_torch.config import parse_config
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg = parse_config(argv, is_train=True)

    import numpy as np
    import torch
    from pcgan_tpu_torch.device import resolve_device
    device = resolve_device(cfg.run.device)
    cuda = device.type == "cuda"
    rep = {"versions": {
        "python": sys.version.split()[0], "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cudnn": torch.backends.cudnn.version() if cuda else None,
        "numpy": np.__version__}}
    rep["device"] = device.type
    if cuda:
        n = torch.cuda.device_count()
        rep["devices"] = [torch.cuda.get_device_name(i) for i in range(n)]
        props = torch.cuda.get_device_properties(device)
        rep["card"] = props.name
        rep["memory_gib"] = round(props.total_memory / 2 ** 30, 2)
        rep["power_limit"] = _power_limit()
    else:
        rep["devices"] = ["cpu"]

    if cuda:
        from pcgan_tpu_torch.ops import _build, cuda_preprocess, cuda_wgrad
        rep["nvcc"] = _build.find_nvcc()
        cuda_preprocess.build()
        cuda_wgrad.build()
        rep["kernels"] = {"B1 preprocess": "built", "B2 wgrad": "built"}
    else:
        rep["nvcc"] = shutil.which("nvcc")
        rep["kernels"] = "not built (--device cpu: the plain versions run)"
    rep["jpeg_decoder"] = _decoder()

    try:
        host_cores = len(os.sched_getaffinity(0))
    except AttributeError:
        host_cores = os.cpu_count() or 1
    rep["host_cores"] = host_cores
    if host_cores < cfg.data.num_threads:
        rep["loader_warning"] = (
            f"--num_threads {cfg.data.num_threads} > {host_cores} usable "
            f"core(s): host decode may bottleneck e2e — consider "
            f"--dataset_mode packed or --device_cache")

    from pcgan_tpu_torch.parallel.mesh import SPATIAL, check_mesh_shape
    from pcgan_tpu_torch.parallel.spatial import band_plan
    world = int(os.environ.get("WORLD_SIZE", 1))
    rep["world_size"] = world
    try:
        # the mesh these flags would build over this world
        dims = check_mesh_shape(cfg.parallel.mesh_shape, world)
        rep["mesh"] = {a: int(n) for a, n in zip(cfg.parallel.mesh_axes,
                                                 dims)}
        if rep["mesh"].get(SPATIAL, 1) > 1:
            rep["band_plan"] = band_plan(cfg, rep["mesh"][SPATIAL])
    except (NotImplementedError, ValueError) as e:
        rep["mesh"] = f"FAILED: {e}"
    rep["xla_only_flags"] = {f: "raises (XLA-only)" for f in XLA_ONLY}
    rep["device_check"] = _device_check(torch, device)

    for k, v in rep.items():
        print(f"{k:18s} {v}")
    print(json.dumps({"doctor": rep}, default=str), flush=True)
    return rep


if __name__ == "__main__":
    main()
