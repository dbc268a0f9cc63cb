"""The port stands alone: no module of pcgan_tpu_torch and no line of
chip_smoke.py imports jax, flax, the JAX package pcgan_tpu or the JAX
side's benchmarks folder (the port keeps its own copy of the torch mirror,
``utils/pth_mirror.py``).

Checked on the source (AST), not on sys.modules: the test process itself
imports jax (tests/conftest.py), so a module's import-time effects would not
show which package pulled it in.
"""

import ast
import glob
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "pcgan_tpu", "benchmarks", "torch_baseline")
FILES = sorted(glob.glob(os.path.join(ROOT, "pcgan_tpu_torch", "**", "*.py"),
                         recursive=True)) + [os.path.join(ROOT, "chip_smoke.py")]


def forbidden(module: str) -> bool:
    # whole-name prefix match: pcgan_tpu and pcgan_tpu.x, never pcgan_tpu_torch
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_forbidden_prefix_rule():
    assert forbidden("jax") and forbidden("jax.numpy") and forbidden("flax.linen")
    assert forbidden("pcgan_tpu") and forbidden("pcgan_tpu.ops.preprocess")
    assert not forbidden("pcgan_tpu_torch") and not forbidden("pcgan_tpu_torch.ops")
    assert not forbidden("jaxlib_like") and not forbidden("numpy")
    assert forbidden("benchmarks.torch_baseline") and forbidden("torch_baseline")


def test_files_exist():
    assert os.path.isfile(FILES[-1]), "chip_smoke.py missing at the repo root"
    assert len(FILES) > 10
    rel = {os.path.relpath(f, ROOT) for f in FILES}
    assert {"pcgan_tpu_torch/tools/bench_lowch.py",
            "pcgan_tpu_torch/train_main.py",
            # the serving family and int8 PTQ
            "pcgan_tpu_torch/serving.py", "pcgan_tpu_torch/client.py",
            "pcgan_tpu_torch/ops/quant.py",
            "pcgan_tpu_torch/tools/export_serving.py",
            "pcgan_tpu_torch/tools/serve_http.py",
            "pcgan_tpu_torch/tools/loadtest.py",
            "pcgan_tpu_torch/data/device_cache.py",
            "pcgan_tpu_torch/utils/summary.py"} <= rel
    # the tools (the JAX bench, tools/ and utils/pth_*, profiling)
    assert {"pcgan_tpu_torch/bench.py",
            "pcgan_tpu_torch/utils/profiling.py",
            "pcgan_tpu_torch/utils/pth_import.py",
            "pcgan_tpu_torch/utils/pth_export.py",
            "pcgan_tpu_torch/utils/pth_mirror.py",
            *(f"pcgan_tpu_torch/tools/{t}.py" for t in (
                "profile_step", "profile_e2e", "tune_batch", "memory_plan",
                "doctor", "average_ckpts", "compare_runs", "plot_losses",
                "sweep", "export_pth", "import_pth"))} <= rel


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [(line, mod) for line, mod in imported_modules(path)
           if forbidden(mod)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
