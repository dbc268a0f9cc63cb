"""The port stands alone: no module of pcgan_tpu_torch and no line of
chip_smoke.py imports jax, flax or the JAX package pcgan_tpu.

Checked on the source (AST), not on sys.modules: the test process itself
imports jax (tests/conftest.py), so a module's import-time effects would not
show which package pulled it in.
"""

import ast
import glob
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "pcgan_tpu")
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


def test_files_exist():
    assert os.path.isfile(FILES[-1]), "chip_smoke.py missing at the repo root"
    assert len(FILES) > 10
    rel = {os.path.relpath(f, ROOT) for f in FILES}
    assert {"pcgan_tpu_torch/tools/bench_lowch.py",
            "pcgan_tpu_torch/train_main.py"} <= rel


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    bad = [(line, mod) for line, mod in imported_modules(path)
           if forbidden(mod)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
