"""What the benchmark may import. Nothing it runs on the card loads JAX,
flax or the JAX package ``pcgan_tpu`` (top-level names compared whole:
``pcgan_tpu_torch`` is the port); the plain reference imports nothing of
the port either, nor reads the old ``benchmarks/`` folder or the root
``bench.py``."""

import ast
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)
NEVER = {"jax", "jaxlib", "flax", "pcgan_tpu", "benchmarks", "bench"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for root, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_nor_the_jax_package(path):
    assert not set(_imports(path)) & NEVER


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_port(path):
    names = set(_imports(path))
    assert "pcgan_tpu_torch" not in names
    assert names <= {"__future__", "dataclasses", "typing", "numpy",
                     "torch", "portbench"}, names
    for mod in ast.walk(ast.parse(open(path).read())):
        if isinstance(mod, ast.ImportFrom) and mod.module and \
                mod.module.startswith("portbench."):
            assert mod.module.startswith("portbench.reference"), mod.module


def test_a_run_loads_no_jax():
    """A whole tiny run in a fresh process, then its modules."""
    code = (
        "import sys, time\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from portbench.tests.tiny_cells import SEED, tiny\n"
        "from portbench.harness.report import run_cell\n"
        "from portbench.harness.ranks import loaded_forbidden\n"
        "cell, extra = tiny('grid_utk128')\n"
        "line, _ = run_cell(cell, SEED, 0.5, False, time.time(), 'cpu',"
        " extra)\n"
        "assert line['correct'], line\n"
        "print('FORBIDDEN', loaded_forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_no_card_no_result():
    """Without the cards a cell asks for: non-zero, no result line."""
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "train_utk128_dp4", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
