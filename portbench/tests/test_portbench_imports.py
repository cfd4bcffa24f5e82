"""What the benchmark may load: nothing under ``portbench/`` imports JAX,
its relatives or the JAX package (``mfnerf_tpu``; top-level names compared
whole, so ``mfnerf_tpu_torch`` is not it), the reference imports nothing
of the port, and a whole run leaves none of them in ``sys.modules``."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

from portbench import spec

REPO = pathlib.Path(__file__).resolve().parents[2]

SOURCES = sorted((REPO / "portbench").rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(REPO)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & set(spec.FORBIDDEN)


@pytest.mark.parametrize("path", sorted(
    (REPO / "portbench" / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "mfnerf_tpu_torch" not in top_level_imports(path)
    assert "portbench" not in top_level_imports(path)   # relative only


def test_forbidden_compares_whole_top_level_names():
    assert spec.forbidden_modules(
        ["mfnerf_tpu_torch", "mfnerf_tpu_torch.train", "jaxtyping",
         "numpy"]) == []
    assert spec.forbidden_modules(
        ["jax", "jax.numpy", "jaxlib", "flax.linen", "mfnerf_tpu.ops"]) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib", "mfnerf_tpu.ops"]


def test_a_run_loads_no_jax(tmp_path):
    """A whole CPU run in a fresh process: the harness exits 0 (it exits 3
    if a forbidden module was loaded) and the process holds none."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"sys.path.insert(0, {str(REPO / 'portbench' / 'tests')!r})\n"
        "from conftest import make_tiny_root\n"
        f"make_tiny_root({str(tmp_path)!r})\n"
        "from portbench import run, spec\n"
        "rc = run.main(['--workload', 'tiny_lowrank.tiny_train_flat',"
        " '--seed', '5', '--seconds', '0.2', '--trace', '0'],"
        f" root={str(tmp_path)!r}, device='cpu')\n"
        "print(json.dumps([rc, spec.forbidden_modules(sys.modules)]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[0, []]"
