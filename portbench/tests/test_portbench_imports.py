"""Nothing the benchmark runs imports JAX, flax, optax or the JAX package,
compared by whole top-level module names (``distdiff_tpu_torch`` is not
``distdiff_tpu``); the reference and the work counts import nothing of the
program either."""

import ast
import glob
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
BANNED = {"jax", "jaxlib", "flax", "optax", "distdiff_tpu"}
FILES = sorted(glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True))


def top_level_imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_import(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize("path", [p for p in FILES if os.sep + "reference" + os.sep in p
                                  or os.sep + "work" + os.sep in p],
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_and_work_stand_apart_from_the_program(path):
    assert "distdiff_tpu_torch" not in top_level_imports(path)


def test_top_level_names_compared_whole():
    from portbench.harness.cell import jax_modules

    assert "distdiff_tpu_torch" not in BANNED and "distdiff_tpu" in BANNED
    import distdiff_tpu_torch  # noqa: F401

    assert jax_modules() == [] or set(jax_modules()) <= BANNED


def test_a_run_loads_no_jax_module(tmp_path):
    """A whole tiny run in a fresh process, every module it imports at run
    time included, leaves no JAX module in ``sys.modules``."""
    code = (
        "import sys, tempfile\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from portbench.tests import tiny\n"
        "from portbench.harness import registry\n"
        "from portbench.harness.cell import run_cell, jax_modules\n"
        f"root = tiny.make_tree({str(tmp_path)!r}, limits={{'rms_levels': 1.0}})\n"
        "r = run_cell(registry.find_cell('tiny_tiny_guided', root=root), 3, 0.2, False, 'cpu',"
        " log=lambda s: None)\n"
        "assert r['correct'], r\n"
        "print('LOADED', jax_modules())\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout
