"""Hygiene of the PyTorch port: it imports nothing of JAX or of the JAX
package, its entry points refuse to run quietly on the CPU, and only a CPU
tensor reaches a kernel's plain version."""

import ast
import os

import numpy as np
import pytest
import torch

from distdiff_tpu_torch.config import PipelineConfig, UNetConfig, VAEConfig
from distdiff_tpu_torch.models import AutoencoderKL, UNet2DConditionModel
from distdiff_tpu_torch.models.guide import create_model
from distdiff_tpu_torch.ops import attention, flash
from distdiff_tpu_torch.sampling import ExpansionPipeline

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "distdiff_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "distdiff_tpu")


def _port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PACKAGE):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, node.args[0].value


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 20  # the walk found the package
    bad = []
    for path in sources:
        for lineno, module in _imported_modules(path):
            top = module.split(".")[0]
            if top in FORBIDDEN:
                bad.append(f"{os.path.relpath(path, ROOT)}:{lineno} imports {module}")
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("entry", ["pipeline", "unet", "vae", "guide"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build = {
        "pipeline": lambda: ExpansionPipeline.create(PipelineConfig.tiny()),
        "unet": lambda: UNet2DConditionModel(UNetConfig.tiny()),
        "vae": lambda: AutoencoderKL(VAEConfig.tiny()),
        "guide": lambda: create_model("tiny_resnet", num_classes=3),
    }[entry]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()


def _bh_inputs(bh=2, tq=70, tk=300, d=40, seed=0):
    rng = np.random.RandomState(seed)
    q, do = (torch.from_numpy(rng.randn(bh, tq, d).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(bh, tk, d).astype(np.float32)) for _ in range(2))
    return q, k, v, do


def test_kernel_wrappers_take_the_plain_version_on_cpu_tensors():
    flash.reset_launch_counts()
    q, k, v, do = _bh_inputs()
    o, lse = flash.flash_fwd(q, k, v)
    ref_o, ref_lse = flash.flash_fwd_reference(q, k, v)
    # the same fp32 function on the same inputs: exact
    torch.testing.assert_close(o, ref_o, rtol=0, atol=0)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=0)
    delta = flash.attention_delta(o, do)
    want = flash.flash_bwd_reference(q, k, v, o, lse, do)
    got = (flash.flash_bwd_fused(q, k, v, do, lse, delta),
           (flash.flash_bwd_dq(q, k, v, do, lse, delta),)
           + flash.flash_bwd_dkv(q, k, v, do, lse, delta))
    for grads in got:
        for g, w in zip(grads, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    # attention over kv > 256 on the CPU also stays on the plain path
    attention.attention_hm(*(x.view(1, 2, *x.shape[1:]) for x in (q, k, v)))
    assert sum(flash.launch_counts.values()) == 0


@pytest.mark.parametrize("wrapper", ["flash_fwd", "flash_bwd_fused", "flash_bwd_dq",
                                     "flash_bwd_dkv"])
def test_kernel_wrappers_give_no_other_device_the_plain_version(wrapper):
    """A tensor that is not on the CPU goes to the kernel or raises; here a
    meta tensor raises before any build or launch."""
    q, k, v, do = (x.to("meta") for x in _bh_inputs())
    lse = delta = torch.empty(q.shape[:2], device="meta")
    args = (q, k, v) if wrapper == "flash_fwd" else (q, k, v, do, lse, delta)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        getattr(flash, wrapper)(*args)
    assert sum(flash.launch_counts.values()) == 0


def _calls(node):
    return {n.func.id for n in ast.walk(node)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}


def test_plain_versions_are_reached_only_from_a_cpu_branch():
    """In ``ops/flash.py`` a wrapper reaches a plain version only inside its
    ``if _on_cpu(...)`` branch; no ``try`` anywhere can turn a kernel failure
    into a fallback; no other module of the port calls a plain version."""
    plain = {"flash_fwd_reference", "flash_bwd_reference", "_reference_grads",
             "_grads_from_delta"}
    path = os.path.join(PACKAGE, "ops", "flash.py")
    tree = ast.parse(open(path).read())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef) or fn.name in plain:
            continue
        for stmt in fn.body:
            if (isinstance(stmt, ast.If) and isinstance(stmt.test, ast.Call)
                    and getattr(stmt.test.func, "id", None) == "_on_cpu"):
                continue
            assert not (_calls(stmt) & plain), f"{fn.name} reaches a plain version"
    for src in _port_sources():
        if src == path:
            continue
        tree = ast.parse(open(src).read())
        if os.path.basename(src) == "chip_smoke.py":
            continue  # it times the plain versions beside the kernels
        names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
        names |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
        assert not (names & plain), f"{src} reaches a plain flash version"
    build = open(os.path.join(PACKAGE, "ops", "_build.py")).read()
    assert "try:" not in build
