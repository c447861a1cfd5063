"""Hygiene of the PyTorch port: it imports nothing of JAX or of the JAX
package, its entry points refuse to run quietly on the CPU, and only a CPU
tensor reaches a kernel's plain version."""

import ast
import math
import os
import types

import numpy as np
import pytest
import torch

from distdiff_tpu_torch.config import (
    PipelineConfig,
    TextEncoderConfig,
    UNetConfig,
    VAEConfig,
)
from distdiff_tpu_torch.models import AutoencoderKL, CLIPTextEncoder, UNet2DConditionModel
from distdiff_tpu_torch.models.guide import create_model
from distdiff_tpu_torch.ops import _build, attention, flash
from distdiff_tpu_torch.ops import groupnorm as gn
from distdiff_tpu_torch.parallel import ExpansionDriver
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


def test_port_imports_no_pil_and_no_torchvision():
    """The machine with the card has neither: image I/O is the standard
    library's (``parallel/driver.py``)."""
    bad = [f"{os.path.relpath(path, ROOT)}:{lineno} imports {module}"
           for path in _port_sources() for lineno, module in _imported_modules(path)
           if module.split(".")[0] in ("PIL", "torchvision")]
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("entry", ["pipeline", "unet", "vae", "guide", "text_encoder",
                                   "driver"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build = {
        "pipeline": lambda: ExpansionPipeline.create(PipelineConfig.tiny()),
        "unet": lambda: UNet2DConditionModel(UNetConfig.tiny()),
        "vae": lambda: AutoencoderKL(VAEConfig.tiny()),
        "guide": lambda: create_model("tiny_resnet", num_classes=3),
        "text_encoder": lambda: CLIPTextEncoder(TextEncoderConfig.tiny()),
        "driver": lambda: ExpansionDriver(None, None, "out"),
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


def test_flash_wrappers_take_fp32_and_launch_its_kernels(monkeypatch):
    """fp32 q/k/v pass the wrappers' checks (they raised TypeError before)
    and go to the fp32 entry points with fp32 outputs: nothing is cast to
    bf16. Meta tensors stand in for CUDA ones; the kernel entry points are
    replaced by a recorder."""
    calls = []
    monkeypatch.setattr(_build, "kernel",
                        lambda name: lambda *args: calls.append(name) or 0)
    monkeypatch.setattr(flash, "_on_cpu", lambda x: False)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    flash.reset_launch_counts()
    for dtype, suffix in ((torch.float32, "_f32"), (torch.bfloat16, "")):
        q, k, v, do = (x.to("meta", dtype) for x in _bh_inputs())
        lse = delta = torch.empty(q.shape[:2], device="meta")
        o, _ = flash.flash_fwd(q, k, v)
        grads = flash.flash_bwd_fused(q, k, v, do, lse, delta)
        grads += (flash.flash_bwd_dq(q, k, v, do, lse, delta),)
        grads += flash.flash_bwd_dkv(q, k, v, do, lse, delta)
        assert o.dtype == dtype and all(g.dtype == dtype for g in grads)
        assert calls[-4:] == [n + suffix for n in ("flash_fwd", "flash_bwd_fused",
                                                    "flash_bwd_dq", "flash_bwd_dkv")]
    assert flash.launch_counts == {"flash_fwd": 2, "flash_bwd_fused": 2, "flash_bwd_dq": 2,
                                   "flash_bwd_dkv": 2}
    flash.reset_launch_counts()
    with pytest.raises(TypeError, match="bf16 or fp32"):
        flash._check(*(x.to("meta", torch.float16) for x in _bh_inputs()[:3]))
    with pytest.raises(TypeError, match="k is"):
        q, k, v, _ = (x.to("meta") for x in _bh_inputs())
        flash._check(q, k.to(torch.bfloat16), v)


def test_groupnorm_takes_the_plain_version_only_on_cpu_tensors():
    gn.reset_launch_counts()
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 64, 5, 6).astype(np.float32))
    w, b = torch.ones(64), torch.zeros(64)
    y = gn.group_norm(x, w, b, 32, 1e-5, "silu")
    torch.testing.assert_close(y, gn.group_norm_reference(x, w, b, 32, 1e-5, "silu"),
                               rtol=0, atol=0)  # the same function on the same inputs
    assert sum(gn.launch_counts.values()) == 0 and not gn.layout_counts
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gn.group_norm(x.to("meta"), w.to("meta"), b.to("meta"), 32)
    assert sum(gn.launch_counts.values()) == 0


def test_groupnorm_plain_version_is_reached_only_from_a_cpu_branch():
    """In ``ops/groupnorm.py`` the plain version is reached only inside an
    ``if _on_cpu(...)`` branch and from the autograd backward (which
    differentiates the plain formula, as the reference's custom_vjp does);
    no ``try`` anywhere; no module of the port but chip_smoke.py names it."""
    plain = {"group_norm_reference", "group_norm_stats_reference",
             "group_norm_apply_reference"}
    path = os.path.join(PACKAGE, "ops", "groupnorm.py")
    tree = ast.parse(open(path).read())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef) or fn.name in plain | {"backward"}:
            continue
        for stmt in fn.body:
            if (isinstance(stmt, ast.If) and isinstance(stmt.test, ast.Call)
                    and getattr(stmt.test.func, "id", None) == "_on_cpu"):
                continue
            assert not (_calls(stmt) & plain), f"{fn.name} reaches a plain version"
    for src in _port_sources():
        if src == path or os.path.basename(src) == "chip_smoke.py":
            continue
        tree = ast.parse(open(src).read())
        names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
        names |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
        assert not (names & plain), f"{src} reaches a plain GroupNorm"


@pytest.mark.parametrize("d,want", [(1, 48), (16, 48), (33, 48), (40, 48), (48, 48), (49, 64),
                                    (64, 64), (65, 80), (80, 80), (81, 96), (96, 96), (97, 128),
                                    (128, 128), (129, 0), (512, 0)])
def test_narrow_width_pads_the_head_to_a_built_instance(d, want):
    assert flash.narrow_width(d) == want
    assert want == 0 or (want in flash.NARROW_WIDTHS and want >= d and want % 16 == 0)


@pytest.mark.parametrize("d,offset,want", [
    (40, 0, (48, 1)),   # the UNet's 64^2 heads: TMA
    (80, 0, (80, 1)),   # the UNet's 32^2 heads: TMA
    (64, 0, (64, 1)),
    (33, 0, (48, 0)),   # a row of 66 bytes: no TMA, staged loads
    (40, 1, (48, 0)),   # a view one element into its storage: staged loads
    (40, 8, (48, 1)),   # 16 bytes in: TMA again
    (512, 0, (0, 0)),   # the wide kernel
])
def test_narrow_plan_by_width_and_alignment_on_meta_tensors(d, offset, want):
    """The padded width and the load route the wrappers hand the kernels:
    TMA needs rows of a multiple of 16 bytes and 16-byte aligned bases;
    meta tensors carry their storage offset in data_ptr()."""
    base = torch.empty(offset + 3 * 70 * d, device="meta", dtype=torch.bfloat16)
    q = base[offset:].view(3, 70, d)
    k = v = torch.empty(3, 50, d, device="meta", dtype=torch.bfloat16)
    assert q.is_contiguous() and q.data_ptr() == 2 * offset
    assert flash.narrow_plan(d, q, k, v) == want
    assert flash.tma_route(d, [0, 16, 32]) == (d % 8 == 0)
    assert not flash.tma_route(40, [0, 8])


def _recorded_launches(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "kernel",
                        lambda name: lambda *args: calls.append((name, args)) or 0)
    monkeypatch.setattr(flash, "_on_cpu", lambda x: False)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return calls


@pytest.mark.parametrize("d,offset,plan", [(40, 0, (48, 1)), (80, 0, (80, 1)), (33, 0, (48, 0)),
                                          (40, 1, (48, 0)), (128, 0, (128, 1))])
def test_wrappers_hand_the_narrow_plan_to_the_kernels(monkeypatch, d, offset, plan):
    """flash_fwd and flash_bwd_fused pass (BH, Tq, Tk, D), the plan, the
    scale and the stream after the pointers, as many arguments as the
    entry points' C signatures take; dq's fp32 scratch is [BH, Tq, D]."""
    calls = _recorded_launches(monkeypatch)
    flash.reset_launch_counts()

    def bf16(*shape):
        n = math.prod(shape)
        return torch.empty(offset + n, device="meta", dtype=torch.bfloat16)[offset:].view(*shape)

    q, do, k, v = bf16(2, 70, d), bf16(2, 70, d), bf16(2, 50, d), bf16(2, 50, d)
    lse = delta = torch.empty(2, 70, device="meta")
    flash.flash_fwd(q, k, v)
    dq, dk, dv = flash.flash_bwd_fused(q, k, v, do, lse, delta)
    assert dq.shape == q.shape and dq.dtype == torch.bfloat16 and dk.shape == k.shape
    for name, args in calls:
        n_ptr = 5 if name == "flash_fwd" else 9
        assert len(args) == len(_build.SIGNATURES[name][1])
        assert args[n_ptr:n_ptr + 6] == (2, 70, 50, d) + plan
        assert args[n_ptr + 6] == pytest.approx(d ** -0.5)
    assert [n for n, _ in calls] == ["flash_fwd", "flash_bwd_fused"]
    assert calls[1][1][6] == 0  # the dq scratch: a fresh, aligned fp32 tensor


def test_fp32_and_wide_launches_take_no_narrow_plan(monkeypatch):
    calls = _recorded_launches(monkeypatch)
    q, k, v = (torch.empty(2, 70, 40, device="meta") for _ in range(3))
    flash.flash_fwd(q, k, v)  # fp32: its own instance, no plan
    wide = [torch.empty(1, 64, 512, device="meta", dtype=torch.bfloat16) for _ in range(3)]
    flash.flash_fwd(*wide)    # D = 512: the wide kernel, plan (0, 0)
    (n32, a32), (n16, a16) = calls
    assert n32 == "flash_fwd_f32" and len(a32) == len(_build.SIGNATURES[n32][1]) == 11
    assert n16 == "flash_fwd" and a16[5:11] == (1, 64, 64, 512, 0, 0)
    flash.reset_launch_counts()
