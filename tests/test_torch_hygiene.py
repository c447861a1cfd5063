"""Hygiene of the PyTorch port: it imports nothing of JAX or of the JAX
package, its entry points refuse to run quietly on the CPU, and only a CPU
tensor reaches a kernel's plain version."""

import ast
import math
import os
import subprocess
import sys
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
from distdiff_tpu_torch.models.guide.factory import build_zero_shot_text_features
from distdiff_tpu_torch.ops import _build, attention, flash
from distdiff_tpu_torch.ops import groupnorm as gn
from distdiff_tpu_torch.parallel import ExpansionDriver
from distdiff_tpu_torch.sampling import ExpansionPipeline
from distdiff_tpu_torch.sampling.sdxl import SDXLPipeline

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


PARALLEL = ("mesh", "distributed", "sp", "tp", "pp", "fsdp", "driver", "manifest")


def test_the_parallel_modules_import_nothing_of_jax():
    """Every module of ``parallel/`` imports nothing of JAX, read from its
    source; the int8 test below imports them all with JAX and the JAX
    package absent."""
    walked = {os.path.relpath(p, PACKAGE) for p in _port_sources()}
    for mod in PARALLEL:
        path = os.path.join(PACKAGE, "parallel", f"{mod}.py")
        assert os.path.relpath(path, PACKAGE) in walked
        for lineno, module in _imported_modules(path):
            assert module.split(".")[0] not in FORBIDDEN, f"parallel/{mod}.py:{lineno}"


def test_no_refusal_names_the_parallel_modules_roadmap_item():
    """The parallel surface is ported: no ``NotImplementedError`` (nor any
    line) of the port names ROADMAP queue 1 item 8 any more."""
    bad = []
    for path in _port_sources():
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                if "item 8" in line:
                    bad.append(f"{os.path.relpath(path, ROOT)}:{lineno}")
    assert not bad, bad


QUALITY_LOOP = os.path.join(PACKAGE, "cli", "quality_loop.py")


def test_the_quality_loop_imports_nothing_of_jax_optax_pil_orbax_or_yaml():
    """``cli/quality_loop.py`` (the JAX script's port) is among the sources
    the checks here walk, and imports none of what the JAX script does:
    JAX, optax, PIL, orbax, yaml or the JAX package; the subprocess test
    below imports it with all of them absent."""
    assert QUALITY_LOOP in _port_sources()
    tops = {m.split(".")[0] for _, m in _imported_modules(QUALITY_LOOP)}
    assert "torch" in tops
    assert not tops & set(FORBIDDEN + ("optax", "PIL", "orbax", "yaml")), tops


def test_quality_loop_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    """``main`` on a toy tree with no card and no ``DISTDIFF_PLATFORM``
    raises before it writes anything, as the other CLIs do."""
    from distdiff_tpu_torch.cli import quality_loop

    quality_loop.fabricate_toy_dataset(str(tmp_path / "data"), n_train=1, n_test=1)
    monkeypatch.delenv("DISTDIFF_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="DISTDIFF_PLATFORM=cpu"):
        quality_loop.main(["--data_root", str(tmp_path / "data"),
                           "--workdir", str(tmp_path / "ql"), "--train_vae"])
    assert not os.path.exists(tmp_path / "ql")


def test_port_imports_no_pil_and_no_torchvision():
    """The machine with the card has neither: image I/O is the standard
    library's (``parallel/driver.py``)."""
    bad = [f"{os.path.relpath(path, ROOT)}:{lineno} imports {module}"
           for path in _port_sources() for lineno, module in _imported_modules(path)
           if module.split(".")[0] in ("PIL", "torchvision")]
    assert not bad, "\n".join(bad)


def _functions_importing(path, top):
    """(line, enclosing function or None) of each import of ``top``."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    out = []

    def walk(node, func):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walk(child, child.name)
                continue
            names = ([a.name for a in child.names] if isinstance(child, ast.Import)
                     else [child.module] if isinstance(child, ast.ImportFrom)
                     and child.level == 0 else [])
            if any(n.split(".")[0] == top for n in names):
                out.append((child.lineno, func))
            walk(child, func)
    walk(tree, None)
    return out


def test_port_imports_no_yaml_or_orbax_and_matplotlib_only_to_plot():
    """The card's machine has none of them: the trainer writes and reads
    ``results.yaml`` itself and its checkpoints are ``.pth.tar`` files; the
    logger's plots import matplotlib when they are called."""
    bad = []
    for path in _port_sources():
        rel = os.path.relpath(path, ROOT)
        for top in ("yaml", "orbax"):
            bad += [f"{rel}:{line} imports {top}" for line, _ in _functions_importing(path, top)]
        bad += [f"{rel}:{line} imports matplotlib in {func}"
                for line, func in _functions_importing(path, "matplotlib")
                if func not in ("plot", "plot_overlap", "savefig")]
    assert not bad, "\n".join(bad)


GUIDE_ZOO = ("distdiff_tpu_torch.models.guide.clip_vit",
             "distdiff_tpu_torch.models.guide.mobilenet",
             "distdiff_tpu_torch.models.guide.factory",
             "distdiff_tpu_torch.weights.openclip",
             "distdiff_tpu_torch.utils.classnames",
             "distdiff_tpu_torch.utils.imagenet_tables",
             "distdiff_tpu_torch.utils.prompts",
             "distdiff_tpu_torch.utils.visualize",
             "distdiff_tpu_torch.utils.profiling")


def test_the_guide_zoo_imports_without_jax_pil_or_matplotlib():
    """The guide zoo's modules are among the sources the checks above walk,
    and import, with the OpenCLIP file reader and the grid writer, with
    JAX, the JAX package, PIL, matplotlib and safetensors absent (each set
    to None in ``sys.modules``), as on the card's machine."""
    walked = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for mod in GUIDE_ZOO:
        assert mod.replace(".", os.sep) + ".py" in walked, mod
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'distdiff_tpu', 'PIL', 'matplotlib', 'safetensors'):\n"
        "    sys.modules[m] = None\n"
        + "".join(f"import {m}\n" for m in GUIDE_ZOO)
        + "from distdiff_tpu_torch.weights.openclip import load_openclip_checkpoint\n"
        "from distdiff_tpu_torch.utils.visualize import save_image_grid\n"
        "from distdiff_tpu_torch.models.guide.factory import ARCHS\n"
        "assert len(ARCHS) == 6\n"
        "print('imported')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and "imported" in out.stdout, out.stderr


@pytest.mark.parametrize("entry", ["pipeline", "unet", "vae", "guide", "text_encoder",
                                   "driver", "trainable_guide", "sdxl_pipeline",
                                   "sdxl_expansion", "clip_guide", "mobilenet_guide",
                                   "zero_shot_head"])
def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build = {
        "pipeline": lambda: ExpansionPipeline.create(PipelineConfig.tiny()),
        "unet": lambda: UNet2DConditionModel(UNetConfig.tiny()),
        "vae": lambda: AutoencoderKL(VAEConfig.tiny()),
        "guide": lambda: create_model("tiny_resnet", num_classes=3),
        "text_encoder": lambda: CLIPTextEncoder(TextEncoderConfig.tiny()),
        "driver": lambda: ExpansionDriver(None, None, "out"),
        "trainable_guide": lambda: create_model("tiny_resnet", num_classes=3, trainable=True),
        "sdxl_pipeline": lambda: SDXLPipeline.create(PipelineConfig.sdxl_tiny()),
        "sdxl_expansion": lambda: ExpansionPipeline.create(PipelineConfig.sdxl_tiny()),
        "clip_guide": lambda: create_model("open_clip_vit_b32", num_classes=3),
        "mobilenet_guide": lambda: create_model("mobilenetv2", num_classes=3, trainable=True),
        "zero_shot_head": lambda: build_zero_shot_text_features(
            ["a"], config=TextEncoderConfig.tiny()),
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


def test_int8_plain_product_is_reached_only_from_a_cpu_branch():
    """In ``ops/quant.py`` the plain int8 product ``int_mm_reference`` is
    reached only inside ``int_mm``'s ``if _on_cpu(...)`` branch; no
    ``except`` can turn a refused ``torch._int_mm`` into another route (the
    one ``try`` restores the flag in its ``finally``); no other module of
    the port but chip_smoke.py names it."""
    path = os.path.join(PACKAGE, "ops", "quant.py")
    tree = ast.parse(open(path).read())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try) and n.handlers]
    reached = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef) or fn.name == "int_mm_reference":
            continue
        for stmt in fn.body:
            on_cpu = (isinstance(stmt, ast.If) and isinstance(stmt.test, ast.Call)
                      and getattr(stmt.test.func, "id", None) == "_on_cpu")
            if "int_mm_reference" in _calls(stmt):
                reached.append((fn.name, on_cpu))
    assert reached == [("int_mm", True)]
    for src in _port_sources():
        if src == path or os.path.basename(src) == "chip_smoke.py":
            continue
        tree = ast.parse(open(src).read())
        names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
        names |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
        assert "int_mm_reference" not in names, f"{src} reaches the plain int8 product"


def test_int8_route_refuses_other_devices_before_any_product():
    from distdiff_tpu_torch.ops import quant

    quant.reset_counts()
    a = torch.zeros(32, 16, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        quant.int_mm(a.to("meta"), a.to("meta"))
    assert not quant.product_shapes


def test_int8_ops_and_parameter_files_import_without_jax_orbax_or_pil():
    """``ops/quant.py``, the layers that call it, ``weights/params_io.py``,
    the parallel modules and ``cli/quality_loop.py`` import, and save and
    read a parameter directory, with JAX, the JAX package, optax, orbax, PIL
    and yaml absent (each set to None in ``sys.modules``), as on the card's
    machine."""
    walked = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for mod in ("ops/quant.py", "weights/params_io.py", "cli/quality_loop.py"):
        assert os.path.join("distdiff_tpu_torch", mod) in walked
    code = (
        "import sys, tempfile, os\n"
        "for m in ('jax', 'flax', 'distdiff_tpu', 'optax', 'orbax', 'PIL', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        "from distdiff_tpu_torch.ops import quant\n"
        "from distdiff_tpu_torch.weights import params_io\n"
        "from distdiff_tpu_torch.cli import quality_loop\n"
        + "".join(f"import distdiff_tpu_torch.parallel.{m}\n" for m in PARALLEL) +
        "from distdiff_tpu_torch.config import PipelineConfig\n"
        "from distdiff_tpu_torch.sampling import ExpansionPipeline\n"
        "pipe = ExpansionPipeline.create(PipelineConfig.tiny(), device='cpu')\n"
        "d = os.path.join(tempfile.mkdtemp(), 'params')\n"
        "params_io.save_params(d, pipe, 'sd15')\n"
        "print(sorted(params_io.load_params(d, pipe, 'sd15')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and "['text_encoder', 'unet', 'vae']" in out.stdout, out.stderr


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
    (512, 0, (0, 1)),   # the wide forward at the VAE's width: TMA
    (160, 0, (0, 1)),   # the wide forward's DMAX = 256 instance: TMA
    (130, 0, (0, 0)),   # a row of 260 bytes: the wide forward's staged loads
    (512, 1, (0, 0)),   # a view one element in: the wide forward's staged loads
])
def test_narrow_plan_by_width_and_alignment_on_meta_tensors(d, offset, want):
    """The padded width and the load route the wrappers hand the kernels:
    TMA needs rows of a multiple of 16 bytes and 16-byte aligned bases;
    meta tensors carry their storage offset in data_ptr()."""
    base = torch.empty(offset + 3 * 70 * d, device="meta", dtype=torch.bfloat16)
    q = base[offset:].view(3, 70, d)
    k = v = torch.empty(3, 50, d, device="meta", dtype=torch.bfloat16)
    assert q.is_contiguous() and q.data_ptr() == 2 * offset
    assert flash.bf16_plan(d, q, k, v) == want
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
    flash.flash_fwd(*wide)    # D = 512: the wide kernel, width 0, TMA loads
    (n32, a32), (n16, a16) = calls
    assert n32 == "flash_fwd_f32" and len(a32) == len(_build.SIGNATURES[n32][1]) == 11
    assert n16 == "flash_fwd" and a16[5:11] == (1, 64, 64, 512, 0, 1)
    flash.reset_launch_counts()


@pytest.mark.parametrize("d,offset,route", [
    (512, 0, 1),   # the VAE mid-block's head: TMA
    (512, 1, 0),   # a view one element into its storage: staged
    (512, 8, 1),   # 16 bytes in: TMA again
    (136, 0, 1),   # the DMAX = 256 instance: TMA
    (129, 0, 0),   # rows of 258 bytes: staged
    (130, 0, 0),
    (257, 0, 0),   # the DMAX = 512 instance, staged
])
def test_wide_forward_gets_width_zero_and_the_load_route(monkeypatch, d, offset, route):
    """Past D = 128 flash_fwd hands its kernel width 0 (the wide kernel) and
    the load route of q, k and v by width and storage offset, as many
    arguments as the C signature takes; the backward pair takes its own
    plan (the load route alone, checked below)."""
    calls = _recorded_launches(monkeypatch)
    flash.reset_launch_counts()

    def bf16(*shape):
        n = math.prod(shape)
        return torch.empty(offset + n, device="meta", dtype=torch.bfloat16)[offset:].view(*shape)

    q, do, k, v = bf16(2, 70, d), bf16(2, 70, d), bf16(2, 50, d), bf16(2, 50, d)
    lse = delta = torch.empty(2, 70, device="meta")
    o, lse_out = flash.flash_fwd(q, k, v)
    assert o.shape == q.shape and o.dtype == torch.bfloat16 and lse_out.shape == (2, 70)
    flash.flash_bwd_dq(q, k, v, do, lse, delta)
    (name, args), (bname, bargs) = calls
    assert name == "flash_fwd" and len(args) == len(_build.SIGNATURES[name][1])
    assert args[5:11] == (2, 70, 50, d, 0, route)
    assert args[11] == pytest.approx(d ** -0.5)
    assert bname == "flash_bwd_dq" and len(bargs) == len(_build.SIGNATURES[bname][1])
    assert flash.launch_counts["flash_fwd"] == 1
    flash.reset_launch_counts()


@pytest.mark.parametrize("d,offset,route", [
    (512, 0, 1),   # the VAE mid-block's head: TMA
    (512, 1, 0),   # a view one element into its storage: staged
    (512, 8, 1),   # 16 bytes in: TMA again
    (136, 0, 1),   # the DMAX = 256 instance: TMA
    (129, 0, 0),   # rows of 258 bytes: staged
    (257, 0, 0),   # the DMAX = 512 instance, staged
    (40, 0, 1),    # a narrow width reaches the DMAX = 128 instance
    (33, 0, 0),
])
def test_split_pair_gets_the_load_route(monkeypatch, d, offset, route):
    """flash_bwd_dq and flash_bwd_dkv hand their kernels (BH, Tq, Tk, D),
    the load route of q, k, v and do by width and storage offset, the scale
    and the stream after the pointers, as many arguments as the C
    signatures take; each counts one launch."""
    calls = _recorded_launches(monkeypatch)
    flash.reset_launch_counts()

    def bf16(*shape):
        n = math.prod(shape)
        return torch.empty(offset + n, device="meta", dtype=torch.bfloat16)[offset:].view(*shape)

    q, do, k, v = bf16(2, 70, d), bf16(2, 70, d), bf16(2, 50, d), bf16(2, 50, d)
    lse = delta = torch.empty(2, 70, device="meta")
    assert flash.split_plan(d, q, k, v, do) == (route,)
    dq = flash.flash_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert all(x.dtype == torch.bfloat16 for x in (dq, dk, dv))
    assert [n for n, _ in calls] == ["flash_bwd_dq", "flash_bwd_dkv"]
    for (name, args), n_ptr in zip(calls, (7, 8)):
        assert len(args) == len(_build.SIGNATURES[name][1])
        assert args[n_ptr:n_ptr + 5] == (2, 70, 50, d, route)
        assert args[n_ptr + 5] == pytest.approx(d ** -0.5)
    assert flash.launch_counts["flash_bwd_dq"] == flash.launch_counts["flash_bwd_dkv"] == 1
    flash.reset_launch_counts()


@pytest.mark.parametrize("dmax", flash.SPLIT_DMAX)
def test_split_pair_block_fits_the_card(dmax):
    """A split-backward block at each built width fits the H100's 227 KB of
    shared memory with its ring deeper than a tile's chunks of one operand
    (csrc/flash_bwd.cu SplitBwdCfg; chip_smoke.py phase 1 holds the C count
    against split_smem_bytes on the card)."""
    chunk, ch = 64 * 128, dmax // 64
    ring = (flash.split_smem_bytes(dmax) - 2 * ch * chunk - chunk - 1024 - 1024) // chunk
    assert ring > ch
    assert 0 < flash.split_smem_bytes(dmax) <= 232448


@pytest.mark.parametrize("dmax", flash.F32_WIDE_DMAX)
def test_fp32_wide_forward_block_fits_the_card(dmax):
    """The fp32 wide forward's block (csrc/flash_f32.cu WideCfg) at each
    built width fits the H100's 227 KB of shared memory with its resident q
    tile and four ring slots, each slot holding a k chunk or a v chunk
    (chip_smoke.py phase 1 holds the C count against f32_wide_smem_bytes
    on the card)."""
    q_tile, p_tile, slot = 64 * (dmax + 4) * 4, 64 * 68 * 4, 64 * 68 * 4
    assert 4096 // dmax * (dmax + 8) * 4 <= slot
    assert q_tile + p_tile + 4 * slot < flash.f32_wide_smem_bytes(dmax) <= 232448


@pytest.mark.parametrize("d,want", [
    (16, ("flash_fwd_f32_narrow_kernel", 32)), (40, ("flash_fwd_f32_narrow_kernel", 64)),
    (128, ("flash_fwd_f32_narrow_kernel", 128)),
    (129, ("flash_fwd_f32_wide_kernel", 256)), (160, ("flash_fwd_f32_wide_kernel", 256)),
    (256, ("flash_fwd_f32_wide_kernel", 256)), (257, ("flash_fwd_f32_wide_kernel", 512)),
    (512, ("flash_fwd_f32_wide_kernel", 512)),
])
def test_fp32_forward_takes_the_tensor_core_kernel_past_128(d, want):
    """fp32 flash_fwd runs a 3xTF32 tensor-core kernel at every width: the
    narrow one up to D = 128 and the wide one past it, at the padded widths
    csrc/flash_f32.cu builds; the launch takes no plan, so the C signature
    keeps 11 arguments whatever the kernel and its load route."""
    assert flash.f32_fwd_kernel(d) == want


@pytest.mark.parametrize("dmax", flash.F32_NARROW_DMAX)
def test_fp32_narrow_forward_block_fits_the_card(dmax):
    """The fp32 narrow forward's block (csrc/flash_f32.cu NarrowCfg) at each
    built width: the resident 128-row q tile (rows of dmax + 8 floats) and
    a ring of two slots, each a k tile (dmax + 8) and a v tile (dmax + 4)
    of 64 kv rows (16 at DMAX 128), so that two blocks share an SM, each
    with its 1 KB of reserved shared memory, within the H100's 228 KB an
    SM (chip_smoke.py phase 1 holds the C count against
    f32_narrow_smem_bytes on the card)."""
    bk = 16 if dmax == 128 else 64
    q_tile, slot = 128 * (dmax + 8) * 4, bk * (2 * dmax + 12) * 4
    smem = flash.f32_narrow_smem_bytes(dmax)
    assert q_tile + 2 * slot < smem <= 232448
    assert smem - q_tile - 2 * slot == 2 * 16 + 8 + 128
    assert 2 * (smem + 1024) <= 233472


@pytest.mark.parametrize("d", [160, 257, 512])
def test_fp32_wide_launch_passes_the_shape_and_scale(monkeypatch, d):
    calls = _recorded_launches(monkeypatch)
    flash.reset_launch_counts()
    q = torch.empty(3, 65, d, device="meta")
    k = v = torch.empty(3, 63, d, device="meta")
    o, lse = flash.flash_fwd(q, k, v)
    assert o.dtype == torch.float32 and o.shape == q.shape and lse.shape == (3, 65)
    [(name, args)] = calls
    assert name == "flash_fwd_f32" and len(args) == len(_build.SIGNATURES[name][1]) == 11
    assert args[5:9] == (3, 65, 63, d) and args[9] == pytest.approx(d ** -0.5)
    assert flash.launch_counts["flash_fwd"] == 1
    assert flash.launch_shapes[("flash_fwd", (3, 65, 63, d))] == 1
    flash.reset_launch_counts()


@pytest.mark.parametrize("d", [16, 40, 100, 128])
def test_fp32_narrow_launch_passes_the_shape_and_scale(monkeypatch, d):
    """Up to D = 128 the fp32 forward hands its entry point the pointers,
    then (BH, Tq, Tk, D), the scale and the stream (no plan: the C side
    picks the narrow kernel's instance and its load route), as many
    arguments as the C signature takes; it counts one launch by shape and
    returns fp32 o and lse of the inputs' shapes."""
    calls = _recorded_launches(monkeypatch)
    flash.reset_launch_counts()
    q = torch.empty(2, 129, d, device="meta")
    k = v = torch.empty(2, 63, d, device="meta")
    o, lse = flash.flash_fwd(q, k, v)
    assert o.dtype == lse.dtype == torch.float32
    assert o.shape == q.shape and lse.shape == (2, 129)
    [(name, args)] = calls
    assert name == "flash_fwd_f32" and len(args) == len(_build.SIGNATURES[name][1]) == 11
    assert args[5:9] == (2, 129, 63, d) and args[9] == pytest.approx(d ** -0.5)
    assert flash.launch_counts["flash_fwd"] == 1
    assert flash.launch_shapes[("flash_fwd", (2, 129, 63, d))] == 1
    flash.reset_launch_counts()


@pytest.mark.parametrize("dmax", flash.F32_WIDE_DMAX)
def test_fp32_split_block_fits_the_card(dmax):
    """The fp32 split pair's tensor-core block (csrc/flash_f32.cu SplitCfg)
    at each built width fits the H100's 227 KB of shared memory with its
    two resident 32-row tiles and a ring that holds a whole 16-row tile of
    chunk pairs (a pair stays until the output products have read it), and
    at DMAX 256 two blocks share an SM (chip_smoke.py phase 1 holds the C
    count of either role against f32_split_smem_bytes on the card)."""
    tiles, pair = 2 * 32 * (dmax + 4) * 4, 2 * 16 * 68 * 4
    ring = (flash.f32_split_smem_bytes(dmax) - tiles - dmax // 64 * 2048) // pair
    assert ring >= dmax // 64
    assert tiles + ring * pair < flash.f32_split_smem_bytes(dmax) <= 232448
    if dmax == 256:
        assert 2 * (flash.f32_split_smem_bytes(dmax) + 1024) <= 233472


@pytest.mark.parametrize("w", flash.F32_FUSED_WIDTHS)
def test_fp32_fused_block_fits_the_card(w):
    """The fp32 fused backward's block (csrc/flash_f32.cu FusedCfg) at each
    padded width it is built for fits the H100's 227 KB of shared memory:
    the resident 128-row k and v tiles, a two-slot ring of q and do tiles
    (32 rows, 16 at 128), ds^T, dq's staging and three quarters' partial
    sums, lse and delta of two tiles, the mbarriers and 128 bytes of
    alignment (chip_smoke.py phase 1 holds the C count against
    f32_fused_smem_bytes on the card)."""
    bq = 16 if w == 128 else 32
    tiles = 2 * 128 * (w + 4) * 4 + 2 * 2 * bq * (w + 4) * 4 + 128 * (bq + 4) * 4
    smem = flash.f32_fused_smem_bytes(w)
    assert tiles < smem <= 232448
    assert (w + 4) % 8 == 4  # an odd multiple of 4 floats: ldmatrix and 2t-row loads conflict-free


@pytest.mark.parametrize("d", range(1, 129))
def test_fp32_fused_takes_the_tensor_core_kernel(d):
    """fp32 flash_bwd_fused runs the 3xTF32 tensor-core kernel at every
    width up to 128, at the smallest padded width csrc/flash_f32.cu builds
    that holds d (its fused_width rule, in Python); wider widths raise."""
    name, w = flash.f32_fused_kernel(d)
    assert name == "flash_bwd_fused_f32_kernel"
    assert w == min(x for x in flash.F32_FUSED_WIDTHS if x >= d)
    if d == 128:
        with pytest.raises(ValueError, match="D <= 128"):
            flash.f32_fused_kernel(129)


@pytest.mark.parametrize("d", [16, 40, 100, 128])
def test_fp32_fused_launch_passes_the_shape_and_scale(monkeypatch, d):
    """The fp32 fused wrapper hands its entry point the pointers (q, k, v,
    do, lse, delta, a zeroed fp32 dq, dk, dv), then (BH, Tq, Tk, D), the
    scale and the stream (no plan: the C side picks the instance and its
    load route), as many arguments as the C signature takes; it counts one
    launch by shape, returns fp32 gradients of the inputs' shapes, and
    raises past D = 128 before any launch."""
    calls = _recorded_launches(monkeypatch)
    flash.reset_launch_counts()
    q, do = torch.empty(2, 129, d, device="meta"), torch.empty(2, 129, d, device="meta")
    k = v = torch.empty(2, 63, d, device="meta")
    lse = delta = torch.empty(2, 129, device="meta")
    dq, dk, dv = flash.flash_bwd_fused(q, k, v, do, lse, delta)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert all(x.dtype == torch.float32 for x in (dq, dk, dv))
    [(name, args)] = calls
    assert name == "flash_bwd_fused_f32" and len(args) == len(_build.SIGNATURES[name][1]) == 15
    assert args[9:13] == (2, 129, 63, d) and args[13] == pytest.approx(d ** -0.5)
    assert flash.launch_counts["flash_bwd_fused"] == 1
    assert flash.launch_shapes[("flash_bwd_fused", (2, 129, 63, d))] == 1
    wide = torch.empty(2, 63, 129, device="meta")
    with pytest.raises(ValueError, match="D <= 128"):
        flash.flash_bwd_fused(wide, wide, wide, wide, torch.empty(2, 63, device="meta"),
                              torch.empty(2, 63, device="meta"))
    assert len(calls) == 1
    flash.reset_launch_counts()


@pytest.mark.parametrize("d,want", [
    (16, ("dq_kernel/dkv_kernel", 32)), (40, ("dq_kernel/dkv_kernel", 64)),
    (128, ("dq_kernel/dkv_kernel", 128)), (129, ("flash_bwd_f32_split_kernel", 256)),
    (160, ("flash_bwd_f32_split_kernel", 256)), (256, ("flash_bwd_f32_split_kernel", 256)),
    (257, ("flash_bwd_f32_split_kernel", 512)), (512, ("flash_bwd_f32_split_kernel", 512)),
])
def test_fp32_split_takes_the_tensor_core_kernel_past_128(d, want):
    """fp32 flash_bwd_dq and flash_bwd_dkv run the CUDA-core instances up
    to D = 128 and the 3xTF32 tensor-core kernel past it, at the padded
    widths csrc/flash_f32.cu builds (its C dispatch, in Python)."""
    assert flash.f32_split_kernel(d) == want


@pytest.mark.parametrize("d", [160, 257, 512])
def test_fp32_split_launch_passes_the_shape_and_scale(monkeypatch, d):
    """The fp32 split wrappers hand their entry points the pointers, then
    (BH, Tq, Tk, D), the scale and the stream (no plan: the C side picks
    the load route), as many arguments as the C signatures take; each
    counts one launch by shape; the outputs are fp32 of the inputs' shapes."""
    calls = _recorded_launches(monkeypatch)
    flash.reset_launch_counts()
    q, do = torch.empty(3, 65, d, device="meta"), torch.empty(3, 65, d, device="meta")
    k = v = torch.empty(3, 63, d, device="meta")
    lse = delta = torch.empty(3, 65, device="meta")
    dq = flash.flash_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = flash.flash_bwd_dkv(q, k, v, do, lse, delta)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert all(x.dtype == torch.float32 for x in (dq, dk, dv))
    assert [n for n, _ in calls] == ["flash_bwd_dq_f32", "flash_bwd_dkv_f32"]
    for (name, args), n_ptr in zip(calls, (7, 8)):
        assert len(args) == len(_build.SIGNATURES[name][1]) == n_ptr + 6
        assert args[n_ptr:n_ptr + 4] == (3, 65, 63, d)
        assert args[n_ptr + 4] == pytest.approx(d ** -0.5)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert flash.launch_shapes[(name, (3, 65, 63, d))] == 1
    flash.reset_launch_counts()
