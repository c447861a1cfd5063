"""The port's GroupNorm against the JAX package's Pallas GroupNorm kernels,
run in interpret mode on the CPU (single pass ``_pallas_group_norm`` and the
chunked two-pass ``_pallas_group_norm_chunked`` with small chunks, so that
several run), in both memory formats the port sees (contiguous NCHW and
channels-last), with and without SiLU; the autograd.Function's gradient
against the JAX ``custom_vjp``'s; and the host side of the CUDA wrappers
(layout, shared-memory rule, vector width, split count, launch arguments)
on meta tensors with the kernel entry point replaced by a recorder."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distdiff_tpu.ops.groupnorm as jgn
from distdiff_tpu_torch.ops import _build
from distdiff_tpu_torch.ops import groupnorm as gn

torch.set_num_threads(1)

SHAPES = [  # (B, H, W, C, groups): cpg 4, 8, 1 and 3; odd H*W
    (2, 8, 8, 128, 32),
    (1, 6, 10, 256, 32),
    (2, 5, 7, 32, 32),
    (1, 9, 3, 96, 32),
]


def _inputs(b, h, w, c, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, h, w, c) * 1.5 + 0.3).astype(np.float32)
    scale = (1.0 + 0.5 * rng.randn(c)).astype(np.float32)
    bias = (0.5 * rng.randn(c)).astype(np.float32)
    return x, scale, bias


def _port(x_nhwc, scale, bias, groups, act, channels_last):
    x = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)  # channels-last strides
    if not channels_last:
        x = x.contiguous()
    assert gn.layout(x) == ("nhwc" if channels_last and x.shape[1] > 1 else "nchw")
    y = gn.group_norm(x, torch.from_numpy(scale), torch.from_numpy(bias), groups, 1e-5, act)
    assert y.stride() == x.stride()  # the output keeps the input's memory format
    return y.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape", SHAPES)
def test_matches_single_pass_pallas_kernel(monkeypatch, shape, act, channels_last):
    monkeypatch.setattr(jgn, "INTERPRET", True)
    b, h, w, c, groups = shape
    x, scale, bias = _inputs(b, h, w, c, seed=c + h)
    want = np.asarray(jgn._pallas_group_norm(jnp.asarray(x), jnp.asarray(scale),
                                             jnp.asarray(bias), groups, 1e-5, act))
    got = _port(x, scale, bias, groups, act, channels_last)
    # fp32 statistics summed in another order: 2e-4, as the JAX package's
    # own kernel tests hold the Pallas kernels against xla_group_norm
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("channels_last", [True, False])
@pytest.mark.parametrize("act", [None, "silu"])
def test_matches_chunked_two_pass_pallas_kernels(monkeypatch, act, channels_last):
    monkeypatch.setattr(jgn, "INTERPRET", True)
    b, h, w, c, groups = 2, 12, 8, 128, 32
    monkeypatch.setattr(jgn, "_CHUNK_BYTES", 16 * c * 4)  # 16 rows a chunk
    assert h * w // jgn._chunk_rows(h * w, c, 4) == 6  # six chunks run
    x, scale, bias = _inputs(b, h, w, c, seed=7)
    want = np.asarray(jgn._pallas_group_norm_chunked(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), groups, 1e-5, act))
    got = _port(x, scale, bias, groups, act, channels_last)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


def test_bf16_matches_xla_group_norm():
    """bf16 in, bf16 out: a and b rounded to bf16 before x * a + b, as the
    reference rounds them."""
    x, scale, bias = _inputs(2, 4, 4, 64, seed=3)
    want = np.asarray(jgn.xla_group_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale),
                                         jnp.asarray(bias), 32, 1e-5, "silu"), np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    got = gn.group_norm(xt, torch.from_numpy(scale), torch.from_numpy(bias), 32, 1e-5, "silu")
    assert got.dtype == torch.bfloat16
    # one bf16 rounding step of the largest value (2^-8 relative) at most
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(), want,
                               atol=2.0 ** -7 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("act", [None, "silu"])
def test_gradient_matches_jax_custom_vjp(monkeypatch, act):
    monkeypatch.setattr(jgn, "INTERPRET", True)
    b, h, w, c, groups = 1, 4, 4, 128, 32
    x, scale, bias = _inputs(b, h, w, c, seed=11)
    wgt = np.random.RandomState(12).randn(b, h, w, c).astype(np.float32)

    def loss(xx, ss, bb):
        return jnp.sum(jgn.group_norm(xx, ss, bb, groups, 1e-5, act) * wgt)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale),
                                             jnp.asarray(bias))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    st = torch.from_numpy(scale).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    y = gn.group_norm(xt, st, bt, groups, 1e-5, act)
    assert y.grad_fn is not None and "GroupNormFunction" in type(y.grad_fn).__name__
    (y * torch.from_numpy(wgt).permute(0, 3, 1, 2)).sum().backward()
    got = (xt.grad.permute(0, 2, 3, 1).numpy(), st.grad.numpy(), bt.grad.numpy())
    # both differentiate the plain fp32 formula: summation order only
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(wnt), atol=2e-4, rtol=2e-4)


def test_layout_and_shared_memory_rule():
    x = torch.empty(2, 64, 8, 8, device="meta")
    assert gn.layout(x) == "nchw"
    assert gn.layout(x.to(memory_format=torch.channels_last)) == "nhwc"
    with pytest.raises(ValueError, match="contiguous or channels-last"):
        gn.layout(x.transpose(2, 3))
    with pytest.raises(ValueError, match="contiguous or channels-last"):
        gn.layout(torch.empty(2, 64, 8, 16, device="meta")[..., ::2])
    limit = 232448  # the H100's opt-in shared memory per block
    assert gn.fused_fits(640, 32, 64 * 64, 2, limit)       # 160 KB span
    assert not gn.fused_fits(960, 32, 64 * 64, 2, limit)   # 240 KB
    assert not gn.fused_fits(512, 32, 128 * 128, 2, limit)  # the VAE decoder at 128^2
    assert not gn.fused_fits(640, 32, 64 * 64, 4, limit)   # fp32 doubles the span
    assert gn.fused_header_bytes(10) % 16 == 0


def test_vector_width_and_split_count():
    """The pair's vector (16 bytes where the channel count or the plane and
    both pointers allow) and its bands (about 4 blocks an SM in one wave,
    at least 16 pixel rows a block)."""
    assert gn._vec(2, 40, 16) == 8
    assert gn._vec(2, 10, 16) == 2
    assert gn._vec(2, 3, 16) == 1
    assert gn._vec(4, 64, 16) == 4
    assert gn._vec(2, 64, 2) == 1
    # NHWC: a batch row's pixel rows over 4 blocks an SM; NCHW: per plane
    assert gn.pair_plan(2, 128, 512 * 512, 2, "nhwc", 132, 0, 0).bands == 264
    assert gn.pair_plan(2, 128, 512 * 512, 2, "nchw", 132, 0, 0).bands == 3
    assert gn.pair_plan(1, 32, 20, 2, "nhwc", 132, 0, 0).bands == 1


@pytest.fixture
def recorder(monkeypatch):
    """Replace the kernels' entry points: record each call, return 0."""
    calls = []

    def kernel(name):
        if name == "gn_smem_optin":
            return lambda dev: 232448
        return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(_build, "kernel", kernel)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    gn.reset_launch_counts()
    yield calls
    gn.reset_launch_counts()


def test_wrappers_pass_layout_vector_and_split_to_the_kernels(recorder):
    cl = torch.empty(2, 640, 64, 64, device="meta", dtype=torch.bfloat16).to(
        memory_format=torch.channels_last)
    scale = torch.empty(640, device="meta", dtype=torch.bfloat16)
    gn.gn_fused(cl, scale, scale, 32, 1e-5, "silu", torch.empty_like(cl), 132, 232448)
    name, args = recorder[-1]
    # x, scale, bias, y, is_bf16, param_bf16, B, C, S, G, eps, nhwc, act,
    # group_set, cluster, vec, tma
    assert name == "gn_fused" and len(args) == len(_build.SIGNATURES["gn_fused"][1])
    assert args[4:10] == (1, 1, 2, 640, 4096, 32) and args[11:13] == (1, 1)
    # 2 groups of 20 channels: 80-byte runs, 16 bytes a load, over 16-block
    # clusters (2 rows x 16 sets x 16 = 512 blocks, within 4 an SM: the
    # threads' own loads)
    assert args[13:17] == (2, 16, 8, 0)
    flat = torch.empty(2, 640, 64, 64, device="meta", dtype=torch.bfloat16)
    gn.gn_fused(flat, scale, scale, 32, 1e-5, None, torch.empty_like(flat), 132, 232448)
    # NCHW: one group a unit, vector loads over 16-block clusters
    assert recorder[-1][1][11:17] == (0, 0, 1, 16, 8, 0)
    ab = gn.gn_stats(cl, scale, scale, 32, 1e-5, 132)
    assert tuple(ab.shape) == (2, 2, 640) and ab.dtype == torch.float32
    name, args = recorder[-1]
    # ..., is_bf16, param_bf16, B, C, S, G, eps, nhwc, vec, threads, bands, rows
    assert name == "gn_stats" and len(args) == len(_build.SIGNATURES["gn_stats"][1])
    # 80 vector columns x 3 rows of threads; 4096 rows in 256 bands of 16
    assert args[6:12] == (1, 1, 2, 640, 4096, 32) and args[13:18] == (1, 8, 240, 256, 16)
    gn.gn_apply(cl, ab, None, torch.empty_like(cl), 132)
    name, args = recorder[-1]
    # x, ab, y, is_bf16, B, C, S, nhwc, act, vec, threads, bands, rows
    assert name == "gn_apply" and len(args) == len(_build.SIGNATURES["gn_apply"][1])
    assert args[3:13] == (1, 2, 640, 4096, 1, 0, 8, 240, 256, 16)
    x = torch.empty(1, 32, 9, 7, device="meta")  # NCHW fp32, odd H*W
    f32 = torch.empty(32, device="meta")
    gn.gn_apply(x, torch.empty(1, 2, 32, device="meta"), "silu", torch.empty_like(x), 132)
    # NCHW, one element a load, one band of each 63-element plane, two warps
    assert recorder[-1][1][7:13] == (0, 1, 1, 64, 1, 63)
    gn.gn_stats(x, f32, f32, 32, 1e-5, 132)
    assert recorder[-1][1][6:8] == (0, 0)  # fp32 x, fp32 params
    assert recorder[-1][1][13:18] == (0, 1, 64, 1, 63)
    plan = gn.pair_plan(1, 32, 63, 4, "nchw", 132, 0, 0)
    assert gn.pair_smem_bytes("nchw", 32, 32, plan) == 4 * 4 * 64  # the finish's 4 x 64 floats
    assert gn.launch_counts == {"gn_fused": 2, "gn_stats": 2, "gn_apply": 2}
    # the row counters are made once per stream and set back by the kernel
    assert len(gn._counters) == 1
    assert gn.launch_shapes[("gn_stats", (2, 640, 64, 64))] == 1
    with pytest.raises(TypeError, match="bf16 or fp32"):
        gn._check(x.half(), f32, f32, 32)
    with pytest.raises(ValueError, match="groups"):
        gn._check(x, f32, f32, 5)


H100 = (132, 232448)  # SMs, opt-in shared memory a block


@pytest.mark.parametrize("shape, itemsize, lay, want", [
    # the main path's shapes (bf16, channels-last, 16-byte aligned): runs of
    # 80 bytes (cpg 10, 20, 40) or 64 (cpg 16); clusters grow until 4
    # blocks an SM, keeping >= 8 KB a slice; TMA only where the grid has
    # more blocks than that (1024 at 64^2 x 640)
    ((4, 320, 64 * 64), 2, "nhwc", (4, 16, 8, 0)),
    ((2, 320, 64 * 64), 2, "nhwc", (4, 16, 8, 0)),
    ((4, 640, 64 * 64), 2, "nhwc", (2, 16, 8, 1)),
    ((4, 640, 32 * 32), 2, "nhwc", (2, 8, 8, 0)),
    ((4, 1280, 16 * 16), 2, "nhwc", (1, 2, 8, 0)),
    ((4, 1280, 8 * 8), 2, "nhwc", (1, 1, 8, 0)),
    ((1, 512, 64 * 64), 2, "nhwc", (2, 16, 8, 0)),
    # fp32: twice the bytes a channel, so half the groups a set (and twice
    # the blocks: TMA)
    ((4, 320, 64 * 64), 4, "nhwc", (2, 16, 4, 1)),
    # NCHW: one group a unit (its span is contiguous), vector loads only
    ((4, 320, 64 * 64), 2, "nchw", (1, 8, 8, 0)),
    ((4, 1280, 8 * 8), 4, "nchw", (1, 1, 4, 0)),
    # cpg 9 in 4 groups: the one set of >= 64 bytes is all four (72 bytes,
    # no multiple of 16): 8-byte loads, no TMA; two blocks of 9 KB
    ((2, 36, 15 * 17), 2, "nhwc", (4, 2, 4, 0)),
    # cpg 3: the smallest set of >= 64 bytes is 16 groups (96 bytes)
    ((2, 96, 7 * 9), 2, "nhwc", (16, 1, 8, 0)),
    # 5 groups of 10 (a group count with no set of >= 64 bytes but all):
    # one 100-byte run, 4-byte loads
    ((2, 50, 9 * 7), 2, "nhwc", (5, 1, 2, 0)),
])
def test_fused_plan(shape, itemsize, lay, want):
    b, c, s = shape
    groups = 4 if c == 36 else 5 if c == 50 else 32
    plan = gn.fused_plan(b, c, s, groups, itemsize, lay, *H100, 4096, 8192)
    assert tuple(plan) == want
    assert gn.fused_smem_bytes(lay, c, s, groups, itemsize, plan) <= H100[1]


@pytest.mark.parametrize("x_ptr, y_ptr, want", [
    (4096 + 2, 8192, (2, 16, 1, 0)),   # x one element in: vector loads, 2 bytes each
    (4096, 8192 + 8, (2, 16, 4, 1)),   # y off 16 bytes: TMA loads, 8-byte stores
    (4096 + 16, 8192, (2, 16, 8, 1)),  # 16-byte aligned: as at the base
])
def test_fused_plan_follows_pointer_alignment(x_ptr, y_ptr, want):
    # [4,640,64,64]: 1024 blocks, so TMA where the pointers allow it
    assert tuple(gn.fused_plan(4, 640, 4096, 32, 2, "nhwc", *H100, x_ptr, y_ptr)) == want


@pytest.mark.parametrize("shape, groups, smem_limit", [
    ((4, 640, 64 * 64), 32, 48 * 1024),   # a small limit: clusters grow until a slice fits
    ((1, 602, 6 * 5), 2, 232448),          # 301 channels a set: more vectors than threads
    ((1, 64, 1), 32, 232448),              # one pixel
])
def test_fused_plan_fits_shared_memory(shape, groups, smem_limit):
    b, c, s = shape
    plan = gn.fused_plan(b, c, s, groups, 2, "nhwc", 132, smem_limit, 0, 0)
    assert gn.fused_smem_bytes("nhwc", c, s, groups, 2, plan) <= smem_limit
    assert plan.cluster <= 16 and groups % plan.group_set == 0


def test_fused_plan_refuses_what_no_cluster_fits():
    with pytest.raises(ValueError, match="does not fit"):
        gn.fused_plan(1, 32, 512 * 512, 1, 4, "nhwc", 132, 48 * 1024, 0, 0)


PAIR_EDGES = [
    # (B, C, S, itemsize, layout, x_ptr, y_ptr) -> (vec, threads, bands, rows)
    # B = 1 at the UNet's 960 channels: 120 vector columns x 2 rows of threads
    ((1, 960, 4096, 2, "nhwc", 0, 0), (8, 240, 256, 16)),
    # 10000 pixel rows in bands of 38: the last band holds 6
    ((2, 256, 10000, 2, "nhwc", 0, 0), (8, 256, 264, 38)),
    # C = 36, 50, 45: vectors of 4, 2 and 1 bf16 values
    ((2, 36, 255, 2, "nhwc", 0, 0), (4, 252, 15, 17)),
    ((2, 50, 323, 2, "nhwc", 0, 0), (2, 250, 19, 17)),
    ((1, 45, 256, 2, "nhwc", 0, 0), (1, 225, 16, 16)),
    # x one element off 16 bytes: one element a load; y off 8: four (for
    # gn_apply, which writes y)
    ((2, 128, 4096, 2, "nhwc", 4098, 8192), (1, 256, 256, 16)),
    ((2, 128, 4096, 2, "nhwc", 4096, 8200), (4, 256, 256, 16)),
    # fp32: four values a load, the same bands
    ((2, 128, 512 * 512, 4, "nhwc", 0, 0), (4, 256, 264, 993)),
    # 320 vector columns: 256 threads in one row, a column loop
    ((1, 2560, 81, 2, "nhwc", 0, 0), (8, 256, 5, 17)),
    # one pixel
    ((1, 64, 1, 2, "nhwc", 0, 0), (8, 256, 1, 1)),
    # NCHW: bands of each plane, a multiple of the vector; as many warps as
    # a band's vectors need
    ((2, 128, 512 * 512, 2, "nchw", 0, 0), (8, 256, 3, 87384)),
    ((1, 32, 63, 4, "nchw", 0, 0), (1, 64, 1, 63)),
    ((3, 32, 25, 2, "nchw", 0, 0), (1, 32, 1, 25)),
    ((2, 128, 4096, 2, "nchw", 4098, 4096), (1, 256, 1, 4096)),
    ((1, 1280, 64, 4, "nchw", 0, 0), (4, 32, 1, 64)),
]


@pytest.mark.parametrize("case, want", PAIR_EDGES)
def test_pair_plan(case, want):
    """gn_apply's plan (x -> y); gn_stats' (x alone) has the same bands, so
    that gn_apply finds the rows gn_stats read last still in L2."""
    b, c, s, itemsize, lay, x_ptr, y_ptr = case
    plan = gn.pair_plan(b, c, s, itemsize, lay, 132, x_ptr, y_ptr)
    assert tuple(plan) == want
    stats = gn.pair_plan(b, c, s, itemsize, lay, 132, x_ptr, x_ptr)
    if lay == "nhwc":  # the bands follow from the shape alone
        assert (stats.bands, stats.rows) == (plan.bands, plan.rows)
    if x_ptr % 16 == y_ptr % 16:
        assert stats == plan
    groups = 5 if c in (45, 50) else 4 if c == 36 else 32
    assert gn.pair_smem_bytes(lay, c, groups, stats) <= 232448


def _ab_script():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "torch_gn_ab.py"
    spec = importlib.util.spec_from_file_location("torch_gn_ab", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


AB_PATCHES = [
    ("ABLATIONS", "no_loads"), ("ABLATIONS", "no_stores"), ("ABLATIONS", "no_apply_math"),
    ("ABLATIONS", "no_cluster"), ("PAIR_ABLATIONS", "no_finish"),
    ("PAIR_ABLATIONS", "no_stores"), ("PAIR_ABLATIONS", "apply_empty"),
    ("PAIR_BUILDS", "forward"), ("PAIR_BUILDS", "stcs"),
]


@pytest.mark.parametrize("table, name", AB_PATCHES)
def test_ab_script_patches_apply_to_the_kernel_source(table, name):
    """scripts/torch_gn_ab.py builds its ablations and source variants by
    replacing text of csrc/groupnorm.cu: each text is still there, and the
    patched source differs from the tree's (the cases are all the script's
    patches)."""
    ab = _ab_script()
    assert sorted(getattr(ab, table)) == sorted(n for t, n in AB_PATCHES if t == table)
    text = open(ab.os.path.join(ab.CSRC, "groupnorm.cu")).read()
    patched = text
    for old, new in getattr(ab, table)[name]:
        assert old in patched, f"{table}[{name!r}]: {old[:60]!r} is not in groupnorm.cu"
        patched = patched.replace(old, new)
    assert patched != text
