"""The port's plain flash-attention versions against the JAX package's Pallas
kernels (run in interpret mode) and their ``jax.vjp``, and the port's
attention dispatch on the CPU.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each of them against these plain versions at the main path's shapes."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distdiff_tpu.ops.flash as jflash
from distdiff_tpu.ops.attention import xla_attention as j_xla_attention
from distdiff_tpu.ops.attention import xla_attention_hm as j_xla_attention_hm
from distdiff_tpu_torch.ops import attention, flash

torch.set_num_threads(1)

SHAPES = [
    (1, 128, 128, 2, 40),   # UNet head width, one kv block
    (1, 300, 130, 2, 40),   # ragged q and kv
    (1, 200, 77, 2, 64),    # cross-attention length
    (1, 129, 65, 2, 80),    # the 32^2 head width, lengths off the Hopper kernels' tiles
    (1, 127, 63, 1, 33),    # an odd head width (the kernels' staged loads)
    (2, 128, 128, 1, 160),  # D > 128: the reference's split backward
    (1, 256, 256, 1, 512),  # the VAE's single 512-wide head
    (1, 65, 63, 1, 130),    # a wide width TMA cannot load, lengths off the 64-row tiles
    (1, 63, 129, 1, 257),   # past 256: the wide forward's 512 instance
]


def _to3d(x):
    """[B, T, H, D] numpy -> [B*H, T, D] torch."""
    b, t, h, d = x.shape
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * h, t, d)))


def _from3d(x, b, h):
    bh, t, d = x.shape
    return x.reshape(b, h, t, d).permute(0, 2, 1, 3).numpy()


def _inputs(b, tq, tk, h, d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, tq, h, d).astype(np.float32)
    k = rng.randn(b, tk, h, d).astype(np.float32)
    v = rng.randn(b, tk, h, d).astype(np.float32)
    g = rng.randn(b, tq, h, d).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("b,tq,tk,h,d", SHAPES)
def test_plain_flash_matches_pallas_interpret(monkeypatch, b, tq, tk, h, d):
    monkeypatch.setattr(jflash, "INTERPRET", True)
    q, k, v, g = _inputs(b, tq, tk, h, d)
    out, vjp = jax.vjp(jflash.flash_attention, jnp.asarray(q), jnp.asarray(k),
                       jnp.asarray(v))
    jdq, jdk, jdv = vjp(jnp.asarray(g))

    q3, k3, v3, g3 = (_to3d(x) for x in (q, k, v, g))
    o3, lse3 = flash.flash_fwd_reference(q3, k3, v3)
    # fp32 softmax attention both sides; the kernel's online softmax and the
    # plain logsumexp differ in summation order only
    np.testing.assert_allclose(_from3d(o3, b, h), np.asarray(out), atol=2e-5, rtol=0)
    dq3, dk3, dv3 = flash.flash_bwd_reference(q3, k3, v3, o3, lse3, g3)
    # gradients sum over up to 300 keys of O(1) terms: 1e-4 absolute
    for got, want in ((dq3, jdq), (dk3, jdk), (dv3, jdv)):
        np.testing.assert_allclose(_from3d(got, b, h), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("b,tq,tk,h,d", [(1, 300, 130, 2, 40), (1, 256, 256, 1, 512)])
def test_autograd_function_on_cpu_matches_plain_attention(b, tq, tk, h, d):
    """FlashAttention's backward (fused for D <= 128, split otherwise) on CPU
    tensors equals autograd through the plain attention."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(b, tq, tk, h, d, seed=3))
    qs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    qr = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = flash.flash_attention(*qs)
    ref = attention.xla_attention(*qr)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=2e-5, rtol=0)
    (out * g).sum().backward()
    (ref * g).sum().backward()
    for a, r in zip(qs, qr):
        np.testing.assert_allclose(a.grad.numpy(), r.grad.numpy(), atol=1e-4, rtol=0)
    assert sum(flash.launch_counts.values()) == 0  # CPU tensors launch nothing


@pytest.mark.parametrize("tk", [77, 256, 300])
def test_attention_dispatch_matches_jax_on_cpu(tk):
    q, k, v, _ = _inputs(2, 96, tk, 2, 40, seed=1)
    got = attention.attention(*(torch.from_numpy(x) for x in (q, k, v)))
    want = j_xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    qh, kh, vh = (np.ascontiguousarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v))
    got = attention.attention_hm(*(torch.from_numpy(x) for x in (qh, kh, vh)))
    want = j_xla_attention_hm(jnp.asarray(qh), jnp.asarray(kh), jnp.asarray(vh))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_flash_attention_hm_layout_matches_bthd():
    q, k, v, _ = _inputs(2, 64, 300, 2, 40, seed=2)
    bthd = flash.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
    hm = flash.flash_attention_hm(*(torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 2, 1, 3))) for x in (q, k, v)))
    np.testing.assert_allclose(hm.permute(0, 2, 1, 3).numpy(), bthd.numpy(),
                               atol=1e-6, rtol=0)


def _ablate_script():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "torch_flash_ablate.py"
    spec = importlib.util.spec_from_file_location("torch_flash_ablate", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


WIDE_BWD_VARIANTS = ["wide_bwd", "wide_bwd without exponentials",
                     "wide_bwd without output products", "wide_bwd without score products",
                     "wide_bwd without stream loads", "wide_bwd loads only"]


@pytest.mark.parametrize("name", WIDE_BWD_VARIANTS)
def test_ablation_patches_apply_to_the_split_pair(name):
    """scripts/torch_flash_ablate.py builds the split pair's ablations by
    replacing text of csrc/flash_bwd.cu: each text is still there, once, and
    the patched source differs from the tree's (the cases are all of the
    script's wide_bwd set)."""
    ab = _ablate_script()
    assert sorted(n for n in ab.VARIANTS if n.startswith("wide_bwd")) == sorted(WIDE_BWD_VARIANTS)
    src, subs, shapes = ab.VARIANTS[name]
    assert src == "flash_bwd.cu" and shapes == ab.WIDE
    text = open(os.path.join(ab.CSRC, src)).read()
    patched = text
    for old, new in subs:
        assert patched.count(old) == 1, f"{name}: {old[:60]!r} is not once in {src}"
        patched = patched.replace(old, new)
    assert (patched != text) == bool(subs)


F32_BWD_VARIANTS = ["f32_bwd", "f32_bwd one TF32 product", "f32_bwd without exponentials",
                    "f32_bwd without stream loads", "f32_bwd loads only", "f32_bwd compute only"]


@pytest.mark.parametrize("name", F32_BWD_VARIANTS)
def test_ablation_patches_apply_to_the_fp32_split_pair(name):
    """The fp32 split pair's ablations are text of csrc/flash_f32.cu, each
    still there once (the cases are all of the script's f32_bwd set)."""
    ab = _ablate_script()
    assert sorted(n for n in ab.VARIANTS if n.startswith("f32_bwd")) == sorted(F32_BWD_VARIANTS)
    src, subs, shapes = ab.VARIANTS[name]
    assert src == "flash_f32.cu" and shapes == ab.WIDE_F32
    text = open(os.path.join(ab.CSRC, src)).read()
    patched = text
    for old, new in subs:
        assert patched.count(old) == 1, f"{name}: {old[:60]!r} is not once in {src}"
        patched = patched.replace(old, new)
    assert (patched != text) == bool(subs)


NARROW_F32_VARIANTS = ["narrow_f32", "narrow_f32 one TF32 product",
                       "narrow_f32 without exponentials", "narrow_f32 without k/v loads",
                       "narrow_f32 loads only"]


@pytest.mark.parametrize("name", NARROW_F32_VARIANTS)
def test_ablation_patches_apply_to_the_fp32_narrow_forward(name):
    """The fp32 narrow forward's ablations are text of csrc/flash_f32.cu,
    each still there once (the cases are all of the script's narrow_f32
    set), timed at the UNet's two shapes."""
    ab = _ablate_script()
    assert sorted(n for n in ab.VARIANTS if n.startswith("narrow_f32")) == sorted(
        NARROW_F32_VARIANTS)
    src, subs, shapes = ab.VARIANTS[name]
    assert src == "flash_f32.cu" and shapes == ab.NARROW_F32
    text = open(os.path.join(ab.CSRC, src)).read()
    patched = text
    for old, new in subs:
        assert patched.count(old) == 1, f"{name}: {old[:60]!r} is not once in {src}"
        patched = patched.replace(old, new)
    assert (patched != text) == bool(subs)


WIDE_F32_VARIANTS = ["wide_f32", "wide_f32 one TF32 product", "wide_f32 without exponentials",
                     "wide_f32 without k/v loads", "wide_f32 loads only"]


@pytest.mark.parametrize("name", WIDE_F32_VARIANTS)
def test_ablation_patches_apply_to_the_fp32_wide_forward(name):
    """The fp32 wide forward's ablations are text of csrc/flash_f32.cu, each
    still there once (the cases are all of the script's wide_f32 set)."""
    ab = _ablate_script()
    assert sorted(n for n in ab.VARIANTS if n.startswith("wide_f32")) == sorted(WIDE_F32_VARIANTS)
    src, subs, shapes = ab.VARIANTS[name]
    assert src == "flash_f32.cu" and shapes == ab.WIDE_F32
    text = open(os.path.join(ab.CSRC, src)).read()
    patched = text
    for old, new in subs:
        assert patched.count(old) == 1, f"{name}: {old[:60]!r} is not once in {src}"
        patched = patched.replace(old, new)
    assert (patched != text) == bool(subs)


FUSED_F32_VARIANTS = ["fused_f32", "fused_f32 one TF32 product", "fused_f32 without exponentials",
                      "fused_f32 without q/do loads", "fused_f32 without dq's reduce-add",
                      "fused_f32 without dq's product", "fused_f32 without dk's and dv's products",
                      "fused_f32 loads only"]


@pytest.mark.parametrize("name", FUSED_F32_VARIANTS)
def test_ablation_patches_apply_to_the_fp32_fused_backward(name):
    """The fp32 fused backward's ablations are text of csrc/flash_f32.cu,
    each still there once (the cases are all of the script's fused_f32
    set), timed at the UNet's two shapes."""
    ab = _ablate_script()
    assert sorted(n for n in ab.VARIANTS if n.startswith("fused_f32")) == sorted(
        FUSED_F32_VARIANTS)
    src, subs, shapes = ab.VARIANTS[name]
    assert src == "flash_f32.cu" and shapes == ab.NARROW_F32
    text = open(os.path.join(ab.CSRC, src)).read()
    patched = text
    for old, new in subs:
        assert patched.count(old) == 1, f"{name}: {old[:60]!r} is not once in {src}"
        patched = patched.replace(old, new)
    assert (patched != text) == bool(subs)


def test_fused_probe_needs_a_card(monkeypatch):
    """scripts/torch_fused_f32_probe.py times and checks on the card only:
    without one it exits with 2 before building anything."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "torch_fused_f32_probe.py"
    spec = importlib.util.spec_from_file_location("torch_fused_f32_probe", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mod.main() == 2


def _tf32_high(x, nearest):
    """x's TF32 high part: its top 19 bits (sign, exponent, 10 mantissa
    bits), rounded to nearest (half a TF32 unit added first) or truncated,
    as the tensor cores read a register."""
    bits = x.view(torch.int32)
    if nearest:
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


def _tf32_matmul(a, b, products):
    """a @ b in fp32 from TF32 operands: one product of the operands rounded
    to nearest (TF32 mode), or 3xTF32 as csrc/flash_f32.cu's tensor-core
    kernels (the narrow and wide forwards, the split backward pair) form
    it: the high
    parts truncated, the exact remainders x - hi as low parts (truncated
    again), lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b)."""
    if products == 1:
        return _tf32_high(a, True) @ _tf32_high(b, True)
    ah, bh = _tf32_high(a, False), _tf32_high(b, False)
    al, bl = _tf32_high(a - ah, False), _tf32_high(b - bh, False)
    return al @ bh + ah @ bl + ah @ bh


def _attention(q, k, v, matmul):
    s = matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    lse = torch.logsumexp(s, dim=-1)
    return matmul(torch.exp(s - lse[..., None]), v), lse


@pytest.mark.parametrize("products", [3, 1])
@pytest.mark.parametrize("d,tq,tk", [(160, 65, 63), (512, 63, 129),
                                     (16, 65, 63), (40, 129, 127), (128, 63, 129)])
def test_three_tf32_products_keep_fp32_accuracy(d, tq, tk, products):
    """Why the fp32 forward runs three TF32 products a product, narrow (D <=
    128) and wide: with them o meets chip_smoke.py's fp32 tolerance (1e-4
    of the largest magnitude, lse 1e-4) against fp64 attention; one TF32
    product misses it (both s = q k^T and o = p v emulated in fp32 on the
    CPU)."""
    rng = np.random.RandomState(d)
    q, k, v = (torch.from_numpy(rng.randn(2, t, d).astype(np.float32)) for t in (tq, tk, tk))
    ref_o, ref_lse = _attention(q.double(), k.double(), v.double(), torch.matmul)
    o, lse = _attention(q, k, v, lambda a, b: _tf32_matmul(a, b, products))
    err_o = float((o.double() - ref_o).abs().max() / ref_o.abs().max())
    err_lse = float((lse.double() - ref_lse).abs().max())
    if products == 3:
        assert err_o <= 1e-5 and err_lse <= 1e-5
    else:
        assert err_o > 2e-4 and err_lse > 1e-4


def _split_grads(q, k, v, do, lse, delta, matmul):
    """(dq, dk, dv) by the split pair's formulas, every product by matmul."""
    scale = q.shape[-1] ** -0.5
    p = torch.exp(matmul(q, k.transpose(-1, -2)) * scale - lse[..., None])
    ds = p * (matmul(do, v.transpose(-1, -2)) - delta[..., None]) * scale
    return matmul(ds, k), matmul(ds.transpose(-1, -2), q), matmul(p.transpose(-1, -2), do)


@pytest.mark.parametrize("products", [3, 1])
@pytest.mark.parametrize("d,tq,tk", [(160, 65, 63), (512, 63, 129)])
def test_three_tf32_products_keep_the_split_backward_at_fp32_accuracy(d, tq, tk, products):
    """Why the fp32 split pair runs three TF32 products a product: with them
    its five products (s, dp, dq, dk, dv) meet chip_smoke.py's fp32
    tolerance (1e-4 of the largest magnitude) against fp64 gradients; one
    TF32 product misses it. The lse and delta the pair takes are fp64's,
    rounded to fp32, so the error is the pair's own."""
    rng = np.random.RandomState(d + 1)
    q, do = (torch.from_numpy(rng.randn(2, tq, d).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(2, tk, d).astype(np.float32)) for _ in range(2))
    q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
    s = torch.matmul(q64, k64.transpose(-1, -2)) * d ** -0.5
    lse = torch.logsumexp(s, dim=-1)
    delta = (torch.matmul(torch.exp(s - lse[..., None]), v64) * do64).sum(-1)
    want = _split_grads(q64, k64, v64, do64, lse, delta, torch.matmul)
    got = _split_grads(q, k, v, do, lse.float(), delta.float(),
                       lambda a, b: _tf32_matmul(a, b, products))
    errs = [float((g.double() - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]
    if products == 3:
        assert max(errs) <= 1e-5
    else:
        assert min(errs) > 2e-4


def _fused_grads(q, k, v, do, lse, delta, matmul, bq=32, kq=32):
    """(dq, dk, dv) as csrc/flash_f32.cu's fused backward sums them, every
    product by matmul: s and dp over the head width, dk and dv a q tile of
    bq rows at a time and dq a quarter of a 128-row kv block (kq rows) at a
    time, each part summed from zero and the parts added in fp32."""
    scale = q.shape[-1] ** -0.5
    p = torch.exp(matmul(q, k.transpose(-1, -2)) * scale - lse[..., None])
    ds = p * (matmul(do, v.transpose(-1, -2)) - delta[..., None]) * scale
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    for r in range(0, q.shape[1], bq):
        dv += matmul(p[:, r:r + bq].transpose(-1, -2), do[:, r:r + bq])
        dk += matmul(ds[:, r:r + bq].transpose(-1, -2), q[:, r:r + bq])
    dq = torch.zeros_like(q)
    for c in range(0, k.shape[1], kq):
        dq += matmul(ds[:, :, c:c + kq], k[:, c:c + kq])
    return dq, dk, dv


@pytest.mark.parametrize("products", [3, 1])
@pytest.mark.parametrize("d,tq,tk", [(16, 65, 63), (40, 129, 127), (128, 63, 129)])
def test_three_tf32_products_keep_the_fused_backward_at_fp32_accuracy(d, tq, tk, products):
    """Why the fp32 fused backward runs three TF32 products a product: with
    them its five products, each q tile's (and each quarter of the kv rows'
    for dq) summed from zero, stay within 1e-5 of the largest magnitude of
    fp64 gradients, inside chip_smoke.py's 2e-5 against fp64; one TF32
    product misses by far. The lse and delta it takes are fp64's, rounded
    to fp32, so the error is the kernel's own."""
    rng = np.random.RandomState(d + 2)
    q, do = (torch.from_numpy(rng.randn(2, tq, d).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(2, tk, d).astype(np.float32)) for _ in range(2))
    q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
    s = torch.matmul(q64, k64.transpose(-1, -2)) * d ** -0.5
    lse = torch.logsumexp(s, dim=-1)
    delta = (torch.matmul(torch.exp(s - lse[..., None]), v64) * do64).sum(-1)
    want = _split_grads(q64, k64, v64, do64, lse, delta, torch.matmul)
    got = _fused_grads(q, k, v, do, lse.float(), delta.float(),
                       lambda a, b: _tf32_matmul(a, b, products), bq=16 if d > 96 else 32)
    errs = [float((g.double() - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]
    if products == 3:
        assert max(errs) <= 1e-5
    else:
        assert min(errs) > 2e-4
