"""The port's plain flash-attention versions against the JAX package's Pallas
kernels (run in interpret mode) and their ``jax.vjp``, and the port's
attention dispatch on the CPU.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
each of them against these plain versions at the main path's shapes."""

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
