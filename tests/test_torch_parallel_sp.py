"""The port's sequence-parallel ring (``parallel/sp.py``) and
``flash_attention_lse`` against the JAX package's on the same numpy inputs:
the ring on ``["cpu"] * n`` meshes against JAX's ``sp_attention`` on its
8-virtual-device mesh (forward and the q, k and v gradients, the lse
cotangent carrying the softmax normalisation across shards), and the port's
``flash_attention_lse`` (its plain version on the CPU) against the JAX
Pallas kernel run in interpret mode, both cotangents."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distdiff_tpu.ops import flash as j_flash
from distdiff_tpu.parallel import sp as j_sp
from distdiff_tpu_torch.ops import flash
from distdiff_tpu_torch.ops.attention import xla_attention
from distdiff_tpu_torch.parallel import sp

torch.set_num_threads(1)


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a), requires_grad=True)


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


def test_flash_attention_lse_matches_the_jax_kernel_in_interpret_mode(monkeypatch):
    """o and lse at 2e-4, the gradients of sum(o * w_o) + sum(lse * w_l) at
    5e-4 (the JAX test's own tolerances)."""
    monkeypatch.setattr(j_flash, "INTERPRET", True)
    q, k, v = _rand((1, 48, 2, 16), 3), _rand((1, 40, 2, 16), 4), _rand((1, 40, 2, 16), 5)
    w_o, w_l = _rand((1, 48, 2, 16), 6), _rand((1, 48, 2), 7)

    def jloss(q, k, v):
        out, lse = j_flash.flash_attention_lse(q, k, v)
        return jnp.sum(out * w_o) + jnp.sum(lse * w_l), (out, lse)

    (_, (jo, jl)), jg = jax.value_and_grad(jloss, (0, 1, 2), has_aux=True)(q, k, v)
    tq, tk, tv = _t(q), _t(k), _t(v)
    o, lse = flash.flash_attention_lse(tq, tk, tv)
    assert o.shape == (1, 48, 2, 16) and lse.shape == (1, 48, 2) and lse.dtype == torch.float32
    _close(o, jo, 2e-4)
    _close(lse, jl, 2e-4)
    loss = (o * torch.from_numpy(w_o)).sum() + (lse * torch.from_numpy(w_l)).sum()
    for got, want in zip(torch.autograd.grad(loss, (tq, tk, tv)), jg):
        _close(got, want, 5e-4)


def test_a_zero_lse_cotangent_gives_flash_attentions_gradients():
    q, k, v = (_t(_rand((2, 300, 2, 8), s)) for s in (1, 2, 3))
    w = torch.from_numpy(_rand((2, 300, 2, 8), 4))
    want = torch.autograd.grad((flash.flash_attention(q, k, v) * w).sum(), (q, k, v))
    got = torch.autograd.grad((flash.flash_attention_lse(q, k, v)[0] * w).sum(), (q, k, v))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.fixture(scope="module")
def jax_ring():
    """JAX's ring on 2- and 4-device seq meshes: outputs and gradients."""
    q, k, v, w = (_rand((2, 64, 2, 8), s) for s in (10, 11, 12, 13))
    out = {}
    for n in (2, 4):
        mesh = j_sp.make_sp_mesh(n)

        def loss(q, k, v, mesh=mesh):
            o = j_sp.sp_attention(q, k, v, mesh)
            return jnp.sum(o * w), o

        (_, o), g = jax.jit(jax.value_and_grad(loss, (0, 1, 2), has_aux=True))(q, k, v)
        out[n] = (np.asarray(o), [np.asarray(a) for a in g])
    return (q, k, v, w), out


@pytest.mark.parametrize("n", [2, 4])
def test_sp_attention_matches_the_jax_ring(jax_ring, n):
    """Forward and gradients at 1e-5 against JAX's ring and against the
    unsharded plain attention."""
    (q, k, v, w), want = jax_ring
    tq, tk, tv = _t(q), _t(k), _t(v)
    mesh = sp.make_sp_mesh(n, ["cpu"] * n)
    o = sp.sp_attention(tq, tk, tv, mesh)
    _close(o, want[n][0], 1e-5)
    _close(o, xla_attention(*(torch.from_numpy(a) for a in (q, k, v))), 1e-5)
    grads = torch.autograd.grad((o * torch.from_numpy(w)).sum(), (tq, tk, tv))
    for got, jg in zip(grads, want[n][1]):
        _close(got, jg, 1e-5)


def test_the_ring_never_changes_the_shards_it_sends():
    q, k, v = (torch.from_numpy(_rand((1, 32, 2, 8), s)) for s in (50, 51, 52))
    ks, vs = [k[:, :16].clone(), k[:, 16:].clone()], [v[:, :16].clone(), v[:, 16:].clone()]
    before = [t.clone() for t in ks + vs]
    outs = sp.ring_attention([q[:, :16], q[:, 16:]], ks, vs, [torch.device("cpu")] * 2)
    assert all(torch.equal(a, b) for a, b in zip(ks + vs, before))
    _close(torch.cat(outs, 1), xla_attention(q, k, v), 1e-5)


def test_xla_attention_lse_and_the_cross_attention_match_jax():
    q = _rand((2, 64, 2, 8), 40)
    k, v = _rand((2, 12, 2, 8), 41), _rand((2, 12, 2, 8), 42)
    jmesh = j_sp.make_sp_mesh(4)
    (jo, jl), jx = jax.jit(lambda q, k, v: (j_sp.xla_attention_lse(q, k, v),
                                            j_sp.sp_cross_attention(q, k, v, jmesh)))(q, k, v)
    o, lse = sp.xla_attention_lse(*(torch.from_numpy(a) for a in (q, k, v)))
    _close(o, jo, 1e-5)
    _close(lse, jl, 1e-5)
    mesh = sp.make_sp_mesh(4, ["cpu"] * 4)
    _close(sp.sp_cross_attention(*(torch.from_numpy(a) for a in (q, k, v)), mesh), jx, 1e-5)
