"""Sequence-parallel (ring) attention over a mesh axis (port of
``distdiff_tpu/parallel/sp.py``).

When one device cannot hold one image's attention activations, the token
axis is split over the ``seq`` axis and attention stays exact with a ring:

  * device i holds the ``[B, T/n, H, D]`` shard i of q, k and v;
  * ``n`` ring steps: each device runs the local attention against the kv
    shard it holds now (``ops.flash.flash_attention_lse`` on the card),
    merges the partial output into a running (out, lse) accumulator with a
    stable logsumexp combine, and sends the kv shard on to its neighbour
    (``ppermute``, a ``.to`` that never changes the shard it sends);
  * after ``n`` steps every kv shard has visited every device, and the
    accumulator is exact full-sequence attention.

The ring is recorded by autograd, so the backward ring comes with it: the
lse cotangent that carries the global softmax normalisation across shards
flows into the kernels' backward as delta - dlse (``FlashAttentionLSE``),
so guidance can differentiate through the ring as through one device's
kernel. Cross-attention needs no ring: the 77-token context is replicated
and only q is split (``sp_cross_attention``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from distdiff_tpu_torch.parallel.mesh import Mesh, all_gather, local_devices, ppermute, split

SEQ_AXIS = "seq"

_NEG = -1e30  # not -inf: exp(-inf - (-inf)) is nan in the first merge


def xla_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain attention with the row logsumexp (fp32 softmax): ``(out
    [B, Tq, H, D] in q's dtype, lse [B, Tq, H] fp32)``."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    lse = torch.logsumexp(s, dim=-1)  # [B, H, Tq]
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return out.to(q.dtype), lse.transpose(1, 2)


def _attn_lse(q, k, v):
    """The local op: the flash kernels on the card (kv past ``SMALL_KV``),
    the plain version otherwise, as ``ops.attention`` dispatches."""
    from distdiff_tpu_torch.ops.attention import SMALL_KV

    if k.shape[1] > SMALL_KV and q.is_cuda:
        from distdiff_tpu_torch.ops import flash

        return flash.flash_attention_lse(q, k, v)
    return xla_attention_lse(q, k, v)


def _merge(o_a, l_a, o_b, l_b):
    """Two attention partials over disjoint kv sets combined: o_* ``[B, T,
    H, D]`` (o_a the fp32 accumulator), l_* ``[B, T, H]`` fp32."""
    m = torch.maximum(l_a, l_b)
    wa = torch.exp(l_a - m)
    wb = torch.exp(l_b - m)
    den = wa + wb
    o = wa[..., None] * o_a + wb[..., None] * o_b.float()
    return o / den[..., None], m + torch.log(den)


def ring_attention(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                   vs: Sequence[torch.Tensor], devices: Sequence[torch.device]
                   ) -> List[torch.Tensor]:
    """Exact full-sequence attention from token shards: ``qs[i]``, ``ks[i]``
    and ``vs[i]`` are the ``[B, T/n, H, D]`` shards on ``devices[i]``;
    returns the output shards there. kv shard i travels i -> i + 1 each
    step and is home again after ``n`` steps."""
    n = len(devices)
    o = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    lse = [torch.full(q.shape[:3], _NEG, dtype=torch.float32, device=q.device) for q in qs]
    kc, vc = list(ks), list(vs)
    for _ in range(n):
        for i in range(n):
            oi, li = _attn_lse(qs[i], kc[i], vc[i])
            o[i], lse[i] = _merge(o[i], lse[i], oi, li)
        kc = [ppermute(kc[(i - 1) % n], devices[i]) for i in range(n)]
        vc = [ppermute(vc[(i - 1) % n], devices[i]) for i in range(n)]
    return [oi.to(q.dtype) for oi, q in zip(o, qs)]


def make_sp_mesh(n_seq: int, devices: Optional[Sequence] = None) -> Mesh:
    devices = list(devices) if devices is not None else local_devices()
    if len(devices) < n_seq:
        raise ValueError(f"a {n_seq}-way seq mesh over {len(devices)} devices")
    return Mesh(devices[:n_seq], (SEQ_AXIS,))


def _seq_devices(mesh: Mesh, seq_axis: str) -> List[torch.device]:
    if mesh.axis_names != (seq_axis,):
        raise ValueError(f"sequence parallelism takes a 1-d {seq_axis!r} mesh, got {mesh}")
    return mesh.device_list()


def sp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                 seq_axis: str = SEQ_AXIS) -> torch.Tensor:
    """Self-attention with the token axis split over ``mesh[seq_axis]``:
    ``[B, T, H, D]`` in (T divisible by the axis size), the ``[B, T, H,
    D]`` result on q's device. Exact, not windowed."""
    devices = _seq_devices(mesh, seq_axis)
    n = len(devices)
    shards = [[part.to(dev) for part, dev in zip(split(t, n, 1), devices)] for t in (q, k, v)]
    return all_gather(ring_attention(*shards, devices), 1, q.device)


def sp_cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                       seq_axis: str = SEQ_AXIS) -> torch.Tensor:
    """Cross-attention under sequence parallelism: q split over its tokens,
    the short kv context replicated, no collective."""
    devices = _seq_devices(mesh, seq_axis)
    outs = [_attn_lse(qs.to(dev), k.to(dev), v.to(dev))[0]
            for qs, dev in zip(split(q, len(devices), 1), devices)]
    return all_gather(outs, 1, q.device)
