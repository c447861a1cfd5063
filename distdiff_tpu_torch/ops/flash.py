"""Flash attention (forward + backward) on hand-written CUDA kernels.

Port of ``distdiff_tpu/ops/flash.py``. The Pallas TPU kernels become four
CUDA kernels for Hopper (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``):

  ``flash_fwd``        <- ``_fwd_kernel_single`` / ``_fwd_kernel``
  ``flash_bwd_fused``  <- ``_bwd_fused_kernel``  (D <= 128)
  ``flash_bwd_dq``     <- ``_dq_kernel``         } (D > 128)
  ``flash_bwd_dkv``    <- ``_dkv_kernel``        }

Each wrapper below takes contiguous ``[BH, T, D]`` tensors. On a CUDA tensor
it checks what the kernel takes (bf16 or fp32, one type throughout,
contiguous, matching shapes), launches on the current stream, raises if the
launch failed, and adds one to its launch count. bf16 goes to the
tensor-core kernels: at D <= 128 the warp-specialised TMA/wgmma kernels,
whose padded width and load route ``narrow_plan`` chooses; fp32 goes to
their fp32 instances (``csrc/flash_f32.cu``,
CUDA-core fp32 FMA, no TF32), with fp32 outputs: fp32 is never rounded to
bf16. On a CPU tensor, and only there, it runs the plain PyTorch version
(``flash_fwd_reference`` / ``flash_bwd_reference``), which computes the same
function in fp32. There is no fallback from the kernel.

``FlashAttention`` is the ``torch.autograd.Function``; ``flash_attention``
(``[B, T, H, D]``) and ``flash_attention_hm`` (``[B, H, T, D]``) are the
public ops.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, Tuple

import torch

from distdiff_tpu_torch.ops import _build

# Launches of each kernel since the last reset_launch_counts().
launch_counts: Dict[str, int] = {
    "flash_fwd": 0, "flash_bwd_fused": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
}
# The same launches by (kernel, (BH, Tq, Tk, D)), both types together.
launch_shapes: collections.Counter = collections.Counter()
DTYPES = (torch.bfloat16, torch.float32)
# The reference's rule (flash.py:466): fused backward up to this head width.
FUSED_BWD_MAX_D = 128
MAX_D = 512
# Head widths the narrow (D <= 128) bf16 kernels are built for; D is padded
# to the next one in shared memory only (wgmma takes k-steps of 16).
NARROW_WIDTHS = (48, 64, 80, 96, 128)


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
    launch_shapes.clear()


def _scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


# ------------------------------------------------------------ plain versions

def flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``(o, lse)`` of softmax attention over ``[BH, T, D]``."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * _scale(q.shape[-1])
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.matmul(p, v.float()), lse


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(o * do) in fp32, ``[BH, Tq]``."""
    return (o.float() * do.float()).sum(-1)


def flash_bwd_reference(q, k, v, o, lse, do
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fp32 ``(dq, dk, dv)`` by the kernels' own formulas: p from lse,
    delta from o * do."""
    return _grads_from_delta(q, k, v, do, lse, attention_delta(o, do))


def _grads_from_delta(q, k, v, do, lse, delta):
    scale = _scale(q.shape[-1])
    q32, k32, do32 = q.float(), k.float(), do.float()
    p = torch.exp(torch.matmul(q32, k32.transpose(-1, -2)) * scale - lse[..., None])
    dv = torch.matmul(p.transpose(-1, -2), do32)
    dp = torch.matmul(do32, v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return torch.matmul(ds, k32), torch.matmul(ds.transpose(-1, -2), q32), dv


# ------------------------------------------------------------ kernel wrappers

def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"flash kernels take CUDA or CPU tensors, got {x.device}")
    return False


def _check(q, k, v, *rest):
    for name, x in (("q", q), ("k", k), ("v", v)) + tuple(
            (f"arg{i}", x) for i, x in enumerate(rest)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash kernels take bf16 or fp32, q is {q.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype != q.dtype:
            raise TypeError(f"{name} is {x.dtype}, q is {q.dtype}")
        if x.ndim != 3:
            raise ValueError(f"{name} must be [BH, T, D], got {tuple(x.shape)}")
    bh, tq, d = q.shape
    if k.shape != v.shape or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    if rest and (rest[0].dtype != q.dtype or rest[0].shape != q.shape):
        raise ValueError(f"do must be {q.dtype} of q's shape {tuple(q.shape)}")
    if not (0 < d <= MAX_D) or bh > 65535:
        raise ValueError(f"unsupported head width {d} or batch*heads {bh}")
    return bh, tq, k.shape[1], d


def narrow_width(d: int) -> int:
    """The narrow kernels' padded head width for ``d``; 0 past 128 (the
    wide kernels)."""
    return next((w for w in NARROW_WIDTHS if d <= w), 0)


def tma_route(d: int, ptrs) -> bool:
    """Whether TMA can load the tiles of bf16 ``[BH, T, d]`` slabs at these
    addresses: rows of a multiple of 16 bytes and 16-byte aligned bases.
    Otherwise the narrow kernels stage the tiles through their producer's
    registers (the same kernels, another load path)."""
    return d % 8 == 0 and all(p % 16 == 0 for p in ptrs)


def narrow_plan(d: int, *tensors) -> Tuple[int, int]:
    """(padded width, 1 for TMA loads or 0 for staged ones) of a bf16
    launch over ``tensors``; (0, 0) past D = 128."""
    dp = narrow_width(d)
    return (dp, int(tma_route(d, [t.data_ptr() for t in tensors]))) if dp else (0, 0)


def _launch(name: str, shape: Tuple[int, int, int, int], *tensors, plan=()) -> None:
    """Launch kernel ``name`` on the current stream (its fp32 instance when
    the first tensor is fp32): the tensors' pointers, then (BH, Tq, Tk, D),
    the bf16 kernels' ``plan`` (``narrow_plan``), the softmax scale and the
    stream."""
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in tensors]
    entry = name + "_f32" if tensors[0].dtype == torch.float32 else name
    rc = _build.kernel(entry)(*ptrs, *shape, *plan, _scale(shape[3]), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")
    launch_counts[name] += 1
    launch_shapes[(name, shape)] += 1


def _check_stats(bh, tq, *stats):
    for x in stats:
        if x.dtype != torch.float32 or tuple(x.shape) != (bh, tq):
            raise ValueError(f"lse/delta must be fp32 [{bh}, {tq}], got "
                             f"{x.dtype} {tuple(x.shape)}")


def flash_fwd(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o [BH,Tq,D] in q's dtype, lse [BH,Tq] fp32)``."""
    if _on_cpu(q):
        o, lse = flash_fwd_reference(q, k, v)
        return o.to(q.dtype), lse
    shape = bh, tq, tk, d = _check(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((bh, tq), device=q.device, dtype=torch.float32)
    plan = narrow_plan(d, q, k, v) if q.dtype == torch.bfloat16 else ()
    _launch("flash_fwd", shape, q, k, v, o, lse, plan=plan)
    return o, lse


def flash_bwd_fused(q, k, v, do, lse, delta):
    """``(dq, dk, dv)`` in one kv-major pass; D <= 128."""
    if _on_cpu(q):
        return _reference_grads(q, k, v, do, lse, delta)
    shape = bh, tq, tk, d = _check(q, k, v, do, lse, delta)
    _check_stats(bh, tq, lse, delta)
    if d > FUSED_BWD_MAX_D:
        raise ValueError(f"flash_bwd_fused takes D <= {FUSED_BWD_MAX_D}, got {d}")
    # dq's fp32 sum over the kv tiles, which add into it in any order
    dq32 = torch.zeros((bh, tq, d), device=q.device, dtype=torch.float32)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    plan = narrow_plan(d, q, k, v, do, dq32) if q.dtype == torch.bfloat16 else ()
    _launch("flash_bwd_fused", shape, q, k, v, do, lse, delta, dq32, dk, dv, plan=plan)
    return dq32.to(q.dtype), dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta) -> torch.Tensor:
    """dq pass of the split backward (a loop over kv for each q tile)."""
    if _on_cpu(q):
        return _reference_grads(q, k, v, do, lse, delta)[0]
    shape = bh, tq, tk, d = _check(q, k, v, do, lse, delta)
    _check_stats(bh, tq, lse, delta)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", shape, q, k, v, do, lse, delta, dq)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk/dv pass of the split backward (a loop over q for each kv tile)."""
    if _on_cpu(q):
        return _reference_grads(q, k, v, do, lse, delta)[1:]
    shape = bh, tq, tk, d = _check(q, k, v, do, lse, delta)
    _check_stats(bh, tq, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch("flash_bwd_dkv", shape, q, k, v, do, lse, delta, dk, dv)
    return dk, dv


def _reference_grads(q, k, v, do, lse, delta):
    """The plain backward, cast like the kernels' outputs."""
    dq, dk, dv = _grads_from_delta(q, k, v, do, lse, delta)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd(q, k, v, o, lse, do):
    """The reference's dispatch (flash.py:466-474): fused when D <= 128,
    the split dq + dkv pair otherwise."""
    delta = attention_delta(o, do)
    if q.shape[-1] <= FUSED_BWD_MAX_D:
        return flash_bwd_fused(q, k, v, do, lse, delta)
    dq = flash_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention over contiguous ``[BH, T, D]`` q/k/v; saves q, k, v, o and
    lse for the backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_bwd(q, k, v, o, lse, do.contiguous())


# ------------------------------------------------------------- public ops

def flash_attention(q, k, v) -> torch.Tensor:
    """``[B, Tq, H, D]`` q, ``[B, Tk, H, D]`` k/v -> ``[B, Tq, H, D]``."""
    b, tq, h, d = q.shape
    tk = k.shape[1]

    def to3d(x, t):
        return x.transpose(1, 2).reshape(b * h, t, d).contiguous()

    o = FlashAttention.apply(to3d(q, tq), to3d(k, tk), to3d(v, tk))
    return o.reshape(b, h, tq, d).transpose(1, 2)


def flash_attention_hm(q, k, v) -> torch.Tensor:
    """Head-major ``[B, H, T, D]`` q/k/v -> ``[B, H, Tq, D]``."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    o = FlashAttention.apply(q.reshape(b * h, tq, d).contiguous(),
                             k.reshape(b * h, tk, d).contiguous(),
                             v.reshape(b * h, tk, d).contiguous())
    return o.reshape(b, h, tq, d)
