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
tensor-core kernels: the forward at every width and the fused backward are
warp-specialised TMA/wgmma kernels, whose padded width (0 for the wide
forward) and load route ``bf16_plan`` chooses, and so is the split
backward (D > 128), whose load route ``split_plan`` chooses; fp32 goes to
their fp32 instances (``csrc/flash_f32.cu``), with fp32 outputs: the
forward at every width (its narrow kernel up to D = 128, its wide one past
it), the fused backward (D <= 128) and the split backward pair past
D = 128 on the tensor cores as 3xTF32 (each product formed from the
operands' high and low TF32 parts, lo·hi + hi·lo + hi·hi, which keeps
fp32's accuracy where one TF32 product would lose ~3 digits); only the
split pair's narrow instances, which direct calls of ``flash_bwd_dq`` and
``flash_bwd_dkv`` at D <= 128 reach, run CUDA-core fp32 FMA. fp32 is never
rounded to bf16. On a CPU tensor, and only there, it runs the plain PyTorch version
(``flash_fwd_reference`` / ``flash_bwd_reference``), which computes the same
function in fp32. There is no fallback from the kernel.

``FlashAttention`` is the ``torch.autograd.Function``; ``flash_attention``
(``[B, T, H, D]``) and ``flash_attention_hm`` (``[B, H, T, D]``) are the
public ops. ``flash_attention_lse`` (``FlashAttentionLSE``) also returns
the row lse, differentiably, over the same kernels.
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
    Otherwise the Hopper kernels stage the tiles element by element (the
    same kernels, another load path)."""
    return d % 8 == 0 and all(p % 16 == 0 for p in ptrs)


def bf16_plan(d: int, *tensors) -> Tuple[int, int]:
    """(padded width, 1 for TMA loads or 0 for staged ones) of a bf16
    launch over ``tensors``; the width is 0 past D = 128, where the forward
    takes its wide kernel."""
    return narrow_width(d), int(tma_route(d, [t.data_ptr() for t in tensors]))


# Head widths the split backward's instances are built for (D is padded to
# the next one in shared memory only).
SPLIT_DMAX = (128, 256, 512)


def split_smem_bytes(dmax: int) -> int:
    """Dynamic shared memory of a split-backward block at ``dmax``, as
    csrc/flash_bwd.cu SplitBwdCfg lays it out: the block's two resident
    tiles, the ring of 64-column chunks of the stream (8 KB each: 64 rows of
    128 bytes), a ds buffer, the column vectors, the mbarriers and 1 KB of
    alignment."""
    chunk, ch = 64 * 128, dmax // 64
    ring = 11 if dmax == 512 else 16
    bars = 1 + ring + 4
    return 2 * ch * chunk + ring * chunk + chunk + 2 * 2 * 64 * 4 + 8 * bars + 1024


# Head widths the fp32 narrow forward is built for (D <= 128), and those of
# the fp32 wide tensor-core kernels (the forward's and the split pair's,
# past D = 128); D is padded to the next one in shared memory only.
F32_NARROW_DMAX = (32, 64, 128)
F32_WIDE_DMAX = (256, 512)
# Padded head widths the fp32 fused backward is built for (D <= 128).
F32_FUSED_WIDTHS = (16, 32, 40, 48, 64, 80, 96, 128)


def f32_fwd_kernel(d: int) -> Tuple[str, int]:
    """(kernel, padded width) an fp32 ``flash_fwd`` at head width ``d``
    runs, by csrc/flash_f32.cu's ``flash_fwd_f32`` rule: both are 3xTF32
    tensor-core kernels, the narrow one (a warp's 32 q rows against every
    column of o, s and p in registers) up to D = 128, the wide one (score
    and output roles through shared memory) past it."""
    pad = next(w for w in F32_NARROW_DMAX + F32_WIDE_DMAX if d <= w)
    return ("flash_fwd_f32_narrow_kernel" if pad <= 128 else "flash_fwd_f32_wide_kernel"), pad


def f32_narrow_smem_bytes(dmax: int) -> int:
    """Dynamic shared memory of the fp32 narrow forward's block at ``dmax``,
    as csrc/flash_f32.cu NarrowCfg lays it out: the resident q tile (128
    rows of dmax + 8 floats) and a ring of two slots, each one k tile of BK
    rows of dmax + 8 floats and one v tile of BK rows of dmax + 4 (BK = 64
    kv rows; 16 at DMAX 128); then a full and an empty mbarrier a slot,
    q's, and 128 bytes to align the tiles."""
    bk = 16 if dmax == 128 else 64
    return 4 * (128 * (dmax + 8) + 2 * bk * (2 * dmax + 12)) + 16 * 2 + 8 + 128


def f32_wide_smem_bytes(dmax: int) -> int:
    """Dynamic shared memory of the fp32 wide forward's block at ``dmax``,
    as csrc/flash_f32.cu WideCfg lays it out, in floats: the resident
    64-row q tile (rows of dmax + 4), p (64 x 68), a ring of four slots
    each holding a k chunk (64 x 68) or a v chunk (4096 / dmax rows of
    dmax + 8), the column groups' row maxima and sums, and two row
    vectors."""
    slot = max(64 * 68, 4096 // dmax * (dmax + 8))
    return 4 * (64 * (dmax + 4) + 64 * 68 + 4 * slot + dmax // 128 * 64 + 2 * 64)


def f32_fused_kernel(d: int) -> Tuple[str, int]:
    """(kernel, padded width) the fp32 ``flash_bwd_fused`` at head width
    ``d`` (at most 128) runs, by csrc/flash_f32.cu's ``fused_width`` rule:
    the 3xTF32 tensor-core kernel (eight warps of 16 kv rows, q and do
    streamed, dq handed off through a bulk reduce-add), built at each of
    ``F32_FUSED_WIDTHS`` so that its loops have their bounds at compile
    time."""
    if not 0 < d <= FUSED_BWD_MAX_D:
        raise ValueError(f"flash_bwd_fused takes D <= {FUSED_BWD_MAX_D}, got {d}")
    return "flash_bwd_fused_f32_kernel", next(w for w in F32_FUSED_WIDTHS if d <= w)


def f32_fused_smem_bytes(w: int) -> int:
    """Dynamic shared memory of the fp32 fused backward's block at padded
    width ``w``, as csrc/flash_f32.cu FusedCfg lays it out, in floats: the
    resident k and v tiles (128 rows of w + 4), a ring of two slots of a q
    and a do tile (BQ = 32 rows, 16 at w = 128, of w + 4), the dq staging
    buffer (BQ x the block's columns of dq: all, or half at w = 128, where
    two blocks split them), ds^T (128 rows of BQ + 4), the dq partial sums
    of three quarters of the kv rows (BQ rows of the block's columns
    rounded to 8 (mod 32)), lse and delta of two tiles; then a full
    mbarrier a slot and k and v's, and 128 bytes to align the tiles."""
    bq, ld = (16 if w == 128 else 32), w + 4
    wh = w // 2 if w == 128 else w  # the columns of dk, dv and dq a block owns
    ldr = (wh + 23) // 32 * 32 + 8
    floats = 2 * 128 * ld + 2 * 2 * bq * ld + bq * wh + 128 * (bq + 4) + 3 * bq * ldr + 4 * bq
    return 4 * floats + 8 * 3 + 128


def f32_split_kernel(d: int) -> Tuple[str, int]:
    """(kernel, padded width) the fp32 ``flash_bwd_dq`` and ``flash_bwd_dkv``
    at head width ``d`` run, by csrc/flash_f32.cu's rule: the CUDA-core
    ``dq_kernel`` / ``dkv_kernel`` up to D = 128, which only direct calls
    reach (``flash_bwd`` takes the fused kernel there), the 3xTF32
    tensor-core kernel past it."""
    pad = next(w for w in (32, 64, 128) + F32_WIDE_DMAX if d <= w)
    return ("dq_kernel/dkv_kernel" if pad <= 128 else "flash_bwd_f32_split_kernel"), pad


def f32_split_smem_bytes(dmax: int) -> int:
    """Dynamic shared memory of the fp32 split pair's tensor-core block at
    ``dmax`` (either role), as csrc/flash_f32.cu SplitCfg lays it out: in
    floats, a ring of chunk pairs (9 slots at 512, 4 at 256; two 16 x 68
    chunks a slot), the two resident 32-row tiles (rows of dmax + 4) and
    the dmax / 64 consumer warps' partial sums of s and dp (512 floats
    each); then 16 bytes a slot (its mbarriers or release counter) and 128
    bytes to align the ring."""
    ring = 9 if dmax == 512 else 4
    return 4 * (ring * 2 * 16 * 68 + 2 * 32 * (dmax + 4) + dmax // 64 * 512) + 16 * ring + 128


def split_plan(d: int, *tensors) -> Tuple[int]:
    """(1 for TMA loads or 0 for staged ones,) of a bf16 split-backward
    launch over ``tensors`` (q, k, v, do): the same rule as the forward's."""
    return (int(tma_route(d, [t.data_ptr() for t in tensors])),)


def _launch(name: str, shape: Tuple[int, int, int, int], *tensors, plan=()) -> None:
    """Launch kernel ``name`` on the current stream (its fp32 instance when
    the first tensor is fp32): the tensors' pointers, then (BH, Tq, Tk, D),
    the bf16 kernels' ``plan`` (``bf16_plan``), the softmax scale and the
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
    plan = bf16_plan(d, q, k, v) if q.dtype == torch.bfloat16 else ()
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
    plan = bf16_plan(d, q, k, v, do, dq32) if q.dtype == torch.bfloat16 else ()
    _launch("flash_bwd_fused", shape, q, k, v, do, lse, delta, dq32, dk, dv, plan=plan)
    return dq32.to(q.dtype), dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta) -> torch.Tensor:
    """dq pass of the split backward (a loop over kv for each q tile)."""
    if _on_cpu(q):
        return _reference_grads(q, k, v, do, lse, delta)[0]
    shape = bh, tq, tk, d = _check(q, k, v, do, lse, delta)
    _check_stats(bh, tq, lse, delta)
    dq = torch.empty_like(q)
    plan = split_plan(d, q, k, v, do) if q.dtype == torch.bfloat16 else ()
    _launch("flash_bwd_dq", shape, q, k, v, do, lse, delta, dq, plan=plan)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk/dv pass of the split backward (a loop over q for each kv tile;
    dk and dv blocks in one launch)."""
    if _on_cpu(q):
        return _reference_grads(q, k, v, do, lse, delta)[1:]
    shape = bh, tq, tk, d = _check(q, k, v, do, lse, delta)
    _check_stats(bh, tq, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    plan = split_plan(d, q, k, v, do) if q.dtype == torch.bfloat16 else ()
    _launch("flash_bwd_dkv", shape, q, k, v, do, lse, delta, dk, dv, plan=plan)
    return dk, dv


def _reference_grads(q, k, v, do, lse, delta):
    """The plain backward, cast like the kernels' outputs."""
    dq, dk, dv = _grads_from_delta(q, k, v, do, lse, delta)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd(q, k, v, o, lse, do, dlse=None):
    """The reference's dispatch (flash.py:466-474): fused when D <= 128,
    the split dq + dkv pair otherwise. ``dlse``, the cotangent of the row
    lse (``FlashAttentionLSE``), enters the same kernels as delta - dlse
    (the reference's ``delta_sub``, flash.py:411-420,478-485): d lse / d s
    is p, so it folds into ds = p (dp - delta)."""
    delta = attention_delta(o, do)
    if dlse is not None:
        delta = delta - dlse.float()
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


class FlashAttentionLSE(torch.autograd.Function):
    """``FlashAttention`` that also returns the row lse ``[BH, Tq]`` fp32,
    differentiable in both outputs: the lse cotangent goes into the same
    backward kernels as delta - dlse. No kernel of its own."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_bwd(q, k, v, o, lse, do.contiguous(), dlse.contiguous())


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


def flash_attention_lse(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention that also returns the row logsumexp (port of the
    reference's ``flash_attention_lse``, flash.py:689-744):
    ``q [B, Tq, H, D], k/v [B, Tk, H, D] -> (out [B, Tq, H, D],
    lse [B, Tq, H] fp32)`` with ``lse = logsumexp_k(q.k / sqrt(D))``. It
    launches ``flash_fwd``, and in the backward ``flash_bwd_fused`` (D <=
    128) or the ``flash_bwd_dq``/``flash_bwd_dkv`` pair; the building block
    of ``parallel.sp.ring_attention``."""
    b, tq, h, d = q.shape
    tk = k.shape[1]

    def to3d(x, t):
        return x.transpose(1, 2).reshape(b * h, t, d).contiguous()

    o, lse = FlashAttentionLSE.apply(to3d(q, tq), to3d(k, tk), to3d(v, tk))
    return o.reshape(b, h, tq, d).transpose(1, 2), lse.reshape(b, h, tq).transpose(1, 2)
