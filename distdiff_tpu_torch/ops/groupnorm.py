"""GroupNorm(+SiLU) with fp32 statistics on hand-written CUDA kernels.

Port of ``distdiff_tpu/ops/groupnorm.py``. The Pallas TPU kernels become
three CUDA kernels for Hopper (``csrc/groupnorm.cu``):

  ``gn_fused``  <- ``_gn_kernel``        (the span fits a block's shared memory;
                                         a cluster of blocks per unit)
  ``gn_stats``  <- ``_gn_stats_kernel``  } the two-pass path, for spans no
  ``gn_apply``  <- ``_gn_apply_kernel``  } cluster holds (one wave of bands)

``group_norm`` is the op every GroupNorm of the UNet and the VAE calls. On a
CUDA tensor it always runs the kernels (the reference keeps its Pallas
GroupNorm off by default because XLA fuses the norm into the neighbouring
convolutions, which eager PyTorch does not); on a CPU tensor, and only
there, the plain version ``group_norm_reference`` (the reference's
``xla_group_norm``). There is no fallback from the kernels: a build or
launch failure raises.

Tensors are NCHW in shape. On the card they arrive either contiguous or
channels-last (the models enter through a permute of NHWC, and cuDNN keeps
that memory format); the kernels read both in place and the output keeps
the input's memory format. Any other stride pattern raises: a copy to
contiguous would hide an extra read and write of the slab.

The backward is the reference's (``_gn_bwd``): the kernels have none, and
``GroupNormFunction`` saves only ``(x, scale, bias)`` and differentiates the
plain formula, recomputed, in its backward.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from distdiff_tpu_torch.ops import _build

# Launches of each kernel since the last reset_launch_counts().
launch_counts: Dict[str, int] = {"gn_fused": 0, "gn_stats": 0, "gn_apply": 0}
# The same launches by (kernel, (B, C, H, W)).
launch_shapes: collections.Counter = collections.Counter()
# Norms run on the card by memory format ("nchw" contiguous, "nhwc"
# channels-last).
layout_counts: collections.Counter = collections.Counter()
DTYPES = (torch.bfloat16, torch.float32)
ACTS = {None: 0, "silu": 1}
# The route rule's header (``fused_fits``): 68 floats of block reduction,
# then a and b of each channel of the group, as one block per span needed
_RED_FLOATS = 68
# gn_fused (csrc/groupnorm.cu): threads a block, blocks a cluster at most,
# rows or channels of a TMA box at most, chunks a slice arrives in
FUSED_THREADS = 256
_MAX_CLUSTER = 16
_TMA_BOX = 256
_TMA_CHUNKS = 4
# its plan: a group set's run of channels at each pixel spans at least
# _RUN_BYTES (two 32-byte sectors), so that small grids get more units;
# clusters grow until the grid has _CTAS_PER_SM blocks an SM, keeping each
# slice >= _MIN_SLICE_BYTES; a grid of more blocks than that loads by TMA
# (one that fits is as fast by the threads' own loads)
_RUN_BYTES = 64
_CTAS_PER_SM = 4
_MIN_SLICE_BYTES = 8192
# the pair (gn_stats, gn_apply): at most _PAIR_THREADS threads a block, in
# one wave of _PAIR_BLOCKS_PER_SM blocks an SM, each block at least
# _PAIR_MIN_ROWS pixel rows (NHWC) or _PAIR_MIN_SPLIT elements of a plane
# (NCHW)
_PAIR_THREADS = 256
_PAIR_BLOCKS_PER_SM = 4
_PAIR_MIN_ROWS = 16
_PAIR_MIN_SPLIT = 8192

_smem_limit: Dict[int, int] = {}
_sm_count: Dict[int, int] = {}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
    launch_shapes.clear()
    layout_counts.clear()


# ------------------------------------------------------------ plain version

def group_norm_stats_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                               groups: int, eps: float = 1e-5) -> torch.Tensor:
    """The fp32 per-channel (a, b) as ``[B, 2, C]``: fp32 per-group mean and
    variance (E[x^2] - mean^2), inv = rsqrt(var + eps), a = inv * scale,
    b = bias - mean * inv * scale."""
    b, c = x.shape[:2]
    cpg = c // groups
    x32 = x.float()
    red = tuple(range(2, x.ndim))
    n = cpg
    for d in x.shape[2:]:
        n *= d
    g1 = x32.sum(dim=red).reshape(b, groups, cpg).sum(-1)
    g2 = (x32 * x32).sum(dim=red).reshape(b, groups, cpg).sum(-1)
    mean_g = g1 / n
    var_g = g2 / n - mean_g * mean_g
    inv_g = torch.rsqrt(var_g + eps)
    mean_c = mean_g.repeat_interleave(cpg, dim=1)
    inv_c = inv_g.repeat_interleave(cpg, dim=1)
    s32 = scale.float()[None, :]
    return torch.stack([inv_c * s32, bias.float()[None, :] - mean_c * inv_c * s32], dim=1)


def group_norm_apply_reference(x: torch.Tensor, ab: torch.Tensor,
                               act: Optional[str] = None) -> torch.Tensor:
    """act(x * a + b) with a and b cast to x's dtype; SiLU in fp32."""
    shape = (x.shape[0], x.shape[1]) + (1,) * (x.ndim - 2)
    a = ab[:, 0].to(x.dtype).reshape(shape)
    b_ = ab[:, 1].to(x.dtype).reshape(shape)
    y = x * a + b_
    if act is None:
        return y
    if act == "silu":
        return F.silu(y.float()).to(y.dtype)
    raise ValueError(f"unsupported groupnorm activation {act!r}")


def group_norm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         groups: int, eps: float = 1e-5, act: Optional[str] = None
                         ) -> torch.Tensor:
    """The plain GroupNorm: fp32 statistics folded into a per-channel
    (a, b), cast to x's dtype before ``x * a + b``; the optional SiLU in
    fp32 (the reference's ``xla_group_norm``)."""
    return group_norm_apply_reference(
        x, group_norm_stats_reference(x, scale, bias, groups, eps), act)


# ------------------------------------------------------------ kernel wrappers

def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"groupnorm kernels take CUDA or CPU tensors, got {x.device}")
    return False


def layout(x: torch.Tensor) -> str:
    """``"nchw"`` (contiguous) or ``"nhwc"`` (channels-last); any other
    stride pattern raises. A tensor that is both (one pixel, or one
    channel) counts as NCHW."""
    if x.is_contiguous():
        return "nchw"
    if x.ndim == 4 and x.is_contiguous(memory_format=torch.channels_last):
        return "nhwc"
    raise ValueError(f"groupnorm kernels take contiguous or channels-last tensors, "
                     f"got shape {tuple(x.shape)} strides {x.stride()}")


def fused_header_bytes(cpg: int) -> int:
    return (4 * (_RED_FLOATS + 2 * cpg) + 15) // 16 * 16


def fused_fits(c: int, groups: int, spatial: int, itemsize: int, smem_limit: int) -> bool:
    """Whether one (batch row, group) span and gn_fused's header fit a
    block's shared memory (232448 bytes on the H100: spans up to ~116k bf16
    elements, so the UNet's 64^2 x 640 but not 64^2 x 960)."""
    cpg = c // groups
    return fused_header_bytes(cpg) + cpg * spatial * itemsize <= smem_limit


def _vec(itemsize: int, n: int, align: int) -> int:
    """The largest of 16, 8, 4, 2 bytes' worth of elements (down to one)
    that divides ``n`` and whose byte width divides ``align``."""
    v = 16 // itemsize
    while v > 1 and (n % v or align % (v * itemsize)):
        v //= 2
    return v


def _device_limits(dev: torch.device) -> Tuple[int, int]:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _smem_limit:
        limit = _build.kernel("gn_smem_optin")(idx)
        if limit <= 0:
            raise RuntimeError(f"gn_smem_optin failed with CUDA error {-limit}")
        _smem_limit[idx] = limit
        _sm_count[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _smem_limit[idx], _sm_count[idx]


def _check(x, scale, bias, groups):
    if x.dtype not in DTYPES:
        raise TypeError(f"groupnorm kernels take bf16 or fp32, x is {x.dtype}")
    if x.ndim < 3:
        raise ValueError(f"groupnorm kernels take [B, C, ...], got {tuple(x.shape)}")
    c = x.shape[1]
    if groups <= 0 or c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    for name, p in (("scale", scale), ("bias", bias)):
        if p.device != x.device or p.shape != (c,) or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{c}] tensor on {x.device}")
        if p.dtype != scale.dtype or p.dtype not in DTYPES:
            raise TypeError(f"scale and bias must both be bf16 or fp32, {name} is {p.dtype}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"groupnorm kernels take fewer than 2^31 elements, got {x.numel()}")


def _record(name: str, x: torch.Tensor) -> None:
    launch_counts[name] += 1
    launch_shapes[(name, tuple(x.shape))] += 1


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {rc}")


class FusedPlan(collections.namedtuple("FusedPlan", "group_set cluster vec tma")):
    """gn_fused's launch plan: ``group_set`` adjacent groups a unit (with
    one batch row), ``cluster`` blocks splitting a unit, ``vec`` elements a
    load and store, ``tma`` 1 where the slices arrive by TMA."""


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def fused_smem_bytes(lay: str, c: int, s: int, groups: int, itemsize: int,
                     plan: FusedPlan) -> int:
    """gn_fused's shared bytes a block for ``plan`` (``fused_geom`` in
    csrc/groupnorm.cu): the slice, the column sums, the group partials with
    every rank's gathered and the group statistics, a and b, the
    mbarriers, and 128 bytes of alignment."""
    gs, cl, v, tma = plan
    cpg = c // groups
    w = gs * cpg
    nchunks = 0
    if lay == "nhwc":
        p = -(-s // cl)
        chunk = min(_round_up(-(-p // _TMA_CHUNKS), 8), _TMA_BOX)
        nchunks = -(-p // chunk) if tma else 0
        slice_bytes = (nchunks * chunk if tma else p) * w * itemsize
        rr = FUSED_THREADS // min(w // v, FUSED_THREADS)
        red = 4 * 2 * rr * w
    else:
        slice_bytes = _round_up(-(-(cpg * s) // cl), v) * itemsize
        red = 4 * _RED_FLOATS
    return (_round_up(slice_bytes, 128) + red + _round_up(8 * gs * (cl + 2), 16)
            + _round_up(8 * w, 16) + 8 * nchunks + 128)


def fused_plan(b: int, c: int, s: int, groups: int, itemsize: int, lay: str,
               sm_count: int, smem_limit: int, x_ptr: int, y_ptr: int) -> FusedPlan:
    """gn_fused's plan for a [B, C, S] norm (pure arithmetic on the shape,
    the card's SM count and shared memory, and the pointers).

    NHWC: the group set is the fewest adjacent groups whose run of channels
    at a pixel is >= ``_RUN_BYTES`` and a multiple of 16 bytes (else just
    >= ``_RUN_BYTES``, else every group), so that loads are whole 16-byte
    vectors over whole sectors; TMA where the base is 16-byte aligned, the
    row stride and the run are multiples of 16 bytes (at most 256
    channels: one box) and the grid has more than ``_CTAS_PER_SM`` blocks
    an SM, else the threads' vector loads. NCHW: one group a
    unit (a span is contiguous), vector loads. The cluster doubles from 1
    until the grid has ``_CTAS_PER_SM`` blocks an SM or a slice would fall
    under ``_MIN_SLICE_BYTES``, and further until a block's shared memory
    fits ``smem_limit``; where 16 blocks do not make it fit, the set shrinks
    to the next divisor of the group count; ValueError if one group does
    not fit either."""
    cpg = c // groups
    align = math.gcd(x_ptr, y_ptr, 16)
    if lay == "nhwc":
        sets = [d for d in range(1, groups + 1) if groups % d == 0]
        run = [d for d in sets if d * cpg * itemsize >= _RUN_BYTES]
        first = next((d for d in run if d * cpg * itemsize % 16 == 0), run[0] if run else groups)
        # the set that shared memory cannot take shrinks to the next divisor
        candidates = [first] + [d for d in reversed(sets) if d < first]
    else:
        candidates = [1]
    for gs in candidates:
        w = gs * cpg
        if lay == "nhwc":
            v = _vec(itemsize, w, align)
            tma_ok = (x_ptr % 16 == 0 and c * itemsize % 16 == 0 and w * itemsize % 16 == 0
                      and w <= _TMA_BOX)
            unit_bytes = s * w * itemsize
        else:
            v, tma_ok = _vec(itemsize, cpg * s, align), False
            unit_bytes = cpg * s * itemsize
        units = b * groups // gs
        cl = 1
        while (cl < _MAX_CLUSTER and units * cl < _CTAS_PER_SM * sm_count
               and unit_bytes // (2 * cl) >= _MIN_SLICE_BYTES):
            cl *= 2
        while cl <= _MAX_CLUSTER:
            plan = FusedPlan(gs, cl, v, int(tma_ok and units * cl > _CTAS_PER_SM * sm_count))
            if fused_smem_bytes(lay, c, s, groups, itemsize, plan) <= smem_limit:
                return plan
            cl *= 2
    raise ValueError(f"gn_fused: a [{b}, {c}, {s}] slab in {groups} groups does not fit "
                     f"{_MAX_CLUSTER} blocks' shared memory")


def gn_fused(x, scale, bias, groups: int, eps: float, act, y, sm_count: int,
             smem_limit: int) -> None:
    """y = act(x a + b) in one pass: a cluster of blocks per (batch row,
    group set), as ``fused_plan`` lays it out."""
    lay = layout(x)
    b, c = x.shape[:2]
    s = x.numel() // (b * c)
    plan = fused_plan(b, c, s, groups, x.element_size(), lay, sm_count, smem_limit,
                      x.data_ptr(), y.data_ptr())
    rc = _build.kernel("gn_fused")(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16),
        b, c, s, groups, eps, int(lay == "nhwc"), ACTS[act], *plan,
        torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "gn_fused")
    _record("gn_fused", x)


class PairPlan(collections.namedtuple("PairPlan", "vec threads bands rows")):
    """gn_stats' and gn_apply's launch plan: ``vec`` elements a load and
    store, ``threads`` a block, ``bands`` blocks a batch row (NHWC: each
    ``rows`` pixel rows with every channel) or a channel plane (NCHW: each
    ``rows`` elements of it). Both kernels take the same bands; in NHWC
    gn_apply walks each band's rows last to first, so that it reads first
    the rows gn_stats read last, which are likeliest in L2."""


def pair_plan(b: int, c: int, s: int, itemsize: int, lay: str, sm_count: int,
              x_ptr: int, y_ptr: int) -> PairPlan:
    """The pair's plan for a [B, C, S] norm (pure arithmetic on the shape,
    the card's SM count and the pointers: gn_stats passes x's twice):
    ``_PAIR_BLOCKS_PER_SM`` blocks an SM, in one wave.

    NHWC: the largest vector that divides C and aligns both pointers; a
    block of nvt x rr threads (nvt vector columns, at most 256, and as many
    rows of threads as fill 256); bands of at least ``_PAIR_MIN_ROWS``
    rows. NCHW: the vector divides S, so none crosses a plane; bands of at
    least ``_PAIR_MIN_SPLIT`` elements, a multiple of the vector; a block of
    as many warps as one band's vectors need, up to 8."""
    align = math.gcd(x_ptr, y_ptr, 16)
    target = _PAIR_BLOCKS_PER_SM * sm_count
    if lay == "nhwc":
        v = _vec(itemsize, c, align)
        nvt = min(c // v, _PAIR_THREADS)
        threads = nvt * (_PAIR_THREADS // nvt)
        bands = max(1, min(-(-target // b), s // _PAIR_MIN_ROWS))
        rows = -(-s // bands)
        return PairPlan(v, threads, -(-s // rows), rows)
    v = _vec(itemsize, s, align)
    bands = max(1, min(-(-target // (b * c)), s // _PAIR_MIN_SPLIT, 65535))
    rows = _round_up(-(-s // bands), v)
    threads = min(_PAIR_THREADS, _round_up(rows // v, 32))
    return PairPlan(v, threads, -(-s // rows), rows)


def pair_smem_bytes(lay: str, c: int, groups: int, plan: PairPlan) -> int:
    """gn_stats' dynamic shared bytes a block (``pair_smem`` in
    csrc/groupnorm.cu): NHWC, the column sums of every row of threads; NCHW,
    the block reduction's floats; either, at least the finish's
    max(4 threads, 2G) floats."""
    fin = max(4 * plan.threads, 2 * groups)
    if lay == "nhwc":
        nvt = min(c // plan.vec, plan.threads)
        return 4 * max(2 * (plan.threads // nvt) * c, fin)
    return 4 * max(_RED_FLOATS, fin)


# per (device, stream): gn_stats' row counters, zero between launches (the
# last block of a row sets its counter back to zero), so that a launch
# needs no fill kernel before it
_counters: Dict[Tuple[str, int], torch.Tensor] = {}


def _row_counter(dev: torch.device, stream: int, b: int) -> torch.Tensor:
    key = (str(dev), stream)
    cnt = _counters.get(key)
    if cnt is None or cnt.numel() < b:
        cnt = _counters[key] = torch.zeros((max(b, 64),), device=dev, dtype=torch.int32)
    return cnt


def gn_stats(x, scale, bias, groups: int, eps: float, sm_count: int) -> torch.Tensor:
    """Pass 1: the fp32 per-channel (a, b) as ``[B, 2, C]``, by the plan
    ``pair_plan`` makes (a plan whose ``pair_smem_bytes`` exceed the card's
    shared memory fails to launch and raises)."""
    lay = layout(x)
    b, c = x.shape[:2]
    s = x.numel() // (b * c)
    plan = pair_plan(b, c, s, x.element_size(), lay, sm_count, x.data_ptr(), x.data_ptr())
    npart = b * plan.bands * 2 * (groups if lay == "nhwc" else c)
    part = torch.empty((npart,), device=x.device, dtype=torch.float32)
    stream = torch.cuda.current_stream().cuda_stream
    counter = _row_counter(x.device, stream, b)
    ab = torch.empty((b, 2, c), device=x.device, dtype=torch.float32)
    rc = _build.kernel("gn_stats")(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), part.data_ptr(),
        counter.data_ptr(), ab.data_ptr(), int(x.dtype == torch.bfloat16),
        int(scale.dtype == torch.bfloat16), b, c, s, groups, eps, int(lay == "nhwc"),
        *plan, stream)
    _raise_on(rc, "gn_stats")
    _record("gn_stats", x)
    return ab


def gn_apply(x, ab, act, y, sm_count: int) -> None:
    """Pass 2: y = act(x a + b), a and b rounded to x's dtype, by the plan
    ``pair_plan`` makes."""
    lay = layout(x)
    b, c = x.shape[:2]
    s = x.numel() // (b * c)
    if ab.dtype != torch.float32 or tuple(ab.shape) != (b, 2, c) or not ab.is_contiguous():
        raise ValueError(f"ab must be a contiguous fp32 [{b}, 2, {c}] tensor")
    plan = pair_plan(b, c, s, x.element_size(), lay, sm_count, x.data_ptr(), y.data_ptr())
    rc = _build.kernel("gn_apply")(
        x.data_ptr(), ab.data_ptr(), y.data_ptr(), int(x.dtype == torch.bfloat16), b, c, s,
        int(lay == "nhwc"), ACTS[act], *plan, torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "gn_apply")
    _record("gn_apply", x)


def group_norm_forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                       groups: int, eps: float = 1e-5, act: Optional[str] = None
                       ) -> torch.Tensor:
    """The forward without autograd: the kernels on a CUDA tensor (one
    ``gn_fused`` when a span fits a block's shared memory, else ``gn_stats``
    then ``gn_apply``), the plain version on a CPU tensor."""
    if act not in ACTS:
        raise ValueError(f"unsupported groupnorm activation {act!r}")
    if _on_cpu(x):
        return group_norm_reference(x, scale, bias, groups, eps, act)
    _check(x, scale, bias, groups)
    lay = layout(x)
    y = torch.empty_like(x)  # keeps x's memory format
    smem_limit, sm_count = _device_limits(x.device)
    b, c = x.shape[:2]
    if fused_fits(c, groups, x.numel() // (b * c), x.element_size(), smem_limit):
        gn_fused(x, scale, bias, groups, eps, act, y, sm_count, smem_limit)
    else:
        gn_apply(x, gn_stats(x, scale, bias, groups, eps, sm_count), act, y, sm_count)
    layout_counts[lay] += 1
    return y


class GroupNormFunction(torch.autograd.Function):
    """``group_norm_forward``, differentiated as the reference's
    ``custom_vjp`` is: the backward re-runs the plain formula on the saved
    ``(x, scale, bias)`` and returns its vector-Jacobian product."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, act):
        ctx.save_for_backward(x, scale, bias)
        ctx.cfg = (groups, eps, act)
        return group_norm_forward(x, scale, bias, groups, eps, act)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        want = ctx.needs_input_grad[:3]
        inputs = [t.detach().requires_grad_(w) for t, w in zip((x, scale, bias), want)]
        with torch.enable_grad():
            y = group_norm_reference(*inputs, *ctx.cfg)
            grads = torch.autograd.grad(
                y, [t for t, w in zip(inputs, want) if w], g, allow_unused=True)
        it = iter(grads)
        return tuple(next(it) if w else None for w in want) + (None, None, None)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               groups: int, eps: float = 1e-5, act: Optional[str] = None
               ) -> torch.Tensor:
    """GroupNorm over ``[B, C, ...]`` with fp32 statistics, folded into a
    per-channel (a, b) in x's dtype, and an optional fused SiLU (fp32)."""
    return GroupNormFunction.apply(x, scale, bias, groups, eps, act)
