"""Opt-in int8 (w8a8) inference ops (port of ``distdiff_tpu/ops/quant.py``).

An APPROXIMATE inference mode in the family of DeepCache (``--int8`` in
the CLI; never the parity metric): quantization shifts the samples. It
applies only to the plain denoise spans: the guidance leg (exact energies
and their backward) and the VAE stay in their dtype, and no gradient flows
through a quantized op.

Symmetric int8: the activation gets one scale for the whole tensor (both
CFG halves and every image of the batch), the weight one scale per output
channel. The products accumulate in int32 and are rescaled to
``out_dtype`` as ``acc * (sx * sw)``, as the JAX package does. Weights stay
in their dtype in the modules and are quantized again on every call, so a
LoRA merge or ``apply_lora`` never leaves a stale quantized copy.

The int32 product has no Pallas kernel in the JAX package (XLA's int8
convolution and dot). On a CUDA tensor it is ``torch._int_mm`` (cuBLASLt's
s8 x s8 -> s32 GEMM); convolutions are im2col in int8 over it. Rows are
padded with zeros to more than 16 and the depth and width to multiples of 8,
as ``_int_mm`` requires; zeros add nothing, so the result is exact. There is
no other route on the card: a refused product raises. On a CPU tensor, and
only there, the plain version ``int_mm_reference`` (float64 products, exact
while 127^2 * K < 2^53).

``int8_inference()`` turns the route on for the ``QConv2d``/``QLinear``
layers (``models/layers.py``) called inside it. The flag is read when a
layer is called (the JAX package reads it while tracing), and it is a
context variable, so a thread that did not enter the context sees it off.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
from typing import Tuple

import torch
import torch.nn.functional as F

_INT8 = contextvars.ContextVar("distdiff_int8", default=False)

# int8 products on the card since the last reset_counts(), by the (M, K, N)
# that torch._int_mm got (after padding)
product_shapes: collections.Counter = collections.Counter()


def reset_counts() -> None:
    product_shapes.clear()


def int8_enabled() -> bool:
    return _INT8.get()


@contextlib.contextmanager
def int8_inference():
    """Route ``QConv2d``/``QLinear`` through int8 for the calls inside; the
    flag is restored on exit, also on an exception."""
    token = _INT8.set(True)
    try:
        yield
    finally:
        _INT8.reset(token)


def _per_level(amax: torch.Tensor) -> torch.Tensor:
    """``amax / 127`` as a true division on every device: CUDA divides by a
    Python scalar as a product with its reciprocal, one ulp off the
    quotient the CPU and the JAX package compute."""
    return amax / torch.full((), 127.0, dtype=amax.dtype, device=amax.device)


def quant_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-tensor quantization: (int8 values of x's
    shape, the fp32 scale ``max|x| / 127``, floored at 1e-8)."""
    xf = x.float()
    s = torch.clamp_min(_per_level(xf.abs().amax()), 1e-8)
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def quant_w(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric quantization of a ``[O, ...]`` weight:
    (int8 values of w's shape, fp32 scales ``[O]``)."""
    wf = w.float()
    s = torch.clamp_min(_per_level(wf.abs().amax(dim=tuple(range(1, w.ndim)))), 1e-8)
    q = torch.round(wf / s.view(-1, *([1] * (w.ndim - 1))))
    return torch.clamp(q, -127, 127).to(torch.int8), s


def _on_cpu(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"int8 products take CUDA or CPU tensors, got {x.device}")
    return False


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def int_mm_padding(m: int, k: int, n: int) -> Tuple[int, int, int]:
    """The (M, K, N) a product is padded to for ``torch._int_mm``: more
    than 16 rows (32), depth and width multiples of 8."""
    return (m if m > 16 else 32), _round_up(k, 8), _round_up(n, 8)


def int_mm_reference(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain int8 product ``a [M, K] @ w[N, K]^T`` in int32: float64
    products of the integer values, exact at every K of the models."""
    return (a.double() @ w.double().t()).to(torch.int32)


def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a [M, K] int8 @ w [N, K]^T int8`` -> ``[M, N]`` int32 (exact).

    On the card both operands go to ``torch._int_mm`` with K contiguous
    (``w.t()``, a column-major ``[K, N]`` view): the layout the s8 tensor
    cores take, so nothing is copied on the way."""
    if a.dtype != torch.int8 or w.dtype != torch.int8 or a.ndim != 2 or w.ndim != 2:
        raise TypeError(f"int_mm takes 2-d int8 operands, got {a.dtype} {tuple(a.shape)} "
                        f"and {w.dtype} {tuple(w.shape)}")
    if a.shape[1] != w.shape[1]:
        raise ValueError(f"depths differ: {tuple(a.shape)} and {tuple(w.shape)}")
    if _on_cpu(a):
        return int_mm_reference(a, w)
    m, k = a.shape
    n = w.shape[0]
    mp, kp, np_ = int_mm_padding(m, k, n)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), w.contiguous().t())
    product_shapes[(mp, kp, np_)] += 1
    return out if (mp, np_) == (m, n) else out[:m, :n]


def im2col(q: torch.Tensor, kernel: Tuple[int, int], stride: Tuple[int, int],
           padding: Tuple[int, int]) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """An NHWC int8 tensor's patches as ``[B * H' * W', kh * kw * C]`` (zero
    padding, which stays zero after quantization; the depth ordered (i, j,
    c), as a ``[O, kh, kw, I]`` weight flattens), and (B, H', W')."""
    b, h, w, c = q.shape
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    ho, wo = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
    qp = F.pad(q, (0, 0, pw, pw, ph, ph)) if ph or pw else q
    cols = torch.stack([qp[:, i:i + sh * (ho - 1) + 1:sh, j:j + sw * (wo - 1) + 1:sw]
                        for i in range(kh) for j in range(kw)], dim=3)
    return cols.reshape(b * ho * wo, kh * kw * c), (b, ho, wo)


def rescale(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor, out_dtype) -> torch.Tensor:
    """``acc * (sx * sw)`` in fp32 (the scales multiplied first, as the
    JAX package does), cast to ``out_dtype``."""
    return (acc.float() * (sx * sw)).to(out_dtype)


def qconv(x: torch.Tensor, w: torch.Tensor, stride=(1, 1), padding=(1, 1),
          out_dtype=torch.bfloat16) -> torch.Tensor:
    """int8 convolution of NCHW ``x`` with an ``[O, I, kh, kw]`` weight:
    int32 accumulation, per-channel rescale, no bias. The result is NCHW in
    shape and channels-last in memory (the product's ``[B, H', W', O]``)."""
    qx, sx = quant_act(x)
    qw, sw = quant_w(w)
    cols, (b, ho, wo) = im2col(qx.permute(0, 2, 3, 1), tuple(w.shape[2:]), tuple(stride),
                               tuple(padding))
    acc = int_mm(cols, qw.permute(0, 2, 3, 1).reshape(w.shape[0], -1))
    return rescale(acc, sx, sw, out_dtype).reshape(b, ho, wo, -1).permute(0, 3, 1, 2)


def qdot(x: torch.Tensor, w: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """int8 ``x [..., in] @ w [out, in]^T``: int32 accumulation, per-channel
    rescale, no bias."""
    qx, sx = quant_act(x)
    qw, sw = quant_w(w)
    acc = int_mm(qx.reshape(-1, x.shape[-1]), qw)
    return rescale(acc, sx, sw, out_dtype).reshape(*x.shape[:-1], w.shape[0])
