#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card, ``nvcc`` and ``nvidia-smi``; it imports nothing of JAX or of the JAX
package. Six phases, any failure exits non-zero:

1. Device: the card's name and power limit, torch/CUDA versions, the
   time to build the CUDA kernels from ``distdiff_tpu_torch/csrc`` (one
   ``nvcc`` a source, all at once), each kernel's registers and spills from
   ``-Xptxas -v`` (a narrow flash kernel that spills fails the run) and the
   narrow flash kernels' dynamic shared memory.
2. Kernels, each held against its plain PyTorch version on the same inputs:
   every flash kernel at the main path's shapes in bf16 (against the plain
   fp32 version; timed beside ``F.scaled_dot_product_attention``, a
   yardstick the port never calls) and at ragged shapes (the narrow
   kernels also at every narrow head width, lengths one row on either side
   of their tiles, the 77-token kv, and views off 16-byte alignment, which
   take the staged loads); the four flash
   kernels' fp32 instances at main-path widths and ragged shapes (timed at
   the former); gn_fused, gn_stats and gn_apply at every GroupNorm shape of
   the counted runs, in bf16 and fp32, channels-last and contiguous, with
   and without SiLU, and at ragged shapes (timed in bf16 channels-last,
   beside ``F.group_norm`` + ``F.silu``). Times are medians of CUDA events,
   each beside the least time the card could take (``bound_ms``).
3. Agreement: the guided expansion at a small geometry whose attention
   reaches every flash kernel, in bf16 through the kernels, in bf16 through
   the plain attention and in fp32 through the plain attention, on the same
   weights and draws: the kernels' run stays as close to the fp32 run as
   the plain bf16 run. Then the fp32 ``tiny()`` pipeline's guided expand on
   the card through every kernel (norms once by gn_fused, once by the
   gn_stats + gn_apply pair) against the same port on the CPU.
4. Path: the guided expansion at full SD-1.5 geometry (UNet 860M, VAE,
   ResNet-50 guide with 100 classes, seeded random weights) at batch 2:
   DDIM-50, strength 0.5, CFG 7.5, transform guidance at plan index 30 over
   2 steps. One warm-up call, then one counted and timed call (each
   kernel's launches in it, by shape, against the counts the step plan
   implies, and the norms' memory formats) and two more timed calls.
5. Front end (the path of ``cli/generate_data.py``): prompts through the
   HashTokenizer and the CLIP-L text encoder, ``encode_images`` of 512^2
   images, prototypes from the guide's features over 400 seeded images of
   100 classes, then ``ExpansionDriver`` over
   ``make_split_expand(guide_chunk=1)`` for 4 work units, writing PNGs
   (their count, size and range, and each unit against its batch-1 run);
   one counted SplitExpand call against the plan, three timed ones.
6. The card line, the kernels' JSON line (one entry per kernel; its times
   are the means over that kernel's launches in the counted runs, and
   ``shapes`` holds each timed shape's own numbers), and the
   ``{"ok": true, ...}`` line.

``python3 chip_smoke.py --profile [--json PATH]`` runs phase 1, builds the
main path and traces one warm expand call with ``torch.profiler`` instead:
device time by layer and by kernel, and the device's idle share (and the
per-kernel table as JSON at PATH).
"""

from __future__ import annotations

import collections
import json
import math
import statistics
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense); recomputed beside the card nvidia-smi names.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12  # CUDA cores, outside the tensor cores
PEAK_BYTES = 3.35e12
# exp throughput of the special-function units (the FlashAttention-3 paper's figure)
PEAK_EXP = 3.9e12

BATCH = 2
SOURCES = {"flash_fwd": "distdiff_tpu_torch/csrc/flash_fwd.cu",
           "flash_bwd_fused": "distdiff_tpu_torch/csrc/flash_bwd.cu",
           "flash_bwd_dq": "distdiff_tpu_torch/csrc/flash_bwd.cu",
           "flash_bwd_dkv": "distdiff_tpu_torch/csrc/flash_bwd.cu",
           "gn_fused": "distdiff_tpu_torch/csrc/groupnorm.cu",
           "gn_stats": "distdiff_tpu_torch/csrc/groupnorm.cu",
           "gn_apply": "distdiff_tpu_torch/csrc/groupnorm.cu"}
REPLACES = {
    "flash_fwd": "distdiff_tpu/ops/flash.py:131 _fwd_kernel_single, :157 _fwd_kernel",
    "flash_bwd_fused": "distdiff_tpu/ops/flash.py:348 _bwd_fused_kernel",
    "flash_bwd_dq": "distdiff_tpu/ops/flash.py:266 _dq_kernel",
    "flash_bwd_dkv": "distdiff_tpu/ops/flash.py:301 _dkv_kernel",
    "gn_fused": "distdiff_tpu/ops/groupnorm.py:98 _gn_kernel",
    "gn_stats": "distdiff_tpu/ops/groupnorm.py:153 _gn_stats_kernel",
    "gn_apply": "distdiff_tpu/ops/groupnorm.py:190 _gn_apply_kernel",
}
GN_KERNELS = ("gn_fused", "gn_stats", "gn_apply")
# shared memory a block may use on the H100 after opting in; the plan's
# default (the run reads the card's own from gn_smem_optin)
H100_SMEM_OPTIN = 232448
# products (each 2*BH*Tq*Tk*D flops) and exps (BH*Tq*Tk) of each kernel
PRODUCTS = {"flash_fwd": 2, "flash_bwd_fused": 5, "flash_bwd_dq": 3, "flash_bwd_dkv": 4}


def require(ok: bool, what: str) -> None:
    """A check of the run (kept under ``python -O``, unlike ``assert``)."""
    if not ok:
        raise SystemExit(f"chip_smoke: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# a device-side spin queued before each timed call (~1 ms at the H100's
# clocks), so that the host's enqueueing of the call is hidden behind it
SPIN_CYCLES = 2_000_000


def time_ms(fn, iters: int) -> float:
    """Median of per-call CUDA-event times, after two warm-up calls. Each
    call starts behind a device spin, so the events bracket the device's
    work and not the host's launch gaps (which dominate µs-scale kernels)."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(name, bh, tq, tk, d, itemsize=2):
    """(bound_ms, bound_by): the larger of the bytes the function must move
    (inputs read once, outputs written once) over the memory rate and its
    operations (products on the bf16 tensor cores, or on the fp32 CUDA
    cores for fp32 inputs; exps on the special-function units) over their
    peak rates."""
    bf, f4 = itemsize, 4
    q, kv = bh * tq * d * bf, bh * tk * d * bf
    row = bh * tq * f4
    nbytes = {
        "flash_fwd": q + 2 * kv + q + row,                    # q,k,v -> o, lse
        "flash_bwd_fused": 2 * q + 2 * kv + 2 * row + q + 2 * kv,  # q,k,v,do,lse,delta -> dq,dk,dv
        "flash_bwd_dq": 2 * q + 2 * kv + 2 * row + q,
        "flash_bwd_dkv": 2 * q + 2 * kv + 2 * row + 2 * kv,
    }[name]
    t_bytes = nbytes / PEAK_BYTES
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS
    t_ops = max(PRODUCTS[name] * 2.0 * bh * tq * tk * d / peak, bh * tq * tk / PEAK_EXP)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations")


# the narrow (D <= 128) bf16 flash kernels: warp-specialised, TMA and wgmma
NARROW_KERNELS = ("flash_fwd_narrow_kernel", "flash_bwd_fused_kernel")


def ptxas_phase() -> None:
    """Each kernel's registers and spills from ``-Xptxas -v``, and the
    narrow flash kernels' dynamic shared memory; a narrow kernel that
    spills fails the run."""
    from distdiff_tpu_torch.ops import _build, flash

    spilled = []
    for src, log in _build.build_logs().items():
        for name, regs, stack, st, ld in _build.ptxas_report(log):
            print(f"  {src}: {name}: {regs} registers, {stack} B stack, spills {st} B stored / "
                  f"{ld} B loaded")
            if name.split("<")[0] in NARROW_KERNELS and (st or ld):
                spilled.append(name)
    smem = {dp: (_build.kernel("flash_fwd_narrow_smem")(dp),
                 _build.kernel("flash_bwd_fused_smem")(dp)) for dp in flash.NARROW_WIDTHS}
    print("  narrow kernels' dynamic shared memory (forward, fused backward) by padded "
          f"width: {smem}")
    require(not spilled, f"narrow flash kernels spill registers: {spilled}")


def kernel_phase():
    """Hold every kernel against its plain version at the main-path shapes
    (timed), and at ragged shapes (checked only: q and kv lengths off the
    tiles, the 77-token kv of cross-attention, head widths off the padded
    ones, every narrow width, views off 16-byte alignment); returns one
    record per timed (kernel, shape)."""
    import torch
    import torch.nn.functional as F

    from distdiff_tpu_torch.ops import flash

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg_b = 2 * BATCH  # CFG doubles the UNet batch
    split = ["flash_bwd_dq", "flash_bwd_dkv"]
    every = ["flash_fwd", "flash_bwd_fused"] + split
    shapes = [
        # (label, B, H, Tq, Tk, D, kernels to run, timed)
        ("unet64", cfg_b, 8, 4096, 4096, 40, every, True),
        ("unet32", cfg_b, 8, 1024, 1024, 80, ["flash_fwd", "flash_bwd_fused"], True),
        ("vae_mid", BATCH, 1, 4096, 4096, 512, ["flash_fwd"] + split, True),
        ("ragged", 1, 3, 300, 130, 40, every, False),
        ("cross", 2, 2, 200, 77, 64, every, False),
        ("odd", 2, 1, 129, 70, 33, every, False),
        ("ragged512", 1, 1, 100, 333, 512, ["flash_fwd"] + split, False),
    ]
    # the narrow kernels at every narrow width, with q and kv lengths one
    # row on either side of their tiles (forward: 128 q rows, 128 kv rows,
    # 64 past D = 80; fused backward: 128 kv rows, 64 q rows), at the
    # 77-token kv, and on views whose storage offset is off 16 bytes (the
    # staged route); checked only
    narrow = ["flash_fwd", "flash_bwd_fused"]
    shapes += [
        ("w33", 1, 2, 127, 129, 33, narrow, False),
        ("w40", 1, 2, 129, 127, 40, narrow, False),
        ("w64", 1, 2, 63, 65, 64, narrow, False),
        ("w80", 1, 2, 65, 63, 80, narrow, False),
        ("w96", 1, 2, 127, 65, 96, narrow, False),
        ("w128", 1, 2, 129, 63, 128, narrow, False),
        ("cross40", 2, 2, 257, 77, 40, narrow, False),
        ("cross80", 2, 2, 64, 77, 80, narrow, False),
        ("offset40", 1, 3, 200, 150, 40, narrow, "offset"),
        ("offset80", 1, 2, 129, 65, 80, narrow, "offset"),
    ]
    entries = []
    for label, b, h, tq, tk, d, names, timed in shapes:
        bh = b * h

        def rnd(*s):
            if timed == "offset":  # a contiguous view one element into its storage
                n = math.prod(s)
                return torch.randn(n + 1, generator=gen, device=dev).to(torch.bfloat16)[1:].view(*s)
            return torch.randn(*s, generator=gen, device=dev).to(torch.bfloat16)

        q, do, k, v = rnd(bh, tq, d), rnd(bh, tq, d), rnd(bh, tk, d), rnd(bh, tk, d)
        if d <= flash.FUSED_BWD_MAX_D:
            plan = flash.narrow_plan(d, q, k, v, do)
            require(plan[1] == (0 if timed == "offset" or d % 8 else 1),
                    f"{label}: load route {plan} for d={d}")
            print(f"  {label} [{bh},{tq},{tk},{d}]: padded width {plan[0]}, "
                  f"{'TMA' if plan[1] else 'staged'} loads")
        timed = timed is True
        ref_o, ref_lse = flash.flash_fwd_reference(q, k, v)
        o, lse = flash.flash_fwd(q, k, v)
        torch.cuda.synchronize()
        delta = flash.attention_delta(o, do)
        ref_grads = flash.flash_bwd_reference(q, k, v, o, lse, do)
        if timed:
            q4, k4, v4, do4 = (x.view(b, h, -1, d) for x in (q, k, v, do))
            qg, kg, vg = (x.clone().requires_grad_(True) for x in (q4, k4, v4))
            sdpa_out = F.scaled_dot_product_attention(qg, kg, vg)

            def lib_bwd():
                torch.autograd.grad(sdpa_out, (qg, kg, vg), do4, retain_graph=True)

        for name in names:
            if name == "flash_fwd":
                outs = {"o": (o, ref_o), "lse": (lse, ref_lse)}
                run = lambda: flash.flash_fwd(q, k, v)  # noqa: E731
                plain = lambda: flash.flash_fwd_reference(q, k, v)  # noqa: E731
                lib = lambda: F.scaled_dot_product_attention(q4, k4, v4)  # noqa: E731
            else:
                if name == "flash_bwd_fused":
                    got = dict(zip(("dq", "dk", "dv"),
                                   flash.flash_bwd_fused(q, k, v, do, lse, delta)))
                    run = lambda: flash.flash_bwd_fused(q, k, v, do, lse, delta)  # noqa: E731
                elif name == "flash_bwd_dq":
                    got = {"dq": flash.flash_bwd_dq(q, k, v, do, lse, delta)}
                    run = lambda: flash.flash_bwd_dq(q, k, v, do, lse, delta)  # noqa: E731
                else:
                    got = dict(zip(("dk", "dv"), flash.flash_bwd_dkv(q, k, v, do, lse, delta)))
                    run = lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta)  # noqa: E731
                torch.cuda.synchronize()
                ref = dict(zip(("dq", "dk", "dv"), ref_grads))
                outs = {key: (val, ref[key]) for key, val in got.items()}
                plain = lambda: flash.flash_bwd_reference(q, k, v, o, lse, do)  # noqa: E731
                lib = lib_bwd if timed else None
            max_err = 0.0
            for key, (val, want) in outs.items():
                err = (val.float() - want).abs().max().item()
                scale = want.abs().max().item()
                # bf16 outputs round to 2^-9 relative, and so do the p and
                # ds the kernels feed the tensor cores (as the reference
                # rounds them); fp32 sums in another order (and dq's
                # run-to-run atomic order) stay below that, so 2^-7 of the
                # largest magnitude is the tolerance. lse is fp32: 1e-4
                # absolute (|lse| ~ 10).
                tol = 1e-4 if key == "lse" else 2.0 ** -7 * scale
                ok = math.isfinite(err) and err <= tol
                print(f"  {name} {label} {key}: max_abs_err {err:.3e} "
                      f"(tol {tol:.3e}, ref max {scale:.3e}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"{name} disagrees with its plain version at {label}")
                if key != "lse":
                    max_err = max(max_err, err)
            if not timed:
                continue
            iters = 20 if d <= 128 else 10
            ms = time_ms(run, iters)
            plain_ms = time_ms(plain, 5)
            lib_ms = time_ms(lib, iters)
            b_ms, b_by = bound(name, bh, tq, tk, d)
            entry = {
                "name": name, "route": "cuda",
                "source": SOURCES[name], "replaces": REPLACES[name],
                "shape": [bh, tq, tk, d], "cell": label,
                "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            }
            print(f"  {name} {label} [{bh},{tq},{d}]: kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms, sdpa {lib_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
            entries.append(entry)
        if timed:
            del sdpa_out, qg, kg, vg
        del ref_grads, ref_o
        torch.cuda.empty_cache()
    return entries


def flash_f32_phase() -> list:
    """The four flash kernels on fp32 inputs (their fp32 instances,
    csrc/flash_f32.cu) at main-path widths and at ragged shapes, against the
    plain fp32 version; timed at the main-path widths. Returns one record
    per timed (kernel, shape)."""
    import torch
    import torch.nn.functional as F

    from distdiff_tpu_torch.ops import flash

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    split = ["flash_bwd_dq", "flash_bwd_dkv"]
    every = ["flash_fwd", "flash_bwd_fused"] + split
    shapes = [
        # (label, BH, Tq, Tk, D, kernels, timed)
        ("unet64_f32", 32, 4096, 4096, 40, ["flash_fwd", "flash_bwd_fused"], True),
        ("vae_mid_f32", 2, 4096, 4096, 512, ["flash_fwd"] + split, True),
        ("tiny_f32", 4, 576, 576, 16, every, False),
        ("ragged_f32", 3, 300, 130, 40, every, False),
        ("odd_f32", 2, 129, 77, 160, ["flash_fwd"] + split, False),
    ]
    entries = []
    for label, bh, tq, tk, d, names, timed in shapes:
        q, do = (torch.randn(bh, tq, d, generator=gen, device=dev) for _ in range(2))
        k, v = (torch.randn(bh, tk, d, generator=gen, device=dev) for _ in range(2))
        o, lse = flash.flash_fwd(q, k, v)
        ref_o, ref_lse = flash.flash_fwd_reference(q, k, v)
        delta = flash.attention_delta(o, do)
        ref = dict(zip(("dq", "dk", "dv"), flash.flash_bwd_reference(q, k, v, o, lse, do)))
        calls = {
            "flash_fwd": lambda: flash.flash_fwd(q, k, v),
            "flash_bwd_fused": lambda: flash.flash_bwd_fused(q, k, v, do, lse, delta),
            "flash_bwd_dq": lambda: (flash.flash_bwd_dq(q, k, v, do, lse, delta),),
            "flash_bwd_dkv": lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta),
        }
        keys = {"flash_fwd": ("o", "lse"), "flash_bwd_fused": ("dq", "dk", "dv"),
                "flash_bwd_dq": ("dq",), "flash_bwd_dkv": ("dk", "dv")}
        want = dict(ref, o=ref_o, lse=ref_lse)
        for name in names:
            got = dict(zip(keys[name], calls[name]()))
            torch.cuda.synchronize()
            max_err = 0.0
            for key, val in got.items():
                require(val.dtype == torch.float32, f"{name} returned {val.dtype} on fp32")
                err = (val - want[key]).abs().max().item()
                scale = want[key].abs().max().item()
                # fp32 products and sums throughout (CUDA-core FMA, no TF32,
                # nothing rounded to bf16): only the summation order differs
                # from the plain version, ~1e-6 relative; 1e-4 of the
                # largest magnitude (lse: 1e-4 absolute) is the tolerance
                tol = 1e-4 if key == "lse" else 1e-4 * scale
                ok = math.isfinite(err) and err <= tol
                print(f"  {name} {label} fp32 {key}: max_abs_err {err:.3e} (tol {tol:.3e}) "
                      f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"{name} (fp32) disagrees with its plain version at {label}")
                if key != "lse":
                    max_err = max(max_err, err)
            if not timed:
                continue
            ms = time_ms(calls[name], 5)
            plain = (lambda: flash.flash_fwd_reference(q, k, v)) if name == "flash_fwd" \
                else (lambda: flash.flash_bwd_reference(q, k, v, o, lse, do))
            plain_ms = time_ms(plain, 3)
            q4, k4, v4 = (x.view(1, bh, -1, d) for x in (q, k, v))
            if name == "flash_fwd":
                lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4), 5)
            else:
                qg, kg, vg = (x.clone().requires_grad_(True) for x in (q4, k4, v4))
                out = F.scaled_dot_product_attention(qg, kg, vg)
                lib_ms = time_ms(lambda: torch.autograd.grad(
                    out, (qg, kg, vg), do.view(1, bh, -1, d), retain_graph=True), 5)
                del out, qg, kg, vg
            b_ms, b_by = bound(name, bh, tq, tk, d, itemsize=4)
            print(f"  {name} {label} [{bh},{tq},{d}] fp32: kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms, sdpa {lib_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
            entries.append({"name": name, "cell": label, "shape": [bh, tq, tk, d],
                            "dtype": "fp32", "max_abs_err": max_err, "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": lib_ms})
        del ref, ref_o
        torch.cuda.empty_cache()
    return entries


# ----------------------------------------------------------- GroupNorm plan

def _down(side: int) -> int:
    return (side + 1) // 2  # 3x3 stride-2 convolution, padding 1


def unet_norms(ucfg, side: int) -> list:
    """(C, side, act) of every GroupNorm of one UNet forward on a side^2
    latent, in call order (models/unet.py)."""
    boc, n = ucfg.block_out_channels, len(ucfg.block_out_channels)
    out, skips, x_ch, s = [], [boc[0]], boc[0], side
    for bi, ch in enumerate(boc):
        for _ in range(ucfg.layers_per_block):
            out += [(x_ch, s, "silu"), (ch, s, "silu")]
            x_ch = ch
            if ucfg.cross_attention[bi] and ucfg.depth_at(bi) > 0:
                out.append((ch, s, None))
            skips.append(ch)
        if bi < n - 1:
            skips.append(ch)
            s = _down(s)
    mid = boc[-1]
    out += [(mid, s, "silu")] * 2 + [(mid, s, None)] + [(mid, s, "silu")] * 2
    for ui in range(n):
        bi = n - 1 - ui
        ch = boc[bi]
        for _ in range(ucfg.layers_per_block + 1):
            out += [(x_ch + skips.pop(), s, "silu"), (ch, s, "silu")]
            x_ch = ch
            if ucfg.cross_attention[bi] and ucfg.depth_at(bi) > 0:
                out.append((ch, s, None))
        if bi > 0:
            s *= 2
    return out + [(boc[0], s, "silu")]


def _vae_mid(c, s) -> list:
    return [(c, s, "silu")] * 2 + [(c, s, None)] + [(c, s, "silu")] * 2


def vae_decode_norms(vcfg, side: int) -> list:
    """The same for one VAE decode of a side^2 latent (models/vae.py)."""
    boc = vcfg.block_out_channels
    out, x_ch, s = _vae_mid(boc[-1], side), boc[-1], side
    for bi in reversed(range(len(boc))):
        for _ in range(vcfg.layers_per_block + 1):
            out += [(x_ch, s, "silu"), (boc[bi], s, "silu")]
            x_ch = boc[bi]
        if bi > 0:
            s *= 2
    return out + [(boc[0], s, "silu")]


def vae_encode_norms(vcfg, side: int) -> list:
    """The same for one VAE encode of a side^2 image."""
    boc = vcfg.block_out_channels
    out, x_ch, s = [], boc[0], side
    for bi, ch in enumerate(boc):
        for _ in range(vcfg.layers_per_block):
            out += [(x_ch, s, "silu"), (ch, s, "silu")]
            x_ch = ch
        if bi < len(boc) - 1:
            s = _down(s)
    return out + _vae_mid(boc[-1], s) + [(boc[-1], s, "silu")]


def gn_plan(calls, itemsize: int = 2, smem_limit: int = H100_SMEM_OPTIN):
    """GroupNorm kernel launches by (kernel, (B, C, H, W)) of ``calls``, a
    list of (times, batch, norms): gn_fused where a span fits a block's
    shared memory, else the gn_stats + gn_apply pair."""
    from distdiff_tpu_torch.models.layers import group_count
    from distdiff_tpu_torch.ops.groupnorm import fused_fits

    plan = collections.Counter()
    for times, b, norms in calls:
        for c, s, _ in norms:
            shape = (b, c, s, s)
            if fused_fits(c, group_count(c), s * s, itemsize, smem_limit):
                plan[("gn_fused", shape)] += times
            else:
                plan[("gn_stats", shape)] += times
                plan[("gn_apply", shape)] += times
    return plan


def expand_gn_calls(pipe, batch: int, guide_chunk=None) -> list:
    """(times, batch, norms) of one transform-guided expand call at
    ``batch``: the plain UNet steps on the CFG pair, the rollout's UNet
    steps and VAE decodes on sub-batches of ``guide_chunk`` (each twice:
    the rollout and its recompute in the backward), and the final decode."""
    from distdiff_tpu_torch.schedulers import guidance_window, img2img_start_index

    cfg, gcfg = pipe.config, pipe.guidance_cfg
    n = pipe.sched.num_inference_steps
    start = img2img_start_index(pipe.sched, pipe.strength)
    g0, _ = guidance_window(pipe.sched, gcfg.guidance_step, gcfg.guidance_period)
    chunk = guide_chunk or batch
    units = batch // chunk
    ls = cfg.latent_size
    unet = unet_norms(cfg.unet, ls)
    dec = vae_decode_norms(cfg.vae, ls)
    period = gcfg.guidance_period
    return [((g0 - start) + (n - g0), 2 * batch, unet),
            (2 * period * units, 2 * chunk, unet),
            (2 * period * units, chunk, dec),
            (1, batch, dec)]


def gn_shapes(calls) -> dict:
    """Every distinct (B, C, H, W) of ``calls`` with the activations it
    sees."""
    from distdiff_tpu_torch.models.layers import group_count

    shapes = {}
    for _, b, norms in calls:
        for c, s, act in norms:
            shapes.setdefault((b, c, s, s), (group_count(c), set()))[1].add(act)
    return shapes


def gn_bound(name, shape, itemsize):
    """(bound_ms, "bytes"): the slab's bytes over the memory rate, read once
    and written once by gn_fused and gn_apply, read once by gn_stats."""
    b, c, h, w = shape
    passes = 1 if name == "gn_stats" else 2
    return passes * b * c * h * w * itemsize / PEAK_BYTES * 1e3, "bytes"


def gn_kernel_phase(shapes, timed=True) -> list:
    """Hold gn_fused, gn_stats and gn_apply against the plain version at
    every main-path shape ({(B, C, H, W): (groups, acts)}), each in bf16 and
    fp32, channels-last and contiguous, with and without SiLU, and at
    ragged shapes (odd H*W, 1 and 3 channels a group) where every kernel is
    called directly. Timed (bf16, channels-last, the shape's own
    activation): the kernel(s), the plain version, and F.group_norm + F.silu
    (the library yardstick, never called by the port). Returns one record
    per timed (kernel, shape)."""
    import torch
    import torch.nn.functional as F

    from distdiff_tpu_torch.ops import groupnorm as gn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    smem_limit, sm_count = gn._device_limits(dev)

    def data(shape, groups, dtype, cl):
        b, c = shape[:2]
        x = (torch.randn(shape, generator=gen, device=dev) * 1.5 + 0.3).to(dtype)
        if cl:
            x = x.to(memory_format=torch.channels_last)
        scale = (1.0 + 0.5 * torch.randn(c, generator=gen, device=dev)).to(dtype)
        bias = (0.5 * torch.randn(c, generator=gen, device=dev)).to(dtype)
        return x, scale, bias

    def tol_of(ref, dtype):
        # bf16: the kernel and the plain version round a, b and y alike but
        # sum in another order, so a or b may land one bf16 step apart:
        # 2^-7 of the largest magnitude. fp32: 2e-4 absolute plus 2e-4 of
        # each value, as tests/test_groupnorm_kernel.py holds the Pallas
        # kernels.
        if dtype == torch.bfloat16:
            return 2.0 ** -7 * ref.float().abs().max().item(), 0.0
        return 2e-4, 2e-4

    def check(what, got, ref, dtype):
        atol, rtol = tol_of(ref, dtype)
        diff = (got.float() - ref.float()).abs()
        err = diff.max().item()
        excess = (diff - rtol * ref.float().abs()).max().item()
        ok = math.isfinite(err) and excess <= atol
        if not ok:
            print(f"  {what}: max_abs_err {err:.3e} (atol {atol:.3e}, rtol {rtol}) FAIL")
            raise SystemExit(f"groupnorm kernel disagrees with its plain version: {what}")
        return err

    entries, n_checks = [], 0
    cases = []
    for shape, (groups, acts) in sorted(shapes.items(), key=lambda kv: str(kv[0])):
        main = "silu" if "silu" in acts else None
        other = None if main == "silu" else "silu"
        cases += [(shape, groups, torch.bfloat16, True, main, timed),
                  (shape, groups, torch.bfloat16, False, other, False),
                  (shape, groups, torch.float32, True, other, False),
                  (shape, groups, torch.float32, False, main, False)]
    ragged = [((2, 96, 7, 9), 32), ((3, 32, 5, 5), 32), ((1, 192, 33, 31), 64),
              ((2, 40, 15, 17), 8)]
    for shape, groups in ragged:
        for dtype in (torch.bfloat16, torch.float32):
            for cl in (True, False):
                cases.append((shape, groups, dtype, cl, "silu" if cl else None, "direct"))
    for shape, groups, dtype, cl, act, mode in cases:
        x, scale, bias = data(shape, groups, dtype, cl)
        tag = (f"{list(shape)} g{groups} {str(dtype)[6:]} {'nhwc' if cl else 'nchw'} "
               f"act={act}")
        ref_ab = gn.group_norm_stats_reference(x, scale, bias, groups, 1e-5)
        ref = gn.group_norm_apply_reference(x, ref_ab, act)
        if mode == "direct":  # every kernel, whatever the shared-memory rule says
            y = torch.empty_like(x)
            gn.gn_fused(x, scale, bias, groups, 1e-5, act, y)
            check(f"gn_fused {tag}", y, ref, dtype)
            ab = gn.gn_stats(x, scale, bias, groups, 1e-5, sm_count)
            check(f"gn_stats {tag}", ab, ref_ab, torch.float32)
            y2 = torch.empty_like(x)
            gn.gn_apply(x, ref_ab, act, y2, sm_count)
            check(f"gn_apply {tag}", y2, ref, dtype)
            require(y.stride() == x.stride() and y2.stride() == x.stride(),
                    f"output strides differ from the input's at {tag}")
            n_checks += 3
            continue
        before = dict(gn.launch_counts)
        y = gn.group_norm_forward(x, scale, bias, groups, 1e-5, act)
        torch.cuda.synchronize()
        ran = [k for k in GN_KERNELS if gn.launch_counts[k] > before[k]]
        require(y.stride() == x.stride(), f"output strides differ from the input's at {tag}")
        err = check(f"{'+'.join(ran)} {tag}", y, ref, dtype)
        n_checks += 1
        if not mode:
            continue
        itemsize = x.element_size()
        w16 = scale.to(dtype), bias.to(dtype)

        def lib():
            out = F.group_norm(x, groups, w16[0], w16[1], 1e-5)
            return F.silu(out) if act == "silu" else out

        lib_ms = time_ms(lib, 10)
        plain_ms = time_ms(lambda: gn.group_norm_reference(x, scale, bias, groups, 1e-5, act), 5)
        if ran == ["gn_fused"]:
            out = torch.empty_like(x)
            runs = {"gn_fused": lambda: gn.gn_fused(x, scale, bias, groups, 1e-5, act, out)}
            plains = {"gn_fused": plain_ms}
            errs = {"gn_fused": err}
        else:
            ab = gn.gn_stats(x, scale, bias, groups, 1e-5, sm_count)
            out = torch.empty_like(x)
            gn.gn_apply(x, ab, act, out, sm_count)
            torch.cuda.synchronize()
            errs = {"gn_stats": check(f"gn_stats {tag}", ab, ref_ab, torch.float32),
                    "gn_apply": check(f"gn_apply {tag}", out, gn.group_norm_apply_reference(
                        x, ab, act), dtype)}
            runs = {"gn_stats": lambda: gn.gn_stats(x, scale, bias, groups, 1e-5, sm_count),
                    "gn_apply": lambda: gn.gn_apply(x, ab, act, out, sm_count)}
            plains = {"gn_stats": time_ms(lambda: gn.group_norm_stats_reference(
                          x, scale, bias, groups, 1e-5), 5),
                      "gn_apply": time_ms(lambda: gn.group_norm_apply_reference(x, ab, act), 5)}
        for name, run in runs.items():
            ms = time_ms(run, 10)
            b_ms, b_by = gn_bound(name, shape, itemsize)
            print(f"  {name} {list(shape)} bf16 nhwc act={act}: kernel {ms:.4f} ms, plain "
                  f"{plains[name]:.4f} ms, F.group_norm+silu {lib_ms:.4f} ms (whole norm), "
                  f"bound {b_ms:.4f} ms ({b_by}), max_abs_err {errs[name]:.3e}")
            entries.append({"name": name, "cell": "main", "shape": list(shape),
                            "dtype": "bf16", "layout": "nhwc", "act": act,
                            "max_abs_err": errs[name], "ms": ms, "plain_ms": plains[name],
                            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
        del x, y, ref
    print(f"  {n_checks} GroupNorm checks against the plain version: ok "
          f"(shared-memory limit {smem_limit} bytes, {sm_count} SMs)")
    torch.cuda.empty_cache()
    return entries


def expected_launches(pipe, units: int = 1) -> dict:
    """Flash kernel launches of one transform-guided expand call, from the
    plan: UNet forwards = plain steps + 2 x period (rollout and its
    recompute in the backward) for each of ``units`` guidance sub-batches;
    VAE mid-block forwards = 2 x period per sub-batch + the final decode."""
    from distdiff_tpu_torch.schedulers import guidance_window, img2img_start_index

    cfg, ucfg, gcfg = pipe.config, pipe.config.unet, pipe.guidance_cfg
    n = pipe.sched.num_inference_steps
    start = img2img_start_index(pipe.sched, pipe.strength)
    g0, _ = guidance_window(pipe.sched, gcfg.guidance_step, gcfg.guidance_period)
    period = gcfg.guidance_period
    per_unet = 0  # self-attentions with kv > 256 tokens in one UNet forward
    for bi in range(len(ucfg.block_out_channels)):
        side = cfg.latent_size // 2 ** bi
        if ucfg.cross_attention[bi] and side * side > 256:
            per_unet += ucfg.depth_at(bi) * (2 * ucfg.layers_per_block + 1)
    vae_tokens = cfg.latent_size ** 2
    vae_flash = vae_tokens > 256
    unet_fwd = (g0 - start) + 2 * period * units + (n - g0)
    vae_big_d = max(pipe.config.vae.block_out_channels) > 128
    return {
        "flash_fwd": unet_fwd * per_unet + (2 * period * units + 1) * vae_flash,
        "flash_bwd_fused": period * per_unet * units,
        "flash_bwd_dq": period * vae_flash * vae_big_d * units,
        "flash_bwd_dkv": period * vae_flash * vae_big_d * units,
    }


def agreement_phase() -> None:
    """The guided expansion at a small geometry, run three ways on one card
    with the same weights and draws: bf16 through the kernels, bf16 through
    the plain attention, and fp32 through the plain attention.

    UNet heads of 16 over a 24^2 latent (576 tokens) take flash_fwd and
    flash_bwd_fused; the VAE mid-block at width 160 (> 128) takes flash_fwd
    and the split flash_bwd_dq/flash_bwd_dkv pair. Raising the dispatch's
    kv threshold past 576 points every attention at the plain path."""
    import dataclasses

    import torch

    from distdiff_tpu_torch.config import GuidanceConfig, PipelineConfig, VAEConfig
    from distdiff_tpu_torch.models.guide import create_model
    from distdiff_tpu_torch.ops import attention, flash
    from distdiff_tpu_torch.sampling import ExpansionPipeline, SamplerConfig
    from distdiff_tpu_torch.sampling.pipeline import init_weights

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    guide = create_model("tiny_resnet", num_classes=3, device=dev)
    init_weights(guide.module, gen)
    fd = guide.feature_dim
    gp = torch.randn(3, fd, generator=gen, device=dev)
    lp = torch.randn(3, 2, fd, generator=gen, device=dev)
    tiny = PipelineConfig.tiny(sample_size=48)

    def build(dtype):
        # the weights are fp32 and seeded alike; dtype is the compute type
        cfg = dataclasses.replace(
            tiny, unet=dataclasses.replace(tiny.unet, dtype=dtype),
            vae=VAEConfig(block_out_channels=(16, 160), layers_per_block=1, dtype=dtype))
        return ExpansionPipeline.create(
            cfg, sampler_cfg=SamplerConfig(guidance_scale=3.0),
            guidance_cfg=GuidanceConfig(guidance_step=4, guidance_period=2, K=2,
                                        guide_input_size=32, rho=0.5),
            guide=guide, global_protos=gp, local_protos=lp, strength=0.5, seed=3,
            device=dev)

    ls = tiny.latent_size
    lat = torch.randn(2, ls, ls, 4, generator=gen, device=dev) * 0.2
    cond = torch.randn(2, 16, 32, generator=gen, device=dev)
    uncond = torch.randn(2, 16, 32, generator=gen, device=dev)
    targets = torch.tensor([1, 2], device=dev)
    pipe16, pipe32 = build(torch.bfloat16), build(torch.float32)
    draws = pipe16.draw_inputs(lat, gen)

    def run(pipe, plain):
        small_kv = attention.SMALL_KV
        if plain:
            attention.SMALL_KV = 10 ** 9
        try:
            img, aux = pipe.make_expand_fn()(
                lat, cond, uncond, targets, noise=draws[0], gamma0=draws[1],
                beta0=draws[2], return_aux=True)
            torch.cuda.synchronize()
        finally:
            attention.SMALL_KV = small_kv
        return img.float(), aux["latents_after"].float(), aux["score"].float()

    flash.reset_launch_counts()
    kern = run(pipe16, plain=False)
    counts = dict(flash.launch_counts)
    plain16 = run(pipe16, plain=True)
    plain32 = run(pipe32, plain=True)
    print(f"  kernel launches at the small geometry: {counts}")
    require(all(c > 0 for c in counts.values()), f"a kernel was not launched: {counts}")
    require(tuple(kern[0].shape) == (2, 48, 48, 3) and bool(torch.isfinite(kern[0]).all()),
            "small-geometry images are not finite [2, 48, 48, 3]")
    # Both bf16 runs round at every layer, and those roundings carry through
    # 7 UNet calls, the guidance gradient (rho 0.5) and the decode, so they
    # sit some 1e-2 from the fp32 run. The kernels must not add to that:
    # the bf16 run through them stays within twice the plain bf16 run's
    # distance from the fp32 run (plus 1e-3 for a plain error near 0).
    for i, what in enumerate(("image", "updated latents", "guidance score")):
        ref = plain32[i]
        scale = float(ref.abs().max()) if what == "guidance score" else 1.0
        err_k = float((kern[i] - ref).abs().max()) / scale
        err_p = float((plain16[i] - ref).abs().max()) / scale
        tol = 2.0 * err_p + 1e-3
        ok = math.isfinite(err_k) and err_k <= tol
        print(f"  {what}{' (relative)' if scale != 1.0 else ''} against fp32: bf16 kernels "
              f"{err_k:.3e}, bf16 plain {err_p:.3e} (tol {tol:.3e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"the kernel path strays from the fp32 path on {what}")


def fp32_agreement_phase() -> None:
    """The fp32 tiny() pipeline's guided expand on the card, through every
    kernel (flash in fp32; the VAE at width 160 so that its mid-block takes
    the split dq/dkv pair), against the same port on the CPU (plain
    versions) with the same weights and the same draws, made on the CPU.
    The card runs it twice: with the card's shared-memory limit (every
    norm fits gn_fused) and with the limit set to 0 (every norm takes
    gn_stats + gn_apply)."""
    import dataclasses

    import torch

    from distdiff_tpu_torch.config import GuidanceConfig, PipelineConfig, VAEConfig
    from distdiff_tpu_torch.models.guide import create_model
    from distdiff_tpu_torch.ops import flash
    from distdiff_tpu_torch.ops import groupnorm as gn
    from distdiff_tpu_torch.sampling import ExpansionPipeline, SamplerConfig
    from distdiff_tpu_torch.sampling.pipeline import init_weights

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(8)
    cfg = dataclasses.replace(PipelineConfig.tiny(sample_size=48), vae=VAEConfig(
        block_out_channels=(16, 160), layers_per_block=1, dtype=torch.float32))
    guides = [create_model("tiny_resnet", num_classes=3, device=d) for d in ("cpu", dev)]
    init_weights(guides[0].module, gen)
    guides[1].module.load_state_dict(guides[0].module.state_dict())
    fd = guides[0].feature_dim
    gp, lp = torch.randn(3, fd, generator=gen), torch.randn(3, 2, fd, generator=gen)
    pipes = [ExpansionPipeline.create(
        cfg, sampler_cfg=SamplerConfig(guidance_scale=3.0),
        guidance_cfg=GuidanceConfig(guidance_step=4, guidance_period=2, K=2,
                                    guide_input_size=32, rho=0.5),
        guide=g, global_protos=gp, local_protos=lp, strength=0.5, seed=8, device=d)
        for g, d in zip(guides, ("cpu", dev))]
    for name in ("unet", "vae", "text_encoder"):
        getattr(pipes[1], name).load_state_dict(getattr(pipes[0], name).state_dict())
    ls = cfg.latent_size
    inputs = (torch.randn(2, ls, ls, 4, generator=gen) * 0.2,
              torch.randn(2, 16, 32, generator=gen), torch.randn(2, 16, 32, generator=gen),
              torch.tensor([1, 2]))
    draws = dict(zip(("noise", "gamma0", "beta0"), pipes[0].draw_inputs(inputs[0], gen)))

    def run(pipe, device):
        img, aux = pipe.make_expand_fn()(
            *(t.to(device) for t in inputs), return_aux=True,
            **{k: v.to(device) for k, v in draws.items()})
        return [t.float().cpu() for t in (img, aux["latents_after"], aux["score"])]

    t0 = time.time()
    want = run(pipes[0], "cpu")
    cpu_s = time.time() - t0
    idx = torch.cuda.current_device()
    limit = gn._device_limits(dev)[0]
    launched = {}
    for label, smem in (("gn_fused", limit), ("gn_stats+gn_apply", 0)):
        flash.reset_launch_counts()
        gn.reset_launch_counts()
        gn._smem_limit[idx] = smem
        try:
            got = run(pipes[1], dev)
            torch.cuda.synchronize()
        finally:
            gn._smem_limit[idx] = limit
        counts = dict(flash.launch_counts, **gn.launch_counts)
        for k, c in counts.items():
            launched[k] = launched.get(k, 0) + c
        print(f"  fp32 tiny expand on the card, norms by {label}: launches {counts}; "
              f"norm layouts {dict(gn.layout_counts)}")
        # fp32 on both sides (TF32 off); only the summation order differs
        # (cuDNN/cuBLAS and the kernels' tiles against the CPU's), ~1e-6 a
        # layer; 1e-3 covers its growth through 7 UNet calls, the guidance
        # gradient (rho 0.5) and the decode
        for what, g, w in zip(("image", "updated latents", "guidance score"), got, want):
            scale = float(w.abs().max()) if what == "guidance score" else 1.0
            err = float((g - w).abs().max()) / scale
            ok = math.isfinite(err) and err <= 1e-3
            print(f"  {what}{' (relative)' if scale != 1.0 else ''}: card against CPU "
                  f"{err:.3e} (tol 1.0e-03) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"the fp32 card run strays from the CPU run on {what}")
    print(f"  (CPU run {cpu_s:.1f} s)")
    require(all(c > 0 for c in launched.values()), f"a kernel was not launched: {launched}")


class SmokeDataset:
    """What ExpansionDriver reads of a dataset: image_paths, per-item labels,
    class_names, and items with latent, cond, uncond and target."""

    def __init__(self, image_paths, labels, class_names, items):
        self.image_paths, self.labels = image_paths, labels
        self.class_names, self.items = class_names, items

    def __getitem__(self, i):
        return self.items[i]


def main_gn_calls() -> list:
    """(times, batch, norms) of every GroupNorm the counted runs make at
    SD-1.5 geometry: the guided expand at batch 2 (phase 4), the same split
    with guide_chunk=1 (phase 5), and the VAE encode of its 512^2 images."""
    import types

    from distdiff_tpu_torch.config import GuidanceConfig, PipelineConfig
    from distdiff_tpu_torch.schedulers import make_schedule

    cfg = PipelineConfig.sd15()
    pipe = types.SimpleNamespace(config=cfg, guidance_cfg=GuidanceConfig(),
                                 sched=make_schedule(cfg.num_inference_steps), strength=0.5)
    return (expand_gn_calls(pipe, BATCH) + expand_gn_calls(pipe, BATCH, guide_chunk=1)
            + [(1, BATCH, vae_encode_norms(cfg.vae, cfg.sample_size))])


FRONT_CLASSES = 100
FRONT_ITEMS = 2       # dataset images expanded
FRONT_PER_PROMPT = 2  # images per dataset image: 4 work units
FRONT_PROTO_IMAGES = 4  # guide images per class for the prototypes


def frontend_phase(pipe) -> dict:
    """The front of generate_data's path at full SD-1.5 width, on seeded
    random weights and pixels: HashTokenizer prompts through the CLIP-L text
    encoder (cond and the "" uncond), encode_images of 512^2 images,
    prototypes from extract_features over 4 seeded 224^2 images for each of
    100 classes (build_prototypes with K = 3, normalize_prototypes), then
    ExpansionDriver over make_split_expand(guide_chunk=1) for 4 work units,
    writing PNGs. Returns the counts of the run and its numbers."""
    import os
    import tempfile
    import types

    import numpy as np
    import torch

    from distdiff_tpu_torch.models import HashTokenizer
    from distdiff_tpu_torch.ops import flash
    from distdiff_tpu_torch.ops import groupnorm as gn
    from distdiff_tpu_torch.parallel import ExpansionDriver, build_manifest, read_png
    from distdiff_tpu_torch.parallel.driver import unit_seed
    from distdiff_tpu_torch.prototypes import (
        build_prototypes,
        extract_features,
        normalize_prototypes,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    cfg = pipe.config
    classes = [f"class{i:03d}" for i in range(FRONT_CLASSES)]
    labels = [7, 42][:FRONT_ITEMS]
    paths = [f"images/{classes[lab]}/img{i:04d}.jpg" for i, lab in enumerate(labels)]
    flash.reset_launch_counts()
    gn.reset_launch_counts()
    t0 = time.time()
    tok = HashTokenizer(cfg.text_encoder.vocab_size, cfg.text_encoder.max_length)
    cond = pipe.encode_text(torch.as_tensor(
        tok([f"a photo of a {classes[lab]}" for lab in labels]), device=dev).long())
    uncond = pipe.encode_text(torch.as_tensor(tok([""] * FRONT_ITEMS), device=dev).long())
    size = cfg.sample_size
    pixels = torch.rand(FRONT_ITEMS, size, size, 3, generator=gen, device=dev) * 2 - 1
    latents = pipe.encode_images(pixels)
    require(tuple(cond.shape) == (FRONT_ITEMS, 77, 768) and bool(torch.isfinite(cond).all()),
            f"text context {tuple(cond.shape)} is not a finite [{FRONT_ITEMS}, 77, 768]")
    require(tuple(latents.shape) == (FRONT_ITEMS, size // 8, size // 8, 4)
            and bool(torch.isfinite(latents).all()), "latents are not finite [B, 64, 64, 4]")
    gsize = pipe.guidance_cfg.guide_input_size
    n_proto = FRONT_CLASSES * FRONT_PROTO_IMAGES
    proto_labels = np.repeat(np.arange(FRONT_CLASSES), FRONT_PROTO_IMAGES)
    batches = [(torch.rand(50, gsize, gsize, 3, generator=gen, device=dev),
                proto_labels[i:i + 50]) for i in range(0, n_proto, 50)]
    feats, flabels = extract_features(pipe.guide.encode_image, batches, device=dev)
    gp, lp = normalize_prototypes(*build_prototypes(feats, flabels, FRONT_CLASSES,
                                                    k=pipe.guidance_cfg.K))
    pipe.global_protos = torch.as_tensor(gp, device=dev)
    pipe.local_protos = torch.as_tensor(lp, device=dev)
    front_s = time.time() - t0
    print(f"  text encoder, encode_images and prototypes ({n_proto} guide images, "
          f"{FRONT_CLASSES} classes, K={pipe.guidance_cfg.K}): {front_s:.2f} s; "
          f"prototypes {gp.shape} {lp.shape}")

    items = [types.SimpleNamespace(latent=latents[i], cond=cond[i], uncond=uncond[i],
                                   target=labels[i]) for i in range(FRONT_ITEMS)]
    sd = SmokeDataset(paths, labels, classes, items)
    split = pipe.make_split_expand(guide_chunk=1)
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=root, prefix=".smoke_png_") as out:
        driver = ExpansionDriver(split, sd, out, batch_size=BATCH, seed=0, device=dev)
        try:
            stats = driver.run(num_images_per_prompt=FRONT_PER_PROMPT)
        finally:
            driver.close()
        torch.cuda.synchronize()
        counts = dict(flash.launch_counts, **gn.launch_counts)
        by_shape = collections.Counter(flash.launch_shapes) + collections.Counter(gn.launch_shapes)
        layouts = dict(gn.layout_counts)
        units = build_manifest(paths, [classes[lab] for lab in labels], out,
                               FRONT_PER_PROMPT, skip_existing=False)
        pngs = {u.out_path: read_png(u.out_path) for u in units}
        print(f"  driver: {stats}")
        require(stats["written"] == len(units) == FRONT_ITEMS * FRONT_PER_PROMPT,
                f"{stats['written']} PNGs for {len(units)} work units")
        for path, png in pngs.items():
            require(png.shape == (size, size, 3) and png.dtype == np.uint8,
                    f"{path}: {png.shape} {png.dtype}")
            require(png.max() > png.min(), f"{path} is one flat colour")
        # each unit's image against a batch-1 run of the same unit, and,
        # as the contrast a wrong draw would give, against a batch-1 run of
        # the first unit's image with another unit's seed
        def alone(u, seed_unit):
            it = items[u.dataset_index]
            img = split(it.latent[None], it.cond[None], it.uncond[None],
                        torch.tensor([it.target], device=dev),
                        [torch.Generator(device=dev).manual_seed(unit_seed(0, seed_unit))])
            return np.clip(img[0].float().cpu().numpy() * 255.0 + 0.5, 0, 255).astype(np.uint8)

        def diff(a, b):
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            return int(d.max()), float(d.mean())

        diffs = [diff(pngs[u.out_path], alone(u, u)) for u in units]
        contrast = diff(pngs[units[0].out_path], alone(units[0], units[1]))
    # bf16 throughout: in a batch of 2 the UNet's and VAE's convolutions and
    # matmuls may take other cuDNN/cuBLAS kernels than at batch 1, so the
    # roundings differ and carry through 25 steps and the guidance; the
    # draws and the guidance sub-batches are per unit in both. That drift
    # stays within a mean of 4/255 and a largest pixel of 96/255, and below
    # a third of the mean difference that another unit's draws make.
    worst = max(d[0] for d in diffs)
    mean = max(d[1] for d in diffs)
    print(f"  units against their batch-1 runs: max |diff| {[d[0] for d in diffs]}/255, "
          f"mean {[round(d[1], 3) for d in diffs]}/255 (tol max 96, mean 4); with another "
          f"unit's draws: max {contrast[0]}/255, mean {contrast[1]:.3f}/255")
    require(worst <= 96 and mean <= 4.0 and mean < contrast[1] / 3,
            "a unit's image differs from its batch-1 run")
    require(all(c > 0 for c in counts.values()), f"a kernel was not launched: {counts}")
    print(f"  launches over the front-end run: {counts}; norm layouts {layouts}")
    return {"counts": counts, "by_shape": by_shape, "split": split, "items": items,
            "stats": stats, "front_s": front_s, "unit_diffs": diffs, "contrast": contrast}


def split_call_phase(pipe, split, items) -> dict:
    """One counted SplitExpand call at batch 2 (guide_chunk=1): each kernel's
    launches by shape against the plan; then three timed warm calls (median)
    and the peak memory."""
    import torch

    from distdiff_tpu_torch.ops import flash
    from distdiff_tpu_torch.ops import groupnorm as gn

    dev = torch.device("cuda")
    lat = torch.stack([it.latent for it in items])
    cond = torch.stack([it.cond for it in items])
    uncond = torch.stack([it.uncond for it in items])
    targets = torch.tensor([it.target for it in items], device=dev)

    def call(seed):
        gens = [torch.Generator(device=dev).manual_seed(seed + i) for i in range(len(items))]
        img = split(lat, cond, uncond, targets, gens)
        torch.cuda.synchronize()
        return img

    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_counts()
    gn.reset_launch_counts()
    img = call(100)
    peak = torch.cuda.max_memory_allocated()
    require(bool(torch.isfinite(img).all()), "non-finite images from SplitExpand")
    fcounts = dict(flash.launch_counts)
    gshapes = dict(gn.launch_shapes)
    want_f = expected_launches(pipe, units=len(items))
    want_g = gn_plan(expand_gn_calls(pipe, len(items), guide_chunk=1),
                     smem_limit=gn._device_limits(dev)[0])
    for name in flash.launch_counts:
        print(f"  {name}: {fcounts[name]} (plan: {want_f[name]})")
        require(fcounts[name] == want_f[name],
                f"{name}: {fcounts[name]} launches, the plan says {want_f[name]}")
    check_gn_plan(gshapes, want_g)
    print(f"  norm layouts {dict(gn.layout_counts)}")
    runs = []
    for seed in (200, 300, 400):
        t0 = time.time()
        call(seed)
        runs.append(time.time() - t0)
    warm = statistics.median(runs)
    print(f"  SplitExpand batch {len(items)} (guide_chunk=1): warm {warm:.3f} s/batch (median "
          f"of {[round(r, 3) for r in runs]}), peak memory {peak / 2**30:.2f} GiB")
    return {"warm_s": warm, "runs": runs, "peak_bytes": peak}


def check_gn_plan(got: dict, want) -> None:
    """Every GroupNorm kernel's launches by shape against the plan."""
    totals = {k: [0, 0] for k in GN_KERNELS}
    for key in set(got) | set(want):
        g, w = got.get(key, 0), want.get(key, 0)
        totals[key[0]][0] += g
        totals[key[0]][1] += w
        require(g == w, f"{key[0]} {list(key[1])}: {g} launches, the plan says {w}")
    for name, (g, w) in totals.items():
        print(f"  {name}: {g} (plan: {w}, over {len([k for k in want if k[0] == name])} shapes)")
        require(g > 0, f"{name} never launched on the main path")


def summarize(records, by_shape) -> list:
    """One JSON entry per kernel. ``launches`` is its count in the counted
    main-path runs (every shape); ms, plain_ms, bound_ms and library_ms are
    the means, over the launches at the timed shapes, of each shape's own
    numbers (so ``launches * ms`` is about the kernel's time in those runs);
    max_abs_err is the largest over the shapes. ``shapes`` keeps every
    timed shape's record, those with no launch on the main path included."""
    entries = []
    for name in REPLACES:
        recs = [dict(r, launches=by_shape.get((name, tuple(r["shape"])), 0))
                for r in records if r["name"] == name]
        total = sum(c for (n, _), c in by_shape.items() if n == name)
        require(total > 0, f"{name} never launched on the main path")
        timed = sum(r["launches"] for r in recs)
        require(timed > 0, f"{name}: no timed shape was launched on the main path")

        def mean(key, recs=recs, timed=timed):
            return sum(r[key] * r["launches"] for r in recs) / timed

        top = max(recs, key=lambda r: r["bound_ms"] * r["launches"])
        entries.append({
            "name": name, "route": "cuda",
            "source": SOURCES[name], "replaces": REPLACES[name], "launches": total,
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"), "bound_by": top["bound_by"],
            "library_ms": mean("library_ms"),
            "shapes": [{k: r[k] for k in ("cell", "shape", "launches", "max_abs_err", "ms",
                                          "plain_ms", "bound_ms", "bound_by", "library_ms")}
                       for r in recs],
        })
    return entries


def build_path():
    """The main path at full SD-1.5 geometry on the card: the pipeline
    (seeded random weights, bf16 UNet/VAE, fp32 ResNet-50 guide with 100
    classes and random prototypes), its expand function and its inputs."""
    import torch

    from distdiff_tpu_torch.config import GuidanceConfig, PipelineConfig
    from distdiff_tpu_torch.models.guide import create_model
    from distdiff_tpu_torch.sampling import ExpansionPipeline, SamplerConfig, cast_params_bf16
    from distdiff_tpu_torch.sampling.pipeline import init_weights

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    guide = create_model("resnet50", num_classes=100, device=dev)
    init_weights(guide.module, gen)
    gcfg = GuidanceConfig()  # reference recipe: step 20 of 50 from the end, period 2, rho 10, l-inf 0.2
    fd = guide.feature_dim
    gp = torch.randn(100, fd, generator=gen, device=dev)
    lp = torch.randn(100, gcfg.K, fd, generator=gen, device=dev)
    pipe = ExpansionPipeline.create(
        PipelineConfig.sd15(), sampler_cfg=SamplerConfig(guidance_scale=7.5),
        guidance_cfg=gcfg, guide=guide, global_protos=gp, local_protos=lp,
        strength=0.5, seed=0, device=dev)
    cast_params_bf16(pipe)
    print(f"  UNet {sum(p.numel() for p in pipe.unet.parameters()) / 1e6:.1f}M params, VAE "
          f"{sum(p.numel() for p in pipe.vae.parameters()) / 1e6:.1f}M, guide "
          f"{sum(p.numel() for p in guide.module.parameters()) / 1e6:.1f}M")
    ls = pipe.config.latent_size
    lat = torch.randn(BATCH, ls, ls, 4, generator=gen, device=dev) * 0.18
    cond = torch.randn(BATCH, 77, 768, generator=gen, device=dev)
    uncond = torch.randn(BATCH, 77, 768, generator=gen, device=dev)
    targets = torch.randint(0, 100, (BATCH,), generator=gen, device=dev)
    return pipe, pipe.make_expand_fn(), (lat, cond, uncond, targets)


# kernel-name fragments -> the layer that launched them (first match wins)
CATEGORIES = [
    ("flash kernels (port)", ("flash::", "flash32::")),
    ("groupnorm kernels (port)", ("gn::",)),
    ("convolution (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd")),
    ("matmul (cuBLAS)", ("gemm", "nvjet", "cutlass", "gemv", "splitk")),
    ("reduction (norm statistics, softmax)", ("reduce", "softmax", "norm", "bn_fw")),
    ("elementwise and copies", ("elementwise", "vectorized", "unrolled", "copy", "cat",
                                "index", "fill", "memset", "memcpy", "upsample",
                                "interpolate", "pool", "tonchw", "tonhwc")),
]


def profile_path(expand, inputs, json_path=None) -> None:
    """torch.profiler over one warm expand call: device time by layer and by
    kernel, and the device's idle share of the call's wall time; with
    ``json_path``, also the per-kernel table as JSON there."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    expand(*inputs, torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        expand(*inputs, torch.Generator(device="cuda").manual_seed(2))
        torch.cuda.synchronize()
        wall_s = time.time() - t0
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            rec = kernels.setdefault(ev.name, [0, 0.0])
            rec[0] += 1
            rec[1] += ev.time_range.elapsed_us() / 1e3
    busy_ms = sum(ms for _, ms in kernels.values())
    n_launches = sum(n for n, _ in kernels.values())
    by_cat = {}
    for name, (n, ms) in kernels.items():
        low = name.lower()
        cat = next((c for c, keys in CATEGORIES if any(k in low for k in keys)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
    print(f"  one warm expand call under the profiler: wall {wall_s * 1e3:.1f} ms, device "
          f"busy {busy_ms:.1f} ms, idle share {1 - busy_ms / (wall_s * 1e3):.3f}, "
          f"{n_launches} device kernels")
    for cat, ms in sorted(by_cat.items(), key=lambda kv: -kv[1]):
        print(f"  {cat}: {ms:.1f} ms ({ms / busy_ms:.3f} of device time)")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:25]
    for name, (n, ms) in top:
        print(f"  {ms:9.2f} ms {n:6d}x  {name[:110]}")
    if json_path is None:
        return
    os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
    with open(json_path, "w") as f:
        json.dump({"card": card_line(), "wall_ms": wall_s * 1e3, "device_busy_ms": busy_ms,
                   "device_kernels": n_launches,
                   "by_category_ms": by_cat,
                   "kernels": {k: {"launches": n, "ms": ms} for k, (n, ms) in kernels.items()}},
                  f, indent=1)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from distdiff_tpu_torch.ops import _build, flash
        from distdiff_tpu_torch.ops import groupnorm as gn
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2

    card = card_line()
    print("== 1. device")
    print(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    t0 = time.time()
    _build.kernel("flash_fwd")
    print(f"  kernel build {time.time() - t0:.1f} s ({_build.build_info})")
    ptxas_phase()

    if "--profile" in argv:
        print("== profile of the main path")
        _, expand, inputs = build_path()
        json_path = argv[argv.index("--json") + 1] if "--json" in argv else None
        profile_path(expand, inputs, json_path)
        return 0

    print("== 2. kernels")
    records = kernel_phase()
    print("  -- fp32 flash")
    fp32_records = flash_f32_phase()
    print("  -- GroupNorm")
    records += gn_kernel_phase(gn_shapes(main_gn_calls()))

    print("== 3. agreement at a small geometry")
    agreement_phase()
    print("  -- fp32 on the card against the CPU")
    fp32_agreement_phase()

    print("== 4. path")
    pipe, expand, inputs = build_path()
    dev = torch.device("cuda")
    t0 = time.time()
    expand(*inputs, torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    cold_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_counts()
    gn.reset_launch_counts()
    t0 = time.time()
    img, aux = expand(*inputs, torch.Generator(device=dev).manual_seed(2), return_aux=True)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    counts = dict(flash.launch_counts)
    by_shape = collections.Counter(flash.launch_shapes) + collections.Counter(gn.launch_shapes)
    gn_shapes_run = dict(gn.launch_shapes)
    layouts = dict(gn.layout_counts)
    peak = torch.cuda.max_memory_allocated()
    warm_runs = [warm_s]
    for seed in (3, 4):  # the host clock spreads between calls: two more
        t0 = time.time()
        expand(*inputs, torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        warm_runs.append(time.time() - t0)
    warm_s = statistics.median(warm_runs)
    print(f"  expand batch {BATCH}: first call {cold_s:.2f} s, warm {warm_s:.3f} s/batch "
          f"(median of {[round(w, 3) for w in warm_runs]}), peak memory "
          f"{peak / 2**30:.2f} GiB")
    require(tuple(img.shape) == (BATCH, 512, 512, 3), f"image shape {tuple(img.shape)}")
    require(bool(torch.isfinite(img).all()), "non-finite image")
    require(float(img.min()) >= 0.0 and float(img.max()) <= 1.0, "image outside [0, 1]")
    gg, gb = aux["grad_gamma"], aux["grad_beta"]
    for name, g in (("gamma", gg), ("beta", gb)):
        require(bool(torch.isfinite(g).all()), f"non-finite gradient on {name}")
        require(float(g.abs().max()) > 0.0, f"zero gradient on {name}")
    moved = float((aux["latents_after"] - aux["latents_before"]).abs().max())
    require(moved > 0.0, "guidance left the latents unchanged")
    print(f"  images {tuple(img.shape)} in [{float(img.min()):.3f}, {float(img.max()):.3f}]; "
          f"|grad gamma| max {float(gg.abs().max()):.3e}, |grad beta| max "
          f"{float(gb.abs().max()):.3e}; latents moved up to {moved:.4f}; "
          f"score {aux['score'].tolist()}")

    print("  launch counts of the counted call:")
    want = expected_launches(pipe)
    for name in flash.launch_counts:
        print(f"  {name}: {counts[name]} (plan: {want[name]})")
        require(counts[name] == want[name],
                f"{name}: {counts[name]} launches, the plan says {want[name]}")
        require(counts[name] > 0, f"{name} never launched on the main path")
    for (name, shape), c in sorted(by_shape.items()):
        if name in flash.launch_counts:
            print(f"  {name} {list(shape)}: {c}")
    check_gn_plan(gn_shapes_run, gn_plan(expand_gn_calls(pipe, BATCH),
                                         smem_limit=gn._device_limits(dev)[0]))
    print(f"  norms by memory format: {layouts}")

    print("== 5. front-end path (generate_data): text, encode, prototypes, driver")
    front = frontend_phase(pipe)
    split = split_call_phase(pipe, front["split"], front["items"])

    print("== 6. result")
    print(card)
    print(json.dumps({
        "kernels": summarize(records, by_shape + front["by_shape"]),
        "fp32_flash": fp32_records, "expand_warm_s": warm_s,
        "expand_warm_s_runs": warm_runs, "expand_peak_bytes": peak,
        "split_expand_warm_s": split["warm_s"], "split_expand_warm_s_runs": split["runs"],
        "split_expand_peak_bytes": split["peak_bytes"], "driver": front["stats"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
