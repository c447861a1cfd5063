#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card, ``nvcc`` and ``nvidia-smi``; it imports nothing of JAX or of the JAX
package. Five phases, any failure exits non-zero:

1. Device: the card's name and power limit, torch/CUDA versions, and the
   time to build the CUDA kernels from ``distdiff_tpu_torch/csrc``.
2. Kernels: every flash kernel at the main path's shapes, in bf16, held
   against its plain PyTorch version (fp32, same bf16 inputs); median times
   over CUDA events for the kernel, the plain version and
   ``F.scaled_dot_product_attention`` (a yardstick the port never calls),
   beside the least time the card could take (``bound_ms``).
3. Agreement: the guided expansion at a small geometry whose attention
   reaches every kernel (576 tokens; UNet heads of 16, a VAE mid-block of
   160), in bf16 through the kernels, in bf16 through the plain attention
   and in fp32 through the plain attention, on the same weights and draws:
   the kernels' run stays as close to the fp32 run as the plain bf16 run.
4. Path: the guided expansion at full SD-1.5 geometry (UNet 860M, VAE,
   ResNet-50 guide with 100 classes, seeded random weights) at batch 2:
   DDIM-50, strength 0.5, CFG 7.5, transform guidance at plan index 30 over
   2 steps. One warm-up call, then one counted and timed call (each
   kernel's launches in it, by shape, against the counts the step plan
   implies) and two more timed calls.
5. The card line, the kernels' JSON line (one entry per kernel; its times
   are the means over that kernel's launches on the main path, and
   ``shapes`` holds each main-path shape's own numbers), and the
   ``{"ok": true, ...}`` line.

``python3 chip_smoke.py --profile [--json PATH]`` runs phase 1, builds the
main path and traces one warm expand call with ``torch.profiler`` instead:
device time by layer and by kernel, and the device's idle share (and the
per-kernel table as JSON at PATH).
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense); recomputed beside the card nvidia-smi names.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# exp throughput of the special-function units (the FlashAttention-3 paper's figure)
PEAK_EXP = 3.9e12

BATCH = 2
SOURCES = {"flash_fwd": "distdiff_tpu_torch/csrc/flash_fwd.cu"}
REPLACES = {
    "flash_fwd": "distdiff_tpu/ops/flash.py:131 _fwd_kernel_single, :157 _fwd_kernel",
    "flash_bwd_fused": "distdiff_tpu/ops/flash.py:348 _bwd_fused_kernel",
    "flash_bwd_dq": "distdiff_tpu/ops/flash.py:266 _dq_kernel",
    "flash_bwd_dkv": "distdiff_tpu/ops/flash.py:301 _dkv_kernel",
}
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


def time_ms(fn, iters: int) -> float:
    """Median of per-call CUDA-event times, after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(name, bh, tq, tk, d):
    """(bound_ms, bound_by): the larger of the bytes the function must move
    (inputs read once, outputs written once) over the memory rate and its
    operations (products on the bf16 tensor cores, exps on the
    special-function units) over their peak rates."""
    bf, f4 = 2, 4
    q, kv = bh * tq * d * bf, bh * tk * d * bf
    row = bh * tq * f4
    nbytes = {
        "flash_fwd": q + 2 * kv + q + row,                    # q,k,v -> o, lse
        "flash_bwd_fused": 2 * q + 2 * kv + 2 * row + q + 2 * kv,  # q,k,v,do,lse,delta -> dq,dk,dv
        "flash_bwd_dq": 2 * q + 2 * kv + 2 * row + q,
        "flash_bwd_dkv": 2 * q + 2 * kv + 2 * row + 2 * kv,
    }[name]
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(PRODUCTS[name] * 2.0 * bh * tq * tk * d / PEAK_BF16_FLOPS,
                bh * tq * tk / PEAK_EXP)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations")


def kernel_phase():
    """Hold every kernel against its plain version at the main-path shapes
    (timed), and at ragged shapes (checked only: q and kv lengths off the
    64-row tiles, the 77-token kv of cross-attention, head widths off the
    padded ones); returns one record per timed (kernel, shape)."""
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
    entries = []
    for label, b, h, tq, tk, d, names, timed in shapes:
        bh = b * h

        def rnd(*s):
            return torch.randn(*s, generator=gen, device=dev).to(torch.bfloat16)

        q, do, k, v = rnd(bh, tq, d), rnd(bh, tq, d), rnd(bh, tk, d), rnd(bh, tk, d)
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
                "source": SOURCES.get(name, "distdiff_tpu_torch/csrc/flash_bwd.cu"),
                "replaces": REPLACES[name],
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


def expected_launches(pipe) -> dict:
    """Kernel launches of one transform-guided expand call, from the plan:
    UNet forwards = plain steps + 2 x period (rollout and its recompute in
    the backward); VAE mid-block forwards = 2 x period + the final decode."""
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
    unet_fwd = (g0 - start) + 2 * period + (n - g0)
    vae_big_d = max(pipe.config.vae.block_out_channels) > 128
    return {
        "flash_fwd": unet_fwd * per_unet + (2 * period + 1) * vae_flash,
        "flash_bwd_fused": period * per_unet,
        "flash_bwd_dq": period * vae_flash * vae_big_d,
        "flash_bwd_dkv": period * vae_flash * vae_big_d,
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


def summarize(records, by_shape) -> list:
    """One JSON entry per kernel. ``launches`` is its count in the counted
    main-path call; ms, plain_ms, bound_ms and library_ms are the means over
    those launches of each shape's own numbers (so ``launches * ms`` is the
    kernel's time in one expand call); max_abs_err is the largest over the
    shapes. ``shapes`` keeps every shape's record, the D=40 cross-check of
    the split pair (no launches on the main path) included."""
    entries = []
    for name in REPLACES:
        recs = [dict(r, launches=by_shape.get((name, tuple(r["shape"])), 0))
                for r in records if r["name"] == name]
        total = sum(r["launches"] for r in recs)
        require(total > 0, f"{name} never launched on the main path")

        def mean(key, recs=recs, total=total):
            return sum(r[key] * r["launches"] for r in recs) / total

        top = max(recs, key=lambda r: r["bound_ms"] * r["launches"])
        entries.append({
            "name": name, "route": "cuda", "source": recs[0]["source"],
            "replaces": REPLACES[name], "launches": total,
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
    ("flash kernels (port)", ("flash::",)),
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
    by_cat = {}
    for name, (n, ms) in kernels.items():
        low = name.lower()
        cat = next((c for c, keys in CATEGORIES if any(k in low for k in keys)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
    print(f"  one warm expand call under the profiler: wall {wall_s * 1e3:.1f} ms, device "
          f"busy {busy_ms:.1f} ms, idle share {1 - busy_ms / (wall_s * 1e3):.3f}")
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
    for src, log in _build.build_logs().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    if "--profile" in argv:
        print("== profile of the main path")
        _, expand, inputs = build_path()
        json_path = argv[argv.index("--json") + 1] if "--json" in argv else None
        profile_path(expand, inputs, json_path)
        return 0

    print("== 2. kernels")
    records = kernel_phase()

    print("== 3. agreement at a small geometry")
    agreement_phase()

    print("== 4. path")
    pipe, expand, inputs = build_path()
    dev = torch.device("cuda")
    t0 = time.time()
    expand(*inputs, torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    cold_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_counts()
    t0 = time.time()
    img, aux = expand(*inputs, torch.Generator(device=dev).manual_seed(2), return_aux=True)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    counts = dict(flash.launch_counts)
    by_shape = dict(flash.launch_shapes)
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
        print(f"  {name} {list(shape)}: {c}")

    print("== 5. result")
    print(card)
    print(json.dumps({"kernels": summarize(records, by_shape), "expand_warm_s": warm_s,
                      "expand_warm_s_runs": warm_runs, "expand_peak_bytes": peak}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
