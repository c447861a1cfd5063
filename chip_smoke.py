#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card, ``nvcc`` and ``nvidia-smi``; it imports nothing of JAX or of the JAX
package. Fourteen phases, any failure exits non-zero:

1. Device: the card's name and power limit, torch/CUDA versions, the
   time to build the CUDA kernels from ``distdiff_tpu_torch/csrc`` (one
   ``nvcc`` a source, all at once), each kernel's registers and spills from
   ``-Xptxas -v`` (a Hopper flash or GroupNorm kernel that spills fails the
   run), the Hopper flash kernels' dynamic shared memory (the split
   backward pair's, the fp32 narrow and wide forwards', the fp32 fused
   backward's at each padded width and the fp32 split pair's held against
   their Python counts), and the GroupNorm
   kernels' plans with their shared memory, held against the C side's.
2. Kernels, each held against its plain PyTorch version on the same inputs:
   every flash kernel at the main path's shapes (SD-1.5's, phase 8's
   SD-2.1 ones: D = 64 over 9216, 2304 and 576 tokens, D = 512 over 9216,
   and phase 9's SDXL ones: D = 64 over 4096 and 1024 tokens, D = 512
   over 16384) in bf16 (against the plain
   fp32 version; timed beside ``F.scaled_dot_product_attention``, a
   yardstick the port never calls, whose kernels past D = 128 are
   printed) and at ragged shapes (the Hopper
   kernels also at every narrow head width and at wide ones from 129 to
   512, lengths one row on either side of their tiles, the 77-token kv,
   and views off 16-byte alignment, which take the staged loads; the split
   backward pair launched twice for the same bytes); the four
   flash
   kernels' fp32 instances at main-path widths and ragged shapes (timed at
   the former, the forward and the fused backward also at
   [32,1024,1024,80], and the forward and the split pair at D = 160; the
   forward and the fused backward also at narrow widths from 8 to 128 and
   the forward and the split pair at wide widths from 129 to 512, lengths
   one row on either side of their tiles, and views one element into their
   storage, each printed with its kernel and each launch twice for the
   same bytes, but for the fused backward's dq, held to the tolerance
   twice; the forward, the split pair and the fused backward also against
   fp64 at 16384 rows of sum); gn_fused, gn_stats and gn_apply at every GroupNorm shape of
   the counted runs, in bf16 and fp32, channels-last and contiguous, with
   and without SiLU, and at ragged shapes (timed in bf16 channels-last,
   beside ``F.group_norm`` + ``F.silu``; gn_fused also at its edges: B = 1,
   pixels one off its cluster's split, runs off 16 bytes, views off 16-byte
   alignment, each printed with its route and cluster, and every gn_fused
   result launched twice for the same bytes; the gn_stats + gn_apply pair
   at its shapes in all eight combinations of type, layout and SiLU and at
   its edges: B = 1, pixel rows off the band, vectors of 4, 2 and 1,
   column loops, many groups, each printed with its plan, the plan replayed
   by ``check_pair_plan``, every pair result launched twice for the same
   bytes, and the pair also timed as the main path runs it). Times are
   medians of CUDA events, each beside the least time the card could take
   (``bound_ms``).
3. Agreement: the guided expansion at a small geometry whose attention
   reaches every flash kernel, in bf16 through the kernels, in bf16 through
   the plain attention and in fp32 through the plain attention, on the same
   weights and draws: the kernels' run stays as close to the fp32 run as
   the plain bf16 run. Then the fp32 ``tiny()`` pipeline's guided expand on
   the card through every kernel (norms once by gn_fused, once by the
   gn_stats + gn_apply pair; then once with direct guidance) against the
   same port on the CPU, each fp32 forward's and fused backward's launches
   printed by shape with the kernel its width takes.
4. Path: the guided expansion at full SD-1.5 geometry (UNet 860M, VAE,
   ResNet-50 guide with 100 classes, seeded random weights) at batch 2:
   DDIM-50, strength 0.5, CFG 7.5, transform guidance at plan index 30 over
   2 steps. One warm-up call, then one counted and timed call (each
   kernel's launches in it, by shape, against the counts the step plan
   implies, and the norms' memory formats; gn_stats' and gn_apply's
   phase-2 times weighted by their launches in it) and two more timed
   calls.
5. Front end (the path of ``cli/generate_data.py``): prompts through the
   HashTokenizer and the CLIP-L text encoder, ``encode_images`` of 512^2
   images, prototypes from the guide's features over 400 seeded images of
   100 classes, then ``ExpansionDriver`` over
   ``make_split_expand(guide_chunk=1)`` for 4 work units, writing PNGs
   (their count, size and range, and each unit against its batch-1 run);
   one counted SplitExpand call against the plan, three timed ones.
6. The CLI: ``distdiff_tpu_torch.cli.generate_data.main`` on the published
   recipe (transform guidance, strength 0.5, K 3, rho 10, guidance step 20,
   period 2, l-inf 0.2, batch 2, 4 images) in a temporary directory, from
   files written first: an SD-1.5 fp16 diffusers-layout checkpoint with its
   CLIP tokenizer files (``weights/synth.py``, 2.1 GB), a ResNet-50
   ``.pth.tar`` guide of 100 classes and a caltech-101 tree of 400 PNGs
   (plus the two classes the loader drops; half of them with Paeth and
   Average rows, as adaptive encoders write photographs, half with filter
   0). Loaded tensors against the written ones, the CLIP tokenizer, the 4
   PNGs, the latent cache (300 entries) and the prototype cache ([100,
   2048], [100, 3, 2048]), every kernel launched; each stage's seconds,
   the driver's images/s, and the PNG decoder's ms an image for each kind
   of file. Then
   the fp32 tiny() expand with ``text_to_img``, and with ``offset_noise``
   through ``make_expand_fn`` and ``SplitExpand``, on the card against the
   CPU with the same draws, at phase 3's tolerance.
   Phases 4, 5 and 6 each fail if they launched a kernel at a shape that
   phase 2 did not hold against its plain version.
7. The classifier trainer (no kernel of the port runs here: the
   classifier is a BatchNorm ResNet). ``tiny_resnet`` training steps in
   fp32 on the card against the CPU, each card step from the CPU's state
   on the same batch (a padded tail; plain, ``accumulate=2``,
   ``train_fc`` (its running statistics move, its backbone's parameters
   must not), and ``cli.train_transform``'s mixup, cutmix and augmix
   steps): the loss, running statistics and each parameter's step
   held to their limits, accuracies exactly; then the plain case with TF32
   on, which must fail every limit. Then the train step
   alone at ResNet-50 width, batch 64, 224^2, timed with CUDA events on a
   batch already on the card. Then ``cli.train.main`` at the JAX defaults
   (ResNet-50, 224^2, batch 64, SGD lr 0.1 Nesterov, fp32) on a caltech-101
   PNG tree written first (100 classes, 3 train and 1 test image each, half
   with Paeth and Average rows) for one epoch, a resume for a second, and
   ``cli.train_expanded.main`` with a tree of 100 512^2 PNGs in
   ``ExpansionDriver``'s layout for one epoch: ``log.txt``,
   ``results.yaml`` and both ``.pth.tar`` files checked (the trainer
   writes ``model_best.pth.tar`` only in an epoch above 0%), the best
   checkpoint loaded as a guide against the module it saved,
   ``parse_logs`` on the run; the steps' device times there, images/s
   (an epoch's images over its wall time), each epoch's seconds and its
   share waiting on the loader, and the peak
   device memory, each beside the card's name and power limit. Then
   ``cli.train_transform.main`` at the same defaults on a tree cut to 1
   train image a class, cut to one epoch at ``--expand_num 0`` (the
   original-only control, 100 images) under each of the 8
   ``--transform_type`` values, and ``default`` at ``--expand_num 1`` over
   a tree of one 512^2 ``_expand_0`` PNG an original (200 items): each
   run's artifacts checked and its steps counted, its images/s, loader
   share and epoch seconds printed.
8. SD-2.1 768-v, DPM-Solver++(2M), DeepCache and the rollout_remat modes,
   after phases 4-6's pipelines are freed. SD-2.1 at full width (UNet
   865.9M, heads 64 wide, linear projections, v-prediction; seeded random
   weights) at batch 2, 768^2, the phase-4 recipe: a warm-up call, a
   counted call (each flash kernel's launches by shape and each GroupNorm
   kernel's by shape against the plan, peak memory) and one more timed.
   Then ``cli.generate_data.main --model sd21 --scheduler dpmpp
   --resolution 768`` from an SD-2.1 fp16 checkpoint (2.6 GB), a ResNet-50
   guide and a caltech-101 tree written first, cut to 1 train image a
   class (100 latents) and 2 images: the loaded weights, the PNGs, the
   caches and the launches by shape against the plan. Then SD-1.5 at batch 2 under
   ``dpmpp`` and under ``deep_cache`` (interval 3, branch 0), each through
   ``make_expand_fn`` and ``SplitExpand``, timed and counted against the
   plan; the guidance update under each of the eight ``rollout_remat``
   modes (its launches against the mode's plan, time, peak memory, and its
   latents, gradients and scores against "step_nr"'s at a stated bf16
   tolerance); and the fp32 ``tiny()`` expand on the card against the CPU
   under ``dpmpp``, ``deep_cache``, SD-2.1's shape (its gelu text tower
   too) and each mode, at phase 3's tolerance. Each counted run fails on a
   launched shape phase 2 did not hold.
9. SDXL-base at full width (UNet 2,567.5M with the additive
   conditioning, the OpenCLIP-bigG and CLIP-L towers, the SDXL VAE;
   seeded random weights), batch 2, 1024^2, the phase-4 recipe, its
   conditioning from both towers on the card: a first call, a counted call
   (launches by shape against the plan, peak memory) and one more timed;
   then ``SDXLPipeline`` text-to-image (DDIM-50) on the same modules,
   counted and timed; then ``cli.generate_data.main --model sdxl
   --resolution 1024`` from an SDXL fp16 checkpoint (6.9 GB, all four
   components' loaded tensors against the written ones), a ResNet-50
   guide and a caltech-101 tree cut to 1 train image a class and 2
   images; then the fp32 ``sdxl_tiny`` guided expand, ``encode_text_pair``
   and ``SDXLPipeline`` img2img on the card against the CPU. Each counted
   run fails on a launched shape phase 2 did not hold.
10. LoRA fine-tuning of the diffusion UNet (``train/lora.py``). The fp32
   LoRA step (the denoising loss and its backward to the adapter, the
   UNet's inner checkpoints on) on the card against the CPU with the same
   weights, adapter and draws, at phase 3's tolerance (the loss, the
   adapter gradients, one AdamW update), for the tiny() UNet, in SD-2.1's
   shape under v-prediction and for sdxl_tiny (24^2 and 48^2 latents,
   whose 576-token level takes the fp32 flash kernels); the adapter
   gradients at SD-1.5 width, batch 2, through the kernels against the
   plain attention in bf16 (phase 3's rule) and in fp32 (phase 3's fp32
   tolerance); the step at
   ``cli.train_lora``'s defaults (SD-1.5 stored in bf16, batch 8 at
   512^2 without CFG, rank 8, AdamW lr 1e-4): a counted step (launches by
   shape against the plan: flash_fwd 10 and flash_bwd_fused 5 at each of
   [64,4096,40] and [64,1024,80], the norms by gn_plan, peak memory) and
   10 steps timed by CUDA events; then ``cli.train_lora.main`` from
   phase 6's SD-1.5 checkpoint and its writers' other files (the
   caltech-101 tree cut to 1 train image a class), cut to 20 steps with an adapter every 10 (both files' keys,
   shapes and alpha, the launches, each stage's seconds, steps/s), and
   ``cli.generate_data.main --lora`` on that adapter through the published
   recipe cut to 2 images (every adapted UNet leaf equals the merge of
   the written weight bit for bit, every other leaf the written weight,
   and an adapter with b = 0 leaves the bytes as they were). Each counted
   run fails on a launched shape phase 2 did not hold.
11. The guide zoo (no kernel of its own: the ViT's 50 tokens take the
   plain attention, the CNNs cuDNN). ResNeXt-50 (32x4d), Wide ResNet-50-2,
   MobileNetV2 and the OpenCLIP ViT-B/32 image tower at full width, fp32,
   100 classes, seeded weights: ``encode_image`` and the input gradient of
   the per-sample hierarchical energy (batch 2, 224^2) on the card against
   the same guide on the CPU with TF32 off (features within ZOO_FEAT_TOL of
   their largest, the gradient ZOO_CNN_GRAD_TOL in l2, the ViT's, smooth,
   ZOO_GRAD_TOL), then with TF32 on, a control that must exceed both;
   then each guide as the guide of the phase-4 recipe in one SD-1.5
   pipeline: a first call, a counted call (flash and GroupNorm launches by
   shape against phase 4's plan, peak memory) and one more timed, the warm
   call against phase 4's. Then ``cli.generate_data.main`` with the
   default ``-a open_clip_vit_b32`` from phase 6's synth SD-1.5
   checkpoint and files it writes: a full-layout
   OpenCLIP ViT-B/32 ``.safetensors`` (151,277,313 values), a minimal
   merges file as ``--bpe_path`` and a caltech-101 tree cut to 1 train
   image a class, 2 images: the image tower's loaded tensors, the zero-shot
   head ([100, 512], finite), the PNGs, the caches, the launches against
   the plan. Then ``cli.train -a mobilenetv2 --train_fc`` on phase 7's
   tree for one epoch: the backbone unchanged, the BatchNorm statistics
   and ``classifier.*`` moved. Then the whole script's seconds.
12. int8 and the parameter files (no kernel of the port of its own: the
   int8 products are ``torch._int_mm``), run inside phase 4's and phase
   9's live pipelines and on phase 6's files, printed as 12a-e where they
   run. 12e (in phase 6): its CLI run adds ``--save_params``; a second
   ``generate_data.main`` on the same tree passes ``--params_path`` and
   no ``--sd_checkpoint``, for 2 images: its loaded tensors and its PNGs
   (byte for byte) equal the first run's. 12a (after phase 6): ``qconv``
   and ``qdot`` at every int8 layer shape of one SD-1.5 batch-2 call, the
   card's quantization against the CPU's and the int32 accumulator and the
   output against the plain version (float64 products) on the card, bit
   for bit, each timed beside the bf16 layer and its bound. 12b: SD-1.5
   ``--int8`` on phase 4's pipeline (a warm-up, a counted call: flash and
   GroupNorm launches by shape against phase 4's plan, int8 products
   against theirs, peak memory; a timed call), then ``--int8
   --deep_cache`` through SplitExpand, counted; the int8 images' mean
   distance in 8-bit levels from phase 4's exact ones on the same draws.
   12d: the fp32 tiny() int8 guided expand on the card, each int8 layer
   call against the CPU's layer on its input (bit for bit), the CPU's
   expand with each int8 layer given the card's input against the card
   (phase 3's tolerance, at least 10x below the card's int8-versus-exact
   gap; the quantizer is discontinuous), and one guidance update under
   ``config.int8`` equal to the exact one bit for bit. 12c (in phase 9):
   one SDXL ``--int8`` call at 1024^2 on phase 9's pipeline, launches
   against phase 9's plan, time and peak memory.
14. The parallel modules on virtual meshes of cuda:0 (a device may repeat
   in a mesh: one card, one copy of each weight). 14g (in phase 6):
   ``cli.generate_data.main --mesh_model 2`` on phase 6's tree, caches,
   checkpoint and guide, ``parallel.mesh.local_devices`` giving cuda:0
   twice: every UNet transformer block tensor-parallel over the 1 x 2
   mesh (its attention calls counted by group size), every kernel launched
   (counted by shape, each shape held in phase 2), the PNGs against phase
   6's on the same draws (within PARAMS_LEVELS_TOL, mean), the expand
   calls timed and the peak memory beside phase 4's. Then (after 12d) 14a: ``flash_attention_lse`` against
   its plain version, o, lse and the gradients under a nonzero lse
   cotangent, at SD-1.5's self-attention shapes cut in two along the
   tokens and at D = 512, timed beside phase 2's ``flash_fwd`` there; 14b:
   ``sp_attention`` on a 2-way seq mesh against the unsharded
   ``flash_attention`` at [2, 4096, 8, 40], output and gradients (these
   at twice phase 2's tolerance: the ring sums two bf16 partials); 14c/d:
   on phase 4's SD-1.5 UNet, a 2-stage ``PipelinedUNet`` against the whole
   call and microbatched against the whole call on each microbatch (both
   bit for bit), then the UNet turned into its tensor-parallel form (no
   device memory added) against the unsharded call, within TP_SPREAD
   times the unsharded call's own bf16 spread (the whole batch against
   its two halves), each timed; 14e: the fp32 tiny() guided SplitExpand under tensor
   parallelism on the card against the CPU; 14f: ``tiny_resnet`` steps on a
   2-way data mesh, data-parallel and FSDP, against the one-device CPU
   step at phase 7's limits.
13. The card line, the kernels' JSON line (one entry per kernel; its times
   are the means over that kernel's launches in the counted runs, and
   ``shapes`` holds each timed shape's own numbers), and the
   ``{"ok": true, ...}`` line.

``python3 chip_smoke.py --profile [--sd21 | --sdxl | --lora] [--json PATH]``
runs phase 1, builds the main path (with ``--sd21`` phase 8's SD-2.1
768-v path, with ``--sdxl`` phase 9's SDXL-base path, with ``--lora``
phase 10's LoRA step) and traces one warm expand call (or step) with
``torch.profiler`` instead: device time by layer and by kernel, and the
device's idle share (and the per-kernel table as JSON at PATH).
"""

from __future__ import annotations

import collections
import gc
import json
import logging
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

# H100 SXM data-sheet peaks (dense); recomputed beside the card nvidia-smi names.
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12  # tensor cores; an fp32-accurate product takes three (3xTF32)
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


def device_kernels(fn) -> list:
    """The names of the device kernels one call of ``fn`` launches (what
    the library call resolved to), by ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({ev.name[:80] for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA})


def bound(name, bh, tq, tk, d, itemsize=2):
    """(bound_ms, bound_by): the larger of the bytes the function must move
    (inputs read once, outputs written once) over the memory rate and its
    operations (exps on the special-function units; products on the bf16
    tensor cores, or for fp32 inputs as three TF32 products each, 3xTF32,
    the least work that keeps fp32's accuracy on the tensor cores) over
    their peak rates. On the fp32 CUDA cores (67 TFLOP/s) the same products
    would take 495 / 67 / 3 = 2.46 times as long: 1.0257 ms instead of
    0.4165 at [2,4096,4096,512] in the forward."""
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
    flops = PRODUCTS[name] * 2.0 * bh * tq * tk * d
    t_products = flops / PEAK_BF16_FLOPS if itemsize == 2 else 3 * flops / PEAK_TF32_FLOPS
    t_ops = max(t_products, bh * tq * tk / PEAK_EXP)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations")


# the kernels built for Hopper (the bf16 flash kernels: warp-specialised,
# TMA and wgmma; the fp32 forward at every width, the fp32 fused backward
# and the fp32 split pair past D = 128: 3xTF32 on mma.sync, TMA; gn_fused:
# clusters, TMA; the gn_stats and gn_apply pair: banded one-wave grids):
# none may spill
HOPPER_KERNELS = ("flash_fwd_narrow_kernel", "flash_fwd_wide_kernel", "flash_bwd_fused_kernel",
                  "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel", "flash_fwd_f32_narrow_kernel",
                  "flash_fwd_f32_wide_kernel", "flash_bwd_fused_f32_kernel",
                  "flash_bwd_f32_split_kernel", "gn_fused_kernel", "gn_stats_nhwc_kernel",
                  "gn_stats_nchw_kernel", "gn_apply_nhwc_kernel", "gn_apply_nchw_kernel")
WIDE_DMAX = (256, 512)  # the wide forward's instances


def ptxas_phase() -> None:
    """Each kernel's registers and spills from ``-Xptxas -v``, and the
    Hopper flash kernels' dynamic shared memory; a Hopper kernel that
    spills fails the run."""
    from distdiff_tpu_torch.ops import _build, flash

    spilled, narrow_regs, f32_regs, split_regs, fused_regs = [], {}, {}, {}, {}
    for src, log in _build.build_logs().items():
        for name, regs, stack, st, ld in _build.ptxas_report(log):
            print(f"  {src}: {name}: {regs} registers, {stack} B stack, spills {st} B stored / "
                  f"{ld} B loaded")
            if name.split("<")[0] in HOPPER_KERNELS and (st or ld):
                spilled.append(name)
            if name.startswith("flash_fwd_f32_narrow_kernel"):
                narrow_regs[name] = regs
            if name.startswith("flash_fwd_f32_wide_kernel"):
                f32_regs[name] = regs
            if name.startswith("flash_bwd_f32_split_kernel"):
                split_regs[name] = regs
            if name.startswith("flash_bwd_fused_f32_kernel"):
                fused_regs[name] = (regs, st, ld)
    smem = {dp: (_build.kernel("flash_fwd_smem")(dp),
                 _build.kernel("flash_bwd_fused_smem")(dp)) for dp in flash.NARROW_WIDTHS}
    print("  narrow kernels' dynamic shared memory (forward, fused backward) by padded "
          f"width: {smem}")
    wide = {dmax: _build.kernel("flash_fwd_smem")(dmax) for dmax in WIDE_DMAX}
    print(f"  wide forward's dynamic shared memory by DMAX: {wide}")
    split = {dmax: _build.kernel("flash_bwd_split_smem")(dmax) for dmax in flash.SPLIT_DMAX}
    print(f"  split backward pair's dynamic shared memory by DMAX: {split}")
    for dmax, got in split.items():
        want = flash.split_smem_bytes(dmax)
        require(got == want and got <= H100_SMEM_OPTIN,
                f"split backward's shared memory at DMAX {dmax}: C {got}, Python {want}")
    f32_narrow = {dmax: _build.kernel("flash_fwd_f32_smem")(dmax)
                  for dmax in flash.F32_NARROW_DMAX}
    print(f"  fp32 narrow forward (3xTF32 tensor cores): registers {narrow_regs} (<DMAX,TMA "
          f"loads>), dynamic shared memory by DMAX {f32_narrow}")
    require(len(narrow_regs) == 2 * len(flash.F32_NARROW_DMAX),
            "fp32 narrow forward's instances missing")
    for dmax, got in f32_narrow.items():
        want = flash.f32_narrow_smem_bytes(dmax)
        require(got == want and got <= H100_SMEM_OPTIN,
                f"fp32 narrow forward's shared memory at DMAX {dmax}: C {got}, Python {want}")
    f32_wide = {dmax: _build.kernel("flash_fwd_f32_smem")(dmax) for dmax in flash.F32_WIDE_DMAX}
    print(f"  fp32 wide forward (3xTF32 tensor cores): registers {f32_regs} (<DMAX,16-byte "
          f"copies>), dynamic shared memory by DMAX {f32_wide}")
    require(len(f32_regs) == 2 * len(flash.F32_WIDE_DMAX), "fp32 wide forward's instances missing")
    for dmax, got in f32_wide.items():
        want = flash.f32_wide_smem_bytes(dmax)
        require(got == want and got <= H100_SMEM_OPTIN,
                f"fp32 wide forward's shared memory at DMAX {dmax}: C {got}, Python {want}")
    f32_split = {(role, dmax): _build.kernel("flash_bwd_f32_smem")(role, dmax)
                 for role in (0, 1) for dmax in flash.F32_WIDE_DMAX}
    print(f"  fp32 split pair (3xTF32 tensor cores): registers {split_regs} (<DMAX,dkv,TMA "
          f"loads>), dynamic shared memory by (role 0 dq / 1 dkv, DMAX) {f32_split}")
    require(len(split_regs) == 4 * len(flash.F32_WIDE_DMAX), "fp32 split pair's instances missing")
    for (role, dmax), got in f32_split.items():
        want = flash.f32_split_smem_bytes(dmax)
        require(got == want and got <= H100_SMEM_OPTIN,
                f"fp32 split pair's shared memory at role {role}, DMAX {dmax}: C {got}, "
                f"Python {want}")
    f32_fused = {w: _build.kernel("flash_bwd_fused_f32_smem")(w) for w in flash.F32_FUSED_WIDTHS}
    print("  fp32 fused backward (3xTF32 tensor cores): (registers, spill stores, spill loads) "
          f"by <padded width, TMA loads> {fused_regs}, dynamic shared memory by padded width "
          f"{f32_fused}")
    require(len(fused_regs) == 2 * len(flash.F32_FUSED_WIDTHS),
            "fp32 fused backward's instances missing")
    for w, got in f32_fused.items():
        want = flash.f32_fused_smem_bytes(w)
        require(got == want and got <= H100_SMEM_OPTIN,
                f"fp32 fused backward's shared memory at width {w}: C {got}, Python {want}")
    gn_smem_phase()
    require(not spilled, f"Hopper kernels spill registers: {spilled}")


def gn_smem_phase() -> None:
    """gn_fused's plan and dynamic shared memory a block at every main-path
    GroupNorm shape it takes (bf16, channels-last, 16-byte aligned), from
    the C side's geometry, which must equal the plan's own count; the same
    for the gn_stats + gn_apply pair's plan at every shape it takes."""
    import torch

    from distdiff_tpu_torch.models.layers import group_count
    from distdiff_tpu_torch.ops import _build
    from distdiff_tpu_torch.ops import groupnorm as gn

    smem_limit, sm_count = gn._device_limits(torch.device("cuda"))
    plan_keys = gn_plan(main_gn_calls())
    for b, c, h, w in sorted({k[1] for k in plan_keys if k[0] == "gn_fused"}):
        g, s = group_count(c), h * w
        plan = gn.fused_plan(b, c, s, g, 2, "nhwc", sm_count, smem_limit, 0, 0)
        want = gn.fused_smem_bytes("nhwc", c, s, g, 2, plan)
        got = _build.kernel("gn_fused_smem")(1, c, s, g, 1, *plan)
        print(f"  gn_fused [{b},{c},{h},{w}]: {plan}, {got} B of dynamic shared memory a block, "
              f"{b * g // plan.group_set * plan.cluster} blocks")
        require(got == want, f"gn_fused's shared memory at [{b},{c},{h},{w}]: C {got}, plan {want}")
    for b, c, h, w in sorted({k[1] for k in plan_keys if k[0] == "gn_stats"}):
        g, s = group_count(c), h * w
        plan = gn.pair_plan(b, c, s, 2, "nhwc", sm_count, 0, 0)
        check_pair_plan(b, c, s, 2, "nhwc", plan, 0, 0)
        want = gn.pair_smem_bytes("nhwc", c, g, plan)
        got = _build.kernel("gn_stats_smem")(c, s, g, 1, *plan)
        print(f"  gn_stats/gn_apply [{b},{c},{h},{w}]: {plan}, {got} B of dynamic shared memory "
              f"a gn_stats block, {b * plan.bands} blocks")
        require(got == want and got <= smem_limit,
                f"gn_stats' shared memory at [{b},{c},{h},{w}]: C {got}, plan {want}")


def check_pair_plan(b, c, s, itemsize, lay, plan, x_ptr, y_ptr) -> None:
    """Replay the gn_stats and gn_apply kernels' index arithmetic for
    ``plan`` (csrc/groupnorm.cu): every pixel row (NHWC, walked last to
    first as gn_apply walks it) or plane element (NCHW) is covered exactly
    once, and every vector column once; every access lies in bounds; the vector divides what it
    must and aligns both pointers; the block and grid fit the card's
    limits."""
    import numpy as np

    v, threads, bands, rows = plan
    what = f"pair plan {tuple(plan)} at [{b},{c},{s}] {lay}"
    require(0 < threads <= 256 and bands > 0 and rows > 0, f"{what}: block or bands")
    require(x_ptr % (v * itemsize) == 0 and y_ptr % (v * itemsize) == 0 and v * itemsize <= 16,
            f"{what}: vector off its alignment")
    require(bands * rows >= s and (bands - 1) * rows < s, f"{what}: bands do not tile the rows")
    require(b * c * s < 2 ** 31, f"{what}: 2^31 elements or more")
    hits = np.zeros(s, np.int64)
    if lay == "nhwc":
        require(c % v == 0 and b <= 65535, f"{what}: vector does not divide C")
        nv = c // v
        nvt = min(nv, threads)
        rr = threads // nvt
        require(nvt * rr == threads, f"{what}: threads are no whole rows of columns")
        cols = np.zeros(nv, np.int64)
        for tx in range(nvt):
            cols[tx::nvt] += 1  # vector columns tx, tx + nvt, ...
        require(bool((cols == 1).all()), f"{what}: vector columns not covered once")
        ty = np.arange(rr)
        for band in range(bands):
            r0, r1 = band * rows, min(s, band * rows + rows)
            n = np.maximum(0, -(-(r1 - r0 - ty) // rr))  # PairThread::count
            k = np.arange(int(n.max()))
            r = r0 + ty[:, None] + (n[:, None] - 1 - k[None, :]) * rr  # last to first
            r = r[k[None, :] < n[:, None]]
            require(r.size == 0 or (r.min() >= r0 and r.max() < r1), f"{what}: row out of band")
            np.add.at(hits, r, 1)
    else:
        require(s % v == 0 and rows % v == 0 and threads % 32 == 0 and bands <= 65535,
                f"{what}: vector, band or block")
        for band in range(bands):
            lo = band * rows
            n = min(rows, s - lo)
            i = (np.arange(threads) * v)[:, None] + np.arange(-(-n // (threads * v)))[None, :] * (
                threads * v)
            i = i[i < n]
            for j in range(v):
                np.add.at(hits, lo + i + j, 1)
    require(bool((hits == 1).all()), f"{what}: rows not covered exactly once")


def flash_shapes() -> list:
    """Phase 2's flash shapes: (label, B, H, Tq, Tk, D, kernels to run,
    timed: True, False (checked only) or "offset" (checked on views one
    element into their storage))."""
    cfg_b = 2 * BATCH  # CFG doubles the UNet batch
    split = ["flash_bwd_dq", "flash_bwd_dkv"]
    every = ["flash_fwd", "flash_bwd_fused"] + split
    shapes = [
        # (label, B, H, Tq, Tk, D, kernels to run, timed)
        ("unet64", cfg_b, 8, 4096, 4096, 40, every, True),
        ("unet32", cfg_b, 8, 1024, 1024, 80, ["flash_fwd", "flash_bwd_fused"], True),
        ("vae_mid", BATCH, 1, 4096, 4096, 512, ["flash_fwd"] + split, True),
        # phase 5's guidance on sub-batches of one sample (guide_chunk=1):
        # the UNet on the CFG pair of one, the VAE decode on one
        ("unet64_g1", 2, 8, 4096, 4096, 40, ["flash_fwd", "flash_bwd_fused"], True),
        ("unet32_g1", 2, 8, 1024, 1024, 80, ["flash_fwd", "flash_bwd_fused"], True),
        ("vae_mid1", 1, 1, 4096, 4096, 512, ["flash_fwd"] + split, True),
        # phase 6's dataset encode, CLI_ENCODE_BATCH images a call
        ("vae_mid_enc", CLI_ENCODE_BATCH, 1, 4096, 4096, 512, ["flash_fwd"], True),
        # phase 8: SD-2.1 at 768^2 (96^2 latents), heads 64 wide at every
        # level, the CFG pair of batch 2; its VAE mid-block over 9216
        # tokens; the CLI's dataset encode at 768^2
        ("sd21_96", cfg_b, 5, 9216, 9216, 64, ["flash_fwd", "flash_bwd_fused"], True),
        ("sd21_48", cfg_b, 10, 2304, 2304, 64, ["flash_fwd", "flash_bwd_fused"], True),
        ("sd21_24", cfg_b, 20, 576, 576, 64, ["flash_fwd", "flash_bwd_fused"], True),
        ("sd21_vae_mid", BATCH, 1, 9216, 9216, 512, ["flash_fwd"] + split, True),
        ("sd21_vae_enc", CLI_ENCODE_BATCH, 1, 9216, 9216, 512, ["flash_fwd"], True),
        # phase 9: SDXL-base at 1024^2 (128^2 latents), heads 64 wide at the
        # 64^2 and 32^2 levels (10 and 20 heads; none at 128^2), the CFG pair
        # of batch 2; its VAE mid-block over 16384 tokens; the CLI's dataset
        # encode at 1024^2
        ("sdxl_64", cfg_b, 10, 4096, 4096, 64, ["flash_fwd", "flash_bwd_fused"], True),
        ("sdxl_32", cfg_b, 20, 1024, 1024, 64, ["flash_fwd", "flash_bwd_fused"], True),
        ("sdxl_vae_mid", BATCH, 1, 16384, 16384, 512, ["flash_fwd"] + split, True),
        ("sdxl_vae_enc", CLI_ENCODE_BATCH, 1, 16384, 16384, 512, ["flash_fwd"], True),
        # phase 10: SD-1.5's LoRA train step at cli.train_lora's batch of 8
        # (no CFG), 8 heads at the 64^2 and 32^2 levels
        ("lora64", LORA_BATCH, 8, 4096, 4096, 40, ["flash_fwd", "flash_bwd_fused"], True),
        ("lora32", LORA_BATCH, 8, 1024, 1024, 80, ["flash_fwd", "flash_bwd_fused"], True),
        # phase 14: one ring step of a 2-way seq mesh (the tokens cut in
        # two) at SD-1.5's two self-attention widths and the VAE's D = 512
        ("sp64", BATCH, 8, 2048, 2048, 40, ["flash_fwd", "flash_bwd_fused"], True),
        ("sp32", BATCH, 8, 512, 512, 80, ["flash_fwd", "flash_bwd_fused"], True),
        ("sp_vae", 1, 1, 2048, 2048, 512, ["flash_fwd"] + split, True),
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
    # the wide forward and the split backward pair (64-row tiles on both
    # sides) at widths from 129 to 512, with lengths one row on either side
    # of their tiles, and on a view one element into its storage at D = 512
    # (the staged route); checked only
    wide = ["flash_fwd"] + split
    shapes += [
        ("w129", 1, 2, 65, 63, 129, wide, False),
        ("w130", 1, 2, 63, 65, 130, wide, False),
        ("w136", 1, 2, 129, 127, 136, wide, False),
        ("w160", 1, 2, 127, 129, 160, wide, False),
        ("w256", 2, 1, 64, 65, 256, wide, False),
        ("w257", 1, 2, 65, 64, 257, wide, False),
        ("w384", 1, 2, 128, 63, 384, wide, False),
        ("w512", 1, 2, 63, 129, 512, wide, False),
        ("offset512", 1, 1, 200, 150, 512, wide, "offset"),
    ]
    return shapes


def kernel_phase():
    """Hold every kernel against its plain version at the main-path shapes
    (timed), and at ragged shapes (checked only: q and kv lengths off the
    tiles, the 77-token kv of cross-attention, head widths off the padded
    ones, every narrow width, wide widths from 129 to 512, views off
    16-byte alignment); returns one record per timed (kernel, shape)."""
    import torch
    import torch.nn.functional as F

    from distdiff_tpu_torch.ops import flash

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    split = ["flash_bwd_dq", "flash_bwd_dkv"]
    shapes = flash_shapes()
    entries = []
    for label, b, h, tq, tk, d, names, timed in shapes:
        bh = b * h

        def rnd(*s):
            if timed == "offset":  # a contiguous view one element into its storage
                n = math.prod(s)
                return torch.randn(n + 1, generator=gen, device=dev).to(torch.bfloat16)[1:].view(*s)
            return torch.randn(*s, generator=gen, device=dev).to(torch.bfloat16)

        q, do, k, v = rnd(bh, tq, d), rnd(bh, tq, d), rnd(bh, tk, d), rnd(bh, tk, d)
        plan = flash.bf16_plan(d, q, k, v, do)
        require(plan[1] == (0 if timed == "offset" or d % 8 else 1),
                f"{label}: load route {plan} for d={d}")
        print(f"  {label} [{bh},{tq},{tk},{d}]: "
              f"{f'padded width {plan[0]}' if plan[0] else 'wide kernel'}, "
              f"{'TMA' if plan[1] else 'staged'} loads")
        timed = timed is True
        ref_o, ref_lse = flash.flash_fwd_reference(q, k, v)
        o, lse = flash.flash_fwd(q, k, v)
        torch.cuda.synchronize()
        delta = flash.attention_delta(o, do)
        # the plain backward and SDPA's graph only where a backward kernel
        # runs (at [8,16384,16384,512] each score matrix is 8.6 GB in fp32)
        backward = any(name != "flash_fwd" for name in names)
        ref_grads = flash.flash_bwd_reference(q, k, v, o, lse, do) if backward else None
        if timed:
            q4, k4, v4, do4 = (x.view(b, h, -1, d) for x in (q, k, v, do))
        if timed and backward:
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
                    run = lambda: (flash.flash_bwd_dq(q, k, v, do, lse, delta),)  # noqa: E731
                    got = dict(zip(("dq",), run()))
                else:
                    run = lambda: flash.flash_bwd_dkv(q, k, v, do, lse, delta)  # noqa: E731
                    got = dict(zip(("dk", "dv"), run()))
                torch.cuda.synchronize()
                if name in split:  # no atomics: the same bytes on a second launch
                    again = run()
                    torch.cuda.synchronize()
                    same = all(torch.equal(a, b) for a, b in zip(got.values(), again))
                    print(f"  {name} {label}: {'the same' if same else 'OTHER'} bytes on two "
                          f"launches")
                    require(same, f"{name} gives other bytes on a second launch at {label}")
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
            if d > 128:  # SDPA's flash backend stops at 256: say which one ran
                print(f"  sdpa {'forward' if name == 'flash_fwd' else 'backward'} at "
                      f"{label}: {device_kernels(lib)}")
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
        if timed and backward:
            del sdpa_out, qg, kg, vg
        del ref_grads, ref_o
        torch.cuda.empty_cache()
    return entries


def flash_f32_phase() -> list:
    """The four flash kernels on fp32 inputs (their fp32 instances,
    csrc/flash_f32.cu) at main-path widths and at ragged shapes, against the
    plain fp32 version; timed at the main-path widths, the forward and the
    fused backward also at [32,1024,1024,80] and the forward and the split
    pair at D = 160 (the wide tensor-core kernels' DMAX = 256 instances).
    The forward and the fused backward also at narrow widths from 8 to 128
    and the forward and the split pair at the wide widths from 129 to 512,
    with lengths one row on either side of their tiles and on views one
    element into their storage (4-byte copies; the fused backward's dq by
    atomicAdd there), every launch twice: the same bytes, but for the fused
    backward's dq, which its blocks add in no order (held to the tolerance
    on both launches); then the forward against fp64 over 16384 kv rows
    (``fwd_fp64_check``), the split pair and the fused backward against
    fp64 at 16384 rows on either side of their sums (``split_fp64_check``,
    ``fused_fp64_check``). Returns one record per timed (kernel, shape)."""
    import torch
    import torch.nn.functional as F

    from distdiff_tpu_torch.ops import flash

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    split = ["flash_bwd_dq", "flash_bwd_dkv"]
    every = ["flash_fwd", "flash_bwd_fused"] + split
    fwd = ["flash_fwd"]
    wide = ["flash_fwd"] + split
    shapes = [
        # (label, BH, Tq, Tk, D, kernels, timed)
        ("unet64_f32", 32, 4096, 4096, 40, ["flash_fwd", "flash_bwd_fused"], True),
        ("unet32_f32", 32, 1024, 1024, 80, ["flash_fwd", "flash_bwd_fused"], True),
        ("vae_mid_f32", 2, 4096, 4096, 512, ["flash_fwd"] + split, True),
        ("vae160_f32", 4, 4096, 4096, 160, ["flash_fwd"] + split, True),
        ("tiny_f32", 4, 576, 576, 16, every, False),
        ("ragged_f32", 3, 300, 130, 40, every, False),
        ("odd_f32", 2, 129, 77, 160, ["flash_fwd"] + split, False),
        # the narrow forward's edges: its 128-row q tiles (32 rows a
        # warp), its 64-row kv tiles (16 at DMAX 128), its k-steps over d
        # rounded up to 8; DMAX 32, 64 and 128; 4-byte copies where
        # d % 4 != 0 or a base is off 16 bytes
        ("n8_f32", 2, 63, 65, 8, fwd, False),
        ("n16_f32", 2, 65, 63, 16, fwd, False),
        ("n24_f32", 2, 127, 129, 24, fwd, False),
        ("n33_f32", 2, 64, 33, 33, fwd, False),
        ("n40_f32", 2, 129, 127, 40, fwd, False),
        ("n64_f32", 2, 63, 129, 64, fwd, False),
        ("n72_f32", 2, 129, 63, 72, fwd, False),
        ("n80_f32", 2, 65, 127, 80, fwd, False),
        ("n100_f32", 2, 127, 65, 100, fwd, False),
        ("n128_f32", 2, 129, 31, 128, fwd, False),
        ("offset40_f32", 1, 200, 150, 40, fwd, "offset"),
        ("offset100_f32", 1, 65, 129, 100, fwd, "offset"),
        # the tensor-core kernels' edges: the forward's 64-row q and kv
        # tiles, 64-column k chunks and 32-column output slices; the split
        # pair's 32 resident rows, 16-row stream tiles and 64-column chunk
        # pairs; DMAX 256 and 512
        ("w129_f32", 2, 65, 63, 129, wide, False),
        ("w136_f32", 2, 63, 65, 136, wide, False),
        ("w160_f32", 2, 129, 127, 160, wide, False),
        ("w200_f32", 2, 127, 129, 200, wide, False),
        ("w256_f32", 2, 64, 65, 256, wide, False),
        ("w257_f32", 2, 65, 64, 257, wide, False),
        ("w384_f32", 2, 128, 63, 384, wide, False),
        ("w500_f32", 2, 63, 128, 500, wide, False),
        ("w512_f32", 2, 129, 127, 512, wide, False),
        ("w512s_f32", 1, 33, 17, 512, wide, False),
        ("offset512_f32", 1, 200, 150, 512, wide, "offset"),
    ]
    # the fused backward's edges: its 128 kv rows a block, its q tiles of 32
    # rows (16 at D > 96), one row on either side of each; its padded widths
    # 16 to 128 (two blocks split the columns at 128); the 4-byte route and
    # dq by atomicAdd on views one element into their storage
    fused = ["flash_bwd_fused"]
    for d, tq, tk in ((8, 33, 127), (16, 31, 129), (24, 65, 255), (33, 63, 129), (40, 97, 127),
                      (64, 95, 257), (72, 33, 129), (80, 31, 127), (100, 17, 129),
                      (128, 15, 257)):
        shapes += [(f"f{d}_f32", 2, tq, tk, d, fused, False),
                   (f"offset_f{d}_f32", 1, tq + 2, tk - 2, d, fused, "offset")]
    entries = []
    for label, bh, tq, tk, d, names, timed in shapes:
        offset = timed == "offset"

        def rnd(*s):
            if offset:  # a contiguous view one element into its storage
                return torch.randn(math.prod(s) + 1, generator=gen, device=dev)[1:].view(*s)
            return torch.randn(*s, generator=gen, device=dev)

        timed = timed is True
        q, do = rnd(bh, tq, d), rnd(bh, tq, d)
        k, v = rnd(bh, tk, d), rnd(bh, tk, d)
        o, lse = flash.flash_fwd(q, k, v)
        ref_o, ref_lse = flash.flash_fwd_reference(q, k, v)
        delta = flash.attention_delta(o, do)
        ref = {} if names == fwd else dict(zip(("dq", "dk", "dv"),
                                               flash.flash_bwd_reference(q, k, v, o, lse, do)))
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
            # no atomics: the same bytes on a second launch; but the fused
            # backward's dq, summed by blocks in no order, is held to the
            # tolerance on both launches
            again = dict(zip(keys[name], calls[name]()))
            torch.cuda.synchronize()
            same = all(torch.equal(got[key].view(torch.int32), again[key].view(torch.int32))
                       for key in got if key != "dq" or name != "flash_bwd_fused")
            dispatch = {"flash_fwd": flash.f32_fwd_kernel,
                        "flash_bwd_fused": flash.f32_fused_kernel}
            kernel, dp = dispatch.get(name, flash.f32_split_kernel)(d)
            route = ""
            if name == "flash_bwd_fused":  # csrc/flash_f32.cu launch_bwd_fused's rule
                vec = d % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (q, k, v, do))
                require(vec == (d % 4 == 0 and not offset), f"{label}: route {vec}")
                route = ", TMA loads and dq by bulk reduce-add" if vec else \
                    ", 4-byte copies and dq by atomicAdd"
            print(f"  {name} {label} fp32 [{bh},{tq},{tk},{d}]: {kernel} (padded width "
                  f"{dp}{route}), {'the same' if same else 'OTHER'} bytes on two launches"
                  f"{' (dk, dv; dq below)' if name == 'flash_bwd_fused' else ''}")
            require(same, f"{name} (fp32) gives other bytes on a second launch at {label}")
            if name == "flash_bwd_fused":
                got["dq again"] = again["dq"]
                want["dq again"] = want["dq"]
            max_err = 0.0
            for key, val in got.items():
                require(val.dtype == torch.float32, f"{name} returned {val.dtype} on fp32")
                err = (val - want[key]).abs().max().item()
                scale = want[key].abs().max().item()
                # nothing rounded to bf16: the forward at every width, the
                # fused backward and the split pair past D = 128 run 3xTF32
                # products on the tensor cores (~1e-6 a product; their sums
                # round toward zero, so each chunk's are summed apart and
                # added in fp32), within ~2e-5 of the largest output of fp64
                # attention; the split pair's narrow instances fp32 FMA on
                # the CUDA cores, where only the summation order differs
                # from the plain version (~1e-6 relative); 1e-4 of the
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
    entries += fwd_fp64_check(gen)
    entries += split_fp64_check(gen)
    entries += fused_fp64_check(gen)
    return entries


def fwd_fp64_check(gen) -> list:
    """The fp32 narrow forward against fp64 attention where its sums are
    long: 16384 kv rows at D = 40 and 128 ([1,2048,16384,D]), o over the
    largest |o| of fp64 (at most 2e-5) and lse absolute, the plain fp32
    version's errors on the same inputs beside them. Returns one record
    per shape."""
    import torch

    from distdiff_tpu_torch.ops import flash

    dev = torch.device("cuda")
    out = []
    for bh, tq, tk, d in ((1, 2048, 16384, 40), (1, 2048, 16384, 128)):
        q = torch.randn(bh, tq, d, generator=gen, device=dev)
        k, v = (torch.randn(bh, tk, d, generator=gen, device=dev) for _ in range(2))
        s = torch.matmul(q.double(), k.double().transpose(1, 2)) * d ** -0.5
        lse64 = torch.logsumexp(s, dim=-1)
        o64 = torch.matmul(torch.exp(s - lse64[..., None]), v.double())
        del s
        errs = {}
        for who, (o, lse) in (("kernel", flash.flash_fwd(q, k, v)),
                              ("plain", flash.flash_fwd_reference(q, k, v))):
            errs[who] = (float((o.double() - o64).abs().max() / o64.abs().max()),
                         float((lse.double() - lse64).abs().max()))
        torch.cuda.synchronize()
        (err, err_lse), (err_plain, lse_plain) = errs["kernel"], errs["plain"]
        ok = math.isfinite(err) and err <= 2e-5 and err_lse <= 1e-4
        print(f"  flash_fwd ({flash.f32_fwd_kernel(d)[0]}) fp32 [{bh},{tq},{tk},{d}] against "
              f"fp64: max |err| / max |o| {err:.3e} (plain fp32 {err_plain:.3e}; tol 2e-5), lse "
              f"{err_lse:.3e} (plain {lse_plain:.3e}) {'ok' if ok else 'FAIL'}")
        require(ok, f"flash_fwd (fp32) strays from fp64 at [{bh},{tq},{tk},{d}]")
        out.append({"name": "flash_fwd", "cell": "fp64_long", "shape": [bh, tq, tk, d],
                    "dtype": "fp32", "rel_err_fp64": err, "plain_rel_err_fp64": err_plain,
                    "lse_err_fp64": err_lse, "plain_lse_err_fp64": lse_plain})
        del o64
        torch.cuda.empty_cache()
    return out


def split_fp64_check(gen) -> list:
    """The fp32 split pair against fp64 attention gradients where its sums
    are long: dq sums over 16384 kv rows ([1,2048,16384,512]), dk and dv over
    16384 q rows ([1,16384,2048,512]). The inputs' lse and delta come from
    fp64 and are rounded to fp32, so the error is the pair's own; the plain
    fp32 version's error on the same inputs stands beside it. Returns one
    record per (kernel, shape) with both errors over the largest |output|."""
    import torch

    from distdiff_tpu_torch.ops import flash

    dev = torch.device("cuda")
    out = []
    for name, (bh, tq, tk, d) in (("flash_bwd_dq", (1, 2048, 16384, 512)),
                                  ("flash_bwd_dkv", (1, 16384, 2048, 512))):
        q, do = (torch.randn(bh, tq, d, generator=gen, device=dev) for _ in range(2))
        k, v = (torch.randn(bh, tk, d, generator=gen, device=dev) for _ in range(2))
        q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
        s = torch.matmul(q64, k64.transpose(1, 2)) * d ** -0.5
        lse64 = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse64[..., None])
        del s
        delta64 = (torch.matmul(p, v64) * do64).sum(-1)
        ds = p * (torch.matmul(do64, v64.transpose(1, 2)) - delta64[..., None]) * d ** -0.5
        want = ((torch.matmul(ds, k64),) if name == "flash_bwd_dq" else
                (torch.matmul(ds.transpose(1, 2), q64), torch.matmul(p.transpose(1, 2), do64)))
        del p, ds
        lse, delta = lse64.float(), delta64.float()
        if name == "flash_bwd_dq":
            got = (flash.flash_bwd_dq(q, k, v, do, lse, delta),)
            plain = flash._grads_from_delta(q, k, v, do, lse, delta)[:1]
        else:
            got = flash.flash_bwd_dkv(q, k, v, do, lse, delta)
            plain = flash._grads_from_delta(q, k, v, do, lse, delta)[1:]
        torch.cuda.synchronize()
        err = max(float((g.double() - w).abs().max() / w.abs().max()) for g, w in zip(got, want))
        err_plain = max(float((g.double() - w).abs().max() / w.abs().max())
                        for g, w in zip(plain, want))
        ok = math.isfinite(err) and err <= 1e-4
        print(f"  {name} fp32 [{bh},{tq},{tk},{d}] against fp64: max |err| / max |out| "
              f"{err:.3e} (plain fp32 {err_plain:.3e}; tol 1e-4) {'ok' if ok else 'FAIL'}")
        require(ok, f"{name} (fp32) strays from fp64 at [{bh},{tq},{tk},{d}]")
        out.append({"name": name, "cell": "fp64_long", "shape": [bh, tq, tk, d],
                    "dtype": "fp32", "rel_err_fp64": err, "plain_rel_err_fp64": err_plain})
        del want, got, plain
        torch.cuda.empty_cache()
    return out


def fused_fp64_check(gen) -> list:
    """The fp32 fused backward against fp64 attention gradients where its
    sums are long: dq sums over 16384 kv rows ([1,2048,16384,D]), dk and dv
    over 16384 q rows ([1,16384,2048,D]), at D = 40 and 128, each within
    2e-5 of the largest |output| of fp64. The inputs' lse and delta come
    from fp64 and are rounded to fp32, so the error is the kernel's own; the
    plain fp32 version's error on the same inputs stands beside it.
    Returns one record per shape."""
    import torch

    from distdiff_tpu_torch.ops import flash

    dev = torch.device("cuda")
    out = []
    for d in (40, 128):
        for outs, (bh, tq, tk) in ((("dq",), (1, 2048, 16384)), (("dk", "dv"), (1, 16384, 2048))):
            q, do = (torch.randn(bh, tq, d, generator=gen, device=dev) for _ in range(2))
            k, v = (torch.randn(bh, tk, d, generator=gen, device=dev) for _ in range(2))
            q64, k64, v64, do64 = (x.double() for x in (q, k, v, do))
            s = torch.matmul(q64, k64.transpose(1, 2)) * d ** -0.5
            lse64 = torch.logsumexp(s, dim=-1)
            p = torch.exp(s - lse64[..., None])
            del s
            delta64 = (torch.matmul(p, v64) * do64).sum(-1)
            ds = p * (torch.matmul(do64, v64.transpose(1, 2)) - delta64[..., None]) * d ** -0.5
            want = {"dq": torch.matmul(ds, k64), "dk": torch.matmul(ds.transpose(1, 2), q64),
                    "dv": torch.matmul(p.transpose(1, 2), do64)}
            del p, ds
            lse, delta = lse64.float(), delta64.float()
            got = dict(zip(("dq", "dk", "dv"), flash.flash_bwd_fused(q, k, v, do, lse, delta)))
            plain = dict(zip(("dq", "dk", "dv"), flash._grads_from_delta(q, k, v, do, lse, delta)))
            torch.cuda.synchronize()

            def rel(x, key):
                return float((x[key].double() - want[key]).abs().max() / want[key].abs().max())

            err = max(rel(got, key) for key in outs)
            err_plain = max(rel(plain, key) for key in outs)
            ok = math.isfinite(err) and err <= 2e-5
            print(f"  flash_bwd_fused ({flash.f32_fused_kernel(d)[0]}) fp32 {'/'.join(outs)} "
                  f"[{bh},{tq},{tk},{d}] against fp64: max |err| / max |out| {err:.3e} (plain "
                  f"fp32 {err_plain:.3e}; tol 2e-5) {'ok' if ok else 'FAIL'}")
            require(ok, f"flash_bwd_fused (fp32) strays from fp64 at [{bh},{tq},{tk},{d}]")
            out.append({"name": "flash_bwd_fused", "cell": "fp64_long", "outputs": list(outs),
                        "shape": [bh, tq, tk, d], "dtype": "fp32", "rel_err_fp64": err,
                        "plain_rel_err_fp64": err_plain})
            del want, got, plain
            torch.cuda.empty_cache()
    return out


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


def _recipe_pipe(config):
    """What the planners read of a pipeline running the phase-4 recipe."""
    import types

    from distdiff_tpu_torch.config import GuidanceConfig
    from distdiff_tpu_torch.schedulers import make_schedule

    return types.SimpleNamespace(config=config, guidance_cfg=GuidanceConfig(),
                                 sched=make_schedule(config.num_inference_steps), strength=0.5)


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

    def data(shape, groups, dtype, cl, offset=False):
        b, c = shape[:2]
        x = (torch.randn(shape, generator=gen, device=dev) * 1.5 + 0.3).to(dtype)
        if cl:
            x = x.to(memory_format=torch.channels_last)
        if offset:  # the same layout, one element into its storage
            flat = torch.empty(x.numel() + 1, device=dev, dtype=dtype)
            v = flat[1:].as_strided(x.shape, x.stride())
            v.copy_(x)
            x = v
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
        b, c, h, w = shape
        if not gn.fused_fits(c, groups, h * w, 2, smem_limit):  # the pair's: every combination
            cases += [(shape, groups, torch.bfloat16, True, other, False),
                      (shape, groups, torch.bfloat16, False, main, False),
                      (shape, groups, torch.float32, True, main, False),
                      (shape, groups, torch.float32, False, other, False)]
    ragged = [((2, 96, 7, 9), 32), ((3, 32, 5, 5), 32), ((1, 192, 33, 31), 64),
              ((2, 40, 15, 17), 8),
              # gn_fused's edges: B = 1; pixels one off its cluster's split
              # (1023 and 1025; 4095 in a grid past 4 blocks an SM, by
              # TMA); a group set whose run of channels is no multiple of
              # 16 bytes (cpg 9); more channels a set than threads a block
              # (a column loop)
              ((1, 320, 64, 64), 32), ((1, 1280, 8, 8), 32), ((2, 640, 33, 31), 32),
              ((2, 640, 25, 41), 32), ((4, 640, 65, 63), 32), ((2, 36, 15, 17), 4),
              ((1, 602, 6, 5), 2),
              # the pair's edges: B = 1 at the UNet's 960 channels; pixel
              # rows no multiple of the band (10000 in bands of 38); vectors
              # of 2 and 1 bf16 values (C = 50, 45); more vector columns
              # than threads (C = 2560); more groups than the finish has
              # threads (192 groups, 384 columns)
              ((1, 960, 64, 64), 32), ((2, 256, 100, 100), 32), ((2, 50, 17, 19), 5),
              ((1, 45, 16, 16), 5), ((1, 2560, 9, 9), 32), ((2, 384, 20, 20), 192)]
    for shape, groups in ragged:
        for dtype in (torch.bfloat16, torch.float32):
            for cl in (True, False):
                cases.append((shape, groups, dtype, cl, "silu" if cl else None, "direct"))
    # views one element into their storage: vector loads, whatever the shape
    for shape, groups in (((2, 320, 32, 32), 32), ((1, 40, 9, 7), 8), ((2, 128, 64, 64), 32)):
        for cl in (True, False):
            cases.append((shape, groups, torch.bfloat16, cl, "silu", "offset"))

    def fused_twice(x, scale, bias, groups, act, tag):
        """gn_fused twice on one input: both outputs, the same bytes."""
        y1, y2 = torch.empty_like(x), torch.empty_like(x)
        for y in (y1, y2):
            gn.gn_fused(x, scale, bias, groups, 1e-5, act, y, sm_count, smem_limit)
        torch.cuda.synchronize()
        require(same_bytes(y1, y2), f"gn_fused gave two results on one input at {tag}")
        return y1

    def pair_plans(x, y, tag):
        """The pair's plans for x (gn_stats) and x -> y (gn_apply), each
        replayed by check_pair_plan and printed."""
        b, c = x.shape[:2]
        s = x.numel() // (b * c)
        lay = gn.layout(x)
        plans = [gn.pair_plan(b, c, s, x.element_size(), lay, sm_count, x.data_ptr(), p)
                 for p in (x.data_ptr(), y.data_ptr())]
        for plan, p in zip(plans, (x.data_ptr(), y.data_ptr())):
            check_pair_plan(b, c, s, x.element_size(), lay, plan, x.data_ptr(), p)
        print(f"  gn_stats/gn_apply {tag}: {tuple(plans[0])}"
              + (f" / {tuple(plans[1])}" if plans[1] != plans[0] else ""))

    def pair_twice(x, scale, bias, groups, act, tag):
        """gn_stats and gn_apply twice on one input: both (a, b) and both
        outputs, the same bytes."""
        abs_, ys = [], []
        for _ in range(2):
            abs_.append(gn.gn_stats(x, scale, bias, groups, 1e-5, sm_count))
            ys.append(torch.empty_like(x))
            gn.gn_apply(x, abs_[-1], act, ys[-1], sm_count)
        torch.cuda.synchronize()
        require(same_bytes(*abs_) and same_bytes(*ys),
                f"gn_stats/gn_apply gave two results on one input at {tag}")
        return abs_[0], ys[0]

    def same_bytes(a, b):
        bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        return torch.equal(a.view(bits), b.view(bits))

    n_same = n_same_pair = 0
    for shape, groups, dtype, cl, act, mode in cases:
        x, scale, bias = data(shape, groups, dtype, cl, offset=mode == "offset")
        tag = (f"{list(shape)} g{groups} {str(dtype)[6:]} {'nhwc' if cl else 'nchw'} "
               f"act={act}{' offset' if mode == 'offset' else ''}")
        ref_ab = gn.group_norm_stats_reference(x, scale, bias, groups, 1e-5)
        ref = gn.group_norm_apply_reference(x, ref_ab, act)
        if mode in ("direct", "offset"):  # every kernel, whatever the shared-memory rule says
            b, c = shape[:2]
            plan = gn.fused_plan(b, c, x.numel() // (b * c), groups, x.element_size(),
                                 gn.layout(x), sm_count, smem_limit, x.data_ptr(), x.data_ptr())
            print(f"  gn_fused {tag}: {'TMA' if plan.tma else 'vector'} loads, cluster "
                  f"{plan.cluster}, group set {plan.group_set}, {plan.vec} a load")
            require(mode != "offset" or (plan.tma == 0 and plan.vec == 1),
                    f"a view off 16 bytes took {plan} at {tag}")
            y = fused_twice(x, scale, bias, groups, act, tag)
            n_same += 1
            check(f"gn_fused {tag}", y, ref, dtype)
            y2 = torch.empty_like(x)
            pair_plans(x, y2, tag)
            ab, _ = pair_twice(x, scale, bias, groups, act, tag)
            n_same_pair += 1
            check(f"gn_stats {tag}", ab, ref_ab, torch.float32)
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
        if ran != ["gn_fused"]:
            pair_plans(x, y, tag)
            ab, y2 = pair_twice(x, scale, bias, groups, act, tag)
            n_same_pair += 1
            require(same_bytes(y2, y), f"gn_stats/gn_apply gave two results on one input at {tag}")
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
            require(same_bytes(fused_twice(x, scale, bias, groups, act, tag), y),
                    f"gn_fused gave two results on one input at {tag}")
            n_same += 1
            out = torch.empty_like(x)
            runs = {"gn_fused": lambda: gn.gn_fused(x, scale, bias, groups, 1e-5, act, out,
                                                    sm_count, smem_limit)}
            plains = {"gn_fused": plain_ms}
            errs = {"gn_fused": err}
        else:
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
        if "gn_apply" in runs:  # the pair as the main path runs it: gn_apply right behind
            pair_ms = time_ms(lambda: (runs["gn_stats"](), runs["gn_apply"]()), 10)
            pair_bound = gn_bound("gn_stats", shape, 2)[0] + gn_bound("gn_apply", shape, 2)[0]
            print(f"  gn_stats + gn_apply {list(shape)} bf16 nhwc act={act}: pair "
                  f"{pair_ms:.4f} ms, bound {pair_bound:.4f} ms")
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
          f"(shared-memory limit {smem_limit} bytes, {sm_count} SMs); gn_fused gave the same "
          f"bytes twice at {n_same} of them, gn_stats + gn_apply at {n_same_pair}")
    torch.cuda.empty_cache()
    return entries


# Attention forwards of one transform rollout step, forward and backward, by
# rollout_remat mode: (UNet calls, VAE mid-block attentions) for each step
# but the last, then for the last ("tail*" leave it without the outer
# checkpoint). The forward runs once; an outer checkpoint re-runs the step,
# the UNet's inner checkpoints re-run its blocks (its attentions are in
# them; the decoder's mid-block attention is in none of the decoder's), and
# "decode" re-runs the decode + guide leg.
ROLLOUT_CALLS = {
    "step_nr": ((2, 2), (2, 2)),
    "step": ((3, 2), (3, 2)),
    "step_nru": ((2, 2), (2, 2)),
    "decode_nr": ((3, 2), (3, 2)),
    "block": ((2, 1), (2, 1)),
    "decode": ((2, 2), (2, 2)),
    "tail": ((3, 2), (2, 1)),
    "tail_decode_nr": ((3, 2), (2, 1)),
}


def rollout_calls(mode: str, period: int):
    """(UNet calls, VAE attention forwards) over a rollout of ``period``
    steps, forward and backward, under ``mode``."""
    first, last = ROLLOUT_CALLS[mode]
    return ((period - 1) * first[0] + last[0], (period - 1) * first[1] + last[1])


def unet_attentions(ucfg, side: int, levels=None) -> list:
    """(heads, tokens, head width, count) of the self-attentions of one UNet
    call on a side^2 latent (``levels``: the down levels it runs, as a
    DeepCache shallow call runs only those up to its branch)."""
    boc, n, L = ucfg.block_out_channels, len(ucfg.block_out_channels), ucfg.layers_per_block
    out = []
    for bi in (range(n) if levels is None else levels):
        s = side
        for _ in range(bi):
            s = _down(s)
        if ucfg.cross_attention[bi] and ucfg.depth_at(bi) > 0:
            h = ucfg.heads_at(bi)
            out.append((h, s * s, boc[bi] // h, ucfg.depth_at(bi) * (2 * L + 1)))
    if levels is None:  # the mid block's transformer, at the deepest level
        s = side
        for _ in range(n - 1):
            s = _down(s)
        h = ucfg.heads_at(n - 1)
        out.append((h, s * s, boc[-1] // h, ucfg.depth_at(n - 1)))
    return out


def span_unet_calls(pipe, lo: int, hi: int) -> tuple:
    """(full, shallow) UNet calls of the plain steps [lo, hi): all full, or
    under DeepCache a full call on the span's first step and every
    cache_interval steps after it."""
    cfg = pipe.config
    if not getattr(cfg, "deep_cache", False):
        return max(hi - lo, 0), 0
    interval = max(cfg.cache_interval, 1)
    full = sum(1 for i in range(lo, hi) if (i - lo) % interval == 0)
    return full, max(hi - lo, 0) - full


def flash_plan(pipe, batch: int, guide_chunk=None,
               parts=("plain", "rollout", "decode")) -> collections.Counter:
    """Flash kernel launches by (kernel, (BH, Tq, Tk, D)) of one
    transform-guided expand call at ``batch`` (guidance on sub-batches of
    ``guide_chunk``): the plain steps' UNet calls on the CFG pair (full,
    or DeepCache's shallow ones), the rollout's by ``rollout_calls`` with
    one backward per attention, and the final decode (``parts`` keeps some
    of the three). Attention over at most 256 kv tokens takes no kernel;
    D <= 128 takes the fused backward, wider the split pair."""
    from distdiff_tpu_torch.schedulers import guidance_window, img2img_start_index

    cfg, gcfg = pipe.config, pipe.guidance_cfg
    n = pipe.sched.num_inference_steps
    start = img2img_start_index(pipe.sched, pipe.strength)
    g0, _ = guidance_window(pipe.sched, gcfg.guidance_step, gcfg.guidance_period)
    chunk = guide_chunk or batch
    units = batch // chunk
    ls = cfg.latent_size
    unet_fwd, vae_fwd = rollout_calls(gcfg.rollout_remat, gcfg.guidance_period)
    full, shallow = (a + b for a, b in zip(span_unet_calls(pipe, start, g0),
                                           span_unet_calls(pipe, g0, n)))
    plan = collections.Counter()

    def attend(b, heads, tokens, d, fwd, bwd):
        if tokens <= 256:
            return
        shape = (b * heads, tokens, tokens, d)
        plan[("flash_fwd", shape)] += fwd
        for name in (("flash_bwd_fused",) if d <= 128 else ("flash_bwd_dq", "flash_bwd_dkv")):
            plan[(name, shape)] += bwd

    c = cfg.vae.block_out_channels[-1]
    if "plain" in parts:
        for h, t, d, k in unet_attentions(cfg.unet, ls):
            attend(2 * batch, h, t, d, k * full, 0)
        if shallow:
            for h, t, d, k in unet_attentions(cfg.unet, ls, levels=range(cfg.cache_branch + 1)):
                attend(2 * batch, h, t, d, k * shallow, 0)
    if "rollout" in parts:
        for h, t, d, k in unet_attentions(cfg.unet, ls):
            attend(2 * chunk, h, t, d, k * unet_fwd * units, k * gcfg.guidance_period * units)
        attend(chunk, 1, ls * ls, c, vae_fwd * units, gcfg.guidance_period * units)
    if "decode" in parts:
        attend(batch, 1, ls * ls, c, 1, 0)
    return plan


def expected_launches(pipe, units: int = 1) -> dict:
    """Flash kernel launches of one transform-guided expand call, by kernel
    (``flash_plan``'s totals), its guidance on ``units`` sub-batches."""
    totals = dict.fromkeys(PRODUCTS, 0)
    for (name, _), c in flash_plan(pipe, units, guide_chunk=1).items():
        totals[name] += c
    return totals


def check_flash_plan(got: dict, want, what: str, every_kernel: bool = True) -> None:
    """Every flash kernel's launches by shape against the plan, each kernel
    launched at least once (with ``every_kernel``; a call without guidance
    runs no backward)."""
    for key in sorted(set(got) | set(want)):
        g, w = got.get(key, 0), want.get(key, 0)
        if key[0] in PRODUCTS:
            print(f"  {key[0]} {list(key[1])}: {g} (plan: {w})")
            require(g == w, f"{what}: {key[0]} {list(key[1])}: {g} launches, the plan says {w}")
    for name in PRODUCTS if every_kernel else ():
        require(sum(c for (k, _), c in got.items() if k == name) > 0,
                f"{what}: {name} never launched")


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
    from distdiff_tpu_torch.models.init import init_weights
    from distdiff_tpu_torch.ops import attention, flash
    from distdiff_tpu_torch.sampling import ExpansionPipeline, SamplerConfig

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


FP32_TOL = 1e-3  # fp32 card against fp32 CPU (see agree_fp32)


def tiny_fp32_pipes(seed: int = 8, edit=None):
    """The fp32 tiny() pipeline (the VAE at width 160, so that its mid-block
    takes the split dq/dkv pair; ``edit(config)`` changes it further) on the
    CPU and on the card with the same weights; guided-expand inputs; and a
    CPU generator for the draws."""
    import dataclasses

    import torch

    from distdiff_tpu_torch.config import GuidanceConfig, PipelineConfig, VAEConfig
    from distdiff_tpu_torch.models.guide import create_model
    from distdiff_tpu_torch.models.init import init_weights
    from distdiff_tpu_torch.sampling import ExpansionPipeline, SamplerConfig

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    cfg = dataclasses.replace(PipelineConfig.tiny(sample_size=48), vae=VAEConfig(
        block_out_channels=(16, 160), layers_per_block=1, dtype=torch.float32))
    if edit is not None:
        cfg = edit(cfg)
    guides = [create_model("tiny_resnet", num_classes=3, device=d) for d in ("cpu", dev)]
    init_weights(guides[0].module, gen)
    guides[1].module.load_state_dict(guides[0].module.state_dict())
    fd = guides[0].feature_dim
    gp, lp = torch.randn(3, fd, generator=gen), torch.randn(3, 2, fd, generator=gen)
    pipes = [ExpansionPipeline.create(
        cfg, sampler_cfg=SamplerConfig(guidance_scale=3.0),
        guidance_cfg=GuidanceConfig(guidance_step=4, guidance_period=2, K=2,
                                    guide_input_size=32, rho=0.5),
        guide=g, global_protos=gp, local_protos=lp, strength=0.5, seed=seed, device=d)
        for g, d in zip(guides, ("cpu", dev))]
    for name in ("unet", "vae", "text_encoder"):
        getattr(pipes[1], name).load_state_dict(getattr(pipes[0], name).state_dict())
    ls = cfg.latent_size
    inputs = (torch.randn(2, ls, ls, 4, generator=gen) * 0.2,
              torch.randn(2, 16, 32, generator=gen), torch.randn(2, 16, 32, generator=gen),
              torch.tensor([1, 2]))
    return pipes, inputs, gen


def tiny_expand(pipe, device, inputs, draws, split=False) -> list:
    """The guided expand of ``pipe`` on ``device`` from the CPU's inputs and
    draws, through ``make_expand_fn`` (or ``SplitExpand``): the image, and
    the updated latents (transform guidance) and the score, on the CPU."""
    if split:
        img = pipe.make_split_expand()(*(t.to(device) for t in inputs),
                                       **{k: v.to(device) for k, v in draws.items()})
        return [img.float().cpu()]
    img, aux = pipe.make_expand_fn()(
        *(t.to(device) for t in inputs), return_aux=True,
        **{k: v.to(device) for k, v in draws.items()})
    if "latents_after" not in aux:  # direct guidance: the image and the score
        return [t.float().cpu() for t in (img, aux["score"])]
    return [t.float().cpu() for t in (img, aux["latents_after"], aux["score"])]


def agree_fp32(what_got_want) -> None:
    """fp32 on both sides (TF32 off); only the summation order differs
    (cuDNN/cuBLAS and the kernels' tiles against the CPU's), ~1e-6 a layer;
    1e-3 covers its growth through 7 UNet calls, the guidance gradient (rho
    0.5) and the decode. The score is held relative to its size."""
    for what, g, w in what_got_want:
        scale = float(w.abs().max()) if what == "guidance score" else 1.0
        err = float((g - w).abs().max()) / scale
        ok = math.isfinite(err) and err <= FP32_TOL
        print(f"  {what}{' (relative)' if scale != 1.0 else ''}: card against CPU "
              f"{err:.3e} (tol {FP32_TOL:.1e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"the fp32 card run strays from the CPU run on {what}")


def fp32_agreement_phase() -> None:
    """The fp32 tiny() pipeline's guided expand on the card, through every
    kernel (flash in fp32; the VAE at width 160 so that its mid-block takes
    the split dq/dkv pair), against the same port on the CPU (plain
    versions) with the same weights and the same draws, made on the CPU.
    The card runs it twice: with the card's shared-memory limit (every
    norm fits gn_fused) and with the limit set to 0 (every norm takes
    gn_stats + gn_apply); then once with ``guidance_type="direct_guidance"``
    against the CPU's direct-guided run."""
    import dataclasses

    import torch

    from distdiff_tpu_torch.ops import flash
    from distdiff_tpu_torch.ops import groupnorm as gn

    dev = torch.device("cuda")
    pipes, inputs, gen = tiny_fp32_pipes()
    draws = dict(zip(("noise", "gamma0", "beta0"), pipes[0].draw_inputs(inputs[0], gen)))

    def run(pipe, device):
        return tiny_expand(pipe, device, inputs, draws)

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
        fwd = {shape: c for (name, shape), c in flash.launch_shapes.items() if name == "flash_fwd"}
        for shape, c in sorted(fwd.items()):
            print(f"  flash_fwd fp32 {list(shape)}: {c} launches, "
                  f"{'%s (padded width %d)' % flash.f32_fwd_kernel(shape[3])}")
        require(any(flash.f32_fwd_kernel(shape[3])[0] == "flash_fwd_f32_wide_kernel"
                    for shape in fwd), "no fp32 attention took the wide tensor-core kernel")
        narrow = [shape for shape in fwd if shape[3] <= 128]
        require(narrow and all(flash.f32_fwd_kernel(shape[3])[0] == "flash_fwd_f32_narrow_kernel"
                               for shape in narrow),
                "an fp32 forward at D <= 128 did not take the narrow tensor-core kernel")
        fused = {shape: c for (name, shape), c in flash.launch_shapes.items()
                 if name == "flash_bwd_fused"}
        for shape, c in sorted(fused.items()):
            print(f"  flash_bwd_fused fp32 {list(shape)}: {c} launches, "
                  f"{'%s (padded width %d)' % flash.f32_fused_kernel(shape[3])}")
        require(fused and all(flash.f32_fused_kernel(shape[3])[0] == "flash_bwd_fused_f32_kernel"
                              for shape in fused),
                "an fp32 fused backward did not take the tensor-core kernel")
        pair = {(name, shape): c for (name, shape), c in flash.launch_shapes.items()
                if name in ("flash_bwd_dq", "flash_bwd_dkv")}
        for (name, shape), c in sorted(pair.items()):
            print(f"  {name} fp32 {list(shape)}: {c} launches, "
                  f"{'%s (padded width %d)' % flash.f32_split_kernel(shape[3])}")
        require(pair and all(flash.f32_split_kernel(shape[3])[0] == "flash_bwd_f32_split_kernel"
                             for _, shape in pair),
                "an fp32 split launch did not take the tensor-core kernel")
        agree_fp32(zip(("image", "updated latents", "guidance score"), got, want))
    print(f"  (CPU run {cpu_s:.1f} s)")
    require(all(c > 0 for c in launched.values()), f"a kernel was not launched: {launched}")

    # direct guidance (the latents' own gradient through the same kernels),
    # once, the norms by gn_fused, against the CPU at the same tolerance
    for pipe in pipes:
        pipe.guidance_cfg = dataclasses.replace(pipe.guidance_cfg,
                                                guidance_type="direct_guidance")
    want = run(pipes[0], "cpu")
    flash.reset_launch_counts()
    gn.reset_launch_counts()
    got = run(pipes[1], dev)
    torch.cuda.synchronize()
    counts = dict(flash.launch_counts, **gn.launch_counts)
    print(f"  fp32 tiny expand with direct guidance on the card: launches {counts}")
    for (name, shape), c in sorted(flash.launch_shapes.items()):
        if name == "flash_bwd_fused":
            print(f"  flash_bwd_fused fp32 {list(shape)}: {c} launches, "
                  f"{'%s (padded width %d)' % flash.f32_fused_kernel(shape[3])}")
    require(counts["flash_bwd_fused"] > 0 and counts["gn_fused"] > 0,
            f"direct guidance did not run through the kernels: {counts}")
    agree_fp32(zip(("image", "guidance score"), got, want))


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
    SD-1.5 geometry: the guided expand at batch 2 (phases 4 and 6), the same
    split with guide_chunk=1 (phase 5), the VAE encode of phase 5's 512^2
    images, and phase 6's dataset encode (CLI_ENCODE_BATCH images a call)."""
    from distdiff_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig.sd15()
    pipe = _recipe_pipe(cfg)
    return (expand_gn_calls(pipe, BATCH) + expand_gn_calls(pipe, BATCH, guide_chunk=1)
            + [(1, BATCH, vae_encode_norms(cfg.vae, cfg.sample_size)),
               (-(-CLI_CLASSES * CLI_TRAIN // CLI_ENCODE_BATCH), CLI_ENCODE_BATCH,
                vae_encode_norms(cfg.vae, cfg.sample_size))])


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


CLI_CLASSES = 100
CLI_TRAIN = 3   # train images a class: 300 latents
CLI_TEST = 1
CLI_DROPPED = ("BACKGROUND_Google", "Faces_easy")  # the caltech loader drops these
CLI_UNITS = 4
CLI_BATCH = 2
CLI_K = 3
CLI_ENCODE_BATCH = 8  # SDDataset's encode_batch, as the CLI leaves it (a short chunk is padded)


def save_png_filtered(path: str, image01) -> None:
    """``image01`` rounded as ``save_png`` rounds it, written with Paeth (4)
    and Average (3) scanline filters on alternate rows. An adaptive encoder
    (libpng's, so PIL's) writes most rows of a photograph so, and the
    decoder cannot undo those a row at once; ``save_png`` writes filter 0
    only."""
    import os
    import struct
    import zlib

    import numpy as np

    from distdiff_tpu_torch.data.datasets import PNG_SIGNATURE

    arr = np.clip(np.asarray(image01) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    h, w, c = arr.shape
    x = arr.reshape(h, w * c).astype(np.int16)
    up, left, upleft = (np.zeros_like(x) for _ in range(3))
    up[1:] = x[:-1]
    left[:, c:] = x[:, :-c]
    upleft[:, c:] = up[:, :-c]
    pa, pb, pc = np.abs(up - upleft), np.abs(left - upleft), np.abs(left + up - 2 * upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    ftype = np.where(np.arange(h) % 2 == 0, 4, 3)[:, None]
    raw = (x - np.where(ftype == 4, paeth, (left + up) >> 1)) % 256
    rows = np.concatenate([ftype, raw], axis=1).astype(np.uint8)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


def write_caltech_tree(data_root: str, classes: int = CLI_CLASSES, train: int = CLI_TRAIN,
                       test: int = CLI_TEST, seed: int = 0, sizes=(200, 400)) -> list:
    """``{data_root}/caltech-101/{train,test}/{class}/*.png``: ``classes``
    classes of ``train`` + ``test`` seeded images, each side between
    ``sizes`` pixels and never square (so that Resize scales and RandomCrop
    crops), plus the two classes the loader drops. The odd classes are
    written with Paeth and Average rows (``save_png_filtered``), the even
    ones with filter 0 (``save_png``). Returns the kept class directory
    names."""
    import os

    import numpy as np

    from distdiff_tpu_torch.parallel import save_png

    rng = np.random.default_rng(seed)
    names = [f"class_{i:03d}" for i in range(classes)]
    for split, n in (("train", train), ("test", test)):
        for ci, name in enumerate(names + list(CLI_DROPPED)):
            write = save_png_filtered if ci % 2 else save_png
            for i in range(n):
                h = int(rng.integers(sizes[0], sizes[1] + 1))
                w = int(rng.integers(sizes[0], sizes[1]))
                w += w >= h  # never square
                y, x = np.mgrid[0:h, 0:w].astype(np.float32)
                freq = rng.uniform(0.005, 0.05, (2, 3)).astype(np.float32)
                phase = rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
                img = 0.5 + 0.4 * np.sin(y[..., None] * freq[0] + x[..., None] * freq[1] + phase)
                img += rng.uniform(-0.1, 0.1, (h, w, 3)).astype(np.float32)
                write(os.path.join(data_root, "caltech-101", split, name,
                                   f"image_{i:04d}.png"), img)
    return names


def write_guide_checkpoint(path: str, num_classes: int = CLI_CLASSES, seed: int = 0) -> dict:
    """A ResNet-50 guide in the reference's ``checkpoint.pth.tar`` form: a
    dict with ``state_dict`` of ``module.``-prefixed torchvision keys (the
    reference trains under DataParallel), seeded weights and running
    statistics. Returns the state dict without the prefix."""
    import torch

    from distdiff_tpu_torch.models.guide.resnet import ResNet, resnet50_config
    from distdiff_tpu_torch.models.init import init_weights

    gen = torch.Generator().manual_seed(seed)
    module = ResNet(resnet50_config(num_classes), device="cpu")
    init_weights(module, gen)
    state = module.state_dict()
    for k, v in state.items():
        if k.endswith("running_mean"):
            v.copy_(torch.randn(v.shape, generator=gen) * 0.1)
        elif k.endswith("running_var"):
            v.copy_(torch.rand(v.shape, generator=gen) + 0.5)
    torch.save({"epoch": 100, "arch": "resnet50", "best_acc": 0.0,
                "state_dict": {"module." + k: v for k, v in state.items()}}, path)
    return state


def cli_argv(data_root: str, checkpoint: str, guide_path: str, output_dir: str,
             units: int = CLI_UNITS) -> list:
    """The published recipe (``distdiff_tpu/cli/generate_data.py``'s usage)
    on the written tree, checkpoint and guide, cut to ``units`` images."""
    return ["-d", "caltech-101", "--data_root", data_root, "--sd_checkpoint", checkpoint,
            "-a", "resnet50", "--encoder_weight_path", guide_path,
            "--guidance_type", "transform_guidance", "--strength", "0.5", "--K", str(CLI_K),
            "--rho", "10.0", "--guidance_step", "20", "--guidance_period", "2",
            "--constraint_value", "0.2", "--num_images_per_prompt", "1",
            "--train_batch_size", str(CLI_BATCH), "--max_units", str(units),
            "--seed", "0", "--output_dir", output_dir]


def loaded_matches(module, written: dict, keys, what: str) -> None:
    """Each of ``keys``: the module's tensor equals the written one after
    the cast to the module's dtype."""
    import torch

    own = module.state_dict()
    for k in keys:
        got = own[k].detach().cpu()
        want = written[k].to(got.dtype)
        require(got.shape == want.shape and torch.equal(got, want),
                f"{what} {k}: the loaded tensor differs from the written one")


def cli_phase(checkpoint: str) -> dict:
    """``distdiff_tpu_torch.cli.generate_data.main`` on the published recipe,
    in a temporary working directory: an SD-1.5 fp16 diffusers-layout
    checkpoint written to ``checkpoint`` (``weights/synth.py``, with its
    CLIP tokenizer files; phases 10 and 11 read it too), a
    ResNet-50 ``.pth.tar`` guide of 100 classes and a caltech-101 tree of
    PNGs written first; then the loaded weights, the tokenizer, the PNGs,
    the latent and prototype caches and the kernels' launches checked. The
    CLI's stages are timed through wrappers of its own functions."""
    import os
    import tempfile

    import numpy as np
    import torch

    import distdiff_tpu_torch.data as data_pkg
    import distdiff_tpu_torch.models as models_pkg
    from distdiff_tpu_torch.cli import generate_data as cli
    from distdiff_tpu_torch.data import load_image
    from distdiff_tpu_torch.models import CLIPTokenizer
    from distdiff_tpu_torch.ops import flash
    from distdiff_tpu_torch.ops import groupnorm as gn
    from distdiff_tpu_torch.parallel import read_png
    from distdiff_tpu_torch.weights import params_io
    from distdiff_tpu_torch.weights.convert import COMPONENTS
    from distdiff_tpu_torch.weights.synth import write_synth_checkpoint

    root = os.path.dirname(os.path.abspath(__file__))
    secs, seen = {}, {}
    with tempfile.TemporaryDirectory(dir=root, prefix=".smoke_cli_") as work:
        t0 = time.time()
        ckpt = write_synth_checkpoint(checkpoint, seed=0)
        secs["write checkpoint"] = time.time() - t0
        t0 = time.time()
        guide_path = os.path.join(work, "checkpoint", "model_best.pth.tar")
        os.makedirs(os.path.dirname(guide_path))
        guide_state = write_guide_checkpoint(guide_path)
        classes = write_caltech_tree(os.path.join(work, "data"))
        secs["write guide and PNG tree"] = time.time() - t0

        def timed(label, fn, keep=None):
            def wrapper(*a, **kw):
                t = time.time()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                secs[label] = time.time() - t
                if keep:
                    seen[keep] = out
                return out
            return wrapper

        patches = [(cli, "build_pipeline", timed("load weights", cli.build_pipeline, "pipe")),
                   (cli, "prepare_guide_and_prototypes",
                    timed("prototypes", cli.prepare_guide_and_prototypes, "guide")),
                   (data_pkg, "SDDataset", timed("dataset encode", data_pkg.SDDataset, "sd")),
                   (models_pkg, "load_tokenizer",
                    timed("tokenizer", models_pkg.load_tokenizer, "tokenizer")),
                   (params_io, "save_params",
                    timed("save parameter files", params_io.save_params))]
        saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
        cwd = os.getcwd()
        flash.reset_launch_counts()
        gn.reset_launch_counts()
        try:
            for obj, name, fn in patches:
                setattr(obj, name, fn)
            os.chdir(work)
            t0 = time.time()
            params_dir = os.path.join(work, "params")  # phase 12e reads it back
            stats = cli.main(cli_argv(os.path.join(work, "data"), ckpt, guide_path, "out")
                             + ["--save_params", params_dir])
            torch.cuda.synchronize()
            secs["whole CLI"] = time.time() - t0
        finally:
            os.chdir(cwd)
            for obj, name, fn in saved:
                setattr(obj, name, fn)
        counts = dict(flash.launch_counts, **gn.launch_counts)
        by_shape = collections.Counter(flash.launch_shapes) + collections.Counter(gn.launch_shapes)
        secs["driver"] = stats["seconds"]

        pipe, sd = seen["pipe"], seen["sd"]
        check_loaded(pipe, ckpt, COMPONENTS)
        guide = seen["guide"][0]
        gkeys = sorted(k for k in guide_state if not k.endswith("num_batches_tracked"))
        loaded_matches(guide.module, guide_state, gkeys[::max(1, len(gkeys) // 8)], "guide")
        print(f"  loaded tensors equal the written ones after the cast: UNet "
              f"{next(pipe.unet.parameters()).dtype}, guide fp32")
        require(isinstance(seen["tokenizer"], CLIPTokenizer),
                f"the CLI tokenised with {type(seen['tokenizer']).__name__}, not CLIP's BPE")
        require(sd.class_names == [c.replace("_", " ") for c in classes],
                "the caltech loader did not keep exactly the 100 written classes")
        pngs = sorted(os.path.join(d, f) for d, _, fs in os.walk(os.path.join(work, "out"))
                      for f in fs if f.endswith(".png"))
        require(stats["written"] == len(pngs) == CLI_UNITS,
                f"{stats['written']} written, {len(pngs)} PNGs, {CLI_UNITS} units")
        for path in pngs:
            png = read_png(path)
            require(png.shape == (512, 512, 3) and png.dtype == np.uint8,
                    f"{path}: {png.shape} {png.dtype}")
            require(png.max() > png.min(), f"{path} is one flat colour")
        latents = np.load(sd.cache_path("CompVis/stable-diffusion-v1-4", work))
        n_train = CLI_CLASSES * CLI_TRAIN
        require(latents.shape == (n_train, 64, 64, 4) and bool(np.isfinite(latents).all()),
                f"latent cache {latents.shape}, want {n_train} finite [64, 64, 4] latents")
        protos = np.load(os.path.join(work, cli.prototype_cache_path(
            "resnet50", "caltech-101", CLI_K)))
        gshape, lshape = protos["global_prototypes"].shape, protos["local_prototypes"].shape
        require(gshape == (CLI_CLASSES, 2048) and lshape == (CLI_CLASSES, CLI_K, 2048),
                f"prototype cache global {gshape}, local {lshape}")
        print(f"  {len(pngs)} PNGs of 512x512x3; latent cache {latents.shape}; prototype "
              f"cache global {gshape}, local {lshape}")
        # the decoder's cost an image on this host, one thread, by the rows'
        # filters (the dataset encode above decodes each train image once)
        decode_ms = {}
        for kind, parity in (("filter 0", 0), ("Paeth and Average", 1)):
            paths = [p for p, lab in zip(sd.image_paths, sd.labels) if lab % 2 == parity][:30]
            t0, px = time.perf_counter(), 0
            for path in paths:
                px += math.prod(load_image(path).shape[:2])
            decode_ms[kind] = (time.perf_counter() - t0) * 1e3 / len(paths)
            print(f"  PNG decode, one thread, {kind} rows: {decode_ms[kind]:.2f} ms an image "
                  f"(mean of {len(paths)}, {px / len(paths):.0f} pixels)")
        save_s = secs["save parameter files"]
        print(f"== 12e. the parameter files: phase 6's --save_params ({save_s:.2f} s), then "
              f"--params_path on the same tree")
        t0 = time.time()
        params = params_phase(work, ckpt, guide_path, params_dir, pipe)
        params["phase_s"] = time.time() - t0
        params["save_s"] = save_s
        print("== 14g. generate_data --mesh_model 2 on the same tree and caches")
        mesh_run = mesh_cli_phase(work, ckpt, guide_path)
    for name in REPLACES:
        require(counts.get(name, 0) > 0, f"{name} was not launched by the CLI run: {counts}")
    print(f"  launches over the CLI run: {counts}")
    return {"counts": counts, "by_shape": by_shape, "secs": secs, "stats": stats,
            "decode_ms": decode_ms, "params": params, "mesh": mesh_run}


# ------------------------------------------------------------- phase 7

TRAIN_EPOCHS = 1          # the first run; a resume adds a second
TRAIN_EXPANDED_EPOCHS = 1
TRANSFORM_TRAIN = 1       # train images a class in the cli.train_transform runs
# card against CPU, fp32 with TF32 off, each step from the CPU's state; each
# limit lies between the sound run's reading and the TF32 control's (NVIDIA
# H100, PERF.md's PR 15 section): loss 1.1e-7 / 7.95e-5, statistics 1.19e-7
# (one ulp at 1) / 1.02e-4, steps 3.64e-3 (a flipped ReLU gradient) / 0.117
TRAIN_LOSS_TOL = 3e-6     # relative, each step's loss and the eval's loss sum
TRAIN_STATS_TOL = 3e-6    # absolute, every running mean and variance after a step
TRAIN_UPDATE_TOL = 2e-2   # each parameter's step: |card - CPU| / |the CPU's step| (L2)


def train_argv(data_root: str, run_dir: str, epochs: int, extra=()) -> list:
    """``cli.train`` at the JAX package's defaults (ResNet-50, 224^2, train
    batch 64, test batch 100, SGD lr 0.1, momentum 0.9, Nesterov, weight
    decay 5e-4, the cosine) on the written caltech-101 tree, cut to
    ``epochs`` epochs."""
    return ["-d", "caltech-101", "--data_root", data_root, "--epochs", str(epochs),
            "--manualSeed", "1", "--checkpoint", run_dir, *extra]


def write_expanded_tree(root: str, class_names, stems: int = 1, side: int = 512) -> int:
    """A tree in the layout ``ExpansionDriver`` writes,
    ``{root}/{class name}/{stem}_expand_{i}.png``: the ``_expand_0`` image of
    each of ``stems`` originals a class (``image_0000`` on), seeded
    ``side``-pixel images written as ``ExpansionDriver`` writes them
    (``save_png``, filter 0). Returns the count."""
    import os

    import numpy as np

    from distdiff_tpu_torch.parallel import save_png

    rng = np.random.default_rng(1)
    y, x = np.mgrid[0:side, 0:side].astype(np.float32)
    for name in class_names:
        for i in range(stems):
            freq = rng.uniform(0.005, 0.05, (2, 3)).astype(np.float32)
            img = 0.5 + 0.4 * np.sin(y[..., None] * freq[0] + x[..., None] * freq[1])
            save_png(os.path.join(root, name, f"image_{i:04d}_expand_0.png"), img)
    return len(class_names) * stems


class TimedLoader:
    """A loader whose iteration adds up the seconds the caller waited for
    each batch (``wait_s``)."""

    def __init__(self, loader):
        self.loader = loader
        self.wait_s = 0.0

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.wait_s += time.perf_counter() - t0
            yield batch


def epoch_lrs(*epochs_per_call: int, lr: float = 0.1) -> list:
    """The learning rates ``log.txt`` prints for a run of successive CLI
    calls (each resuming the last) of these ``--epochs``: the per-epoch
    cosine over the call's own ``--epochs``."""
    out = []
    for total in epochs_per_call:
        out += [lr * 0.5 * (1 + math.cos(math.pi * e / total)) for e in range(len(out), total)]
    return out


def check_run(run_dir: str, lrs: list) -> dict:
    """The artifacts of a trainer run: ``log.txt`` (the five columns, one
    finite row an epoch, the learning rates ``lrs``),
    ``results.yaml`` (the best and last valid accuracy of the log),
    ``checkpoint.pth.tar`` (its keys, its epoch, its best accuracy) and
    ``model_best.pth.tar`` (there exactly when the best accuracy is above
    0). Returns the results."""
    import os

    import torch

    from distdiff_tpu_torch.cli.parse_logs import read_results
    from distdiff_tpu_torch.train.loops import LOG_COLUMNS

    with open(os.path.join(run_dir, "log.txt")) as f:
        lines = f.read().splitlines()
    require(lines[0].split("\t") == LOG_COLUMNS, f"{run_dir}/log.txt header {lines[0]!r}")
    rows = [[float(v) for v in line.split("\t")] for line in lines[1:]]
    epochs = len(lrs)
    require(len(rows) == epochs, f"{run_dir}/log.txt has {len(rows)} rows, want {epochs}")
    for e, (row, lr) in enumerate(zip(rows, lrs)):
        require(all(math.isfinite(v) for v in row), f"{run_dir} epoch {e + 1}: {row}")
        require(abs(row[0] - lr) <= 1e-6, f"{run_dir} epoch {e + 1}: lr {row[0]}, want {lr}")
    results = read_results(os.path.join(run_dir, "results.yaml"))
    valid = [row[4] for row in rows]
    require(abs(results["last_accuracy"] - valid[-1]) <= 1e-4
            and results["best_accuracy"] >= max(valid) - 1e-4,
            f"{run_dir}: results {results} against the log's valid accuracy {valid}")
    saved = torch.load(os.path.join(run_dir, "checkpoint.pth.tar"), map_location="cpu",
                       weights_only=True)
    require(sorted(saved) == ["best_acc", "epoch", "optimizer", "state_dict"]
            and saved["epoch"] == epochs
            and abs(saved["best_acc"] - results["best_accuracy"]) <= 1e-9,
            f"{run_dir}/checkpoint.pth.tar: epoch {saved.get('epoch')}, keys {sorted(saved)}")
    # the trainer writes model_best.pth.tar only in an epoch that beats the
    # best so far, which starts at 0% (the reference's rule): at chance on 100
    # classes a short run may never beat it, and then there is none
    has_best = os.path.exists(os.path.join(run_dir, "model_best.pth.tar"))
    require(has_best == (results["best_accuracy"] > 0),
            f"{run_dir}: model_best.pth.tar {'present' if has_best else 'absent'} at best "
            f"accuracy {results['best_accuracy']}")
    return results


def train_agreement(label: str, cfg, batches, start, strict: bool = True,
                    stage=None) -> dict:
    """``tiny_resnet`` training steps in fp32 on the card and on the CPU
    under ``cfg``, the card starting each step from the CPU's state
    (weights, statistics and optimiser) on the same batch, then the eval
    step. ``stage``, ``(loss_fn, on_batch)`` of ``cli.train_transform``'s
    ``batch_stage``, replaces the loss and prepares each batch once for
    both devices (mixup's and cutmix's draws, AugMix's packed views).
    Returns the largest reading of each kind: ``loss`` (relative),
    ``stats`` (absolute), ``update`` (each parameter's step, relative) and
    ``acc_flips`` (steps and eval sums whose accuracy differs; with
    ``strict`` one fails), and ``stats_moved``, the running statistics the
    CPU's steps moved. Whatever the CPU's step leaves unchanged (the
    frozen backbone's parameters, a step inside an accumulation) must stay
    bit for bit unchanged on the card.

    Only the forward's numbers (loss, statistics) are continuous in the
    rounding; the gradient is not: where a ReLU's input lies within fp32
    rounding of 0, or two max-pool inputs within rounding of a tie, the
    devices' summation orders may route a gradient on one and not the
    other (seen at -7.0e-7 against +9.6e-8 in fp64, 9% of a BatchNorm
    bias's gradient). So precision is held on the loss and statistics,
    and a parameter's step only to the size of the step, which catches an
    optimiser fault (learning rate, schedule, momentum, decay,
    accumulation); free-running trajectories are not compared."""
    import copy

    import torch

    from distdiff_tpu_torch.models.guide import create_model
    from distdiff_tpu_torch.train import (
        create_train_state,
        make_eval_step,
        make_optimizer,
        make_train_step,
    )

    n_cls = start["fc.weight"].shape[0]
    loss_fn, on_batch = stage or (None, None)
    sides = []
    for dev in ("cpu", "cuda"):
        gm = create_model("tiny_resnet", n_cls, device=dev, trainable=True)
        gm.module.load_state_dict(start)
        tx = make_optimizer(gm.module, cfg, steps_per_epoch=len(batches))
        sides.append((create_train_state(gm.module, tx),
                      make_train_step(gm.module, tx, loss_fn=loss_fn), make_eval_step(gm.module)))
    (cpu, cpu_step, cpu_eval), (card, card_step, card_eval) = sides
    params = {k for k, _ in cpu.module.named_parameters()}
    read = {"loss": 0.0, "stats": 0.0, "update": 0.0, "acc_flips": 0, "stats_moved": 0}
    staged = []
    for i, batch in enumerate(batches):
        x, y, m = on_batch(*batch) if on_batch else batch
        staged.append((x, y, m))
        card.module.load_state_dict(cpu.module.state_dict())
        card.tx.load_state_dict(copy.deepcopy(cpu.tx.state_dict()))
        before = {k: v.detach().clone() for k, v in cpu.module.state_dict().items()}
        _, want = cpu_step(cpu, x, y, m)
        _, got = card_step(card, x, y, m)
        if float(got["acc"]) != float(want["acc"]):
            read["acc_flips"] += 1
            require(not strict, f"train step {label} {i}: accuracy {float(got['acc'])} on "
                    f"the card, {float(want['acc'])} on the CPU")
        read["loss"] = max(read["loss"], abs(float(got["loss"]) / float(want["loss"]) - 1.0))
        after = {k: v.cpu() for k, v in card.module.state_dict().items()}
        for k, v in cpu.module.state_dict().items():
            if not v.is_floating_point() or torch.equal(v, before[k]):
                require(torch.equal(after[k], v), f"{label} {i}: {k} is {after[k]} on "
                        f"the card, {v} on the CPU" if v.ndim == 0 else
                        f"{label} {i}: {k} moved on the card, not on the CPU")
            elif k in params:
                step = float((v - before[k]).norm())
                read["update"] = max(read["update"], float((after[k] - v).norm()) / step)
            else:
                read["stats"] = max(read["stats"], float((after[k] - v).abs().max()))
                read["stats_moved"] += 1
        if cfg.train_fc_only:
            moved = [k for k in params if not k.startswith("fc.")
                     and not torch.equal(after[k], before[k])]
            require(not moved, f"train_fc moved the backbone's parameters: {moved[:4]}")
    card.module.load_state_dict(cpu.module.state_dict())
    cev = [float(v) for v in cpu_eval(*staged[0])]
    gev = [float(v) for v in card_eval(*staged[0])]
    if gev[:3] != cev[:3]:
        read["acc_flips"] += 1
        require(not strict, f"eval step {label}: {gev} on the card, {cev} on the CPU")
    read["loss"] = max(read["loss"], abs(gev[3] / cev[3] - 1.0))
    return read


def train_agreement_phase() -> dict:
    """``train_agreement`` plain, with ``accumulate=2`` and with
    ``train_fc`` (whose running statistics move, its backbone's parameters
    not) on 5 batches of 16 (the last a tail of 11, padded as the loader
    pads); then the steps of ``cli.train_transform``'s mixup, cutmix and
    augmix (``batch_stage``) on the last two of them (augmix's with three
    views an item); each reading held to its limit. Then the plain case
    with TF32 on, the control, which must fail every limit: a limit it
    passes would let a lower precision through."""
    import numpy as np
    import torch

    from distdiff_tpu_torch.cli.train_transform import batch_stage
    from distdiff_tpu_torch.device import disable_tf32
    from distdiff_tpu_torch.models.guide import create_model
    from distdiff_tpu_torch.train import TrainConfig

    disable_tf32()
    n_cls, b, side = 10, 16, 64
    rng = np.random.default_rng(0)
    batches = []
    for i in range(5):
        x = rng.standard_normal((b, side, side, 3)).astype(np.float32)
        y = rng.integers(0, n_cls, b).astype(np.int32)
        m = np.ones(b, bool)
        if i == 4:  # a tail of 11, padded as the loader pads
            x[11:], y[11:], m[11:] = x[10], y[10], False
        batches.append((x, y, m))
    start = create_model("tiny_resnet", n_cls, device="cpu", trainable=True).module.state_dict()
    limits = {"loss": TRAIN_LOSS_TOL, "stats": TRAIN_STATS_TOL, "update": TRAIN_UPDATE_TOL}

    def show(read):
        return ", ".join(f"{k} {read[k]:.3e} (limit {tol:g})" for k, tol in limits.items())

    views = [(np.stack([x, x[:, :, ::-1], -x], 1), y, m) for x, y, m in batches[3:]]
    cases = [(label, cfg, batches, None) for label, cfg in (
        ("plain", TrainConfig(epochs=2)), ("accumulate 2", TrainConfig(epochs=2, accumulate=2)),
        ("train_fc", TrainConfig(epochs=2, train_fc_only=True)))]
    for label in ("mixup", "cutmix", "augmix"):
        loss_fn, on_batch, _ = batch_stage(label, np.random.default_rng(1))
        cases.append((label, TrainConfig(epochs=2), views if label == "augmix" else batches[3:],
                      (loss_fn, on_batch)))
    out = {}
    for label, cfg, data, stage in cases:
        read = out[label] = train_agreement(label, cfg, data, start, stage=stage)
        for k, tol in limits.items():
            require(read[k] <= tol, f"train step {label}: {k} {read[k]:.3e} from the CPU, "
                    f"over {tol}")
        require(read["stats_moved"] > 0, f"train step {label}: no running statistic moved")
        print(f"  {label}: {len(data)} steps of batch {b} and the eval, card against CPU: "
              f"{show(read)}; {read['stats_moved']} statistics moved")
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        read = out["control, TF32 on"] = train_agreement(
            "control", TrainConfig(epochs=2), batches, start, strict=False)
    finally:
        disable_tf32()
    over = {k: read[k] / tol for k, tol in limits.items()}
    print(f"  control, plain with TF32 on: {show(read)}; {read['acc_flips']} accuracies "
          f"differ; " + ", ".join(f"{k} {x:.1f}x" for k, x in over.items()) + " its limit")
    require(min(over.values()) > 1.0, f"the TF32 control passed a limit ({over}): it "
            f"would not catch a lower precision")
    return out


def train_step_timing(card: str, steps: int = 10) -> dict:
    """The train step alone, the step metric: ResNet-50 (100 classes) in
    fp32 with TF32 off, SGD at the CLI's defaults, one batch of 64 224^2
    images already on the card, ``steps`` steps after two warm ones, each
    timed between CUDA events. No loader runs beside it."""
    import torch

    from distdiff_tpu_torch.device import disable_tf32
    from distdiff_tpu_torch.models.guide import create_model
    from distdiff_tpu_torch.train import (
        TrainConfig,
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    disable_tf32()
    gm = create_model("resnet50", CLI_CLASSES, device="cuda", trainable=True)
    tx = make_optimizer(gm.module, TrainConfig(epochs=1), steps_per_epoch=steps + 2)
    state, step = create_train_state(gm.module, tx), make_train_step(gm.module, tx)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(64, 224, 224, 3, device="cuda", generator=g)
    y = torch.randint(0, CLI_CLASSES, (64,), device="cuda", generator=g)
    m = torch.ones(64, dtype=torch.bool, device="cuda")
    ms, losses = [], []
    for i in range(steps + 2):
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        state, metrics = step(state, x, y, m)
        ev[1].record()
        ev[1].synchronize()
        losses.append(float(metrics["loss"]))
        if i >= 2:
            ms.append(ev[0].elapsed_time(ev[1]))
    require(all(math.isfinite(v) for v in losses), f"train step losses {losses}")
    out = {"step_ms": statistics.median(ms), "step_ms_runs": ms}
    out["images_per_s"] = 64e3 / out["step_ms"]
    print(f"  train step alone, ResNet-50 fp32 at batch 64, 224^2, on the card's batch: "
          f"{out['step_ms']:.2f} ms (median of {len(ms)}, {min(ms):.2f} to {max(ms):.2f}), "
          f"{out['images_per_s']:.1f} images/s ({card})")
    return out


class TrainerProbe:
    """Wrappers of the trainer's own functions, in place while the probe is
    entered: each CLI run (``start_run``) records its steps (host seconds,
    and device milliseconds between CUDA events), its epochs (wall time,
    loader waits, steps, items) and the module of each best checkpoint.

    Each wrapper goes where the trainer looks the function up when it
    runs: the CLIs import make_train_step from the package inside their
    bodies, fit calls run_epoch by its module-global name and the
    checkpoint writer as ``ckpt.save_train_checkpoint``. A refactor that
    binds one of them earlier bypasses its wrapper; the step and epoch
    counts and the saved modules then fail."""

    def __init__(self):
        self.steps, self.step_ms, self.epochs, self.best, self.last = [], [], [], {}, {}

    def start_run(self) -> None:
        self.steps.append([])
        self.step_ms.append([])
        self.epochs.append([])

    def __enter__(self):
        import copy

        import torch

        import distdiff_tpu_torch.train as train_pkg
        from distdiff_tpu_torch.train import loops
        from distdiff_tpu_torch.utils import checkpoints

        orig_step, orig_epoch = train_pkg.make_train_step, loops.run_epoch
        orig_save = checkpoints.save_train_checkpoint

        def timed_make_train_step(*a, **kw):
            step = orig_step(*a, **kw)

            def timed(state, images, targets, mask):
                t0 = time.perf_counter()
                ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                ev[0].record()
                out = step(state, images, targets, mask)
                ev[1].record()
                ev[1].synchronize()
                self.steps[-1].append(time.perf_counter() - t0)
                self.step_ms[-1].append(ev[0].elapsed_time(ev[1]))
                return out
            return timed

        def timed_run_epoch(train_step, state, loader, on_batch=None):
            timed_loader = TimedLoader(loader)
            t0 = time.perf_counter()
            out = orig_epoch(train_step, state, timed_loader, on_batch)
            torch.cuda.synchronize()
            self.epochs[-1].append({"wall_s": time.perf_counter() - t0,
                                    "loader_wait_s": timed_loader.wait_s, "steps": len(loader),
                                    "images": len(loader.dataset)})
            return out

        def keep_best(out_dir, state, epoch, best_acc, is_best):
            orig_save(out_dir, state, epoch, best_acc, is_best)
            self.last[out_dir] = copy.deepcopy(state.module).eval()
            if is_best:
                self.best[out_dir] = self.last[out_dir]

        self.saved = [(train_pkg, "make_train_step", orig_step),
                      (loops, "run_epoch", orig_epoch),
                      (checkpoints, "save_train_checkpoint", orig_save)]
        train_pkg.make_train_step = timed_make_train_step
        loops.run_epoch = timed_run_epoch
        checkpoints.save_train_checkpoint = keep_best
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self.saved:
            setattr(obj, name, fn)
        return False

    def show_epochs(self, labels, card: str) -> None:
        for label, eps in zip(labels, self.epochs):
            for e in eps:
                print(f"  {label} epoch: {e['steps']} steps, {e['images']} images in "
                      f"{e['wall_s']:.2f} s, {e['images'] / e['wall_s']:.1f} images/s, "
                      f"{e['loader_wait_s'] / e['wall_s']:.3f} of it waiting on the loader "
                      f"({card})")


def train_phase(card: str, work: str) -> dict:
    """``cli.train.main`` at ResNet-50 width on a caltech-101 PNG tree written
    first under ``work`` (100 classes, 3 train and 1 test image each, half
    with Paeth and Average rows), one epoch; a resume for a second;
    ``cli.train_expanded.main`` with a tree of 100 512^2 PNGs in
    ``ExpansionDriver``'s layout for one epoch; every artifact checked,
    the best checkpoint loaded as a guide against the module it saved,
    ``parse_logs`` on the run. The steps, epochs and loader waits are timed
    through ``TrainerProbe``. Returns the numbers, the tree and its class
    directory names."""
    import os

    import torch

    from distdiff_tpu_torch.cli import parse_logs
    from distdiff_tpu_torch.cli import train as train_cli
    from distdiff_tpu_torch.cli import train_expanded as expanded_cli
    from distdiff_tpu_torch.models.guide import create_model

    out = {}
    t0 = time.time()
    data = os.path.join(work, "data")
    classes = write_caltech_tree(data)
    n_exp = write_expanded_tree(os.path.join(work, "expanded"),
                                [c.replace("_", " ") for c in classes])
    out["write_s"] = time.time() - t0
    out["data"], out["classes"] = data, classes
    run = os.path.join(work, "checkpoint", "resnet50", "seed1")
    run_exp = os.path.join(work, "checkpoint", "resnet50_expanded", "seed1")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # what the earlier phases still hold
    runs = (("train", train_cli, train_argv(data, run, TRAIN_EPOCHS)),
            ("resume", train_cli, train_argv(data, run, TRAIN_EPOCHS + 1, ["--resume", run])),
            ("expanded", expanded_cli,
             train_argv(data, run_exp, TRAIN_EXPANDED_EPOCHS,
                        ["--data_expanded_dir", os.path.join(work, "expanded")])))
    with TrainerProbe() as probe:
        for label, cli, argv in runs:
            probe.start_run()
            t0 = time.time()
            result = cli.main(argv)
            torch.cuda.synchronize()
            out[f"{label}_main_s"] = time.time() - t0
            out[f"{label}_result"] = result
    steps, step_ms, epochs = probe.steps, probe.step_ms, probe.epochs
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["trainer_peak_bytes"] = out["peak_bytes"] - base

    per_epoch = -(-CLI_CLASSES * CLI_TRAIN // 64)
    require([len(e) for e in epochs] == [TRAIN_EPOCHS, 1, TRAIN_EXPANDED_EPOCHS],
            f"epochs run {[len(e) for e in epochs]}")
    require(len(steps[0]) == TRAIN_EPOCHS * per_epoch and len(steps[1]) == per_epoch,
            f"steps {[len(s) for s in steps]}, want {per_epoch} an epoch")
    require(len(steps[2]) == -(-(CLI_CLASSES * CLI_TRAIN + n_exp) // 64),
            f"the expanded run took {len(steps[2])} steps for "
            f"{CLI_CLASSES * CLI_TRAIN} + {n_exp} images")
    results = check_run(run, epoch_lrs(TRAIN_EPOCHS, TRAIN_EPOCHS + 1))
    check_run(run_exp, epoch_lrs(TRAIN_EXPANDED_EPOCHS))
    require(results == {k: float(v) for k, v in out["resume_result"].items()},
            f"results.yaml {results} against the run's {out['resume_result']}")
    perfs = parse_logs.main([run])
    require(perfs == [results["best_accuracy"]], f"parse_logs read {perfs}")

    # the best checkpoint through the guide loader, against the module it
    # saved: model_best.pth.tar, or where no epoch beat 0% (check_run) the
    # last epoch's checkpoint.pth.tar, which has the same layout
    require(run in probe.last and (run in probe.best) == (results["best_accuracy"] > 0),
            f"{run}: modules kept {sorted(probe.last)}, best {sorted(probe.best)}")
    name, module = (("model_best.pth.tar", probe.best[run]) if run in probe.best
                    else ("checkpoint.pth.tar", probe.last[run]))
    guide = create_model("resnet50", CLI_CLASSES, device="cuda",
                         weight_path=os.path.join(run, name))
    x = torch.randn(8, 224, 224, 3, generator=torch.Generator().manual_seed(0)).cuda()
    with torch.no_grad():
        diff = float((guide.module(x) - module(x)).abs().max())
    require(diff <= 1e-5, f"{name} as a guide is {diff:.3e} from the trained module")
    print(f"  {name} as a guide: logits {diff:.3e} from the module it saved")
    out["step_s"] = steps
    out["step_ms"] = step_ms
    out["epochs"] = epochs
    warm = [ms for run_ms in step_ms for ms in run_ms][1:]
    print(f"  train steps in the CLI runs, device time between events: first "
          f"{step_ms[0][0]:.2f} ms, then median {statistics.median(warm):.2f} ms, "
          f"{min(warm):.2f} to {max(warm):.2f} ms over {len(warm)} ({card})")
    probe.show_epochs(("train", "resume", "expanded"), card)
    out["images_per_s"] = (sum(e["images"] for eps in epochs for e in eps)
                           / sum(e["wall_s"] for eps in epochs for e in eps))
    print(f"  peak device memory {out['peak_bytes'] / 2**30:.2f} GiB, the trainer's "
          f"{out['trainer_peak_bytes'] / 2**30:.2f} GiB of it; trees written in "
          f"{out['write_s']:.2f} s; main {out['train_main_s']:.2f} s, resume "
          f"{out['resume_main_s']:.2f} s, expanded {out['expanded_main_s']:.2f} s ({card})")
    return out


def train_transform_phase(card: str, work: str) -> dict:
    """``cli.train_transform.main`` at the JAX defaults (ResNet-50, 224^2,
    batch 64, fp32) on a caltech-101 tree written first under ``work``
    (100 classes, TRANSFORM_TRAIN train and 1 test image each), cut to one
    epoch at ``--expand_num 0`` (the defaults: 100 epochs, 5): the
    original-only control of 100 images under each of the 8
    ``--transform_type`` values; then ``default`` over original ⊕ expanded
    at ``--expand_num 1``, a tree of one 512^2 ``_expand_0`` PNG an
    original image written first (200 items, the CLI's ratio assert). Each run's ``log.txt``,
    ``results.yaml`` and checkpoints checked and its steps counted; its
    images/s (items over the epoch's wall time; an AugMix item is three
    views), loader share and epoch seconds printed."""
    import os

    import torch

    from distdiff_tpu_torch.cli import train_transform as transform_cli

    t0 = time.time()
    data = os.path.join(work, "data_transform")
    classes = write_caltech_tree(data, train=TRANSFORM_TRAIN)
    expanded = os.path.join(work, "expanded_per_image")
    n_exp = write_expanded_tree(expanded, [c.replace("_", " ") for c in classes],
                                stems=TRANSFORM_TRAIN)
    out = {"write_s": time.time() - t0}
    n_orig = CLI_CLASSES * TRANSFORM_TRAIN
    require(n_exp == n_orig, f"{n_exp} expanded images for {n_orig} originals")
    runs = [(t, ["--transform_type", t, "--expand_num", "0"], n_orig)
            for t in transform_cli.TRANSFORM_TYPES]
    runs.append(("default+expanded", ["--transform_type", "default", "--expand_num", "1",
                                      "--data_expanded_dir", expanded], 2 * n_orig))
    with TrainerProbe() as probe:
        for label, extra, items in runs:
            probe.start_run()
            run_dir = os.path.join(work, "checkpoint", "transform", label)
            t0 = time.time()
            transform_cli.main(train_argv(data, run_dir, 1, extra))
            torch.cuda.synchronize()
            out[label] = {"main_s": time.time() - t0}
            check_run(run_dir, epoch_lrs(1))
            (epoch,) = probe.epochs[-1]
            require(epoch["images"] == items and len(probe.steps[-1]) == -(-items // 64),
                    f"{label}: {epoch['images']} items in {len(probe.steps[-1])} steps, "
                    f"want {items}")
            out[label].update(epoch=epoch, step_ms=probe.step_ms[-1])
    probe.show_epochs([label for label, _, _ in runs], card)
    for label, _, _ in runs:
        print(f"  {label}: main {out[label]['main_s']:.2f} s, steps median "
              f"{statistics.median(out[label]['step_ms']):.2f} ms ({card})")
    return out


def t2i_offset_phase() -> None:
    """The fp32 tiny() pipeline on the card against the CPU with the same
    injected draws (made on the CPU): ``make_expand_fn(text_to_img=True)``,
    then, with ``offset_noise`` on (the draws carry the offset),
    ``make_expand_fn`` and ``SplitExpand``; held to phase 3's tolerance."""
    import torch

    from distdiff_tpu_torch.ops import flash
    from distdiff_tpu_torch.ops import groupnorm as gn

    dev = torch.device("cuda")
    pipes, inputs, gen = tiny_fp32_pipes(seed=9)
    flash.reset_launch_counts()
    gn.reset_launch_counts()
    for label, text_to_img, offset, split in (("text_to_img, make_expand_fn", True, False, False),
                                              ("offset_noise, make_expand_fn", False, True, False),
                                              ("offset_noise, SplitExpand", False, True, True)):
        for pipe in pipes:
            pipe.offset_noise = offset
        draws = dict(zip(("noise", "gamma0", "beta0"), pipes[0].draw_inputs(inputs[0], gen)))
        out = []
        for pipe, device in zip(pipes, ("cpu", dev)):
            fn = (pipe.make_split_expand(text_to_img=text_to_img) if split
                  else pipe.make_expand_fn(text_to_img=text_to_img))
            img = fn(*(t.to(device) for t in inputs), **{k: v.to(device) for k, v in draws.items()})
            out.append(img.float().cpu())
        torch.cuda.synchronize()
        require(bool(torch.isfinite(out[1]).all()), f"{label}: non-finite image on the card")
        print(f"  {label}:")
        agree_fp32([("image", out[1], out[0])])
    counts = dict(flash.launch_counts, **gn.launch_counts)
    print(f"  launches over the three card runs: {counts}")
    require(counts["flash_fwd"] > 0 and counts["flash_bwd_fused"] > 0 and counts["gn_fused"] > 0,
            f"the fp32 runs did not go through the kernels: {counts}")


# ------------------------------------------------------------- phase 8

SD21_CLI_TRAIN = 1  # train images a class (3 in phase 6): 100 latents at 768^2
SD21_CLI_UNITS = 2  # one batch of 2 work units
# The eight rollout_remat modes against "step_nr" in bf16. Every mode
# recomputes the same forward, so the scores agree to 1e-4 of their size.
# The backward sums its bf16 gradients in another order where a mode
# checkpoints (a skip connection's two paths, the fused backward's dq
# atomics), which moves gamma's and beta's gradients by a few bf16 steps:
# 2^-5 of their largest magnitude. The updated latents, lat (1 + gamma) +
# beta with gamma and beta rho gradients from the draws, then move by at
# most rho (|d g_gamma| max|lat| + |d g_beta|), plus one bf16 step of
# their largest magnitude (2^-7).
MODE_SCORE_TOL = 1e-4
MODE_GRAD_TOL = 2.0 ** -5
MODE_LAT_STEP = 2.0 ** -7


def sd21_gn_calls() -> list:
    """(times, batch, norms) of every GroupNorm of phase 8's SD-2.1 runs:
    the guided expand at batch 2, 768^2 (the CLI's too), and the CLI's
    dataset encode at 768^2, CLI_ENCODE_BATCH images a call."""
    from distdiff_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig.sd21()
    return expand_gn_calls(_recipe_pipe(cfg), BATCH) + [sd21_encode_gn_call(cfg)]


def sd21_encode_gn_call(cfg) -> tuple:
    """(times, batch, norms) of the SD-2.1 CLI run's dataset encode."""
    return (-(-CLI_CLASSES * SD21_CLI_TRAIN // CLI_ENCODE_BATCH), CLI_ENCODE_BATCH,
            vae_encode_norms(cfg.vae, cfg.sample_size))


def gn_only(by_shape) -> dict:
    return {k: c for k, c in by_shape.items() if k[0] in GN_KERNELS}


def counted_call(fn):
    """``fn()`` with every launch count set to 0 just before and read just
    after: (its result, launches by (kernel, shape), seconds, peak bytes
    allocated over the call)."""
    import torch

    from distdiff_tpu_torch.ops import flash
    from distdiff_tpu_torch.ops import groupnorm as gn

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash.reset_launch_counts()
    gn.reset_launch_counts()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    secs = time.time() - t0
    by_shape = collections.Counter(flash.launch_shapes) + collections.Counter(gn.launch_shapes)
    return out, by_shape, secs, torch.cuda.max_memory_allocated()


def wall_s(fn) -> float:
    import torch

    t0 = time.time()
    fn()
    torch.cuda.synchronize()
    return time.time() - t0


def check_images(img, side: int, what: str) -> None:
    import torch

    require(tuple(img.shape) == (BATCH, side, side, 3), f"{what}: image shape {tuple(img.shape)}")
    require(bool(torch.isfinite(img).all()), f"{what}: non-finite image")
    require(float(img.min()) >= 0.0 and float(img.max()) <= 1.0, f"{what}: image outside [0, 1]")


def kernel_ms_of_call(records, by_shape, what: str) -> dict:
    """Each kernel's launches in a counted call and phase 2's time of them:
    launches x ms at each shape, summed."""
    out = {}
    for name in REPLACES:
        recs = {tuple(r["shape"]): r for r in records if r["name"] == name}
        launches = {shape: c for (k, shape), c in by_shape.items() if k == name}
        if not launches:
            continue
        ms = sum(recs[shape]["ms"] * c for shape, c in launches.items())
        bound = sum(recs[shape]["bound_ms"] * c for shape, c in launches.items())
        out[name] = {"launches": sum(launches.values()), "ms": ms, "bound_ms": bound}
        print(f"  {what} {name}: {out[name]['launches']} launches, {ms:.2f} ms of kernel time "
              f"a call by phase 2's times (bound {bound:.2f} ms)")
    return out


def sd21_phase(records, card: str) -> dict:
    """SD-2.1 768-v at full width (UNet 865.9M, heads 64 wide, 1024-wide
    context, linear projections; the SD-1.x VAE; v-prediction), seeded
    random weights, batch 2, 768^2, DDIM-50 at strength 0.5, CFG 7.5,
    transform guidance at plan index 30 over 2 steps: a warm-up call, a
    counted call (each kernel's launches by shape against the plan, peak
    memory) and one more timed calls."""
    import torch

    from distdiff_tpu_torch.config import PipelineConfig
    from distdiff_tpu_torch.ops import groupnorm as gn

    dev = torch.device("cuda")
    pipe, expand, inputs = build_path(PipelineConfig.sd21())
    require(pipe.sched.prediction_type == "v_prediction", "SD-2.1 is not v-prediction")

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    cold = wall_s(lambda: expand(*inputs, gen(1)))
    (img, aux), by_shape, secs, peak = counted_call(
        lambda: expand(*inputs, gen(2), return_aux=True))
    runs = [secs, wall_s(lambda: expand(*inputs, gen(3)))]
    warm = statistics.median(runs)
    print(f"  SD-2.1 768^2 expand batch {BATCH}: first call {cold:.2f} s, warm {warm:.3f} s/batch "
          f"(median of {[round(r, 3) for r in runs]}), peak memory {peak / 2**30:.2f} GiB "
          f"({card})")
    check_images(img, 768, "SD-2.1")
    for name in ("grad_gamma", "grad_beta"):
        g = aux[name]
        require(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0.0,
                f"SD-2.1: {name} is zero or not finite")
    moved = float((aux["latents_after"] - aux["latents_before"]).abs().max())
    require(moved > 0.0, "SD-2.1: guidance left the latents unchanged")
    print(f"  images in [{float(img.min()):.3f}, {float(img.max()):.3f}]; latents moved up to "
          f"{moved:.4f}; score {aux['score'].tolist()}")
    check_flash_plan(by_shape, flash_plan(pipe, BATCH), "phase 8 SD-2.1")
    check_gn_plan(gn_only(by_shape), gn_plan(expand_gn_calls(pipe, BATCH),
                                             smem_limit=gn._device_limits(dev)[0]))
    require_timed(records, by_shape, "phase 8 (SD-2.1)")
    kernels = kernel_ms_of_call(records, by_shape, "SD-2.1 call:")
    del pipe, expand, inputs, img, aux
    torch.cuda.empty_cache()
    return {"warm_s": warm, "runs": runs, "cold_s": cold, "peak_bytes": peak,
            "by_shape": by_shape, "kernels": kernels}


def sd21_cli_phase(records, card: str) -> dict:
    """``cli.generate_data.main --model sd21 --scheduler dpmpp --resolution
    768`` on the published recipe, from files written first: an SD-2.1 fp16
    diffusers-layout checkpoint (linear projections, the 23-layer OpenCLIP
    tower; 2.6 GB), a ResNet-50 guide of 100 classes and a caltech-101 PNG
    tree cut to SD21_CLI_TRAIN train images a class, and SD21_CLI_UNITS
    images. The loaded
    weights, the PNGs, the caches and every kernel's launches by shape
    against the plan (the dataset encode, then one SplitExpand call)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from distdiff_tpu_torch.cli import generate_data as cli
    from distdiff_tpu_torch.config import PipelineConfig
    from distdiff_tpu_torch.ops import groupnorm as gn
    from distdiff_tpu_torch.parallel import read_png
    from distdiff_tpu_torch.schedulers import DPMSchedule
    from distdiff_tpu_torch.weights.convert import COMPONENTS
    from distdiff_tpu_torch.weights.synth import write_synth_checkpoint

    dev = torch.device("cuda")
    root = os.path.dirname(os.path.abspath(__file__))
    secs, seen = {}, {}
    with tempfile.TemporaryDirectory(dir=root, prefix=".smoke_sd21_") as work:
        t0 = time.time()
        ckpt = write_synth_checkpoint(os.path.join(work, "sd21"), PipelineConfig.sd21(), seed=1)
        secs["write checkpoint"] = time.time() - t0
        t0 = time.time()
        guide_path = os.path.join(work, "checkpoint", "model_best.pth.tar")
        os.makedirs(os.path.dirname(guide_path))
        write_guide_checkpoint(guide_path)
        data = os.path.join(work, "data")
        write_caltech_tree(data, train=SD21_CLI_TRAIN)
        secs["write guide and PNG tree"] = time.time() - t0
        argv = cli_argv(data, ckpt, guide_path, "out", units=SD21_CLI_UNITS) + [
            "--model", "sd21", "--scheduler", "dpmpp", "--resolution", "768"]
        build = cli.build_pipeline

        def keep(*a, **kw):
            seen["pipe"] = build(*a, **kw)
            return seen["pipe"]

        cwd = os.getcwd()
        cli.build_pipeline = keep
        try:
            os.chdir(work)
            stats, by_shape, secs["whole CLI"], peak = counted_call(lambda: cli.main(argv))
        finally:
            os.chdir(cwd)
            cli.build_pipeline = build
        pipe = seen["pipe"]
        require(pipe.config.unet.linear_projection and pipe.config.sample_size == 768
                and isinstance(pipe.sched, DPMSchedule)
                and pipe.sched.prediction_type == "v_prediction",
                f"the CLI built {pipe.config}")
        check_loaded(pipe, ckpt, COMPONENTS)
        pngs = sorted(os.path.join(d, f) for d, _, fs in os.walk(os.path.join(work, "out"))
                      for f in fs if f.endswith(".png"))
        require(stats["written"] == len(pngs) == SD21_CLI_UNITS,
                f"{stats['written']} written, {len(pngs)} PNGs, {SD21_CLI_UNITS} units")
        for path in pngs:
            png = read_png(path)
            require(png.shape == (768, 768, 3) and png.max() > png.min(),
                    f"{path}: {png.shape}, flat {png.max() == png.min()}")
        n_train = CLI_CLASSES * SD21_CLI_TRAIN
        lat_path = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(work, "save"))
                    for f in fs if f.startswith("image_latents_768")]
        require(len(lat_path) == 1, f"latent caches {lat_path}")
        latents = np.load(lat_path[0])
        require(latents.shape == (n_train, 96, 96, 4) and bool(np.isfinite(latents).all()),
                f"latent cache {latents.shape}, want {n_train} finite [96, 96, 4] latents")
        protos = np.load(os.path.join(work, cli.prototype_cache_path(
            "resnet50", "caltech-101", CLI_K)))
        require(protos["local_prototypes"].shape == (CLI_CLASSES, CLI_K, 2048),
                f"prototype cache {protos['local_prototypes'].shape}")
    secs["driver"] = stats["seconds"]
    encodes = -(-n_train // CLI_ENCODE_BATCH)
    want = flash_plan(pipe, CLI_BATCH)
    want[("flash_fwd", (CLI_ENCODE_BATCH, 96 * 96, 96 * 96, 512))] += encodes
    check_flash_plan(by_shape, want, "phase 8 SD-2.1 CLI")
    check_gn_plan(gn_only(by_shape), gn_plan(
        expand_gn_calls(pipe, CLI_BATCH) + [sd21_encode_gn_call(pipe.config)],
        smem_limit=gn._device_limits(dev)[0]))
    require_timed(records, by_shape, "phase 8 (SD-2.1 CLI)")
    for stage, s in secs.items():
        print(f"  {stage}: {s:.2f} s ({card})")
    print(f"  {len(pngs)} PNGs of 768x768x3; latent cache {latents.shape}; peak memory "
          f"{peak / 2**30:.2f} GiB")
    del seen, pipe
    torch.cuda.empty_cache()
    return {"secs": secs, "stats": stats, "by_shape": by_shape, "peak_bytes": peak}


def sd15_solver_phase(records, card: str) -> dict:
    """SD-1.5 at batch 2 under ``dpmpp`` and under ``deep_cache`` (interval
    3, branch 0), each through ``make_expand_fn`` (a warm-up, a counted
    call, one more timed) and ``SplitExpand`` (a counted call, one more
    timed), each counted call's flash launches by shape against the plan.
    Returns the timings, the pipeline and its inputs."""
    import dataclasses

    import torch

    from distdiff_tpu_torch.schedulers import build_schedule

    dev = torch.device("cuda")
    pipe, _, inputs = build_path()

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def gens(seed):
        return [gen(seed + i) for i in range(BATCH)]

    out, by_shape = {}, collections.Counter()
    for label, kw in (("dpmpp", dict(scheduler="dpmpp")),
                      ("deep_cache", dict(deep_cache=True, cache_interval=3, cache_branch=0))):
        cfg = dataclasses.replace(pipe.config, **kw)
        vp = dataclasses.replace(pipe, config=cfg, sched=build_schedule(
            cfg.scheduler, cfg.num_inference_steps, prediction_type=cfg.prediction_type))
        fused, split = vp.make_expand_fn(), vp.make_split_expand()
        wall_s(lambda: fused(*inputs, gen(1)))
        img, shapes, secs, peak = counted_call(lambda: fused(*inputs, gen(2)))
        check_images(img, 512, label)
        check_flash_plan(shapes, flash_plan(vp, BATCH), f"phase 8 {label}, make_expand_fn")
        require_timed(records, shapes, f"phase 8 ({label})")
        runs = [secs, wall_s(lambda: fused(*inputs, gen(3)))]
        simg, sshapes, ssecs, speak = counted_call(lambda: split(*inputs, gens(10)))
        check_images(simg, 512, f"{label} SplitExpand")
        check_flash_plan(sshapes, flash_plan(vp, BATCH), f"phase 8 {label}, SplitExpand")
        require_timed(records, sshapes, f"phase 8 ({label} SplitExpand)")
        sruns = [ssecs, wall_s(lambda: split(*inputs, gens(20)))]
        by_shape += shapes + sshapes
        out[label] = {"warm_s": statistics.median(runs), "runs": runs, "peak_bytes": peak,
                      "split_runs": sruns, "split_peak_bytes": speak}
        print(f"  SD-1.5 {label} batch {BATCH}: make_expand_fn {statistics.median(runs):.3f} "
              f"s/batch (median of {[round(r, 3) for r in runs]}), SplitExpand "
              f"{[round(r, 3) for r in sruns]} s, peak {peak / 2**30:.2f} / "
              f"{speak / 2**30:.2f} GiB ({card})")
    return out, by_shape, pipe, inputs


def modes_phase(records, pipe, inputs, card: str) -> tuple:
    """The transform guidance update alone at SD-1.5 batch 2, plan index
    30, under each of the eight rollout_remat modes on the same latents and
    draws: a counted call (its flash launches by shape against the mode's
    plan, its peak memory) and one more timed; its updated latents,
    gradients and scores against "step_nr"'s."""
    import dataclasses

    import torch

    from distdiff_tpu_torch.config import ROLLOUT_REMAT_MODES
    from distdiff_tpu_torch.guidance import transform_guidance

    dev = torch.device("cuda")
    lat, cond, uncond, targets = inputs
    noise, gamma0, beta0 = pipe.draw_inputs(lat, torch.Generator(device=dev).manual_seed(7))
    start, _, _, g0, _ = pipe.window()
    with torch.no_grad():
        x = pipe.denoise_ranged()(pipe.init_latents(lat, noise), cond, uncond, start, g0)
    base_cfg = pipe.guidance_cfg
    out, by_shape, ref = {}, collections.Counter(), None
    order = ["step_nr"] + [m for m in ROLLOUT_REMAT_MODES if m != "step_nr"]
    try:
        for mode in order:
            pipe.guidance_cfg = dataclasses.replace(base_cfg, rollout_remat=mode)
            ctx = pipe.guidance_context()

            def run(ctx=ctx):
                return transform_guidance(ctx, x, cond, uncond, targets, g0, gamma0, beta0)

            (up, score, grads), shapes, secs, peak = counted_call(run)
            check_flash_plan(shapes, flash_plan(pipe, BATCH, parts=("rollout",)),
                             f"phase 8 rollout_remat={mode}")
            require_timed(records, shapes, f"phase 8 ({mode})")
            by_shape += shapes
            runs = [secs, wall_s(run)]
            got = {"latents": up.float(), "gamma": grads[0], "beta": grads[1],
                   "score": score}
            if ref is None:
                ref = got
            diff = {k: float((got[k] - ref[k]).abs().max()) for k in got}
            scale = {k: float(ref[k].abs().max()) for k in got}
            lat_tol = (base_cfg.rho * (diff["gamma"] * float(x.float().abs().max()) + diff["beta"])
                       + MODE_LAT_STEP * scale["latents"])
            tols = {"latents": lat_tol / scale["latents"], "gamma": MODE_GRAD_TOL,
                    "beta": MODE_GRAD_TOL, "score": MODE_SCORE_TOL}
            errs = {k: diff[k] / scale[k] for k in got}
            out[mode] = {"s": statistics.median(runs), "runs": runs, "peak_bytes": peak,
                         "rel_err": errs, "rel_tol": tols}
            print(f"  {mode}: {statistics.median(runs):.3f} s (median of "
                  f"{[round(r, 3) for r in runs]}), peak {peak / 2**30:.2f} GiB; against "
                  f"step_nr, of its size: " + ", ".join(
                      f"{k} {errs[k]:.2e} (tol {tols[k]:.1e})" for k in got) + f" ({card})")
            for k in got:
                require(math.isfinite(errs[k]) and errs[k] <= tols[k],
                        f"rollout_remat={mode}: {k} {errs[k]:.3e} of its size from step_nr's "
                        f"(tol {tols[k]:.1e})")
    finally:
        pipe.guidance_cfg = base_cfg
    return out, by_shape


def solver_fp32_phase() -> None:
    """The fp32 tiny() pipeline on the card against the port on the CPU,
    with the same weights and draws, at phase 3's tolerance: under dpmpp
    (make_expand_fn and SplitExpand), under deep_cache (interval 2, both
    entry points), in SD-2.1's shape (v-prediction, linear projections,
    heads of one width, the gelu text tower, its text held too), and
    under each rollout_remat mode."""
    import dataclasses

    import torch

    from distdiff_tpu_torch.config import ROLLOUT_REMAT_MODES
    from distdiff_tpu_torch.models import HashTokenizer
    from distdiff_tpu_torch.ops import flash
    from distdiff_tpu_torch.ops import groupnorm as gn

    dev = torch.device("cuda")

    def sd21_shape(c):
        return dataclasses.replace(
            c, prediction_type="v_prediction",
            unet=dataclasses.replace(c.unet, linear_projection=True, num_attention_heads=(2, 4)),
            text_encoder=dataclasses.replace(c.text_encoder, activation="gelu"))

    variants = (("dpmpp", lambda c: dataclasses.replace(c, scheduler="dpmpp")),
                ("deep_cache", lambda c: dataclasses.replace(c, deep_cache=True,
                                                              cache_interval=2)),
                ("SD-2.1 shape", sd21_shape))
    flash.reset_launch_counts()
    gn.reset_launch_counts()
    for label, edit in variants:
        pipes, inputs, gen = tiny_fp32_pipes(seed=10, edit=edit)
        draws = dict(zip(("noise", "gamma0", "beta0"), pipes[0].draw_inputs(inputs[0], gen)))
        for split in (False, True):
            want = tiny_expand(pipes[0], "cpu", inputs, draws, split)
            got = tiny_expand(pipes[1], dev, inputs, draws, split)
            print(f"  {label}, {'SplitExpand' if split else 'make_expand_fn'}:")
            agree_fp32(zip(("image", "updated latents", "guidance score"), got, want))
        if label == "SD-2.1 shape":
            ids = torch.as_tensor(HashTokenizer(vocab_size=1000, max_length=16)(
                ["a photo of an owl", ""])).long()
            text = [p.encode_text(ids.to(d)).float().cpu() for p, d in zip(pipes, ("cpu", dev))]
            agree_fp32([("gelu text tower", text[1], text[0])])
    pipes, inputs, gen = tiny_fp32_pipes(seed=11)
    draws = dict(zip(("noise", "gamma0", "beta0"), pipes[0].draw_inputs(inputs[0], gen)))
    for mode in ROLLOUT_REMAT_MODES:
        for pipe in pipes:
            pipe.guidance_cfg = dataclasses.replace(pipe.guidance_cfg, rollout_remat=mode)
        want = tiny_expand(pipes[0], "cpu", inputs, draws)
        got = tiny_expand(pipes[1], dev, inputs, draws)
        print(f"  rollout_remat={mode}:")
        agree_fp32(zip(("image", "updated latents", "guidance score"), got, want))
    torch.cuda.synchronize()
    counts = dict(flash.launch_counts, **gn.launch_counts)
    print(f"  launches over the fp32 card runs: {counts}")
    require(all(counts[k] > 0 for k in ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq",
                                        "flash_bwd_dkv", "gn_fused")),
            f"the fp32 runs did not go through the kernels: {counts}")


# ------------------------------------------------------------- phase 9

SDXL_SIDE = 1024
SDXL_CLI_TRAIN = 1  # train images a class (3 in phase 6): 100 latents at 1024^2
SDXL_CLI_UNITS = 2  # one batch of 2 work units
SDXL_T2I_STEPS = 50


def sdxl_encode_gn_call(cfg) -> tuple:
    """(times, batch, norms) of the SDXL CLI run's dataset encode."""
    return (-(-CLI_CLASSES * SDXL_CLI_TRAIN // CLI_ENCODE_BATCH), CLI_ENCODE_BATCH,
            vae_encode_norms(cfg.vae, cfg.sample_size))


def t2i_gn_calls(cfg, batch: int, steps: int) -> list:
    """(times, batch, norms) of one ``SDXLPipeline`` text-to-image call:
    ``steps`` UNet calls on the CFG pair, one decode."""
    ls = cfg.latent_size
    return [(steps, 2 * batch, unet_norms(cfg.unet, ls)), (1, batch, vae_decode_norms(cfg.vae, ls))]


def t2i_flash_plan(cfg, batch: int, steps: int) -> collections.Counter:
    """Flash launches by (kernel, shape) of one text-to-image call: forwards
    only (no guidance), over more than 256 kv tokens."""
    ls = cfg.latent_size
    plan = collections.Counter()
    for h, t, d, k in unet_attentions(cfg.unet, ls):
        if t > 256:
            plan[("flash_fwd", (2 * batch * h, t, t, d))] += k * steps
    if ls * ls > 256:
        plan[("flash_fwd", (batch, ls * ls, ls * ls, cfg.vae.block_out_channels[-1]))] += 1
    return plan


def sdxl_gn_calls() -> list:
    """(times, batch, norms) of every GroupNorm of phase 9's SDXL runs: the
    guided expand at batch 2, 1024^2 (the CLI's too; the text-to-image call
    has the same shapes), and the CLI's dataset encode at 1024^2,
    CLI_ENCODE_BATCH images a call."""
    from distdiff_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig.sdxl_base()
    return (expand_gn_calls(_recipe_pipe(cfg), BATCH) + t2i_gn_calls(cfg, BATCH, SDXL_T2I_STEPS)
            + [sdxl_encode_gn_call(cfg)])


def check_loaded(pipe, ckpt: str, components: dict) -> None:
    """A fifth of each component's keys: the loaded tensor against the
    checkpoint's (``weights/convert.py`` ``COMPONENTS`` or
    ``SDXL_COMPONENTS``: component -> (directory, the pipeline's
    attribute))."""
    from distdiff_tpu_torch.weights.safetensors import load_file
    from distdiff_tpu_torch.weights.synth import COMPONENT_FILES

    for comp, (_, attr) in components.items():
        sub, fname = COMPONENT_FILES[comp]
        written = load_file(os.path.join(ckpt, sub, fname))
        keys = sorted(written)
        loaded_matches(getattr(pipe, attr), written, keys[::max(1, len(keys) // 5)], comp)


def sdxl_phase(records, card: str) -> dict:
    """SDXL-base at full width (UNet 2,567.5M with the additive conditioning,
    the bigG and CLIP-L towers, the SDXL VAE; seeded random weights) at
    batch 2, 1024^2, the phase-4 recipe (DDIM-50, strength 0.5, CFG 7.5,
    transform guidance at plan index 30 over 2 steps, ResNet-50 guide), the
    conditioning from both towers on the card: a first call, a counted call
    (each kernel's launches by shape against the plan, peak memory) and two
    more timed. Then ``SDXLPipeline`` text-to-image on the same modules at
    batch 2, DDIM-50: a warm-up and a counted, timed call."""
    import torch

    from distdiff_tpu_torch.config import PipelineConfig
    from distdiff_tpu_torch.ops import groupnorm as gn
    from distdiff_tpu_torch.sampling.sdxl import SDXLPipeline

    dev = torch.device("cuda")
    t0 = time.time()
    pipe, expand, inputs = build_path(PipelineConfig.sdxl_base())
    build_s = time.time() - t0
    cfg = pipe.config
    n_params = {name: sum(p.numel() for p in getattr(pipe, name).parameters())
                for name in ("unet", "text_encoder", "text_encoder_2", "vae")}
    print(f"  parameters {n_params}; built with seeded weights in {build_s:.1f} s; rollout_remat "
          f"{pipe.guidance_cfg.rollout_remat!r}")
    require(n_params["unet"] == 2_567_463_684 and n_params["text_encoder_2"] == 694_659_840,
            f"SDXL parameter counts {n_params}")

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    cold = wall_s(lambda: expand(*inputs, gen(1)))
    (img, aux), by_shape, secs, peak = counted_call(
        lambda: expand(*inputs, gen(2), return_aux=True))
    runs = [secs, wall_s(lambda: expand(*inputs, gen(3)))]
    warm = statistics.median(runs)
    print(f"  SDXL {SDXL_SIDE}^2 guided expand batch {BATCH}: first call {cold:.2f} s, warm "
          f"{warm:.3f} s/batch (median of {[round(r, 3) for r in runs]}), peak memory "
          f"{peak / 2**30:.2f} GiB ({card})")
    check_images(img, SDXL_SIDE, "SDXL")
    for name in ("grad_gamma", "grad_beta"):
        g = aux[name]
        require(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0.0,
                f"SDXL: {name} is zero or not finite")
    moved = float((aux["latents_after"] - aux["latents_before"]).abs().max())
    require(moved > 0.0, "SDXL: guidance left the latents unchanged")
    print(f"  images in [{float(img.min()):.3f}, {float(img.max()):.3f}]; latents moved up to "
          f"{moved:.4f}; score {aux['score'].tolist()}")
    smem = gn._device_limits(dev)[0]
    check_flash_plan(by_shape, flash_plan(pipe, BATCH), "phase 9 SDXL")
    check_gn_plan(gn_only(by_shape), gn_plan(expand_gn_calls(pipe, BATCH), smem_limit=smem))
    require_timed(records, by_shape, "phase 9 (SDXL)")
    kernels = kernel_ms_of_call(records, by_shape, "SDXL call:")
    print("== 12c. SDXL --int8 on phase 9's pipeline")
    t0 = time.time()
    int8 = sdxl_int8_call(records, pipe, inputs, img, card)
    int8["phase_s"] = time.time() - t0
    del img, aux

    print("  -- SDXLPipeline text-to-image, the same modules")
    t2i = SDXLPipeline(config=cfg, sampler_cfg=pipe.sampler_cfg, sched=pipe.sched,
                       unet=pipe.unet, vae=pipe.vae, text_encoder=pipe.text_encoder,
                       text_encoder_2=pipe.text_encoder_2, device=dev)
    sample = t2i.make_sample_fn(text_to_img=True)
    args = inputs[:3]  # the latents (their shape) and the {"ctx", "add"} conds
    t2i_cold = wall_s(lambda: sample(*args, gen(5)))
    t2i_img, t2i_shapes, t2i_s, t2i_peak = counted_call(lambda: sample(*args, gen(6)))
    check_images(t2i_img, SDXL_SIDE, "SDXL text-to-image")
    check_flash_plan(t2i_shapes, t2i_flash_plan(cfg, BATCH, SDXL_T2I_STEPS),
                     "phase 9 SDXL text-to-image", every_kernel=False)
    check_gn_plan(gn_only(t2i_shapes), gn_plan(t2i_gn_calls(cfg, BATCH, SDXL_T2I_STEPS),
                                               smem_limit=smem))
    require_timed(records, t2i_shapes, "phase 9 (SDXL text-to-image)")
    print(f"  SDXL text-to-image batch {BATCH}, DDIM-{SDXL_T2I_STEPS}: first call {t2i_cold:.2f} s, "
          f"warm {t2i_s:.3f} s/batch, peak memory {t2i_peak / 2**30:.2f} GiB ({card})")
    del pipe, expand, inputs, t2i, sample, args, t2i_img
    gc.collect()
    torch.cuda.empty_cache()
    return {"warm_s": warm, "runs": runs, "cold_s": cold, "peak_bytes": peak,
            "build_s": build_s, "by_shape": by_shape + t2i_shapes + int8.pop("by_shape"),
            "kernels": kernels, "t2i_warm_s": t2i_s, "t2i_cold_s": t2i_cold,
            "t2i_peak_bytes": t2i_peak, "int8": int8}


def sdxl_cli_phase(records, card: str) -> dict:
    """``cli.generate_data.main --model sdxl --resolution 1024`` on the
    published recipe, from files written first: an SDXL fp16
    diffusers-layout checkpoint (``text_encoder_2`` and the UNet's
    ``add_embedding`` too; 6.9 GB), a ResNet-50 guide of 100 classes and a
    caltech-101 PNG tree cut to SDXL_CLI_TRAIN train images a class, and
    SDXL_CLI_UNITS images. The loaded weights of all four components, the
    PNGs, the caches and every kernel's launches by shape against the plan
    (the dataset encode, then one SplitExpand call)."""
    import tempfile

    import numpy as np
    import torch

    from distdiff_tpu_torch.cli import generate_data as cli
    from distdiff_tpu_torch.config import PipelineConfig
    from distdiff_tpu_torch.ops import groupnorm as gn
    from distdiff_tpu_torch.parallel import read_png
    from distdiff_tpu_torch.weights.convert import SDXL_COMPONENTS
    from distdiff_tpu_torch.weights.synth import write_synth_checkpoint

    dev = torch.device("cuda")
    root = os.path.dirname(os.path.abspath(__file__))
    secs, seen = {}, {}
    side, ls = SDXL_SIDE, SDXL_SIDE // 8
    with tempfile.TemporaryDirectory(dir=root, prefix=".smoke_sdxl_") as work:
        t0 = time.time()
        ckpt = write_synth_checkpoint(os.path.join(work, "sdxl"), PipelineConfig.sdxl_base(),
                                      seed=2)
        secs["write checkpoint"] = time.time() - t0
        t0 = time.time()
        guide_path = os.path.join(work, "checkpoint", "model_best.pth.tar")
        os.makedirs(os.path.dirname(guide_path))
        write_guide_checkpoint(guide_path)
        data = os.path.join(work, "data")
        write_caltech_tree(data, train=SDXL_CLI_TRAIN)
        secs["write guide and PNG tree"] = time.time() - t0
        argv = cli_argv(data, ckpt, guide_path, "out", units=SDXL_CLI_UNITS) + [
            "--model", "sdxl", "--resolution", str(side)]
        build = cli.build_pipeline

        def keep(*a, **kw):
            t = time.time()
            seen["pipe"] = build(*a, **kw)
            secs["build and load"] = time.time() - t
            return seen["pipe"]

        cwd = os.getcwd()
        cli.build_pipeline = keep
        try:
            os.chdir(work)
            stats, by_shape, secs["whole CLI"], peak = counted_call(lambda: cli.main(argv))
        finally:
            os.chdir(cwd)
            cli.build_pipeline = build
        pipe = seen["pipe"]
        require(pipe.is_sdxl and pipe.config.sample_size == side
                and pipe.config.vae.scaling_factor == 0.13025,
                f"the CLI built {pipe.config}")
        check_loaded(pipe, ckpt, SDXL_COMPONENTS)
        pngs = sorted(os.path.join(d, f) for d, _, fs in os.walk(os.path.join(work, "out"))
                      for f in fs if f.endswith(".png"))
        require(stats["written"] == len(pngs) == SDXL_CLI_UNITS,
                f"{stats['written']} written, {len(pngs)} PNGs, {SDXL_CLI_UNITS} units")
        for path in pngs:
            png = read_png(path)
            require(png.shape == (side, side, 3) and png.max() > png.min(),
                    f"{path}: {png.shape}, flat {png.max() == png.min()}")
        n_train = CLI_CLASSES * SDXL_CLI_TRAIN
        lat_path = [os.path.join(d, f) for d, _, fs in os.walk(os.path.join(work, "save"))
                    for f in fs if f.startswith(f"image_latents_{side}")]
        require(len(lat_path) == 1, f"latent caches {lat_path}")
        latents = np.load(lat_path[0])
        require(latents.shape == (n_train, ls, ls, 4) and bool(np.isfinite(latents).all()),
                f"latent cache {latents.shape}, want {n_train} finite [{ls}, {ls}, 4] latents")
        protos = np.load(os.path.join(work, cli.prototype_cache_path(
            "resnet50", "caltech-101", CLI_K)))
        require(protos["local_prototypes"].shape == (CLI_CLASSES, CLI_K, 2048),
                f"prototype cache {protos['local_prototypes'].shape}")
    secs["driver"] = stats["seconds"]
    encodes = -(-n_train // CLI_ENCODE_BATCH)
    want = flash_plan(pipe, CLI_BATCH)
    want[("flash_fwd", (CLI_ENCODE_BATCH, ls * ls, ls * ls, 512))] += encodes
    check_flash_plan(by_shape, want, "phase 9 SDXL CLI")
    check_gn_plan(gn_only(by_shape), gn_plan(
        expand_gn_calls(pipe, CLI_BATCH) + [sdxl_encode_gn_call(pipe.config)],
        smem_limit=gn._device_limits(dev)[0]))
    require_timed(records, by_shape, "phase 9 (SDXL CLI)")
    for stage, s in secs.items():
        print(f"  {stage}: {s:.2f} s ({card})")
    print(f"  {len(pngs)} PNGs of {side}x{side}x3; latent cache {latents.shape}; peak memory "
          f"{peak / 2**30:.2f} GiB")
    del seen, pipe
    gc.collect()
    torch.cuda.empty_cache()
    return {"secs": secs, "stats": stats, "by_shape": by_shape, "peak_bytes": peak}


def sdxl_fp32_pipes(seed: int = 12):
    """``sdxl_tiny`` at 96^2 in fp32 (latents 48^2, so that the 24^2 level's
    attention takes the flash kernels; the VAE at width 160, so that its
    mid-block takes the split pair) on the CPU and on the card with the
    same weights, and the conditioning of both towers on the CPU."""
    import dataclasses

    import torch

    from distdiff_tpu_torch.config import PipelineConfig, VAEConfig
    from distdiff_tpu_torch.models import HashTokenizer

    def edit(_):
        cfg = PipelineConfig.sdxl_tiny(sample_size=96)
        return dataclasses.replace(cfg, vae=VAEConfig(
            block_out_channels=(16, 160), layers_per_block=1, dtype=torch.float32))

    pipes, (lat, _, _, targets), gen = tiny_fp32_pipes(seed=seed, edit=edit)
    pipes[1].text_encoder_2.load_state_dict(pipes[0].text_encoder_2.state_dict())
    tok = HashTokenizer(vocab_size=1000, max_length=16)
    ids = torch.as_tensor(tok(["a photo of an owl", "a photo of a lynx"])).long()
    uids = torch.as_tensor(tok(["", ""])).long()
    cond, uncond = pipes[0].encode_text_pair(ids, ids), pipes[0].encode_text_pair(uids, uids)
    return pipes, (lat, cond, uncond, targets), gen, (ids, uids)


def sdxl_fp32_phase() -> None:
    """The fp32 ``sdxl_tiny`` guided expand (make_expand_fn, transform
    guidance), ``encode_text_pair`` and ``SDXLPipeline`` img2img on the
    card against the CPU, with the same weights and draws, at phase 3's
    tolerance; the flash and GroupNorm kernels launched."""
    import torch

    from distdiff_tpu_torch.ops import flash
    from distdiff_tpu_torch.ops import groupnorm as gn
    from distdiff_tpu_torch.sampling.conditioning import cond_to
    from distdiff_tpu_torch.sampling.sdxl import SDXLPipeline

    dev = torch.device("cuda")
    flash.reset_launch_counts()
    gn.reset_launch_counts()
    pipes, inputs, gen, (ids, uids) = sdxl_fp32_pipes()
    draws = dict(zip(("noise", "gamma0", "beta0"), pipes[0].draw_inputs(inputs[0], gen)))

    def run(pipe, device):
        lat, cond, uncond, targets = inputs
        img, aux = pipe.make_expand_fn()(
            lat.to(device), cond_to(cond, device), cond_to(uncond, device), targets.to(device),
            return_aux=True, **{k: v.to(device) for k, v in draws.items()})
        return [t.float().cpu() for t in (img, aux["latents_after"], aux["score"])]

    print("  SDXL tiny guided expand:")
    agree_fp32(zip(("image", "updated latents", "guidance score"), run(pipes[1], dev),
                   run(pipes[0], "cpu")))
    pair = [p.encode_text_pair(i.to(d), i.to(d)) for p, i, d in
            zip(pipes, (ids, ids), ("cpu", dev))]
    agree_fp32([(f"encode_text_pair {k}", pair[1][k].float().cpu(), pair[0][k])
                for k in ("ctx", "add")])
    images = []
    for pipe, device in zip(pipes, ("cpu", dev)):
        sdxl = SDXLPipeline(config=pipe.config, sampler_cfg=pipe.sampler_cfg, sched=pipe.sched,
                            unet=pipe.unet, vae=pipe.vae, text_encoder=pipe.text_encoder,
                            text_encoder_2=pipe.text_encoder_2, device=torch.device(device))
        c, u = (cond_to(x, device) for x in inputs[1:3])
        images.append(sdxl.make_sample_fn(text_to_img=False)(
            inputs[0].to(device), c, u, noise=draws["noise"].to(device)).float().cpu())
    print("  SDXLPipeline img2img:")
    agree_fp32([("image", images[1], images[0])])
    torch.cuda.synchronize()
    counts = dict(flash.launch_counts, **gn.launch_counts)
    print(f"  launches over the fp32 SDXL card runs: {counts}")
    require(all(counts[k] > 0 for k in ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq",
                                        "flash_bwd_dkv", "gn_fused")),
            f"the fp32 SDXL runs did not go through the kernels: {counts}")


# ------------------------------------------------------------- phase 10

# cli.train_lora's defaults: batch 8 at 512^2, rank 8 with alpha = rank,
# AdamW lr 1e-4 and weight decay 1e-2
LORA_BATCH = 8
LORA_RANK = 8
LORA_LR = 1e-4
LORA_WD = 1e-2
LORA_TIMED = 10  # steps timed by CUDA events
LORA_CLI_TRAIN = 1  # train images a class (3 in phase 6): 100 latents
LORA_CLI_STEPS = 20  # cut from the CLI's 1000
LORA_CLI_SAVE = 10
LORA_CLI_UNITS = 2  # images of the generate_data --lora run: one batch
# SD-1.5's adapter at the default targets (to_q, to_k, to_v, to_out) and rank 8
LORA_SD15_LEAVES = 128
LORA_SD15_PARAMS = 1_594_368
# one AdamW update, card against CPU: the share of elements more than
# lr / 10 apart (tests/test_torch_lora.py's rule)
LORA_UPDATE_SHARE = 1e-3
# std of the test adapters' b: a delta (alpha/r) a b^T of std 0.005, a
# tenth to a third of the lecun-normal weights'. At ten times that the
# delta is as large as the weights and the random UNet's adapter gradients
# chaotic: bf16 rounding moves them further than a planted fault does
LORA_B_STD = 0.005
# the bf16 kernels' adapter gradients: their l2 distance from the fp32
# plain run's at most this many times the bf16 plain run's, between the
# sound kernels' and planted faults' readings (scripts/torch_lora_grad_gate.py
# prints them)
LORA_BF16_GRAD_RATIO = 2.0


def lora_flash_plan(ucfg, side: int, batch: int) -> collections.Counter:
    """Flash launches by (kernel, shape) of one LoRA train step on a side^2
    latent at ``batch`` (no CFG): each self-attention over more than 256
    tokens runs its forward once, and again in the backward when the UNet
    recomputes its blocks (``ucfg.remat``), and one fused backward."""
    plan = collections.Counter()
    for h, t, d, k in unet_attentions(ucfg, side):
        if t <= 256:
            continue
        shape = (batch * h, t, t, d)
        plan[("flash_fwd", shape)] += k * (2 if ucfg.remat else 1)
        plan[("flash_bwd_fused", shape)] += k
    return plan


def lora_gn_calls(ucfg, side: int, batch: int) -> list:
    """(times, batch, norms) of one LoRA train step at the default targets
    (in the transformers): the norms of the blocks from the first
    transformer on run again in the backward's recompute (``ucfg.remat``). The
    blocks before it hold no adapted weight and take no input that needs a
    gradient, so the backward never reaches them; conv_norm_out sits in no
    block. The backward of a norm is the plain formula: no kernel."""
    norms = unet_norms(ucfg, side)
    first = next(i for i, (_, _, act) in enumerate(norms) if act is None)
    return [(1, batch, norms[:first] + norms[-1:]),
            (2 if ucfg.remat else 1, batch, norms[first:-1])]


def lora_main_gn_calls() -> list:
    """(times, batch, norms) of phase 10's counted steps: SD-1.5 at batch
    LORA_BATCH (the CLI's steps too; its dataset encode is phase 6's)."""
    from distdiff_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig.sd15()
    return lora_gn_calls(cfg.unet, cfg.latent_size, LORA_BATCH)


def lora_unet(ucfg, dev, seed: int):
    """A UNet of ``ucfg`` on ``dev`` with seeded random weights (the same
    for every dtype of ``ucfg``), frozen, in eval mode; fp32 products and
    convolutions on the card in full fp32 (TF32 off), as the pipelines
    set them."""
    import torch

    from distdiff_tpu_torch.device import disable_tf32
    from distdiff_tpu_torch.models import UNet2DConditionModel
    from distdiff_tpu_torch.models.init import init_weights

    if torch.device(dev).type == "cuda":
        disable_tf32()
    unet = UNet2DConditionModel(ucfg, device=dev)
    init_weights(unet, torch.Generator(device=dev).manual_seed(seed))
    unet.requires_grad_(False)
    return unet.eval()


def lora_adapter(unet, gen, rank: int = LORA_RANK) -> dict:
    """An adapter of ``unet`` drawn from the CPU generator ``gen``: init_lora's
    ``a``, and ``b`` normal with std LORA_B_STD (so that ``a`` has a
    gradient too), on the UNet's device."""
    import torch

    from distdiff_tpu_torch.train.lora import init_lora

    lora = init_lora(gen, unet, rank=rank)
    for pair in lora.values():
        with torch.no_grad():
            pair["b"].copy_(LORA_B_STD * torch.randn(pair["b"].shape, generator=gen))
    return lora


def flat_grads(grads) -> "torch.Tensor":
    import torch

    return torch.cat([grads[k][p].float().flatten().cpu() for k in sorted(grads)
                      for p in ("a", "b")])


def lora_agreement_phase() -> dict:
    """The fp32 LoRA step (inner checkpoints on) on the card against the
    port on the CPU with the same weights, adapter and draws: the loss and
    the adapter gradients (relative to the largest) at phase 3's tolerance,
    and one AdamW update as tests/test_torch_lora.py holds it (AdamW moves
    an element by about lr whatever its gradient's size, so one whose
    gradient is within fp32 noise of 0 may move the other way: at most
    2 lr apart, and at most LORA_UPDATE_SHARE of the elements more than
    lr / 10 apart), for the tiny() UNet (epsilon), the same in
    SD-2.1's shape (linear projections, per-level heads) under
    v-prediction, and sdxl_tiny with its dict conditioning. Latents of 24^2
    (48^2 for sdxl_tiny, whose first level has no attention), so that the
    576-token level takes flash_fwd_f32 and flash_bwd_fused_f32."""
    import dataclasses

    import torch

    from distdiff_tpu_torch.config import PipelineConfig
    from distdiff_tpu_torch.ops import flash
    from distdiff_tpu_torch.ops import groupnorm as gn
    from distdiff_tpu_torch.schedulers import make_schedule
    from distdiff_tpu_torch.train.lora import (
        draw_t_noise,
        lora_value_and_grad,
        make_lora_train_step,
        make_optimizer,
    )

    dev = torch.device("cuda")
    tiny = PipelineConfig.tiny(sample_size=48).unet
    cases = (("sd15 epsilon", tiny, "epsilon", 24),
             ("sd21 v-prediction", dataclasses.replace(
                 tiny, linear_projection=True, num_attention_heads=(2, 4)), "v_prediction", 24),
             ("sdxl_tiny", dataclasses.replace(PipelineConfig.sdxl_tiny(96).unet, remat=True),
              "epsilon", 48))
    out = {}
    for label, ucfg, pred, ls in cases:
        gen = torch.Generator().manual_seed(21)
        cpu = lora_unet(ucfg, "cpu", 21)
        card = lora_unet(ucfg, dev, 21)
        card.load_state_dict(cpu.state_dict())
        sched = make_schedule(50, prediction_type=pred)
        lat = torch.randn(2, ls, ls, 4, generator=gen) * 0.5
        ctx = torch.randn(2, 16, ucfg.cross_attention_dim, generator=gen)
        if ucfg.addition_embed_dim:
            ctx = {"ctx": ctx, "add": torch.randn(2, ucfg.addition_embed_dim, generator=gen)}
        t, noise = draw_t_noise(gen, 2, (ls, ls, 4), len(sched.alphas_cumprod))
        loras = [lora_adapter(cpu, gen)]
        loras.append({k: {p: v.detach().to(dev, copy=True).requires_grad_() for p, v in pair.items()}
                      for k, pair in loras[0].items()})

        def on(x, d):
            return {k: v.to(d) for k, v in x.items()} if isinstance(x, dict) else x.to(d)

        flash.reset_launch_counts()
        gn.reset_launch_counts()
        res = []
        for unet, lora, d in ((cpu, loras[0], "cpu"), (card, loras[1], dev)):
            loss, grads = lora_value_and_grad(unet, sched, lora, on(lat, d), on(ctx, d),
                                              t.to(d), noise.to(d), float(LORA_RANK))
            before = {k: {p: v.detach().clone() for p, v in pair.items()}
                      for k, pair in lora.items()}
            step = make_lora_train_step(unet, sched, make_optimizer(lora, LORA_LR, LORA_WD),
                                        float(LORA_RANK))
            step(lora, on(lat, d), on(ctx, d), t.to(d), noise.to(d))
            moved = flat_grads({k: {p: lora[k][p].detach() - before[k][p] for p in pair}
                                for k, pair in lora.items()})
            res.append((float(loss), flat_grads(grads), moved))
        torch.cuda.synchronize()
        launched = dict(flash.launch_counts, **gn.launch_counts)
        (l_cpu, g_cpu, m_cpu), (l_card, g_card, m_card) = res
        errs = {"loss (relative)": abs(l_card - l_cpu) / abs(l_cpu),
                "adapter gradients (relative)": float((g_card - g_cpu).abs().max()
                                                      / g_cpu.abs().max())}
        apart = (m_card - m_cpu).abs()
        update, share = float(apart.max()), float((apart > LORA_LR / 10).float().mean())
        ok = update <= 2 * LORA_LR and share <= LORA_UPDATE_SHARE
        print(f"  {label}: launches {launched}; one AdamW update, card against CPU: largest "
              f"difference {update:.3e} ({update / LORA_LR:.3f} lr, tol 2 lr), share over "
              f"lr / 10 {share:.3e} (tol {LORA_UPDATE_SHARE:.0e}) {'ok' if ok else 'FAIL'}")
        require(ok, f"one AdamW update of the fp32 LoRA step on the card strays from the "
                f"CPU's ({label})")
        for what, err in errs.items():
            ok = math.isfinite(err) and err <= FP32_TOL
            print(f"  {label} {what}: card against CPU {err:.3e} (tol {FP32_TOL:.1e}) "
                  f"{'ok' if ok else 'FAIL'}")
            require(ok, f"the fp32 LoRA step on the card strays from the CPU's on {what} "
                    f"({label})")
        require(launched["flash_fwd"] > 0 and launched["flash_bwd_fused"] > 0,
                f"{label}: the fp32 LoRA step did not go through the flash kernels: {launched}")
        out[label] = dict(errs, update=update, update_share=share, launches=launched)
        del cpu, card
    return out


def lora_grad_inputs(seed: int = 31):
    """Latents, context, timesteps and noise of batch BATCH for SD-1.5's
    512^2 (64^2 latents) on the card, drawn from ``seed``."""
    import torch

    from distdiff_tpu_torch.config import PipelineConfig
    from distdiff_tpu_torch.train.lora import draw_t_noise

    dev = torch.device("cuda")
    cfg = PipelineConfig.sd15()
    ls = cfg.latent_size
    gen = torch.Generator().manual_seed(seed)
    lat = (torch.randn(BATCH, ls, ls, 4, generator=gen) * 0.18).to(dev)
    ctx = torch.randn(BATCH, 77, cfg.unet.cross_attention_dim, generator=gen).to(dev)
    t, noise = draw_t_noise(gen, BATCH, (ls, ls, 4), 1000)
    return lat, ctx, t.to(dev), noise.to(dev)


def lora_grad_run(inputs, dtype, plain: bool = False, bwd=None, b_scale: float = 1.0,
                  adapter_seed: int = 32):
    """(loss, flat adapter gradients on the CPU) of one LoRA step (the
    loss and its backward, inner checkpoints on) of SD-1.5 at full width in
    ``dtype`` on ``inputs`` (``lora_grad_inputs``), seeded random weights,
    the adapter of ``adapter_seed`` with b scaled by ``b_scale``: through
    the kernels, or the plain attention (``plain``); ``bwd`` in place of
    ``flash_bwd_fused`` (a planted fault)."""
    import dataclasses

    import torch

    from distdiff_tpu_torch.config import PipelineConfig
    from distdiff_tpu_torch.ops import attention, flash
    from distdiff_tpu_torch.schedulers import make_schedule
    from distdiff_tpu_torch.train.lora import lora_value_and_grad

    cfg = PipelineConfig.sd15()
    unet = lora_unet(dataclasses.replace(cfg.unet, dtype=dtype), "cuda", 31)
    lora = lora_adapter(unet, torch.Generator().manual_seed(adapter_seed))
    with torch.no_grad():
        for pair in lora.values():
            pair["b"].mul_(b_scale)
    small_kv, fused = attention.SMALL_KV, flash.flash_bwd_fused
    if plain:
        attention.SMALL_KV = 10 ** 9
    flash.flash_bwd_fused = bwd or fused
    try:
        loss, grads = lora_value_and_grad(unet, make_schedule(50), lora, *inputs,
                                          float(LORA_RANK))
        torch.cuda.synchronize()
    finally:
        attention.SMALL_KV, flash.flash_bwd_fused = small_kv, fused
    out = float(loss), flat_grads(grads)
    del unet, lora, grads
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lora_grad_phase() -> dict:
    """SD-1.5 at full width, batch 2, 512^2, rank 8: the adapter gradients
    of one LoRA step in bf16 through the kernels, in bf16 through the plain
    attention, in fp32 through the kernels and in fp32 through the plain
    attention, on the same weights, adapter and draws (``lora_grad_run``).
    The bf16 kernels' loss stays within twice the plain bf16 run's
    distance from the fp32 run (plus 1e-3), phase 3's rule, and their
    gradients' l2 distance from the fp32 run within LORA_BF16_GRAD_RATIO
    times the plain bf16 run's; the fp32 kernels' gradients within
    FP32_TOL of the largest. A control, the bf16 kernels with
    flash_bwd_fused's dk dropped (the fault that read nearest the limit),
    must fail the gradient limit."""
    import torch

    from distdiff_tpu_torch.ops import flash

    inputs = lora_grad_inputs()
    fused = flash.flash_bwd_fused

    def drop_dk(*args):
        dq, dk, dv = fused(*args)
        return dq, torch.zeros_like(dk), dv

    control = "bf16 kernels, dk dropped (control)"
    res = {label: lora_grad_run(inputs, dtype, plain, bwd)
           for label, dtype, plain, bwd in (("bf16 kernels", torch.bfloat16, False, None),
                                            ("bf16 plain", torch.bfloat16, True, None),
                                            ("fp32 kernels", torch.float32, False, None),
                                            ("fp32 plain", torch.float32, True, None),
                                            (control, torch.bfloat16, False, drop_dk))}
    ref_loss, ref = res["fp32 plain"]
    l2 = {label: float((g - ref).norm() / ref.norm()) for label, (_, g) in res.items()
          if label != "fp32 plain"}
    out = {"gradient l2 (relative)": l2,
           "fp32 kernels max (relative)": float((res["fp32 kernels"][1] - ref).abs().max()
                                                / ref.abs().max())}
    print(f"  adapter gradients against fp32 plain, l2 (relative): {l2}")
    # fp32 on both sides, the kernels' TF32 products against the plain
    # attention: phase 3's fp32 tolerance, relative to the largest gradient
    err32 = out["fp32 kernels max (relative)"]
    ok = math.isfinite(err32) and err32 <= FP32_TOL
    print(f"  adapter gradients (relative), fp32 kernels against fp32 plain: {err32:.3e} "
          f"(tol {FP32_TOL:.1e}) {'ok' if ok else 'FAIL'}")
    require(ok, "the LoRA step's fp32 gradients through the kernels stray from the plain run")
    err_k, err_p = (abs(res[label][0] - ref_loss) / abs(ref_loss)
                    for label in ("bf16 kernels", "bf16 plain"))
    tol = 2.0 * err_p + 1e-3
    ok = math.isfinite(err_k) and err_k <= tol
    print(f"  loss (relative) against fp32: bf16 kernels {err_k:.3e}, bf16 plain {err_p:.3e} "
          f"(tol {tol:.3e}) {'ok' if ok else 'FAIL'}")
    require(ok, "the LoRA step's loss through the kernels strays from the fp32 run")
    out["loss"] = {"kernels": err_k, "plain": err_p, "tol": tol}
    ratios = {label: l2[label] / l2["bf16 plain"] for label in ("bf16 kernels", control)}
    for label, ratio in ratios.items():
        ok = math.isfinite(ratio) and ratio <= LORA_BF16_GRAD_RATIO
        want = label != control
        print(f"  adapter gradients, l2 distance from fp32 over the bf16 plain run's: {label} "
              f"{ratio:.3f} (limit {LORA_BF16_GRAD_RATIO}, must "
              f"{'hold' if want else 'fail'}) {'ok' if ok == want else 'FAIL'}")
        require(ok == want, f"the LoRA step's bf16 gradient gate: {label} reads {ratio:.3f}, "
                f"limit {LORA_BF16_GRAD_RATIO}")
    out["adapter gradients"] = {"ratio": ratios["bf16 kernels"], "control": ratios[control],
                                "limit": LORA_BF16_GRAD_RATIO}
    return out


def build_lora_step(gen):
    """The SD-1.5 LoRA train step at cli.train_lora's defaults on the card
    (UNet stored in bf16, seeded random weights, an adapter from ``gen``):
    (config, the adapter, the step, latents and a context of batch 8)."""
    import torch

    from distdiff_tpu_torch.config import PipelineConfig
    from distdiff_tpu_torch.schedulers import make_schedule
    from distdiff_tpu_torch.train.lora import init_lora, make_lora_train_step, make_optimizer

    dev = torch.device("cuda")
    cfg = PipelineConfig.sd15()
    ls, b = cfg.latent_size, LORA_BATCH
    unet = lora_unet(cfg.unet, dev, 41).to(torch.bfloat16)
    lora = init_lora(gen, unet, rank=LORA_RANK)
    step = make_lora_train_step(unet, make_schedule(50), make_optimizer(lora, LORA_LR, LORA_WD),
                                float(LORA_RANK))
    lat = (torch.randn(b, ls, ls, 4, generator=gen) * 0.18).to(dev)
    ctx = torch.randn(b, 77, cfg.unet.cross_attention_dim, generator=gen).to(dev)
    return cfg, unet, lora, step, lat, ctx


def lora_step_phase(records, card: str) -> dict:
    """The LoRA train step at cli.train_lora's defaults on SD-1.5 at full
    width (UNet 859.5M stored in bf16, as the CLI stores it; seeded random
    weights): batch 8 at 512^2 (64^2 latents, no CFG), rank 8, alpha 8,
    AdamW lr 1e-4, weight decay 1e-2, the UNet's inner checkpoints on. A
    warm-up step, a counted step (each kernel's launches by shape against
    the plan, peak memory), then LORA_TIMED steps timed by CUDA events on
    a batch and draws already on the card."""
    import torch

    from distdiff_tpu_torch.ops import groupnorm as gn
    from distdiff_tpu_torch.train.lora import draw_t_noise, lora_table

    dev = torch.device("cuda")
    t0 = time.time()
    gen = torch.Generator().manual_seed(41)
    cfg, unet, lora, step, lat, ctx = build_lora_step(gen)
    ls, b = cfg.latent_size, LORA_BATCH
    n = sum(v.numel() for pair in lora.values() for v in pair.values())
    print(f"  adapter: {len(lora)} leaves, {n} parameters (rank {LORA_RANK})")
    require((len(lora), n) == (LORA_SD15_LEAVES, LORA_SD15_PARAMS),
            f"SD-1.5's adapter has {len(lora)} leaves and {n} parameters")
    require(len(lora_table(unet)) == len(lora), "lora_table and init_lora disagree")
    draws = [tuple(x.to(dev) for x in draw_t_noise(gen, b, (ls, ls, 4), 1000))
             for _ in range(LORA_TIMED + 2)]
    build_s = time.time() - t0
    t0 = time.time()
    first = float(step(lora, lat, ctx, *draws[0]))
    first_s = time.time() - t0
    loss, by_shape, counted_s, peak = counted_call(lambda: step(lora, lat, ctx, *draws[1]))
    check_flash_plan(by_shape, lora_flash_plan(cfg.unet, ls, b), "phase 10 LoRA step",
                     every_kernel=False)
    for name in ("flash_fwd", "flash_bwd_fused"):
        require(any(k == name for k, _ in by_shape), f"phase 10: {name} never launched")
    check_gn_plan(gn_only(by_shape), gn_plan(lora_gn_calls(cfg.unet, ls, b),
                                             smem_limit=gn._device_limits(dev)[0]))
    require_timed(records, by_shape, "phase 10 (LoRA step)")
    times = []
    for i in range(LORA_TIMED):
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        last = step(lora, lat, ctx, *draws[2 + i])
        e.record()
        e.synchronize()
        times.append(a.elapsed_time(e))
    losses = [first, float(loss), float(last)]
    require(all(math.isfinite(v) for v in losses), f"non-finite LoRA loss {losses}")
    moved = max(float(pair["b"].detach().abs().max()) for pair in lora.values())
    require(moved > 0, "the LoRA steps left b at 0")
    step_ms = statistics.median(times)
    kernels = kernel_ms_of_call(records, by_shape, "LoRA step")
    norms = call_weighted(records, gn_only(by_shape), GN_KERNELS)
    for name, m in norms.items():
        print(f"  LoRA step {name}, its {m['shapes']} shapes weighted by its {m['launches']} "
              f"launches (phase 2's times): kernel {m['ms']:.4f} ms, plain {m['plain_ms']:.4f} "
              f"ms, F.group_norm+silu {m['library_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms")
    print(f"  SD-1.5 LoRA step, batch {b}, 512^2, rank {LORA_RANK}: build {build_s:.1f} s, "
          f"first step {first_s:.2f} s, counted step {counted_s:.3f} s; median of "
          f"{LORA_TIMED} steps {step_ms:.1f} ms ({[round(x, 1) for x in times]}), "
          f"{b * 1000.0 / step_ms:.2f} images/s; peak memory {peak / 2**30:.2f} GiB; losses "
          f"{[round(v, 4) for v in losses]}; |b| max {moved:.3e} ({card})")
    del unet, lora, step, draws
    gc.collect()
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "step_ms_runs": times, "peak_bytes": peak, "build_s": build_s,
            "first_step_s": first_s, "by_shape": by_shape, "kernels": kernels,
            "norms": norms, "losses": losses}


class StepRecords(logging.Handler):
    """Keeps the arguments of cli.train_lora's "step %d/%d ..." records."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        if record.msg.startswith("step "):
            self.records.append(record.args)


def lora_cli_phase(records, card: str, ckpt: str) -> dict:
    """``cli.train_lora.main`` at its defaults (SD-1.5, batch 8, 512^2,
    rank 8) from phase 6's SD-1.5 fp16 diffusers-layout checkpoint
    ``ckpt`` and files written first (phase 6's writers: a ResNet-50 guide
    of 100 classes, a caltech-101 PNG tree cut to LORA_CLI_TRAIN train
    images a class), cut
    to LORA_CLI_STEPS steps with an adapter saved every LORA_CLI_SAVE: both
    files' keys, shapes and alpha, the launches by shape against the plan,
    each stage's seconds and the steps/s. Then ``cli.generate_data.main
    --lora`` on that adapter through the published recipe cut to
    LORA_CLI_UNITS images: every adapted leaf of its UNet equals the merge
    of the written weight bit for bit, every other leaf the written weight;
    an adapter with b = 0 merged into that UNet leaves its bytes as they
    were."""
    import numpy as np
    import torch

    import distdiff_tpu_torch.data as data_pkg
    from distdiff_tpu_torch.cli import generate_data as gen_cli
    from distdiff_tpu_torch.cli import train_lora as lora_cli
    from distdiff_tpu_torch.config import PipelineConfig
    from distdiff_tpu_torch.ops import groupnorm as gn
    from distdiff_tpu_torch.parallel import read_png
    from distdiff_tpu_torch.train.lora import load_lora, lora_table, merge_lora
    from distdiff_tpu_torch.weights.safetensors import load_file
    from distdiff_tpu_torch.weights.synth import COMPONENT_FILES

    dev = torch.device("cuda")
    root = os.path.dirname(os.path.abspath(__file__))
    cfg = PipelineConfig.sd15()
    ls = cfg.latent_size
    secs, seen = {}, {}
    log = StepRecords()
    logger = logging.getLogger("distdiff.train_lora")
    build, dataset = gen_cli.build_pipeline, data_pkg.SDDataset

    def keep(*a, **kw):
        t = time.time()
        seen["pipe"] = build(*a, **kw)
        secs[f"{seen['what']}: build and load"] = time.time() - t
        return seen["pipe"]

    def timed_dataset(*a, **kw):
        t = time.time()
        sd = dataset(*a, **kw)
        secs[f"{seen['what']}: dataset and caches"] = time.time() - t
        return sd

    with tempfile.TemporaryDirectory(dir=root, prefix=".smoke_lora_") as work:
        t0 = time.time()
        guide_path = os.path.join(work, "checkpoint", "model_best.pth.tar")
        os.makedirs(os.path.dirname(guide_path))
        write_guide_checkpoint(guide_path)
        data = os.path.join(work, "data")
        write_caltech_tree(data, train=LORA_CLI_TRAIN)
        secs["write guide and PNG tree"] = time.time() - t0
        argv = ["--dataset", "caltech-101", "--data_root", data, "--output_dir", "lora_run",
                "--sd_checkpoint", ckpt, "--steps", str(LORA_CLI_STEPS), "--save_every",
                str(LORA_CLI_SAVE), "--log_every", str(LORA_CLI_SAVE)]
        gen_argv = cli_argv(data, ckpt, guide_path, "out", units=LORA_CLI_UNITS) + [
            "--lora", os.path.join("lora_run", "lora.npz")]
        cwd = os.getcwd()
        gen_cli.build_pipeline, data_pkg.SDDataset = keep, timed_dataset
        level = logger.level
        logger.setLevel(logging.INFO)
        logger.addHandler(log)
        try:
            os.chdir(work)
            seen["what"] = "train_lora"
            out, train_shapes, secs["train_lora: whole CLI"], train_peak = counted_call(
                lambda: lora_cli.main(argv))
            train_pipe = seen.pop("pipe")
            table = {k: shape for k, (_, shape) in lora_table(train_pipe.unet).items()}
            del train_pipe
            gc.collect()
            torch.cuda.empty_cache()
            seen["what"] = "generate_data --lora"
            stats, gen_shapes, secs["generate_data --lora: whole CLI"], gen_peak = counted_call(
                lambda: gen_cli.main(gen_argv))
        finally:
            os.chdir(cwd)
            gen_cli.build_pipeline, data_pkg.SDDataset = build, dataset
            logger.removeHandler(log)
            logger.setLevel(level)
        # the adapter files
        require(out == os.path.join("lora_run", "lora.npz"), f"train_lora returned {out}")
        for name in ("lora.npz", f"lora_{LORA_CLI_SAVE:06d}.npz"):
            npz = np.load(os.path.join(work, "lora_run", name))
            require(sorted(npz.files) == sorted(
                ["__alpha__"] + [f"{k}::{p}" for k in table for p in ("a", "b")]),
                f"{name}: {len(npz.files)} entries, want {2 * len(table) + 1}")
            require(len(table) == LORA_SD15_LEAVES and float(npz["__alpha__"]) == LORA_RANK,
                    f"{name}: {len(table)} leaves, alpha {float(npz['__alpha__'])}")
            for k, (n_in, n_out) in table.items():
                require(npz[f"{k}::a"].shape == (n_in, LORA_RANK)
                        and npz[f"{k}::b"].shape == (LORA_RANK, n_out)
                        and npz[f"{k}::a"].dtype == np.float32
                        and bool(np.isfinite(npz[f"{k}::b"]).all()), f"{name} {k}: shapes")
        steps = log.records
        require(len(steps) == LORA_CLI_STEPS // LORA_CLI_SAVE, f"step log {steps}")
        steps_per_s = steps[-1][3]
        # the generate_data --lora run
        pipe = seen.pop("pipe")
        pngs = sorted(os.path.join(d, f) for d, _, fs in os.walk(os.path.join(work, "out"))
                      for f in fs if f.endswith(".png"))
        require(stats["written"] == len(pngs) == LORA_CLI_UNITS,
                f"{stats['written']} written, {len(pngs)} PNGs, {LORA_CLI_UNITS} units")
        for path in pngs:
            png = read_png(path)
            require(png.shape == (512, 512, 3) and png.max() > png.min(),
                    f"{path}: {png.shape}, flat {png.max() == png.min()}")
        lora, alpha = load_lora(os.path.join(work, "lora_run", "lora.npz"), device=dev)
        sub, fname = COMPONENT_FILES["unet"]
        written = load_file(os.path.join(ckpt, sub, fname))
        adapted = {name: k for k, (name, _) in lora_table(pipe.unet).items()}
        own = pipe.unet.state_dict()
        for name, w in own.items():
            base = written[name].to(dev).to(w.dtype)
            if name in adapted:
                a, b_ = lora[adapted[name]]["a"], lora[adapted[name]]["b"]
                # the merge's formula, written out here
                want = (base.float() + ((a.float() @ b_.float()) * (alpha / a.shape[1]))
                        .t().reshape(base.shape)).to(w.dtype)
            else:
                want = base
            require(torch.equal(w, want), f"generate_data --lora: UNet leaf {name} is not "
                    f"{'the merge of the written weight' if name in adapted else 'the written weight'}")
        require(len(adapted) == LORA_SD15_LEAVES, f"{len(adapted)} adapted leaves")
        snapshot = {k: v.clone() for k, v in own.items()}
        zero = {k: {"a": pair["a"], "b": torch.zeros_like(pair["b"])} for k, pair in lora.items()}
        merge_lora(pipe.unet, zero, alpha)
        require(all(torch.equal(v, snapshot[k]) for k, v in pipe.unet.state_dict().items()),
                "an adapter with b = 0 changed the UNet's bytes")
    n_train = CLI_CLASSES * LORA_CLI_TRAIN
    encodes = -(-n_train // CLI_ENCODE_BATCH)
    want = collections.Counter()
    for key, c in lora_flash_plan(cfg.unet, ls, LORA_BATCH).items():
        want[key] += c * LORA_CLI_STEPS
    want[("flash_fwd", (CLI_ENCODE_BATCH, ls * ls, ls * ls, 512))] += encodes
    print("  train_lora CLI launches:")
    check_flash_plan(train_shapes, want, "phase 10 train_lora CLI", every_kernel=False)
    limit = gn._device_limits(dev)[0]
    steps_gn = [(times * LORA_CLI_STEPS, b, norms)
                for times, b, norms in lora_gn_calls(cfg.unet, ls, LORA_BATCH)]
    check_gn_plan(gn_only(train_shapes), gn_plan(
        steps_gn + [(encodes, CLI_ENCODE_BATCH, vae_encode_norms(cfg.vae, cfg.sample_size))],
        smem_limit=limit))
    print("  generate_data --lora launches (the latent cache read, not encoded):")
    check_flash_plan(gen_shapes, flash_plan(pipe, CLI_BATCH), "phase 10 generate_data --lora")
    check_gn_plan(gn_only(gen_shapes), gn_plan(expand_gn_calls(pipe, CLI_BATCH),
                                               smem_limit=limit))
    for what, shapes in (("train_lora CLI", train_shapes), ("generate_data --lora", gen_shapes)):
        require_timed(records, shapes, f"phase 10 ({what})")
    secs["train_lora: steps"] = LORA_CLI_STEPS / steps_per_s
    for stage, s in secs.items():
        print(f"  {stage}: {s:.2f} s ({card})")
    print(f"  train_lora: {steps_per_s:.3f} steps/s over {LORA_CLI_STEPS} steps "
          f"({LORA_BATCH * steps_per_s:.2f} images/s), peak memory {train_peak / 2**30:.2f} "
          f"GiB; generate_data --lora: {len(pngs)} PNGs, peak {gen_peak / 2**30:.2f} GiB ({card})")
    del seen, pipe, own, snapshot
    gc.collect()
    torch.cuda.empty_cache()
    return {"secs": secs, "steps_per_s": steps_per_s, "stats": stats,
            "by_shape": train_shapes + gen_shapes, "train_peak_bytes": train_peak,
            "generate_peak_bytes": gen_peak}


# ------------------------------------------------------------- phase 11

ZOO = ("resnext50", "wideresnet50", "mobilenetv2", "open_clip_vit_b32")
# card against CPU, fp32 with TF32 off, the same guide and inputs; the
# TF32-on control must exceed both limits. First readings (NVIDIA H100,
# ResNeXt-50, Wide ResNet-50-2, MobileNetV2, the ViT): features 2.8e-7,
# 3.2e-7, 3.0e-7, 9.2e-7, TF32 4.8e-4, 4.4e-4, 3.2e-4, 7.9e-4. The CNNs'
# input gradient 4.3e-4, 1.5e-3, 3.1e-4 (a ReLU mask or a max-pool choice
# that the last bits flip moves it locally), TF32 4.8e-2, 4.2e-2, 7.2e-2;
# the ViT's, smooth in the rounding, 1.7e-6, TF32 1.3e-3
ZOO_FEAT_TOL = 1e-4  # max |card - CPU| of the features over their max |CPU|
# l2 of card - CPU of the energy's input gradient over the CPU's l2
ZOO_GRAD_TOL = {"open_clip_vit_b32": 1e-4}
ZOO_CNN_GRAD_TOL = 1e-2
ZOO_SIDE = 224
ZOO_CLI_TRAIN = 1    # train images a class: 100 latents
ZOO_CLI_UNITS = 2
ZOO_MERGES = "#version: 0.2\nc l</w>\na s\nas s</w>\n"


def zoo_guide(arch: str, dev, seed: int = 0):
    """A frozen guide of ``arch`` at full width with 100 classes on
    ``dev``: flax-style seeded weights (``init_weights``) and seeded
    BatchNorm running statistics, drawn on the CPU, so the same on every
    device."""
    import torch

    from distdiff_tpu_torch.models.guide import create_model
    from distdiff_tpu_torch.models.init import init_weights

    gm = create_model(arch, CLI_CLASSES, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    init_weights(gm.module, gen)
    with torch.no_grad():
        for k, v in gm.module.state_dict().items():
            if k.endswith("running_mean"):
                v.copy_(torch.randn(v.shape, generator=gen) * 0.1)
            elif k.endswith("running_var"):
                v.copy_(torch.rand(v.shape, generator=gen) + 0.5)
    gm.module.to(dev)
    return gm


def zoo_agreement(arch: str, card_gm, seed: int) -> dict:
    """``encode_image`` and the input gradient of the summed per-sample
    hierarchical energy of the guide on the card against the same guide on
    the CPU (batch 2, 224^2, seeded inputs and prototypes), with TF32 off;
    then the TF32-on control, which must exceed both limits."""
    import torch

    from distdiff_tpu_torch.device import disable_tf32
    from distdiff_tpu_torch.guidance import hierarchical_energy_per_sample

    cpu_gm = zoo_guide(arch, "cpu", seed)
    gen = torch.Generator().manual_seed(seed + 100)
    x = torch.rand(BATCH, ZOO_SIDE, ZOO_SIDE, 3, generator=gen) * 2 - 1
    t = torch.randint(0, CLI_CLASSES, (BATCH,), generator=gen)
    gp = torch.randn(CLI_CLASSES, cpu_gm.feature_dim, generator=gen)
    lp = torch.randn(CLI_CLASSES, CLI_K, cpu_gm.feature_dim, generator=gen)

    def run(gm):
        dev = next(gm.module.parameters()).device
        xx = x.to(dev).requires_grad_(True)
        f = gm.encode_image(xx)
        e = hierarchical_energy_per_sample(f, t.to(dev), gp.to(dev), lp.to(dev))
        (g,) = torch.autograd.grad(e.sum(), xx)
        return f.detach().cpu(), g.cpu()

    def errors(got, want):
        (f, g), (wf, wg) = got, want
        return (float((f - wf).abs().max() / wf.abs().max()),
                float((g - wg).norm() / wg.norm()))

    want = run(cpu_gm)
    disable_tf32()
    feat, grad = errors(run(card_gm), want)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf_feat, tf_grad = errors(run(card_gm), want)
    finally:
        disable_tf32()
    grad_tol = ZOO_GRAD_TOL.get(arch, ZOO_CNN_GRAD_TOL)
    print(f"  {arch}: card against CPU, fp32: features {feat:.3e} of their largest, the "
          f"energy's input gradient {grad:.3e} (l2); TF32 on: {tf_feat:.3e}, {tf_grad:.3e} "
          f"(limits {ZOO_FEAT_TOL}, {grad_tol})")
    require(feat <= ZOO_FEAT_TOL and grad <= grad_tol,
            f"{arch}: card against CPU, features {feat:.3e} (limit {ZOO_FEAT_TOL}), gradient "
            f"{grad:.3e} (limit {grad_tol})")
    require(tf_feat > ZOO_FEAT_TOL and tf_grad > grad_tol,
            f"{arch}: the TF32 control passed a limit ({tf_feat:.3e}, {tf_grad:.3e}): it would "
            f"not catch a lower precision")
    return {"feat_err": feat, "grad_err": grad, "tf32_feat_err": tf_feat,
            "tf32_grad_err": tf_grad}


def zoo_recipe(records, pipe, inputs, gm, card: str) -> dict:
    """The phase-4 recipe (SD-1.5, batch 2, 512^2, DDIM-50 at strength
    0.5, transform guidance) with ``gm`` as the guide and seeded random
    prototypes of its width: a first call, a counted call (launches by
    shape against phase 4's plan: the guides launch no flash or GroupNorm
    kernel of their own) and one more timed calls, the counted call's peak
    memory."""
    import torch

    from distdiff_tpu_torch.ops import groupnorm as gn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    pipe.guide = gm
    pipe.global_protos = torch.randn(CLI_CLASSES, gm.feature_dim, generator=gen, device=dev)
    pipe.local_protos = torch.randn(CLI_CLASSES, CLI_K, gm.feature_dim, generator=gen,
                                    device=dev)
    expand = pipe.make_expand_fn()

    def g(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    cold = wall_s(lambda: expand(*inputs, g(1)))
    (img, aux), by_shape, secs, peak = counted_call(
        lambda: expand(*inputs, g(2), return_aux=True))
    runs = [secs, wall_s(lambda: expand(*inputs, g(3)))]
    warm = statistics.median(runs)
    what = f"phase 11 {gm.arch}"
    check_images(img, 512, what)
    for name in ("grad_gamma", "grad_beta"):
        require(bool(torch.isfinite(aux[name]).all()) and float(aux[name].abs().max()) > 0.0,
                f"{what}: {name} is zero or not finite")
    moved = float((aux["latents_after"] - aux["latents_before"]).abs().max())
    require(moved > 0.0, f"{what}: guidance left the latents unchanged")
    check_flash_plan(by_shape, flash_plan(pipe, BATCH), what)
    check_gn_plan(gn_only(by_shape), gn_plan(expand_gn_calls(pipe, BATCH),
                                             smem_limit=gn._device_limits(dev)[0]))
    require_timed(records, by_shape, what)
    print(f"  {gm.arch} guide ({sum(p.numel() for p in gm.module.parameters()) / 1e6:.1f}M): "
          f"first call {cold:.2f} s, warm {warm:.3f} s/batch (median of "
          f"{[round(r, 3) for r in runs]}), peak memory {peak / 2**30:.2f} GiB; latents moved "
          f"up to {moved:.4f} ({card})")
    return {"warm_s": warm, "runs": runs, "cold_s": cold, "peak_bytes": peak,
            "by_shape": by_shape}


def write_openclip_checkpoint(path: str, seed: int = 7, shapes=None) -> dict:
    """An OpenCLIP ViT-B/32 state (laion's: no OpenAI markers) as
    ``.safetensors``, fp32: every key of ``openclip_vit_b32_state_shapes``
    (``shapes``, default the full layout: 151,277,313 values), normal with
    std 0.02 but the LayerNorm scales (1 + normal * 0.1) and the logit
    scale (log 100). Returns the state."""
    import torch

    from distdiff_tpu_torch.weights.openclip import (
        CLIP_VIT_B32_TOTAL,
        openclip_vit_b32_state_shapes,
        state_size,
    )
    from distdiff_tpu_torch.weights.safetensors import save_file

    if shapes is None:
        shapes = openclip_vit_b32_state_shapes()
        require(state_size(shapes) == CLIP_VIT_B32_TOTAL, "the OpenCLIP enumeration's total")
    gen = torch.Generator().manual_seed(seed)
    state = {}
    for k, s in shapes.items():
        if k == "logit_scale":
            state[k] = torch.tensor(math.log(100.0))
        elif ".ln_" in k and k.endswith("weight") or k.startswith("ln_final.weight"):
            state[k] = 1 + 0.1 * torch.randn(s, generator=gen)
        else:
            state[k] = 0.02 * torch.randn(s, generator=gen)
    save_file(state, path)
    return state


def zoo_cli_plans(pipe) -> tuple:
    """(flash launches by (kernel, shape), GroupNorm calls) of phase 11's
    CLI run: one SplitExpand call at CLI_BATCH, after the dataset encode of
    CLI_CLASSES * ZOO_CLI_TRAIN images, CLI_ENCODE_BATCH a call (the VAE
    mid-block's attention, D = 512). The guide adds none."""
    encodes = -(-CLI_CLASSES * ZOO_CLI_TRAIN // CLI_ENCODE_BATCH)
    cfg = pipe.config
    t = cfg.latent_size ** 2
    want = flash_plan(pipe, CLI_BATCH)
    want[("flash_fwd", (CLI_ENCODE_BATCH, t, t, cfg.vae.block_out_channels[-1]))] += encodes
    return want, expand_gn_calls(pipe, CLI_BATCH) + [
        (encodes, CLI_ENCODE_BATCH, vae_encode_norms(cfg.vae, cfg.sample_size))]


def zoo_cli_phase(records, card: str, ckpt: str) -> dict:
    """``cli.generate_data.main`` with the default ``-a``
    (``open_clip_vit_b32``) on the published recipe, from phase 6's synth
    SD-1.5 checkpoint ``ckpt`` and files written first: a full-layout OpenCLIP
    ViT-B/32 ``.safetensors`` (``--encoder_weight_path``), a minimal merges
    file (``--bpe_path``) and a caltech-101 PNG tree cut to ZOO_CLI_TRAIN
    train images a class, ZOO_CLI_UNITS images. The image tower's loaded
    tensors against the written ones, the zero-shot head ([100, 512],
    finite, class rows apart), the PNGs, the caches and the launches by
    shape against the plan."""
    import numpy as np
    import torch

    from distdiff_tpu_torch.cli import generate_data as cli
    from distdiff_tpu_torch.ops import groupnorm as gn
    from distdiff_tpu_torch.parallel import read_png
    from distdiff_tpu_torch.weights.openclip import convert_openclip

    dev = torch.device("cuda")
    root = os.path.dirname(os.path.abspath(__file__))
    secs, seen = {}, {}
    with tempfile.TemporaryDirectory(dir=root, prefix=".smoke_zoo_") as work:
        t0 = time.time()
        clip_path = os.path.join(work, "open_clip_vit_b32_laion2b.safetensors")
        written = write_openclip_checkpoint(clip_path)
        secs["write OpenCLIP checkpoint"] = time.time() - t0
        bpe = os.path.join(work, "merges.txt")
        with open(bpe, "w") as f:
            f.write(ZOO_MERGES)
        data = os.path.join(work, "data")
        t0 = time.time()
        write_caltech_tree(data, train=ZOO_CLI_TRAIN)
        secs["write PNG tree"] = time.time() - t0
        argv = cli_argv(data, ckpt, clip_path, "out", units=ZOO_CLI_UNITS)
        i = argv.index("-a")
        argv = argv[:i] + argv[i + 2:] + ["--bpe_path", bpe]  # the default -a
        require(cli.parse_args(argv).arch == "open_clip_vit_b32", "the CLI's default -a")
        build, prepare = cli.build_pipeline, cli.prepare_guide_and_prototypes

        def keep_pipe(*a, **kw):
            seen["pipe"] = build(*a, **kw)
            return seen["pipe"]

        def keep_guide(*a, **kw):
            t = time.time()
            seen["guide"] = prepare(*a, **kw)
            secs["guide, zero-shot head and prototypes"] = time.time() - t
            return seen["guide"]

        cwd = os.getcwd()
        cli.build_pipeline, cli.prepare_guide_and_prototypes = keep_pipe, keep_guide
        try:
            os.chdir(work)
            stats, by_shape, secs["whole CLI"], peak = counted_call(lambda: cli.main(argv))
        finally:
            os.chdir(cwd)
            cli.build_pipeline, cli.prepare_guide_and_prototypes = build, prepare
        pipe, (guide, _, _) = seen["pipe"], seen["guide"]
        require(guide.arch == "open_clip_vit_b32" and guide.text_activation == "gelu"
                and guide.text_state is not None, f"the CLI's guide: {guide.arch}, text "
                f"activation {guide.text_activation}")
        visual = convert_openclip({k: v for k, v in written.items() if k.startswith("visual.")})[0]
        loaded_matches(guide.module, visual, sorted(visual)[::7], "OpenCLIP image tower")
        head = guide.class_text_features
        require(tuple(head.shape) == (CLI_CLASSES, 512) and bool(torch.isfinite(head).all()),
                f"zero-shot head {tuple(head.shape)}, finite {bool(torch.isfinite(head).all())}")
        spread = float((head - head[:1]).abs().max())
        require(spread > 0.0, "the zero-shot head's class rows are all equal")
        pngs = sorted(os.path.join(d, f) for d, _, fs in os.walk(os.path.join(work, "out"))
                      for f in fs if f.endswith(".png"))
        require(stats["written"] == len(pngs) == ZOO_CLI_UNITS,
                f"{stats['written']} written, {len(pngs)} PNGs, {ZOO_CLI_UNITS} units")
        for path in pngs:
            png = read_png(path)
            require(png.shape == (512, 512, 3) and png.max() > png.min(),
                    f"{path}: {png.shape}, flat {png.max() == png.min()}")
        protos = np.load(os.path.join(work, cli.prototype_cache_path(
            "open_clip_vit_b32", "caltech-101", CLI_K)))
        gshape, lshape = protos["global_prototypes"].shape, protos["local_prototypes"].shape
        require(gshape == (CLI_CLASSES, 512) and lshape == (CLI_CLASSES, CLI_K, 512),
                f"prototype cache global {gshape}, local {lshape}")
    secs["driver"] = stats["seconds"]
    want, gn_calls = zoo_cli_plans(pipe)
    check_flash_plan(by_shape, want, "phase 11 CLI")
    check_gn_plan(gn_only(by_shape), gn_plan(gn_calls, smem_limit=gn._device_limits(dev)[0]))
    require_timed(records, by_shape, "phase 11 (CLI)")
    for stage, s in secs.items():
        print(f"  {stage}: {s:.2f} s ({card})")
    print(f"  zero-shot head [{CLI_CLASSES}, 512], class rows up to {spread:.3e} apart; "
          f"{len(pngs)} PNGs of 512x512x3; prototype cache global {gshape}, local {lshape}; "
          f"peak memory {peak / 2**30:.2f} GiB")
    del seen, pipe, guide
    gc.collect()
    torch.cuda.empty_cache()
    return {"secs": secs, "stats": stats, "by_shape": by_shape, "peak_bytes": peak}


def zoo_train_phase(card: str, data: str) -> dict:
    """``cli.train -a mobilenetv2 --train_fc`` at phase 7's cuts (the JAX
    defaults on phase 7's caltech-101 tree ``data``: 100 classes, 3 train
    and 1 test image each) for one epoch, from a seeded MobileNetV2
    ``.pth.tar``: the run's artifacts, and in its checkpoint every backbone
    parameter as written, every BatchNorm's running statistics moved,
    ``classifier.*`` moved."""
    import torch

    from distdiff_tpu_torch.cli import train as train_cli

    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    with tempfile.TemporaryDirectory(dir=root, prefix=".smoke_zoo_train_") as work:
        t0 = time.time()
        start = os.path.join(work, "mobilenetv2.pth.tar")
        state = {k: v.clone() for k, v in zoo_guide("mobilenetv2", "cpu", 8).module.state_dict()
                 .items()}
        torch.save({"state_dict": state}, start)
        out["write_s"] = time.time() - t0
        run = os.path.join(work, "checkpoint", "mobilenetv2_fc")
        t0 = time.time()
        out["result"] = train_cli.main(train_argv(data, run, 1, [
            "-a", "mobilenetv2", "--train_fc", "--encoder_weight_path", start]))
        torch.cuda.synchronize()
        out["main_s"] = time.time() - t0
        check_run(run, epoch_lrs(1))
        saved = torch.load(os.path.join(run, "checkpoint.pth.tar"), map_location="cpu",
                           weights_only=True)["state_dict"]
    moved = {k for k in state if not torch.equal(saved[k], state[k])}
    head = {k for k in state if k.startswith("classifier.")}
    stats = {k for k in state if k.endswith(("running_mean", "running_var",
                                             "num_batches_tracked"))}
    require(head <= moved and stats <= moved and moved <= head | stats,
            f"train_fc: moved {sorted(moved - head - stats)[:4]} of the backbone, kept "
            f"{sorted((head | stats) - moved)[:4]}")
    print(f"  cli.train -a mobilenetv2 --train_fc, one epoch: main {out['main_s']:.2f} s (start "
          f"written in {out['write_s']:.2f} s); backbone unchanged, {len(stats)} "
          f"BatchNorm buffers and {len(head)} classifier tensors moved ({card})")
    return out


def zoo_phase(records, card: str, ckpt: str, data: str) -> dict:
    """Phase 11: each guide of the zoo at full width on the card against the
    CPU and through the phase-4 recipe, then ``cli.generate_data`` with the
    default ``-a`` from phase 6's checkpoint ``ckpt`` and ``cli.train -a
    mobilenetv2 --train_fc`` on phase 7's tree ``data``."""
    import torch

    pipe, _, inputs = build_path()
    out = {"guides": {}}
    for i, arch in enumerate(ZOO):
        gm = zoo_guide(arch, torch.device("cuda"), seed=20 + i)
        read = zoo_agreement(arch, gm, seed=20 + i)
        out["guides"][arch] = dict(read, **zoo_recipe(records, pipe, inputs, gm, card))
        del gm
        pipe.guide = None
        torch.cuda.empty_cache()
    del pipe, inputs
    gc.collect()
    torch.cuda.empty_cache()
    print("  -- cli.generate_data with the default -a (open_clip_vit_b32) from files on disk")
    out["cli"] = zoo_cli_phase(records, card, ckpt)
    print("  -- cli.train -a mobilenetv2 --train_fc (phase 7's cuts, one epoch)")
    out["train"] = zoo_train_phase(card, data)
    return out


# ------------------------------------------------------------- phase 12

PEAK_INT8_OPS = 1979e12  # dense int8 tensor-core rate (H100 SXM data sheet)
# the guidance update with config.int8 against the exact one on the card, the
# largest difference over its outputs relative to each output's largest:
# bit for bit on the CPU (tests/test_torch_int8.py), on the card within the
# run-to-run spread of the fused backward's dq sum (fp32 order, ~1e-7)
GUIDE_SPREAD_TOL = 1e-5
# the --params_path run's guided PNGs against the first run's, the mean of
# |difference| in 8-bit levels: two identical guided calls on the card
# differ (the dq sum's order moves the update; phase 12b prints by how
# much), so the byte-for-byte check is the unguided pair's
PARAMS_LEVELS_TOL = 1.0
INT8_DEEP_CACHE = dict(deep_cache=True, cache_interval=3, cache_branch=0)
INT8_TIMED = 20  # CUDA-event launches a shape


def unet_int8_layers(ucfg, side: int, batch: int, branch=None) -> list:
    """The int8 layers of one UNet forward at ``batch`` on a side^2 latent,
    in call order (models/unet.py): ("conv", batch, C_in, C_out, input
    side, stride) for the resnets' and the resamplers' 3x3 convolutions,
    ("dot", rows, K, N) for the feed-forward projections. With ``branch``,
    a DeepCache shallow call at that cache branch: the down levels up to
    it (no downsample at the branch) and the up groups from the one the
    cache enters."""
    boc, n, L = ucfg.block_out_channels, len(ucfg.block_out_channels), ucfg.layers_per_block
    out, skips, x_ch, s = [], [boc[0]], boc[0], side

    def res(cin, cout, s):
        out.extend([("conv", batch, cin, cout, s, 1), ("conv", batch, cout, cout, s, 1)])

    def ff(ch, s, depth):  # each transformer block's GEGLU and output projections
        for _ in range(depth):
            out.extend([("dot", batch * s * s, ch, 8 * ch), ("dot", batch * s * s, 4 * ch, ch)])

    def attn(bi, ch, s):
        if ucfg.cross_attention[bi]:
            ff(ch, s, ucfg.depth_at(bi))

    for bi, ch in enumerate(boc):
        if branch is not None and bi > branch:
            break
        for _ in range(L):
            res(x_ch, ch, s)
            x_ch = ch
            attn(bi, ch, s)
            skips.append(ch)
        if bi < n - 1 and not (branch is not None and bi == branch):
            out.append(("conv", batch, ch, ch, s, 2))
            skips.append(ch)
            s = _down(s)
    first = 0
    if branch is None:
        mid = boc[-1]
        res(mid, mid, s)
        ff(mid, s, ucfg.depth_at(n - 1))  # the mid block always has its transformer
        res(mid, mid, s)
    else:  # the cached feature: the output of up group n - 2 - branch, upsampled
        first = n - 1 - branch
        x_ch = boc[branch + 1]
    for ui in range(first, n):
        bi = n - 1 - ui
        ch = boc[bi]
        for _ in range(L + 1):
            res(x_ch + skips.pop(), ch, s)
            x_ch = ch
            attn(bi, ch, s)
        if bi > 0:
            s *= 2
            out.append(("conv", batch, ch, ch, s, 1))
    return out


def int8_mkn(layer) -> tuple:
    """(M, K, N) of a layer's int8 product, before padding."""
    if layer[0] == "dot":
        return layer[1:]
    _, b, cin, cout, s, stride = layer
    so = _down(s) if stride == 2 else s
    return b * so * so, 9 * cin, cout


def int8_plan(pipe, batch: int) -> collections.Counter:
    """``torch._int_mm`` calls by padded (M, K, N) of one expand call at
    ``batch`` under ``config.int8``: the plain spans' UNet calls on the CFG
    pair (full, or DeepCache's shallow ones); the guidance and the decode
    run none."""
    from distdiff_tpu_torch.ops.quant import int_mm_padding
    from distdiff_tpu_torch.schedulers import guidance_window, img2img_start_index

    cfg, gcfg = pipe.config, pipe.guidance_cfg
    n = pipe.sched.num_inference_steps
    start = img2img_start_index(pipe.sched, pipe.strength)
    g0, _ = guidance_window(pipe.sched, gcfg.guidance_step, gcfg.guidance_period)
    full, shallow = (a + b for a, b in zip(span_unet_calls(pipe, start, g0),
                                           span_unet_calls(pipe, g0, n)))
    plan = collections.Counter()
    for calls, branch in ((full, None), (shallow, cfg.cache_branch)):
        if calls:
            for layer in unet_int8_layers(cfg.unet, cfg.latent_size, 2 * batch, branch):
                plan[int_mm_padding(*int8_mkn(layer))] += calls
    return plan


def int8_bound(layer) -> tuple:
    """(bound_ms, bound_by) of one int8 layer as a function of its bf16
    input and weight to its bf16 output: those bytes once over the memory
    rate, or its products over the int8 tensor-core rate."""
    m, k, n = int8_mkn(layer)
    if layer[0] == "dot":
        nbytes = 2 * (m * k + k * n + m * n)
    else:
        _, b, cin, cout, s, _ = layer
        nbytes = 2 * (b * cin * s * s + 9 * cin * cout + m * n)
    t_bytes, t_ops = nbytes / PEAK_BYTES, 2.0 * m * k * n / PEAK_INT8_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def int8_op_phase(card: str) -> list:
    """Phase 12a: ``qconv``/``qdot`` at every int8 layer shape of one SD-1.5
    batch-2 call (the CFG pair: batch 4 at 64^2), seeded bf16 inputs on the
    card: the quantized operands against the same quantization on the CPU,
    the ``torch._int_mm`` accumulator and the layer's output against the
    plain version on the card (float64 products), bit for bit; then the
    route, ``_int_mm`` alone, the plain product and the bf16 cuDNN/cuBLAS
    layer timed (medians of CUDA events) beside the layer's bound."""
    import torch
    import torch.nn.functional as F

    from distdiff_tpu_torch.config import PipelineConfig
    from distdiff_tpu_torch.ops import quant

    dev = torch.device("cuda")
    cfg = PipelineConfig.sd15()
    layers = collections.Counter(unet_int8_layers(cfg.unet, cfg.latent_size, 2 * BATCH))
    gen = torch.Generator(device=dev).manual_seed(12)
    out = []
    for layer, count in sorted(layers.items()):
        m, k, n = int8_mkn(layer)
        if layer[0] == "dot":
            x = torch.randn(4, m // 4, k, generator=gen, device=dev).to(torch.bfloat16)
            w = (torch.randn(n, k, generator=gen, device=dev) / k ** 0.5).to(torch.bfloat16)
            bias = torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
            qx, sx = quant.quant_act(x)
            qw, sw = quant.quant_w(w)
            a, wm = qx.reshape(-1, k), qw
            route = lambda: quant.qdot(x, w, torch.bfloat16) + bias  # noqa: E731
            library = lambda: F.linear(x, w, bias)  # noqa: E731
        else:
            _, b, cin, cout, s, stride = layer
            x = torch.randn(b, s, s, cin, generator=gen, device=dev).to(
                torch.bfloat16).permute(0, 3, 1, 2)  # channels-last, as the UNet holds it
            w = (torch.randn(cout, cin, 3, 3, generator=gen, device=dev)
                 / (9 * cin) ** 0.5).to(torch.bfloat16)
            bias = torch.randn(cout, generator=gen, device=dev).to(torch.bfloat16)
            qx, sx = quant.quant_act(x)
            qw, sw = quant.quant_w(w)
            a, _ = quant.im2col(qx.permute(0, 2, 3, 1), (3, 3), (stride, stride), (1, 1))
            wm = qw.permute(0, 2, 3, 1).reshape(cout, -1)
            route = lambda: (quant.qconv(x, w, (stride, stride), (1, 1), torch.bfloat16)  # noqa: E731
                             + bias[:, None, None])
            library = lambda: F.conv2d(x, w, bias, stride, 1)  # noqa: E731
        cq, csx = quant.quant_act(x.cpu())
        cw, csw = quant.quant_w(w.cpu())
        require(torch.equal(qx.cpu(), cq) and torch.equal(qw.cpu(), cw)
                and torch.equal(sx.cpu(), csx) and torch.equal(sw.cpu(), csw),
                f"int8 {layer}: the card's quantization differs from the CPU's")
        quant.reset_counts()
        acc = quant.int_mm(a, wm)
        require(sum(quant.product_shapes.values()) == 1,
                f"int8 {layer}: the product did not go to torch._int_mm")
        plain = quant.int_mm_reference(a, wm)
        require(torch.equal(acc, plain), f"int8 {layer}: the int32 accumulator differs from "
                f"the plain product")
        y = route()
        want = quant.rescale(plain, sx, sw, torch.bfloat16)
        want = (want + bias) if layer[0] == "dot" else (
            want.reshape(y.shape[0], y.shape[2], y.shape[3], -1).permute(0, 3, 1, 2)
            + bias[:, None, None])
        require(torch.equal(y, want.reshape(y.shape)), f"int8 {layer}: the output differs from "
                f"the plain version's")
        mp, kp, np_ = quant.int_mm_padding(m, k, n)
        ap = torch.nn.functional.pad(a, (0, kp - k, 0, mp - m)).contiguous()
        wp = torch.nn.functional.pad(wm, (0, kp - k, 0, np_ - n)).contiguous()
        rec = {"layer": list(layer), "mkn": [m, k, n], "launches": count,
               "route_ms": time_ms(route, INT8_TIMED),
               "int_mm_ms": time_ms(lambda: torch._int_mm(ap, wp.t()), INT8_TIMED),
               "plain_ms": time_ms(lambda: quant.int_mm_reference(a, wm), 5),
               "library_ms": time_ms(library, INT8_TIMED)}
        rec["bound_ms"], rec["bound_by"] = int8_bound(layer)
        out.append(rec)
        print(f"  {layer[0]} {list(layer[1:])} (M,K,N {m},{k},{n}) x{count}: route "
              f"{rec['route_ms']:.4f} ms (_int_mm {rec['int_mm_ms']:.4f}), bf16 layer "
              f"{rec['library_ms']:.4f}, plain product {rec['plain_ms']:.3f}, bound "
              f"{rec['bound_ms']:.4f} ({rec['bound_by']})")
    total = {key: sum(r[key] * r["launches"] for r in out)
             for key in ("route_ms", "int_mm_ms", "library_ms", "bound_ms")}
    print(f"  one UNet call's {sum(layers.values())} int8 layers at these times: route "
          f"{total['route_ms']:.2f} ms (_int_mm {total['int_mm_ms']:.2f}), bf16 layers "
          f"{total['library_ms']:.2f}, bound {total['bound_ms']:.2f} ({card})")
    return out


def int8_levels(a, b) -> float:
    """Mean |difference| of two [0, 1] image batches in 8-bit levels."""
    return float(((a.float() * 255).round() - (b.float() * 255).round()).abs().mean())


def check_int8_plan(what: str, pipe) -> None:
    from distdiff_tpu_torch.ops import quant

    got, want = collections.Counter(quant.product_shapes), int8_plan(pipe, BATCH)
    require(got == want, f"{what}: int8 products {dict(got)}, the plan says {dict(want)}")
    print(f"  {what}: {sum(got.values())} int8 products over {len(got)} shapes (plan held)")


def int8_path_phase(records, pipe, inputs, exact_img, card: str) -> dict:
    """Phase 12b: SD-1.5 ``--int8`` on phase 4's live pipeline (its modules,
    recipe and inputs): a warm-up, a counted call (flash and GroupNorm
    launches by shape against phase 4's plan, int8 products against theirs,
    peak memory), a timed call, then ``--int8 --deep_cache`` (interval 3,
    branch 0) through SplitExpand, counted against its plan; the int8
    images' mean distance from phase 4's exact images on the same draws."""
    import dataclasses

    import torch

    from distdiff_tpu_torch.ops import groupnorm as gn
    from distdiff_tpu_torch.ops import quant

    dev = torch.device("cuda")

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    again = pipe.make_expand_fn()(*inputs, gen(2))  # phase 4's counted call, again
    rerun = int8_levels(again, exact_img)
    print(f"  phase 4's exact call again on the same draws: {rerun:.4f} 8-bit levels from its "
          f"first images (mean), {float((again - exact_img).abs().max()) * 255:.2f} at most")
    del again
    vp = dataclasses.replace(pipe, config=dataclasses.replace(pipe.config, int8=True))
    fused = vp.make_expand_fn()
    cold = wall_s(lambda: fused(*inputs, gen(1)))
    quant.reset_counts()
    img, by_shape, secs, peak = counted_call(lambda: fused(*inputs, gen(2)))
    check_images(img, 512, "SD-1.5 --int8")
    check_flash_plan(by_shape, flash_plan(vp, BATCH), "phase 12 SD-1.5 --int8")
    check_gn_plan(gn_only(by_shape), gn_plan(expand_gn_calls(vp, BATCH),
                                             smem_limit=gn._device_limits(dev)[0]))
    require_timed(records, by_shape, "phase 12 (SD-1.5 --int8)")
    check_int8_plan("SD-1.5 --int8 make_expand_fn", vp)
    timed = wall_s(lambda: fused(*inputs, gen(3)))
    levels = int8_levels(img, exact_img)
    require(math.isfinite(levels) and levels > 0, f"--int8 images {levels} levels from exact")
    print(f"  SD-1.5 --int8 batch {BATCH}: first call {cold:.2f} s, counted {secs:.3f} s, timed "
          f"{timed:.3f} s, peak {peak / 2**30:.2f} GiB; images {levels:.3f} 8-bit levels (mean "
          f"|difference|) from phase 4's exact ones on the same draws ({card})")
    vdc = dataclasses.replace(vp, config=dataclasses.replace(vp.config, **INT8_DEEP_CACHE))
    split = vdc.make_split_expand()
    quant.reset_counts()
    dimg, dshapes, dsecs, dpeak = counted_call(
        lambda: split(*inputs, [gen(20 + i) for i in range(BATCH)]))
    check_images(dimg, 512, "SD-1.5 --int8 --deep_cache")
    check_flash_plan(dshapes, flash_plan(vdc, BATCH), "phase 12 --int8 --deep_cache SplitExpand")
    require_timed(records, dshapes, "phase 12 (--int8 --deep_cache)")
    check_int8_plan("SD-1.5 --int8 --deep_cache SplitExpand", vdc)
    print(f"  SD-1.5 --int8 --deep_cache SplitExpand batch {BATCH}: {dsecs:.3f} s, peak "
          f"{dpeak / 2**30:.2f} GiB ({card})")
    return {"cold_s": cold, "counted_s": secs, "timed_s": timed, "peak_bytes": peak,
            "levels_from_exact": levels, "exact_rerun_levels": rerun, "deep_cache_s": dsecs,
            "deep_cache_peak_bytes": dpeak, "by_shape": by_shape + dshapes}


def sdxl_int8_call(records, pipe, expand_inputs, exact_img, card: str) -> dict:
    """Phase 12c: one SDXL-base ``--int8`` call at 1024^2, batch 2, on phase
    9's live pipeline and draws: launches by shape against phase 9's plan,
    int8 products against theirs, time, peak memory and the images'
    distance from phase 9's exact ones."""
    import dataclasses

    import torch

    from distdiff_tpu_torch.ops import groupnorm as gn
    from distdiff_tpu_torch.ops import quant

    dev = torch.device("cuda")
    vp = dataclasses.replace(pipe, config=dataclasses.replace(pipe.config, int8=True))
    fused = vp.make_expand_fn()
    quant.reset_counts()
    img, by_shape, secs, peak = counted_call(
        lambda: fused(*expand_inputs, torch.Generator(device=dev).manual_seed(2)))
    check_images(img, SDXL_SIDE, "SDXL --int8")
    check_flash_plan(by_shape, flash_plan(vp, BATCH), "phase 12 SDXL --int8")
    check_gn_plan(gn_only(by_shape), gn_plan(expand_gn_calls(vp, BATCH),
                                             smem_limit=gn._device_limits(dev)[0]))
    require_timed(records, by_shape, "phase 12 (SDXL --int8)")
    check_int8_plan("SDXL --int8 make_expand_fn", vp)
    levels = int8_levels(img, exact_img)
    require(math.isfinite(levels) and levels > 0, f"SDXL --int8 images {levels} levels off")
    print(f"  SDXL --int8 {SDXL_SIDE}^2 batch {BATCH}: {secs:.3f} s (the first int8 call), peak "
          f"{peak / 2**30:.2f} GiB; images {levels:.3f} 8-bit levels from phase 9's exact ones "
          f"({card})")
    return {"s": secs, "peak_bytes": peak, "levels_from_exact": levels, "by_shape": by_shape}


class Int8Inputs:
    """Forward pre-hooks on a UNet's int8 layers, active while the route is
    on: ``record`` keeps each call's (module name, input, output) on the
    CPU; ``pin`` hands each call, in order, the recorded input in place of
    its own (the quantizer is discontinuous: see tests/test_torch_int8.py)."""

    def __init__(self, unet, pinned=None):
        from distdiff_tpu_torch.models.layers import QConv2d, QLinear
        from distdiff_tpu_torch.ops import quant

        self.quant, self.pinned, self.calls, self.handles = quant, pinned, [], []
        for name, m in unet.named_modules():
            if isinstance(m, (QConv2d, QLinear)):
                self.handles.append(m.register_forward_pre_hook(
                    lambda mod, args, name=name: self.pre(name, args)))
                self.handles.append(m.register_forward_hook(
                    lambda mod, args, out, name=name: self.post(name, args, out)))

    def pre(self, name, args):
        if not self.quant.int8_enabled() or self.pinned is None:
            return None
        want, x, _ = self.pinned[len(self.calls)]
        require(want == name, f"pinned int8 call {len(self.calls)}: {name}, recorded {want}")
        return (x.to(args[0].device),) + tuple(args[1:])

    def post(self, name, args, out):
        if self.quant.int8_enabled():
            self.calls.append((name, args[0].detach().float().cpu(), out.detach().float().cpu()))

    def close(self):
        for h in self.handles:
            h.remove()


def int8_fp32_phase() -> dict:
    """Phase 12d: the fp32 tiny() guided expand under int8 on the card
    against the port on the CPU, the same weights and draws. The card's
    run records each int8 layer call; each is held against the CPU's layer
    on the same input (bit for bit), and the CPU's expand is run with each
    int8 layer given the card's input for that call: its images, updated
    latents and score within phase 3's tolerance, which must be at least
    10x below the card's int8-versus-exact gap. One guidance update with
    ``config.int8`` set equals the one without, bit for bit."""
    import dataclasses

    import torch

    from distdiff_tpu_torch.guidance import transform_guidance
    from distdiff_tpu_torch.ops import quant

    dev = torch.device("cuda")
    pipes, inputs, gen = tiny_fp32_pipes(seed=13, edit=lambda c: dataclasses.replace(c, int8=True))
    draws = dict(zip(("noise", "gamma0", "beta0"), pipes[0].draw_inputs(inputs[0], gen)))
    rec = Int8Inputs(pipes[1].unet)
    try:
        got = tiny_expand(pipes[1], dev, inputs, draws)
    finally:
        rec.close()
    layers = dict(pipes[0].unet.named_modules())
    with quant.int8_inference(), torch.no_grad():
        for i, (name, x, y) in enumerate(rec.calls):
            require(torch.equal(layers[name](x), y),
                    f"int8 call {i} ({name}): the card's output differs from the CPU's")
    print(f"  {len(rec.calls)} int8 layer calls of the card's expand equal the CPU's layers on "
          f"their inputs, bit for bit")
    pin = Int8Inputs(pipes[0].unet, pinned=rec.calls)
    try:
        want = tiny_expand(pipes[0], "cpu", inputs, draws)
    finally:
        pin.close()
    require(len(pin.calls) == len(rec.calls), "the pinned CPU run made other int8 calls")
    exact = tiny_expand(dataclasses.replace(
        pipes[1], config=dataclasses.replace(pipes[1].config, int8=False)), dev, inputs, draws)
    gap = float((got[0] - exact[0]).abs().max())
    print(f"  int8 against exact on the card: images {gap:.3e} apart (at least "
          f"{10 * FP32_TOL:.1e} needed)")
    require(gap >= 10 * FP32_TOL, f"int8 moved the tiny images by {gap}, under 10x the tolerance")
    agree_fp32(zip(("int8 image", "int8 updated latents", "int8 guidance score"), got, want))
    card = pipes[1]
    exact_pipe = dataclasses.replace(card, config=dataclasses.replace(card.config, int8=False))
    lat = inputs[0].to(dev) * 3
    cond, uncond, targets = (t.to(dev) for t in inputs[1:])
    g0 = card.window()[3]

    def update(p):
        new, score, grads = transform_guidance(p.guidance_context(), lat, cond, uncond,
                                               targets, g0, draws["gamma0"].to(dev),
                                               draws["beta0"].to(dev))
        return (new, score) + tuple(grads)

    def rel(a, b):
        return max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
                   for x, y in zip(a, b))

    quant.reset_counts()
    upd8 = update(card)
    products = sum(quant.product_shapes.values())
    exact_a, exact_b = update(exact_pipe), update(exact_pipe)
    diff, spread = rel(upd8, exact_a), rel(exact_b, exact_a)
    print(f"  the guidance update under config.int8: {products} int8 products; against the "
          f"exact update {diff:.3e} of each output's largest, two exact updates {spread:.3e} "
          f"apart (the fused backward's dq sums in an order that varies)")
    require(products == 0, "the guidance update ran int8 products")
    require(diff <= GUIDE_SPREAD_TOL, f"the guidance update moved with config.int8 ({diff})")
    return {"calls": len(rec.calls), "gap": gap, "err": float((got[0] - want[0]).abs().max()),
            "guidance_diff": diff, "guidance_spread": spread}


def params_phase(work: str, ckpt: str, guide_path: str, saved: str, first_pipe) -> dict:
    """Phase 12e, on phase 6's tree: ``generate_data.main`` with
    ``--params_path`` (the directory phase 6's run wrote with
    ``--save_params``) and no ``--sd_checkpoint``, for 2 images of the
    published recipe: its loaded tensors equal the first run's, bit for
    bit; its PNGs at the first run's paths, within PARAMS_LEVELS_TOL of
    them (a guided call does not repeat itself bit for bit on the card).
    Then the same 2 units unguided, from ``--sd_checkpoint`` and from
    ``--params_path``: their PNGs equal byte for byte. The directory's size
    and the load seconds (the save's are phase 6's)."""
    import os

    import numpy as np
    import torch

    from distdiff_tpu_torch.cli import generate_data as cli
    from distdiff_tpu_torch.parallel import read_png
    from distdiff_tpu_torch.weights import params_io

    bpe = ["--bpe_path", os.path.join(ckpt, "tokenizer", "merges.txt")]

    def argv(out, from_params, guided=True):
        a = cli_argv(os.path.join(work, "data"), ckpt, guide_path, out, units=2) + bpe
        if from_params:
            i = a.index("--sd_checkpoint")
            a[i:i + 2] = ["--params_path", saved]
        if not guided:
            a[a.index("--guidance_type") + 1] = "none"
        return a

    def pngs(out):
        root = os.path.join(work, out)
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs if f.endswith(".png"))

    def read(out, rel):
        with open(os.path.join(work, out, rel), "rb") as f:
            return f.read()

    seen, secs = {}, {}
    build, load = cli.build_pipeline, params_io.load_params

    def timed_load(*a, **kw):
        t = time.time()
        out = load(*a, **kw)
        torch.cuda.synchronize()
        secs.setdefault("load", time.time() - t)
        return out

    cwd = os.getcwd()
    try:
        cli.build_pipeline = lambda *a, **kw: seen.setdefault("pipe", build(*a, **kw))
        params_io.load_params = timed_load
        os.chdir(work)
        t0 = time.time()
        stats = cli.main(argv("out_params", True))
        secs["whole CLI"] = time.time() - t0
        pipe = seen.pop("pipe")
        for name in ("unet", "vae", "text_encoder"):
            want = getattr(first_pipe, name).state_dict()
            for k, v in getattr(pipe, name).state_dict().items():
                require(torch.equal(v, want[k]), f"--params_path {name} {k}: the loaded tensor "
                        f"differs from the first run's")
        del pipe
        t0 = time.time()
        for out, from_params in (("out_unguided_ckpt", False), ("out_unguided_params", True)):
            cli.main(argv(out, from_params, guided=False))
            seen.pop("pipe")
        secs["unguided pair"] = time.time() - t0
    finally:
        os.chdir(cwd)
        cli.build_pipeline, params_io.load_params = build, load
    got = pngs("out_params")
    require(stats["written"] == len(got) == 2 and set(got) <= set(pngs("out")),
            f"--params_path run wrote {got}")
    levels = [np.abs(read_png(os.path.join(work, "out_params", rel)).astype(int)
                     - read_png(os.path.join(work, "out", rel)).astype(int)) for rel in got]
    mean = float(np.mean([d.mean() for d in levels]))
    same = sum(read("out_params", rel) == read("out", rel) for rel in got)
    print(f"  --params_path run: loaded tensors equal the first run's; PNGs at its paths, "
          f"{same} of {len(got)} byte for byte, {mean:.4f} 8-bit levels from them (mean), "
          f"{max(int(d.max()) for d in levels)} at most")
    require(mean <= PARAMS_LEVELS_TOL, f"--params_path PNGs {mean} levels from the first run's")
    unguided = pngs("out_unguided_params")
    require(len(unguided) == 2 and unguided == pngs("out_unguided_ckpt"),
            f"the unguided pair wrote {unguided}")
    for rel in unguided:
        require(read("out_unguided_params", rel) == read("out_unguided_ckpt", rel),
                f"unguided PNG {rel}: --params_path differs from --sd_checkpoint")
    size = sum(os.path.getsize(os.path.join(saved, f)) for f in os.listdir(saved))
    print(f"  unguided, --params_path against --sd_checkpoint: {len(unguided)} PNGs equal byte "
          f"for byte; {size / 1e9:.3f} GB of parameter files loaded in {secs['load']:.2f} s, "
          f"the guided main {secs['whole CLI']:.2f} s, the unguided pair "
          f"{secs['unguided pair']:.2f} s")
    return {"bytes": size, "secs": secs, "guided_levels": mean, "guided_same": same}


# ------------------------------------------------------------- phase 14

# flash_attention_lse at SD-1.5's self-attention shapes cut in two along the
# tokens (one ring step of a 2-way seq mesh), and at the VAE's D = 512
# (label, B, H, T of q and of kv, D); phase 2 holds and times flash_fwd there
LSE_SHAPES = [("sp64", BATCH, 8, 2048, 40), ("sp32", BATCH, 8, 512, 80),
              ("sp_vae", 1, 1, 2048, 512)]
MESH_DEVICES = 2  # the virtual meshes: cuda:0 twice
TP_SPREAD = 2.0  # the TP UNet's distance from the unsharded call, in bf16 spreads


def _bf16_err(got, want) -> tuple:
    """(max |got - want|, phase 2's bf16 tolerance: 2^-7 of want's largest
    magnitude)."""
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max()), 2.0 ** -7 * float(want.abs().max())


def _hold(what: str, got, want, tol=None) -> float:
    err, bf16_tol = _bf16_err(got, want)
    tol = bf16_tol if tol is None else tol
    ok = math.isfinite(err) and err <= tol
    print(f"  {what}: max_abs_err {err:.3e} (tol {tol:.3e}) {'ok' if ok else 'FAIL'}")
    require(ok, f"{what} disagrees")
    return err


def lse_phase(records, card: str) -> dict:
    """``flash_attention_lse`` against its plain version (``parallel.sp
    .xla_attention_lse`` in fp32 on the same bf16 inputs): o, lse, and the
    q, k, v gradients of sum(o * w_o) + sum(lse * w_l) with a random
    nonzero lse cotangent, at phase 2's bf16 tolerances; the op's time
    (forward, and forward + backward) beside phase 2's flash_fwd kernel at
    the same shape."""
    import torch

    from distdiff_tpu_torch.ops import flash
    from distdiff_tpu_torch.parallel.sp import xla_attention_lse

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    out = {}
    for label, b, h, t, d in LSE_SHAPES:
        q, k, v = (torch.randn(b, t, h, d, generator=gen, device=dev).to(torch.bfloat16)
                   .requires_grad_(True) for _ in range(3))
        w_o = torch.randn(b, t, h, d, generator=gen, device=dev)
        w_l = torch.randn(b, t, h, generator=gen, device=dev)
        before = dict(flash.launch_counts)
        o, lse = flash.flash_attention_lse(q, k, v)
        grads = torch.autograd.grad((o.float() * w_o).sum() + (lse * w_l).sum(), (q, k, v))
        torch.cuda.synchronize()
        launched = {n: flash.launch_counts[n] - before[n] for n in before
                    if flash.launch_counts[n] > before[n]}
        want_bwd = {"flash_bwd_fused"} if d <= flash.FUSED_BWD_MAX_D else \
            {"flash_bwd_dq", "flash_bwd_dkv"}
        require(set(launched) == {"flash_fwd"} | want_bwd,
                f"flash_attention_lse at {label} launched {launched}")
        q32, k32, v32 = (x.detach().float().requires_grad_(True) for x in (q, k, v))
        ro, rl = xla_attention_lse(q32, k32, v32)
        rgrads = torch.autograd.grad((ro * w_o).sum() + (rl * w_l).sum(), (q32, k32, v32))
        _hold(f"flash_attention_lse {label} [{b},{t},{h},{d}] o", o, ro)
        _hold(f"flash_attention_lse {label} lse", lse, rl, tol=1e-4)
        for name, g, r in zip(("dq", "dk", "dv"), grads, rgrads):
            _hold(f"flash_attention_lse {label} {name} (lse cotangent nonzero)", g, r)
        qd, kd, vd = (x.detach() for x in (q, k, v))
        fwd_ms = time_ms(lambda: flash.flash_attention_lse(qd, kd, vd), 10)

        def both():
            oo, ll = flash.flash_attention_lse(q, k, v)
            torch.autograd.grad((oo.float() * w_o).sum() + (ll * w_l).sum(), (q, k, v))

        both_ms = time_ms(both, 5)
        rec = next(r for r in records if r["name"] == "flash_fwd"
                   and r["shape"] == [b * h, t, t, d])
        print(f"  flash_attention_lse {label}: forward op {fwd_ms:.3f} ms, forward + backward "
              f"{both_ms:.3f} ms; phase 2's flash_fwd kernel at [{b * h},{t},{t},{d}] "
              f"{rec['ms']:.3f} ms ({card})")
        out[label] = {"fwd_ms": fwd_ms, "fwd_bwd_ms": both_ms, "flash_fwd_ms": rec["ms"],
                      "launches": launched}
    return out


def sp_phase(card: str) -> dict:
    """``sp_attention`` on a 2-way seq mesh of cuda:0 against the unsharded
    ``flash_attention`` at [2, 4096, 8, 40] bf16: the output at phase 2's
    bf16 tolerance, the q, k, v gradients (each a bf16 sum of two ring
    steps' partials) at twice it."""
    import torch

    from distdiff_tpu_torch.ops import flash
    from distdiff_tpu_torch.parallel.sp import make_sp_mesh, sp_attention

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(15)
    q, k, v = (torch.randn(BATCH, 4096, 8, 40, generator=gen, device=dev).to(torch.bfloat16)
               .requires_grad_(True) for _ in range(3))
    w = torch.randn(BATCH, 4096, 8, 40, generator=gen, device=dev)
    mesh = make_sp_mesh(MESH_DEVICES, ["cuda:0"] * MESH_DEVICES)
    flash.reset_launch_counts()
    t0 = time.time()
    o = sp_attention(q, k, v, mesh)
    grads = torch.autograd.grad((o.float() * w).sum(), (q, k, v))
    torch.cuda.synchronize()
    ring_s = time.time() - t0
    shapes = dict(flash.launch_shapes)
    ref = flash.flash_attention(q, k, v)
    rgrads = torch.autograd.grad((ref.float() * w).sum(), (q, k, v))
    _hold("sp_attention [2,4096,8,40] on 2 seq shards: out", o, ref)
    for name, g, r in zip(("dq", "dk", "dv"), grads, rgrads):
        # each gradient is the bf16 sum of the two ring steps' partials, one
        # rounding more than the unsharded kernel's: twice phase 2's limit
        _hold(f"sp_attention {name}", g, r, tol=2.0 * _bf16_err(g, r)[1])
    want = {("flash_fwd", (16, 2048, 2048, 40)): MESH_DEVICES ** 2,
            ("flash_bwd_fused", (16, 2048, 2048, 40)): MESH_DEVICES ** 2}
    require(shapes == want, f"the ring launched {shapes}, want {want}")
    print(f"  the ring's launches {shapes}; forward + backward {ring_s * 1e3:.1f} ms wall, "
          f"first call ({card})")
    return {"launches": {f"{n} {list(sh)}": c for (n, sh), c in shapes.items()},
            "wall_ms": ring_s * 1e3}


def pp_tp_unet_phase(pipe, card: str) -> dict:
    """On phase 4's SD-1.5 UNet (bf16, on the card): a 2-stage
    ``PipelinedUNet`` over cuda:0 twice against the whole call, and
    microbatched against the whole call on each microbatch, both bit for bit
    (the same operations in the same order); then the UNet turned into its
    tensor-parallel form on a 1 x 2 mesh of cuda:0 (the shards are views:
    the device memory must not grow) against the unsharded call. Tensor
    parallelism rounds its partial sums to bf16 before the all-reduce, so it
    is held to the bf16 spread of the unsharded call itself: the distance
    between the whole batch and the same batch in two halves (other
    cuBLAS/cuDNN choices, the same function), at most TP_SPREAD times it.
    Each form is timed."""
    import torch

    from distdiff_tpu_torch.parallel.mesh import make_expand_mesh
    from distdiff_tpu_torch.parallel.pp import PipelinedUNet
    from distdiff_tpu_torch.parallel.tp import tensor_parallel, unet_param_shardings

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    unet = pipe.unet
    cfg_b = 2 * BATCH
    x = torch.randn(cfg_b, 64, 64, 4, generator=gen, device=dev)
    ctx = torch.randn(cfg_b, 77, 768, generator=gen, device=dev)
    t = torch.full((cfg_b,), 501, device=dev)
    out = {}
    with torch.no_grad():
        ref = unet(x, t, ctx)
        halves = torch.cat([unet(x[i:i + BATCH], t[i:i + BATCH], ctx[i:i + BATCH])
                            for i in (0, BATCH)])
        pp = PipelinedUNet(unet, n_stages=2, devices=["cuda:0"] * MESH_DEVICES)
        got = pp(x, t, ctx)
        micro = pp.microbatched(x, t, ctx)
        torch.cuda.synchronize()
        out["pp_bitwise"] = torch.equal(got, ref)
        out["pp_micro_bitwise"] = torch.equal(micro, halves)
        print(f"  PipelinedUNet, 2 stages {pp.boundaries} on cuda:0 twice: "
              f"{'bit for bit' if out['pp_bitwise'] else 'NOT bit for bit'} the whole call; "
              f"microbatched: {'bit for bit' if out['pp_micro_bitwise'] else 'NOT bit for bit'} "
              f"the whole call on each microbatch")
        require(out["pp_bitwise"] and out["pp_micro_bitwise"],
                "the pipelined UNet is not the whole UNet's arithmetic")
        spread, _ = _bf16_err(halves, ref)
        out["bf16_spread"] = spread
        out["unet_ms"] = time_ms(lambda: unet(x, t, ctx), 3)
        out["pp_ms"] = time_ms(lambda: pp(x, t, ctx), 3)
        out["pp_micro_ms"] = time_ms(lambda: pp.microbatched(x, t, ctx), 3)
        mesh = make_expand_mesh(MESH_DEVICES, ["cuda:0"] * MESH_DEVICES)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        tensor_parallel(unet, mesh, shardings=unet_param_shardings(mesh, unet))
        grew = torch.cuda.memory_allocated() - mem0
        require(grew < 2 ** 20, f"the tensor-parallel form allocated {grew} bytes")
        got = unet(x, t, ctx)
        err, _ = _bf16_err(got, ref)
        rel = float((got - ref).norm() / ref.norm())
        rel_spread = float((halves - ref).norm() / ref.norm())
        out.update(tp_err=err, tp_rel_l2=rel, spread_rel_l2=rel_spread)
        ok = math.isfinite(err) and err <= TP_SPREAD * spread
        print(f"  tensor-parallel SD-1.5 UNet on a 1 x 2 mesh against the unsharded call: "
              f"max_abs_err {err:.3e}, rel l2 {rel:.3e}; the unsharded call's own bf16 spread "
              f"(whole batch against two halves) {spread:.3e}, rel l2 {rel_spread:.3e} "
              f"(limit {TP_SPREAD} x the spread) {'ok' if ok else 'FAIL'}")
        require(ok, "the tensor-parallel UNet strays beyond the bf16 spread")
        out["tp_ms"] = time_ms(lambda: unet(x, t, ctx), 3)
    print(f"  SD-1.5 UNet at batch {cfg_b}: whole {out['unet_ms']:.2f} ms, 2 stages "
          f"{out['pp_ms']:.2f} ms, microbatched {out['pp_micro_ms']:.2f} ms, tensor-parallel "
          f"{out['tp_ms']:.2f} ms; the form added {grew} bytes ({card})")
    return out


def tp_fp32_phase() -> None:
    """The fp32 tiny() guided SplitExpand under tensor parallelism (a 1 x 2
    mesh: cuda:0 twice on the card, the CPU twice on the CPU) on the card
    against the same port on the CPU, at phase 3's fp32 tolerance."""
    import torch

    from distdiff_tpu_torch.parallel.mesh import make_expand_mesh
    from distdiff_tpu_torch.parallel.tp import TPAttention, unet_param_shardings

    pipes, inputs, gen = tiny_fp32_pipes(seed=21)
    draws = dict(zip(("noise", "gamma0", "beta0"), pipes[0].draw(inputs[0], gen)))
    outs = []
    for pipe, dev in zip(pipes, ("cpu", "cuda:0")):
        mesh = make_expand_mesh(MESH_DEVICES, [dev] * MESH_DEVICES)
        split = pipe.make_split_expand(mesh=mesh,
                                       param_shardings=unet_param_shardings(mesh, pipe.unet))
        require(isinstance(pipe.unet.mid_block.attentions[0].transformer_blocks[0].attn1,
                           TPAttention), "the UNet is not in its tensor-parallel form")
        img = split(*(t.to(dev) for t in inputs), **{k: v.to(dev) for k, v in draws.items()})
        outs.append(img.float().cpu())
    agree_fp32([("tensor-parallel tiny guided image", outs[1], outs[0])])


def mesh_train_phase() -> dict:
    """``tiny_resnet`` steps on a 2-way data mesh of cuda:0, data-parallel
    and FSDP, each card step from the CPU one-device step's state on the
    same batch, held to phase 7's limits (the loss relative, the running
    statistics absolute, each parameter's step relative to its size)."""
    import copy

    import torch

    from distdiff_tpu_torch.models.guide import create_model
    from distdiff_tpu_torch.models.init import init_weights
    from distdiff_tpu_torch.parallel.fsdp import make_fsdp_train_step
    from distdiff_tpu_torch.parallel.mesh import make_mesh
    from distdiff_tpu_torch.train import (
        TrainConfig,
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    gen = torch.Generator().manual_seed(22)
    n_cls, b = 10, 16
    batches = [(torch.rand(b, 32, 32, 3, generator=gen).numpy(),
                torch.randint(0, n_cls, (b,), generator=gen).numpy(), torch.ones(b).numpy())
               for _ in range(3)]
    base = create_model("tiny_resnet", n_cls, device="cpu", trainable=True)
    init_weights(base.module, gen)
    start = base.module.state_dict()
    cfg = TrainConfig(lr=0.1, epochs=2)
    mesh = make_mesh(["cuda:0"] * MESH_DEVICES)
    reads = {}
    for kind in ("data-parallel", "fsdp"):
        cpu = create_model("tiny_resnet", n_cls, device="cpu", trainable=True)
        cpu.module.load_state_dict(start)
        ctx = make_optimizer(cpu.module, cfg, len(batches))
        cstate, cstep = create_train_state(cpu.module, ctx), make_train_step(cpu.module, ctx)
        read = {"loss": 0.0, "stats": 0.0, "update": 0.0}
        for x, y, m in batches:
            card = create_model("tiny_resnet", n_cls, device="cuda", trainable=True)
            card.module.load_state_dict(cpu.module.state_dict())
            ttx = make_optimizer(card.module, cfg, len(batches))
            ttx.load_state_dict(copy.deepcopy(ctx.state_dict()))
            tstate = create_train_state(card.module, ttx)
            before = {k: v.detach().clone() for k, v in cpu.module.state_dict().items()}
            if kind == "fsdp":
                step, fs = make_fsdp_train_step(card.module, ttx, tstate, mesh=mesh,
                                                min_shard_elems=512)
                require(any(len(p) == MESH_DEVICES for p in fs.shards.values()),
                        "FSDP split no parameter")
                fs, got = step(fs, x, y, m)
                after = {k: v.cpu() for k, v in fs.unshard().state_dict().items()}
            else:
                tstep = make_train_step(card.module, ttx, mesh=mesh)
                tstate, got = tstep(tstate, x, y, m)
                after = {k: v.cpu() for k, v in tstate.module.state_dict().items()}
            cstate, want = cstep(cstate, x, y, m)
            read["loss"] = max(read["loss"], abs(float(got["loss"]) / float(want["loss"]) - 1))
            params = {k for k, _ in cpu.module.named_parameters()}
            for k, v in cpu.module.state_dict().items():
                if not v.is_floating_point():
                    continue
                if k in params:
                    stepn = float((v - before[k]).norm())
                    read["update"] = max(read["update"], float((after[k] - v).norm()) / stepn)
                else:
                    read["stats"] = max(read["stats"], float((after[k] - v).abs().max()))
        ok = (read["loss"] <= TRAIN_LOSS_TOL and read["stats"] <= TRAIN_STATS_TOL
              and read["update"] <= TRAIN_UPDATE_TOL)
        print(f"  tiny_resnet {kind} steps on cuda:0 twice against the one-device CPU step: "
              f"loss {read['loss']:.2e} (tol {TRAIN_LOSS_TOL:.0e}), statistics "
              f"{read['stats']:.2e} (tol {TRAIN_STATS_TOL:.0e}), steps {read['update']:.2e} "
              f"(tol {TRAIN_UPDATE_TOL:.0e}) {'ok' if ok else 'FAIL'}")
        require(ok, f"the {kind} mesh step strays from the one-device CPU step")
        reads[kind] = read
    return reads


def mesh_cli_phase(work: str, ckpt: str, guide_path: str) -> dict:
    """``cli.generate_data.main --mesh_model 2`` on phase 6's tree, its
    latent and prototype caches, checkpoint and guide, with
    ``parallel.mesh.local_devices`` giving cuda:0 twice: every transformer
    block's attention tensor-parallel over the 1 x 2 mesh, every kernel
    launched (counted, by shape), the PNGs against phase 6's on the same
    draws, each expand call timed, the run's peak memory."""
    import numpy as np
    import torch

    from distdiff_tpu_torch.cli import generate_data as cli
    from distdiff_tpu_torch.ops import flash
    from distdiff_tpu_torch.ops import groupnorm as gn
    from distdiff_tpu_torch.parallel import mesh, read_png, tp
    from distdiff_tpu_torch.sampling.pipeline import SplitExpand

    calls, groups = [], collections.Counter()
    split_call, attn_fwd = SplitExpand.__call__, tp.TPAttention.forward

    def timed_call(self, *a, **kw):
        t = time.time()
        img = split_call(self, *a, **kw)
        if self.mesh is not None:  # the mesh's call, not its data index's inside it
            torch.cuda.synchronize()
            calls.append(time.time() - t)
        return img

    def counted_attn(self, *a, **kw):
        groups[len(self.group)] += 1
        return attn_fwd(self, *a, **kw)

    local = mesh.local_devices
    cwd = os.getcwd()
    flash.reset_launch_counts()
    gn.reset_launch_counts()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()  # earlier phases' live tensors
    torch.cuda.reset_peak_memory_stats()
    try:
        SplitExpand.__call__, tp.TPAttention.forward = timed_call, counted_attn
        mesh.local_devices = lambda: [torch.device("cuda", 0)] * MESH_DEVICES
        os.chdir(work)
        t0 = time.time()
        stats = cli.main(cli_argv(os.path.join(work, "data"), ckpt, guide_path, "out_mesh")
                         + ["--mesh_model", str(MESH_DEVICES)])
        torch.cuda.synchronize()
        whole_s = time.time() - t0
    finally:
        os.chdir(cwd)
        SplitExpand.__call__, tp.TPAttention.forward = split_call, attn_fwd
        mesh.local_devices = local
    peak = torch.cuda.max_memory_allocated()
    counts = dict(flash.launch_counts, **gn.launch_counts)
    by_shape = collections.Counter(flash.launch_shapes) + collections.Counter(gn.launch_shapes)
    require(dict(groups) and set(groups) == {MESH_DEVICES},
            f"tensor-parallel attention calls by group size: {dict(groups)}")
    for name in REPLACES:
        require(counts.get(name, 0) > 0, f"{name} was not launched by the --mesh_model run")
    levels = []
    for d, _, fs in os.walk(os.path.join(work, "out_mesh")):
        for f in fs:
            got = read_png(os.path.join(d, f)).astype(int)
            want = read_png(os.path.join(d.replace("out_mesh", "out"), f)).astype(int)
            require(got.shape == want.shape == (512, 512, 3), f"{f}: {got.shape}")
            levels.append(float(np.abs(got - want).mean()))
    require(stats["written"] == len(levels) == CLI_UNITS,
            f"{stats['written']} written, {len(levels)} PNGs")
    # the same draws through the same function, its partial sums rounded
    # to bf16 in another order: held as phase 12e holds a guided rerun
    require(max(levels) <= PARAMS_LEVELS_TOL,
            f"--mesh_model 2's PNGs are {max(levels):.3f} levels (mean) from phase 6's")
    for (name, shape), c in sorted(flash.launch_shapes.items()):
        print(f"  --mesh_model 2: {name} {list(shape)}: {c}")
    print(f"  --mesh_model 2: {stats['written']} PNGs, each against phase 6's on the same "
          f"draws: {[round(v, 3) for v in levels]} levels mean; {sum(groups.values())} "
          f"tensor-parallel attention calls; launches {counts}")
    print(f"  --mesh_model 2: whole CLI {whole_s:.1f} s, expand calls "
          f"{[round(c, 3) for c in calls]} s, peak {(peak - held) / 2**30:.2f} GiB above the "
          f"{held / 2**30:.2f} GiB earlier phases hold ({card_line()})")
    return {"counts": counts, "by_shape": by_shape, "stats": stats, "whole_s": whole_s,
            "calls_s": calls, "warm_s": calls[-1], "peak_bytes": peak - held,
            "held_bytes": held, "png_levels": levels}


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


def require_timed(records, by_shape, what: str) -> None:
    """Every (kernel, shape) that a counted run launched was held against
    its plain version, and timed, in phase 2."""
    held = {(r["name"], tuple(r["shape"])) for r in records}
    missing = sorted(k for k in by_shape if k[0] in REPLACES and k not in held)
    require(not missing, f"{what} launched kernels at shapes phase 2 did not hold "
            f"against their plain versions: {missing}")


def call_weighted(records, launches, names) -> dict:
    """Per kernel of ``names``: the means of phase 2's per-shape numbers
    (kernel, plain, library and bound ms) over the shapes of ``launches``
    ({(kernel, shape): count}, one counted call), weighted by the launches
    there."""
    out = {}
    for name in names:
        recs = [(r, launches.get((name, tuple(r["shape"])), 0)) for r in records
                if r["name"] == name]
        n = sum(c for _, c in recs)
        require(n > 0, f"{name}: no timed shape was launched in the counted call")
        out[name] = {key: sum(r[key] * c for r, c in recs) / n
                     for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
        out[name].update(shapes=sum(1 for _, c in recs if c), launches=n)
    return out


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


def build_path(config=None):
    """The main path at full SD-1.5 geometry (or ``config``'s, e.g.
    ``PipelineConfig.sd21()``) on the card: the pipeline (seeded random
    weights, bf16 UNet/VAE, fp32 ResNet-50 guide with 100 classes and
    random prototypes), its expand function and its inputs (for SDXL the
    conditioning of both text towers on prompts, else random contexts)."""
    import torch

    from distdiff_tpu_torch.config import GuidanceConfig, PipelineConfig
    from distdiff_tpu_torch.models.guide import create_model
    from distdiff_tpu_torch.models.init import init_weights
    from distdiff_tpu_torch.sampling import ExpansionPipeline, SamplerConfig, cast_params_bf16

    config = PipelineConfig.sd15() if config is None else config
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    guide = create_model("resnet50", num_classes=100, device=dev)
    init_weights(guide.module, gen)
    gcfg = GuidanceConfig()  # reference recipe: step 20 of 50 from the end, period 2, rho 10, l-inf 0.2
    fd = guide.feature_dim
    gp = torch.randn(100, fd, generator=gen, device=dev)
    lp = torch.randn(100, gcfg.K, fd, generator=gen, device=dev)
    pipe = ExpansionPipeline.create(
        config, sampler_cfg=SamplerConfig(guidance_scale=7.5),
        guidance_cfg=gcfg, guide=guide, global_protos=gp, local_protos=lp,
        strength=0.5, seed=0, device=dev)
    cast_params_bf16(pipe)
    print(f"  UNet {sum(p.numel() for p in pipe.unet.parameters()) / 1e6:.1f}M params, VAE "
          f"{sum(p.numel() for p in pipe.vae.parameters()) / 1e6:.1f}M, guide "
          f"{sum(p.numel() for p in guide.module.parameters()) / 1e6:.1f}M")
    ls = pipe.config.latent_size
    ctx = config.unet.cross_attention_dim
    lat = torch.randn(BATCH, ls, ls, 4, generator=gen, device=dev) * 0.18
    if pipe.is_sdxl:  # both towers on the card: the {"ctx", "add"} dicts
        from distdiff_tpu_torch.models import HashTokenizer

        tok = HashTokenizer(config.text_encoder.vocab_size, config.text_encoder.max_length)
        ids = torch.as_tensor(tok([f"a photo of a class_{i:03d}" for i in range(BATCH)]),
                              device=dev).long()
        uids = torch.as_tensor(tok([""] * BATCH), device=dev).long()
        cond, uncond = pipe.encode_text_pair(ids, ids), pipe.encode_text_pair(uids, uids)
    else:
        cond = torch.randn(BATCH, 77, ctx, generator=gen, device=dev)
        uncond = torch.randn(BATCH, 77, ctx, generator=gen, device=dev)
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
    """torch.profiler over one warm call of ``expand(*inputs, generator)``
    (an expand call, or the LoRA step): device time by layer and by
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
    print(f"  one warm call under the profiler: wall {wall_s * 1e3:.1f} ms, device "
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

    script_t0 = time.time()
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

    if "--profile" in argv and "--lora" in argv:
        from distdiff_tpu_torch.train.lora import draw_t_noise

        print("== profile of the LoRA step (SD-1.5, batch 8, 512^2, rank 8)")
        cfg, _, lora, step, lat, ctx = build_lora_step(torch.Generator().manual_seed(41))
        side = cfg.latent_size

        def one_step(gen):
            return step(lora, lat, ctx, *draw_t_noise(gen, LORA_BATCH, (side, side, 4), 1000))

        json_path = argv[argv.index("--json") + 1] if "--json" in argv else None
        profile_path(one_step, (), json_path)
        return 0

    if "--profile" in argv:
        from distdiff_tpu_torch.config import PipelineConfig

        sd21, sdxl = "--sd21" in argv, "--sdxl" in argv
        print(f"== profile of the {'SD-2.1 768-v' if sd21 else 'SDXL-base' if sdxl else 'main'} "
              f"path")
        _, expand, inputs = build_path(PipelineConfig.sd21() if sd21 else
                                       PipelineConfig.sdxl_base() if sdxl else None)
        json_path = argv[argv.index("--json") + 1] if "--json" in argv else None
        profile_path(expand, inputs, json_path)
        return 0

    print("== 2. kernels")
    records = kernel_phase()
    print("  -- fp32 flash")
    fp32_records = flash_f32_phase()
    print("  -- GroupNorm")
    records += gn_kernel_phase(gn_shapes(main_gn_calls() + sd21_gn_calls() + sdxl_gn_calls()
                                         + lora_main_gn_calls()))

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
    require_timed(records, by_shape, "phase 4")
    print(f"  norms by memory format: {layouts}")
    for name, m in call_weighted(records, gn_shapes_run, ("gn_stats", "gn_apply")).items():
        print(f"  {name}, its {m['shapes']} shapes of a call weighted by its {m['launches']} "
              f"launches there (phase 2's times): kernel {m['ms']:.4f} ms, plain "
              f"{m['plain_ms']:.4f} ms, F.group_norm+silu {m['library_ms']:.4f} ms (whole "
              f"norm), bound {m['bound_ms']:.4f} ms")

    print("== 5. front-end path (generate_data): text, encode, prototypes, driver")
    front = frontend_phase(pipe)
    require_timed(records, front["by_shape"], "phase 5")
    split = split_call_phase(pipe, front["split"], front["items"])

    print("== 6. generate_data CLI: the published recipe from files on disk")
    t0 = time.time()
    # phase 6's SD-1.5 checkpoint, which phases 10 and 11 read as well
    files = tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__)),
                                        prefix=".smoke_files_")
    sd15_ckpt = os.path.join(files.name, "sd15")
    cli = cli_phase(sd15_ckpt)
    require_timed(records, cli["by_shape"], "phase 6")
    for stage, s in cli["secs"].items():
        print(f"  {stage}: {s:.2f} s ({card})")
    print(f"  driver: {cli['stats']['images_per_sec']:.3f} images/s over "
          f"{cli['stats']['written']} images ({card})")
    print("  -- text_to_img and offset_noise, fp32 tiny, card against CPU")
    t2i_offset_phase()
    print(f"  phase 6: {time.time() - t0:.1f} s ({card})")

    print("== 12a. the int8 route at every int8 shape of one SD-1.5 call")
    t0 = time.time()
    int8_ops = int8_op_phase(card)
    print("== 12b. SD-1.5 --int8 on phase 4's pipeline")
    int8_path = int8_path_phase(records, pipe, inputs, img, card)
    print("== 12d. the fp32 tiny() --int8 expand on the card against the CPU")
    int8_fp32 = int8_fp32_phase()
    int8_s = time.time() - t0
    print(f"  phase 12a, 12b, 12d: {int8_s:.1f} s ({card})")

    print("== 14. the parallel modules on virtual meshes of cuda:0 (14g ran in phase 6)")
    t0 = time.time()
    mesh_cli = cli["mesh"]
    require_timed(records, mesh_cli["by_shape"], "phase 14g")
    print(f"  14g --mesh_model 2: warm expand call {mesh_cli['warm_s']:.3f} s, peak "
          f"{mesh_cli['peak_bytes'] / 2**30:.2f} GiB (the CLI's pipeline and its calls); "
          f"phase 4: warm {warm_s:.3f} s, peak {peak / 2**30:.2f} GiB (its pipeline and "
          f"its call) ({card})")
    print("  -- 14a. flash_attention_lse against its plain version")
    lse = lse_phase(records, card)
    print("  -- 14b. sp_attention on a 2-way seq mesh against flash_attention")
    sp = sp_phase(card)
    print("  -- 14c/d. PipelinedUNet and the tensor-parallel UNet at SD-1.5 width")
    pp_tp = pp_tp_unet_phase(pipe, card)
    print("  -- 14e. the fp32 tiny() guided expand under tensor parallelism, card against CPU")
    tp_fp32_phase()
    print("  -- 14f. tiny_resnet on a 2-way data mesh, data-parallel and FSDP, card against CPU")
    mesh_train = mesh_train_phase()
    parallel_s = time.time() - t0 + mesh_cli["whole_s"]
    print(f"  phase 14: {parallel_s:.1f} s, 14g's CLI run included ({card})")

    print("== 7. the classifier trainer (cli.train, cli.train_expanded)")
    t0 = time.time()
    print("  -- tiny_resnet steps, fp32, card against CPU")
    train_agree = train_agreement_phase()
    print("  -- the train step alone at ResNet-50 width")
    step_timing = train_step_timing(card)
    print("  -- ResNet-50 at full width through the CLIs")
    work = os.path.join(files.name, "train")  # phase 11 trains on its tree too
    os.makedirs(work)
    trainer = train_phase(card, work)
    print(f"  -- cli.train_transform: each --transform_type, one epoch at --expand_num 0 "
          f"(cut from 100 epochs and 5) on {TRANSFORM_TRAIN} train image a class, then "
          f"default over the expanded tree")
    t1 = time.time()
    transform = train_transform_phase(card, work)
    transform["phase_s"] = time.time() - t1
    print(f"  cli.train_transform runs: {transform['phase_s']:.1f} s, the trees written in "
          f"{transform['write_s']:.2f} s ({card})")
    print(f"  phase 7: {time.time() - t0:.1f} s ({card})")

    print("== 8. SD-2.1 768-v, DPM-Solver++(2M), DeepCache and the rollout_remat modes")
    del pipe, expand, inputs, img, aux, gg, gb  # phases 4-6's pipelines go first
    front.pop("split")
    front.pop("items")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    sd21 = sd21_phase(records, card)
    print("  -- cli.generate_data --model sd21 --scheduler dpmpp from files on disk")
    sd21_cli = sd21_cli_phase(records, card)
    print("  -- SD-1.5 under dpmpp and under deep_cache")
    solvers, solver_shapes, pipe, inputs = sd15_solver_phase(records, card)
    print("  -- the guidance update under each rollout_remat mode, SD-1.5 batch 2")
    modes, mode_shapes = modes_phase(records, pipe, inputs, card)
    del pipe, inputs
    gc.collect()
    torch.cuda.empty_cache()
    print("  -- fp32 tiny() on the card against the CPU: dpmpp, deep_cache, SD-2.1's shape, "
          "the modes")
    solver_fp32_phase()
    print(f"  phase 8: {time.time() - t0:.1f} s ({card})")

    print("== 9. SDXL-base at 1024^2: the guided expand, text-to-image, the CLI")
    t0 = time.time()
    sdxl = sdxl_phase(records, card)
    print("  -- cli.generate_data --model sdxl from files on disk")
    sdxl_cli = sdxl_cli_phase(records, card)
    print("  -- fp32 sdxl_tiny on the card against the CPU")
    sdxl_fp32_phase()
    print(f"  phase 9: {time.time() - t0:.1f} s ({card})")

    print("== 10. LoRA at SD-1.5 width: the step, cli.train_lora, generate_data --lora")
    t0 = time.time()
    print("  -- the fp32 LoRA step on the card against the CPU")
    lora_agree = lora_agreement_phase()
    print("  -- the adapter gradients through the kernels, SD-1.5 batch 2")
    lora_grads = lora_grad_phase()
    print(f"  -- the step at cli.train_lora's defaults (batch {LORA_BATCH}, 512^2, rank "
          f"{LORA_RANK})")
    lora_step = lora_step_phase(records, card)
    print(f"  -- cli.train_lora ({LORA_CLI_STEPS} steps, cut from 1000) and generate_data "
          f"--lora from files on disk")
    lora_cli = lora_cli_phase(records, card, sd15_ckpt)
    print(f"  phase 10: {time.time() - t0:.1f} s ({card})")

    print("== 11. the guide zoo: ResNeXt-50, Wide ResNet-50-2, MobileNetV2, OpenCLIP ViT-B/32")
    t0 = time.time()
    zoo = zoo_phase(records, card, sd15_ckpt, trainer["data"])
    files.cleanup()
    print(f"  warm call against phase 4's (ResNet-50, {warm_s:.3f} s): " + ", ".join(
        f"{a} {zoo['guides'][a]['warm_s'] / warm_s:.3f}x" for a in ZOO) + f" ({card})")
    zoo_s = time.time() - t0
    print(f"  phase 11: {zoo_s:.1f} s ({card})")
    phase12_s = (int8_s + sdxl["int8"]["phase_s"] + cli["params"]["phase_s"]
                 + cli["params"]["save_s"])
    print(f"  phase 12 (12a-e, the save in phase 6's run included): {phase12_s:.1f} s ({card})")
    print(f"  the whole script: {time.time() - script_t0:.1f} s ({card})")

    print("== 13. result")
    print(card)
    print(json.dumps({
        "kernels": summarize(records, by_shape + front["by_shape"] + cli["by_shape"]
                             + int8_path["by_shape"] + mesh_cli["by_shape"]
                             + sd21["by_shape"] + sd21_cli["by_shape"] + solver_shapes
                             + mode_shapes + sdxl["by_shape"] + sdxl_cli["by_shape"]
                             + lora_step["by_shape"] + lora_cli["by_shape"]
                             + sum((g["by_shape"] for g in zoo["guides"].values()),
                                   collections.Counter()) + zoo["cli"]["by_shape"]),
        "fp32_flash": fp32_records, "expand_warm_s": warm_s,
        "expand_warm_s_runs": warm_runs, "expand_peak_bytes": peak,
        "split_expand_warm_s": split["warm_s"], "split_expand_warm_s_runs": split["runs"],
        "split_expand_peak_bytes": split["peak_bytes"], "driver": front["stats"],
        "cli_seconds": cli["secs"], "cli_driver": cli["stats"],
        "cli_png_decode_ms": cli["decode_ms"],
        "train": {"agreement": train_agree, "step_ms": step_timing["step_ms"],
                  "step_ms_runs": step_timing["step_ms_runs"],
                  "images_per_s": trainer["images_per_s"], "epochs": trainer["epochs"],
                  "cli_step_s": trainer["step_s"], "cli_step_ms": trainer["step_ms"],
                  "peak_bytes": trainer["peak_bytes"],
                  "trainer_peak_bytes": trainer["trainer_peak_bytes"],
                  "write_s": trainer["write_s"],
                  "main_s": {k: trainer[f"{k}_main_s"] for k in ("train", "resume",
                                                                 "expanded")},
                  "transform": transform},
        "sd21": {"warm_s": sd21["warm_s"], "runs": sd21["runs"], "cold_s": sd21["cold_s"],
                 "peak_bytes": sd21["peak_bytes"], "kernels": sd21["kernels"],
                 "cli_seconds": sd21_cli["secs"], "cli_driver": sd21_cli["stats"],
                 "cli_peak_bytes": sd21_cli["peak_bytes"]},
        "solvers": solvers, "rollout_remat": modes,
        "sdxl": {k: sdxl[k] for k in ("warm_s", "runs", "cold_s", "peak_bytes", "build_s",
                                      "kernels", "t2i_warm_s", "t2i_cold_s", "t2i_peak_bytes")}
        | {"cli_seconds": sdxl_cli["secs"], "cli_driver": sdxl_cli["stats"],
           "cli_peak_bytes": sdxl_cli["peak_bytes"]},
        "lora": {"agreement": lora_agree, "gradients": lora_grads,
                 "step_ms": lora_step["step_ms"], "step_ms_runs": lora_step["step_ms_runs"],
                 "step_peak_bytes": lora_step["peak_bytes"], "kernels": lora_step["kernels"],
                 "norms": lora_step["norms"],
                 "cli_seconds": lora_cli["secs"], "cli_steps_per_s": lora_cli["steps_per_s"],
                 "cli_peak_bytes": lora_cli["train_peak_bytes"],
                 "generate_driver": lora_cli["stats"],
                 "generate_peak_bytes": lora_cli["generate_peak_bytes"]},
        "guides": {a: {k: v for k, v in g.items() if k != "by_shape"}
                   for a, g in zoo["guides"].items()}
        | {"phase_s": zoo_s, "cli_seconds": zoo["cli"]["secs"], "cli_driver": zoo["cli"]["stats"],
           "cli_peak_bytes": zoo["cli"]["peak_bytes"], "train_fc_main_s": zoo["train"]["main_s"]},
        "int8": {"ops": int8_ops, "sd15": {k: v for k, v in int8_path.items() if k != "by_shape"},
                 "sdxl": sdxl["int8"], "fp32": int8_fp32, "params": cli["params"],
                 "phase_s": phase12_s},
        "parallel": {"lse": lse, "sp": sp, "pp_tp_unet": pp_tp, "mesh_train": mesh_train,
                     "mesh_cli": {k: v for k, v in mesh_cli.items() if k != "by_shape"},
                     "phase_s": parallel_s}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
