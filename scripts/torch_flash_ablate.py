#!/usr/bin/env python3
"""Where the Hopper flash kernels' time goes, on one NVIDIA GPU.

Builds the port's narrow (D <= 128) flash kernels (``flash_fwd`` and
``flash_bwd_fused`` in ``distdiff_tpu_torch/csrc``), its wide forward
(``flash_fwd`` past D = 128), its split backward pair
(``flash_bwd_dq``, ``flash_bwd_dkv``), its fp32 narrow and wide forwards
(``flash_fwd_f32`` up to and past D = 128, on 3xTF32 tensor-core products)
and its fp32 split pair (``flash_bwd_dq_f32``, ``flash_bwd_dkv_f32`` past
D = 128, the same arithmetic) once as they are and once for each variant
below, with one part taken out of the source, and times every build on the
same inputs (the narrow variants at the UNet's shapes, the wide ones at the
VAE mid-block's, the fp32 wide ones at [2,4096,4096,512] and
[4,4096,4096,160] and the fp32 narrow forward's at the UNet's shapes, in
fp32): the median of CUDA events around one
launch queued behind a device spin, the kernel alone (no wrapper, no dq
zeroing or cast). A variant computes wrong numbers by design; only its
time means something. Each build runs in its own process under a time
limit, so a variant that stalls cannot hold the run.

Run from the repository root on the machine with the card:
``python3 scripts/torch_flash_ablate.py [--only TEXT] [--csrc DIR] [--json
PATH]``. It prints one line per (variant, shape) and, with ``--json``,
writes them there too; ``--only`` keeps the variants whose name contains
TEXT (``--only wide_bwd``: the split backward pair's set, each build
timing ``flash_bwd_dq`` and ``flash_bwd_dkv``; ``--only wide_f32``: the
fp32 wide forward's set; ``--only narrow_f32``: the fp32 narrow forward's
set; ``--only f32_bwd``: the fp32 split pair's set, each build timing both
kernels); ``--csrc`` patches and builds another copy of the sources (an
unpacked older commit's ``distdiff_tpu_torch/csrc``). The ``fma_f32`` set
patches the CUDA-core ``fwd_kernel`` that ``flash_fwd_f32`` ran at
D <= 128 before its narrow tensor-core kernel: run it with ``--csrc`` on
such a tree.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "distdiff_tpu_torch", "csrc")
NARROW = [(32, 4096, 40), (32, 1024, 80)]  # the UNet's 64^2 and 32^2 self-attention
WIDE = [(2, 4096, 512)]  # the VAE mid-block's single head
WIDE_F32 = [(2, 4096, 512), (4, 4096, 160)]  # the fp32 wide forward's two instances
NARROW_F32 = [(32, 4096, 40), (32, 1024, 80)]  # the UNet's shapes in fp32

# the wide forward's parts: its k and v tiles' loads (each replaced by a
# bare arrival on its full barrier, the TMA route's count), its two products
# and its exponentials
_NO_WIDE_K = ("hopper::mbar_arrive_tx(k_full + c, CHUNK);\n"
              "            hopper::tma_load_3d(Kt + c * CHUNK, &kmap, 64 * c, (j + 1) * BK, bh, k_full + c);",
              "hopper::mbar_arrive(k_full + c);")
_NO_WIDE_V = ("hopper::mbar_arrive_tx(v_full + w, VCH * CHUNK);\n"
              "        for (int i = 0; i < VCH; ++i)\n"
              "          hopper::tma_load_3d(Vw + i * CHUNK, &vmap, 64 * (w * VCH + i), j * BK, bh, v_full + w);",
              "hopper::mbar_arrive(v_full + w);")
_NO_WIDE_S = ("hopper::Wgmma<BK>::template ss<0, 0>(s_acc,",
              "if (c < 0) hopper::Wgmma<BK>::template ss<0, 0>(s_acc,")
_NO_WIDE_PV = ("hopper::Wgmma<ON>::template ss<0, 1>(o_acc,",
               "if (t < 0) hopper::Wgmma<ON>::template ss<0, 1>(o_acc,")
_NO_WIDE_EX2 = ("hopper::ex2(fmaf(s_acc[4 * n + e], sl2, -mc[e >> 1]))",
                "fmaf(s_acc[4 * n + e], sl2, -mc[e >> 1])")

# the split backward pair's parts (flash_bwd_dq and flash_bwd_dkv, timed
# each): its exponentials, its output products (ds X), its score products
# (s and dp), and its stream's loads (each replaced by a bare arrival on
# its full barrier, the TMA route's count)
_NO_SPLIT_EX2 = ("hopper::ex2(fmaf(s_acc[4 * n + e], sl2, -L))", "fmaf(s_acc[4 * n + e], sl2, -L)")
_NO_SPLIT_OUT = ("hopper::Wgmma<64>::template ss<0, 1>(acc[i],",
                 "if (t < 0) hopper::Wgmma<64>::template ss<0, 1>(acc[i],")
_NO_SPLIT_SCORE = ("hopper::Wgmma<64>::template ss<0, 0>(acc,",
                   "if (i < 0) hopper::Wgmma<64>::template ss<0, 0>(acc,")
_NO_SPLIT_LOADS = ("hopper::mbar_arrive_tx(ring_full + s, CHUNK);\n"
                   "        hopper::tma_load_3d(R + s * CHUNK, p < CH ? rmap : xmap, col, row, bh, ring_full + s);",
                   "hopper::mbar_arrive(ring_full + s);")

# the fp32 wide forward's parts (csrc/flash_f32.cu): the two correction
# products of every 3xTF32 product (one TF32 product is left), its
# exponentials, its k and v chunks' copies into the ring (the q tile is
# still loaded), and every product (the copies and the fragment loads are
# left)
_F32_CORRECTIONS = ("  mma_tf32(c, al, b0, b1);\n  mma_tf32(c, a, bl0, bl1);\n", "")
_F32_PRODUCTS = ("  mma_tf32(c, al, b0, b1);\n  mma_tf32(c, a, bl0, bl1);\n"
                 "  mma_tf32(c, a, b0, b1);\n", "")
_F32_EX2 = ("const float p = exp2f(s_acc[n][e] - m_run[e >> 1]);",
            "const float p = s_acc[n][e] - m_run[e >> 1];")
_F32_NO_KV = ("    if (nj < ntile) {\n      float* dst", "    if (nj < 0) {\n      float* dst")

# the fp32 split pair's parts (the same file; mma3's patches above take
# its correction products or all its products too): its exponentials, and
# its stream's TMA loads (each slot's barrier still completes; the
# resident tiles are still loaded)
_F32_BWD_EX2 = ("exp2f(fmaf(s[e], sl2, -L))", "fmaf(s[e], sl2, -L)")
# ... and, for its compute alone, its slot waits, its refills (by the last
# warp or by the producer warp) and the waits' partner arrivals
_F32_BWD_NO_WAITS = ("        hopper::mbar_wait(full + slot, phase);  // pair (j, c) is in\n", "")
_F32_BWD_NO_REFILLS = (
    "        __syncwarp();  // the warp is done with pair (j, c)\n"
    "        if (PROD) {\n"
    "          if (lane == 0) hopper::mbar_arrive(empty + slot);\n"
    "        } else {  // the last warp to leave the slot refills it\n"
    "          int last = 0;\n"
    "          if (lane == 0) {\n"
    "            __threadfence_block();\n"
    "            last = atomicAdd(released + slot, 1) == C::NW - 1;\n"
    "            if (last) released[slot] = 0;\n"
    "          }\n"
    "          const int p = (j * nc + c) + RING;\n"
    "          if (__shfl_sync(0xffffffffu, last, 0) && p < npair) load_pair(p, slot);\n"
    "        }\n", "")
_F32_BWD_NO_PRODUCER = ("    for (int p = RING; p < npair; ++p) {", "    for (int p = npair; p < npair; ++p) {")
_F32_BWD_NO_STREAM = (
    "        hopper::mbar_arrive_tx(full + slot, 2 * C::CHUNK * 4);\n"
    "        hopper::tma_load_3d(dst, &umap, c0, row0, bh, full + slot);\n"
    "        hopper::tma_load_3d(dst + C::CHUNK, &wmap, c0, row0, bh, full + slot);\n",
    "        hopper::mbar_arrive(full + slot);\n")

# the fp32 narrow forward's parts (the same file; mma3's patches above take
# its correction products or all its products too): its exponentials, and
# its k and v tiles' TMA loads (each replaced by a bare arrival on the
# slot's full barrier)
_NARROW_EX2 = ("const float p = hopper::ex2(fmaf(s[m][n][e], sl2, -m_run[m][e >> 1]));",
               "const float p = fmaf(s[m][n][e], sl2, -m_run[m][e >> 1]);")
_NARROW_NO_KV = ("      hopper::mbar_arrive_tx(full + slot, (C::KT + C::VT) * 4);\n"
                 "      hopper::tma_load_3d(dst, &kmap, 0, j * BK, bh, full + slot);\n"
                 "      hopper::tma_load_3d(dst + C::KT, &vmap, 0, j * BK, bh, full + slot);\n",
                 "      hopper::mbar_arrive(full + slot);\n")

# the CUDA-core fwd_kernel's parts (flash_f32.cu before the narrow
# tensor-core kernel, with --csrc): its exponentials, its k and v tiles'
# staging into shared memory, and its fused multiply-adds (the score
# statement is dq_kernel's too, which this set does not time)
_FMA_EX2 = ("s[r] = exp2f(x - mn);", "s[r] = x - mn;")
_FMA_NO_KV = ("    stage<TILE, DP, C::LDK>(Ks, kb, k0, tk, d);\n"
              "    stage<TILE, DP, DP>(Vs, vb, k0, tk, d);\n", "")
_FMA_PRODUCTS = [("s[r] = fmaf(qw[r * DP + c], kc, s[r]);", ";"),
                 ("acc[r][i] = fmaf(p, vj[i], acc[r][i]);", ";")]

# the fp32 fused backward's parts (the same file; mma3's patches above
# take its correction products or all its products too): its
# exponentials, its q and do tiles' TMA loads (each replaced by a bare
# arrival on the slot's full barrier; k and v are still loaded), dq's
# hand-off (the bulk reduce-adds into dq; the partial sums are still
# formed and staged), and, to see inside, its dq product and its dk and dv
# products
_FUSED_EX2 = ("p[e] = hopper::ex2(fmaf(s[n][e], sl2, -((e & 1) ? L.y : L.x)));",
              "p[e] = fmaf(s[n][e], sl2, -((e & 1) ? L.y : L.x));")
_FUSED_NO_STREAM = ("      hopper::mbar_arrive_tx(full + slot, 2 * C::ST * 4);\n"
                    "      hopper::tma_load_3d(dst, &qmap, 0, j * BQ, bh, full + slot);\n"
                    "      hopper::tma_load_3d(dst + C::ST, &domap, 0, j * BQ, bh, full + slot);\n",
                    "      hopper::mbar_arrive(full + slot);\n")
_FUSED_NO_REDUCE = ("      hopper::bulk_reduce_add_f32(dq + (qoff + r0 + r) * d + c0,",
                    "      if (r < 0) hopper::bulk_reduce_add_f32(dq + (qoff + r0 + r) * d + c0,")
_FUSED_NO_DQ = ("          mma3(acc[i], a, al, b0, b1, tf32_lo(b0), tf32_lo(b1));\n", "")
_FUSED_NO_DKV = ("            mma3(tv[u], pa[i], pl[i], d0, d1, tf32_lo(d0), tf32_lo(d1));\n"
                 "            mma3(tkk[u], da[i], dal[i], q0, q1, tf32_lo(q0), tf32_lo(q1));\n", "")

# variant -> (source file, [(text, replacement)], shapes); the split pair's
# variants run its two entry points, the other flash_bwd.cu ones and the
# fused_f32 ones the fused pass
VARIANTS = {
    "fwd": ("flash_fwd.cu", [], NARROW),
    "fwd without k/v loads": ("flash_fwd.cu", [
        ("hopper::tma_load_3d(Ks", "if (0) hopper::tma_load_3d(Ks"),
        ("hopper::tma_load_3d(Vs", "if (0) hopper::tma_load_3d(Vs"),
        ("hopper::mbar_arrive_tx(k_full + s, C::KV_BYTES);", "hopper::mbar_arrive(k_full + s);"),
        ("hopper::mbar_arrive_tx(v_full + s, C::KV_BYTES);", "hopper::mbar_arrive(v_full + s);")],
        NARROW),
    "fwd without exponentials": ("flash_fwd.cu", [
        ("hopper::ex2(fmaf(s[4 * n + e], sl2, -mc[e >> 1]))", "fmaf(s[4 * n + e], sl2, -mc[e >> 1])")],
        NARROW),
    "fwd without softmax": ("flash_fwd.cu", [
        ("fwd_softmax<BK>(s_acc, m, l, alpha, j == nk - 1 ? tk - j * BK : BK, sl2, t4, c,\n"
         "                    pass_last || j < nk - 1);",
         "alpha[0] = alpha[1] = 1.f; hopper::named_sync(SCHED_BAR + c, 256);\n"
         "    if (pass_last || j < nk - 1) hopper::named_arrive(SCHED_BAR + (1 - c), 256);")],
        NARROW),
    "bwd": ("flash_bwd.cu", [], NARROW),
    "bwd without exponentials": ("flash_bwd.cu", [
        ("st[4 * n + e] = hopper::ex2(fmaf(st[4 * n + e], sl2, -((e & 1) ? ls.y : ls.x)));",
         "st[4 * n + e] = fmaf(st[4 * n + e], sl2, -((e & 1) ? ls.y : ls.x));")], NARROW),
    "bwd without dq hand-off and reduce": ("flash_bwd.cu", [
        ("    const int q0 = i * BQ;\n    if (TMA) {",
         "    const int q0 = i * BQ;\n    if (TMA) {} else if (q0 < 0) {"),
        ("    if (!TMA) return;\n    const int lane = tid - 32;",
         "    return;\n    const int lane = tid - 32;")], NARROW),
    "bwd without the dq product": ("flash_bwd.cu", [
        ("hopper::Wgmma<DH>::template ss<1, 1>(dq_acc,",
         "if (0) hopper::Wgmma<DH>::template ss<1, 1>(dq_acc,")], NARROW),
    "wide fwd": ("flash_fwd.cu", [], WIDE),
    "wide fwd without k loads": ("flash_fwd.cu", [_NO_WIDE_K], WIDE),
    "wide fwd without v loads": ("flash_fwd.cu", [_NO_WIDE_V], WIDE),
    "wide fwd without k and v loads": ("flash_fwd.cu", [_NO_WIDE_K, _NO_WIDE_V], WIDE),
    "wide fwd without s": ("flash_fwd.cu", [_NO_WIDE_S], WIDE),
    "wide fwd without p v": ("flash_fwd.cu", [_NO_WIDE_PV], WIDE),
    "wide fwd without exponentials": ("flash_fwd.cu", [_NO_WIDE_EX2], WIDE),
    "wide fwd without loads and products": ("flash_fwd.cu", [
        _NO_WIDE_K, _NO_WIDE_V, _NO_WIDE_S, _NO_WIDE_PV], WIDE),
    "wide_bwd": ("flash_bwd.cu", [], WIDE),
    "wide_bwd without exponentials": ("flash_bwd.cu", [_NO_SPLIT_EX2], WIDE),
    "wide_bwd without output products": ("flash_bwd.cu", [_NO_SPLIT_OUT], WIDE),
    "wide_bwd without score products": ("flash_bwd.cu", [_NO_SPLIT_SCORE], WIDE),
    "wide_bwd without stream loads": ("flash_bwd.cu", [_NO_SPLIT_LOADS], WIDE),
    "wide_bwd loads only": ("flash_bwd.cu", [_NO_SPLIT_EX2, _NO_SPLIT_OUT, _NO_SPLIT_SCORE], WIDE),
    "wide_f32": ("flash_f32.cu", [], WIDE_F32),
    "wide_f32 one TF32 product": ("flash_f32.cu", [_F32_CORRECTIONS], WIDE_F32),
    "wide_f32 without exponentials": ("flash_f32.cu", [_F32_EX2], WIDE_F32),
    "wide_f32 without k/v loads": ("flash_f32.cu", [_F32_NO_KV], WIDE_F32),
    "wide_f32 loads only": ("flash_f32.cu", [_F32_PRODUCTS, _F32_EX2], WIDE_F32),
    "narrow_f32": ("flash_f32.cu", [], NARROW_F32),
    "narrow_f32 one TF32 product": ("flash_f32.cu", [_F32_CORRECTIONS], NARROW_F32),
    "narrow_f32 without exponentials": ("flash_f32.cu", [_NARROW_EX2], NARROW_F32),
    "narrow_f32 without k/v loads": ("flash_f32.cu", [_NARROW_NO_KV], NARROW_F32),
    "narrow_f32 loads only": ("flash_f32.cu", [_F32_PRODUCTS, _NARROW_EX2], NARROW_F32),
    "fma_f32": ("flash_f32.cu", [], NARROW_F32),
    "fma_f32 without exponentials": ("flash_f32.cu", [_FMA_EX2], NARROW_F32),
    "fma_f32 without k/v loads": ("flash_f32.cu", [_FMA_NO_KV], NARROW_F32),
    "fma_f32 without products": ("flash_f32.cu", _FMA_PRODUCTS, NARROW_F32),
    "fma_f32 loads only": ("flash_f32.cu", _FMA_PRODUCTS + [_FMA_EX2], NARROW_F32),
    "f32_bwd": ("flash_f32.cu", [], WIDE_F32),
    "f32_bwd one TF32 product": ("flash_f32.cu", [_F32_CORRECTIONS], WIDE_F32),
    "f32_bwd without exponentials": ("flash_f32.cu", [_F32_BWD_EX2], WIDE_F32),
    "f32_bwd without stream loads": ("flash_f32.cu", [_F32_BWD_NO_STREAM], WIDE_F32),
    "f32_bwd loads only": ("flash_f32.cu", [_F32_PRODUCTS, _F32_BWD_EX2], WIDE_F32),
    "f32_bwd compute only": ("flash_f32.cu", [
        _F32_BWD_NO_WAITS, _F32_BWD_NO_REFILLS, _F32_BWD_NO_PRODUCER], WIDE_F32),
    "fused_f32": ("flash_f32.cu", [], NARROW_F32),
    "fused_f32 one TF32 product": ("flash_f32.cu", [_F32_CORRECTIONS], NARROW_F32),
    "fused_f32 without exponentials": ("flash_f32.cu", [_FUSED_EX2], NARROW_F32),
    "fused_f32 without q/do loads": ("flash_f32.cu", [_FUSED_NO_STREAM], NARROW_F32),
    "fused_f32 without dq's reduce-add": ("flash_f32.cu", [_FUSED_NO_REDUCE], NARROW_F32),
    "fused_f32 without dq's product": ("flash_f32.cu", [_FUSED_NO_DQ], NARROW_F32),
    "fused_f32 without dk's and dv's products": ("flash_f32.cu", [_FUSED_NO_DKV], NARROW_F32),
    "fused_f32 loads only": ("flash_f32.cu", [_F32_PRODUCTS, _FUSED_EX2], NARROW_F32),
}

CHILD = r'''
import ctypes, json, statistics, sys
import torch
lib_path, stem, kind = sys.argv[1], sys.argv[2], sys.argv[4]
split = kind == "split"
shapes = json.loads(sys.argv[3])
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
lib = ctypes.CDLL(lib_path)
f32 = stem == "flash_f32"
entries = ["flash_bwd_dq", "flash_bwd_dkv"] if split else ["flash_bwd_fused"] if kind == "fused" \
    else ["flash_fwd_f32" if f32 else "flash_fwd" if stem == "flash_fwd" else "flash_bwd_fused"]
fns = {}
for name in entries:
    fns[name] = getattr(lib, name + ("_f32" if f32 and kind else ""))
    n_ptr = {"flash_fwd": 5, "flash_fwd_f32": 5, "flash_bwd_fused": 9, "flash_bwd_dq": 7,
             "flash_bwd_dkv": 8}[name]
    fns[name].argtypes = [P] * n_ptr + [I] * (4 if f32 else 5 if split else 6) + [F, P]
    fns[name].restype = I
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
stream = torch.cuda.current_stream().cuda_stream
out = {}
for bh, t, d in shapes:
    dtype = torch.float32 if f32 else torch.bfloat16
    q, k, v, do = (torch.randn(bh, t, d, generator=gen, device=dev).to(dtype)
                   for _ in range(4))
    o = torch.empty_like(q)
    lse = torch.randn(bh, t, device=dev).abs() + 5.0
    dq = torch.zeros(bh, t, d, device=dev)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dp = next((w for w in (48, 64, 80, 96, 128) if d <= w), 0)  # 0: the wide kernel
    plan = () if f32 else (1,) if split else (dp, 1)
    for name, fn in fns.items():
        args = {"flash_fwd": (q, k, v, o, lse), "flash_fwd_f32": (q, k, v, o, lse),
                "flash_bwd_fused": (q, k, v, do, lse, lse, dq, dk, dv),
                "flash_bwd_dq": (q, k, v, do, lse, lse, dk),
                "flash_bwd_dkv": (q, k, v, do, lse, lse, dk, dv)}[name]
        call = lambda: fn(*[a.data_ptr() for a in args], bh, t, t, d, *plan, d ** -0.5, stream)
        assert call() == 0
        torch.cuda.synchronize()
        times = []
        for _ in range(22):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            a.record(); call(); b.record(); b.synchronize()
            times.append(a.elapsed_time(b))
        key = f"{bh},{t},{d}"
        out[f"{name[10:]} {key}" if split else key] = statistics.median(times[2:])
print(json.dumps(out))
'''


def nvcc() -> str:
    return "/usr/local/cuda/bin/nvcc"


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_flash_ablate: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card)
    work = tempfile.mkdtemp(prefix="flash_ablate_")
    builds = []
    only = argv[argv.index("--only") + 1] if "--only" in argv else ""
    csrc = argv[argv.index("--csrc") + 1] if "--csrc" in argv else CSRC
    for i, (name, (src, subs, shapes)) in enumerate(VARIANTS.items()):
        if only not in name:
            continue
        d = os.path.join(work, str(i))
        os.makedirs(d)
        for f in os.listdir(csrc):
            if f.endswith((".cu", ".cuh")):
                text = open(os.path.join(csrc, f)).read()
                if f == src:
                    for a, b in subs:
                        if a not in text:
                            raise SystemExit(f"{name}: {a[:60]!r} is not in {src}")
                        text = text.replace(a, b)
                with open(os.path.join(d, f), "w") as out:
                    out.write(text)
        lib = os.path.join(d, "lib.so")
        cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-o", lib, os.path.join(d, src)]
        split = name.startswith(("wide_bwd", "f32_bwd"))
        kind = "split" if split else "fused" if name.startswith("fused_f32") else ""
        builds.append((name, src[:-3], kind, lib, shapes, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    rows = []
    for name, stem, kind, lib, shapes, proc in builds:
        split = kind == "split"
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        try:
            res = subprocess.run([sys.executable, "-c", CHILD, lib, stem, json.dumps(shapes),
                                  kind], capture_output=True, text=True, timeout=120)
            times = json.loads(res.stdout.strip().splitlines()[-1]) if res.returncode == 0 else {}
        except subprocess.TimeoutExpired:
            times = {}
        for shape in shapes:
            key = ",".join(map(str, shape))
            for kernel in ("dq", "dkv") if split else ("",):
                ms = times.get(f"{kernel} {key}" if split else key)
                rows.append({"variant": name, "kernel": kernel or None, "shape": list(shape),
                             "ms": ms, "card": card})
                print(f"  {name:38s} {kernel:3s} [{key}]: " +
                      (f"{ms:.4f} ms" if ms else "failed or stalled"))
    if "--json" in argv:
        path = argv[argv.index("--json") + 1]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
