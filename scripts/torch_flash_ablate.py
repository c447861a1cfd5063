#!/usr/bin/env python3
"""Where the narrow flash kernels' time goes, on one NVIDIA GPU.

Builds the port's narrow (D <= 128) flash kernels (``flash_fwd`` and
``flash_bwd_fused`` in ``distdiff_tpu_torch/csrc``) once as they are and
once for each variant below, with one part taken out of the source, and
times every build on the same inputs: the median of CUDA events around one
launch queued behind a device spin, the kernel alone (no wrapper, no dq
zeroing or cast). A variant computes wrong numbers by design; only its
time means something. Each build runs in its own process under a time
limit, so a variant that stalls cannot hold the run.

Run from the repository root on the machine with the card:
``python3 scripts/torch_flash_ablate.py [--json PATH]``. It prints one line
per (variant, shape) and, with ``--json``, writes them there too.
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
SHAPES = [(32, 4096, 40), (32, 1024, 80)]  # the UNet's 64^2 and 32^2 self-attention

# variant -> (source file, [(text, replacement)])
VARIANTS = {
    "fwd": ("flash_fwd.cu", []),
    "fwd without k/v loads": ("flash_fwd.cu", [
        ("hopper::tma_load_3d(Ks", "if (0) hopper::tma_load_3d(Ks"),
        ("hopper::tma_load_3d(Vs", "if (0) hopper::tma_load_3d(Vs"),
        ("hopper::mbar_arrive_tx(k_full + s, C::KV_BYTES);", "hopper::mbar_arrive(k_full + s);"),
        ("hopper::mbar_arrive_tx(v_full + s, C::KV_BYTES);", "hopper::mbar_arrive(v_full + s);")]),
    "fwd without exponentials": ("flash_fwd.cu", [
        ("hopper::ex2(fmaf(s[4 * n + e], sl2, -mc[e >> 1]))", "fmaf(s[4 * n + e], sl2, -mc[e >> 1])")]),
    "fwd without softmax": ("flash_fwd.cu", [
        ("fwd_softmax<BK>(s_acc, m, l, alpha, j == nk - 1 ? tk - j * BK : BK, sl2, t4, c,\n"
         "                    pass_last || j < nk - 1);",
         "alpha[0] = alpha[1] = 1.f; hopper::named_sync(SCHED_BAR + c, 256);\n"
         "    if (pass_last || j < nk - 1) hopper::named_arrive(SCHED_BAR + (1 - c), 256);")]),
    "bwd": ("flash_bwd.cu", []),
    "bwd without exponentials": ("flash_bwd.cu", [
        ("st[4 * n + e] = hopper::ex2(fmaf(st[4 * n + e], sl2, -((e & 1) ? ls.y : ls.x)));",
         "st[4 * n + e] = fmaf(st[4 * n + e], sl2, -((e & 1) ? ls.y : ls.x));")]),
    "bwd without dq hand-off and reduce": ("flash_bwd.cu", [
        ("    const int q0 = i * BQ;\n    if (TMA) {",
         "    const int q0 = i * BQ;\n    if (TMA) {} else if (q0 < 0) {"),
        ("    if (!TMA) return;\n    const int lane = tid - 32;",
         "    return;\n    const int lane = tid - 32;")]),
    "bwd without the dq product": ("flash_bwd.cu", [
        ("hopper::Wgmma<DH>::template ss<1, 1>(dq_acc,",
         "if (0) hopper::Wgmma<DH>::template ss<1, 1>(dq_acc,")]),
}

CHILD = r'''
import ctypes, json, statistics, sys
import torch
lib_path, stem = sys.argv[1], sys.argv[2]
shapes = json.loads(sys.argv[3])
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
lib = ctypes.CDLL(lib_path)
fn = getattr(lib, "flash_fwd" if stem == "flash_fwd" else "flash_bwd_fused")
fn.argtypes = [P] * (5 if stem == "flash_fwd" else 9) + [I] * 6 + [F, P]
fn.restype = I
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(0)
stream = torch.cuda.current_stream().cuda_stream
out = {}
for bh, t, d in shapes:
    q, k, v, do = (torch.randn(bh, t, d, generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    o = torch.empty_like(q)
    lse = torch.randn(bh, t, device=dev).abs() + 5.0
    dq = torch.zeros(bh, t, d, device=dev)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    dp = next(w for w in (48, 64, 80, 96, 128) if d <= w)
    if stem == "flash_fwd":
        args = (q, k, v, o, lse)
    else:
        args = (q, k, v, do, lse, lse, dq, dk, dv)
    call = lambda: fn(*[a.data_ptr() for a in args], bh, t, t, d, dp, 1, d ** -0.5, stream)
    assert call() == 0
    torch.cuda.synchronize()
    times = []
    for _ in range(22):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record(); call(); b.record(); b.synchronize()
        times.append(a.elapsed_time(b))
    out[f"{bh},{t},{d}"] = statistics.median(times[2:])
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
    for i, (name, (src, subs)) in enumerate(VARIANTS.items()):
        d = os.path.join(work, str(i))
        os.makedirs(d)
        for f in os.listdir(CSRC):
            if f.endswith((".cu", ".cuh")):
                text = open(os.path.join(CSRC, f)).read()
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
        builds.append((name, src[:-3], lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    rows = []
    for name, stem, lib, proc in builds:
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log[-3000:]}")
        try:
            res = subprocess.run([sys.executable, "-c", CHILD, lib, stem, json.dumps(SHAPES)],
                                 capture_output=True, text=True, timeout=120)
            times = json.loads(res.stdout.strip().splitlines()[-1]) if res.returncode == 0 else {}
        except subprocess.TimeoutExpired:
            times = {}
        for shape in SHAPES:
            key = ",".join(map(str, shape))
            ms = times.get(key)
            rows.append({"variant": name, "shape": list(shape), "ms": ms, "card": card})
            print(f"  {name:38s} [{key}]: " + (f"{ms:.4f} ms" if ms else "failed or stalled"))
    if "--json" in argv:
        path = argv[argv.index("--json") + 1]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
