#!/usr/bin/env python3
"""The flash kernels of this tree (the wide ones, the fp32 narrow forward
and the fp32 fused backward) against those of another copy of the kernel
sources, timed in turns on one NVIDIA GPU.

Builds ``flash_fwd.cu`` (with ``--bwd``: ``flash_bwd.cu``; with ``--f32``:
``flash_f32.cu``) from
``distdiff_tpu_torch/csrc`` and from the directory given (for example an
unpacked parent commit's ``distdiff_tpu_torch/csrc``, or a variant of the
sources), calls each library's ``flash_fwd`` (with ``--bwd``: the split
backward pair ``flash_bwd_dq`` and ``flash_bwd_dkv``, each copy with its
own C signature: the pair took no load route before it ran on TMA; with
``--f32``: ``flash_fwd_f32`` on fp32 inputs at [2,4096,4096,512] and
[4,4096,4096,160], its two wide instances, or with ``--f32 --narrow`` at
[32,4096,4096,40] and [32,1024,1024,80], the UNet's attention at its two
narrow instances; with ``--f32 --bwd``: the fp32 split pair
``flash_bwd_dq_f32`` and ``flash_bwd_dkv_f32`` at the wide shapes; with
``--f32 --fused``: the fp32 fused backward ``flash_bwd_fused_f32`` at the
UNet's two shapes, its dq zeroed before each launch outside the timing,
as the wrapper zeroes it) through
``ctypes`` on the same inputs (bf16; fp32 with ``--f32``), checks that the
two agree, and times
them in turns (other, tree, tree, other, other, tree): each time the median
of CUDA events around one launch queued behind a device spin, the kernel
alone.

Run from the repository root on the machine with the card:
``python3 scripts/torch_flash_ab.py OTHER_CSRC_DIR [--bwd] [--f32 [--narrow | --fused]]
[--json PATH]``.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# [BH, Tq, Tk, D]: the VAE mid-block's attention, a shorter one, and the
# wide kernels' DMAX = 256 instance
SHAPES = [(2, 4096, 4096, 512), (2, 1024, 1024, 512), (4, 4096, 4096, 160)]
# the UNet's 64^2 and 32^2 self-attention, in fp32 (the narrow forward)
NARROW_F32 = [(32, 4096, 4096, 40), (32, 1024, 1024, 80)]


def takes_route(src: str, entry: str) -> bool:
    """Whether ``entry`` in the source file ``src`` takes a load route (an
    ``int tma`` argument) before its scale."""
    text = open(src).read()
    head = text[text.index(f'extern "C" int {entry}('):]
    return "int tma" in head[:head.index(")")]


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from distdiff_tpu_torch.ops import _build

    if not torch.cuda.is_available() or not argv:
        print("usage: torch_flash_ab.py OTHER_CSRC_DIR [--bwd] [--f32 [--narrow | --fused]] "
              "[--json PATH] (needs a CUDA card)", file=sys.stderr)
        return 2
    bwd, f32 = "--bwd" in argv, "--f32" in argv
    fused = f32 and "--fused" in argv
    card = cs.card_line()
    print(card)
    work = tempfile.mkdtemp(prefix="flash_ab_")
    trees = {"tree": os.path.join(ROOT, "distdiff_tpu_torch", "csrc"), "other": argv[0]}
    source = "flash_f32.cu" if f32 else "flash_bwd.cu" if bwd else "flash_fwd.cu"
    procs = []
    for tag, src in trees.items():
        lib = os.path.join(work, f"{tag}.so")
        procs.append((tag, lib, os.path.join(src, source), subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *_build.NVCC_FLAGS, "-o", lib, os.path.join(src, source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for tag, lib, src, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{tag}: nvcc failed\n{log[-3000:]}")
        keep = ("dq", "dkv", "split") if bwd else ("fused", "dkv") if fused else (
            ("fwd",) if f32 else ("wide",))
        print(f"  {tag}: {[r for r in _build.ptxas_report(log) if any(x in r[0] for x in keep)]}")
        fns[tag] = {}
        suffix = "_f32" if f32 else ""
        entries = ("flash_bwd_dq" + suffix, "flash_bwd_dkv" + suffix) if bwd else (
            ("flash_bwd_fused_f32",) if fused else ("flash_fwd" + suffix,))
        for entry in entries:
            fn = getattr(ctypes.CDLL(lib), entry)
            argtypes = list(_build.SIGNATURES[entry][1])
            route = not f32
            if bwd and not f32 and not takes_route(src, entry):
                del argtypes[-3]  # no load route before the scale
                route = False
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[tag][entry] = (fn, route)
    if bwd:
        return ab_bwd(fns, card, argv, f32)
    if fused:
        return ab_fused(fns, card, argv)
    fns = {tag: f[entries[0]][0] for tag, f in fns.items()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    dtype = torch.float32 if f32 else torch.bfloat16
    plan = () if f32 else (0, 1)  # the bf16 wide kernel: width 0, TMA loads
    rows = []
    shapes = NARROW_F32 if "--narrow" in argv else (SHAPES[0], SHAPES[-1]) if f32 else SHAPES
    for bh, tq, tk, d in shapes:
        q, k, v = (torch.randn(bh, t, d, generator=gen, device=dev).to(dtype)
                   for t in (tq, tk, tk))
        calls, outs = {}, {}
        for tag, fn in fns.items():
            o = torch.empty_like(q)
            lse = torch.empty(bh, tq, device=dev)

            def call(fn=fn, o=o, lse=lse):
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                        bh, tq, tk, d, *plan, d ** -0.5, stream)
                if rc:
                    raise SystemExit(f"launch failed with CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            calls[tag], outs[tag] = call, (o, lse)
        err_o = (outs["tree"][0].float() - outs["other"][0].float()).abs().max().item()
        err_lse = (outs["tree"][1] - outs["other"][1]).abs().max().item()
        times = {tag: [] for tag in fns}
        for tag in ("other", "tree", "tree", "other", "other", "tree"):
            times[tag].append(cs.time_ms(calls[tag], 10))
        b_ms = cs.bound("flash_fwd", bh, tq, tk, d, itemsize=q.element_size())[0]
        row = {"shape": [bh, tq, tk, d], "dtype": str(dtype)[6:], "card": card,
               "max_abs_diff_o": err_o, "max_abs_diff_lse": err_lse, "bound_ms": b_ms,
               **{f"{t}_ms": statistics.median(x) for t, x in times.items()},
               **{f"{t}_runs": x for t, x in times.items()}}
        rows.append(row)
        print(f"  [{bh},{tq},{tk},{d}] {row['dtype']}: tree {row['tree_ms']:.4f} ms "
              f"{times['tree']}, other {row['other_ms']:.4f} ms {times['other']}, bound "
              f"{b_ms:.4f} ms; |o| diff {err_o:.2e}, |lse| diff {err_lse:.2e}", flush=True)
    write_json(rows, argv)
    return 0


def write_json(rows, argv) -> None:
    if "--json" in argv:
        path = argv[argv.index("--json") + 1]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(rows, f, indent=1)


def ab_fused(fns, card, argv) -> int:
    """flash_bwd_fused_f32 of both copies in turns at NARROW_F32's shapes,
    on fp32 inputs with the forward's lse and delta (plain torch): each
    launch adds into a dq zeroed just before it, outside the events."""
    import torch

    import chip_smoke as cs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for bh, tq, tk, d in NARROW_F32:
        q, do = (torch.randn(bh, tq, d, generator=gen, device=dev) for _ in range(2))
        k, v = (torch.randn(bh, tk, d, generator=gen, device=dev) for _ in range(2))
        s = torch.matmul(q, k.transpose(1, 2)) * d ** -0.5
        lse = torch.logsumexp(s, dim=-1)
        delta = (torch.matmul(torch.softmax(s, dim=-1), v) * do).sum(-1)
        del s
        calls, outs = {}, {}
        for tag, per in fns.items():
            fn = per["flash_bwd_fused_f32"][0]
            out = [torch.zeros_like(q), torch.empty_like(k), torch.empty_like(v)]
            ptrs = [x.data_ptr() for x in (q, k, v, do, lse, delta, *out)]

            def call(fn=fn, ptrs=ptrs):
                rc = fn(*ptrs, bh, tq, tk, d, d ** -0.5, stream)
                if rc:
                    raise SystemExit(f"launch failed with CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            calls[tag], outs[tag] = (call, out[0]), [x.clone() for x in out]
        diff = max((a - b).abs().max().item() for a, b in zip(outs["tree"], outs["other"]))
        top = max(a.abs().max().item() for a in outs["tree"])
        times = {tag: [] for tag in fns}
        for tag in ("other", "tree", "tree", "other", "other", "tree"):
            times[tag].append(time_zeroed(*calls[tag], 10))
        b_ms = cs.bound("flash_bwd_fused", bh, tq, tk, d, itemsize=4)[0]
        row = {"kernel": "flash_bwd_fused_f32", "shape": [bh, tq, tk, d], "dtype": "float32",
               "card": card, "max_abs_diff": diff, "max_abs": top, "bound_ms": b_ms,
               **{f"{t}_ms": statistics.median(x) for t, x in times.items()},
               **{f"{t}_runs": x for t, x in times.items()}}
        rows.append(row)
        print(f"  flash_bwd_fused_f32 [{bh},{tq},{tk},{d}]: tree {row['tree_ms']:.4f} ms "
              f"{times['tree']}, other {row['other_ms']:.4f} ms {times['other']}, bound "
              f"{b_ms:.4f}; max |diff| {diff:.2e} of max |out| {top:.2e}", flush=True)
    write_json(rows, argv)
    return 0


def time_zeroed(fn, dq, iters: int) -> float:
    """chip_smoke.time_ms for a launch that adds into ``dq``: the same
    median of CUDA events behind a device spin, with dq zeroed before the
    spin, outside the events."""
    import torch

    import chip_smoke as cs

    for _ in range(2):
        dq.zero_()
        fn()
    times = []
    for _ in range(iters):
        dq.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cs.SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def ab_bwd(fns, card, argv, f32=False) -> int:
    """flash_bwd_dq and flash_bwd_dkv (their fp32 instances with ``f32``) of
    both copies in turns, at SHAPES' first and last (D = 512, and 160: the
    DMAX = 256 instance)."""
    import torch

    import chip_smoke as cs

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    dtype = torch.float32 if f32 else torch.bfloat16
    rows = []
    for bh, tq, tk, d in (SHAPES[0], SHAPES[-1]):
        q, do = (torch.randn(bh, tq, d, generator=gen, device=dev).to(dtype) for _ in range(2))
        k, v = (torch.randn(bh, tk, d, generator=gen, device=dev).to(dtype) for _ in range(2))
        # the forward's lse and delta = rowsum(o do), in fp32 (plain torch)
        s = torch.matmul(q.float(), k.float().transpose(1, 2)) * d ** -0.5
        lse = torch.logsumexp(s, dim=-1)
        o = torch.matmul(torch.softmax(s, dim=-1), v.float())
        delta = (o * do.float()).sum(-1)
        del s, o
        for entry in ("flash_bwd_dq", "flash_bwd_dkv"):
            calls, outs = {}, {}
            for tag, per in fns.items():
                fn, route = per[entry + ("_f32" if f32 else "")]
                out = [torch.empty_like(q)] if entry == "flash_bwd_dq" else [
                    torch.empty_like(k), torch.empty_like(v)]
                ptrs = [x.data_ptr() for x in (q, k, v, do, lse, delta, *out)]
                extra = (1,) if route else ()

                def call(fn=fn, ptrs=ptrs, extra=extra):
                    rc = fn(*ptrs, bh, tq, tk, d, *extra, d ** -0.5, stream)
                    if rc:
                        raise SystemExit(f"launch failed with CUDA error {rc}")

                call()
                torch.cuda.synchronize()
                calls[tag], outs[tag] = call, out
            diff = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(outs["tree"], outs["other"]))
            top = max(a.float().abs().max().item() for a in outs["tree"])
            times = {tag: [] for tag in fns}
            for tag in ("other", "tree", "tree", "other", "other", "tree"):
                times[tag].append(cs.time_ms(calls[tag], 10))
            b_ms = cs.bound(entry, bh, tq, tk, d, itemsize=q.element_size())[0]
            row = {"kernel": entry, "shape": [bh, tq, tk, d], "dtype": str(dtype)[6:], "card": card,
                   "max_abs_diff": diff, "max_abs": top, "bound_ms": b_ms,
                   **{f"{t}_ms": statistics.median(x) for t, x in times.items()},
                   **{f"{t}_runs": x for t, x in times.items()}}
            rows.append(row)
            print(f"  {entry} [{bh},{tq},{tk},{d}]: tree {row['tree_ms']:.4f} ms {times['tree']}, "
                  f"other {row['other_ms']:.4f} ms {times['other']}, bound {b_ms:.4f}; "
                  f"max |diff| {diff:.2e} of max |out| {top:.2e}", flush=True)
    write_json(rows, argv)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
