#!/usr/bin/env python3
"""The forward flash kernel of this tree against that of another copy of
the kernel sources, timed in turns on one NVIDIA GPU.

Builds ``flash_fwd.cu`` from ``distdiff_tpu_torch/csrc`` and from the
directory given (for example an unpacked parent commit's
``distdiff_tpu_torch/csrc``, or a variant of the sources), calls each
library's ``flash_fwd`` through ``ctypes`` on the same bf16 inputs, checks
that the two agree, and times them in turns (other, tree, tree, other,
other, tree): each time the median of CUDA events around one launch queued
behind a device spin, the kernel alone.

Run from the repository root on the machine with the card:
``python3 scripts/torch_flash_ab.py OTHER_CSRC_DIR [--json PATH]``.
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
# wide kernel's DMAX = 256 instance
SHAPES = [(2, 4096, 4096, 512), (2, 1024, 1024, 512), (4, 4096, 4096, 160)]


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from distdiff_tpu_torch.ops import _build

    if not torch.cuda.is_available() or not argv:
        print("usage: torch_flash_ab.py OTHER_CSRC_DIR [--json PATH] (needs a CUDA card)",
              file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card)
    work = tempfile.mkdtemp(prefix="flash_ab_")
    trees = {"tree": os.path.join(ROOT, "distdiff_tpu_torch", "csrc"), "other": argv[0]}
    procs = []
    for tag, src in trees.items():
        lib = os.path.join(work, f"{tag}.so")
        procs.append((tag, lib, subprocess.Popen(
            ["/usr/local/cuda/bin/nvcc", *_build.NVCC_FLAGS, "-o", lib,
             os.path.join(src, "flash_fwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for tag, lib, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{tag}: nvcc failed\n{log[-3000:]}")
        print(f"  {tag}: {[r for r in _build.ptxas_report(log) if 'wide' in r[0]]}")
        fn = ctypes.CDLL(lib).flash_fwd
        fn.argtypes, fn.restype = _build.SIGNATURES["flash_fwd"][1], ctypes.c_int
        fns[tag] = fn
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for bh, tq, tk, d in SHAPES:
        q, k, v = (torch.randn(bh, t, d, generator=gen, device=dev).to(torch.bfloat16)
                   for t in (tq, tk, tk))
        calls, outs = {}, {}
        for tag, fn in fns.items():
            o = torch.empty_like(q)
            lse = torch.empty(bh, tq, device=dev)

            def call(fn=fn, o=o, lse=lse):
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                        bh, tq, tk, d, 0, 1, d ** -0.5, stream)
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
        row = {"shape": [bh, tq, tk, d], "card": card, "max_abs_diff_o": err_o,
               "max_abs_diff_lse": err_lse,
               **{f"{t}_ms": statistics.median(x) for t, x in times.items()},
               **{f"{t}_runs": x for t, x in times.items()}}
        rows.append(row)
        print(f"  [{bh},{tq},{tk},{d}]: tree {row['tree_ms']:.4f} ms {times['tree']}, other "
              f"{row['other_ms']:.4f} ms {times['other']}; |o| diff {err_o:.2e}, |lse| diff "
              f"{err_lse:.2e}", flush=True)
    if "--json" in argv:
        path = argv[argv.index("--json") + 1]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
