#!/usr/bin/env python3
"""What ``torch._int_mm`` takes on the card, for the int8 route of
``distdiff_tpu_torch/ops/quant.py``.

Run from the repository root on a machine with one CUDA card:
``python3 scripts/torch_int8_probe.py``. For each shape (M, K, N) it
multiplies seeded int8 operands with the weight as a column-major
``[K, N]`` view (``w.t()`` of a ``[N, K]`` tensor, K contiguous in both
operands: the route's layout) and as a row-major ``[K, N]`` copy, holds
both against float64 products on the card (exact for integers while
127^2 * K < 2^53), and times each (median of CUDA events over 20 launches,
after 3 warm-ups) beside ``F.linear`` in bf16 on the same shape. Then it
checks the size rules at the edges: M = 16 and 17, K and N off a multiple
of 8, each accepted or refused. Prints one JSON line last.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

# (M, K, N): the SD-1.5 batch-2 CFG call's resnet convolutions at 64^2 and
# 8^2 (im2col depth 9 C), a feed-forward projection, and a 16-row product
SHAPES = [(16384, 2880, 320), (256, 11520, 1280), (16384, 320, 2560), (16, 2880, 320)]


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def time_ms(fn, iters: int = 20) -> float:
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_int8_probe: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    print(card, torch.__version__, torch.version.cuda)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for m, k, n in SHAPES:
        a = torch.randint(-127, 128, (m, k), generator=gen, device="cuda", dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=gen, device="cuda", dtype=torch.int8)
        want = (a.double() @ w.double().t()).to(torch.int32)
        row = {"shape": [m, k, n]}
        for label, b in (("col_major", w.t()), ("row_major", w.t().contiguous())):
            try:
                got = torch._int_mm(a, b)
            except RuntimeError as e:
                row[label] = f"refused: {str(e).splitlines()[0]}"
                continue
            row[label] = {"exact": bool(torch.equal(got, want)),
                          "ms": time_ms(lambda b=b: torch._int_mm(a, b))}
        xb, wb = a.to(torch.bfloat16), w.to(torch.bfloat16)
        row["bf16_linear_ms"] = time_ms(lambda: F.linear(xb, wb))
        rows.append(row)
        print(json.dumps(row))
    edges = {}
    for m, k, n in ((16, 64, 64), (17, 64, 64), (32, 60, 64), (32, 64, 60)):
        a = torch.ones((m, k), device="cuda", dtype=torch.int8)
        w = torch.ones((n, k), device="cuda", dtype=torch.int8)
        try:
            ok = bool((torch._int_mm(a, w.t()) == k).all())
            edges[f"{m}x{k}x{n}"] = "accepted, exact" if ok else "accepted, WRONG"
        except RuntimeError as e:
            edges[f"{m}x{k}x{n}"] = f"refused: {str(e).splitlines()[0]}"
    print(json.dumps(edges))
    print(json.dumps({"card": card, "torch": torch.__version__, "shapes": rows,
                      "edges": edges}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
