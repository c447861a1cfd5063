#!/usr/bin/env python3
"""Seconds per warm guided expand call of the port at SD-1.5 geometry.

Builds the main path exactly as ``chip_smoke.py`` phase 4 does (seeded
random weights, batch 2, the reference recipe), makes one warm-up call,
then times ``--calls`` more (host clock around a call that ends in
``torch.cuda.synchronize()``) and prints them with their median as one
JSON line. It times the tree it is run from: to compare two commits, unpack
both and run this from the root of each, in turns (A, B, B, A), in one
session on one card.

Run from a repository root on the machine with the card:
``python3 scripts/torch_expand_timing.py [--calls N] [--tag NAME]``.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_expand_timing: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from distdiff_tpu_torch.ops import _build

    calls = int(argv[argv.index("--calls") + 1]) if "--calls" in argv else 6
    tag = argv[argv.index("--tag") + 1] if "--tag" in argv else os.getcwd()
    _build.kernel("flash_fwd")
    _, expand, inputs = chip_smoke.build_path()
    dev = torch.device("cuda")
    expand(*inputs, torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    runs = []
    for seed in range(2, 2 + calls):
        t0 = time.time()
        expand(*inputs, torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        runs.append(time.time() - t0)
    print(json.dumps({"tag": tag, "card": chip_smoke.card_line(), "warm_s": runs,
                      "median_s": statistics.median(runs)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
