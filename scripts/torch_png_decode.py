#!/usr/bin/env python3
"""The port's PNG decoder on the host, alone and on loader threads.

Writes seeded 300 x 300 RGB PNGs of two kinds into a temporary directory:
filter 0 rows (``save_png``, as the driver writes) and Paeth and Average
rows (``chip_smoke.save_png_filtered``, as an adaptive encoder writes most
rows of a photograph). For each kind it times, in ms an image: the decode
alone on one thread; the prototype pass's item (decode, then
``prototype_transform(224)``) on one thread and on a pool of 4 threads (the
CLI's ``BatchLoader``); and that pool while the main thread runs the
ResNet-50 guide at batch 16 on 224^2 images, as ``generate_data``'s
prototype pass does, with the guide's ms a batch beside it. The Paeth and
Average kind is timed twice: with the decoder's one-at-a-time lock
(``datasets._WAVEFRONT_LOCK``) and with it replaced by a no-op. The guide
runs on the card where there is one, else on the CPU.

Run from the repository root: ``python3 scripts/torch_png_decode.py
[--images N] [--json PATH]``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=40)
    ap.add_argument("--json")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as cs
    from distdiff_tpu_torch.data import datasets
    from distdiff_tpu_torch.data.transforms import prototype_transform
    from distdiff_tpu_torch.models.guide import create_model
    from distdiff_tpu_torch.parallel import save_png

    dev = "cuda" if torch.cuda.is_available() else "cpu"
    where = cs.card_line() if dev == "cuda" else "CPU"
    print(f"{where}; {os.cpu_count()} CPUs; guide on {dev}")
    rng = np.random.default_rng(0)
    tf = prototype_transform(224)
    guide = create_model("resnet50", num_classes=100, device=dev)
    x = torch.rand(16, 224, 224, 3, device=dev)

    def item(path):
        return tf(datasets.load_image(path), np.random.default_rng(0))

    def guide_ms(n=20):
        t = time.perf_counter()
        with torch.no_grad():
            for _ in range(n):
                guide.encode_image(x).float().cpu()
        return (time.perf_counter() - t) / n * 1e3

    def per_image(fn, paths):
        t = time.perf_counter()
        fn(paths)
        return (time.perf_counter() - t) / len(paths) * 1e3

    def pooled(paths):
        with ThreadPoolExecutor(4) as ex:
            list(ex.map(item, paths))

    def pooled_with_guide(paths):
        with ThreadPoolExecutor(4) as ex:
            t = time.perf_counter()
            futs = [ex.submit(item, p) for p in paths]
            g = guide_ms()
            for f in futs:
                f.result()
            return (time.perf_counter() - t) / len(paths) * 1e3, g

    results = {"device": where, "guide_alone_ms": None, "kinds": {}}
    with tempfile.TemporaryDirectory() as d:
        kinds = {"filter 0": [], "Paeth and Average": []}
        for i in range(args.images):
            img = rng.uniform(0, 1, (300, 300, 3))
            kinds["filter 0"].append(os.path.join(d, f"f{i}.png"))
            save_png(kinds["filter 0"][-1], img)
            kinds["Paeth and Average"].append(os.path.join(d, f"p{i}.png"))
            cs.save_png_filtered(kinds["Paeth and Average"][-1], img)
        guide_ms(3)  # warm-up
        results["guide_alone_ms"] = guide_ms()
        print(f"guide alone: {results['guide_alone_ms']:.2f} ms a batch of 16")
        runs = [("filter 0", None), ("Paeth and Average", None),
                ("Paeth and Average, no lock", contextlib.nullcontext())]
        for label, lock in runs:
            paths = kinds[label.split(",")[0]]
            saved = datasets._WAVEFRONT_LOCK
            if lock is not None:
                datasets._WAVEFRONT_LOCK = lock
            try:
                r = {"decode_ms": per_image(lambda ps: [datasets.load_image(p) for p in ps], paths),
                     "item_ms": per_image(lambda ps: [item(p) for p in ps], paths),
                     "pool4_ms": per_image(pooled, paths)}
                r["pool4_with_guide_ms"], r["guide_ms"] = pooled_with_guide(paths)
            finally:
                datasets._WAVEFRONT_LOCK = saved
            results["kinds"][label] = r
            print(f"{label}: decode {r['decode_ms']:.2f} ms an image, decode + transform "
                  f"{r['item_ms']:.2f}, 4 threads {r['pool4_ms']:.2f}; 4 threads beside the "
                  f"guide {r['pool4_with_guide_ms']:.2f} (guide {r['guide_ms']:.2f} ms a batch)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
