#!/usr/bin/env python3
"""Readings behind ``chip_smoke.py`` phase 10's bf16 gradient limit.

For each adapter scale and input seed, one LoRA step of SD-1.5 at full
width (batch 2, 512^2, rank 8, seeded random weights; ``chip_smoke``
``lora_grad_run``) gives the adapter gradients in fp32 through the plain
attention (the reference), in bf16 through the plain attention, in bf16
through the kernels, and in bf16 through the kernels with a fault planted
in ``flash_bwd_fused``'s outputs: dq dropped, dk dropped, all three
halved. Each bf16 run prints its gradients' l2 distance from the
reference (relative to the reference's norm) and that distance over the
plain bf16 run's, the measure phase 10 limits at
``LORA_BF16_GRAD_RATIO``, which the sound kernels must stay under and the
faults must exceed. The adapter's b has std ``LORA_B_STD`` times each
``--b_scale``.

Run from the repository root on a machine with a CUDA device:
``python3 scripts/torch_lora_grad_gate.py [--b_scale 1 10] [--seeds 31 35]
[--json PATH]``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--b_scale", type=float, nargs="+", default=[1.0, 10.0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[31, 35])
    ap.add_argument("--json")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_lora_grad_gate: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from distdiff_tpu_torch.ops import flash

    fused = flash.flash_bwd_fused

    def planted(fault):
        def bwd(*a):
            dq, dk, dv = fused(*a)
            return {"dq dropped": (dq * 0, dk, dv), "dk dropped": (dq, dk * 0, dv),
                    "halved": (dq * 0.5, dk * 0.5, dv * 0.5)}[fault]
        return bwd

    print(cs.card_line(), flush=True)
    runs = (("bf16 plain", torch.bfloat16, True, None),
            ("bf16 kernels", torch.bfloat16, False, None),
            *((f"bf16 kernels, {f}", torch.bfloat16, False, planted(f))
              for f in ("dq dropped", "dk dropped", "halved")))
    out = []
    for scale in args.b_scale:
        for seed in args.seeds:
            inputs = cs.lora_grad_inputs(seed)
            _, ref = cs.lora_grad_run(inputs, torch.float32, plain=True, b_scale=scale,
                                      adapter_seed=seed + 1)
            l2 = {}
            for label, dtype, plain, bwd in runs:
                _, g = cs.lora_grad_run(inputs, dtype, plain, bwd, b_scale=scale,
                                        adapter_seed=seed + 1)
                l2[label] = float((g - ref).norm() / ref.norm())
                row = {"b_std": cs.LORA_B_STD * scale, "seed": seed, "run": label,
                       "l2": l2[label], "ratio": l2[label] / l2["bf16 plain"]}
                out.append(row)
                print(f"  b std {row['b_std']:g}, seed {seed}, {label}: l2 from fp32 "
                      f"{row['l2']:.4g}, over the plain bf16 run's {row['ratio']:.4g} "
                      f"(limit {cs.LORA_BF16_GRAD_RATIO})", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": cs.card_line(), "runs": out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
