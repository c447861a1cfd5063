#!/usr/bin/env python3
"""A quick check of the fp32 fused backward on one NVIDIA GPU.

Builds the kernels, prints the registers and spills of every
``flash_bwd_fused_f32_kernel`` instance (and of the CUDA-core ``dkv_kernel``
beside them), its dynamic shared memory from C against
``ops/flash.py`` ``f32_fused_smem_bytes`` at each padded width, holds
``flash.flash_bwd_fused`` on fp32 inputs against the plain version at edge
shapes of every width on both load routes (a view one element into its
storage takes the 4-byte route), launched twice (dk and dv the same bytes,
dq within the tolerance both times), and times it at the UNet's two shapes
beside SDPA's whole backward, as ``chip_smoke.py`` phase 2 does. Exits 1 if
a check fails.

Run from the repository root on the machine with the card:
``python3 scripts/torch_fused_f32_probe.py``.
"""

from __future__ import annotations

import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke as cs
    from distdiff_tpu_torch.ops import _build, flash

    if not torch.cuda.is_available():
        print("torch_fused_f32_probe: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    t0 = time.time()
    _build.kernel("flash_fwd")
    print(f"build {time.time() - t0:.1f} s", flush=True)
    for r in _build.ptxas_report(_build.build_logs()["flash_f32"]):
        if "fused" in r[0] or "dkv" in r[0]:
            print("  (kernel, registers, stack, spill stores, spill loads)", r)
    for w in flash.F32_FUSED_WIDTHS:
        print(f"smem {w}: C {_build.kernel('flash_bwd_fused_f32_smem')(w)} "
              f"Python {flash.f32_fused_smem_bytes(w)}", flush=True)
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    def make(bh, tq, tk, d, offset=False):
        def rnd(*s):
            if offset:  # a contiguous view one element into its storage
                return torch.randn(math.prod(s) + 1, generator=gen, device=dev)[1:].view(*s)
            return torch.randn(*s, generator=gen, device=dev)
        q, do = rnd(bh, tq, d), rnd(bh, tq, d)
        k, v = rnd(bh, tk, d), rnd(bh, tk, d)
        o, lse = flash.flash_fwd_reference(q, k, v)
        return q, k, v, do, lse, flash.attention_delta(o, do)

    def check(bh, tq, tk, d, offset=False):
        q, k, v, do, lse, delta = make(bh, tq, tk, d, offset)
        ref = flash._grads_from_delta(q, k, v, do, lse, delta)
        got = flash.flash_bwd_fused(q, k, v, do, lse, delta)
        again = flash.flash_bwd_fused(q, k, v, do, lse, delta)
        torch.cuda.synchronize()
        errs = [float((g - r).abs().max() / r.abs().max()) for g, r in zip(got, ref)]
        err_again = float((again[0] - ref[0]).abs().max() / ref[0].abs().max())
        same = all(torch.equal(a, b) for a, b in zip(got[1:], again[1:]))
        ok = max(errs + [err_again]) <= 1e-4 and same
        print(f"  [{bh},{tq},{tk},{d}]{' offset' if offset else ''}: max |err| / max |ref| "
              f"dq/dk/dv {['%.2e' % e for e in errs]}, dq again {err_again:.2e}, dk and dv "
              f"the same bytes {same} {'ok' if ok else 'FAIL'}", flush=True)
        return ok

    ok = True
    for d in (8, 16, 24, 33, 40, 48, 64, 72, 80, 96, 100, 128):
        bq = 16 if d > 96 else 32  # the kernel's q tile
        ok &= check(2, 2 * bq + 1, 129, d)
        ok &= check(1, bq - 1, 127, d)
        ok &= check(1, 3 * bq - 1, 257, d, offset=True)
    for bh, t, d in ((32, 4096, 40), (32, 1024, 80)):
        q, k, v, do, lse, delta = make(bh, t, t, d)
        ms = cs.time_ms(lambda: flash.flash_bwd_fused(q, k, v, do, lse, delta), 5)
        q4, k4, v4 = (x.view(1, bh, -1, d).clone().requires_grad_(True) for x in (q, k, v))
        out = torch.nn.functional.scaled_dot_product_attention(q4, k4, v4)
        lib = cs.time_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), do.view(1, bh, -1, d),
                                                     retain_graph=True), 5)
        print(f"  [{bh},{t},{t},{d}]: fused {ms:.4f} ms, sdpa bwd {lib:.4f} ms, bound "
              f"{cs.bound('flash_bwd_fused', bh, t, t, d, itemsize=4)[0]:.4f}", flush=True)
        del q4, k4, v4, out
    print("all checks ok" if ok else "a check FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
