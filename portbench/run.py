"""Run one cell of ``BENCHMARK.json`` once and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the kernels' build or load, seeded weights and inputs made
on the card, the program's assembly, the warm-up batches), then the
measured window of whole batches through the program's expansion driver,
then, with ``--trace 1``, the per-layer metrics of the traced window, and
last the comparison with the plain fp32 reference of the written PNGs (and,
in guided cells, of the latents before the guidance step), one unit at each
slot of the batch. The last line of standard output is the result as one
JSON object; the numbers compared, each beside its limit, are also the last
lines of standard error.
Exits non-zero, with no result, without enough CUDA devices, or when a JAX
module was loaded.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".portbench_cache")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every cache of the program and its libraries inside the checkout, at
    # fixed paths, so that only a checkout's first run builds
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # one process with few threads: the host issues the kernels, and idle
    # intra-op threads spinning beside it only add noise
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = "1"
    sys.path.insert(0, ROOT)

    import torch

    from portbench.harness import registry
    from portbench.harness.cell import jax_modules, run_cell

    cell = registry.find_cell(args.workload)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2

    def log(line):
        print(line, file=sys.stderr, flush=True)

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                      t_start=T_START, log=log)
    found = jax_modules()
    if found:
        print(f"portbench: JAX modules loaded in this process: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"portbench check: {name} {c['value']:.6g} (limit {c['limit']:.6g})",
              file=sys.stderr)
    if not result["checks"]:
        print(f"portbench check: no limits for {args.workload}: nothing held", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
