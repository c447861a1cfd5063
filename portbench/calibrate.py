"""The readings the comparison's limits are set from, for one cell:

    python3 portbench/calibrate.py --workload <name> --seeds 1 2 ... \
        [--control int8|fp8 --control-seeds 7 8 9] [--fault half_batch --fault-seeds 10]

Each seed runs the cell as ``run.py`` does (one warm-up batch, one window
batch through the program's driver, every slot of that batch judged against
the plain fp32 reference, the cell's limits applied), all seeds in one
process. The control is one step below the bf16 the configurations state:
with ``--control int8`` the same run with the program's int8 path switched
on; with ``--control fp8`` the reference itself with its products' operands
in fp8 (``reference/lowp.py``) in the program's place, judged as the
program's outputs are. ``--fault`` plants a fault under the timed path
(``harness/faults.py``). One JSON line a run, with its verdict, then the
lower reading (the largest of the program's) and the upper one (the
smallest of the control's) of every number compared.
"""

import argparse
import contextlib
import gc
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fp8_control(cell, seed: int, keep, log, device="cuda") -> dict:
    """The fp8 reference in the program's place, over the units of a
    window's first batch, judged as a run's outputs are."""
    import types

    from portbench.harness import compare, weights
    from portbench.harness.cell import judge

    tr = cell.traffic
    inputs = weights.make_inputs(cell.config, tr, seed, device)
    first = [types.SimpleNamespace(dataset_index=u // tr["images_per_prompt"],
                                   image_i=u % tr["images_per_prompt"])
             for u in range(tr["batch"])]
    sample = [(first[s], None) for _, s in compare.slot_plan(1, tr["batch"], seed)]

    def produced(units_g0):
        g0 = [] if tr["guidance"]["type"] != "none" else None
        images = compare.reference_images(cell.config, tr, seed, inputs,
                                          [u for u, _ in units_g0], device, fp8=True,
                                          g0_latents=g0)
        return images, g0 if g0 else [None] * len(images)

    return judge(cell, seed, inputs, len(first), 0, sample, device, produced, log, keep)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control", choices=("int8", "fp8"), default="int8")
    p.add_argument("--fault", choices=("half_batch", "answer_altered", "state_unchanged"))
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--keep", help="a directory for each run's written-minus-reference images")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench.harness import faults, registry
    from portbench.harness.cell import run_cell

    def log(line):
        print(line, file=sys.stderr, flush=True)

    cell = registry.find_cell(args.workload)
    cell.traffic = dict(cell.traffic, warmup_batches=1)
    worst = {"program": {}, "control": {}}
    for kind, seeds in (("control", args.control_seeds), ("program", args.seeds),
                        ("fault", args.fault_seeds)):
        for seed in seeds:
            t = time.time()

            def keep(units, written, refs, kind=kind, seed=seed):
                if args.keep:
                    os.makedirs(args.keep, exist_ok=True)
                    diff = [w[..., :3].astype(np.int16) - r for w, r in zip(written, refs)]
                    extra = {"ref": np.stack(refs)} if kind == "program" else {}
                    np.savez_compressed(os.path.join(args.keep, f"{kind}_{seed}.npz"),
                                        diff=np.stack(diff), **extra)

            planted = contextlib.nullcontext()
            hook = None
            if kind == "fault" and args.fault == "state_unchanged":
                planted = faults.state_unchanged()
            elif kind == "fault":
                hook = faults.HOOKS[args.fault]
            if kind == "control" and args.control == "fp8":
                r = fp8_control(cell, seed, keep, log)
            else:
                with planted:
                    r = run_cell(cell, seed, 0.1, False, "cuda",
                                 int8=kind == "control", expand_hook=hook, log=log,
                                 on_images=keep)
            label = args.fault if kind == "fault" else (
                args.control if kind == "control" else "program")
            print(json.dumps({"kind": kind, "as": label, "seed": seed, "correct": r["correct"],
                              **r["readings"], "seconds": round(time.time() - t, 1)}),
                  flush=True)
            if kind != "fault":
                pick = max if kind == "program" else min
                for k, v in r["readings"].items():
                    worst[kind][k] = pick(worst[kind].get(k, v), v)
            gc.collect()
            torch.cuda.empty_cache()
    print(json.dumps({"lower": worst["program"], "upper": worst["control"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
