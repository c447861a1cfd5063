"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the reference, and the result's last line.

``setup_s`` runs from the process's start to the first timed batch: imports,
the kernels' build or load, the weights, the inputs, the program's
assembly and the warm-up batches. The window is ``ExpansionDriver.run`` over
whole batches, as many as the warm-up's last batch says fit ``--seconds``
(the last one starts before the deadline, at today's speed); it ends when
its last PNG is written.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import shutil
import subprocess
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from portbench.harness import compare, registry, timeline, weights
from portbench.harness.registry import Cell
from portbench.reference import models
from portbench.work import attention as attn_work
from portbench.work import groupnorm as gn_work
from portbench.work.peaks import PEAK_BF16_FLOPS

GIB = 2 ** 30


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclasses.dataclass
class TracedWindow:
    """What the per-layer readers read (``portbench/metrics/*.py``)."""
    cfg: dict
    traffic: dict
    batch: int
    records: list               # BatchRecord per window batch, CUDA events
    first_profiled: int         # index of the first batch of the measured slice
    profiled: int               # batches in the measured slice
    slice: Optional[timeline.Slice]
    flops_per_image: Callable[[], float]
    # the program's flash launches of one batch, {(kernel, (BH, Tq, Tk, D)):
    # launches}, from its own counters over the window
    flash_launches: dict = dataclasses.field(default_factory=dict)

    @property
    def timed(self) -> list:
        """The batches before the measured slice, which no profiler slows."""
        return self.records[:self.first_profiled]

    def span_ms(self, name: str) -> float:
        """Device milliseconds of span ``name`` over the timed batches."""
        return sum(a.elapsed_time(b) for r in self.timed for a, b in r.spans.get(name, ()))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: Optional[float] = None, int8: bool = False,
             expand_hook: Optional[Callable] = None, log=print,
             on_images: Optional[Callable] = None) -> dict:
    """The result line of one run (a dict). ``int8`` switches on the
    program's int8 path (the control); ``expand_hook(images, units)`` breaks
    the timed path where tests plant a fault; ``on_images(units, written,
    reference)`` sees the compared images."""
    t_start = time.time() if t_start is None else t_start
    device = torch.device(device)
    cfg, tr = cell.config, cell.traffic
    parts: Dict[str, float] = {"import_s": time.time() - t_start}
    t = time.time()
    if device.type == "cuda":
        from distdiff_tpu_torch.ops import _build

        _build.kernel("flash_fwd")  # builds every kernel library, or loads the built ones
        parts["kernels_s"] = time.time() - t
        t = time.time()
    mods = models.build(cfg, "meta")
    states = weights.states(cfg, seed, device, mods)
    sync(device)
    parts["weights_s"] = time.time() - t
    t = time.time()
    inputs = weights.make_inputs(cfg, tr, seed, device)
    sync(device)
    parts["inputs_s"] = time.time() - t
    t = time.time()

    from portbench.harness.port import PortRun

    run = PortRun(cfg, tr, states, inputs, device, trace=trace, int8=int8,
                  expand_hook=expand_hook)
    del states
    parts["assemble_s"] = time.time() - t
    t = time.time()
    tmp = tempfile.mkdtemp(prefix=f"portbench-{cell.name}-")
    try:
        run.run(os.path.join(tmp, "warmup"), tr["warmup_batches"])
        sync(device)
        est = time.perf_counter() - run.records[-1].host_start
        parts["warmup_s"] = time.time() - t
        units = tr["classes"] * tr["items_per_class"] * tr["images_per_prompt"]
        profile = tr["profile_batches"] if run.trace else 0
        # traced: two timed batches at least, the measured slice, the labelled batch
        batches = max(math.ceil(seconds / est), profile + 3 if profile else 1)
        batches = min(batches, units // tr["batch"])
        # a batch at today's speed: the warm-up's last batch, from its start
        # to the warm-up's end (its issue, its device work, its PNGs)
        log(f"portbench: set-up {parts}; a batch ~{est:.3f} s at the warm-up's end: "
            f"{batches} batches of {tr['batch']} in the window")
        return _window(cell, seed, run, inputs, device, tmp, batches, profile, parts, t_start,
                       log, on_images)
    finally:
        run.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _launch_check(cfg, tr, batches: int, log) -> None:
    """The program's own launch counters over the window beside the frozen
    plan (a cross-check of the plan; the numerators never read them)."""
    from distdiff_tpu_torch.ops import flash
    from distdiff_tpu_torch.ops import groupnorm as gn

    want = {**attn_work.launch_totals(cfg, tr), **gn_work.launch_totals(cfg, tr)}
    got = {**flash.launch_counts, **gn.launch_counts}
    line = ", ".join(f"{k} {got.get(k, 0)} (plan {want[k] * batches})" for k in want)
    log(f"portbench: launches in the window, program's counters (frozen plan): {line}")


def _flash_launches_per_batch(batches: int) -> dict:
    """The program's flash launch counters over the window, per batch
    (every batch launches the same)."""
    from distdiff_tpu_torch.ops import flash

    shapes = getattr(flash, "launch_shapes", None) or {}
    return {key: n / batches for key, n in shapes.items()}


def _reset_counters() -> None:
    from distdiff_tpu_torch.ops import flash
    from distdiff_tpu_torch.ops import groupnorm as gn

    flash.reset_launch_counts()
    gn.reset_launch_counts()


def _window(cell, seed, run, inputs, device, tmp, batches, profile, parts, t_start, log,
            on_images):
    cfg, tr = cell.config, cell.traffic
    plan = compare.slot_plan(batches, tr["batch"], seed)
    run.keep_g0 = {}
    for b, slot in plan:
        run.keep_g0.setdefault(b, []).append(slot)
    _reset_counters()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync(device)
    t0 = time.time()
    setup_s = t0 - t_start
    out_dir = os.path.join(tmp, "window")
    stats = run.run(out_dir, batches, profile)
    t1 = time.time()
    sync(device)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    written = stats["written"]
    window_s = t1 - t0
    images_per_s = written / window_s
    parts_line = ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
    log(f"portbench: setup_s {setup_s:.3f} ({parts_line}); window {window_s:.3f} s, "
        f"{written} images, {images_per_s:.4f} images/s; peak {peak / GIB:.3f} GiB; "
        f"card {card_line() if device.type == 'cuda' else device}")
    _launch_check(cfg, tr, batches, log)
    metrics = {"images_per_s": {"value": images_per_s, "unit": "images/s"},
               "peak_mem_gib": {"value": peak / GIB, "unit": "GiB"},
               "setup_s": {"value": setup_s, "unit": "s"}}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else str(device),
           "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if run.trace:
        metrics, breakdown = _traced(cell, run, batches, profile, images_per_s, dev, log)
    units = [u for r in run.records for u in r.units]
    sample = [(run.records[b].units[s], run.records[b].g0.get(s)) for b, s in plan]
    # the program's state goes before the reference runs
    run.pipe = run.se = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    def produced(units_g0):
        """The program's outputs: the PNGs it wrote, read back, and the
        latents it kept at g0."""
        return ([compare.read_png(u.out_path) if os.path.exists(u.out_path) else None
                 for u, _ in units_g0],
                [None if g is None else g.cpu().numpy() for _, g in units_g0])

    missing = sum(1 for u in units if not os.path.exists(u.out_path))
    verdict = judge(cell, seed, inputs, len(units), missing, sample, device, produced, log,
                    on_images)
    return {"correct": verdict["correct"], "attempted": verdict["attempted"],
            "failed": verdict["failed"], "metrics": metrics, "device": dev,
            **({"breakdown": breakdown} if breakdown else {}),
            "readings": verdict["readings"], "checks": verdict["checks"]}


def _traced(cell, run, batches, profile, images_per_s, dev, log):
    cfg, tr = cell.config, cell.traffic
    t = time.time()
    sl = timeline.from_profiler(run.prof_device, profile * tr["batch"]) if run.prof_device else None
    labelled = timeline.from_profiler(run.prof_host, tr["batch"]) if run.prof_host else None
    flops = {}

    def flops_per_image():
        if "v" not in flops:
            from portbench.work import flops as flop_count

            flops["v"] = flop_count.per_image(cfg, tr)
        return flops["v"]

    tw = TracedWindow(cfg=cfg, traffic=tr, batch=tr["batch"], records=run.records,
                      first_profiled=batches - profile - 1, profiled=profile, slice=sl,
                      flops_per_image=flops_per_image,
                      flash_launches=_flash_launches_per_batch(batches))
    timed = tw.timed
    timed_s = timed[0].start.elapsed_time(timed[-1].end) / 1e3 if timed else float("nan")
    log(f"portbench: traced run: images_per_s {images_per_s:.4f} over the window (the "
        f"untraced runs' figure is the same measure); {len(timed) * tr['batch'] / timed_s:.4f} "
        f"over the {len(timed)} batches before the measured slice (CUDA events on)")
    metrics = {}
    for m in cell.per_layer:
        value = registry.load_metric(m["name"]).read(tw)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    breakdown = None
    if sl is not None:
        dev["busy_s"], dev["window_s"] = sl.busy_s, sl.wall_s
        breakdown = {"device_ops": sl.breakdown()["device_ops"],
                     "idle_gaps": (labelled or sl).breakdown()["idle_gaps"]}
        cats = ", ".join(f"{k} {v:.4f}" for k, v in
                         sorted(sl.by_category().items(), key=lambda kv: -kv[1]))
        log(f"portbench: profile: {sl.note}; the labelled batch: "
            f"{labelled.note if labelled else 'none'}")
        log(f"portbench: measured slice ({profile} batches): wall {sl.wall_s:.4f} s, device "
            f"busy {sl.busy_s:.4f} s, {len(sl.kernels)} kernels; device s by family: {cats}")
    log(f"portbench: per-image FLOPs {tw.flops_per_image():.6e}; peak {PEAK_BF16_FLOPS:.3e} "
        f"FLOP/s (bf16, H100 SXM data sheet, 700 W); trace read in {time.time() - t:.1f} s")
    return metrics, breakdown


def judge(cell, seed, inputs, attempted, missing, sample, device, produced, log,
          on_images=None) -> dict:
    """The verdict on one run's outputs. ``attempted``: the units the window
    started, ``missing`` of them with no PNG; ``sample``: the judged (unit,
    g0 latents or None) pairs; ``produced(sample) -> (images, g0 latents)``:
    what stands in the program's place (a missing image is None). Every
    judged unit is held to every limit of the cell: one over any limit, or
    a missing PNG, makes the run not correct."""
    tr = cell.traffic
    t = time.time()
    failed = missing
    images, g0 = produced(sample)
    keep = [i for i, img in enumerate(images) if img is not None]
    judged = [sample[i][0] for i in keep]
    ref_g0 = [] if any(g is not None for g in g0) else None
    refs = compare.reference_images(cell.config, tr, seed, inputs, judged, device,
                                    g0_latents=ref_g0)
    written = [images[i] for i in keep]
    if on_images is not None:
        on_images(judged, written, refs)
    readings = []
    for j, (i, w, r) in enumerate(zip(keep, written, refs)):
        g = compare.gaps(w, r)
        if ref_g0 is not None and g0[i] is not None:
            g.update(compare.latent_gaps(g0[i], ref_g0[j]))
        readings.append(g)
        u = sample[i][0]
        log(f"portbench: unit ({u.dataset_index}, {u.image_i}): "
            + ", ".join(f"{k} {v:.4f}" for k, v in g.items()))
    numbers = {k: max(g[k] for g in readings) for k in readings[0]} if readings else {}
    checks = compare.judge(numbers, cell.limits) if set(cell.limits) <= set(numbers) else {}
    bad = [k for k, c in checks.items() if not c["value"] <= c["limit"]]
    failed += sum(1 for g in readings
                  if any(not g.get(k, float("inf")) <= lim for k, lim in cell.limits.items()))
    correct = bool(checks) and not bad and failed == 0 and attempted > 0
    log(f"portbench: reference over {len(judged)} of {attempted} images in "
        f"{time.time() - t:.1f} s; worst: "
        + ", ".join(f"{k} {v:.4f}" for k, v in numbers.items()))
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "readings": numbers, "checks": checks}


def jax_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's, optax's or the
    JAX package's."""
    import sys

    banned = {"jax", "jaxlib", "flax", "optax", "distdiff_tpu"}
    return sorted({m.split(".")[0] for m in list(sys.modules)} & banned)

