#!/usr/bin/env python3
"""GroupNorm kernels of this tree against those of another copy of the
kernel sources, timed in turns on one NVIDIA GPU.

Builds ``groupnorm.cu`` from ``distdiff_tpu_torch/csrc`` and from the
directory given (for example an unpacked parent commit's
``distdiff_tpu_torch/csrc``) and calls each library through ``ctypes`` on
the same bf16 channels-last inputs, checks that the two agree, and times
them in turns (other, tree, tree, other, other, tree): each time the median
of CUDA events around one launch queued behind a device spin, the kernel
alone.

Default mode: ``gn_fused`` at the main path's seven launch-weighted
shapes. Each copy is called with its own C signature: the cluster kernel's
(a plan from this tree's ``fused_plan``) or the one-block-per-span kernel's
before it. ``--variant NAME:key=value,...`` adds this tree's kernel under a
plan with fields replaced (``group_set``, ``cluster``, ``vec``, ``tma``),
under the plan that ``fused_plan`` makes with other values of its rule's
constants (``run_bytes``, ``ctas_per_sm``, ``min_slice_bytes``), or without
the SiLU (``act=0``, held to the plain version without it), timed in the
same turns; a plan the kernel cannot take is skipped. ``--empty`` also
times an empty kernel over the plan's grid and clusters: the latency
floor.

``--pair``: the ``gn_stats`` + ``gn_apply`` pair at its six shapes of one
guided call (``PAIR_SHAPES``, with their launches a call), each kernel and
the pair timed, each copy called with its own C signature (the banded
kernels' with this tree's ``pair_plan``, or the split-count kernels' before
them); ``gn_fused`` of this tree under the plan ``fused_plan`` makes, where
it makes one, in the same turns; and the launch-weighted pair time of a
guided call for each copy. ``--variant`` there replaces ``pair_plan``'s
fields (``vec``, ``threads``, ``bands``, ``rows``) or its rule's
constants (``pair_blocks_per_sm``, ``pair_min_rows``), or drops the SiLU
(``act=0``); ``--build NAME`` adds a build of this tree's source with one
change (``PAIR_BUILDS``: the forward walk, evict-first stores), held to the
plain version like the tree.

``--ablate`` adds builds of this tree's source with one part taken out
(``ABLATIONS``, or ``PAIR_ABLATIONS`` with ``--pair``): they compute wrong
numbers by design, so only their times mean something. Run from the
repository root on the machine with the card: ``python3
scripts/torch_gn_ab.py OTHER_CSRC_DIR [--pair] [--variant ...] [--empty]
[--ablate] [--json PATH]``.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "distdiff_tpu_torch", "csrc")
sys.path.insert(0, ROOT)

# [B, C, H, W] of gn_fused on the main path, most launches first
SHAPES = [(4, 320, 64, 64), (4, 1280, 8, 8), (4, 640, 32, 32), (4, 1280, 16, 16),
          (2, 320, 64, 64), (1, 512, 64, 64), (4, 640, 64, 64)]
# the one-block-per-span kernel's C signature (before the cluster kernel)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
OLD_SIGNATURE = [_P] * 4 + [_I] * 6 + [_F] + [_I] * 4 + [_P]

# gn_fused's parts, each taken out of the tree's groupnorm.cu by text
# replacement: the loads (TMA boxes replaced by a bare arrival: the slice
# is left as it was), the stores (kept for one output pattern in 65536, so
# that the arithmetic stays), the arithmetic of the apply (x copied), and
# the cluster (each block keeps its own partial sums, block barriers only)
ABLATIONS = {
    "no_loads": [("hopper::mbar_arrive_tx(bars + k, box);\n        hopper::tma_load_3d(",
                  "hopper::mbar_arrive(bars + k);\n        if (k < 0) hopper::tma_load_3d(")],
    "no_stores": [("*reinterpret_cast<R*>(ys + r * g.C + cv * V) = out;",
                   "if (reinterpret_cast<const unsigned char*>(&out)[0] == 0xA5u &&\n"
                   "              reinterpret_cast<const unsigned char*>(&out)[1] == 0x5Au)\n"
                   "            *reinterpret_cast<R*>(ys + r * g.C + cv * V) = out;")],
    "no_apply_math": [("affine_act_bf16x2<V>(e, a2, bv, g.act, o);", "out = raw;")],
    "no_cluster": [("gath[i] = cluster.map_shared_rank(part, i / (2 * g.gs))[i % (2 * g.gs)];",
                    "gath[i] = part[i % (2 * g.gs)];"),
                   ("cg::this_cluster().sync();", "__syncthreads();")],
}


# [B, C, H, W] of the gn_stats + gn_apply pair in one guided call, with its
# launches there (chip_smoke.py's plan)
PAIR_SHAPES = [((2, 128, 512, 512), 30), ((2, 256, 512, 512), 5), ((2, 256, 256, 256), 25),
               ((2, 512, 256, 256), 5), ((2, 512, 128, 128), 30), ((4, 960, 64, 64), 29)]
# the split-count kernels' C signatures (before the banded pair)
OLD_STATS = [_P] * 6 + [_I] * 6 + [_F] + [_I] * 3 + [_P]
OLD_APPLY = [_P] * 3 + [_I] * 8 + [_P]

# the pair's parts, taken out the same way: gn_stats' finish (the last
# block's sum of the partials and the (a, b) it writes), gn_apply's stores
# (kept for one output pattern in 65536), gn_apply's whole body (an empty
# kernel over the same grid: the launch and the wave)
_GUARD = ("if (reinterpret_cast<const unsigned char*>(&out)[0] == 0xA5u &&\n"
          "            reinterpret_cast<const unsigned char*>(&out)[1] == 0x5Au)\n")
PAIR_ABLATIONS = {
    "no_finish": [("  finish_row(part + (size_t)b * bands * 2 * G,",
                   "  if (C < 0) finish_row(part + (size_t)b * bands * 2 * G,")],
    "no_stores": [("        *reinterpret_cast<R*>(y + off + u * step) = out;",
                   "        " + _GUARD
                   + "        *reinterpret_cast<R*>(y + off + u * step) = out;"),
                  ("      *reinterpret_cast<R*>(y + off) = out;",
                   "      " + _GUARD + "      *reinterpret_cast<R*>(y + off) = out;")],
    "apply_empty": [("                     int C, int S, int act, int rows) {\n",
                     "                     int C, int S, int act, int rows) {\n"
                     "  if (C > 0) return;\n")],
}

# variants of the pair's source, held to the plain version like the tree
# (``--build NAME``): gn_apply walking each band first to last, as gn_stats
# does; gn_apply's stores with the evict-first hint (an output no later read
# of this kernel wants; the next kernel's cost of it is not seen here)
PAIR_BUILDS = {
    "forward": [("  const int step = -t.rr * C;", "  const int step = t.rr * C;"),
                ("    int off = (b * S + r0 + t.ty + (n > 0 ? (n - 1) * t.rr : 0)) * C + cv * V;",
                 "    int off = (b * S + r0 + t.ty) * C + cv * V;")],
    "stcs": [("        *reinterpret_cast<R*>(y + off + u * step) = out;",
              "        __stcs(reinterpret_cast<R*>(y + off + u * step), out);")],
}


def build(tag, src_dir, work):
    from distdiff_tpu_torch.ops import _build

    lib = os.path.join(work, f"{tag}.so")
    return lib, subprocess.Popen(
        ["/usr/local/cuda/bin/nvcc", *_build.NVCC_FLAGS, "-o", lib,
         os.path.join(src_dir, "groupnorm.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ablated_source(name, work, table=ABLATIONS) -> str:
    """A directory holding the tree's groupnorm.cu without part ``name``."""
    text = open(os.path.join(CSRC, "groupnorm.cu")).read()
    for old, new in table[name]:
        if old not in text:
            raise SystemExit(f"ablation {name}: its text is not in groupnorm.cu")
        text = text.replace(old, new)
    d = os.path.join(work, name)
    os.makedirs(d)
    shutil.copy(os.path.join(CSRC, "hopper.cuh"), d)
    with open(os.path.join(d, "groupnorm.cu"), "w") as f:
        f.write(text)
    return d


def main(argv) -> int:
    import torch

    import chip_smoke as cs
    from distdiff_tpu_torch.models.layers import group_count
    from distdiff_tpu_torch.ops import _build
    from distdiff_tpu_torch.ops import groupnorm as gn

    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--empty", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--pair", action="store_true")
    ap.add_argument("--build", action="append", default=[], choices=sorted(PAIR_BUILDS))
    ap.add_argument("--json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_gn_ab.py needs a CUDA card", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card)
    table = PAIR_ABLATIONS if args.pair else ABLATIONS
    work = tempfile.mkdtemp(prefix="gn_ab_")
    sources = [("tree", CSRC), ("other", args.other)]
    if args.ablate:
        sources += [(name, ablated_source(name, work, table)) for name in table]
    sources += [(name, ablated_source(name, work, PAIR_BUILDS)) for name in args.build]
    procs = [(tag, *build(tag, d, work)) for tag, d in sources]
    libs = {}
    for tag, lib, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{tag}: nvcc failed\n{log[-3000:]}")
        if tag in ("tree", "other"):
            keys = ("gn_stats", "gn_apply") if args.pair else ("gn_fused",)
            print(f"  {tag}: {[r for r in _build.ptxas_report(log) if r[0].startswith(keys)]}")
        libs[tag] = ctypes.CDLL(lib)
    if args.pair:
        rows = pair_main(args, card, libs)
        if args.json:
            os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
            with open(args.json, "w") as f:
                json.dump(rows, f, indent=1)
        return 0
    fns = {}
    for tag, lib in libs.items():
        fn = lib.gn_fused
        new = hasattr(lib, "gn_fused_smem")
        fn.argtypes = _build.SIGNATURES["gn_fused"][1] if new else OLD_SIGNATURE
        fn.restype = ctypes.c_int
        fns[tag] = (fn, new)
    tree = libs["tree"]
    for name in ("gn_empty", "gn_fused_smem"):
        f = getattr(tree, name)
        f.argtypes, f.restype = _build.SIGNATURES[name][1], ctypes.c_int
    variants = {}
    for spec in args.variant:
        name, _, fields = spec.partition(":")
        variants[name] = {k: int(v) for k, v in (f.split("=") for f in fields.split(","))}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    smem_limit, sm_count = gn._device_limits(dev)
    rows = []
    for shape in SHAPES:
        b, c, h, w = shape
        s, groups = h * w, group_count(c)
        x = (torch.randn(shape, generator=gen, device=dev) * 1.5 + 0.3).to(
            torch.bfloat16).to(memory_format=torch.channels_last)
        scale = (1.0 + 0.5 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        bias = (0.5 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        def plan_of(**rule):  # fused_plan, its constants given new values
            saved = {k: getattr(gn, f"_{k.upper()}") for k in rule}
            for k, v in rule.items():
                setattr(gn, f"_{k.upper()}", v)
            try:
                return gn.fused_plan(b, c, s, groups, 2, "nhwc", sm_count, smem_limit,
                                     x.data_ptr(), x.data_ptr())
            finally:
                for k, v in saved.items():
                    setattr(gn, f"_{k.upper()}", v)

        plan = plan_of()
        # (tag, library, plan, act, held to the plain version)
        runs = [("tree", "tree", plan, 1, True), ("other", "other", plan, 1, True)]
        for name, fields in variants.items():  # those the kernel takes, in shared memory
            fields = dict(fields)
            act = fields.pop("act", 1)
            rule = {k: fields.pop(k) for k in list(fields) if k not in gn.FusedPlan._fields}
            p = plan_of(**rule)._replace(**fields)
            if 0 < tree.gn_fused_smem(1, c, s, groups, 1, *p) <= smem_limit:
                runs.append((name, "tree", p, act, True))
            else:
                print(f"  {name} skipped at {list(shape)}: the kernel cannot take {tuple(p)}")
        if args.ablate:
            runs += [(name, name, plan, 1, False) for name in ABLATIONS]
        calls, outs, plans, acts, checked = {}, {}, {}, {}, []
        for tag, lib_tag, p, act, check in runs:
            fn, new = fns[lib_tag]
            y = torch.empty_like(x)
            tail = tuple(p) if new else (gn.fused_header_bytes(c // groups),
                                         gn._vec(2, c // groups, math.gcd(
                                             16, x.data_ptr(), y.data_ptr())))
            plans[tag], acts[tag] = tail, act

            def call(fn=fn, y=y, tail=tail, act=act):
                rc = fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), 1, 1, b,
                        c, s, groups, 1e-5, 1, act, *tail, stream)
                if rc:
                    raise SystemExit(f"launch failed with CUDA error {rc} ({tail})")

            call()
            torch.cuda.synchronize()
            calls[tag], outs[tag] = call, y
            if check:
                checked.append(tag)
        if args.empty:
            smem = gn.fused_smem_bytes("nhwc", c, s, groups, 2, plan)

            def call_empty(smem=smem):
                rc = tree.gn_empty(b, groups, plan.group_set, plan.cluster, smem, stream)
                if rc:
                    raise SystemExit(f"empty launch failed with CUDA error {rc}")

            calls["empty"] = call_empty
        refs = {act: gn.group_norm_reference(x, scale, bias, groups, 1e-5,
                                             ("silu" if act else None)).float()
                for act in set(acts.values())}
        diffs = {}
        for tag in checked:
            ref = refs[acts[tag]]
            diffs[tag] = d = (outs[tag].float() - ref).abs().max().item()
            if not d <= 2.0 ** -7 * ref.abs().max().item():
                raise SystemExit(f"{tag} disagrees with the plain version at {shape}: {d:.3e}")
        diff = (outs["tree"].float() - outs["other"].float()).abs().max().item()
        order = ["other"] + [t for t in calls if t != "other"]
        times = {tag: [] for tag in calls}
        for turn in (order, order[::-1], order):
            for tag in turn:
                times[tag].append(cs.time_ms(calls[tag], 20))
        b_ms, _ = cs.gn_bound("gn_fused", shape, 2)
        row = {"shape": list(shape), "card": card, "plan": list(plan), "bound_ms": b_ms,
               "max_abs_diff_tree_other": diff, "max_abs_err": diffs,
               "plans": {k: list(v) for k, v in plans.items()},
               **{f"{t}_ms": statistics.median(v) for t, v in times.items()},
               **{f"{t}_runs": v for t, v in times.items()}}
        rows.append(row)
        print(f"  {list(shape)} {tuple(plan)}: " + ", ".join(
            f"{t} {row[f'{t}_ms']:.4f}" for t in times) + f" ms; bound {b_ms:.4f}; "
            f"|tree - other| {diff:.2e}", flush=True)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


def pair_main(args, card, libs) -> list:
    """The --pair mode: one row per shape of PAIR_SHAPES, and the
    launch-weighted times of a guided call."""
    import torch

    import chip_smoke as cs
    from distdiff_tpu_torch.models.layers import group_count
    from distdiff_tpu_torch.ops import _build
    from distdiff_tpu_torch.ops import groupnorm as gn

    fns = {}
    for tag, lib in libs.items():
        new = hasattr(lib, "gn_stats_smem")
        stats, apply_ = lib.gn_stats, lib.gn_apply
        stats.argtypes = _build.SIGNATURES["gn_stats"][1] if new else OLD_STATS
        apply_.argtypes = _build.SIGNATURES["gn_apply"][1] if new else OLD_APPLY
        stats.restype = apply_.restype = ctypes.c_int
        fns[tag] = (stats, apply_, new)
    tree = libs["tree"]
    tree.gn_fused.argtypes, tree.gn_fused.restype = _build.SIGNATURES["gn_fused"][1], ctypes.c_int
    variants = {}
    for spec in args.variant:
        name, _, fields = spec.partition(":")
        variants[name] = {k: int(v) for k, v in (f.split("=") for f in fields.split(","))}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    smem_limit, sm_count = gn._device_limits(dev)
    rows_out, totals = [], collections.Counter()
    for shape, launches in PAIR_SHAPES:
        b, c, h, w = shape
        s, groups = h * w, group_count(c)
        x = (torch.randn(shape, generator=gen, device=dev) * 1.5 + 0.3).to(
            torch.bfloat16).to(memory_format=torch.channels_last)
        scale = (1.0 + 0.5 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        bias = (0.5 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        part = torch.empty(b * 1024 * 2 * groups, device=dev, dtype=torch.float32)

        def plan_of(**rule):  # pair_plan, its constants given new values
            saved = {k: getattr(gn, f"_{k.upper()}") for k in rule}
            for k, v in rule.items():
                setattr(gn, f"_{k.upper()}", v)
            try:
                return gn.pair_plan(b, c, s, 2, "nhwc", sm_count, x.data_ptr(), x.data_ptr())
            finally:
                for k, v in saved.items():
                    setattr(gn, f"_{k.upper()}", v)

        plan = plan_of()
        # (tag, library, plan, act, held to the plain version)
        runs = [("tree", "tree", plan, 1, True), ("other", "other", plan, 1, True)]
        for name, fields in variants.items():
            fields = dict(fields)
            act = fields.pop("act", 1)
            rule = {k: fields.pop(k) for k in list(fields) if k not in gn.PairPlan._fields}
            runs.append((name, "tree", plan_of(**rule)._replace(**fields), act, True))
        runs += [(name, name, plan, 1, True) for name in args.build]
        if args.ablate:
            runs += [(name, name, plan, 1, False) for name in PAIR_ABLATIONS]
        calls, outs, acts, checked = {}, {}, {}, []
        for tag, lib_tag, p, act, check in runs:
            stats, apply_, new = fns[lib_tag]
            y = torch.empty_like(x)
            ab = torch.empty((b, 2, c), device=dev, dtype=torch.float32)
            # a counter of its own: an ablation may leave it nonzero
            counter = torch.zeros(b, device=dev, dtype=torch.int32)
            if new:
                st_tail = ap_tail = tuple(p)
            else:  # the split-count kernels' own rule (4 blocks an SM, >= 16 rows a block)
                nsplit = max(1, min(-(-4 * sm_count // b), s // 16, 65535))
                st_tail, ap_tail = (nsplit, p.vec), (sm_count, p.vec)

            def run_stats(stats=stats, ab=ab, st_tail=st_tail, counter=counter):
                rc = stats(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), part.data_ptr(),
                           counter.data_ptr(), ab.data_ptr(), 1, 1, b, c, s, groups, 1e-5, 1,
                           *st_tail, stream)
                if rc:
                    raise SystemExit(f"gn_stats launch failed with CUDA error {rc}")

            def run_apply(apply_=apply_, ab=ab, y=y, ap_tail=ap_tail, act=act):
                rc = apply_(x.data_ptr(), ab.data_ptr(), y.data_ptr(), 1, b, c, s, 1, act,
                            *ap_tail, stream)
                if rc:
                    raise SystemExit(f"gn_apply launch failed with CUDA error {rc}")

            def run_pair(run_stats=run_stats, run_apply=run_apply):
                run_stats()
                run_apply()

            run_pair()
            torch.cuda.synchronize()
            calls[f"{tag}_stats"], calls[f"{tag}_apply"] = run_stats, run_apply
            calls[tag] = run_pair
            outs[tag], acts[tag] = (ab, y), act
            if check:
                checked.append(tag)
        try:
            fplan = gn.fused_plan(b, c, s, groups, 2, "nhwc", sm_count, smem_limit, x.data_ptr(),
                                  x.data_ptr())
        except ValueError:
            fplan = None
        if fplan is not None:
            yf = torch.empty_like(x)

            def run_fused(yf=yf):
                rc = tree.gn_fused(x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                                   yf.data_ptr(), 1, 1, b, c, s, groups, 1e-5, 1, 1, *fplan,
                                   stream)
                if rc:
                    raise SystemExit(f"gn_fused launch failed with CUDA error {rc}")

            run_fused()
            torch.cuda.synchronize()
            calls["fused"], outs["fused"], acts["fused"] = run_fused, (None, yf), 1
            checked.append("fused")
        ref_ab = gn.group_norm_stats_reference(x, scale, bias, groups, 1e-5)
        refs = {a: gn.group_norm_apply_reference(x, ref_ab, "silu" if a else None).float()
                for a in set(acts.values())}
        errs = {}
        for tag in checked:
            ab, y = outs[tag]
            ref = refs[acts[tag]]
            errs[tag] = d = (y.float() - ref).abs().max().item()
            if not d <= 2.0 ** -7 * ref.abs().max().item():
                raise SystemExit(f"{tag} disagrees with the plain version at {shape}: {d:.3e}")
            if ab is not None and not torch.allclose(ab, ref_ab, atol=2e-4, rtol=2e-4):
                raise SystemExit(f"{tag}: (a, b) disagree with the plain version at {shape}")
        diff = (outs["tree"][1].float() - outs["other"][1].float()).abs().max().item()
        order = ["other", "other_stats", "other_apply"] + [
            t for t in calls if not t.startswith("other")]
        times = {tag: [] for tag in calls}
        for turn in (order, order[::-1], order):
            for tag in turn:
                times[tag].append(cs.time_ms(calls[tag], 20))
        med = {t: statistics.median(v) for t, v in times.items()}
        bounds = {k: cs.gn_bound(k, shape, 2)[0] for k in ("gn_stats", "gn_apply")}
        pair_bound = bounds["gn_stats"] + bounds["gn_apply"]
        for t in ("tree", "other", "fused"):
            if t in med:
                totals[t] += launches * med[t]
        row = {"shape": list(shape), "launches_per_call": launches, "card": card,
               "plan": list(plan), "fused_plan": list(fplan) if fplan else None,
               "bound_stats_ms": bounds["gn_stats"], "bound_apply_ms": bounds["gn_apply"],
               "bound_pair_ms": pair_bound, "bound_fused_ms": cs.gn_bound("gn_fused", shape, 2)[0],
               "max_abs_diff_tree_other": diff, "max_abs_err": errs,
               **{f"{t}_ms": m for t, m in med.items()},
               **{f"{t}_runs": v for t, v in times.items()}}
        rows_out.append(row)
        print(f"  {list(shape)} x{launches} {tuple(plan)}: " + ", ".join(
            f"{t} {m:.4f}" for t, m in med.items()) + f" ms; bound pair {pair_bound:.4f} "
            f"(stats {bounds['gn_stats']:.4f}); tree at {pair_bound / med['tree']:.2f} of it; "
            f"|tree - other| {diff:.2e}", flush=True)
        del x, part
        torch.cuda.empty_cache()
    print("  launch-weighted pair time a guided call (ms): " + ", ".join(
        f"{t} {v:.4f}" for t, v in totals.items())
        + " (fused: the shapes fused_plan takes, without [2,256,512,512])")
    rows_out.append({"launch_weighted_ms": dict(totals), "card": card})
    return rows_out


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
