"""The frozen work counts: the bounds reproduce the kernel table's bound
column, the launch plans reproduce the program's launch counts as the
chip runs printed them (guided call at batch 2), and the FLOPs an image of
each cell are as stated in PERF.md."""

import json
import os

import pytest

from portbench.work import attention, flops, groupnorm
from portbench.work.recipe import Steps, steps

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(config, traffic, **edit):
    with open(os.path.join(BENCH, "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(BENCH, "traffic", f"{traffic}.json")) as f:
        tr = json.load(f)
    return cfg, dict(tr, **edit)


@pytest.mark.parametrize("shape,kernel,ms", [
    ((32, 4096, 4096, 40), "flash_fwd", 0.1377), ((32, 1024, 1024, 80), "flash_fwd", 0.0109),
    ((2, 4096, 4096, 512), "flash_fwd", 0.0695), ((2, 16384, 16384, 512), "flash_fwd", 1.1117),
    ((80, 1024, 1024, 64), "flash_fwd", 0.0217), ((40, 4096, 4096, 64), "flash_fwd", 0.1737),
    ((32, 4096, 4096, 40), "flash_bwd_fused", 0.2171),
    ((2, 16384, 16384, 512), "flash_bwd_dq", 1.6676),
    ((2, 16384, 16384, 512), "flash_bwd_dkv", 2.2235),
])
def test_attention_bounds_match_the_kernel_table(shape, kernel, ms):
    assert round(attention.bound_s(kernel, *shape) * 1e3, 4) == ms


@pytest.mark.parametrize("shape,ms", [((4, 320, 64, 64), 0.0063), ((4, 1280, 8, 8), 0.0004)])
def test_groupnorm_bounds_match_the_kernel_table(shape, ms):
    assert round(groupnorm.bound_s(shape) * 1e3, 4) == ms


@pytest.mark.parametrize("config,flash,gn", [
    ("sd15", (295, 20, 2, 2), (1795, 124, 124)),
    ("sdxl_base", (2035, 140, 2, 2), (928, 556, 556)),
])
def test_launch_plans_match_the_programs_counts(config, flash, gn):
    cfg, tr = load(config, "guided_b2")
    assert tuple(attention.launch_totals(cfg, tr).values()) == flash
    assert tuple(groupnorm.launch_totals(cfg, tr).values()) == gn


def test_unguided_runs_no_backward():
    cfg, tr = load("sd15", "unguided_b16")
    assert steps(tr) == Steps(plain=25, period=0, batch=16)
    assert attention.launch_totals(cfg, tr) == {
        "flash_fwd": 251, "flash_bwd_fused": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


# TFLOP an image, as PERF.md states them
FLOPS = {("sd15", "guided_b8"): 59.74181834752, ("sd15", "unguided_b16"): 42.678190997504,
         ("sdxl_base", "guided_b2"): 448.43223576576}


@pytest.mark.parametrize("config,traffic", sorted(FLOPS))
def test_flops_per_image(config, traffic):
    cfg, tr = load(config, traffic)
    assert flops.per_image(cfg, tr) / 1e12 == pytest.approx(FLOPS[(config, traffic)], rel=1e-9)


def test_needed_work_leaves_recomputation_out():
    cfg, tr = load("sd15", "guided_b8")
    need = attention.needed(cfg, tr)
    # 25 plain steps and 2 rollout steps, 5 attentions a call at each of 64^2 and 32^2
    assert need[("fwd", (8 * 2 * 8, 4096, 4096, 40))] == 5 * 27
    assert need[("bwd", (8 * 2 * 8, 4096, 4096, 40))] == 5 * 2
    assert need[("fwd", (8, 4096, 4096, 512))] == 3
    assert sum(groupnorm.needed(cfg, tr).values()) < sum(groupnorm.launches(cfg, tr).values())
