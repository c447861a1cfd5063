"""The host-side logic of ``chip_smoke.py``: without a card it fails and
prints no result, its launch plan for the SD-1.5 recipe, and the kernels'
JSON entries it builds from per-shape records."""

import importlib.util
import os
import types

import pytest
import torch

from distdiff_tpu_torch.config import GuidanceConfig, PipelineConfig
from distdiff_tpu_torch.schedulers import make_schedule

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fails_without_a_card_and_prints_no_result(smoke, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert smoke.main([]) != 0
    assert smoke.main(["--profile"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("strength,want", [
    # 25 plain + 2 rollout + 2 recomputed in the backward UNet forwards, 10
    # long self-attentions each, + 5 VAE mid-block attentions; at 0.75,
    # 38 + 4 UNet forwards
    (0.5, {"flash_fwd": 295, "flash_bwd_fused": 20, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}),
    (0.75, {"flash_fwd": 425, "flash_bwd_fused": 20, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}),
])
def test_launch_plan_of_the_sd15_recipe(smoke, strength, want):
    pipe = types.SimpleNamespace(config=PipelineConfig.sd15(), guidance_cfg=GuidanceConfig(),
                                 sched=make_schedule(50), strength=strength)
    assert smoke.expected_launches(pipe) == want


def test_summary_has_one_entry_per_kernel_with_launch_weighted_means(smoke):
    def rec(name, cell, shape, ms):
        return {"name": name, "cell": cell, "shape": shape, "source": f"{name}.cu",
                "max_abs_err": ms / 100, "ms": ms, "plain_ms": 2 * ms,
                "bound_ms": ms / 10, "bound_by": "operations", "library_ms": ms / 2}

    records = [rec(n, "a", [4, 64, 64, 40], 1.0) for n in smoke.REPLACES]
    records.append(rec("flash_fwd", "b", [2, 64, 64, 512], 4.0))
    by_shape = {(n, (4, 64, 64, 40)): 3 for n in smoke.REPLACES}
    by_shape[("flash_fwd", (2, 64, 64, 512))] = 1
    entries = smoke.summarize(records, by_shape)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert [e["name"] for e in entries] == list(smoke.REPLACES)
    for e in entries:
        assert keys <= set(e)
    fwd = entries[0]
    assert fwd["launches"] == 4
    assert fwd["ms"] == pytest.approx((3 * 1.0 + 1 * 4.0) / 4)
    assert fwd["library_ms"] == pytest.approx((3 * 0.5 + 1 * 2.0) / 4)
    assert fwd["max_abs_err"] == pytest.approx(0.04)
    with pytest.raises(SystemExit, match="never launched"):
        smoke.summarize(records, {})


def _sd15_pipe(strength=0.5):
    return types.SimpleNamespace(config=PipelineConfig.sd15(), guidance_cfg=GuidanceConfig(),
                                 sched=make_schedule(50), strength=strength)


def test_groupnorm_counts_per_model_call(smoke):
    cfg = PipelineConfig.sd15()
    unet = smoke.unet_norms(cfg.unet, 64)
    assert len(unet) == 61 and sum(act is None for _, _, act in unet) == 16
    assert unet[0] == (320, 64, "silu") and unet[-1] == (320, 64, "silu")
    assert (960, 64, "silu") in unet and (2560, 8, "silu") in unet
    assert len(smoke.vae_decode_norms(cfg.vae, 64)) == 30
    assert smoke.vae_decode_norms(cfg.vae, 64)[-1] == (128, 512, "silu")
    enc = smoke.vae_encode_norms(cfg.vae, 512)
    assert len(enc) == 22 and enc[-1] == (512, 64, "silu")


@pytest.mark.parametrize("guide_chunk,want", [
    # 29 UNet forwards (61 norms) + 5 VAE decodes (30 norms); the 64^2 x 960
    # norms and the VAE's stages from 128^2 up take the pair
    (None, {"gn_fused": 1795, "gn_stats": 124, "gn_apply": 124}),
    # the rollout and its recompute per unit: 25 + 2 x 4 UNet forwards,
    # 2 x 4 + 1 decodes
    (1, {"gn_fused": 2079, "gn_stats": 204, "gn_apply": 204}),
])
def test_groupnorm_launch_plan_of_the_sd15_recipe(smoke, guide_chunk, want):
    plan = smoke.gn_plan(smoke.expand_gn_calls(_sd15_pipe(), 2, guide_chunk))
    totals = {k: sum(n for (name, _), n in plan.items() if name == k) for k in want}
    assert totals == want
    assert plan[("gn_stats", (4, 960, 64, 64))] == (29 if guide_chunk is None else 25)
    assert plan[("gn_fused", (4, 640, 64, 64))] > 0
    # fp32 spans are twice the bytes: the 64^2 x 640 norms no longer fit
    assert smoke.gn_plan(smoke.expand_gn_calls(_sd15_pipe(), 2), itemsize=4)[
        ("gn_stats", (4, 640, 64, 64))] > 0


def test_split_expand_flash_plan_and_main_shapes(smoke):
    assert smoke.expected_launches(_sd15_pipe(), units=2) == {
        "flash_fwd": 339, "flash_bwd_fused": 40, "flash_bwd_dq": 4, "flash_bwd_dkv": 4}
    shapes = smoke.gn_shapes(smoke.main_gn_calls())
    assert len(shapes) == 42
    assert shapes[(4, 320, 64, 64)] == (32, {"silu", None})
    assert shapes[(2, 128, 512, 512)] == (32, {"silu"})


def test_gn_bound_counts_slab_passes(smoke):
    shape = (2, 128, 512, 512)
    one = 2 * 128 * 512 * 512 * 2 / smoke.PEAK_BYTES * 1e3
    assert smoke.gn_bound("gn_stats", shape, 2) == (pytest.approx(one), "bytes")
    assert smoke.gn_bound("gn_apply", shape, 2)[0] == pytest.approx(2 * one)
    assert smoke.gn_bound("gn_fused", shape, 4)[0] == pytest.approx(4 * one)


@pytest.mark.parametrize("name,shape,itemsize,want", [
    # fp32: each product as three TF32 products at 495 TFLOP/s (3xTF32)
    ("flash_fwd", (2, 4096, 4096, 512), 4, 0.4165),
    ("flash_fwd", (4, 4096, 4096, 160), 4, 0.2603),
    # the narrow fp32 forward at the UNet's shapes
    ("flash_fwd", (32, 4096, 4096, 40), 4, 0.5206),
    ("flash_fwd", (32, 1024, 1024, 80), 4, 0.0651),
    # the fp32 split pair: 3 and 4 products
    ("flash_bwd_dq", (2, 4096, 4096, 512), 4, 0.6247),
    ("flash_bwd_dkv", (2, 4096, 4096, 512), 4, 0.8330),
    ("flash_bwd_dq", (4, 4096, 4096, 160), 4, 0.39045),
    ("flash_bwd_dkv", (4, 4096, 4096, 160), 4, 0.5206),
    # the fp32 fused backward at the UNet's shapes: 5 products
    ("flash_bwd_fused", (32, 4096, 4096, 40), 4, 1.3015),
    ("flash_bwd_fused", (32, 1024, 1024, 80), 4, 0.1627),
    # bf16: one product on the bf16 tensor cores, as before
    ("flash_fwd", (2, 4096, 4096, 512), 2, 0.0695),
    ("flash_fwd", (32, 4096, 4096, 40), 2, 0.1377),
    ("flash_bwd_fused", (32, 4096, 4096, 40), 2, 0.2171),
    ("flash_bwd_dq", (2, 4096, 4096, 512), 2, 0.1042),
    ("flash_bwd_dkv", (2, 4096, 4096, 512), 2, 0.1390),
])
def test_flash_bound_counts_fp32_products_as_three_tf32(smoke, name, shape, itemsize, want):
    """The least time of an fp32-accurate flash kernel on the card: every
    product three times on the TF32 tensor cores; bf16 bounds unchanged."""
    ms, by = smoke.bound(name, *shape, itemsize=itemsize)
    assert ms == pytest.approx(want, abs=5e-5) and by == "operations"


def test_call_weighted_means_follow_the_launches_of_the_call(smoke):
    """The launch-weighted numbers of the gn_stats / gn_apply rows: each
    timed shape's kernel, plain, library and bound ms weighted by its
    launches in the counted call; a shape the call did not launch weighs
    nothing, and a kernel with no launched shape fails the run."""
    recs = [{"name": "gn_stats", "shape": [2, 320, 64, 64], "ms": 1.0, "plain_ms": 4.0,
             "library_ms": 2.0, "bound_ms": 0.5},
            {"name": "gn_stats", "shape": [2, 640, 32, 32], "ms": 3.0, "plain_ms": 8.0,
             "library_ms": 6.0, "bound_ms": 1.5},
            {"name": "gn_stats", "shape": [2, 960, 8, 8], "ms": 9.0, "plain_ms": 9.0,
             "library_ms": 9.0, "bound_ms": 9.0}]
    launches = {("gn_stats", (2, 320, 64, 64)): 3, ("gn_stats", (2, 640, 32, 32)): 1}
    m = smoke.call_weighted(recs, launches, ("gn_stats",))["gn_stats"]
    assert m["shapes"] == 2 and m["launches"] == 4
    assert m["ms"] == pytest.approx(1.5) and m["plain_ms"] == pytest.approx(5.0)
    assert m["library_ms"] == pytest.approx(3.0) and m["bound_ms"] == pytest.approx(0.75)
    with pytest.raises(SystemExit, match="gn_apply"):
        smoke.call_weighted(recs, launches, ("gn_apply",))


def test_gn_fused_plan_at_every_main_path_shape(smoke):
    """Every gn_fused shape of the counted runs (bf16, channels-last, 16-byte
    aligned) takes 16-byte vectors over a run of at least 64 bytes at each
    pixel, loads by TMA where its grid has more than 4 blocks an SM, and
    fits an H100 block's shared memory."""
    from distdiff_tpu_torch.models.layers import group_count
    from distdiff_tpu_torch.ops import groupnorm as gn

    shapes = sorted({s for name, s in smoke.gn_plan(smoke.main_gn_calls()) if name == "gn_fused"})
    assert len(shapes) == 28
    for b, c, h, w in shapes:
        groups = group_count(c)
        plan = gn.fused_plan(b, c, h * w, groups, 2, "nhwc", 132, smoke.H100_SMEM_OPTIN, 0, 0)
        blocks = b * groups // plan.group_set * plan.cluster
        assert plan.vec == 8 and plan.tma == (blocks > 4 * 132)
        run = plan.group_set * (c // groups) * 2
        assert run >= 64 and run % 16 == 0
        assert gn.fused_smem_bytes("nhwc", c, h * w, groups, 2, plan) <= smoke.H100_SMEM_OPTIN


# the gn_stats + gn_apply shapes of the counted runs (main_gn_calls)
PAIR_SHAPES = [
    (1, 128, 512, 512), (1, 256, 256, 256), (1, 256, 512, 512), (1, 512, 128, 128),
    (1, 512, 256, 256), (2, 128, 256, 256), (2, 128, 512, 512), (2, 256, 128, 128),
    (2, 256, 256, 256), (2, 256, 512, 512), (2, 512, 128, 128), (2, 512, 256, 256),
    (2, 960, 64, 64), (4, 960, 64, 64)]


def test_pair_shapes_are_the_main_paths(smoke):
    assert sorted({s for name, s in smoke.gn_plan(smoke.main_gn_calls())
                   if name == "gn_stats"}) == PAIR_SHAPES


@pytest.mark.parametrize("shape", PAIR_SHAPES)
def test_pair_plan_at_every_main_path_shape(smoke, shape):
    """In both layouts and both types: the kernels' walk covers every row
    once, in bounds, with vectors that divide and align; bf16 channels-last
    (the main path) takes 16-byte vectors, one block of 240 or 256 threads
    per band, one wave of about 4 blocks an SM, and gn_stats' shared memory
    fits."""
    from distdiff_tpu_torch.models.layers import group_count
    from distdiff_tpu_torch.ops import groupnorm as gn

    b, c, h, w = shape
    for lay in ("nhwc", "nchw"):
        for itemsize in (2, 4):
            plan = gn.pair_plan(b, c, h * w, itemsize, lay, 132, 4096, 8192)
            smoke.check_pair_plan(b, c, h * w, itemsize, lay, plan, 4096, 8192)
            assert gn.pair_smem_bytes(lay, c, group_count(c), plan) <= smoke.H100_SMEM_OPTIN
    plan = gn.pair_plan(b, c, h * w, 2, "nhwc", 132, 0, 0)
    assert plan.vec == 8 and plan.threads in (240, 256)
    assert 4 * 132 * 0.95 <= b * plan.bands <= 4 * 132


# B = 1; rows no multiple of the band; vectors of 4, 2 and 1; pointers off
# 16 bytes; fp32; a column loop; one pixel; NCHW (test_torch_groupnorm.py
# holds the plans' values)
PAIR_EDGES = [
    (1, 960, 4096, 2, "nhwc", 0, 0), (2, 256, 10000, 2, "nhwc", 0, 0),
    (2, 36, 255, 2, "nhwc", 0, 0), (2, 50, 323, 2, "nhwc", 0, 0), (1, 45, 256, 2, "nhwc", 0, 0),
    (2, 128, 4096, 2, "nhwc", 4098, 8192), (2, 128, 4096, 2, "nhwc", 4096, 8200),
    (2, 128, 512 * 512, 4, "nhwc", 0, 0), (1, 2560, 81, 2, "nhwc", 0, 0),
    (1, 64, 1, 2, "nhwc", 0, 0), (2, 128, 512 * 512, 2, "nchw", 0, 0),
    (1, 32, 63, 4, "nchw", 0, 0), (3, 32, 25, 2, "nchw", 0, 0),
    (2, 128, 4096, 2, "nchw", 4098, 4096), (1, 1280, 64, 4, "nchw", 0, 0)]


@pytest.mark.parametrize("case", PAIR_EDGES)
def test_pair_plan_replays_at_edges(smoke, case):
    from distdiff_tpu_torch.ops import groupnorm as gn

    b, c, s, itemsize, lay, x_ptr, y_ptr = case
    plan = gn.pair_plan(b, c, s, itemsize, lay, 132, x_ptr, y_ptr)
    smoke.check_pair_plan(b, c, s, itemsize, lay, plan, x_ptr, y_ptr)


@pytest.mark.parametrize("field, value, fault", [
    ("bands", 263, "bands do not tile"),     # one band short of the rows
    ("vec", 16, "vector"),                   # 32 bytes a load
    ("threads", 250, "threads are no whole rows"),
    ("rows", 1000, "bands do not tile"),     # the last band empty
])
def test_pair_plan_replay_catches_faults(smoke, field, value, fault):
    from distdiff_tpu_torch.ops import groupnorm as gn

    plan = gn.pair_plan(2, 128, 512 * 512, 2, "nhwc", 132, 0, 0)._replace(**{field: value})
    with pytest.raises(SystemExit, match=fault):
        smoke.check_pair_plan(2, 128, 512 * 512, 2, "nhwc", plan, 0, 0)
