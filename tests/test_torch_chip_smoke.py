"""The host-side logic of ``chip_smoke.py``: without a card it fails and
prints no result, its launch plan for the SD-1.5 recipe, and the kernels'
JSON entries it builds from per-shape records."""

import collections
import importlib.util
import math
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
    assert len(shapes) == 48
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
    assert len(shapes) == 29
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
    (2, 960, 64, 64), (4, 960, 64, 64), (8, 128, 256, 256), (8, 128, 512, 512),
    (8, 256, 128, 128), (8, 256, 256, 256), (8, 512, 128, 128)]


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


def test_caltech_tree_writer_gives_the_loaders_dataset(smoke, tmp_path):
    from distdiff_tpu_torch.data import load_dataset, load_image

    names = smoke.write_caltech_tree(str(tmp_path), sizes=(8, 12))
    loaded = load_dataset("caltech-101", data_root=str(tmp_path))
    assert len(names) == smoke.CLI_CLASSES == loaded.num_classes == 100
    assert loaded.classnames == [n.replace("_", " ") for n in names]
    assert len(loaded.train) == 300 and len(loaded.test) == 100
    assert loaded.train.labels == [i // 3 for i in range(300)]
    assert all(smoke.CLI_DROPPED[0] not in p for p in loaded.train.image_paths)
    for path in loaded.train.image_paths[:20]:
        img = load_image(path)
        h, w, _ = img.shape
        assert 8 <= h <= 12 and 8 <= w <= 12 and h != w and img.max() > img.min()


def test_guide_checkpoint_writer_loads_through_load_weights(smoke, tmp_path):
    from distdiff_tpu_torch.models.guide import create_model

    path = str(tmp_path / "model_best.pth.tar")
    state = smoke.write_guide_checkpoint(path)
    saved = torch.load(path, map_location="cpu", weights_only=False)
    assert all(k.startswith("module.") for k in saved["state_dict"])
    guide = create_model("resnet50", num_classes=100, weight_path=path, device="cpu")
    keys = [k for k in state if not k.endswith("num_batches_tracked")]
    smoke.loaded_matches(guide.module, state, keys, "guide")
    assert float(guide.module.bn1.running_var.min()) >= 0.5  # the seeded statistics
    with pytest.raises(SystemExit, match="differs"):
        smoke.loaded_matches(create_model("resnet50", num_classes=100, device="cpu").module,
                             state, ["conv1.weight"], "guide")


def test_cli_argument_list_is_the_published_recipe(smoke):
    from distdiff_tpu_torch.cli.generate_data import check_ported, parse_args

    args = parse_args(smoke.cli_argv("data", "ckpt", "guide.pth.tar", "out"))
    check_ported(args)  # every option it sets is ported
    assert (args.dataset, args.arch, args.guidance_type) == (
        "caltech-101", "resnet50", "transform_guidance")
    assert (args.strength, args.K, args.rho, args.guidance_step, args.guidance_period,
            args.constraint_value) == (0.5, 3, 10.0, 20, 2, 0.2)
    assert (args.num_images_per_prompt, args.train_batch_size, args.max_units, args.seed) == (
        1, 2, 4, 0)
    assert (args.sd_checkpoint, args.encoder_weight_path, args.output_dir) == (
        "ckpt", "guide.pth.tar", "out")
    assert not args.tiny and not args.fused_program and args.resolution == 512


def test_filtered_png_writer_gives_paeth_and_average_rows_pil_reads(smoke, tmp_path):
    import zlib

    import numpy as np
    from PIL import Image

    from distdiff_tpu_torch.data import load_image

    rng = np.random.default_rng(3)
    img01 = rng.uniform(0, 1, (13, 9, 3))
    want = np.clip(img01 * 255.0 + 0.5, 0, 255).astype(np.uint8)
    path = str(tmp_path / "sub" / "x.png")
    smoke.save_png_filtered(path, img01)
    assert np.array_equal(load_image(path), want)
    assert np.array_equal(np.asarray(Image.open(path).convert("RGB")), want)
    data = open(path, "rb").read()
    n = int.from_bytes(data[33:37], "big")  # the IDAT chunk follows IHDR
    assert data[37:41] == b"IDAT"
    rows = np.frombuffer(zlib.decompress(data[41:41 + n]), np.uint8).reshape(13, 9 * 3 + 1)
    assert rows[:, 0].tolist() == [4, 3] * 6 + [4]


def test_caltech_tree_writes_half_its_classes_with_paeth_and_average_rows(smoke, tmp_path):
    import zlib

    import numpy as np

    smoke.write_caltech_tree(str(tmp_path), classes=4, train=1, test=1, sizes=(8, 12))
    for ci, want in ((0, {0}), (1, {3, 4}), (2, {0}), (3, {3, 4})):
        data = open(tmp_path / "caltech-101" / "train" / f"class_{ci:03d}" / "image_0000.png",
                    "rb").read()
        w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")
        n = int.from_bytes(data[33:37], "big")
        rows = np.frombuffer(zlib.decompress(data[41:41 + n]), np.uint8).reshape(h, 3 * w + 1)
        assert set(rows[:, 0].tolist()) == want


def test_require_timed_names_the_shapes_phase_2_did_not_hold(smoke):
    import collections

    records = [{"name": "flash_fwd", "shape": [4, 64, 64, 40]},
               {"name": "gn_fused", "shape": [2, 320, 8, 8]}]
    launched = collections.Counter({("flash_fwd", (4, 64, 64, 40)): 3,
                                    ("gn_fused", (2, 320, 8, 8)): 1})
    smoke.require_timed(records, launched, "phase 4")
    launched[("flash_fwd", (8, 4096, 4096, 512))] += 1
    with pytest.raises(SystemExit, match=r"phase 6 .*\('flash_fwd', \(8, 4096, 4096, 512\)\)"):
        smoke.require_timed(records, launched, "phase 6")


def test_cli_encode_batch_is_the_datasets_own(smoke):
    import inspect

    from distdiff_tpu_torch.cli import generate_data
    from distdiff_tpu_torch.data import SDDataset

    assert inspect.signature(SDDataset).parameters["encode_batch"].default == smoke.CLI_ENCODE_BATCH
    assert "encode_batch" not in inspect.getsource(generate_data)


def test_trainer_argument_list_is_the_jax_defaults_at_resnet50_width(smoke):
    from distdiff_tpu.cli import train as j_train
    from distdiff_tpu_torch.cli import train

    argv = smoke.train_argv("data", "run", 2, ["--resume", "run"])
    args = train.parse_args(argv)
    assert vars(args) == vars(j_train.parse_args(argv))
    assert (args.arch, args.input_size, args.train_batch, args.test_batch) == (
        "resnet50", 224, 64, 100)
    assert (args.lr, args.momentum, args.weight_decay, args.epochs, args.resume) == (
        0.1, 0.9, 5e-4, 2, "run")
    assert not (args.train_fc or args.pretrained or args.evaluate) and args.accumulate == 1


def test_expanded_tree_writer_gives_the_readers_dataset(smoke, tmp_path):
    from distdiff_tpu_torch.data import DatasetByClassNames

    names = ["class 000", "class 001", "class 002"]
    assert smoke.write_expanded_tree(str(tmp_path), names, stems=2, side=12) == 6
    ds = DatasetByClassNames(str(tmp_path), names)
    assert ds.labels == [0, 0, 1, 1, 2, 2]
    assert all(p.endswith(f"image_{i:04d}_expand_0.png")
               for p, i in zip(ds.image_paths, [0, 1] * 3))
    assert ds[0][0].shape == (12, 12, 3)
    # one _expand_0 image an original: all kept at --expand_num 1, none at 0
    assert len(DatasetByClassNames(str(tmp_path), names, expand_num=1)) == 6
    assert len(DatasetByClassNames(str(tmp_path), names, expand_num=0)) == 0


def test_timed_loader_yields_every_batch_and_adds_up_the_waits(smoke):
    import time

    def slow():
        for i in range(3):
            time.sleep(0.01)
            yield i
    timed = smoke.TimedLoader(type("L", (), {"__iter__": lambda self: slow(),
                                             "__len__": lambda self: 3})())
    assert list(timed) == [0, 1, 2] and len(timed) == 3
    assert timed.wait_s >= 0.03


def test_epoch_learning_rates_follow_each_calls_cosine(smoke):
    assert smoke.epoch_lrs(2, 3) == pytest.approx([0.1, 0.05, 0.025])
    assert smoke.epoch_lrs(1) == [0.1]


def test_run_checker_takes_a_cpu_run_and_refuses_faults(smoke, tmp_path, monkeypatch):
    """``check_run`` on a run of the port's CLI on the CPU (tiny_resnet, a
    toy tree), then on the same run with a row missing, with
    ``model_best.pth.tar``'s presence flipped and with its results edited."""
    import numpy as np

    from distdiff_tpu_torch.cli import train
    from distdiff_tpu_torch.parallel import save_png

    rng = np.random.default_rng(0)
    for split, n in (("train", 3), ("test", 2)):
        for c in ("a", "b"):
            for i in range(n):
                save_png(str(tmp_path / "data" / "medmnist" / "breastmnist" / split / c
                             / f"{i}.png"), rng.random((20, 24, 3)))
    monkeypatch.setenv("DISTDIFF_PLATFORM", "cpu")
    run = str(tmp_path / "run")
    argv = ["-d", "breastmnist", "--data_root", str(tmp_path / "data"), "-a", "tiny_resnet",
            "--input_size", "16", "--train-batch", "4", "--test-batch", "4",
            "--manualSeed", "1", "--checkpoint", run]
    train.main(argv + ["--epochs", "1"])
    train.main(argv + ["--epochs", "2", "--resume", run])
    results = smoke.check_run(run, smoke.epoch_lrs(1, 2))
    assert set(results) == {"best_accuracy", "last_accuracy"}
    with pytest.raises(SystemExit, match="rows"):
        smoke.check_run(run, smoke.epoch_lrs(3))
    with pytest.raises(SystemExit, match="lr"):
        smoke.check_run(run, [0.1, 0.075])
    # model_best.pth.tar is there exactly when an epoch beat 0%: flipping its
    # presence against the run's best accuracy is refused
    best = tmp_path / "run" / "model_best.pth.tar"
    assert best.exists() == (results["best_accuracy"] > 0)
    if best.exists():
        best.unlink()
    else:
        best.write_bytes((tmp_path / "run" / "checkpoint.pth.tar").read_bytes())
    with pytest.raises(SystemExit, match="model_best"):
        smoke.check_run(run, smoke.epoch_lrs(1, 2))
    with open(tmp_path / "run" / "results.yaml", "w") as f:
        f.write("best_accuracy: 1000.0\nlast_accuracy: -1.0\n")
    with pytest.raises(SystemExit, match="results"):
        smoke.check_run(run, smoke.epoch_lrs(1, 2))


def _tiny_batches(n_cls=5, b=4, side=16):
    import numpy as np

    rng = np.random.default_rng(0)
    batches = []
    for i in range(3):
        x = rng.standard_normal((b, side, side, 3)).astype(np.float32)
        y = rng.integers(0, n_cls, b).astype(np.int32)
        m = np.ones(b, bool)
        if i == 2:  # a tail of 3, padded as the loader pads
            x[3:], y[3:], m[3:] = x[2], y[2], False
        batches.append((x, y, m))
    return batches


def _card_on_the_cpu(monkeypatch):
    """``train_agreement``'s card side built on the CPU instead."""
    import distdiff_tpu_torch.models.guide as guide

    real = guide.create_model
    monkeypatch.setattr(guide, "create_model",
                        lambda *a, device, **kw: real(*a, device="cpu", **kw))
    return real("tiny_resnet", 5, device="cpu", trainable=True).module.state_dict()


@pytest.mark.parametrize("cfg", [{}, {"accumulate": 2}, {"train_fc_only": True}])
def test_train_agreement_reads_zero_for_the_cpu_against_itself(smoke, cfg, monkeypatch):
    from distdiff_tpu_torch.train import TrainConfig

    start = _card_on_the_cpu(monkeypatch)
    read = smoke.train_agreement("cpu", TrainConfig(epochs=2, **cfg), _tiny_batches(), start)
    assert read == {"loss": 0.0, "stats": 0.0, "update": 0.0, "acc_flips": 0,
                    "stats_moved": 3 * _running_statistics(start)}


def _running_statistics(state):
    return sum(k.endswith(("running_mean", "running_var")) for k in state)


@pytest.mark.parametrize("transform_type", ["mixup", "cutmix", "augmix"])
def test_train_agreement_takes_the_transform_stages(smoke, transform_type, monkeypatch):
    """``cli.train_transform``'s ``batch_stage`` through ``train_agreement``:
    each batch prepared once (augmix's three views packed into 12 rows),
    the stage's loss on both sides; the CPU against itself reads zero."""
    import numpy as np

    from distdiff_tpu_torch.cli.train_transform import batch_stage
    from distdiff_tpu_torch.train import TrainConfig

    start = _card_on_the_cpu(monkeypatch)
    batches = _tiny_batches()
    if transform_type == "augmix":
        batches = [(np.stack([x, -x, x[:, ::-1]], 1), y, m) for x, y, m in batches]
    loss_fn, on_batch, _ = batch_stage(transform_type, np.random.default_rng(0))
    seen = []

    def spy(images, targets, mask):
        seen.append(len(images))
        return on_batch(images, targets, mask)
    read = smoke.train_agreement("cpu", TrainConfig(epochs=2), batches, start,
                                 stage=(loss_fn, spy))
    assert seen == [4] * 3
    assert read == {"loss": 0.0, "stats": 0.0, "update": 0.0, "acc_flips": 0,
                    "stats_moved": 3 * _running_statistics(start)}


def test_transform_argument_lists_are_the_jax_defaults_at_resnet50_width(smoke):
    """Phase 7's ``cli.train_transform`` runs: the JAX parser's reading of
    each argument list, ResNet-50 at 224^2 and batch 64, cut to one epoch."""
    from distdiff_tpu.cli import train_transform as j_cli
    from distdiff_tpu_torch.cli import train_transform as cli

    for t in cli.TRANSFORM_TYPES:
        argv = smoke.train_argv("data", "run", 1, ["--transform_type", t, "--expand_num", "0"])
        args = cli.parse_args(argv)
        assert vars(args) == vars(j_cli.parse_args(argv))
        assert (args.arch, args.input_size, args.train_batch, args.epochs, args.lr) == (
            "resnet50", 224, 64, 1, 0.1)


def test_train_agreement_reads_an_optimizer_fault_on_the_step(smoke, monkeypatch):
    """The second side's learning rate 5% off: each parameter's step is 5%
    off, over ``TRAIN_UPDATE_TOL``; the forward's readings stay 0."""
    import dataclasses

    import distdiff_tpu_torch.train as train_pkg
    from distdiff_tpu_torch.train import TrainConfig

    start = _card_on_the_cpu(monkeypatch)
    made = []

    def faulty(module, cfg, steps_per_epoch):
        made.append(cfg)
        if len(made) == 2:
            cfg = dataclasses.replace(cfg, lr=cfg.lr * 1.05)
        return real(module, cfg, steps_per_epoch)
    real = train_pkg.make_optimizer
    monkeypatch.setattr(train_pkg, "make_optimizer", faulty)
    read = smoke.train_agreement("fault", TrainConfig(epochs=2), _tiny_batches(), start)
    assert len(made) == 2
    assert read["update"] > smoke.TRAIN_UPDATE_TOL
    assert read["update"] == pytest.approx(0.05, rel=0.2)
    assert read["loss"] <= smoke.TRAIN_LOSS_TOL and read["stats"] <= smoke.TRAIN_STATS_TOL


# ------------------------------------------------------------- phase 8

def _pipe(config, **guidance):
    return types.SimpleNamespace(config=config, guidance_cfg=GuidanceConfig(**guidance),
                                 sched=make_schedule(config.num_inference_steps), strength=0.5)


def test_sd21_flash_launch_plan_by_shape(smoke):
    plan = smoke.flash_plan(_pipe(PipelineConfig.sd21()), 2)
    # 25 plain + 2 rollout + 2 recomputed UNet calls on the CFG pair of 2,
    # 5 self-attentions at each of the 96^2, 48^2 and 24^2 levels (5, 10
    # and 20 heads of 64; the mid block's 12^2 takes no kernel), one
    # backward each in the rollout; 5 VAE mid-block attentions over 9216
    # tokens at D = 512, 2 backwards by the split pair
    unet = {(20, 9216, 9216, 64), (40, 2304, 2304, 64), (80, 576, 576, 64)}
    vae = (2, 9216, 9216, 512)
    want = {("flash_fwd", s): 145 for s in unet}
    want.update({("flash_bwd_fused", s): 10 for s in unet})
    want.update({("flash_fwd", vae): 5, ("flash_bwd_dq", vae): 2, ("flash_bwd_dkv", vae): 2})
    assert dict(plan) == want
    assert smoke.expected_launches(_pipe(PipelineConfig.sd21())) == {
        "flash_fwd": 440, "flash_bwd_fused": 30, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}


def test_sd21_groupnorm_shapes_at_768(smoke):
    cfg = PipelineConfig.sd21()
    unet = smoke.unet_norms(cfg.unet, 96)
    assert len(unet) == 61 and unet[0] == (320, 96, "silu") and (2560, 12, "silu") in unet
    assert smoke.vae_decode_norms(cfg.vae, 96)[-1] == (128, 768, "silu")
    assert smoke.vae_encode_norms(cfg.vae, 768)[-1] == (512, 96, "silu")
    shapes = smoke.gn_shapes(smoke.sd21_gn_calls())
    assert len(shapes) == 26
    assert shapes[(4, 320, 96, 96)] == (32, {"silu", None})
    assert shapes[(2, 128, 768, 768)] == (32, {"silu"})
    assert shapes[(8, 128, 768, 768)] == (32, {"silu"})  # the CLI's encode
    plan = smoke.gn_plan(smoke.expand_gn_calls(_pipe(cfg), 2))
    assert {k: sum(n for (name, _), n in plan.items() if name == k)
            for k in smoke.GN_KERNELS} == {"gn_fused": 1653, "gn_stats": 266, "gn_apply": 266}
    # the 96^2 x 960 norm of every UNet call takes the pair
    assert plan[("gn_stats", (4, 960, 96, 96))] == 29


def test_deep_cache_and_mode_plans(smoke):
    import dataclasses

    dc = _pipe(dataclasses.replace(PipelineConfig.sd15(), deep_cache=True, cache_interval=3))
    # [25, 30): full at 25, 28; [30, 50): every third from 30
    assert smoke.span_unet_calls(dc, 25, 30) == (2, 3)
    assert smoke.span_unet_calls(dc, 30, 50) == (7, 13)
    # 9 full calls x 10 long self-attentions, 16 shallow x the 5 at 64^2,
    # the rollout's 4 x 10, 5 VAE
    assert smoke.expected_launches(dc)["flash_fwd"] == 90 + 80 + 40 + 5
    fwd = {mode: smoke.flash_plan(_pipe(PipelineConfig.sd15(), rollout_remat=mode), 2,
                                  parts=("rollout",))[("flash_fwd", (32, 4096, 4096, 40))]
           for mode in smoke.ROLLOUT_CALLS}
    # 5 attentions at 64^2 a UNet call; the inner checkpoints add a call a step
    assert fwd == {"step_nr": 20, "step": 30, "step_nru": 20, "decode_nr": 30, "block": 20,
                   "decode": 20, "tail": 25, "tail_decode_nr": 25}


def test_phase2_holds_every_shape_phase8_launches(smoke):
    import dataclasses

    timed = {(name, (b * h, tq, tk, d)) for _, b, h, tq, tk, d, names, t in smoke.flash_shapes()
             if t is True for name in names}
    sd21, sd15 = PipelineConfig.sd21(), PipelineConfig.sd15()
    plans = [smoke.flash_plan(_pipe(sd21), 2),
             {("flash_fwd", (smoke.CLI_ENCODE_BATCH, 9216, 9216, 512)): 13},
             smoke.flash_plan(_pipe(dataclasses.replace(sd15, scheduler="dpmpp")), 2),
             smoke.flash_plan(_pipe(dataclasses.replace(sd15, deep_cache=True)), 2)]
    plans += [smoke.flash_plan(_pipe(sd15, rollout_remat=m), 2, parts=("rollout",))
              for m in smoke.ROLLOUT_CALLS]
    for plan in plans:
        assert set(plan) <= timed, set(plan) - timed
    held = set(smoke.gn_shapes(smoke.main_gn_calls() + smoke.sd21_gn_calls()))
    launched = smoke.gn_plan(smoke.expand_gn_calls(_pipe(sd21), 2)
                             + [smoke.sd21_encode_gn_call(sd21)]
                             + smoke.expand_gn_calls(_pipe(sd15), 2))
    assert {shape for _, shape in launched} <= held


@pytest.fixture(scope="module")
def tiny_pipe():
    import numpy as np

    from distdiff_tpu_torch.models.guide import create_model
    from distdiff_tpu_torch.sampling import ExpansionPipeline, SamplerConfig

    rng = np.random.RandomState(0)
    guide = create_model("tiny_resnet", num_classes=3, device="cpu")
    fd = guide.feature_dim
    return ExpansionPipeline.create(
        PipelineConfig.tiny(sample_size=32), sampler_cfg=SamplerConfig(guidance_scale=3.0),
        guidance_cfg=GuidanceConfig(guidance_step=4, guidance_period=2, K=2,
                                    guide_input_size=32, rho=0.5),
        guide=guide, global_protos=rng.randn(3, fd).astype(np.float32),
        local_protos=rng.randn(3, 2, fd).astype(np.float32), device="cpu")


def _count_forwards(modules):
    counts = [0] * len(modules)
    handles = []
    for i, group in enumerate(modules):
        for m in group:
            def pre(module, args, i=i):
                counts[i] += 1
            handles.append(m.register_forward_pre_hook(pre))
    return counts, handles


@pytest.mark.parametrize("mode", ["step_nr", "step", "step_nru", "decode_nr", "block",
                                  "decode", "tail", "tail_decode_nr"])
def test_rollout_calls_are_the_ports_recompute(smoke, tiny_pipe, mode):
    """ROLLOUT_CALLS, from which phase 8 plans each mode's launches, against
    the attention forwards the port runs in one rollout, counted with hooks."""
    import dataclasses

    from distdiff_tpu_torch.guidance import transform_guidance
    from distdiff_tpu_torch.models.layers import Transformer2DModel
    from distdiff_tpu_torch.models.vae import VAEAttention

    pipe = tiny_pipe
    pipe.guidance_cfg = dataclasses.replace(pipe.guidance_cfg, rollout_remat=mode)
    unet_attn = [m for m in pipe.unet.modules() if isinstance(m, Transformer2DModel)]
    vae_attn = [m for m in pipe.vae.decoder.modules() if isinstance(m, VAEAttention)]
    counts, handles = _count_forwards([unet_attn, vae_attn])
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, 16, 4, generator=gen) * 0.2
    try:
        transform_guidance(pipe.guidance_context(), x, torch.randn(2, 8, 32, generator=gen),
                           torch.randn(2, 8, 32, generator=gen), torch.tensor([0, 1]), 6,
                           torch.rand(2, 1, 1, 4, generator=gen),
                           torch.randn(2, 1, 1, 4, generator=gen))
    finally:
        for h in handles:
            h.remove()
    unet_calls, vae_fwd = smoke.rollout_calls(mode, 2)
    assert counts == [unet_calls * len(unet_attn), vae_fwd * len(vae_attn)]


def test_deep_cache_span_plan_is_the_ports_loop(smoke, tiny_pipe):
    import dataclasses

    pipe = dataclasses.replace(tiny_pipe, config=dataclasses.replace(
        tiny_pipe.config, deep_cache=True, cache_interval=3))
    counts, handles = _count_forwards([[pipe.unet.mid_block.attentions[0]],
                                       [pipe.unet.conv_in]])
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16, 16, 4, generator=gen)
    cond, uncond = torch.randn(2, 8, 32, generator=gen), torch.randn(2, 8, 32, generator=gen)
    try:
        with torch.no_grad():
            pipe.denoise_ranged()(x, cond, uncond, 3, 10)
    finally:
        for h in handles:
            h.remove()
    full, shallow = smoke.span_unet_calls(pipe, 3, 10)
    assert (full, shallow) == (3, 4)
    # the mid block runs in full calls only; conv_in in every call
    assert counts == [full, full + shallow]


# ------------------------------------------------------------- phase 9

def test_sdxl_flash_launch_plan_by_shape(smoke):
    cfg = PipelineConfig.sdxl_base()
    plan = smoke.flash_plan(_pipe(cfg), 2)
    # 25 plain + 2 rollout + 2 recomputed UNet calls on the CFG pair of 2;
    # each call: 10 self-attentions at 64^2 (two transformer blocks in each
    # of 2 down and 3 up attentions, 10 heads of 64), 60 at 32^2 (ten
    # blocks in each of 5 attentions and the mid block's, 20 heads); none at
    # 128^2. One backward each in the rollout. 5 VAE mid-block attentions
    # over 16384 tokens at D = 512, 2 backwards by the split pair
    at64, at32, vae = (40, 4096, 4096, 64), (80, 1024, 1024, 64), (2, 16384, 16384, 512)
    assert dict(plan) == {
        ("flash_fwd", at64): 290, ("flash_bwd_fused", at64): 20,
        ("flash_fwd", at32): 1740, ("flash_bwd_fused", at32): 120,
        ("flash_fwd", vae): 5, ("flash_bwd_dq", vae): 2, ("flash_bwd_dkv", vae): 2}
    assert smoke.unet_attentions(cfg.unet, 128) == [(10, 4096, 64, 10), (20, 1024, 64, 50),
                                                    (20, 1024, 64, 10)]
    # text-to-image: 50 UNet calls, one decode, no backward
    assert dict(smoke.t2i_flash_plan(cfg, 2, 50)) == {
        ("flash_fwd", at64): 500, ("flash_fwd", at32): 3000, ("flash_fwd", vae): 1}


def test_sdxl_groupnorm_plan_at_1024(smoke):
    cfg = PipelineConfig.sdxl_base()
    unet = smoke.unet_norms(cfg.unet, 128)
    # 2 + 2 + 3 + 3 resnets at three levels with 2 norms, 4 mid-block norms,
    # conv_norm_out; 10 transformers' norms (none at 128^2)
    assert len(unet) == 46 and sum(act is None for _, _, act in unet) == 11
    assert unet[0] == (320, 128, "silu") and (2560, 32, "silu") in unet
    assert smoke.vae_decode_norms(cfg.vae, 128)[-1] == (128, 1024, "silu")
    assert (256, 1024, "silu") in smoke.vae_decode_norms(cfg.vae, 128)
    shapes = smoke.gn_shapes(smoke.sdxl_gn_calls())
    assert len(shapes) == 24
    assert shapes[(2, 256, 1024, 1024)] == (32, {"silu"})  # 537M elements
    assert shapes[(8, 128, 1024, 1024)] == (32, {"silu"})  # the CLI's encode, 1.07e9
    assert all(math.prod(s) < 2 ** 31 for s in shapes)
    plan = smoke.gn_plan(smoke.expand_gn_calls(_pipe(cfg), 2))
    assert {k: sum(n for (name, _), n in plan.items() if name == k)
            for k in smoke.GN_KERNELS} == {"gn_fused": 928, "gn_stats": 556, "gn_apply": 556}
    # text-to-image: each of 50 UNet calls' and one decode's norms is one
    # gn_fused launch or one gn_stats + gn_apply pair
    t2i = smoke.gn_plan(smoke.t2i_gn_calls(cfg, 2, 50))
    totals = {k: sum(n for (name, _), n in t2i.items() if name == k) for k in smoke.GN_KERNELS}
    assert totals["gn_fused"] + totals["gn_stats"] == 50 * 46 + 30
    assert totals["gn_stats"] == totals["gn_apply"]


def test_phase2_holds_every_shape_phase9_launches(smoke):
    timed = {(name, (b * h, tq, tk, d)) for _, b, h, tq, tk, d, names, t in smoke.flash_shapes()
             if t is True for name in names}
    cfg = PipelineConfig.sdxl_base()
    plans = [smoke.flash_plan(_pipe(cfg), 2), smoke.t2i_flash_plan(cfg, 2, 50),
             {("flash_fwd", (smoke.CLI_ENCODE_BATCH, 16384, 16384, 512)): 13}]
    for plan in plans:
        assert set(plan) <= timed, set(plan) - timed
    held = set(smoke.gn_shapes(smoke.main_gn_calls() + smoke.sd21_gn_calls()
                               + smoke.sdxl_gn_calls()))
    launched = smoke.gn_plan(smoke.expand_gn_calls(_pipe(cfg), 2)
                             + smoke.t2i_gn_calls(cfg, 2, 50)
                             + [smoke.sdxl_encode_gn_call(cfg)])
    assert {shape for _, shape in launched} <= held


def test_sdxl_planners_follow_the_ports_unet(smoke):
    """unet_norms and unet_attentions, from which phase 9 plans its
    launches, against the norms and self-attentions one UNet call of the
    port runs at an SDXL topology (sdxl_tiny at 64^2 latents: three levels,
    no attention at the first, per-level depths and heads), by hooks."""
    from distdiff_tpu_torch.models import UNet2DConditionModel
    from distdiff_tpu_torch.models.layers import GroupNorm

    cfg = PipelineConfig.sdxl_tiny().unet
    unet = UNet2DConditionModel(cfg, device="cpu")
    seen, attn = [], []
    norms = [m for m in unet.modules() if isinstance(m, GroupNorm)]
    selfs = [m.attn1 for m in unet.modules() if hasattr(m, "attn1")]
    handles = [m.register_forward_pre_hook(
        lambda mod, args: seen.append((args[0].shape[1], args[0].shape[-1], mod.act)))
        for m in norms]
    handles += [m.register_forward_pre_hook(
        lambda mod, args: attn.append((mod.heads, args[0].shape[1]))) for m in selfs]
    gen = torch.Generator().manual_seed(0)
    try:
        with torch.no_grad():
            unet(torch.randn(1, 64, 64, 4, generator=gen), 10,
                 torch.randn(1, 8, cfg.cross_attention_dim, generator=gen),
                 torch.randn(1, cfg.addition_embed_dim, generator=gen))
    finally:
        for h in handles:
            h.remove()
    assert seen == smoke.unet_norms(cfg, 64)
    want = [(h, t) for h, t, _, k in smoke.unet_attentions(cfg, 64) for _ in range(k)]
    assert sorted(attn) == sorted(want)


# ------------------------------------------------------------- phase 10

def test_lora_step_plan_at_sd15_and_phase2_holds_it(smoke):
    cfg = PipelineConfig.sd15()
    plan = smoke.lora_flash_plan(cfg.unet, cfg.latent_size, smoke.LORA_BATCH)
    # batch 8 without CFG: 8 x 8 heads; 5 self-attentions at 64^2 (D = 40)
    # and 5 at 32^2 (D = 80), each forward again in the backward's
    # recompute, one fused backward each; 16^2 and the 8^2 mid block take
    # no kernel
    at64, at32 = (64, 4096, 4096, 40), (64, 1024, 1024, 80)
    assert dict(plan) == {("flash_fwd", at64): 10, ("flash_bwd_fused", at64): 5,
                          ("flash_fwd", at32): 10, ("flash_bwd_fused", at32): 5}
    timed = {(name, (b * h, tq, tk, d)) for _, b, h, tq, tk, d, names, t in smoke.flash_shapes()
             if t is True for name in names}
    assert set(plan) <= timed
    calls = smoke.lora_gn_calls(cfg.unet, cfg.latent_size, smoke.LORA_BATCH)
    norms = smoke.unet_norms(cfg.unet, 64)
    # down_blocks.0.resnets.0's two norms come before the first adapted
    # layer: the backward does not recompute them
    assert calls == [(1, 8, norms[:2] + norms[-1:]), (2, 8, norms[2:-1])] and len(norms) == 61
    launched = smoke.gn_plan(calls)
    held = set(smoke.gn_shapes(smoke.main_gn_calls() + smoke.sd21_gn_calls()
                               + smoke.sdxl_gn_calls() + smoke.lora_main_gn_calls()))
    assert {shape for _, shape in launched} <= held
    totals = {k: sum(n for (name, _), n in launched.items() if name == k) for k in smoke.GN_KERNELS}
    assert totals["gn_fused"] + totals["gn_stats"] == 3 + 2 * 58
    assert totals["gn_stats"] == totals["gn_apply"] > 0


def test_lora_step_plans_follow_the_ports_step(smoke):
    """lora_flash_plan and lora_gn_calls, from which phase 10 plans its
    launches, against the self-attention and GroupNorm forwards of one
    LoRA step of the port (the tiny UNet, 24^2 latents, with its inner
    checkpoints and without them), by hooks."""
    import dataclasses

    from distdiff_tpu_torch.models import UNet2DConditionModel
    from distdiff_tpu_torch.models.layers import GroupNorm
    from distdiff_tpu_torch.train import lora as tl

    for remat in (True, False):
        cfg = dataclasses.replace(PipelineConfig.tiny().unet, remat=remat)
        unet = UNet2DConditionModel(cfg, device="cpu").requires_grad_(False)
        gen = torch.Generator().manual_seed(0)
        lora = tl.init_lora(gen, unet, rank=2)
        seen, attn = [], []
        handles = [m.register_forward_pre_hook(
            lambda mod, args: seen.append((args[0].shape[1], args[0].shape[-1], mod.act)))
            for m in unet.modules() if isinstance(m, GroupNorm)]
        handles += [m.attn1.register_forward_pre_hook(
            lambda mod, args: attn.append((mod.heads, args[0].shape[1])))
            for m in unet.modules() if hasattr(m, "attn1")]
        t, noise = tl.draw_t_noise(gen, 2, (24, 24, 4), 1000)
        try:
            tl.lora_value_and_grad(unet, make_schedule(10), lora, torch.randn(2, 24, 24, 4),
                                   torch.randn(2, 6, cfg.cross_attention_dim), t, noise, 2.0)
        finally:
            for h in handles:
                h.remove()
        want = collections.Counter()
        for times, _, norms in smoke.lora_gn_calls(cfg, 24, 2):
            for norm in norms:
                want[norm] += times
        assert collections.Counter(seen) == want, remat
        plan = smoke.lora_flash_plan(cfg, 24, 2)
        long = collections.Counter((h, tok) for h, tok in attn if tok > 256)
        assert {(bh // 2, tq): c for (name, (bh, tq, _, _)), c in plan.items()
                if name == "flash_fwd"} == dict(long) and long, remat


# ------------------------------------------------------- phase 11: the guide zoo

def test_phase2_holds_every_shape_phase11_launches(smoke):
    """Phase 11's counted runs: the phase-4 recipe (each guide adds no
    kernel launch of its own) and the default-``-a`` CLI run, whose plan is
    one SplitExpand call at batch 2 after 13 dataset encodes of 8 images."""
    timed = {(name, (b * h, tq, tk, d)) for _, b, h, tq, tk, d, names, t in smoke.flash_shapes()
             if t is True for name in names}
    pipe = _pipe(PipelineConfig.sd15())
    want, gn_calls = smoke.zoo_cli_plans(pipe)
    recipe = smoke.flash_plan(pipe, 2)
    assert want - recipe == collections.Counter(
        {("flash_fwd", (smoke.CLI_ENCODE_BATCH, 4096, 4096, 512)): 13})
    assert smoke.CLI_CLASSES * smoke.ZOO_CLI_TRAIN == 100 and smoke.ZOO_CLI_UNITS == 2
    for plan in (recipe, want):
        assert set(plan) <= timed, set(plan) - timed
    held = set(smoke.gn_shapes(smoke.main_gn_calls()))
    launched = smoke.gn_plan(smoke.expand_gn_calls(pipe, 2) + gn_calls)
    assert {shape for _, shape in launched} <= held
    assert gn_calls[-1][:2] == (13, smoke.CLI_ENCODE_BATCH)


@pytest.mark.parametrize("arch", ["resnext50", "mobilenetv2"])
def test_zoo_guides_are_seeded_alike_on_every_build(smoke, arch):
    a, b = smoke.zoo_guide(arch, "cpu", 3), smoke.zoo_guide(arch, "cpu", 3)
    sa, sb = a.module.state_dict(), b.module.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not a.module.training and not any(p.requires_grad for p in a.module.parameters())
    var = [v for k, v in sa.items() if k.endswith("running_var")]
    assert var and min(float(v.min()) for v in var) >= 0.5  # the seeded statistics
    c = smoke.zoo_guide(arch, "cpu", 4).module.state_dict()
    assert not all(torch.equal(sa[k], c[k]) for k in sa)


def test_openclip_writer_loads_as_the_default_guide(smoke, tmp_path):
    """``write_openclip_checkpoint`` (at a shrunk layout here) through the
    guide loader: the image tower equal to the converted written tensors,
    the text tower's weights beside it, laion's activation, the logit
    scale 100; ``loaded_matches`` refuses another tower."""
    from distdiff_tpu_torch.models.guide.clip_vit import CLIPViT, tiny_clip_vit_config
    from distdiff_tpu_torch.models.guide.factory import GuideModel, load_weights
    from distdiff_tpu_torch.weights.openclip import (
        convert_openclip,
        openclip_vit_b32_state_shapes,
    )

    shapes = openclip_vit_b32_state_shapes(image_size=32, patch=8, vw=32, vlayers=2, tw=32,
                                           tlayers=2, embed=16, vocab=600, ctx_len=32)
    path = str(tmp_path / "clip.safetensors")
    written = smoke.write_openclip_checkpoint(path, shapes=shapes)
    assert {k: tuple(v.shape) for k, v in written.items()} == shapes
    assert all(v.dtype == torch.float32 for v in written.values())
    assert float(written["ln_final.weight"].mean()) == pytest.approx(1, abs=0.1)
    gm = GuideModel(arch="open_clip_vit_b32", module=CLIPViT(tiny_clip_vit_config()),
                    feature_dim=16, num_classes=3)
    load_weights(gm, path)
    visual = convert_openclip({k: v for k, v in written.items() if k.startswith("visual.")})[0]
    smoke.loaded_matches(gm.module, visual, sorted(visual), "image tower")
    assert gm.text_activation == "gelu" and gm.logit_scale == pytest.approx(100.0, rel=1e-6)
    assert set(gm.text_state) == set(convert_openclip(written)[1])
    with pytest.raises(SystemExit, match="differs"):
        smoke.loaded_matches(CLIPViT(tiny_clip_vit_config()), visual, ["proj"], "image tower")



# ------------------------------------------------------------- phase 12

def _narrow_sd15_unet():
    """SD-1.5's UNet topology (four levels, attention at the first three,
    two resnets a level, one transformer a stage) at narrow widths."""
    import dataclasses

    from distdiff_tpu_torch.config import UNetConfig

    return dataclasses.replace(UNetConfig.sd15(), block_out_channels=(16, 32, 32, 32),
                               num_attention_heads=2, cross_attention_dim=24,
                               dtype=torch.float32, remat=False)


@pytest.mark.parametrize("topology", ["sd15", "sdxl_tiny", "tiny"])
@pytest.mark.parametrize("branch", [None, 0])
def test_int8_layer_plan_follows_the_ports_unet(smoke, monkeypatch, topology, branch):
    """unet_int8_layers, from which phase 12 plans the int8 products and
    takes the shapes it holds and times, against the int8 products one UNet
    call of the port runs (a full call, or a DeepCache shallow one at branch
    0), in order, at SD-1.5's topology (narrow widths, 16^2 latents),
    sdxl_tiny's and tiny()'s."""
    from distdiff_tpu_torch.models import UNet2DConditionModel
    from distdiff_tpu_torch.ops import quant

    cfg = {"sd15": _narrow_sd15_unet(), "sdxl_tiny": PipelineConfig.sdxl_tiny().unet,
           "tiny": PipelineConfig.tiny().unet}[topology]
    side, batch = 16, 3
    unet = UNet2DConditionModel(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    args = [torch.randn(batch, side, side, 4, generator=gen), 10,
            torch.randn(batch, 5, cfg.cross_attention_dim, generator=gen)]
    if cfg.addition_embed_dim:
        args.append(torch.randn(batch, cfg.addition_embed_dim, generator=gen))
    seen = []
    real = quant.int_mm
    monkeypatch.setattr(quant, "int_mm", lambda a, w: seen.append(
        (a.shape[0], a.shape[1], w.shape[0])) or real(a, w))
    with torch.no_grad(), quant.int8_inference():
        if branch is None:
            unet(*args)
        else:
            _, cache = unet(*args, return_cache=True, cache_branch=branch)
            seen.clear()
            unet(*args, deep_cache=cache, cache_branch=branch)
    want = [smoke.int8_mkn(layer) for layer in smoke.unet_int8_layers(cfg, side, batch, branch)]
    assert seen == want and len(seen) > 0


def test_int8_plan_of_the_sd15_recipe(smoke):
    """One SD-1.5 batch-2 call: 82 int8 layers a UNet call (44 resnet
    convolutions, 6 resamplers, 32 feed-forward projections), 25 plain
    steps on the CFG pair; under DeepCache (interval 3, branch 0) 9 full
    calls and 16 shallow ones of 20 layers (the first level's 8, the last up
    group's 12)."""
    import dataclasses

    cfg = dataclasses.replace(PipelineConfig.sd15(), int8=True)
    layers = smoke.unet_int8_layers(cfg.unet, 64, 4)
    kinds = collections.Counter((lay[0], lay[-1] if lay[0] == "conv" else 0) for lay in layers)
    assert len(layers) == 82 and kinds == {("conv", 1): 47, ("conv", 2): 3, ("dot", 0): 32}
    assert smoke.int8_mkn(layers[0]) == (16384, 2880, 320)
    pipe = types.SimpleNamespace(config=cfg, guidance_cfg=GuidanceConfig(),
                                 sched=make_schedule(50), strength=0.5)
    plan = smoke.int8_plan(pipe, 2)
    # the 64^2 resnets' 320-wide convolutions: 4 in the down level, 3 conv2 in the up
    assert sum(plan.values()) == 25 * 82 and plan[(16384, 2880, 320)] == 25 * 7
    cached = types.SimpleNamespace(**dict(vars(pipe), config=dataclasses.replace(
        cfg, **smoke.INT8_DEEP_CACHE)))
    full, shallow = (a + b for a, b in zip(smoke.span_unet_calls(cached, 25, 30),
                                           smoke.span_unet_calls(cached, 30, 50)))
    assert (full, shallow) == (9, 16)
    assert sum(smoke.int8_plan(cached, 2).values()) == 9 * 82 + 16 * 20
    # the bound of the 64^2 resnet convolution: its products at the int8 rate
    # (15.3 us; its 22.8 MB of bf16 input, weight and output take 6.8 us)
    ms, by = smoke.int8_bound(layers[0])
    assert by == "operations" and ms == pytest.approx(
        2 * 16384 * 2880 * 320 / smoke.PEAK_INT8_OPS * 1e3)
    assert 2 * (2 * 16384 * 320 + 9 * 320 * 320) / smoke.PEAK_BYTES * 1e3 < ms
    # a feed-forward projection at 8^2 is bound by its weight's bytes
    assert smoke.int8_bound(("dot", 256, 5120, 1280))[1] == "bytes"


def test_int8_pins_hold_a_perturbed_run_to_its_recording(smoke):
    """Int8Inputs, with which phase 12d holds the CPU's int8 expand to the
    card's: a tiny UNet whose conv_in moved by 1e-7 (as a card's sums
    move) lands as far from the recorded run as int8 is from exact when
    left alone, and within fp32 noise of it when each int8 layer is given
    the recorded input; the pins are taken in order, one a call."""
    from distdiff_tpu_torch.models import UNet2DConditionModel
    from distdiff_tpu_torch.ops import quant

    cfg = PipelineConfig.tiny().unet
    unet = UNet2DConditionModel(cfg, device="cpu")
    moved = UNet2DConditionModel(cfg, device="cpu")
    moved.load_state_dict(unet.state_dict())
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in moved.conv_in.parameters():
            p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen))
    args = (torch.randn(4, 16, 16, 4, generator=gen), 500, torch.randn(4, 5, 32, generator=gen))
    rec = smoke.Int8Inputs(unet)
    with torch.no_grad():
        with quant.int8_inference():
            want = unet(*args)
        rec.close()
        exact = unet(*args)
        with quant.int8_inference():
            loose = moved(*args)
            pin = smoke.Int8Inputs(moved, pinned=rec.calls)
            pinned = moved(*args)
            pin.close()
    assert len(rec.calls) == len(pin.calls) == 26
    gap = float((want - exact).abs().max())
    assert float((pinned - want).abs().max()) <= 1e-5 < gap / 100
    assert float((loose - want).abs().max()) > float((pinned - want).abs().max())


def test_pretraining_norms_are_phase_2s_shapes(smoke):
    """Phase 15: every GroupNorm call of one VAE step and one UNet step of
    the quality loop's pre-training (the inner checkpoints' recomputations
    included), counted by ``norm_calls`` on the CPU, is at a shape that
    ``pretrain_gn_calls`` gives phase 2 to hold (at the step's batch), with
    its groups; the checks of the card's run read zero for the CPU against
    itself."""
    from distdiff_tpu_torch.cli import quality_loop as ql
    from distdiff_tpu_torch.sampling import ExpansionPipeline

    cfg = PipelineConfig.tiny()
    pipe = ExpansionPipeline.create(cfg, device="cpu", seed=15)
    b = 2  # the card's steps take smoke.QL_CLASSES * smoke.QL_TRAIN images
    gen = torch.Generator().manual_seed(0)
    x = torch.rand((b, cfg.sample_size, cfg.sample_size, 3), generator=gen) * 2 - 1
    sf = cfg.vae.scaling_factor
    opt = ql.make_adam(pipe.vae)
    grads = smoke.first_grads(opt, pipe.vae)
    vae_calls = smoke.norm_calls(pipe.vae, lambda: ql.vae_train_step(pipe.vae, opt, x, sf))
    lat = torch.randn((b, cfg.latent_size, cfg.latent_size, 4), generator=gen)
    ctx = torch.randn((3, cfg.max_text_length, cfg.unet.cross_attention_dim), generator=gen)
    y = torch.arange(b) % 2
    t, noise, drop = ql.draw_unet_inputs(gen, lat.shape, 1000)
    uopt = ql.make_adam(pipe.unet)
    unet_calls = smoke.norm_calls(pipe.unet, lambda: ql.unet_train_step(
        pipe.unet, uopt, pipe.sched, lat, y, ctx, t, noise, drop))
    held = smoke.gn_shapes(smoke.pretrain_gn_calls(b))
    for calls in (vae_calls, unet_calls):
        assert calls and all(n > 0 for n in calls.values())
        for (shape, groups), _ in calls.items():
            assert shape in held and held[shape][0] == groups, shape
    # the inner checkpoints re-run the decoder's and the UNet's blocks
    assert sum(vae_calls.values()) > len(smoke.vae_encode_norms(cfg.vae, cfg.sample_size)) + len(
        smoke.vae_decode_norms(cfg.vae, cfg.latent_size))
    plan = smoke.norm_plan(vae_calls, 4, smoke.H100_SMEM_OPTIN)
    assert sum(plan.values()) >= sum(vae_calls.values())
    assert sorted(grads) == sorted(k for k, _ in pipe.vae.named_parameters())
    assert smoke.held_training("self", pipe.vae, pipe.vae, grads)["max_abs_err"] == 0.0
    assert smoke.held_losses("self", [1.0, 2.0], [1.0, 2.0]) == 0.0
