"""The reference against the program on the CPU, at tiny sizes: the
reference modules load the program's state dicts strictly, the whole run
(driver, PNGs, read-back, reference) comes out correct, and comes out not
correct with the timed path broken underneath or with the program's int8
path (the control) switched on."""

import contextlib
import copy
import json
import os

import numpy as np
import pytest
import torch

from portbench.harness import compare, faults, registry, weights
from portbench.harness.cell import run_cell
from portbench.harness.compare import gaps, read_png
from portbench.reference import models
from portbench.tests import tiny

LIMITS = {"rms_levels": 1.0}


def quiet(_line):
    pass


@pytest.mark.parametrize("config", ["sd15", "sdxl_base"])
def test_reference_loads_the_programs_state_dicts(config):
    from distdiff_tpu_torch.models.guide.factory import create_model
    from distdiff_tpu_torch.models.unet import UNet2DConditionModel
    from distdiff_tpu_torch.models.vae import AutoencoderKL

    from portbench.harness.port import pipeline_config

    cell = next(w for w in registry.load_benchmark()["workloads"] if w["config"] == config)
    cfg, tr = registry.find_cell(cell["name"]).config, registry.find_cell(cell["name"]).traffic
    pcfg = pipeline_config(cfg, tr)
    port = {"unet": UNet2DConditionModel(pcfg.unet, device="meta"),
            "vae": AutoencoderKL(pcfg.vae, device="meta"),
            "guide": create_model("resnet50", cfg["guide"]["num_classes"], device="meta").module}
    ref = models.build(cfg, "meta")
    for part in port:
        ps, rs = port[part].state_dict(), ref[part].state_dict()
        assert list(ps) == list(rs), part
        assert all(ps[k].shape == rs[k].shape for k in ps), part
        ref[part].load_state_dict(ps, strict=True, assign=True)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    ung = copy.deepcopy(tiny.TINY_TRAFFIC)
    ung["guidance"]["type"] = "none"
    return tiny.make_tree(str(tmp_path_factory.mktemp("tree")),
                          configs=(tiny.TINY_CONFIG, tiny.TINY_XL),
                          traffic={"g": tiny.TINY_TRAFFIC, "u": ung},
                          limits=LIMITS)


@pytest.mark.parametrize("cell", ["tiny_g", "tiny_u", "tiny_xl_g", "tiny_xl_u"])
def test_program_agrees_with_reference(tree, cell):
    r = run_cell(registry.find_cell(cell, root=tree), 2 ** 33 + 7, 0.5, False, "cpu", log=quiet)
    assert r["correct"], r
    # the window is whole batches, and the rate is over all of them
    assert r["attempted"] % tiny.TINY_TRAFFIC["batch"] == 0 and r["failed"] == 0
    assert r["metrics"]["images_per_s"]["value"] > 0
    assert list(r)[-1] == "checks" and r["checks"]["rms_levels"]["value"] < 0.2
    assert r["device"]["platform"] == "cpu"


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_broken_path_is_not_correct(tree, fault):
    planted = faults.state_unchanged() if fault == "state_unchanged" else contextlib.nullcontext()
    with planted:
        r = run_cell(registry.find_cell("tiny_g", root=tree), 11, 0.5, False, "cpu",
                     expand_hook=faults.HOOKS.get(fault), log=quiet)
    assert not r["correct"], r
    assert r["checks"]["rms_levels"]["value"] > LIMITS["rms_levels"]


def test_half_batch_is_seen_on_every_seed(tree):
    """Every slot of a batch is judged, so a fault in half of each batch
    cannot fall outside the sample."""
    cell = registry.find_cell("tiny_g", root=tree)
    for seed in (3, 4, 2 ** 31 + 9):
        r = run_cell(cell, seed, 0.5, False, "cpu", expand_hook=faults.half_batch, log=quiet)
        assert not r["correct"], r


def test_sample_covers_every_slot():
    for seed in (0, 1, 2 ** 32 + 5):
        plan = compare.slot_plan(17, 16, seed)
        assert [s for _, s in plan] == list(range(16))
        assert all(0 <= b < 17 for b, _ in plan)
        assert plan == compare.slot_plan(17, 16, seed)


def test_int8_control_is_not_correct(tree):
    """The unguided cells' control: the program with its int8 path on."""
    r = run_cell(registry.find_cell("tiny_u", root=tree), 5, 0.5, False, "cpu", int8=True,
                 log=quiet)
    assert not r["correct"], r


def test_guided_cells_judge_the_latents_at_g0(tree):
    """A guided run judges the latents the first denoise span hands the
    guidance step, beside the images; an unguided one the images alone."""
    g = run_cell(registry.find_cell("tiny_g", root=tree), 6, 0.5, False, "cpu", log=quiet)
    u = run_cell(registry.find_cell("tiny_u", root=tree), 6, 0.5, False, "cpu", log=quiet)
    assert g["readings"]["lat_rms_pct"] < 0.1 and g["readings"]["lat_over0.05_pct"] == 0
    assert not any(k.startswith("lat_") for k in u["readings"])


def test_latent_limit_fails_the_int8_control(tmp_path):
    """A guided cell held by a latent number alone: the program passes it,
    the program with its int8 path on does not."""
    root = tiny.make_tree(str(tmp_path), traffic={"g": tiny.TINY_TRAFFIC},
                          limits={"lat_rms_pct": 0.5})
    cell = registry.find_cell("tiny_g", root=root)
    assert run_cell(cell, 8, 0.5, False, "cpu", log=quiet)["correct"]
    r = run_cell(cell, 8, 0.5, False, "cpu", int8=True, log=quiet)
    assert not r["correct"] and r["checks"]["lat_rms_pct"]["value"] > 0.5, r


def test_fp8_control_is_not_correct(tree):
    """The guided cells' image control: the reference on fp8 operands in
    the program's place, judged as the program's outputs are."""
    from portbench import calibrate

    r = calibrate.fp8_control(registry.find_cell("tiny_g", root=tree), 5, None, quiet, "cpu")
    assert not r["correct"], r
    assert r["checks"]["rms_levels"]["value"] > LIMITS["rms_levels"]
    assert r["readings"]["lat_rms_pct"] > 0


def test_png_reader_undoes_every_filter(tmp_path):
    """The reader against an independent encoder of each row filter."""
    import struct
    import zlib

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)
    rows, prev = [], np.zeros(21, np.int32)
    for y, kind in enumerate([0, 1, 2, 3, 4]):
        cur = img[y].reshape(-1).astype(np.int32)
        out = np.zeros(21, np.int32)
        for x in range(21):
            a = cur[x - 3] if x >= 3 else 0
            b, c = prev[x], (prev[x - 3] if x >= 3 else 0)
            p = [0, a, b, (a + b) // 2,
                 a if abs(b - c) <= abs(a - c) and abs(b - c) <= abs(a + b - 2 * c)
                 else (b if abs(a - c) <= abs(a + b - 2 * c) else c)][kind]
            out[x] = (cur[x] - p) & 255
        rows.append(bytes([kind]) + out.astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    path = os.path.join(tmp_path, "x.png")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 7, 5, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))
    assert np.array_equal(read_png(path), img)
    assert gaps(img, img)["max_abs_levels"] == 0.0


def test_weights_and_inputs_follow_the_seed():
    cfg = tiny.TINY_CONFIG
    mods = models.build(cfg, "meta")
    a = weights.states(cfg, 2 ** 40 + 3, "cpu", mods)
    b = weights.states(cfg, 2 ** 40 + 3, "cpu", mods)
    c = weights.states(cfg, 2 ** 40 + 4, "cpu", mods)
    k = "down_blocks.0.resnets.0.conv1.weight"
    assert torch.equal(a["unet"][k], b["unet"][k]) and not torch.equal(a["unet"][k], c["unet"][k])
    ia = weights.make_inputs(cfg, tiny.TINY_TRAFFIC, 9, "cpu")
    ib = weights.make_inputs(cfg, tiny.TINY_TRAFFIC, 9, "cpu")
    assert np.array_equal(ia.latents, ib.latents) and torch.equal(ia.noise, ib.noise)
    assert json.dumps(ia.labels) == json.dumps(ib.labels)
