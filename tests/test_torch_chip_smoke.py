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
