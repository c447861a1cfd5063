"""Statistical quality ordering on the port: the calibrated quality-loop
recipes of ``tests/test_quality_ordering.py`` (cal11, cal14;
``docs/quality_loop_v5e_r4.md``), run through
``distdiff_tpu_torch.cli.quality_loop`` with the same margins, on the
device ``DISTDIFF_PLATFORM`` names (the card when it is unset, the CPU
under ``cpu``). A multi-seed statistical run, not an every-commit test.
Gate:

    DISTDIFF_RUN_QUALITY_ORDERING=1 python -m pytest \\
        tests/test_torch_quality_ordering.py -q -m slow

``docs/quality_loop_h100.md`` has the port's tables on an H100.
"""

import os

import pytest

GATED = pytest.mark.skipif(
    not os.environ.get("DISTDIFF_RUN_QUALITY_ORDERING"),
    reason="multi-seed statistical run; set DISTDIFF_RUN_QUALITY_ORDERING=1 to "
           "reproduce the docs/quality_loop_h100.md tables",
)
COMMON = ["--seeds", "1", "2", "3", "4", "5",
          "--epochs", "12", "--train_batch", "16", "--input_size", "16",
          "--n_classes", "4", "--toy_noise", "30", "--toy_jitter", "55",
          "--guidance_scale", "1.0", "--steps", "20",
          "--train_guide", "--train_vae", "--train_unet"]


def _run(tmp_path, monkeypatch, extra):
    from distdiff_tpu_torch.cli import quality_loop

    monkeypatch.chdir(tmp_path)  # save/ caches land in tmp
    table = quality_loop.main(["--workdir", str(tmp_path / "ql")] + COMMON + extra)
    for variant in ("original", "unguided", "guided"):
        assert table[variant]["n"] == 5, (variant, table)
    return table


@pytest.mark.slow
@GATED
def test_guided_beats_unguided_five_seeds(tmp_path, monkeypatch):
    """cal11: guided > unguided + 1.0 and guided > original - 1.5, the
    margins ``tests/test_quality_ordering.py`` holds the JAX package to."""
    table = _run(tmp_path, monkeypatch, [
        "--num_images_per_prompt", "4", "--n_train", "8", "--n_test", "40",
        "--strength", "0.5"])
    assert table["guided"]["mean"] > table["unguided"]["mean"] + 1.0, table
    assert table["guided"]["mean"] > table["original"]["mean"] - 1.5, table


@pytest.mark.slow
@GATED
def test_full_ordering_starved_regime(tmp_path, monkeypatch):
    """cal14: unguided > original + 5, guided > original + 5 and guided >=
    unguided - 0.5."""
    table = _run(tmp_path, monkeypatch, [
        "--num_images_per_prompt", "5", "--n_train", "5", "--n_test", "50",
        "--strength", "0.45", "--guide_epochs", "40"])
    orig = table["original"]["mean"]
    ung = table["unguided"]["mean"]
    gui = table["guided"]["mean"]
    assert ung > orig + 5.0, table
    assert gui > orig + 5.0, table
    assert gui >= ung - 0.5, table
