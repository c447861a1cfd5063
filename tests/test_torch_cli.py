"""The port's ``generate_data`` CLI: its parser against the JAX package's
(every dest and default), the refusal of every unported option, the device
rule (the card, or the CPU under ``DISTDIFF_PLATFORM=cpu``), and ``main``
end to end on the CPU at ``--tiny`` against the JAX CLI on the same files:
the same output paths, latent cache and prototypes; the same under
``--model sd21``, ``--scheduler dpmpp`` and ``--deep_cache``, and the
refusal of ``--deep_cache --scheduler dpmpp`` by both CLIs."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from distdiff_tpu.cli import generate_data as j_cli
from distdiff_tpu.config import PipelineConfig as JPipelineConfig
from distdiff_tpu.models.guide import create_model as j_create_model
from distdiff_tpu.weights.synth import write_synth_checkpoint as j_write_synth
from distdiff_tpu_torch.cli import generate_data as cli
from distdiff_tpu_torch.models.guide.resnet import tiny_resnet_config
from distdiff_tpu_torch.weights.from_jax import state_dict_from_jax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ("alpha", "beta")


def _actions(parser):
    return {a.dest: (a.default, tuple(a.option_strings), type(a).__name__, a.choices,
                     a.const, a.nargs, getattr(a.type, "__name__", a.type))
            for a in parser._actions}


def test_parser_has_the_jax_parsers_dests_and_defaults():
    got, want = _actions(cli.build_parser()), _actions(j_cli.build_parser())
    assert len(want) > 90 and got == want
    for argv in ([], ["--guidance_type", "transform_guidance", "-a", "resnet50", "--K", "5"],
                 ["--do_classifier_free_guidance", "false", "--gradient_checkpointing"]):
        assert vars(cli.parse_args(argv)) == vars(j_cli.parse_args(argv))


UNPORTED = [
    # SDXL is ported; its int8 spans are not (the case keeps its id)
    pytest.param(["--model", "sdxl", "--int8"], id="model_sdxl"), ["--int8"], ["--lora", "adapter.npz"], ["--params_path", "params"],
    ["--save_params", "params"], ["--mesh_model", "2"],
    # the guide archs the port lacks (open_clip_vit_b32 is the default -a)
    ["--guidance_type", "transform_guidance"],
    ["--guidance_type", "direct_guidance", "-a", "mobilenetv2"],
    ["--guidance_type", "transform_guidance", "-a", "resnext50"],
    ["--guidance_type", "transform_guidance", "-a", "wideresnet50"],
]


@pytest.mark.parametrize("argv", UNPORTED, ids=lambda a: "_".join(a).strip("-"))
def test_every_unported_option_raises_naming_its_roadmap_item(argv, monkeypatch):
    monkeypatch.setenv("DISTDIFF_PLATFORM", "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        cli.main(argv + ["--output_dir", "never_written"])
    assert not os.path.exists("never_written")


def test_the_cli_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("DISTDIFF_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="DISTDIFF_PLATFORM=cpu"):
        cli.main(["--tiny", "--output_dir", "never_written"])
    monkeypatch.setenv("DISTDIFF_PLATFORM", "tpu")
    with pytest.raises(ValueError, match="DISTDIFF_PLATFORM"):
        cli.main(["--tiny", "--output_dir", "never_written"])
    assert not os.path.exists("never_written")


def test_module_runs_as_a_program():
    out = subprocess.run([sys.executable, "-m", "distdiff_tpu_torch.cli.generate_data", "--help"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "--sd_checkpoint" in out.stdout


@pytest.fixture(scope="module")
def toy_files(tmp_path_factory):
    """The toy tree of ``tests/test_cli_smoke.py`` (a 2-class medmnist-style
    tree of 20x20 PNGs), a tiny diffusers checkpoint and a tiny guide
    ``.pth.tar``, shared by both CLIs."""
    root = tmp_path_factory.mktemp("files")
    base = root / "data" / "medmnist" / "breastmnist"
    for ci, cat in enumerate(CLASSES):
        shade = 40 + 170 * ci
        for split, n, blue in (("train", 4, None), ("test", 2, 200)):
            os.makedirs(base / split / cat)
            for k in range(n):
                Image.new("RGB", (20, 20), (shade, shade // 2, 10 + k if blue is None else blue)
                          ).save(base / split / cat / f"img_{k}.png")
    ckpt = j_write_synth(str(root / "ckpt"), JPipelineConfig.tiny(sample_size=32), seed=5)
    jg = j_create_model("tiny_resnet", num_classes=2, input_size=32)
    state = state_dict_from_jax(jax.tree.map(np.asarray, jg.variables), tiny_resnet_config(2))
    torch.save({"state_dict": {"module." + k: v for k, v in state.items()}},
               str(root / "guide.pth.tar"))
    return str(root / "data"), ckpt, str(root / "guide.pth.tar")


def _argv(toy_files, extra=()):
    data, ckpt, guide = toy_files
    return ["-d", "breastmnist", "--data_root", data, "--tiny", "--sd_checkpoint", ckpt,
            "--encoder_weight_path", guide, "--guidance_type", "transform_guidance",
            "--guidance_step", "4", "--guidance_period", "2", "--K", "2",
            "--num_images_per_prompt", "2", "--train_batch_size", "2", "--max_units", "5",
            "--output_dir", "out", "--seed", "0", "--resolution", "32", *extra]


def _outputs(workdir):
    return sorted(os.path.relpath(os.path.join(d, f), workdir)
                  for d, _, fs in os.walk(workdir) for f in fs)


@pytest.fixture(scope="module")
def jax_run(toy_files, tmp_path_factory):
    work = tmp_path_factory.mktemp("jax_run")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        stats = j_cli.main(_argv(toy_files))
    finally:
        os.chdir(cwd)
    return str(work), stats


@pytest.mark.parametrize("fused", [False, True])
def test_tiny_cli_on_the_cpu_matches_the_jax_cli(toy_files, jax_run, tmp_path, monkeypatch,
                                                 fused):
    jwork, jstats = jax_run
    monkeypatch.setenv("DISTDIFF_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    stats = cli.main(_argv(toy_files, ["--fused_program"] if fused else []))
    assert stats["written"] == jstats["written"] == 5
    # the same PNGs, latent cache and prototype cache, at the same paths
    assert _outputs(str(tmp_path)) == _outputs(jwork)
    pngs = [p for p in _outputs(str(tmp_path)) if p.endswith(".png")]
    assert len(pngs) == 5 and all("_expand_" in p for p in pngs)
    from distdiff_tpu_torch.parallel import read_png

    assert read_png(os.path.join(tmp_path, pngs[0])).shape == (32, 32, 3)
    lat = "save/vae_embedding/breastmnist/CompVis--stable-diffusion-v1-4/image_latents_32.npy"
    # fp32 VAE encoders on the same checkpoint and crops: summation order
    np.testing.assert_allclose(np.load(tmp_path / lat), np.load(os.path.join(jwork, lat)),
                               atol=1e-5, rtol=0)
    proto = "save/prototypes/tiny_resnet/breastmnist/class_wise_prototype_K2.npz"
    got, want = np.load(tmp_path / proto), np.load(os.path.join(jwork, proto))
    for key in ("global_prototypes", "local_prototypes"):
        assert got[key].shape == want[key].shape
        # fp32 guides on the same weights and images: summation order only
        np.testing.assert_allclose(got[key], want[key], atol=1e-5, rtol=0)


# ------------------------------------ the options ported with SD-2.1 and DPM

@pytest.fixture(scope="module")
def port_default_pngs(toy_files, tmp_path_factory):
    """The port's PNGs under the default options, by path."""
    work = tmp_path_factory.mktemp("port_default")
    cwd = os.getcwd()
    os.chdir(work)
    os.environ["DISTDIFF_PLATFORM"] = "cpu"
    try:
        cli.main(_argv(toy_files))
    finally:
        os.environ.pop("DISTDIFF_PLATFORM")
        os.chdir(cwd)
    from distdiff_tpu_torch.parallel import read_png

    return {p: read_png(os.path.join(work, p)) for p in _outputs(str(work)) if p.endswith(".png")}


OPTIONS = {"sd21": ["--model", "sd21"], "dpmpp": ["--scheduler", "dpmpp"],
           "deep_cache": ["--deep_cache", "--cache_interval", "2"]}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_tiny_cli_option_matches_the_jax_cli(toy_files, port_default_pngs, option, tmp_path,
                                             monkeypatch):
    extra = OPTIONS[option]
    jwork = tmp_path / "jax"
    os.makedirs(jwork)
    monkeypatch.chdir(jwork)
    jstats = j_cli.main(_argv(toy_files, extra))
    monkeypatch.setenv("DISTDIFF_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    args = cli.parse_args(_argv(toy_files, extra))
    pipe = cli.build_pipeline(args)
    assert (pipe.config.prediction_type, pipe.config.scheduler, pipe.config.deep_cache) == {
        "sd21": ("v_prediction", "ddim", False), "dpmpp": ("epsilon", "dpmpp", False),
        "deep_cache": ("epsilon", "ddim", True)}[option]
    stats = cli.main(_argv(toy_files, extra))
    assert stats["written"] == jstats["written"] == 5
    # the same PNGs (by path), latent cache and prototype cache as JAX's run
    got = [p for p in _outputs(str(tmp_path)) if not p.startswith("jax" + os.sep)]
    assert got == _outputs(str(jwork))
    from distdiff_tpu_torch.parallel import read_png

    pngs = {p: read_png(os.path.join(tmp_path, p)) for p in got if p.endswith(".png")}
    assert sorted(pngs) == sorted(port_default_pngs)
    # the option changed the images (the draws are the default run's)
    assert max(np.abs(pngs[p].astype(int) - port_default_pngs[p].astype(int)).max()
               for p in pngs) > 0
    lat = "save/vae_embedding/breastmnist/CompVis--stable-diffusion-v1-4/image_latents_32.npy"
    np.testing.assert_allclose(np.load(tmp_path / lat), np.load(jwork / lat), atol=1e-5, rtol=0)


def test_deep_cache_under_dpmpp_is_refused_by_both_clis(toy_files, tmp_path, monkeypatch):
    argv = _argv(toy_files, ["--deep_cache", "--scheduler", "dpmpp"])
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="DDIM solver only"):
        j_cli.main(argv)
    monkeypatch.setenv("DISTDIFF_PLATFORM", "cpu")
    port = tmp_path / "port"
    os.makedirs(port)
    monkeypatch.chdir(port)
    with pytest.raises(NotImplementedError, match="DDIM solver only"):
        cli.main(argv)
    assert _outputs(str(port)) == []  # refused before any cache or image
