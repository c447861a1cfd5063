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


# --int8, --params_path and --save_params are ported (tests/test_torch_int8.py,
# tests/test_torch_params_io.py), and --mesh_model (tests/test_torch_parallel_*.py):
# each case keeps its id and pairs its options with --mesh_model 2, which a
# process with one CPU device refuses
UNPORTED = [
    pytest.param(["--model", "sdxl", "--int8", "--mesh_model", "2"], id="model_sdxl"),
    pytest.param(["--int8", "--mesh_model", "2"], id="int8"),
    pytest.param(["--lora", "adapter.npz", "--save_params", "params", "--mesh_model", "2"],
                 id="lora_adapter.npz"),
    pytest.param(["--params_path", "params", "--mesh_model", "2"], id="params_path_params"),
    pytest.param(["--save_params", "params", "--mesh_model", "2"], id="save_params_params"),
    ["--mesh_model", "2"],
    pytest.param(["--guidance_type", "transform_guidance", "--int8", "--mesh_model", "2"],
                 id="guidance_type_transform_guidance"),
    pytest.param(["--guidance_type", "direct_guidance", "-a", "mobilenetv2", "--mesh_model", "2"],
                 id="guidance_type_direct_guidance_-a_mobilenetv2"),
    pytest.param(["--guidance_type", "transform_guidance", "-a", "resnext50", "--params_path",
                  "params", "--mesh_model", "2"],
                 id="guidance_type_transform_guidance_-a_resnext50"),
    pytest.param(["--guidance_type", "transform_guidance", "-a", "wideresnet50", "--save_params",
                  "params", "--mesh_model", "2"],
                 id="guidance_type_transform_guidance_-a_wideresnet50"),
]


@pytest.mark.parametrize("argv", UNPORTED, ids=lambda a: "_".join(a).strip("-"))
def test_every_unported_option_raises_naming_its_roadmap_item(argv, monkeypatch):
    """The name is from when ``--mesh_model`` was not ported. On one CPU
    device the port refuses ``--mesh_model 2`` before it writes anything, as
    the JAX package's ``make_expand_mesh`` asserts that the model axis
    divides the device count; the message names no ROADMAP item and none of
    the other flags."""
    monkeypatch.setenv("DISTDIFF_PLATFORM", "cpu")
    with pytest.raises(ValueError, match="--mesh_model 2 does not divide 1 devices") as err:
        cli.main(argv + ["--output_dir", "never_written"])
    msg = str(err.value)
    assert "item 8" not in msg and "ROADMAP" not in msg
    assert not any(flag in msg for flag in ("--int8", "--params_path", "--save_params"))
    assert not os.path.exists("never_written")


@pytest.mark.parametrize("arch", ["resnet50", "resnext50", "wideresnet50", "mobilenetv2",
                                  "open_clip_vit_b32"])
@pytest.mark.parametrize("guidance", ["transform_guidance", "direct_guidance"])
def test_every_guide_arch_passes_check_ported(arch, guidance):
    from distdiff_tpu_torch.models.guide.factory import ARCHS

    assert arch in ARCHS
    args = cli.parse_args(["--guidance_type", guidance, "-a", arch])
    cli.check_ported(args)  # raises for nothing
    assert cli.parse_args([]).arch == "open_clip_vit_b32"


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


def test_tiny_cli_under_mesh_model_2_matches_the_jax_cli(toy_files, jax_run, tmp_path,
                                                         monkeypatch):
    """``--mesh_model 2`` on a 2-device CPU mesh (``parallel.mesh.local_devices``
    patched: the one function that lists the devices), every transformer
    block of the UNet tensor-parallel, on the JAX run's own draws (its
    per-unit keys, ``fold_in(fold_in(PRNGKey(seed), dataset index),
    image_i)``, in place of the port's generators): the JAX CLI's files,
    its latent and prototype caches within 1e-5, its PNGs within one level
    (the images agree to about 2e-4 before the 8-bit rounding)."""
    from torch_parity import jax_draws

    from distdiff_tpu_torch.parallel import driver, mesh, read_png, tp
    from distdiff_tpu_torch.sampling import pipeline

    jwork, jstats = jax_run
    monkeypatch.setenv("DISTDIFF_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(mesh, "local_devices", lambda: [torch.device("cpu")] * 2)
    base = jax.random.PRNGKey(0)  # --seed 0

    def unit_keys(self, units):
        return [np.asarray(jax.random.fold_in(jax.random.fold_in(base, u.dataset_index),
                                              u.image_i)) for u in units]

    def draw(self, image_latents, keys, text_to_img=False):
        return tuple(torch.from_numpy(a) for a in jax_draws(np.stack(keys),
                                                             image_latents.numpy()))

    groups = []
    forward = tp.TPAttention.forward

    def counted(self, *a, **k):
        groups.append(len(self.group))
        return forward(self, *a, **k)

    monkeypatch.setattr(driver.ExpansionDriver, "generators", unit_keys)
    monkeypatch.setattr(pipeline.ExpansionPipeline, "draw", draw)
    monkeypatch.setattr(tp.TPAttention, "forward", counted)
    stats = cli.main(_argv(toy_files, ["--mesh_model", "2"]))
    assert stats["written"] == jstats["written"] == 5
    assert groups and set(groups) == {2}
    assert _outputs(str(tmp_path)) == _outputs(jwork)
    for p in _outputs(jwork):
        if p.endswith(".png"):
            got, want = read_png(str(tmp_path / p)), read_png(os.path.join(jwork, p))
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, p
    lat = "save/vae_embedding/breastmnist/CompVis--stable-diffusion-v1-4/image_latents_32.npy"
    np.testing.assert_allclose(np.load(tmp_path / lat), np.load(os.path.join(jwork, lat)),
                               atol=1e-5, rtol=0)
    proto = "save/prototypes/tiny_resnet/breastmnist/class_wise_prototype_K2.npz"
    got, want = np.load(tmp_path / proto), np.load(os.path.join(jwork, proto))
    for key in ("global_prototypes", "local_prototypes"):
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


def _unused_images(self, params, image_latents, cond, uncond, targets, keys):
    """The JAX ``SplitExpand`` call's output shape, in zeros: the option runs
    below read the JAX CLI's files, caches and counts, never its images, so
    its expand (most of a minute of tracing and compiling an option's
    programs) is not run."""
    import jax.numpy as jnp

    side = self.pipe.config.sample_size
    return jnp.zeros((image_latents.shape[0], side, side, 3), jnp.float32)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_tiny_cli_option_matches_the_jax_cli(toy_files, port_default_pngs, option, tmp_path,
                                             monkeypatch):
    from distdiff_tpu.sampling import pipeline as j_pipeline

    extra = OPTIONS[option]
    jwork = tmp_path / "jax"
    os.makedirs(jwork)
    monkeypatch.chdir(jwork)
    with monkeypatch.context() as mp:
        mp.setattr(j_pipeline.SplitExpand, "__call__", _unused_images)
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
    # the same PNGs (by path), latent cache and prototype cache as JAX's run;
    # the port's latent cache of another model than SD-1.x names the model
    lat = "save/vae_embedding/breastmnist/CompVis--stable-diffusion-v1-4/image_latents_32.npy"
    port_lat = lat.replace(".npy", "_sd21.npy") if option == "sd21" else lat
    got = [p for p in _outputs(str(tmp_path)) if not p.startswith("jax" + os.sep)]
    assert got == sorted(port_lat if p == lat else p for p in _outputs(str(jwork)))
    from distdiff_tpu_torch.parallel import read_png

    pngs = {p: read_png(os.path.join(tmp_path, p)) for p in got if p.endswith(".png")}
    assert sorted(pngs) == sorted(port_default_pngs)
    # the option changed the images (the draws are the default run's)
    assert max(np.abs(pngs[p].astype(int) - port_default_pngs[p].astype(int)).max()
               for p in pngs) > 0
    np.testing.assert_allclose(np.load(tmp_path / port_lat), np.load(jwork / lat), atol=1e-5,
                               rtol=0)


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


# ------------------------------------------------------------ the guide zoo

@pytest.fixture(scope="module")
def zoo_files(toy_files, tmp_path_factory):
    """MobileNetV2 (2 classes, full width) as the JAX package's flat
    ``.npz`` of seeded variables, a shrunk OpenCLIP state in
    ``.safetensors``, a minimal merges file, and 5 noise PNGs a class
    (distinct images, so that the prototypes' clustering has no near
    ties; the toy tree's are flat colours)."""
    from distdiff_tpu.models.guide.mobilenet import MobileNetV2 as JMobileNetV2
    from distdiff_tpu.models.guide.mobilenet import MobileNetV2Config as JMobileNetV2Config
    from torch_parity import flat_variables, seeded_variables

    from distdiff_tpu_torch.weights.openclip import openclip_vit_b32_state_shapes
    from distdiff_tpu_torch.weights.safetensors import save_file

    root = tmp_path_factory.mktemp("zoo")
    variables = seeded_variables(JMobileNetV2(JMobileNetV2Config(num_classes=2)),
                                 np.zeros((1, 32, 32, 3), np.float32), seed=4)
    np.savez(root / "mobilenetv2.npz", **flat_variables(variables))
    rng = np.random.default_rng(5)
    save_file({k: (rng.standard_normal(s) * 0.02 + (k.endswith("ln_1.weight") or k.endswith(
        "ln_2.weight") or "ln_" in k and k.endswith("weight"))).astype(np.float32)
               for k, s in openclip_vit_b32_state_shapes(
                   image_size=32, patch=8, vw=32, vlayers=2, tw=32, tlayers=2, embed=16,
                   vocab=600, ctx_len=32).items()}, str(root / "openclip.safetensors"))
    (root / "merges.txt").write_text("#version: 0.2\na l</w>\nb e\nbe t\n")
    paths, labels = [], []
    for ci, cat in enumerate(CLASSES):
        os.makedirs(root / "images" / cat)
        for k in range(5):
            img = rng.integers(0, 200, (24, 28, 3))
            img[..., ci] += 55
            paths.append(str(root / "images" / cat / f"{k}.png"))
            labels.append(ci)
            Image.fromarray(img.astype(np.uint8)).save(paths[-1])
    return {"mobilenetv2": str(root / "mobilenetv2.npz"),
            "open_clip_vit_b32": str(root / "openclip.safetensors"),
            "bpe": str(root / "merges.txt"), "images": (paths, np.array(labels))}


def _tiny_clip_geometry(monkeypatch):
    """Both factories build the CLIP ViT and the zero-shot text tower at the
    shrunk state's geometry (the full B/32 towers are held on the card)."""
    import functools

    import distdiff_tpu.models.guide.factory as j_factory
    from distdiff_tpu.config import TextEncoderConfig as JTextEncoderConfig
    from distdiff_tpu.models.guide.clip_vit import tiny_clip_vit_config as j_tiny_clip

    import distdiff_tpu_torch.models.guide.factory as factory
    from distdiff_tpu_torch.config import TextEncoderConfig
    from distdiff_tpu_torch.models.guide.clip_vit import tiny_clip_vit_config

    kw = dict(vocab_size=600, hidden_size=32, num_layers=2, num_heads=2, max_length=32,
              embed_dim=16)
    monkeypatch.setattr(j_factory, "CLIPViTConfig", j_tiny_clip)
    monkeypatch.setattr(factory, "CLIPViTConfig", tiny_clip_vit_config)
    for mod, cfg in ((j_factory, functools.partial(JTextEncoderConfig, dtype=jax.numpy.float32,
                                                   **kw)),
                     (factory, functools.partial(TextEncoderConfig, dtype=torch.float32, **kw))):
        def build(*a, _orig=mod.build_zero_shot_text_features, _cfg=cfg, **k):
            return _orig(*a, config=_cfg(activation=k.get("activation", "gelu")), **k)
        monkeypatch.setattr(mod, "build_zero_shot_text_features", build)


@pytest.mark.parametrize("arch", ["mobilenetv2", "open_clip_vit_b32"])
def test_prepare_guide_and_prototypes_matches_the_jax_cli(zoo_files, tmp_path, monkeypatch,
                                                          arch):
    """``prepare_guide_and_prototypes`` of both CLIs, guided and not
    ``--tiny``, on the same guide file and train images (32^2): the same
    prototype cache, and under ``open_clip_vit_b32`` (an OpenCLIP file with
    its text tower, ``--bpe_path``) the same zero-shot head. The JAX guide
    is built lazily (the file replaces every leaf of its init)."""
    import argparse
    import functools
    import types

    import distdiff_tpu.models.guide as j_guide_pkg

    if arch == "open_clip_vit_b32":
        _tiny_clip_geometry(monkeypatch)
    monkeypatch.setattr(j_guide_pkg, "create_model",
                        functools.partial(j_guide_pkg.create_model, lazy_init=True))
    paths, labels = zoo_files["images"]
    sd = types.SimpleNamespace(class_names=list(CLASSES), image_paths=paths, labels=labels)
    args = argparse.Namespace(arch=arch, tiny=False, encoder_weight_path=zoo_files[arch],
                              dataset="breastmnist", K=2, bpe_path=zoo_files["bpe"],
                              sd_checkpoint=None)
    gcfg = types.SimpleNamespace(guide_input_size=32)
    out = {}
    for side, fn, pipe in (
            ("jax", j_cli.prepare_guide_and_prototypes,
             types.SimpleNamespace(guidance_cfg=gcfg)),
            ("port", cli.prepare_guide_and_prototypes,
             types.SimpleNamespace(guidance_cfg=gcfg, device=torch.device("cpu")))):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        guide, gp, lp = fn(args, pipe, sd)
        out[side] = guide, np.asarray(gp), np.asarray(lp)
    proto = f"save/prototypes/{arch}/breastmnist/class_wise_prototype_K2.npz"
    got, want = np.load(tmp_path / "port" / proto), np.load(tmp_path / "jax" / proto)
    dim = 1280 if arch == "mobilenetv2" else 16
    for key, shape in (("global_prototypes", (2, dim)), ("local_prototypes", (2, 2, dim))):
        assert got[key].shape == want[key].shape == shape
        # fp32 guides on the same weights and images: summation order only
        np.testing.assert_allclose(got[key], want[key], atol=1e-5, rtol=0)
    np.testing.assert_allclose(out["port"][1], out["jax"][1], atol=1e-5, rtol=0)
    (jguide, *_), (guide, *_) = out["jax"], out["port"]
    if arch == "open_clip_vit_b32":
        assert guide.text_activation == jguide.text_activation == "gelu"
        want_head = np.asarray(jguide.class_text_features)
        assert guide.class_text_features.shape == want_head.shape == (2, 16)
        np.testing.assert_allclose(guide.class_text_features.numpy(), want_head,
                                   atol=1e-5 * float(np.abs(want_head).max()), rtol=0)
    else:
        assert guide.class_text_features is None and guide.feature_dim == 1280


def test_train_fc_on_mobilenetv2_matches_the_jax_cli(toy_files, zoo_files, tmp_path,
                                                     monkeypatch):
    """``cli.train -a mobilenetv2 --train_fc`` for one step (8 images of
    64^2, one batch, one epoch) from the same ``.npz`` weights, against the
    JAX CLI's ``log.txt``: the learning rate equal, the train and test
    losses within 1e-3, the accuracies equal. The JAX package's
    ``train_fc`` passes a masked-out leaf's gradient through as its update
    (``optax.masked``, ``ROADMAP.md`` §3), so its optimiser is held to a
    frozen backbone here (``optax.multi_transform`` with ``set_to_zero``
    outside the head), as ``tests/test_torch_train.py`` holds its step, and
    its step runs on one of the host's devices (a 12 s compile where the
    8-device mesh takes 35 s). The tolerance: the training forward
    normalises by batch statistics of 32 values a channel at MobileNetV2's
    last stage, and the JAX CLI's own train loss moves by 3.1e-4 between
    the 1- and the 8-device mesh (0.776212, 0.776523); the port's reads
    0.776724. The port's backbone does not move; its BatchNorm statistics
    and ``classifier.*`` do."""
    import contextlib
    import dataclasses
    import functools
    import io

    import optax

    import distdiff_tpu.models.guide as j_guide_pkg
    import distdiff_tpu.train as j_train_pkg
    from distdiff_tpu.cli import train as j_train

    from distdiff_tpu_torch.cli import train

    j_make = j_train_pkg.make_optimizer

    def frozen_backbone(cfg, steps_per_epoch):
        head = j_make(dataclasses.replace(cfg, train_fc_only=False), steps_per_epoch)

        def labels(params):
            return jax.tree_util.tree_map_with_path(
                lambda path, _: "head" if any(getattr(k, "key", None) in ("fc", "classifier")
                                              for k in path) else "frozen", params)
        return optax.multi_transform({"head": head, "frozen": optax.set_to_zero()}, labels)

    import distdiff_tpu.data.datasets as j_datasets

    import distdiff_tpu_torch.data.datasets as datasets

    for pkg in (datasets, j_datasets):  # the CLIs' set_seed: restored after the test
        monkeypatch.setattr(pkg, "_DATA_SEED", list(pkg._DATA_SEED))
    monkeypatch.setattr(j_train_pkg, "make_optimizer", frozen_backbone)
    # the JAX CLI's step on one of the host's devices (the batch is not split)
    import distdiff_tpu.train.classifier as j_classifier

    one_device = functools.partial(j_classifier.make_mesh, jax.devices()[:1])
    monkeypatch.setattr(j_classifier, "make_mesh", one_device)
    monkeypatch.setattr(j_guide_pkg, "create_model",
                        functools.partial(j_guide_pkg.create_model, lazy_init=True))
    data = toy_files[0]

    def argv(run):
        return ["-d", "breastmnist", "--data_root", data, "-a", "mobilenetv2", "--train_fc",
                "--input_size", "64", "--train-batch", "8", "--test-batch", "8", "--epochs",
                "1", "--manualSeed", "1", "--encoder_weight_path", zoo_files["mobilenetv2"],
                "--checkpoint", str(tmp_path / run)]

    with contextlib.redirect_stdout(io.StringIO()):
        j_train.main(argv("jax"))
        monkeypatch.setenv("DISTDIFF_PLATFORM", "cpu")
        train.main(argv("port"))

    def log(run):
        with open(tmp_path / run / "log.txt") as f:
            lines = f.read().splitlines()
        return lines[0].split("\t"), [[float(v) for v in line.split("\t")] for line in lines[1:]]

    (jnames, jrows), (names, rows) = log("jax"), log("port")
    assert names == jnames and len(rows) == len(jrows) == 1
    (row,), (jrow,) = rows, jrows
    assert row[0] == jrow[0]
    assert abs(row[1] - jrow[1]) <= 1e-3 and abs(row[2] - jrow[2]) <= 1e-3, (row, jrow)
    assert row[3:] == jrow[3:]
    # the port's checkpoint: the backbone as loaded, the head and statistics moved
    from distdiff_tpu_torch.models.guide import create_model

    start = create_model("mobilenetv2", 2, device="cpu",
                         weight_path=zoo_files["mobilenetv2"]).module.state_dict()
    saved = torch.load(tmp_path / "port" / "checkpoint.pth.tar",
                       weights_only=True)["state_dict"]
    moved = {k for k in start if not torch.equal(start[k], saved[k])}
    assert {"classifier.1.weight", "classifier.1.bias"} <= moved
    assert all(k.startswith("classifier.") or k.endswith(
        ("running_mean", "running_var", "num_batches_tracked")) for k in moved)
    assert any(k.endswith("running_var") for k in moved)
