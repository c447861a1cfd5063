"""The pipeline's parameter files (``weights/params_io.py``;
``generate_data --save_params`` / ``--params_path``, ``train_lora
--params_path``) on the CPU at ``--tiny``:

* a round trip for ``sd15``, ``sd21`` and ``sdxl`` (the last two under
  ``--int8``) and under ``--lora`` (with ``--int8 --deep_cache``): a run
  from a synth checkpoint writes the directory, a second run in another
  directory reads it with no ``--sd_checkpoint``; its PNGs equal the
  first run's byte for byte;
* the strict refusals: a missing key, a misshapen key, another
  ``--model``, another geometry;
* the JAX package's parameter tree as a flat ``.npz``: the port's
  ``--params_path`` run gives the JAX CLI's ``--params_path`` run (on the
  same tree saved as orbax; both under ``--int8 --deep_cache``) its PNGs'
  paths, latent cache and prototypes, and loads the weights the port's
  own checkpoint load gives, bit for bit;
* an orbax directory written by the JAX package's ``save_pytree``,
  refused before anything is written, naming the ``.npz`` route;
* ``train_lora --params_path`` from the ``.npz``: the adapter of the run
  from ``--sd_checkpoint`` on the same weights."""

import os
import shutil

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from distdiff_tpu.cli import generate_data as j_cli
from distdiff_tpu.config import PipelineConfig as JPipelineConfig
from distdiff_tpu.models.guide import create_model as j_create_model
from distdiff_tpu.utils.checkpoints import save_pytree
from distdiff_tpu.weights.synth import write_synth_checkpoint as j_write_synth
from distdiff_tpu_torch.cli import generate_data as cli
from distdiff_tpu_torch.cli import train_lora
from distdiff_tpu_torch.config import PipelineConfig
from distdiff_tpu_torch.models.guide.resnet import tiny_resnet_config
from distdiff_tpu_torch.sampling import ExpansionPipeline
from distdiff_tpu_torch.train.lora import init_lora, save_lora
from distdiff_tpu_torch.weights import params_io
from distdiff_tpu_torch.weights.from_jax import state_dict_from_jax
from distdiff_tpu_torch.weights.safetensors import load_file, save_file
from distdiff_tpu_torch.weights.synth import write_synth_checkpoint

torch.set_num_threads(1)

CLASSES = ("alpha", "beta")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 2-class medmnist-style tree of 20x20 PNGs, tiny fp32 synth
    checkpoints (SD-1.x and SDXL layouts), a tiny guide and an adapter."""
    root = tmp_path_factory.mktemp("files")
    base = root / "data" / "medmnist" / "breastmnist"
    for ci, cat in enumerate(CLASSES):
        shade = 40 + 170 * ci
        for split, n in (("train", 3), ("test", 1)):
            os.makedirs(base / split / cat)
            for k in range(n):
                Image.new("RGB", (20, 20), (shade, shade // 2, 10 + 30 * k)).save(
                    base / split / cat / f"img_{k}.png")
    sd = j_write_synth(str(root / "ckpt"), JPipelineConfig.tiny(sample_size=32), seed=5,
                       scale=0.1, dtype=np.float32)
    sdxl = write_synth_checkpoint(str(root / "ckpt_xl"), PipelineConfig.sdxl_tiny(32), seed=6,
                                  scale=0.1, dtype=np.float32)
    jg = j_create_model("tiny_resnet", num_classes=2, input_size=32)
    state = state_dict_from_jax(jax.tree.map(np.asarray, jg.variables), tiny_resnet_config(2))
    torch.save({"state_dict": {"module." + k: v for k, v in state.items()}},
               str(root / "guide.pth.tar"))
    unet = ExpansionPipeline.create(PipelineConfig.tiny(32), device="cpu").unet
    lora = init_lora(torch.Generator().manual_seed(3), unet, rank=2)
    for pair in lora.values():  # b away from 0, so that the merge moves the UNet
        pair["b"].data.normal_(0, 0.05, generator=torch.Generator().manual_seed(4))
    save_lora(str(root / "lora.npz"), lora, alpha=2.0)
    return {"data": str(root / "data"), "sd": sd, "sdxl": sdxl,
            "guide": str(root / "guide.pth.tar"), "lora": str(root / "lora.npz")}


def _argv(files, weights, extra=()):
    return ["-d", "breastmnist", "--data_root", files["data"], "--tiny", *weights,
            "--encoder_weight_path", files["guide"], "--guidance_type", "transform_guidance",
            "--guidance_step", "4", "--guidance_period", "2", "--K", "2",
            "--num_images_per_prompt", "1", "--train_batch_size", "2", "--max_units", "2",
            "--output_dir", "out", "--seed", "0", "--resolution", "32", *extra]


def _run(workdir, argv, monkeypatch, main=cli.main):
    os.makedirs(workdir, exist_ok=True)
    monkeypatch.setenv("DISTDIFF_PLATFORM", "cpu")
    monkeypatch.chdir(workdir)
    return main(argv)


def _pngs(workdir):
    out = {}
    for d, _, fs in os.walk(os.path.join(workdir, "out")):
        for f in fs:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), workdir)] = fh.read()
    return out


ROUND_TRIPS = {
    "sd15": ("sd", []),
    "sd21_int8": ("sd", ["--model", "sd21", "--int8"]),
    "sdxl_int8": ("sdxl", ["--model", "sdxl", "--int8"]),
    "lora_int8_deep_cache": ("sd", ["LORA", "--int8", "--deep_cache", "--cache_interval", "2"]),
}


@pytest.mark.parametrize("case", list(ROUND_TRIPS))
def test_save_params_round_trip_gives_the_same_pngs(files, tmp_path, monkeypatch, case):
    ckpt, extra = ROUND_TRIPS[case]
    extra = [a for x in extra for a in (["--lora", files["lora"]] if x == "LORA" else [x])]
    bpe = ["--bpe_path", os.path.join(files[ckpt], "tokenizer", "merges.txt")]
    saved = str(tmp_path / "params")
    first = _run(tmp_path / "first", _argv(files, ["--sd_checkpoint", files[ckpt], *bpe,
                                                   "--save_params", saved], extra), monkeypatch)
    model = extra[extra.index("--model") + 1] if "--model" in extra else "sd15"
    stems = ["text_encoder", "unet", "vae"] + (["text_encoder_2"] if model == "sdxl" else [])
    assert sorted(os.listdir(saved)) == sorted([params_io.MANIFEST] + [
        f"{s}.safetensors" for s in stems])
    # the saved UNet is the one the run sampled with: the adapter merged in
    args = cli.parse_args(_argv(files, ["--sd_checkpoint", files[ckpt]], extra))
    monkeypatch.setenv("DISTDIFF_PLATFORM", "cpu")
    pipe = cli.build_pipeline(args)
    unet = load_file(os.path.join(saved, "unet.safetensors"))
    for k, v in pipe.unet.state_dict().items():
        assert torch.equal(unet[k], v), k
    lora = [a for a in extra if a == files["lora"]]
    second_extra = [a for a in extra if a not in ("--lora", *lora)]
    second = _run(tmp_path / "second", _argv(files, ["--params_path", saved, *bpe],
                                             second_extra), monkeypatch)
    assert first["written"] == second["written"] == 2
    got, want = _pngs(tmp_path / "second"), _pngs(tmp_path / "first")
    assert len(want) == 2 and got == want
    # a save over an existing directory replaces it
    stale = os.path.join(saved, "stale.txt")
    open(stale, "w").close()
    assert params_io.save_params(saved, pipe, model) > 0 and not os.path.exists(stale)


@pytest.fixture(scope="module")
def saved_tiny(files, tmp_path_factory):
    """A tiny SD-1.5 pipeline on the synth checkpoint and its saved
    directory."""
    from distdiff_tpu_torch.weights.convert import load_sd_checkpoint

    pipe = ExpansionPipeline.create(PipelineConfig.tiny(32), device="cpu")
    load_sd_checkpoint(files["sd"], pipe)
    path = str(tmp_path_factory.mktemp("saved") / "params")
    params_io.save_params(path, pipe, "sd15")
    return pipe, path


@pytest.mark.parametrize("fault", ["missing", "misshapen"])
def test_a_faulty_key_is_refused_naming_it(saved_tiny, tmp_path, fault):
    pipe, path = saved_tiny
    bad = str(tmp_path / "bad")
    shutil.copytree(path, bad)
    state = load_file(os.path.join(bad, "vae.safetensors"))
    key = "decoder.conv_out.weight"
    if fault == "missing":
        del state[key]
    else:
        state[key] = state[key][:, :, :2]
    save_file(state, os.path.join(bad, "vae.safetensors"))
    fresh = ExpansionPipeline.create(PipelineConfig.tiny(32), device="cpu")
    label = {"missing": "missing", "misshapen": "shape-mismatched"}[fault]
    with pytest.raises(ValueError, match=rf"vae: .*{label}.*{key}"):
        params_io.load_params(bad, fresh, "sd15")
    assert params_io.load_params(path, fresh, "sd15")["vae"] == len(fresh.vae.state_dict())
    for k, v in fresh.unet.state_dict().items():
        assert torch.equal(v, pipe.unet.state_dict()[k])


def test_another_model_or_geometry_is_refused_naming_both(saved_tiny):
    _, path = saved_tiny
    v_pred = ExpansionPipeline.create(PipelineConfig.tiny(32), device="cpu")
    with pytest.raises(ValueError, match="--model sd15 parameters; this run is --model sd21"):
        params_io.load_params(path, v_pred, "sd21")
    xl = ExpansionPipeline.create(PipelineConfig.sdxl_tiny(32), device="cpu")
    with pytest.raises(ValueError, match=r"text_encoder was saved with another geometry "
                                         r"\(differs in \['hidden_size'\]\)"):
        params_io.load_params(path, xl, "sd15")


# ------------------------------------------------ the JAX package's tree

JAX_RUN = ["--int8", "--deep_cache", "--cache_interval", "2"]


@pytest.fixture(scope="module")
def jax_tree(files, tmp_path_factory):
    """The JAX CLI's parameter tree of the tiny pipeline on the synth
    checkpoint, saved as orbax (the JAX CLI's ``--save_params``) and as a
    flat ``.npz``; and the JAX CLI's ``--params_path`` run on it under
    ``JAX_RUN``."""
    root = tmp_path_factory.mktemp("jax_tree")
    params = j_cli.build_pipeline(j_cli.parse_args(_argv(files, ["--sd_checkpoint",
                                                                 files["sd"]]))).params
    params = jax.tree.map(np.asarray, params)
    save_pytree(str(root / "orbax"), params)
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = np.asarray(v, np.float32)
    walk(params, "")
    assert {k.split("/")[0] for k in flat} == {"unet", "vae", "text"}
    np.savez(root / "params.npz", **flat)
    cwd = os.getcwd()
    os.makedirs(root / "run")
    os.chdir(root / "run")
    try:
        j_cli.main(_argv(files, ["--params_path", str(root / "orbax")], JAX_RUN))
    finally:
        os.chdir(cwd)
    return str(root / "orbax"), str(root / "params.npz"), str(root / "run")


def _files(workdir):
    return sorted(os.path.relpath(os.path.join(d, f), workdir)
                  for d, _, fs in os.walk(workdir) for f in fs)


def test_jax_npz_gives_the_jax_clis_params_path_run(files, jax_tree, tmp_path, monkeypatch):
    """The port's ``--params_path`` run on the ``.npz`` beside the JAX
    CLI's on the orbax tree, both under ``--int8 --deep_cache``: the same
    output paths, latent cache and prototypes (the draws differ: torch's
    generators, JAX's keys); the loaded modules equal, bit for bit, the
    port's own load of the synth checkpoint the tree was converted from."""
    _, npz, jwork = jax_tree
    stats = _run(tmp_path, _argv(files, ["--params_path", npz], JAX_RUN), monkeypatch)
    assert stats["written"] == 2 and _files(str(tmp_path)) == _files(jwork)
    lat = "save/vae_embedding/breastmnist/CompVis--stable-diffusion-v1-4/image_latents_32.npy"
    np.testing.assert_allclose(np.load(tmp_path / lat), np.load(os.path.join(jwork, lat)),
                               atol=1e-5, rtol=0)
    proto = "save/prototypes/tiny_resnet/breastmnist/class_wise_prototype_K2.npz"
    got, want = np.load(tmp_path / proto), np.load(os.path.join(jwork, proto))
    for key in ("global_prototypes", "local_prototypes"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-5, rtol=0)
    from_npz = cli.build_pipeline(cli.parse_args(_argv(files, ["--params_path", npz])))
    from_ckpt = cli.build_pipeline(cli.parse_args(_argv(files, ["--sd_checkpoint", files["sd"]])))
    for name in ("unet", "vae", "text_encoder"):
        want = getattr(from_ckpt, name).state_dict()
        for k, v in getattr(from_npz, name).state_dict().items():
            assert torch.equal(v, want[k]), (name, k)


def test_an_orbax_directory_is_refused_naming_the_npz_route(files, jax_tree, tmp_path,
                                                            monkeypatch):
    orbax, _, _ = jax_tree
    monkeypatch.setenv("DISTDIFF_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match=r"orbax checkpoint .*\.npz"):
        cli.main(_argv(files, ["--params_path", orbax]))
    with pytest.raises(NotImplementedError, match=r"\.npz"):
        train_lora.main(["--dataset", "breastmnist", "--output_dir", "runs", "--tiny",
                         "--params_path", orbax])
    assert os.listdir(tmp_path) == []


def test_train_lora_from_the_npz_is_the_run_from_the_checkpoint(files, jax_tree, tmp_path,
                                                                monkeypatch):
    _, npz, _ = jax_tree
    bpe = ["--bpe_path", os.path.join(files["sd"], "tokenizer", "merges.txt")]
    adapters = {}
    for label, weights in (("ckpt", ["--sd_checkpoint", files["sd"]]),
                           ("npz", ["--params_path", npz])):
        out = _run(tmp_path / label, ["--dataset", "breastmnist", "--data_root", files["data"],
                                      "--output_dir", "runs", "--tiny", "--resolution", "32",
                                      "--steps", "2", "--batch", "2", *weights, *bpe],
                   monkeypatch, main=train_lora.main)
        adapters[label] = np.load(out)
    got, want = adapters["npz"], adapters["ckpt"]
    assert sorted(got.files) == sorted(want.files) and len(want.files) == 2 * 32 + 1
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k])
