"""``generate_data --model sdxl --tiny`` in the port against the JAX CLI on
the same files (a toy PNG tree, an SDXL-layout synth checkpoint and a
guide): the CLI's SDXL pipeline and its pair encoder against JAX's (both
towers on one tokenization), the dataset's dict conditioning and its
collation, then a guided run of both CLIs: the same PNG paths, latent
cache and prototypes. The images themselves differ by the draws (threefry
keys against torch generators); ``test_torch_sdxl.py`` holds the expand
on the JAX side's draws."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from distdiff_tpu.cli import generate_data as j_cli
from distdiff_tpu.config import PipelineConfig as JPipelineConfig
from distdiff_tpu.data import SDDataset as JSDDataset
from distdiff_tpu.data import collate_sd as j_collate_sd
from distdiff_tpu.models import load_tokenizer as j_load_tokenizer
from distdiff_tpu.models.guide import create_model as j_create_model
from distdiff_tpu.weights.synth import write_synth_checkpoint as j_write_synth
from distdiff_tpu_torch.cli import generate_data as cli
from distdiff_tpu_torch.data import SDDataset, collate_sd
from distdiff_tpu_torch.models import load_tokenizer
from distdiff_tpu_torch.models.guide.resnet import tiny_resnet_config
from distdiff_tpu_torch.parallel import read_png
from distdiff_tpu_torch.sampling.conditioning import cond_asarray
from distdiff_tpu_torch.weights.from_jax import state_dict_from_jax

torch.set_num_threads(1)

CLASSES = ("alpha", "beta")
SAMPLE = 32


@pytest.fixture(scope="module")
def toy_files(tmp_path_factory):
    """A 2-class medmnist-style tree of 20x20 PNGs, an ``sdxl_tiny``
    diffusers-layout checkpoint with its tokenizer files, and a tiny guide
    ``.pth.tar``, shared by both CLIs."""
    root = tmp_path_factory.mktemp("files")
    base = root / "data" / "medmnist" / "breastmnist"
    for ci, cat in enumerate(CLASSES):
        shade = 40 + 170 * ci
        for split, n, blue in (("train", 3, None), ("test", 1, 200)):
            os.makedirs(base / split / cat)
            for k in range(n):
                Image.new("RGB", (20, 20), (shade, shade // 2, 10 + k if blue is None else blue)
                          ).save(base / split / cat / f"img_{k}.png")
    ckpt = j_write_synth(str(root / "ckpt"), JPipelineConfig.sdxl_tiny(sample_size=SAMPLE),
                         seed=5)
    jg = j_create_model("tiny_resnet", num_classes=2, input_size=SAMPLE)
    state = state_dict_from_jax(jax.tree.map(np.asarray, jg.variables), tiny_resnet_config(2))
    torch.save({"state_dict": {"module." + k: v for k, v in state.items()}},
               str(root / "guide.pth.tar"))
    return str(root / "data"), ckpt, str(root / "guide.pth.tar")


def _argv(toy_files, extra=()):
    data, ckpt, guide = toy_files
    return ["-d", "breastmnist", "--data_root", data, "--tiny", "--model", "sdxl",
            "--sd_checkpoint", ckpt, "--encoder_weight_path", guide,
            "--guidance_type", "transform_guidance", "--guidance_step", "4",
            "--guidance_period", "2", "--K", "2", "--num_images_per_prompt", "2",
            "--train_batch_size", "2", "--max_units", "4", "--output_dir", "out",
            "--seed", "0", "--resolution", str(SAMPLE), *extra]


def _outputs(workdir):
    return sorted(os.path.relpath(os.path.join(d, f), workdir)
                  for d, _, fs in os.walk(workdir) for f in fs)


@pytest.fixture(scope="module")
def encoders(toy_files):
    """((JAX pipeline, its text fn), (the port's pipeline, its text fn)),
    each built by its CLI from the same argv, and the image encoders."""
    _, ckpt, _ = toy_files
    jpipe = j_cli.build_pipeline(j_cli.parse_args(_argv(toy_files)))
    os.environ["DISTDIFF_PLATFORM"] = "cpu"
    try:
        tpipe = cli.build_pipeline(cli.parse_args(_argv(toy_files)))
    finally:
        os.environ.pop("DISTDIFF_PLATFORM")
    jtok = j_load_tokenizer(None, max_length=16, vocab_size=1000, checkpoint_dir=ckpt)
    ttok = load_tokenizer(None, max_length=16, vocab_size=1000, checkpoint_dir=ckpt)
    assert type(ttok).__name__ == type(jtok).__name__ == "CLIPTokenizer"

    def jax_text(prompts):
        ids = jnp.asarray(jtok(list(prompts)))
        return jpipe.encode_text_pair(jpipe.params, ids, ids)

    def port_text(prompts):
        ids = torch.from_numpy(np.asarray(ttok(list(prompts)))).long()
        return cond_asarray(tpipe.encode_text_pair(ids, ids))

    def jax_images(im):
        return np.asarray(jpipe.encode_images(jpipe.params, jnp.asarray(im)))

    def port_images(im):
        return tpipe.encode_images(torch.from_numpy(im)).numpy()

    return (jpipe, jax_text, jax_images), (tpipe, port_text, port_images)


def test_the_clis_build_the_same_sdxl_conditioning(encoders):
    (jpipe, jt, _), (tpipe, tt, _) = encoders
    assert tpipe.is_sdxl and tpipe.config.unet.addition_embed_dim == 64
    assert tpipe.config.sample_size == SAMPLE and tpipe.guidance_cfg.guide_input_size == SAMPLE
    prompts = ["a breast ultrasound image of alpha.", ""]
    got, want = tt(prompts), jt(prompts)
    assert got["ctx"].shape == (2, 16, 48) and got["add"].shape == (2, 64)
    for k in ("ctx", "add"):
        # fp32 towers on the same checkpoint and ids: summation order only
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=1e-5, rtol=0)


def test_sd_dataset_and_collate_on_dict_conditioning(toy_files, encoders, tmp_path):
    data = toy_files[0]
    (_, jt, ji), (_, tt, ti) = encoders
    kw = dict(size=SAMPLE, data_root=data, encode_batch=2)
    want = JSDDataset("breastmnist", jt, ji, cache_root=str(tmp_path / "jax"), **kw)
    got = SDDataset("breastmnist", tt, ti, cache_root=str(tmp_path / "port"), model="sdxl",
                    **kw)
    # the same contents under the JAX package's name plus the model
    ckpt = "CompVis/stable-diffusion-v1-4"
    assert got.cache_path(ckpt, "port") == want._cache_path(ckpt, "port").replace(
        ".npy", "_sdxl.npy")
    np.testing.assert_array_equal(np.load(got.cache_path(ckpt, str(tmp_path / "port"))),
                                  got.latents)
    assert set(got.class_embeds) == {"ctx", "add"}
    assert got.class_embeds["ctx"].shape == (2, 16, 48)
    for k in ("ctx", "add"):
        np.testing.assert_allclose(got.class_embeds[k], np.asarray(want.class_embeds[k]),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(got.uncond_embed[k], np.asarray(want.uncond_embed[k]),
                                   atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.latents, want.latents, atol=1e-5, rtol=0)
    items = [got[i] for i in range(len(got))]
    batch, jbatch = collate_sd(items), j_collate_sd([want[i] for i in range(len(want))])
    assert batch["cond"]["ctx"].shape == (6, 16, 48) and batch["uncond"]["add"].shape == (6, 64)
    for side in ("cond", "uncond"):
        for k in ("ctx", "add"):
            assert isinstance(batch[side][k], np.ndarray)
            np.testing.assert_allclose(batch[side][k], np.asarray(jbatch[side][k]), atol=1e-5,
                                       rtol=0)
    assert list(batch["targets"]) == list(jbatch["targets"]) == [0, 0, 0, 1, 1, 1]


def test_tiny_sdxl_cli_matches_the_jax_cli(toy_files, tmp_path, monkeypatch):
    jwork = tmp_path / "jax"
    os.makedirs(jwork)
    monkeypatch.chdir(jwork)
    jstats = j_cli.main(_argv(toy_files))
    monkeypatch.setenv("DISTDIFF_PLATFORM", "cpu")
    port = tmp_path / "port"
    os.makedirs(port)
    monkeypatch.chdir(port)
    stats = cli.main(_argv(toy_files))
    assert stats["written"] == jstats["written"] == 4
    # the same PNGs, latent cache and prototype cache, at the same paths,
    # but for the latent cache, whose name the port keys on the model
    lat = "save/vae_embedding/breastmnist/CompVis--stable-diffusion-v1-4/image_latents_32.npy"
    port_lat = lat.replace(".npy", "_sdxl.npy")
    got = _outputs(str(port))
    assert got == sorted(port_lat if p == lat else p for p in _outputs(str(jwork)))
    pngs = [p for p in got if p.endswith(".png")]
    assert len(pngs) == 4 and all("_expand_" in p for p in pngs)
    for p in pngs:
        img, ref = read_png(os.path.join(port, p)), read_png(os.path.join(jwork, p))
        assert img.shape == ref.shape == (SAMPLE, SAMPLE, 3) and img.max() > img.min()
    # fp32 VAE encoders on the same checkpoint and crops: summation order
    np.testing.assert_allclose(np.load(port / port_lat), np.load(jwork / lat), atol=1e-5,
                               rtol=0)
    proto = "save/prototypes/tiny_resnet/breastmnist/class_wise_prototype_K2.npz"
    got_p, want_p = np.load(port / proto), np.load(jwork / proto)
    for key in ("global_prototypes", "local_prototypes"):
        np.testing.assert_allclose(got_p[key], want_p[key], atol=1e-5, rtol=0)
