"""The front of the port's expansion path at the tiny config
(``PipelineConfig.tiny(sample_size=32)``): ``encode_images`` and
``encode_text`` against the JAX pipeline's on the same weights;
``SplitExpand`` against the port's own ``make_expand_fn`` (held against the
JAX package in ``test_torch_guided_expand.py``) on the same draws, its
``guide_chunk``/``decode_chunk`` against the unchunked call, and its
per-unit draws; the manifest and the stdlib PNG writer against the JAX
package's; and ``ExpansionDriver`` end to end on the CPU."""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from distdiff_tpu.config import PipelineConfig as JPipelineConfig
from distdiff_tpu.parallel.driver import save_png as j_save_png
from distdiff_tpu.parallel.manifest import build_manifest as j_build_manifest
from distdiff_tpu.parallel.manifest import chunk_units as j_chunk_units
from distdiff_tpu.sampling import ExpansionPipeline as JExpansionPipeline
from distdiff_tpu_torch.config import GuidanceConfig, PipelineConfig
from distdiff_tpu_torch.models import HashTokenizer
from distdiff_tpu_torch.models.guide import create_model
from distdiff_tpu_torch.models.init import init_weights
from distdiff_tpu_torch.parallel import (
    ExpansionDriver,
    build_manifest,
    chunk_units,
    read_png,
    save_png,
    split_range,
)
from distdiff_tpu_torch.parallel.driver import unit_seed
from distdiff_tpu_torch.sampling import ExpansionPipeline, SamplerConfig, SplitExpand
from distdiff_tpu_torch.weights.from_jax import state_dict_from_jax

torch.set_num_threads(1)

SAMPLE = 32
GUIDE_KW = dict(guidance_step=4, guidance_period=2, K=2, guide_input_size=32, rho=0.5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pipelines():
    """The JAX pipeline (no guide) and the port's on the same weights, and
    a guided port pipeline for the split tests."""
    jpipe = JExpansionPipeline.create(JPipelineConfig.tiny(sample_size=SAMPLE))
    params = _np(jpipe.params)
    cfg = PipelineConfig.tiny(sample_size=SAMPLE)
    gen = torch.Generator().manual_seed(0)
    guide = create_model("tiny_resnet", num_classes=3, device="cpu")
    init_weights(guide.module, gen)
    fd = guide.feature_dim
    tpipe = ExpansionPipeline.create(
        cfg, sampler_cfg=SamplerConfig(guidance_scale=3.0),
        guidance_cfg=GuidanceConfig(**GUIDE_KW), guide=guide,
        global_protos=torch.randn(3, fd, generator=gen),
        local_protos=torch.randn(3, 2, fd, generator=gen), strength=0.5, device="cpu")
    tpipe.unet.load_state_dict(state_dict_from_jax(params["unet"], cfg.unet))
    tpipe.vae.load_state_dict(state_dict_from_jax(params["vae"], cfg.vae))
    tpipe.text_encoder.load_state_dict(state_dict_from_jax(params["text"], cfg.text_encoder))
    return jpipe, tpipe


def _images(n, seed):
    return np.random.RandomState(seed).uniform(-1, 1, (n, SAMPLE, SAMPLE, 3)).astype(np.float32)


def test_encode_images_matches_jax(pipelines):
    jpipe, tpipe = pipelines
    img = _images(2, 0)
    want = np.asarray(jax.jit(lambda p, x: jpipe.encode_images(p, x))(
        jpipe.params, jnp.asarray(img)))
    got = tpipe.encode_images(torch.from_numpy(img))
    assert got.shape == want.shape == (2, SAMPLE // 2, SAMPLE // 2, 4)
    # fp32 VAE encoder (posterior mean x 0.18215): summation order only
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # a sample: the mean plus exp(logvar / 2) times the generator's noise
    sample = tpipe.encode_images(torch.from_numpy(img), torch.Generator().manual_seed(3))
    mean, logvar = tpipe.vae.encode_moments(torch.from_numpy(img))
    noise = torch.randn(mean.shape, generator=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(
        sample.numpy(), ((mean + torch.exp(0.5 * logvar) * noise) * 0.18215).detach().numpy(),
        atol=1e-6, rtol=0)


def test_encode_text_matches_jax(pipelines):
    jpipe, tpipe = pipelines
    ids = HashTokenizer(vocab_size=1000, max_length=16)(["a photo of a dog", ""])
    want = np.asarray(jax.jit(lambda p, i: jpipe.encode_text(p, i))(
        jpipe.params, jnp.asarray(ids)))
    got = tpipe.encode_text(torch.from_numpy(ids).long())
    assert got.shape == (2, 16, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _inputs(tpipe, b=2, seed=1):
    rng = np.random.RandomState(seed)
    ls = tpipe.config.latent_size
    lat = torch.from_numpy((rng.randn(b, ls, ls, 4) * 0.2).astype(np.float32))
    cond = torch.from_numpy(rng.randn(b, 16, 32).astype(np.float32))
    uncond = torch.from_numpy(rng.randn(b, 16, 32).astype(np.float32))
    return lat, cond, uncond, torch.tensor([1, 2, 0, 1][:b])


@pytest.mark.parametrize("gtype", ["transform_guidance", "direct_guidance", "none"])
def test_split_expand_equals_make_expand_fn(pipelines, gtype):
    tpipe = dataclasses.replace(pipelines[1], guidance_cfg=dataclasses.replace(
        pipelines[1].guidance_cfg, guidance_type=gtype))
    lat, cond, uncond, targets = _inputs(tpipe)
    noise, gamma0, beta0 = tpipe.draw_inputs(lat, torch.Generator().manual_seed(5))
    kw = dict(noise=noise, gamma0=gamma0, beta0=beta0)
    want = tpipe.make_expand_fn()(lat, cond, uncond, targets, **kw)
    split = tpipe.make_split_expand()
    assert isinstance(split, SplitExpand) and split.guided == (gtype != "none")
    got = split(lat, cond, uncond, targets, **kw)
    assert got.shape == (2, SAMPLE, SAMPLE, 3)
    # the same operations on the same batch, in the same order
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


def test_chunked_split_expand_equals_unchunked(pipelines):
    tpipe = pipelines[1]
    lat, cond, uncond, targets = _inputs(tpipe, b=4, seed=2)
    kw = dict(zip(("noise", "gamma0", "beta0"),
                  tpipe.draw_inputs(lat, torch.Generator().manual_seed(6))))
    want = tpipe.make_split_expand()(lat, cond, uncond, targets, **kw)
    got = tpipe.make_split_expand(guide_chunk=1, decode_chunk=2)(
        lat, cond, uncond, targets, **kw)
    # samples are independent; CPU kernels may block a batch of 1 and of 4
    # differently, so summation order differs: 1e-5 on images in [0, 1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="multiple"):
        tpipe.make_split_expand(guide_chunk=3)(lat, cond, uncond, targets, **kw)


def test_unit_draws_do_not_depend_on_the_batch(pipelines):
    tpipe = pipelines[1]
    lat, cond, uncond, targets = _inputs(tpipe, b=2, seed=3)
    split = tpipe.make_split_expand(guide_chunk=1)
    pair = split(lat, cond, uncond, targets,
                 [torch.Generator().manual_seed(s) for s in (11, 12)])
    alone = split(lat[1:], cond[1:], uncond[1:], targets[1:], [torch.Generator().manual_seed(12)])
    np.testing.assert_allclose(pair[1:].numpy(), alone.numpy(), atol=1e-5, rtol=0)
    assert np.abs(pair[0].numpy() - pair[1].numpy()).max() > 1e-3
    with pytest.raises(ValueError, match="generator"):
        split(lat, cond, uncond, targets, [torch.Generator()])


def _dataset(n, classes=("cat", "dog", "owl")):
    paths = [f"/data/{classes[i % len(classes)]}/img{i:03d}.jpg" for i in range(n)]
    return paths, [i % len(classes) for i in range(n)], list(classes)


def test_manifest_matches_jax(tmp_path):
    paths, labels, classes = _dataset(11)
    per_item = [classes[lab] for lab in labels]
    out = str(tmp_path)
    os.makedirs(os.path.join(out, "dog"))
    open(os.path.join(out, "dog", "img001_expand_1.png"), "w").close()
    for split, total in ((0, 1), (1, 3), (2, 3)):
        got = build_manifest(paths, per_item, out, 3, 1, split, total)
        want = j_build_manifest(paths, per_item, out, 3, 1, split, total)
        assert [dataclasses.astuple(u) for u in got] == [dataclasses.astuple(u) for u in want]
        assert [([u.out_path for u in c], m) for c, m in chunk_units(got, 4)] == \
            [([u.out_path for u in c], m) for c, m in j_chunk_units(want, 4)]
    assert split_range(11, 2, 3) == (6, 11)
    assert len(build_manifest(paths, per_item, out, 3, 1, skip_existing=False)) == 22


def test_png_writer_matches_jax_pixels(tmp_path):
    img = np.random.RandomState(7).uniform(-0.1, 1.1, (9, 13, 3)).astype(np.float32)
    img[0, 0] = [0.0, 1.0, 0.5]
    save_png(str(tmp_path / "a" / "port.png"), img)
    j_save_png(str(tmp_path / "b" / "jax.png"), img)
    got = np.asarray(Image.open(tmp_path / "a" / "port.png"))
    want = np.asarray(Image.open(tmp_path / "b" / "jax.png"))
    assert got.dtype == np.uint8 and got.shape == (9, 13, 3)
    np.testing.assert_array_equal(got, want)  # the same rounding: exact
    np.testing.assert_array_equal(read_png(str(tmp_path / "a" / "port.png")), want)


def test_driver_writes_the_manifest_on_cpu(pipelines, tmp_path):
    tpipe = pipelines[1]
    paths, labels, classes = _dataset(3)
    lat, cond, uncond, _ = _inputs(tpipe, b=3, seed=4)
    items = [types.SimpleNamespace(latent=lat[i], cond=cond[i], uncond=uncond[i],
                                   target=labels[i]) for i in range(3)]
    sd = type("SD", (), {"image_paths": paths, "labels": labels, "class_names": classes,
                         "__getitem__": lambda self, i: items[i]})()
    split = tpipe.make_split_expand(guide_chunk=1)
    driver = ExpansionDriver(split, sd, str(tmp_path), batch_size=2, seed=9, device="cpu")
    try:
        stats = driver.run(num_images_per_prompt=2, max_units=5)
        assert stats["units"] == stats["written"] == 5 and stats["images_per_sec"] > 0
        files = sorted(os.path.relpath(os.path.join(d, f), tmp_path)
                       for d, _, fs in os.walk(tmp_path) for f in fs)
        assert files == ["cat/img000_expand_0.png", "cat/img000_expand_1.png",
                         "dog/img001_expand_0.png", "dog/img001_expand_1.png",
                         "owl/img002_expand_0.png"]
        png = read_png(str(tmp_path / "dog" / "img001_expand_1.png"))
        assert png.shape == (SAMPLE, SAMPLE, 3)
        # the unit's image is its batch-1 run with its own generator
        unit = build_manifest(paths, [classes[lab] for lab in labels], "x", 2)[3]
        alone = split(lat[1:2], cond[1:2], uncond[1:2], torch.tensor([labels[1]]),
                      [torch.Generator().manual_seed(unit_seed(9, unit))])
        want = np.clip(alone[0].numpy() * 255.0 + 0.5, 0, 255).astype(np.uint8)
        assert np.abs(png.astype(int) - want.astype(int)).max() <= 1
        assert driver.run(num_images_per_prompt=2)["units"] == 1  # the rest is skipped
    finally:
        driver.close()
