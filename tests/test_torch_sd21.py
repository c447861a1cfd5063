"""SD-2.1 in the port: a tiny SD-2.1-shaped pipeline (v-prediction, linear
projections, per-block heads of one width, the gelu text tower) through
both packages from one synth checkpoint written in the SD-2.1 layout and
loaded strictly by both converters, and the published geometry's parameter
counts from its shapes alone."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import run_both, tiny_pipelines

from distdiff_tpu.config import PipelineConfig as JPipelineConfig
from distdiff_tpu.weights import sd15_geometry as j_geometry
from distdiff_tpu.weights.convert import convert_sd_checkpoint
from distdiff_tpu.weights.synth import write_synth_checkpoint as j_write_synth
from distdiff_tpu_torch.config import PipelineConfig, TextEncoderConfig
from distdiff_tpu_torch.models import CLIPTextEncoder, HashTokenizer, UNet2DConditionModel
from distdiff_tpu_torch.weights import sd15_geometry as geometry
from distdiff_tpu_torch.weights.convert import load_sd_checkpoint
from distdiff_tpu_torch.weights.safetensors import load_file
from distdiff_tpu_torch.weights.synth import write_synth_checkpoint

torch.set_num_threads(1)

SAMPLE = 32


def _tiny_sd21(pkg_config):
    """The tiny config in SD-2.1's shape: heads 2/4 over widths 32/64 (16
    wide each, as SD-2.1's are 64 at every block), linear projections, the
    gelu tower, v-prediction."""
    cfg = pkg_config.tiny(sample_size=SAMPLE)
    return dataclasses.replace(
        cfg, prediction_type="v_prediction",
        unet=dataclasses.replace(cfg.unet, num_attention_heads=(2, 4), linear_projection=True),
        text_encoder=dataclasses.replace(cfg.text_encoder, activation="gelu"))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    tcfg = _tiny_sd21(PipelineConfig)
    path = write_synth_checkpoint(str(tmp_path_factory.mktemp("sd21")), tcfg, seed=3,
                                  scale=0.1, dtype=np.float32, tokenizer=False)
    return path, tcfg


def test_the_synth_checkpoint_is_the_jax_writers(checkpoint, tmp_path):
    path, _ = checkpoint
    jcfg = _tiny_sd21(JPipelineConfig)
    jpath = j_write_synth(str(tmp_path), jcfg, seed=3, scale=0.1, dtype=np.float32,
                          tokenizer=False)
    for sub, name in (("unet", "diffusion_pytorch_model.safetensors"),
                      ("vae", "diffusion_pytorch_model.safetensors"),
                      ("text_encoder", "model.safetensors")):
        got, want = load_file(f"{path}/{sub}/{name}"), load_file(f"{jpath}/{sub}/{name}")
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    unet = load_file(f"{path}/unet/diffusion_pytorch_model.safetensors")
    # SD-2.x's layout: linear projections [C, C]
    assert tuple(unet["down_blocks.0.attentions.0.proj_in.weight"].shape) == (32, 32)


@pytest.fixture(scope="module")
def pipelines(checkpoint):
    path, tcfg = checkpoint
    jcfg = _tiny_sd21(JPipelineConfig)
    jparams = convert_sd_checkpoint(path, config=jcfg)  # strict
    jpipe, params, tpipe = tiny_pipelines(jcfg, tcfg, params=jparams)
    loaded = load_sd_checkpoint(path, tpipe)  # strict
    assert loaded["unet"] == len(tpipe.unet.state_dict())
    return jpipe, jax.tree.map(np.asarray, jpipe.full_params()), tpipe


def test_text_tower_matches_jax(pipelines):
    jpipe, params, tpipe = pipelines
    ids = HashTokenizer(vocab_size=1000, max_length=16)(["a photo of an owl", ""])
    want = np.asarray(jax.jit(lambda p, i: jpipe.encode_text(p, i))(params, jnp.asarray(ids)))
    got = tpipe.encode_text(torch.from_numpy(ids).long())
    assert tpipe.text_encoder.config.activation == "gelu"
    # fp32 towers on the same weights: summation order only
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_guided_expand_matches_jax(pipelines):
    jpipe, params, tpipe = pipelines
    ref, got, _ = run_both(jpipe, params, tpipe, "fused")
    assert tpipe.sched.prediction_type == "v_prediction"
    assert got.shape == ref.shape == (2, SAMPLE, SAMPLE, 3)
    # fp32 throughout, as the SD-1.x expand of test_torch_guided_expand.py
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)


def _count(shapes):
    return sum(math.prod(s) for s in shapes.values())


def test_published_geometry_counts_without_allocating():
    unet = geometry.sd15_unet_state_shapes(ctx=1024, linear_proj=True)
    t = TextEncoderConfig.sd21()
    text = geometry.sd15_text_state_shapes(d=t.hidden_size, ff=t.hidden_size * t.mlp_ratio,
                                           layers=t.num_layers, vocab=t.vocab_size,
                                           pos=t.max_length)
    assert _count(unet) == geometry.PARAM_TOTALS["sd21_unet"] == \
        j_geometry.PARAM_TOTALS["sd21_unet"] == 865_910_724
    assert _count(text) == geometry.PARAM_TOTALS["sd21_text"] == \
        j_geometry.PARAM_TOTALS["sd21_text"] == 340_387_840
    assert unet == j_geometry.sd15_unet_state_shapes(ctx=1024, linear_proj=True)
    # the port's modules at PipelineConfig.sd21(), built on the meta device
    # (no storage), hold exactly those keys and shapes
    cfg = PipelineConfig.sd21()
    assert cfg.sample_size == 768 and cfg.latent_size == 96
    for want, module in ((unet, UNet2DConditionModel(cfg.unet, device="meta")),
                         (text, CLIPTextEncoder(cfg.text_encoder, device="meta"))):
        assert {k: tuple(v.shape) for k, v in module.state_dict().items()} == want
    heads = [cfg.unet.heads_at(b) for b in range(4)]
    assert heads == [5, 10, 20, 20]
    assert {c // h for c, h in zip(cfg.unet.block_out_channels, heads)} == {64}
