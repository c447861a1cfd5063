"""The port's guided expansion against the JAX package, end to end, at the
tiny config (``PipelineConfig.tiny(sample_size=48)``: a 24^2 latent of 576
tokens, so attention sees kv > 256 as it does on the card; on the CPU both
packages take their plain attention).

Both pipelines hold the same weights (the JAX init, carried over with
``state_dict_from_jax``), the same prototypes and the same random draws (the
JAX package's own img2img noise and gamma0/beta0, handed to the port's
``expand``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distdiff_tpu.config import GuidanceConfig as JGuidanceConfig
from distdiff_tpu.config import PipelineConfig as JPipelineConfig
from distdiff_tpu.guidance import transform_guidance as j_transform_guidance
from distdiff_tpu.models.guide import create_model as j_create_model
from distdiff_tpu.sampling import ExpansionPipeline as JExpansionPipeline
from distdiff_tpu.sampling import SamplerConfig as JSamplerConfig
from distdiff_tpu.sampling.sampler import denoise_range as j_denoise_range
from distdiff_tpu.sampling.sampler import img2img_init as j_img2img_init
from distdiff_tpu_torch.config import GuidanceConfig, PipelineConfig
from distdiff_tpu_torch.models.guide import create_model
from distdiff_tpu_torch.models.guide.resnet import tiny_resnet_config
from distdiff_tpu_torch.sampling import ExpansionPipeline, SamplerConfig
from distdiff_tpu_torch.weights.from_jax import state_dict_from_jax
from torch_parity import jax_init_params

torch.set_num_threads(1)

SAMPLE = 48
GUIDE_KW = dict(guidance_step=4, guidance_period=2, K=2, guide_input_size=32, rho=0.5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pipelines():
    """Both pipelines, built once: the guidance type is swapped per test."""
    rng = np.random.RandomState(0)
    j_guide = j_create_model("tiny_resnet", num_classes=3, input_size=32)
    gp = rng.randn(3, j_guide.feature_dim).astype(np.float32)
    lp = rng.randn(3, 2, j_guide.feature_dim).astype(np.float32)
    jcfg = JPipelineConfig.tiny(sample_size=SAMPLE)
    jpipe = JExpansionPipeline.create(
        jcfg, params=jax_init_params(jcfg),
        sampler_cfg=JSamplerConfig(guidance_scale=3.0),
        guidance_cfg=JGuidanceConfig(**GUIDE_KW),
        guide=j_guide, global_protos=gp, local_protos=lp, strength=0.5)
    params = jpipe.full_params()

    cfg = PipelineConfig.tiny(sample_size=SAMPLE)
    guide = create_model("tiny_resnet", num_classes=3, device="cpu")
    guide.module.load_state_dict(
        state_dict_from_jax(_np(params["guide"]), tiny_resnet_config(3)))
    tpipe = ExpansionPipeline.create(
        cfg, sampler_cfg=SamplerConfig(guidance_scale=3.0),
        guidance_cfg=GuidanceConfig(**GUIDE_KW),
        guide=guide, global_protos=gp, local_protos=lp, strength=0.5,
        device="cpu")
    tpipe.unet.load_state_dict(state_dict_from_jax(_np(params["unet"]), cfg.unet))
    tpipe.vae.load_state_dict(state_dict_from_jax(_np(params["vae"]), cfg.vae))
    return jpipe, params, tpipe


def _inputs(ls):
    rng = np.random.RandomState(1)
    lat = (rng.randn(2, ls, ls, 4) * 0.2).astype(np.float32)
    cond = rng.randn(2, 8, 32).astype(np.float32)
    uncond = rng.randn(2, 8, 32).astype(np.float32)
    return lat, cond, uncond, np.array([1, 2])


def _jax_draws(key, lat):
    """The draws JAX's expand makes from one key (pipeline.py, sampler.py,
    optimize.py): img2img noise, gamma0, beta0."""
    k_noise, k_guide = jax.random.split(key)
    noise = jax.random.normal(k_noise, lat.shape, jnp.float32)
    k_gamma, k_beta = jax.random.split(k_guide)
    shape = (lat.shape[0], 1, 1, lat.shape[-1])
    gamma0 = jax.random.uniform(k_gamma, shape, jnp.float32)
    beta0 = jax.random.normal(k_beta, shape, jnp.float32)
    return k_guide, [np.asarray(a) for a in (noise, gamma0, beta0)]


@pytest.mark.parametrize("gtype", ["transform_guidance", "direct_guidance", "none"])
def test_expand_matches_jax(pipelines, gtype):
    jpipe, params, tpipe = pipelines
    jpipe.guidance_cfg = dataclasses.replace(jpipe.guidance_cfg, guidance_type=gtype)
    tpipe.guidance_cfg = dataclasses.replace(tpipe.guidance_cfg, guidance_type=gtype)
    lat, cond, uncond, targets = _inputs(tpipe.config.latent_size)
    key = jax.random.key(7)
    k_guide, (noise, gamma0, beta0) = _jax_draws(key, lat)

    ref = np.asarray(jax.jit(jpipe.make_expand_fn())(
        params, jnp.asarray(lat), jnp.asarray(cond), jnp.asarray(uncond),
        jnp.asarray(targets), key))
    def t(a):
        return torch.from_numpy(np.array(a))

    img, aux = tpipe.make_expand_fn()(
        t(lat), t(cond), t(uncond), t(targets), noise=t(noise),
        gamma0=t(gamma0), beta0=t(beta0), return_aux=True)
    img = img.numpy()
    assert img.shape == ref.shape == (2, SAMPLE, SAMPLE, 3)
    # images in [0, 1] after 5 plain steps, the guidance backward (rho 0.5)
    # and a VAE decode, all fp32: 2e-4 covers summation-order differences
    # between XLA's and torch's CPU convolutions and matmuls
    np.testing.assert_allclose(img, ref, atol=2e-4, rtol=0)

    if gtype == "transform_guidance":
        sched = jpipe.sched
        g0 = 6  # 10-step plan, guidance_step 4
        x, start = j_img2img_init(sched, jnp.asarray(lat),
                                  jax.random.split(key)[0], 0.5)
        eps_fn = jpipe.eps_fn()
        x = j_denoise_range(sched, eps_fn, params, x, jnp.asarray(cond),
                            jnp.asarray(uncond), start, g0)
        ctx = jpipe.guidance_context()
        updated, score = jax.jit(
            lambda p, x, c, u, tg, k: j_transform_guidance(ctx, p, x, c, u, tg, k, g0))(
            params, x, jnp.asarray(cond), jnp.asarray(uncond), jnp.asarray(targets),
            k_guide)
        np.testing.assert_allclose(aux["latents_before"].numpy(), np.asarray(x),
                                   atol=1e-5, rtol=0)
        # the energy is a norm of 64-wide guide features (~O(10)): relative
        np.testing.assert_allclose(aux["score"].numpy(), np.asarray(score),
                                   rtol=1e-5)
        # latents ~O(1) after one SGD step on gamma/beta (rho 0.5)
        np.testing.assert_allclose(aux["latents_after"].numpy(),
                                   np.asarray(updated), atol=2e-5, rtol=0)
        assert np.abs(aux["latents_after"].numpy() - np.asarray(x)).max() > 1e-6
