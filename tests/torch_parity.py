"""Helpers shared by the port's parity tests of the tiny expansion: a JAX
pipeline and the port's on the JAX package's weights, guide and prototypes,
the inputs, and the JAX expand's own random draws."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from distdiff_tpu.config import GuidanceConfig as JGuidanceConfig
from distdiff_tpu.models.guide import create_model as j_create_model
from distdiff_tpu.sampling import ExpansionPipeline as JExpansionPipeline
from distdiff_tpu.sampling import SamplerConfig as JSamplerConfig
from distdiff_tpu_torch.config import GuidanceConfig
from distdiff_tpu_torch.models.guide import create_model
from distdiff_tpu_torch.models.guide.resnet import tiny_resnet_config
from distdiff_tpu_torch.sampling import ExpansionPipeline, SamplerConfig
from distdiff_tpu_torch.weights.from_jax import state_dict_from_jax

GUIDE_KW = dict(guidance_step=4, guidance_period=2, K=2, guide_input_size=32, rho=0.5)


def tiny_pipelines(jcfg, tcfg, guide_kw=GUIDE_KW, params=None):
    """(jpipe, numpy params, tpipe): both guided by a 3-class tiny_resnet
    with seeded prototypes, CFG scale 3, strength 0.5; the port's pipeline
    on the CPU holding the JAX init's UNet and VAE. With ``params`` (a JAX
    parameter tree), the JAX pipeline holds those and the port's models
    keep their own weights: the caller loads them."""
    rng = np.random.RandomState(0)
    j_guide = j_create_model("tiny_resnet", num_classes=3, input_size=guide_kw["guide_input_size"])
    gp = rng.randn(3, j_guide.feature_dim).astype(np.float32)
    lp = rng.randn(3, guide_kw["K"], j_guide.feature_dim).astype(np.float32)
    given = params is not None
    jpipe = JExpansionPipeline.create(
        jcfg, params=params, sampler_cfg=JSamplerConfig(guidance_scale=3.0),
        guidance_cfg=JGuidanceConfig(**guide_kw), guide=j_guide,
        global_protos=gp, local_protos=lp, strength=0.5)
    params = jax.tree.map(np.asarray, jpipe.full_params())
    guide = create_model("tiny_resnet", num_classes=3, device="cpu")
    guide.module.load_state_dict(state_dict_from_jax(params["guide"], tiny_resnet_config(3)))
    tpipe = ExpansionPipeline.create(
        tcfg, sampler_cfg=SamplerConfig(guidance_scale=3.0),
        guidance_cfg=GuidanceConfig(**guide_kw), guide=guide,
        global_protos=gp, local_protos=lp, strength=0.5, device="cpu")
    if given:
        return jpipe, params, tpipe
    tpipe.unet.load_state_dict(state_dict_from_jax(params["unet"], tcfg.unet))
    tpipe.vae.load_state_dict(state_dict_from_jax(params["vae"], tcfg.vae))
    return jpipe, params, tpipe


def inputs(latent_size, ctx_dim=32, seed=1):
    """Latents, cond, uncond ([2, 8, ctx_dim]) and targets, as numpy."""
    rng = np.random.RandomState(seed)
    lat = (rng.randn(2, latent_size, latent_size, 4) * 0.2).astype(np.float32)
    cond = rng.randn(2, 8, ctx_dim).astype(np.float32)
    uncond = rng.randn(2, 8, ctx_dim).astype(np.float32)
    return lat, cond, uncond, np.array([1, 2])


def jax_draws(key, lat):
    """The draws the JAX expand (and SplitExpand) makes from one key:
    img2img noise, gamma0, beta0, as writable numpy arrays."""
    k_noise, k_guide = jax.random.split(key)
    noise = jax.random.normal(k_noise, lat.shape, jnp.float32)
    k_gamma, k_beta = jax.random.split(k_guide)
    shape = (lat.shape[0], 1, 1, lat.shape[-1])
    return [np.array(a) for a in (noise, jax.random.uniform(k_gamma, shape, jnp.float32),
                                  jax.random.normal(k_beta, shape, jnp.float32))]


def run_both(jpipe, params, tpipe, path, key=7, seed=1):
    """The JAX pipeline's and the port's images (numpy) on the same inputs
    and draws, through ``make_expand_fn`` (path "fused") or ``SplitExpand``
    (path "split")."""
    lat, cond, uncond, targets = inputs(tpipe.config.latent_size,
                                        tpipe.config.unet.cross_attention_dim, seed)
    key = jax.random.key(key)
    kw = dict(zip(("noise", "gamma0", "beta0"),
                  (torch.from_numpy(a) for a in jax_draws(key, lat))))
    jargs = (params, jnp.asarray(lat), jnp.asarray(cond), jnp.asarray(uncond),
             jnp.asarray(targets), key)
    targs = [torch.from_numpy(a) for a in (lat, cond, uncond, targets)]
    if path == "fused":
        ref = np.asarray(jax.jit(jpipe.make_expand_fn())(*jargs))
        got = tpipe.make_expand_fn()(*targs, **kw)
    else:
        ref = np.asarray(jpipe.make_split_expand()(*jargs))
        got = tpipe.make_split_expand()(*targs, **kw)
    return ref, got.numpy(), (targs, kw)
