"""Helpers shared by the port's parity tests of the tiny expansion: a JAX
pipeline and the port's on the JAX package's weights, guide and prototypes,
the inputs, and the JAX expand's own random draws; and seeded variables for
a JAX guide module."""

import hashlib
import os
import tempfile

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


def jax_init_params(jcfg, seed=0):
    """``distdiff_tpu.sampling.pipeline.init_params`` of ``jcfg`` (its UNet,
    VAE and text encoder), as numpy: the JAX init's own values, which
    ``ExpansionPipeline.create(jcfg)`` would make. The processes of one
    test session share them: the first to need a configuration's runs the
    init programs and writes them to a ``.npz`` in a directory named by the
    session's ``PYTEST_XDIST_TESTRUNUID``, the others read that file (a
    JAX init of the tiny pipeline is 13-28 s, most of it tracing)."""
    from distdiff_tpu.models import AutoencoderKL, CLIPTextEncoder, UNet2DCondition
    from distdiff_tpu.sampling.pipeline import init_params

    assert jcfg.text_encoder_2 is None, "SD-1.x/2.x configurations only"
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    key = hashlib.sha1(repr((jcfg.unet, jcfg.vae, jcfg.text_encoder, seed)).encode())
    path = None if uid is None else os.path.join(
        tempfile.gettempdir(), f"distdiff-jax-init-{uid}", key.hexdigest()[:16] + ".npz")
    if path is not None and os.path.exists(path):
        tree = {}
        with np.load(path) as flat:
            for name in flat.files:
                *parents, leaf = name.split("/")
                node = tree
                for part in parents:
                    node = node.setdefault(part, {})
                node[leaf] = flat[name]
        return tree
    params = jax.tree.map(np.asarray, init_params(
        jcfg, UNet2DCondition(jcfg.unet), AutoencoderKL(jcfg.vae),
        CLIPTextEncoder(jcfg.text_encoder), seed))
    if path is not None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        part = f"{path}.{os.getpid()}.npz"
        np.savez(part, **flat_variables(params))
        os.replace(part, path)  # whole files only: a reader never sees a partial one
    return params


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
        jcfg, params=params if given else jax_init_params(jcfg),
        sampler_cfg=JSamplerConfig(guidance_scale=3.0),
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
    """The draws the JAX expand (and SplitExpand) makes from one key, or
    from a ``[B]`` array of per-sample keys: img2img noise, gamma0, beta0,
    as writable numpy arrays."""
    c = lat.shape[-1]
    if key.ndim >= 1:  # per-sample: fold_in 0 / 1 for noise / guide, then 0 / 1 again
        k_noise = jax.vmap(lambda k: jax.random.fold_in(k, 0))(key)
        k_guide = jax.vmap(lambda k: jax.random.fold_in(k, 1))(key)
        noise = jax.vmap(lambda k: jax.random.normal(k, lat.shape[1:], jnp.float32))(k_noise)
        gamma0 = jax.vmap(lambda k: jax.random.uniform(jax.random.fold_in(k, 0), (1, 1, c)))(
            k_guide)
        beta0 = jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, 1), (1, 1, c)))(
            k_guide)
        return [np.array(a) for a in (noise, gamma0, beta0)]
    k_noise, k_guide = jax.random.split(key)
    noise = jax.random.normal(k_noise, lat.shape, jnp.float32)
    k_gamma, k_beta = jax.random.split(k_guide)
    shape = (lat.shape[0], 1, 1, c)
    return [np.array(a) for a in (noise, jax.random.uniform(k_gamma, shape, jnp.float32),
                                  jax.random.normal(k_beta, shape, jnp.float32))]


def to_torch(x):
    """A numpy array, or a dict of them (SDXL's conditioning), as torch."""
    if isinstance(x, dict):
        return {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}
    return torch.from_numpy(np.asarray(x))


def run_both(jpipe, params, tpipe, path, key=7, seed=1, conds=None, split_kw=None,
             per_sample=False):
    """The JAX pipeline's and the port's images (numpy) on the same inputs
    and draws, through ``make_expand_fn`` (path "fused") or ``SplitExpand``
    (path "split", built by both with ``split_kw``: ``guide_chunk``,
    ``decode_chunk``). ``conds`` replaces the random text contexts with a
    given (cond, uncond) pair, numpy arrays or SDXL's dicts of them. The
    draws come from one key, or with ``per_sample`` (and always with
    ``split_kw``) from one key a sample, as the driver's work units draw."""
    lat, cond, uncond, targets = inputs(tpipe.config.latent_size,
                                        tpipe.config.unet.cross_attention_dim, seed)
    if conds is not None:
        cond, uncond = conds
    key = jax.random.key(key)
    if split_kw or per_sample:  # a chunked SplitExpand slices the keys with the batch
        key = jax.random.split(key, len(lat))
    kw = dict(zip(("noise", "gamma0", "beta0"),
                  (torch.from_numpy(a) for a in jax_draws(key, lat))))
    jargs = (params, jnp.asarray(lat), jax.tree.map(jnp.asarray, cond),
             jax.tree.map(jnp.asarray, uncond), jnp.asarray(targets), key)
    targs = [to_torch(a) for a in (lat, cond, uncond, targets)]
    if path == "fused":
        ref = np.asarray(jax.jit(jpipe.make_expand_fn())(*jargs))
        got = tpipe.make_expand_fn()(*targs, **kw)
    else:
        ref = np.asarray(jpipe.make_split_expand(**(split_kw or {}))(*jargs))
        got = tpipe.make_split_expand(**(split_kw or {}))(*targs, **kw)
    return ref, got.numpy(), (targs, kw)


def seeded_variables(jmodule, x, seed):
    """The JAX module's variable tree (shapes from ``jax.eval_shape``, no
    init program compiled) filled with seeded numpy draws: kernels normal
    over the square root of their fan-in, biases and BatchNorm shifts
    normal * 0.1, scales 1 + normal * 0.1, running means normal * 0.1,
    running variances uniform in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), jnp.asarray(x))

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            return rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape)
        if name == "scale":
            return 1 + 0.1 * rng.standard_normal(s.shape)
        return 0.1 * rng.standard_normal(s.shape)
    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def flat_variables(tree, prefix=""):
    """A variable tree as the JAX package's flat ``.npz`` keys
    (``params/conv1/kernel``)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_variables(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out
