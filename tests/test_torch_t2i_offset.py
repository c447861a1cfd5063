"""The port's ``text_to_img`` and ``offset_noise`` options against the JAX
package at the tiny config (``PipelineConfig.tiny(sample_size=32)``), on the
same weights and with the JAX side's own draws: the pure-noise start under
``text_to_img`` and the per-(sample, channel) offset of ``offset_noise``,
through ``make_expand_fn`` and ``SplitExpand``; ``guidance_active`` over a
grid; and the port's own draws of the offset."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distdiff_tpu.config import GuidanceConfig as JGuidanceConfig
from distdiff_tpu.config import PipelineConfig as JPipelineConfig
from distdiff_tpu.models.guide import create_model as j_create_model
from distdiff_tpu.sampling import ExpansionPipeline as JExpansionPipeline
from distdiff_tpu.sampling import SamplerConfig as JSamplerConfig
from distdiff_tpu.schedulers import build_schedule as j_build_schedule
from distdiff_tpu_torch.config import GuidanceConfig, PipelineConfig
from distdiff_tpu_torch.models.guide import create_model
from distdiff_tpu_torch.models.guide.resnet import tiny_resnet_config
from distdiff_tpu_torch.sampling import ExpansionPipeline, SamplerConfig, SplitExpand
from distdiff_tpu_torch.schedulers import make_schedule
from distdiff_tpu_torch.weights.from_jax import state_dict_from_jax

torch.set_num_threads(1)

SAMPLE = 32
GUIDE_KW = dict(guidance_step=4, guidance_period=2, K=2, guide_input_size=32, rho=0.5)
OFFSET_FOLD = 0x0FF5E7  # the JAX sampler's fold-in constant for the offset draw


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def pipelines():
    rng = np.random.RandomState(0)
    j_guide = j_create_model("tiny_resnet", num_classes=3, input_size=32)
    gp = rng.randn(3, j_guide.feature_dim).astype(np.float32)
    lp = rng.randn(3, 2, j_guide.feature_dim).astype(np.float32)
    jpipe = JExpansionPipeline.create(
        JPipelineConfig.tiny(sample_size=SAMPLE), sampler_cfg=JSamplerConfig(guidance_scale=3.0),
        guidance_cfg=JGuidanceConfig(**GUIDE_KW), guide=j_guide, global_protos=gp,
        local_protos=lp, strength=0.5)
    params = jpipe.full_params()
    cfg = PipelineConfig.tiny(sample_size=SAMPLE)
    guide = create_model("tiny_resnet", num_classes=3, device="cpu")
    guide.module.load_state_dict(state_dict_from_jax(_np(params["guide"]), tiny_resnet_config(3)))
    tpipe = ExpansionPipeline.create(
        cfg, sampler_cfg=SamplerConfig(guidance_scale=3.0), guidance_cfg=GuidanceConfig(**GUIDE_KW),
        guide=guide, global_protos=gp, local_protos=lp, strength=0.5, device="cpu")
    tpipe.unet.load_state_dict(state_dict_from_jax(_np(params["unet"]), cfg.unet))
    tpipe.vae.load_state_dict(state_dict_from_jax(_np(params["vae"]), cfg.vae))
    return jpipe, params, tpipe


def _inputs(ls):
    rng = np.random.RandomState(1)
    lat = (rng.randn(2, ls, ls, 4) * 0.2).astype(np.float32)
    cond = rng.randn(2, 16, 32).astype(np.float32)
    uncond = rng.randn(2, 16, 32).astype(np.float32)
    return lat, cond, uncond, np.array([1, 2])


def _jax_draws(key, lat, offset):
    """The draws JAX's expand makes from one key: the initial noise (with
    the offset exactly as ``sampler.img2img_init`` forms it), gamma0, beta0."""
    k_noise, k_guide = jax.random.split(key)
    noise = jax.random.normal(k_noise, lat.shape, jnp.float32)
    if offset:
        shape = (lat.shape[0], 1, 1, lat.shape[-1])
        noise = noise + 0.1 * jax.random.normal(
            jax.random.fold_in(k_noise, OFFSET_FOLD), shape, jnp.float32)
    k_gamma, k_beta = jax.random.split(k_guide)
    shape = (lat.shape[0], 1, 1, lat.shape[-1])
    gamma0 = jax.random.uniform(k_gamma, shape, jnp.float32)
    beta0 = jax.random.normal(k_beta, shape, jnp.float32)
    return [np.array(a) for a in (noise, gamma0, beta0)]


CASES = [("text_to_img", "transform_guidance"), ("text_to_img", "direct_guidance"),
         ("offset_noise", "transform_guidance")]
_REF = {}


def _jax_reference(pipelines, option, gtype):
    """The JAX expand's images (computed once per case)."""
    if (option, gtype) not in _REF:
        jpipe, params, tpipe = pipelines
        jp = dataclasses.replace(jpipe, offset_noise=option == "offset_noise",
                                 guidance_cfg=dataclasses.replace(jpipe.guidance_cfg,
                                                                  guidance_type=gtype))
        lat, cond, uncond, targets = _inputs(tpipe.config.latent_size)
        fn = jax.jit(jp.make_expand_fn(text_to_img=option == "text_to_img"))
        _REF[option, gtype] = np.asarray(fn(params, *(jnp.asarray(a) for a in (
            lat, cond, uncond, targets)), jax.random.key(7)))
    return _REF[option, gtype]


@pytest.mark.parametrize("entry", ["make_expand_fn", "SplitExpand"])
@pytest.mark.parametrize("option,gtype", CASES)
def test_option_matches_jax(pipelines, option, gtype, entry):
    jpipe, params, tpipe = pipelines
    ref = _jax_reference(pipelines, option, gtype)
    tp = dataclasses.replace(tpipe, offset_noise=option == "offset_noise",
                             guidance_cfg=dataclasses.replace(tpipe.guidance_cfg,
                                                              guidance_type=gtype))
    text_to_img = option == "text_to_img"
    assert tp.guidance_active(text_to_img=text_to_img)
    lat, cond, uncond, targets = _inputs(tp.config.latent_size)
    noise, gamma0, beta0 = _jax_draws(jax.random.key(7), lat, option == "offset_noise")
    fn = (tp.make_expand_fn(text_to_img=text_to_img) if entry == "make_expand_fn"
          else tp.make_split_expand(text_to_img=text_to_img))
    assert isinstance(fn, SplitExpand) == (entry == "SplitExpand")
    got = fn(*(torch.from_numpy(np.array(a)) for a in (lat, cond, uncond, targets)),
             noise=torch.from_numpy(noise), gamma0=torch.from_numpy(gamma0),
             beta0=torch.from_numpy(beta0)).numpy()
    assert got.shape == ref.shape == (2, SAMPLE, SAMPLE, 3)
    # images in [0, 1] after up to 10 fp32 steps, the guidance backward (rho
    # 0.5) and the decode: summation order only, as test_torch_guided_expand
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)
    # the option changes the images: against the plain img2img run
    plain = tpipe.make_expand_fn()(*(torch.from_numpy(np.array(a)) for a in (
        lat, cond, uncond, targets)), noise=torch.from_numpy(
            _jax_draws(jax.random.key(7), lat, False)[0]),
        gamma0=torch.from_numpy(gamma0), beta0=torch.from_numpy(beta0)).numpy()
    assert np.abs(got - plain).max() > 1e-3


def test_guidance_active_matches_jax_over_a_grid(pipelines):
    jpipe, _, tpipe = pipelines
    checked = {}
    for steps in (10, 25, 50):
        jsched, tsched = j_build_schedule("ddim", steps), make_schedule(steps)
        for strength in (0.05, 0.3, 0.5, 0.75, 0.9, 1.0):
            for step in (1, 2, 4, 8, 9) + ((20, 24) if steps > 10 else ()):
                for gtype in ("transform_guidance", "direct_guidance", "none"):
                    for text_to_img in (False, True):
                        jp = dataclasses.replace(
                            jpipe, sched=jsched, strength=strength,
                            guidance_cfg=dataclasses.replace(
                                jpipe.guidance_cfg, guidance_step=step, guidance_type=gtype))
                        tp = dataclasses.replace(
                            tpipe, sched=tsched, strength=strength,
                            guidance_cfg=dataclasses.replace(
                                tpipe.guidance_cfg, guidance_step=step, guidance_type=gtype))
                        want = _outcome(jp.guidance_active, text_to_img)
                        assert _outcome(tp.guidance_active, text_to_img) == want, (
                            steps, strength, step, gtype, text_to_img)
                        checked[want] = checked.get(want, 0) + 1
    # the grid holds guided, unguided and refused (a window past the plan's
    # end) cases
    assert min(checked.values()) > 10 and len(checked) == 3, checked


def _outcome(fn, *args):
    try:
        return fn(*args)
    except ValueError:
        return "ValueError"


def test_offset_draw_is_constant_over_height_and_width(pipelines):
    tpipe = pipelines[2]
    lat = torch.zeros(3, 8, 6, 4)
    on = dataclasses.replace(tpipe, offset_noise=True)
    plain = dataclasses.replace(tpipe, offset_noise=False).draw_inputs(
        lat, torch.Generator().manual_seed(5))
    offset = on.draw_inputs(lat, torch.Generator().manual_seed(5))
    # the offset is drawn after the others, which do not move
    for a, b in zip(plain[1:], offset[1:]):
        assert torch.equal(a, b)
    d = offset[0] - plain[0]
    assert d.shape == (3, 8, 6, 4) and float(d.abs().min()) > 0
    np.testing.assert_allclose(d.numpy(), d[:, :1, :1, :].expand_as(d).numpy(), atol=1e-6, rtol=0)
    # 0.1 x the next standard-normal draw of the generator, [B, 1, 1, C]
    want = torch.randn((3, 1, 1, 4), generator=_after_draws(lat))
    np.testing.assert_allclose(d[:, :1, :1, :].numpy(), 0.1 * want.numpy(), atol=1e-6, rtol=0)
    # no offset under text_to_img: the noise is the plain draw
    t2i = on.draw_inputs(lat, torch.Generator().manual_seed(5), text_to_img=True)
    for a, b in zip(plain, t2i):
        assert torch.equal(a, b)


def _after_draws(lat):
    """A generator advanced past the noise, gamma0 and beta0 draws."""
    gen = torch.Generator().manual_seed(5)
    b, c = lat.shape[0], lat.shape[-1]
    torch.randn(lat.shape, generator=gen)
    torch.rand((b, 1, 1, c), generator=gen)
    torch.randn((b, 1, 1, c), generator=gen)
    return gen


@pytest.mark.parametrize("text_to_img,offset", [(False, True), (True, True), (True, False)])
def test_per_sample_generators_give_the_split_result(pipelines, text_to_img, offset):
    """``make_expand_fn`` takes one generator per sample, as ExpansionDriver
    passes them (``--fused_program``), and gives SplitExpand's images."""
    tp = dataclasses.replace(pipelines[2], offset_noise=offset)
    lat, cond, uncond, targets = (torch.from_numpy(np.array(a))
                                  for a in _inputs(tp.config.latent_size))

    def gens():
        return [torch.Generator().manual_seed(s) for s in (11, 12)]

    want = tp.make_split_expand(text_to_img=text_to_img)(lat, cond, uncond, targets, gens())
    got = tp.make_expand_fn(text_to_img=text_to_img)(lat, cond, uncond, targets, gens())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
