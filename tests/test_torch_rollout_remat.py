"""The port's eight ``rollout_remat`` modes: the transform guidance's updated
latents, scores and gamma/beta gradients against the JAX package's update
and against the port's "step_nr", and the block forwards each mode runs in
one rollout's forward and backward, counted with hooks, which show where
each mode recomputes. The JAX update is computed once, in the JAX
package's default mode ("step"): a mode places checkpoints and changes no
value (the JAX package's ``tests/test_guidance.py``
``test_rollout_remat_modes_equivalent`` holds six of its modes to
"step"), so each port mode is held to the one JAX run."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import GUIDE_KW, jax_draws, tiny_pipelines

from distdiff_tpu.config import PipelineConfig as JPipelineConfig
from distdiff_tpu.guidance import transform_guidance as j_transform_guidance
from distdiff_tpu_torch.config import ROLLOUT_REMAT_MODES, GuidanceConfig, PipelineConfig
from distdiff_tpu_torch.guidance import transform_guidance
from distdiff_tpu_torch.models.layers import ResnetBlock2D

torch.set_num_threads(1)

SAMPLE = 32
G0 = 6  # the window's first plan index: 10 steps, guidance_step 4
# no l-inf clip, so that JAX's updated latents give its gradients back
KW = dict(GUIDE_KW, constraint_value=1e3)


@pytest.fixture(scope="module")
def setup():
    jpipe, params, tpipe = tiny_pipelines(JPipelineConfig.tiny(sample_size=SAMPLE),
                                          PipelineConfig.tiny(sample_size=SAMPLE), KW)
    rng = np.random.RandomState(3)
    ls = tpipe.config.latent_size
    lat = (rng.randn(2, ls, ls, 4) * 0.2).astype(np.float32)
    # pixel (0, 0) at 0 and (0, 1) at 1: there the update is
    # beta0 - rho g_beta and 1 + gamma0 + beta0 - rho (g_gamma + g_beta)
    lat[:, 0, 0, :], lat[:, 0, 1, :] = 0.0, 1.0
    cond, uncond = (rng.randn(2, 8, 32).astype(np.float32) for _ in range(2))
    key = jax.random.key(5)
    _, gamma0, beta0 = jax_draws(key, lat)
    k_guide = jax.random.split(key)[1]
    ins = dict(lat=lat, cond=cond, uncond=uncond, targets=np.array([1, 2]),
               gamma0=gamma0, beta0=beta0, k_guide=k_guide)
    base = _port(tpipe, "step_nr", ins)
    return jpipe, params, tpipe, ins, base, _jax(jpipe, params, ins)


def _jax(jpipe, params, ins):
    """JAX's updated latents, score and gamma/beta gradients, in its
    default mode."""
    assert jpipe.guidance_cfg.rollout_remat == "step"
    ctx = jpipe.guidance_context()
    jup, jscore = jax.jit(lambda p, *a: j_transform_guidance(ctx, p, *a, G0))(
        params, *(jnp.asarray(ins[k]) for k in ("lat", "cond", "uncond", "targets")),
        ins["k_guide"])
    jup, jscore = np.asarray(jup), np.asarray(jscore)
    rho = KW["rho"]
    gamma0, beta0 = ins["gamma0"][:, 0, 0], ins["beta0"][:, 0, 0]
    jgb = (beta0 - jup[:, 0, 0]) / rho
    jgg = (1.0 + gamma0 + beta0 - jup[:, 0, 1]) / rho - jgb
    return jup, jscore, jgg, jgb


def _port(tpipe, mode, ins):
    tpipe.guidance_cfg = dataclasses.replace(tpipe.guidance_cfg, rollout_remat=mode)
    t = {k: torch.from_numpy(np.array(v)) for k, v in ins.items() if k != "k_guide"}
    up, score, (gg, gb) = transform_guidance(
        tpipe.guidance_context(), t["lat"], t["cond"], t["uncond"], t["targets"], G0,
        t["gamma0"], t["beta0"])
    return up.numpy(), score.numpy(), gg.numpy(), gb.numpy()


def test_the_default_mode_and_the_refusal_of_others():
    assert GuidanceConfig().rollout_remat == "step_nr"
    assert len(ROLLOUT_REMAT_MODES) == 8
    with pytest.raises(ValueError, match="tail_decode_nr"):
        GuidanceConfig(rollout_remat="steps")


@pytest.mark.parametrize("mode", ROLLOUT_REMAT_MODES)
def test_mode_matches_jax_and_step_nr(setup, mode):
    _, _, tpipe, ins, base, (jup, jscore, jgg, jgb) = setup
    up, score, gg, gb = _port(tpipe, mode, ins)
    # fp32 rollouts (2 UNet steps, 2 decodes, the guide) and their
    # backward on the same weights: XLA's and torch's summation orders
    np.testing.assert_allclose(up, jup, atol=2e-5, rtol=0)
    np.testing.assert_allclose(score, jscore, rtol=1e-5)
    for got, want in ((gg[:, 0, 0], jgg), (gb[:, 0, 0], jgb)):
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max() + 1e-6, rtol=0)
    # against the port's own default: the same forward values, recomputed
    # or kept; the backward's sums may be ordered otherwise
    for got, want in zip((up, score, gg, gb), base):
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert np.abs(gg).max() > 0 and np.abs(gb).max() > 0


# Forwards in one transform rollout of 2 steps, forward and backward: the
# UNet's resnets (U, 8 a UNet call) and its conv_in (C, outside every
# block), the VAE decoder's resnets (V, 6 a decode) and its conv_in (D).
# An outer checkpoint re-runs a step once (C, D and every block once more);
# an inner one re-runs its blocks once more in the backward.
PER_CALL = {"U": 8, "C": 1, "V": 6, "D": 1}
WANT = {  # per step, in UNet calls and decodes: (U, C, V, D) each step
    "step_nr": [(2, 2, 2, 2)] * 2,
    "step": [(3, 2, 3, 2)] * 2,
    "step_nru": [(2, 2, 3, 2)] * 2,
    "decode_nr": [(3, 2, 2, 2)] * 2,
    "block": [(2, 1, 2, 1)] * 2,
    "decode": [(2, 1, 3, 2)] * 2,
    "tail": [(3, 2, 3, 2), (2, 1, 2, 1)],
    "tail_decode_nr": [(3, 2, 2, 2), (2, 1, 1, 1)],
}


def test_each_mode_recomputes_where_it_says(setup):
    _, _, tpipe, ins, _, _ = setup
    counts, handles = {}, []

    def hook(key):
        def pre(module, args):
            counts[key] = counts.get(key, 0) + 1
        return pre

    for key, root in (("U", tpipe.unet), ("V", tpipe.vae.decoder)):
        handles += [m.register_forward_pre_hook(hook(key)) for m in root.modules()
                    if isinstance(m, ResnetBlock2D)]
    handles.append(tpipe.unet.conv_in.register_forward_pre_hook(hook("C")))
    handles.append(tpipe.vae.decoder.conv_in.register_forward_pre_hook(hook("D")))
    seen = {}
    try:
        for mode in ROLLOUT_REMAT_MODES:
            counts.clear()
            _port(tpipe, mode, ins)
            seen[mode] = tuple(counts.get(k, 0) for k in "UCVD")
    finally:
        for h in handles:
            h.remove()
    want = {mode: tuple(sum(step[i] for step in steps) * PER_CALL[k]
                        for i, k in enumerate("UCVD"))
            for mode, steps in WANT.items()}
    assert seen == want
    assert len(set(seen.values())) == 8  # no mode is another's alias
