"""The port's DPM-Solver++(2M) against the JAX package's: the tables in both
prediction types, ``dpm_step`` and ``denoise_range_dpm`` at 10 steps (where
``lower_order_final`` takes the last step) and at 50 (where it does not),
``build_schedule``'s names, ``ddim_step`` on a ``DPMSchedule``, and the
tiny guided expand (transform and direct guidance) and ``SplitExpand``
under ``dpmpp`` on the JAX package's weights and draws."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import run_both, tiny_pipelines

from distdiff_tpu.config import PipelineConfig as JPipelineConfig
from distdiff_tpu.schedulers import ddim_step as j_ddim_step
from distdiff_tpu.schedulers import dpm as jdpm
from distdiff_tpu_torch.config import PipelineConfig
from distdiff_tpu_torch.schedulers import (
    DDIMSchedule,
    DPMSchedule,
    build_schedule,
    ddim_step,
    denoise_range_dpm,
    dpm_step,
    make_dpm_schedule,
    make_schedule,
)

torch.set_num_threads(1)

TABLES = ("alphas_cumprod", "step_alphas", "step_alphas_prev", "step_alpha_sqrt",
          "step_sigma", "step_lambda", "prev_alpha_sqrt", "prev_sigma", "prev_lambda")


@pytest.mark.parametrize("steps", [10, 50])
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_tables_match_jax(steps, prediction_type):
    js = jdpm.make_dpm_schedule(steps, prediction_type=prediction_type)
    ts = make_dpm_schedule(steps, prediction_type=prediction_type)
    # both are float64 numpy arithmetic cast to fp32: exact
    np.testing.assert_array_equal(ts.timesteps, np.asarray(js.timesteps))
    for name in TABLES:
        np.testing.assert_array_equal(getattr(ts, name), np.asarray(getattr(js, name)))
    assert (ts.prediction_type, ts.num_inference_steps, ts.lower_order_final) == \
        (js.prediction_type, js.num_inference_steps, js.lower_order_final)


def _arrays(seed=0, shape=(2, 6, 6, 4)):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("steps", [10, 50])
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_dpm_step_matches_jax(steps, prediction_type):
    js = jdpm.make_dpm_schedule(steps, prediction_type=prediction_type)
    ts = make_dpm_schedule(steps, prediction_type=prediction_type)
    x, out, prev = _arrays()
    for i in sorted({0, 1, steps // 2, steps - 2, steps - 1}):
        # a span's first step has no history, so plan index 0 never has one
        for has_prev in (False, True) if i else (False,):
            jx, jx0 = jdpm.dpm_step(js, jnp.asarray(out), i, jnp.asarray(x),
                                    jnp.asarray(prev), jnp.asarray(has_prev))
            tx, tx0 = dpm_step(ts, torch.from_numpy(out), i, torch.from_numpy(x),
                               torch.from_numpy(prev) if has_prev else None)
            # the same fp32 formula on the same fp32 tables; x0 divides by
            # alpha_s (down to 0.07 at the first of 50 steps): 1e-5 relative
            np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5, rtol=1e-5)


def _eps_fns():
    """One model, written once per package: eps = tanh(x) * cond + t/1000 *
    uncond, so each step depends on x and on the timestep."""

    def j_eps(params, x, t, cond, uncond):
        return jnp.tanh(x) * cond + t.astype(jnp.float32) / 1000.0 * uncond

    def t_eps(x, t, cond, uncond):
        return torch.tanh(x) * cond + t / 1000.0 * uncond

    return j_eps, t_eps


@pytest.mark.parametrize("steps,span", [(10, (0, 10)), (10, (3, 7)), (50, (0, 50)),
                                        (50, (25, 50))])
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_denoise_range_dpm_matches_jax(steps, span, prediction_type):
    js = jdpm.make_dpm_schedule(steps, prediction_type=prediction_type)
    ts = make_dpm_schedule(steps, prediction_type=prediction_type)
    x, cond, uncond = _arrays(1)
    cond, uncond = cond * 0.5, uncond * 0.5
    j_eps, t_eps = _eps_fns()
    want = jax.jit(lambda a, c, u: jdpm.denoise_range_dpm(js, j_eps, None, a, c, u, *span))(
        jnp.asarray(x), jnp.asarray(cond), jnp.asarray(uncond))
    got = denoise_range_dpm(ts, t_eps, torch.from_numpy(x), torch.from_numpy(cond),
                            torch.from_numpy(uncond), *span)
    # up to 50 fp32 steps of the same arithmetic (XLA may fuse it otherwise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    # the solver is second order after the span's first step: a first-order
    # (DDIM-like) run of the same span lands elsewhere
    first = torch.from_numpy(x)
    for i in range(*span):
        first, _ = dpm_step(ts, t_eps(first, int(ts.timesteps[i]), torch.from_numpy(cond),
                                      torch.from_numpy(uncond)), i, first, None)
    assert (first - got).abs().max() > 1e-4


@pytest.mark.parametrize("scheduler", ["ddim", "dpmpp"])
def test_sample_with_a_guided_segment_matches_jax(scheduler):
    """``sample``: plain steps to the segment, the guide function, plain
    steps after it, each span solved on its own."""
    from distdiff_tpu.sampling.sampler import sample as j_sample
    from distdiff_tpu.schedulers import build_schedule as j_build_schedule
    from distdiff_tpu_torch.sampling.sampler import sample

    js, ts = j_build_schedule(scheduler, 20), build_schedule(scheduler, 20)
    x, cond, uncond = _arrays(3)
    cond, uncond = cond * 0.5, uncond * 0.5
    j_eps, t_eps = _eps_fns()
    for segment in (None, (12, 14)):
        jseg = tseg = None
        if segment:
            jseg = (*segment, lambda p, a, c, u: 0.9 * a + 0.05 * c)
            tseg = (*segment, lambda a, c, u: 0.9 * a + 0.05 * c)
        want = jax.jit(lambda a, c, u: j_sample(js, j_eps, None, a, c, u, 4, jseg))(
            jnp.asarray(x), jnp.asarray(cond), jnp.asarray(uncond))
        got = sample(ts, t_eps, torch.from_numpy(x), torch.from_numpy(cond),
                     torch.from_numpy(uncond), 4, tseg)
        # 16 fp32 steps of the same arithmetic
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_build_schedule_names():
    for name in ("dpmpp", "dpmsolver++", "dpm++2m"):
        s = build_schedule(name, 10)
        assert isinstance(s, DPMSchedule) and s.num_inference_steps == 10
    ddim = build_schedule("ddim", 10, prediction_type="v_prediction")
    assert type(ddim) is DDIMSchedule and ddim.prediction_type == "v_prediction"
    with pytest.raises(ValueError, match="unknown scheduler"):
        build_schedule("euler", 10)


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_ddim_step_takes_a_dpm_schedule(prediction_type):
    """The guidance rollout's DDIM update reads a DPMSchedule's DDIM fields,
    as the JAX package's does."""
    dpm = make_dpm_schedule(50, prediction_type=prediction_type)
    ddim = make_schedule(50, prediction_type=prediction_type)
    jsched = jdpm.make_dpm_schedule(50, prediction_type=prediction_type)
    x, out, _ = _arrays(2)
    for i in (25, 30, 49):
        a = ddim_step(dpm, torch.from_numpy(out), i, torch.from_numpy(x))
        b = ddim_step(ddim, torch.from_numpy(out), i, torch.from_numpy(x))
        j = j_ddim_step(jsched, jnp.asarray(out), i, jnp.asarray(x))
        for got, same, want in zip(a, b, j):
            assert torch.equal(got, same)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


# ------------------------------------------------------ the tiny expansion

SAMPLE = 32


@pytest.fixture(scope="module")
def pipelines():
    """The JAX and the port's tiny pipelines under dpmpp on the JAX
    package's weights, guide and prototypes."""
    jcfg = dataclasses.replace(JPipelineConfig.tiny(sample_size=SAMPLE), scheduler="dpmpp")
    tcfg = dataclasses.replace(PipelineConfig.tiny(sample_size=SAMPLE), scheduler="dpmpp")
    jpipe, params, tpipe = tiny_pipelines(jcfg, tcfg)
    assert isinstance(jpipe.sched, jdpm.DPMSchedule) and isinstance(tpipe.sched, DPMSchedule)
    return jpipe, params, tpipe


@pytest.mark.parametrize("path,gtype", [("fused", "transform_guidance"),
                                        ("fused", "direct_guidance"),
                                        ("split", "transform_guidance")])
def test_expand_under_dpmpp_matches_jax(pipelines, path, gtype):
    jpipe, params, tpipe = pipelines
    for pipe in (jpipe, tpipe):
        pipe.guidance_cfg = dataclasses.replace(pipe.guidance_cfg, guidance_type=gtype)
    ref, got, (targs, kw) = run_both(jpipe, params, tpipe, path)
    assert got.shape == ref.shape == (2, SAMPLE, SAMPLE, 3)
    # fp32 throughout, as the DDIM expand of test_torch_guided_expand.py:
    # images in [0, 1], summation order between XLA's and torch's kernels
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)
    if gtype == "direct_guidance":
        # spans [5, 6) and [8, 10): first order throughout (the last step
        # by lower_order_final), where DPM-Solver++ is DDIM
        return
    # the solver moved the result: the same draws under DDIM land elsewhere
    ddim = dataclasses.replace(tpipe, sched=make_schedule(tpipe.sched.num_inference_steps))
    other = ddim.make_expand_fn()(*targs, **kw).numpy()
    assert np.abs(other - got).max() > 1e-3
