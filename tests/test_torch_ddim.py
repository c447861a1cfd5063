"""The port's DDIM scheduler against the JAX package's, and the goldens of
``tests/test_ddim.py`` held for the port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distdiff_tpu.sampling.pipeline import _clamp_window as j_clamp_window
from distdiff_tpu.schedulers import ddim as jddim
from distdiff_tpu_torch.sampling.pipeline import _clamp_window
from distdiff_tpu_torch.schedulers import ddim
from distdiff_tpu_torch.schedulers.dpm import make_dpm_schedule

torch.set_num_threads(1)


def _oracle_tables():
    betas = np.linspace(0.00085**0.5, 0.012**0.5, 1000) ** 2
    return np.cumprod(1.0 - betas)


@pytest.mark.parametrize("steps", [50, 10])
def test_schedule_tables_match_jax(steps):
    js, ts = jddim.make_schedule(steps), ddim.make_schedule(steps)
    # both are fp64 numpy intermediates cast to fp32/int: exact
    np.testing.assert_array_equal(ts.timesteps, np.asarray(js.timesteps))
    for name in ("alphas_cumprod", "step_alphas", "step_alphas_prev"):
        np.testing.assert_array_equal(getattr(ts, name), np.asarray(getattr(js, name)))
    assert float(ts.final_alpha_cumprod) == float(js.final_alpha_cumprod)


@pytest.mark.parametrize("steps", [50, 10])
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_ddim_step_and_add_noise_match_jax(steps, prediction_type):
    js = jddim.make_schedule(steps, prediction_type=prediction_type)
    ts = ddim.make_schedule(steps, prediction_type=prediction_type)
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    eps = rng.randn(2, 8, 8, 4).astype(np.float32)
    for i in sorted({0, steps // 3, steps // 2, steps - 1}):
        jp, jx0 = jddim.ddim_step(js, jnp.asarray(eps), i, jnp.asarray(x))
        tp, tx0 = ddim.ddim_step(ts, torch.from_numpy(eps), i, torch.from_numpy(x))
        # the same fp32 formula on the same fp32 tables: <= 1e-6
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), atol=1e-6, rtol=1e-6)
    for t in (1, 501, 981):
        jn = jddim.add_noise(js, jnp.asarray(x), jnp.asarray(eps), jnp.asarray(t))
        tn = ddim.add_noise(ts, torch.from_numpy(x), torch.from_numpy(eps), t)
        np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("steps", [50, 10])
def test_plan_indices_match_jax(steps):
    js, ts = jddim.make_schedule(steps), ddim.make_schedule(steps)
    for strength in (0.0, 0.3, 0.5, 0.75, 1.0):
        assert ddim.img2img_start_index(ts, strength) == \
            jddim.img2img_start_index(js, strength)
    for gstep, period in ((steps // 2, 2), (4, 2), (steps, 1)):
        assert ddim.guidance_window(ts, gstep, period) == \
            jddim.guidance_window(js, gstep, period)
        g0, g1 = ddim.guidance_window(ts, gstep, period)
        for gtype in ("transform_guidance", "direct_guidance"):
            for start in (0, g0 - 1, g0, g0 + 1, steps - 1):
                for in_plan in (False, True):
                    assert _clamp_window(gtype, start, g0, g1, in_plan, steps) == \
                        j_clamp_window(gtype, start, g0, g1, in_plan, steps)
    with pytest.raises(ValueError):
        ddim.guidance_window(ts, steps + 1, 2)


# ---- the goldens of tests/test_ddim.py, for the port


def test_timestep_plan_golden():
    ts = ddim.make_schedule(50).timesteps
    np.testing.assert_array_equal(ts, np.arange(0, 50)[::-1] * 20 + 1)


def test_alpha_tables_golden():
    sched = ddim.make_schedule(50)
    acp = _oracle_tables()
    np.testing.assert_allclose(sched.alphas_cumprod, acp, rtol=1e-6)
    np.testing.assert_allclose(float(sched.final_alpha_cumprod), acp[0], rtol=1e-6)
    prev = sched.timesteps - 20
    exp_prev = np.where(prev >= 0, acp[np.clip(prev, 0, None)], acp[0])
    np.testing.assert_allclose(sched.step_alphas_prev, exp_prev, rtol=1e-6)


def test_ddim_step_golden():
    rng = np.random.RandomState(0)
    sched = ddim.make_schedule(50)
    acp = _oracle_tables()
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    eps = rng.randn(2, 8, 8, 4).astype(np.float32)
    for i in [0, 17, 30, 49]:
        t = int(sched.timesteps[i])
        a_t = acp[t]
        a_prev = acp[t - 20] if t - 20 >= 0 else acp[0]
        x0_ref = (x - np.sqrt(1 - a_t) * eps) / np.sqrt(a_t)
        prev_ref = np.sqrt(a_prev) * x0_ref + np.sqrt(1 - a_prev) * eps
        prev, x0 = ddim.ddim_step(sched, torch.from_numpy(eps), i, torch.from_numpy(x))
        np.testing.assert_allclose(x0.numpy(), x0_ref, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(prev.numpy(), prev_ref, rtol=2e-5, atol=2e-5)


def test_v_prediction_roundtrip_golden():
    rng = np.random.RandomState(1)
    sched = ddim.make_schedule(50, prediction_type="v_prediction")
    acp = _oracle_tables()
    x0 = rng.randn(1, 4, 4, 4).astype(np.float32)
    eps = rng.randn(1, 4, 4, 4).astype(np.float32)
    i = 10
    a = acp[int(sched.timesteps[i])]
    x_t = np.sqrt(a) * x0 + np.sqrt(1 - a) * eps
    v = np.sqrt(a) * eps - np.sqrt(1 - a) * x0
    _, x0_hat = ddim.ddim_step(sched, torch.from_numpy(v.astype(np.float32)), i,
                               torch.from_numpy(x_t.astype(np.float32)))
    np.testing.assert_allclose(x0_hat.numpy(), x0, rtol=1e-4, atol=1e-4)


def test_add_noise_golden():
    rng = np.random.RandomState(2)
    sched = ddim.make_schedule(50)
    acp = _oracle_tables()
    x0 = rng.randn(2, 4, 4, 4).astype(np.float32)
    eps = rng.randn(2, 4, 4, 4).astype(np.float32)
    out = ddim.add_noise(sched, torch.from_numpy(x0), torch.from_numpy(eps), 501)
    ref = np.sqrt(acp[501]) * x0 + np.sqrt(1 - acp[501]) * eps
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-6, atol=2e-6)
    out = ddim.add_noise(sched, torch.from_numpy(x0), torch.from_numpy(eps), [3, 997])
    for b, tb in enumerate([3, 997]):
        ref_b = np.sqrt(acp[tb]) * x0[b] + np.sqrt(1 - acp[tb]) * eps[b]
        np.testing.assert_allclose(out.numpy()[b], ref_b, rtol=2e-6, atol=2e-6)


def test_tensor_timesteps_index_one_copy_of_the_table():
    """An int64 tensor of timesteps gives add_noise's and alphas_at's
    values of the same list, from one copy of the table a device, made at
    the first call and kept on the schedule (a DPM schedule too)."""
    rng = np.random.RandomState(3)
    x0 = torch.from_numpy(rng.randn(2, 4, 4, 4).astype(np.float32))
    eps = torch.from_numpy(rng.randn(2, 4, 4, 4).astype(np.float32))
    for sched in (ddim.make_schedule(50), make_dpm_schedule(20)):
        assert sched.device_tables == {}
        t = torch.tensor([3, 997], dtype=torch.int64)
        want = ddim.add_noise(sched, x0, eps, [3, 997])
        assert torch.equal(ddim.add_noise(sched, x0, eps, t), want)
        table = sched.device_tables[t.device]
        assert torch.equal(ddim.alphas_at(sched, t, "cpu"),
                           torch.from_numpy(sched.alphas_cumprod[[3, 997]]))
        assert list(sched.device_tables) == [t.device]
        assert sched.device_tables[t.device] is table


def test_img2img_start_and_guidance_window_golden():
    sched = ddim.make_schedule(50)
    assert ddim.img2img_start_index(sched, 0.5) == 25
    assert ddim.img2img_start_index(sched, 1.0) == 0
    assert ddim.guidance_window(sched, 20, 2) == (30, 32)
    assert sched.timesteps[30] == 381 and sched.timesteps[31] == 361
