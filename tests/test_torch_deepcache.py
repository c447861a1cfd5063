"""The port's DeepCache (``models/unet.py``'s cache arguments and
``sampling/deepcache.py``) against the JAX package's: the full call's cache
and the shallow call on it against JAX's UNet, the shallow call on a fresh
cache equal to the full call, interval 1 equal to the uncached loop, the
cached ``make_expand_fn`` and ``SplitExpand`` on the JAX package's weights
and draws, and the refusal of ``deep_cache`` under ``dpmpp``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import run_both, tiny_pipelines

from distdiff_tpu.config import PipelineConfig as JPipelineConfig
from distdiff_tpu_torch.config import PipelineConfig
from distdiff_tpu_torch.sampling.deepcache import denoise_range_cached
from distdiff_tpu_torch.sampling.sampler import denoise_range

torch.set_num_threads(1)

SAMPLE = 32


def _cfgs(**kw):
    return (dataclasses.replace(JPipelineConfig.tiny(sample_size=SAMPLE), **kw),
            dataclasses.replace(PipelineConfig.tiny(sample_size=SAMPLE), **kw))


@pytest.fixture(scope="module")
def pipelines():
    return tiny_pipelines(*_cfgs(deep_cache=True, cache_interval=2))


def _unet_inputs(pipe, seed=0):
    rng = np.random.RandomState(seed)
    ls = pipe.config.latent_size
    x = rng.randn(4, ls, ls, 4).astype(np.float32)
    ctx = rng.randn(4, 8, 32).astype(np.float32)
    return x, ctx, np.array([7, 7, 7, 7])


def test_cache_and_shallow_call_match_jax(pipelines):
    jpipe, params, tpipe = pipelines
    x, ctx, t = _unet_inputs(tpipe)
    out, cache = tpipe.unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                            return_cache=True)
    jout, jcache = jax.jit(lambda p, a, c: jpipe.unet.apply(
        {"params": p}, a, jnp.asarray(t), c, return_cache=True))(
        params["unet"], jnp.asarray(x), jnp.asarray(ctx))
    # the cache is the NCHW feature entering the last up group, JAX's NHWC
    assert tuple(cache.shape) == (4, 64, SAMPLE // 2, SAMPLE // 2)
    # fp32 UNets on the same weights: summation order only
    np.testing.assert_allclose(cache.permute(0, 2, 3, 1).numpy(), np.asarray(jcache),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-5, rtol=0)
    # the shallow call on another cache: a live substitution, as JAX's
    other = cache + 0.5
    got = tpipe.unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                     deep_cache=other)
    want = jax.jit(lambda p, a, c, k: jpipe.unet.apply({"params": p}, a, jnp.asarray(t), c,
                                                       deep_cache=k))(
        params["unet"], jnp.asarray(x), jnp.asarray(ctx),
        jnp.asarray(other.permute(0, 2, 3, 1).numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    assert (got - out).abs().max() > 1e-3


def test_shallow_call_on_a_fresh_cache_equals_the_full_call(pipelines):
    tpipe = pipelines[2]
    x, ctx, t = (torch.from_numpy(a) for a in _unet_inputs(tpipe, 1))
    plain = tpipe.unet(x, t, ctx)
    out, cache = tpipe.unet(x, t, ctx, return_cache=True)
    assert torch.equal(out, plain)
    shallow = tpipe.unet(x, t, ctx, deep_cache=cache)
    # the same operations on the same values
    np.testing.assert_allclose(shallow.numpy(), out.numpy(), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="cache_branch"):
        tpipe.unet(x, t, ctx, return_cache=True, cache_branch=1)


def test_interval_one_equals_the_uncached_loop(pipelines):
    tpipe = pipelines[2]
    rng = np.random.RandomState(2)
    ls = tpipe.config.latent_size
    x = torch.from_numpy(rng.randn(2, ls, ls, 4).astype(np.float32))
    cond, uncond = (torch.from_numpy(rng.randn(2, 8, 32).astype(np.float32)) for _ in range(2))
    eps_full, eps_shallow = tpipe.cached_eps_fns()
    want = denoise_range(tpipe.sched, tpipe.eps_fn(), x, cond, uncond, 4, 10)
    got = denoise_range_cached(tpipe.sched, eps_full, eps_shallow, x, cond, uncond, 4, 10, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    cached = denoise_range_cached(tpipe.sched, eps_full, eps_shallow, x, cond, uncond, 4, 10, 3)
    assert (cached - want).abs().max() > 1e-4  # shallow steps approximate


@pytest.mark.parametrize("path", ["fused", "split"])
def test_cached_expand_matches_jax(pipelines, path):
    jpipe, params, tpipe = pipelines
    ref, got, (targs, kw) = run_both(jpipe, params, tpipe, path)
    assert got.shape == ref.shape == (2, SAMPLE, SAMPLE, 3)
    # fp32 throughout, as the uncached expand of test_torch_guided_expand.py
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)
    # the cache moved the result: the uncached expand lands elsewhere
    plain = dataclasses.replace(tpipe, config=dataclasses.replace(tpipe.config,
                                                                  deep_cache=False))
    assert np.abs(plain.make_expand_fn()(*targs, **kw).numpy() - got).max() > 1e-4


def test_deep_cache_under_dpmpp_raises_as_jax(pipelines):
    jpipe, _, tpipe = pipelines
    from distdiff_tpu.schedulers import build_schedule as j_build_schedule
    from distdiff_tpu_torch.schedulers import build_schedule

    jdpm = dataclasses.replace(jpipe, sched=j_build_schedule("dpmpp", 10),
                               config=dataclasses.replace(jpipe.config, scheduler="dpmpp"))
    tdpm = dataclasses.replace(tpipe, sched=build_schedule("dpmpp", 10),
                               config=dataclasses.replace(tpipe.config, scheduler="dpmpp"))
    for make in (jdpm.make_expand_fn, jdpm.make_split_expand, tdpm.make_expand_fn,
                 tdpm.make_split_expand):
        with pytest.raises(NotImplementedError, match="DDIM solver only"):
            make()
