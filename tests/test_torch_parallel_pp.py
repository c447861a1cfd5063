"""The port's pipeline-parallel UNet (``parallel/pp.py``,
``UNet2DConditionModel(segment=..., skips=...)``) against the JAX
package's on the same numpy weights: stage plans equal to JAX's
``plan_boundaries`` (tiny and SD-1.5 geometry), the segment chain and the
staged forward equal to the whole call, and the 2-stage forward within
1e-5 of JAX's ``PipelinedUNet`` on its virtual devices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distdiff_tpu.config import UNetConfig as JUNetConfig
from distdiff_tpu.models import UNet2DCondition
from distdiff_tpu.parallel import pp as j_pp
from distdiff_tpu_torch.config import UNetConfig
from distdiff_tpu_torch.models import UNet2DConditionModel
from distdiff_tpu_torch.parallel import pp
from distdiff_tpu_torch.weights.from_jax import state_dict_from_jax

torch.set_num_threads(1)
T = 3


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.RandomState(0)
    cfg = JUNetConfig.tiny()
    x = rng.randn(4, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(4, 6, cfg.cross_attention_dim).astype(np.float32)
    mod = UNet2DCondition(cfg)
    shapes = jax.eval_shape(mod.init, jax.random.PRNGKey(0), x, jnp.array([1]), ctx)
    draw = np.random.default_rng(1)
    params = jax.tree.map(lambda s: (draw.standard_normal(s.shape) * 0.2).astype(np.float32),
                          shapes)
    unet = UNet2DConditionModel(UNetConfig.tiny(), device="cpu")
    unet.load_state_dict(state_dict_from_jax(params["params"], UNetConfig.tiny()))
    unet.requires_grad_(False)
    with torch.no_grad():
        ref = unet(torch.from_numpy(x), T, torch.from_numpy(ctx))
    return mod, params, x, ctx, unet, ref


def test_every_parameter_has_its_unit_and_the_plans_are_jaxs(tiny):
    mod, params, _, _, unet, _ = tiny
    nb = len(unet.config.block_out_channels)
    units = {pp.unit_of_param(n, nb) for n, _ in unet.named_parameters()}
    assert units == set(range(pp.n_units(nb))) | {None}
    for s in (2, 3, 4):
        assert pp.plan_boundaries(unet, nb, s) == j_pp.plan_boundaries(params, nb, s)
    stages = pp.split_unet_params(unet, pp.plan_boundaries(unet, nb, 2), nb)
    shared = set(stages[0]) & set(stages[1])
    assert {n.split(".")[0] for n in shared} == {"time_embedding"}
    assert set(stages[0]) | set(stages[1]) == {n for n, _ in unet.named_parameters()}


def test_sd15_plans_are_jaxs():
    """At SD-1.5 geometry (the port on the meta device, JAX by eval_shape)."""
    cfg = JUNetConfig.sd15()
    shapes = jax.eval_shape(UNet2DCondition(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 8, 4)), jnp.array([1]),
                            jnp.zeros((1, 77, cfg.cross_attention_dim)))
    unet = UNet2DConditionModel(UNetConfig.sd15(), device="meta")
    for s in (2, 3, 4):
        assert pp.plan_boundaries(unet, 4, s) == j_pp.plan_boundaries(shapes, 4, s)


def test_segment_chain_is_the_whole_call(tiny):
    *_, unet, ref = tiny
    x, ctx = (torch.from_numpy(a) for a in tiny[2:4])
    nu = pp.n_units(len(unet.config.block_out_channels))
    h, skips = x, ()
    with torch.no_grad():
        for a, b in ((0, 2), (2, 5), (5, nu)):
            out = unet(h, T, ctx, segment=(a, b), skips=skips)
            if b < nu:
                h, skips = out
    assert torch.equal(out, ref)
    with pytest.raises(AssertionError, match="mutually exclusive"):
        unet(x, T, ctx, segment=(0, 2), return_cache=True)


def test_pipelined_unet_matches_the_whole_call_and_jax(tiny):
    """2 and 3 stages on one device each equal to the whole call, bit for
    bit (the same operations in the same order); 2 stages of two devices
    (pipeline x data) and microbatches, which run smaller batches, within
    1e-5. The 2-stage forward within 1e-5 of JAX's PipelinedUNet."""
    mod, params, x, ctx, unet, ref = tiny
    tx, tctx = torch.from_numpy(x), torch.from_numpy(ctx)
    with torch.no_grad():
        for stages, devices in ((2, 2), (3, 3), (2, 4)):
            pipe = pp.PipelinedUNet(unet, n_stages=stages, devices=["cpu"] * devices)
            assert all(m is unet for st in pipe.stages for m in st.values())  # one copy
            out = pipe(tx, T, tctx)
            if stages == devices:
                assert torch.equal(out, ref)
            np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5, rtol=0)
            np.testing.assert_allclose(pipe.microbatched(tx, T, tctx, n_micro=2).numpy(),
                                       ref.numpy(), atol=1e-5, rtol=0)
        pipe = pp.PipelinedUNet(unet, n_stages=2, devices=["cpu"] * 2)
    jpipe = j_pp.PipelinedUNet(mod, params, n_stages=2, devices=jax.devices()[:2])
    assert jpipe.boundaries == pipe.boundaries
    np.testing.assert_allclose(ref.numpy(), np.asarray(jpipe(x, T, ctx)), atol=1e-5, rtol=0)
