"""The port's tensor-parallel UNet (``parallel/tp.py``) and attention
routing (``ops/attention.py``) against the JAX package's on the same numpy
weights and inputs: the sharding rules parameter by parameter, the TP
forward on ``["cpu"] * n`` model groups against the unsharded call (2e-5)
and against the JAX TP forward on its 8-virtual-device mesh (2e-4), at a
group that splits the heads (2) and one that does not divide them (4:
head-replicated attention), the int8 route of a row-parallel layer, and
the guided SplitExpand on a data x model mesh."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distdiff_tpu.config import UNetConfig as JUNetConfig
from distdiff_tpu.models import UNet2DCondition
from distdiff_tpu.parallel import tp as j_tp
from distdiff_tpu_torch.config import UNetConfig
from distdiff_tpu_torch.models import UNet2DConditionModel
from distdiff_tpu_torch.ops import attention as attn_op
from distdiff_tpu_torch.ops import flash, quant
from distdiff_tpu_torch.parallel import tp
from distdiff_tpu_torch.parallel.mesh import P, make_expand_mesh
from distdiff_tpu_torch.weights.from_jax import key_table, state_dict_from_jax

torch.set_num_threads(1)
T = 3


@pytest.fixture(scope="module")
def tiny():
    """JAX params (numpy draws on eval_shape, no init compiled), inputs, the
    JAX TP forward on a 2 x 4 mesh, and the port's UNet on those weights."""
    rng = np.random.RandomState(0)
    cfg = JUNetConfig.tiny()
    x = rng.randn(4, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(4, 6, cfg.cross_attention_dim).astype(np.float32)
    mod = UNet2DCondition(cfg)
    shapes = jax.eval_shape(mod.init, jax.random.PRNGKey(0), x, jnp.array([1]), ctx)
    draw = np.random.default_rng(1)
    params = jax.tree.map(lambda s: (draw.standard_normal(s.shape) * 0.2).astype(np.float32),
                          shapes)
    mesh = j_tp.make_tp_mesh(2, 4)
    sh = j_tp.unet_param_shardings(mesh, params)
    bs = j_tp.batch_sharding(mesh)
    fwd = jax.jit(lambda p, xx, cc: mod.apply(p, xx, jnp.array([T]), cc),
                  in_shardings=(sh, bs, bs), out_shardings=bs)
    want = np.asarray(fwd(jax.device_put(params, sh), x, ctx))
    unet = UNet2DConditionModel(UNetConfig.tiny(), device="cpu")
    unet.load_state_dict(state_dict_from_jax(params["params"], UNetConfig.tiny()))
    unet.requires_grad_(False)
    return params, sh, x, ctx, want, unet


def test_the_sharding_rules_are_the_jax_packages(tiny):
    """Each port parameter's spec is its JAX leaf's, in torch's layout: a
    dense kernel ``[in, out]`` is the weight ``[out, in]``. The GEGLU's
    ``net.0.proj`` stays whole, as the JAX rule leaves it."""
    params, jsh, *_ = tiny
    flat = {"/".join(p.key for p in path if hasattr(p, "key")): s.spec for path, s in
            jax.tree_util.tree_flatten_with_path(jsh)[0]}
    mesh = make_expand_mesh(2, ["cpu"] * 2)
    got = tp.unet_param_shardings(mesh, UNet2DConditionModel(UNetConfig.tiny(), device="meta"))
    table = key_table(UNetConfig.tiny())
    split = 0
    for name, sharding in got.items():
        jspec = tuple(flat["params/" + table[name][0]])
        jspec = jspec + (None,) * (len(table[name][1]) - len(jspec))
        want = jspec[::-1] if len(table[name][1]) == 2 else jspec
        assert tuple(sharding.spec) + (None,) * (len(want) - len(sharding.spec)) == want, name
        split += any(a is not None for a in sharding.spec)
    assert split == 36  # q, k, v, out and net.2 of 6 transformer blocks, and attn2's
    assert got["mid_block.attentions.0.transformer_blocks.0.ff.net.0.proj.weight"].spec == P()


@pytest.mark.parametrize("n_model", [2, 4])
def test_tp_unet_matches_the_unsharded_call_and_jax(tiny, n_model):
    params, _, x, ctx, want, unet = tiny
    tx, tctx = torch.from_numpy(x), torch.from_numpy(ctx)
    xr = tx.clone().requires_grad_(True)
    ref = unet(xr, T, tctx)
    gref = torch.autograd.grad((ref ** 2).sum(), xr)[0]
    mesh = make_expand_mesh(n_model, ["cpu"] * n_model)
    tpu = tp.tensor_parallel(copy.deepcopy(unet), mesh,
                             shardings=tp.unet_param_shardings(mesh, unet))
    block = tpu.mid_block.attentions[0].transformer_blocks[0]
    assert block.attn1.local_heads == (n_model == 2)  # 2 heads: split, or whole over 4
    xt = tx.clone().requires_grad_(True)
    out = tpu(xt, T, tctx)
    g = torch.autograd.grad((out ** 2).sum(), xt)[0]
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), atol=2e-5, rtol=0)
    assert float((g - gref).abs().max() / gref.abs().max()) < 2e-5
    np.testing.assert_allclose(out.detach().numpy(), want, atol=2e-4, rtol=0)
    assert sorted(tpu.state_dict()) == sorted(unet.state_dict())


def test_tp_attention_routes_each_devices_heads():
    """``_tp_attention`` splits the heads over the model group holding q's
    device (the plain flash version on the CPU), or runs once when they do
    not divide; the context routes only the kernel calls (CUDA tensors)
    and is restored on exit."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(rng.randn(2, 300, 4, 8).astype(np.float32)) for _ in range(3))
    want = attn_op.xla_attention(q, k, v)
    for n in (2, 4, 3):
        mesh = make_expand_mesh(n, ["cpu"] * n)
        assert attn_op.model_group(mesh, q.device) == [torch.device("cpu")] * n
        got = attn_op._tp_attention(q, k, v, mesh, "model", 2, flash.flash_attention)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
        hm = attn_op._tp_attention(*(t.transpose(1, 2) for t in (q, k, v)), mesh, "model", 1,
                                   flash.flash_attention_hm)
        np.testing.assert_allclose(hm.transpose(1, 2).numpy(), want.numpy(), atol=1e-5, rtol=0)
    with attn_op.tp_sharded_attention(mesh):
        assert attn_op._TP_CTX["mesh"] is mesh
        assert torch.equal(attn_op.attention(q, k, v), attn_op.local_attention(q, k, v))
    assert attn_op._TP_CTX["mesh"] is None


def test_int8_row_parallel_equals_the_unsharded_layer(tiny):
    """Under int8 a row-parallel ``net.2`` takes the global scales and sums
    the int32 partials: tolerance 0 against the unsharded layer."""
    unet = tiny[-1]
    ff = unet.mid_block.attentions[0].transformer_blocks[0].ff
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 16, ff.net[2].out_features)
                         .astype(np.float32))
    tff = tp.TPFeedForward(ff, [torch.device("cpu")] * 2)
    with quant.int8_inference():
        assert torch.equal(tff(x), ff(x))


def test_tp_split_expand_matches_the_one_device_run():
    """The guided SplitExpand on a 2 x 2 data x model mesh (TP UNets) and
    on a 4-way data mesh against one device, on the same draws: 2e-5."""
    from distdiff_tpu_torch.config import GuidanceConfig, PipelineConfig
    from distdiff_tpu_torch.models.guide import create_model
    from distdiff_tpu_torch.sampling import ExpansionPipeline, SamplerConfig

    rng = np.random.RandomState(0)
    torch.manual_seed(0)
    guide = create_model("tiny_resnet", num_classes=4, device="cpu")
    pipe = ExpansionPipeline.create(
        PipelineConfig.tiny(sample_size=32), sampler_cfg=SamplerConfig(guidance_scale=3.0),
        guidance_cfg=GuidanceConfig(guidance_type="transform_guidance", guidance_step=4,
                                    guidance_period=2, K=2, guide_input_size=32),
        guide=guide, global_protos=rng.randn(4, guide.feature_dim).astype(np.float32),
        local_protos=rng.randn(4, 2, guide.feature_dim).astype(np.float32), device="cpu")
    ls = pipe.config.latent_size
    args = [torch.from_numpy(a) for a in (rng.randn(4, ls, ls, 4).astype(np.float32) * 0.2,
                                          rng.randn(4, 8, 32).astype(np.float32),
                                          rng.randn(4, 8, 32).astype(np.float32))]
    args.append(torch.arange(4) % 4)

    def gens():
        return [torch.Generator().manual_seed(i) for i in range(4)]

    ref = pipe.make_split_expand()(*args, gens())
    dp = pipe.make_split_expand(mesh=make_expand_mesh(1, ["cpu"] * 4), guide_chunk=4)
    np.testing.assert_allclose(dp(*args, gens()).numpy(), ref.numpy(), atol=2e-5, rtol=0)
    mesh = make_expand_mesh(2, ["cpu"] * 4)
    assert mesh.shape == {"data": 2, "model": 2}
    tpx = pipe.make_split_expand(mesh=mesh, param_shardings=tp.unet_param_shardings(mesh,
                                                                                     pipe.unet))
    assert isinstance(pipe.unet.mid_block.attentions[0].transformer_blocks[0].attn1,
                      tp.TPAttention)  # the pipeline's own UNet: one copy on the device
    np.testing.assert_allclose(tpx(*args, gens()).numpy(), ref.numpy(), atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="multiple of the data-axis size"):
        pipe.make_split_expand(mesh=mesh, guide_chunk=3)
