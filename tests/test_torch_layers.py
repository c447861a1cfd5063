"""The port's building blocks against the JAX package's Flax layers, with the
JAX parameters carried over by the port's key map."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distdiff_tpu.models import layers as jl
from distdiff_tpu_torch.models import layers as tl
from distdiff_tpu_torch.sampling.pipeline import resize_bicubic
from distdiff_tpu_torch.weights.from_jax import submodule_state_dict_from_jax

torch.set_num_threads(1)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _randomize(params, seed):
    """Random values for every leaf (norm scales/biases included)."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda p: (rng.randn(*p.shape) * 0.3 + (1.0 if p.ndim == 1 else 0.0)
                   ).astype(np.float32), params)


@pytest.mark.parametrize("c,act", [(32, None), (48, "silu"), (20, "silu"), (6, None), (40, "silu")])
def test_group_norm_matches_jax(c, act):
    """Includes channel counts where min(32, c) does not divide c (48 -> 24
    groups, 40 -> 20): the group-count rule must match."""
    rng = np.random.RandomState(c)
    x = (rng.randn(2, 5, 5, c) * 2 + 0.5).astype(np.float32)
    mod = jl.GroupNorm(dtype=jnp.float32, act=act)
    params = _randomize(mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], c)
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x)))
    gn = tl.GroupNorm(c, act=act, device="cpu")
    gn.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                        "bias": torch.from_numpy(params["bias"])})
    # fp32 statistics over 25*c/groups elements: 1e-5
    np.testing.assert_allclose(_nhwc(gn(_nchw(x))), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("cin,cout", [(48, 32), (40, 40)])
def test_resnet_block_matches_jax(cin, cout):
    rng = np.random.RandomState(cin)
    x = rng.randn(2, 8, 8, cin).astype(np.float32)
    temb = rng.randn(2, 64).astype(np.float32)
    mod = jl.ResnetBlock(cout, dtype=jnp.float32)
    params = _randomize(mod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                 jnp.asarray(temb))["params"], cout)
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x), jnp.asarray(temb)))
    blk = tl.ResnetBlock2D(cin, cout, temb_channels=64, device="cpu")
    blk.load_state_dict(submodule_state_dict_from_jax(
        params, blk, "unet", "down_blocks.0.resnets.0."))
    got = _nhwc(blk(_nchw(x), torch.from_numpy(temb)))
    # two 3x3 convs over <= 48 channels of O(1) values, fp32: 1e-5 relative
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("depth,side", [(1, 6), (2, 17)])
def test_spatial_transformer_matches_jax(depth, side):
    """GN -> proj_in -> (self-attn, cross-attn, GEGLU with tanh gelu, flax's
    LayerNorm eps 1e-6) x depth -> proj_out; side 17 gives 289 tokens, past
    the 256-token dispatch threshold."""
    rng = np.random.RandomState(depth)
    x = rng.randn(2, side, side, 32).astype(np.float32)
    ctx = rng.randn(2, 8, 24).astype(np.float32)
    mod = jl.SpatialTransformer(num_heads=2, head_dim=16, depth=depth, dtype=jnp.float32)
    params = _randomize(mod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                 jnp.asarray(ctx))["params"], depth)
    want = np.asarray(mod.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx)))
    st = tl.Transformer2DModel(32, 2, 16, 24, depth=depth, device="cpu")
    st.load_state_dict(submodule_state_dict_from_jax(
        params, st, "unet", "down_blocks.0.attentions.0."))
    got = _nhwc(st(_nchw(x), torch.from_numpy(ctx)))
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("dim", [32, 33, 320])
def test_timestep_embedding_and_mlp_match_jax(dim):
    t = np.array([1, 381, 981], np.int32)
    want = np.asarray(jl.timestep_embedding(jnp.asarray(t), dim))
    got = tl.timestep_embedding(torch.from_numpy(t), dim).numpy()
    # fp32 cos/sin of arguments t * freq up to ~981 rad: one ulp of freq
    # (exp computed by XLA vs torch) moves the argument by up to
    # 981 * 1.2e-7 ~ 1.2e-4, so 2e-4 absolute
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)

    mlp = jl.TimestepMLP(4 * dim, dtype=jnp.float32)
    params = _randomize(mlp.init(jax.random.PRNGKey(0), jnp.asarray(want))["params"], dim)
    mwant = np.asarray(mlp.apply({"params": params}, jnp.asarray(want)))
    te = tl.TimestepEmbedding(dim, 4 * dim, device="cpu")
    te.load_state_dict(submodule_state_dict_from_jax(params, te, "unet", "time_embedding."))
    mgot = te(torch.from_numpy(want.copy())).detach().numpy()
    np.testing.assert_allclose(mgot, mwant, atol=1e-5 * np.abs(mwant).max(), rtol=0)


@pytest.mark.parametrize("src,dst", [(512, 224), (48, 32)])
def test_bicubic_resize_matches_jax(src, dst):
    """jax.image.resize's bicubic antialiases when downsampling; torch's
    antialiased bicubic matches it, its default does not."""
    rng = np.random.RandomState(src)
    img = rng.uniform(-1, 1, (2, src, src, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(img), (2, dst, dst, 3), "bicubic"))
    got = resize_bicubic(torch.from_numpy(img), dst).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(img).permute(0, 3, 1, 2), size=(dst, dst), mode="bicubic",
        align_corners=False).permute(0, 2, 3, 1).numpy()
    assert np.abs(plain - want).max() > 1e-2
