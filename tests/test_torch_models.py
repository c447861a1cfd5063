"""The port's UNet, VAE and guide ResNet against the JAX package's at the
tiny configs, and the strictness and coverage of ``state_dict_from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distdiff_tpu.config import UNetConfig as JUNetConfig
from distdiff_tpu.config import VAEConfig as JVAEConfig
from distdiff_tpu.models import AutoencoderKL as JAutoencoderKL
from distdiff_tpu.models import UNet2DCondition
from distdiff_tpu.models.guide import create_model as j_create_model
from distdiff_tpu.models.guide.resnet import ResNet as JResNet
from distdiff_tpu.models.guide.resnet import resnet50_config as j_resnet50_config
from distdiff_tpu_torch.config import UNetConfig, VAEConfig
from distdiff_tpu_torch.models import AutoencoderKL, UNet2DConditionModel
from distdiff_tpu_torch.models.guide import create_model
from distdiff_tpu_torch.models.guide.resnet import resnet50_config, tiny_resnet_config
from distdiff_tpu_torch.weights.from_jax import key_table, state_dict_from_jax

torch.set_num_threads(1)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


@pytest.fixture(scope="module")
def unet_params():
    rng = np.random.RandomState(0)
    lat = rng.randn(2, 24, 24, 4).astype(np.float32)
    ctx = rng.randn(2, 8, 32).astype(np.float32)
    mod = UNet2DCondition(JUNetConfig.tiny())
    params = jax.jit(mod.init)(jax.random.PRNGKey(0), jnp.asarray(lat), jnp.array([1]),
                               jnp.asarray(ctx))["params"]
    return mod, params, lat, ctx


@pytest.fixture(scope="module")
def vae_params():
    img = np.random.RandomState(1).uniform(-1, 1, (2, 48, 48, 3)).astype(np.float32)
    mod = JAutoencoderKL(JVAEConfig.tiny())
    return mod, jax.jit(mod.init)(jax.random.PRNGKey(1), jnp.asarray(img))["params"], img


def test_unet_matches_jax(unet_params):
    mod, params, lat, ctx = unet_params
    t = np.array([501, 21])
    want = np.asarray(jax.jit(mod.apply)({"params": params}, jnp.asarray(lat),
                                         jnp.asarray(t), jnp.asarray(ctx)))
    unet = UNet2DConditionModel(UNetConfig.tiny(), device="cpu")
    unet.load_state_dict(state_dict_from_jax(_np(params), UNetConfig.tiny()))
    with torch.no_grad():
        got = unet(torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(ctx)).numpy()
    assert got.shape == want.shape == (2, 24, 24, 4)
    # fp32 through ~20 layers (576-token attention included): 1e-4
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_vae_encode_decode_match_jax(vae_params):
    mod, params, img = vae_params
    vae = AutoencoderKL(VAEConfig.tiny(), device="cpu")
    vae.load_state_dict(state_dict_from_jax(_np(params), VAEConfig.tiny()))
    z = np.random.RandomState(2).randn(2, 24, 24, 4).astype(np.float32)
    want_dec = np.asarray(jax.jit(lambda p, z: mod.apply(p, z, method=mod.decode))(
        {"params": params}, jnp.asarray(z)))
    want_mean, want_logvar = jax.jit(lambda p, x: mod.apply(p, x, method=mod.encode_moments))(
        {"params": params}, jnp.asarray(img))
    with torch.no_grad():
        dec = vae.decode(torch.from_numpy(z)).numpy()
        mean, logvar = vae.encode_moments(torch.from_numpy(img))
    assert dec.shape == (2, 48, 48, 3)
    np.testing.assert_allclose(dec, want_dec, atol=1e-4, rtol=0)
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), atol=1e-4, rtol=0)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(want_logvar), atol=1e-4, rtol=0)


@pytest.mark.parametrize("pooling", ["avg", "max"])
def test_tiny_guide_encode_image_matches_jax(pooling):
    jg = j_create_model("tiny_resnet", num_classes=3, input_size=32)
    guide = create_model("tiny_resnet", num_classes=3, device="cpu")
    guide.module.load_state_dict(state_dict_from_jax(_np(jg.variables), tiny_resnet_config(3)))
    x = np.random.RandomState(3).rand(2, 32, 32, 3).astype(np.float32)
    want = np.asarray(jg.encode_image(jnp.asarray(x), pooling))
    got = guide.encode_image(torch.from_numpy(x), pooling).numpy()
    assert got.shape == (2, guide.feature_dim)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_state_dict_from_jax_is_strict(unet_params):
    params = _np(unet_params[1])
    cfg = UNetConfig.tiny()
    missing = dict(params)
    missing["conv_in"] = {"kernel": params["conv_in"]["kernel"]}  # no bias
    with pytest.raises(KeyError, match="missing"):
        state_dict_from_jax(missing, cfg)
    extra = dict(params)
    extra["stray"] = {"kernel": np.zeros((3, 3), np.float32)}
    with pytest.raises(KeyError, match="unused"):
        state_dict_from_jax(extra, cfg)
    wrong = dict(params)
    wrong["conv_in"] = dict(params["conv_in"], bias=np.zeros(7, np.float32))
    with pytest.raises(ValueError, match="shape"):
        state_dict_from_jax(wrong, cfg)


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


@pytest.mark.parametrize("which", ["unet", "vae", "resnet50"])
def test_key_map_covers_sd15_geometry(which):
    """Every JAX leaf of the SD-1.5 geometry (and of the ResNet-50 guide) has
    exactly one port key of the matching shape. Shapes only: the JAX side is
    jax.eval_shape, the port side is built on the meta device."""
    key = jax.random.PRNGKey(0)
    if which == "unet":
        want = jax.eval_shape(
            UNet2DCondition(JUNetConfig.sd15()).init, key,
            jnp.zeros((1, 8, 8, 4)), jnp.array([1]), jnp.zeros((1, 77, 768)))["params"]
        table = key_table(UNetConfig.sd15())
    elif which == "vae":
        want = jax.eval_shape(JAutoencoderKL(JVAEConfig.sd15()).init, key,
                              jnp.zeros((1, 64, 64, 3)))["params"]
        table = key_table(VAEConfig.sd15())
    else:
        want = jax.eval_shape(JResNet(j_resnet50_config(100)).init, key,
                              jnp.zeros((1, 64, 64, 3)))
        table = key_table(resnet50_config(100))
    want = _shapes(want)
    got = {path: shape for path, shape, _ in table.values()}
    assert len(got) == len(table)  # one JAX leaf per port key
    assert got == want
