"""The port's OpenCLIP guide against the JAX package's on the CPU: the
OpenCLIP state enumeration, both converters on one shrunk OpenCLIP state
(leaf for leaf, from ``.safetensors`` and ``.pt`` files, with and without
the OpenAI markers, through ``load_openclip_checkpoint`` and through each
factory's ``load_weights``), the tiny CLIP ViT's ``encode_image`` and its
energy gradient, ``zero_shot_logits``, and ``build_zero_shot_text_features``
on the converted text tower under both activations.

The shrunk state has OpenCLIP's layout at image 32, patch 8, widths 32,
two layers a tower, embed 16, a 600-token vocabulary and 32 positions;
its values are normal with std 0.02 (as OpenCLIP initialises; the
LayerNorm scales about 1, ``ln_pre``'s 0.05), so the residual streams
have variances of 1e-3 to 3e-2 and every LayerNorm's eps matters: the
image tower is held at 1e-6 absolute (its outputs are of order 0.1), and
one LayerNorm with torch's default eps (1e-5 for flax's 1e-6) moves them
by 3e-5 (a block's ``ln_1``) to 9e-4 (``ln_pre``). The text features and logits are held at 1e-5 of their largest
magnitude. The converters only move bytes, so their leaves are held equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distdiff_tpu.config import TextEncoderConfig as JTextEncoderConfig
from distdiff_tpu.guidance.energy import hierarchical_energy_per_sample as j_energy
from distdiff_tpu.models.guide.clip_vit import CLIPViT as JCLIPViT
from distdiff_tpu.models.guide.clip_vit import tiny_clip_vit_config as j_tiny_config
from distdiff_tpu.models.guide.clip_vit import zero_shot_logits as j_zero_shot_logits
from distdiff_tpu.models.guide.factory import GuideModel as JGuideModel
from distdiff_tpu.models.guide.factory import (
    build_zero_shot_text_features as j_build_zero_shot,
)
from distdiff_tpu.models.guide.factory import load_weights as j_load_weights
from distdiff_tpu.weights.openclip import load_openclip_checkpoint as j_load_openclip
from distdiff_tpu.weights.openclip import (
    openclip_vit_b32_state_shapes as j_state_shapes,
)
from distdiff_tpu_torch.config import TextEncoderConfig
from distdiff_tpu_torch.guidance import hierarchical_energy_per_sample
from distdiff_tpu_torch.models.guide.clip_vit import (
    CLIPViT,
    tiny_clip_vit_config,
    zero_shot_logits,
)
from distdiff_tpu_torch.models.guide.factory import (
    GuideModel,
    build_zero_shot_text_features,
    load_weights,
)
from distdiff_tpu_torch.weights.from_jax import state_dict_from_jax
from distdiff_tpu_torch.weights.openclip import (
    CLIP_VIT_B32_TOTAL,
    load_openclip_checkpoint,
    openclip_vit_b32_state_shapes,
    state_size,
)
from distdiff_tpu_torch.weights.safetensors import save_file

torch.set_num_threads(1)

SHRUNK = dict(image_size=32, patch=8, vw=32, vlayers=2, tw=32, tlayers=2, embed=16,
              vocab=600, ctx_len=32)
MARKERS = {"input_resolution": 224, "context_length": 77, "vocab_size": 49408}
CLASSES = ["cat", "dog", "bird"]
MERGES = "#version: 0.2\nc a</w>\nd o\ndo g</w>\n"
IMAGE_TOL = 1e-6  # absolute, on outputs of order 0.1
TOL = 1e-5        # of the largest magnitude


def _text_configs(activation):
    kw = dict(vocab_size=SHRUNK["vocab"], hidden_size=SHRUNK["tw"],
              num_layers=SHRUNK["tlayers"], num_heads=2, max_length=SHRUNK["ctx_len"],
              embed_dim=SHRUNK["embed"], activation=activation)
    return JTextEncoderConfig(dtype=jnp.float32, **kw), TextEncoderConfig(dtype=torch.float32,
                                                                          **kw)


@pytest.fixture(scope="module")
def state():
    """A shrunk OpenCLIP ViT-B/32 state dict of seeded numpy values."""
    rng = np.random.default_rng(0)
    out = {}
    for k, s in openclip_vit_b32_state_shapes(**SHRUNK).items():
        v = rng.standard_normal(s) * 0.02
        if k.endswith(("ln_1.weight", "ln_2.weight", "ln_post.weight", "ln_final.weight")):
            v = 1 + 0.1 * rng.standard_normal(s)
        elif k == "visual.ln_pre.weight":  # a small residual stream in the image tower
            v = 0.05 * (1 + 0.1 * rng.standard_normal(s))
        out[k] = np.asarray(v, np.float32)
    out["logit_scale"] = np.asarray(np.log(1 / 0.07), np.float32)
    return out


@pytest.fixture(scope="module")
def merges(tmp_path_factory):
    path = tmp_path_factory.mktemp("bpe") / "merges.txt"
    path.write_text(MERGES)
    return str(path)


def test_state_enumeration_is_the_jax_packages_and_the_published_total():
    assert openclip_vit_b32_state_shapes() == j_state_shapes()
    assert openclip_vit_b32_state_shapes(**SHRUNK) == j_state_shapes(**SHRUNK)
    assert state_size(openclip_vit_b32_state_shapes()) == CLIP_VIT_B32_TOTAL == 151_277_313


def _write(state, path, fmt, markers, prefix=""):
    """The state as a file: ``.safetensors``, or ``.pt`` with a
    ``state_dict`` entry (its keys under ``prefix``); the OpenAI markers
    as int64 scalars."""
    extra = {k: np.asarray(v, np.int64) for k, v in MARKERS.items()} if markers else {}
    if fmt == ".safetensors":
        save_file({**state, **extra}, path)
    else:
        torch.save({"epoch": 32, "state_dict": {
            prefix + k: torch.from_numpy(v) for k, v in {**state, **extra}.items()}}, path)


FILES = [(".safetensors", False), (".safetensors", True), (".pt", False), (".pt", True)]


@pytest.mark.parametrize("fmt,markers", FILES, ids=lambda v: str(v).strip("."))
def test_both_converters_give_the_same_leaves(state, tmp_path, fmt, markers):
    """``load_openclip_checkpoint`` (a ``.pt`` as OpenCLIP training saves
    it, under ``module.``; the markers left to the converters, which skip
    them with a warning)."""
    path = str(tmp_path / ("openclip" + fmt))
    _write(state, path, fmt, markers, prefix="module.")
    jvisual, jtext, jscale = j_load_openclip(path)
    visual, text, scale = load_openclip_checkpoint(path)
    want_v = state_dict_from_jax({"params": jax.tree.map(np.asarray, jvisual)},
                                 tiny_clip_vit_config())
    want_t = state_dict_from_jax(jax.tree.map(np.asarray, jtext), _text_configs("gelu")[1])
    for got, want in ((visual, want_v), (text, want_t)):
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k].float(), want[k]), k
    assert scale == pytest.approx(jscale, rel=1e-7) and scale == pytest.approx(1 / 0.07)


@pytest.mark.parametrize("fmt,markers", FILES, ids=lambda v: str(v).strip("."))
def test_both_factories_load_both_towers_and_detect_the_activation(state, tmp_path, fmt,
                                                                   markers):
    """``load_weights`` on the OpenCLIP file: the image tower into the
    guide, the text tower's weights beside it, the logit scale, and the
    text activation (quick_gelu with the OpenAI markers, gelu without), as
    the JAX factory sets them. Both take an OpenCLIP state by its
    ``visual.`` keys as they stand: under a ``module.`` prefix it is read
    as a plain state dict, and both refuse it."""
    path = str(tmp_path / ("openclip" + fmt))
    _write(state, path, fmt, markers)
    jgm, gm = _j_guide(), _guide()
    j_load_weights(jgm, path)
    load_weights(gm, path)
    assert gm.text_activation == jgm.text_activation == ("quick_gelu" if markers else "gelu")
    assert gm.logit_scale == pytest.approx(jgm.logit_scale, rel=1e-7)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jgm.variables), tiny_clip_vit_config())
    got = gm.module.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    want_t = state_dict_from_jax(jax.tree.map(np.asarray, jgm.text_variables["params"]),
                                 _text_configs("gelu")[1])
    assert all(torch.equal(gm.text_state[k].float(), want_t[k]) for k in want_t)
    if fmt == ".pt":
        _write(state, path, fmt, markers, prefix="module.")
        for load, guide in ((j_load_weights, _j_guide()), (load_weights, _guide())):
            with pytest.raises(ValueError):  # nothing matched, or a shape differs
                load(guide, path)


def _j_guide():
    jmodule = JCLIPViT(j_tiny_config())
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    return JGuideModel(arch="open_clip_vit_b32", module=jmodule,
                       variables=jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes),
                       feature_dim=16, num_classes=3)


def _guide(module=None):
    return GuideModel(arch="open_clip_vit_b32", feature_dim=16, num_classes=3,
                      module=CLIPViT(tiny_clip_vit_config()) if module is None else module)


def test_a_state_of_another_geometry_is_refused_by_both(state, tmp_path):
    path = str(tmp_path / "wide.safetensors")
    save_file({k: np.zeros(s, np.float32) for k, s in openclip_vit_b32_state_shapes(
        **dict(SHRUNK, vw=48)).items()}, path)
    gm = _guide()
    with pytest.raises(ValueError, match="OpenCLIP conversion mismatch"):
        load_weights(gm, path)


@pytest.fixture(scope="module")
def towers(state):
    """The JAX image tower's variables and the port's module, both from
    the converted state, the inputs, and the JAX outputs: features, the
    energy's input gradient, zero-shot logits."""
    from distdiff_tpu.weights.openclip import convert_openclip as j_convert

    from distdiff_tpu_torch.weights.openclip import convert_openclip

    jvisual, _, _ = j_convert(state)
    jmodule = JCLIPViT(j_tiny_config())
    jvars = {"params": jax.tree.map(jnp.asarray, jvisual)}
    module = CLIPViT(tiny_clip_vit_config())
    module.load_state_dict(convert_openclip(state)[0])
    module.requires_grad_(False)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    t = np.array([0, 2], np.int32)
    gp = rng.standard_normal((3, 16)).astype(np.float32)
    lp = rng.standard_normal((3, 2, 16)).astype(np.float32)
    txt = rng.standard_normal((3, 16)).astype(np.float32)

    @jax.jit
    def run(x):
        def enc(x):
            return jmodule.apply(jvars, x, method=jmodule.encode_image)

        f = enc(x)
        grad = jax.grad(lambda x: j_energy(enc(x), t, gp, lp).sum())(x)
        return f, grad, j_zero_shot_logits(f, txt)

    want = [np.asarray(a) for a in run(x)]
    return module, dict(x=x, t=t, gp=gp, lp=lp, txt=txt), want


def test_tiny_clip_vit_matches_jax(towers):
    module, inp, (feats, _, _) = towers
    got = module.encode_image(torch.from_numpy(inp["x"]))
    assert got.shape == (2, 16) and float(np.abs(feats).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), feats, atol=IMAGE_TOL, rtol=0)
    assert torch.equal(module(torch.from_numpy(inp["x"])), got)


def test_clip_vit_energy_gradient_matches_jax(towers):
    module, inp, (_, grad, _) = towers
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    hierarchical_energy_per_sample(module.encode_image(x), torch.from_numpy(inp["t"]).long(),
                                   torch.from_numpy(inp["gp"]),
                                   torch.from_numpy(inp["lp"])).sum().backward()
    scale = float(np.abs(grad).max())
    np.testing.assert_allclose(x.grad.numpy(), grad, atol=TOL * scale, rtol=0)


def test_zero_shot_logits_match_jax(towers):
    module, inp, (_, _, logits) = towers
    gm = _guide(module)
    x = torch.from_numpy(inp["x"])
    with pytest.raises(ValueError, match="class_text_features"):
        gm.logits(x)
    gm.class_text_features = torch.from_numpy(inp["txt"])
    got = gm.logits(x)
    assert torch.equal(got, zero_shot_logits(module(x), gm.class_text_features))
    np.testing.assert_allclose(got.numpy(), logits, atol=TOL * float(np.abs(logits).max()),
                               rtol=0)
    # the fixed scale 100, not the checkpoint's logit_scale
    f = np.ones((1, 4), np.float32)
    assert float(zero_shot_logits(torch.from_numpy(f), torch.from_numpy(f))) == \
        pytest.approx(100.0 * 4 / (2 + 1e-8) ** 2)


@pytest.mark.parametrize("activation", ["gelu", "quick_gelu"])
def test_zero_shot_head_matches_jax(state, merges, activation):
    """``build_zero_shot_text_features`` on the converted text tower, a
    dataset template and a minimal merges file, in both packages."""
    from distdiff_tpu.weights.openclip import convert_openclip as j_convert

    from distdiff_tpu_torch.weights.openclip import convert_openclip

    jcfg, cfg = _text_configs(activation)
    _, jtext, _ = j_convert(state)
    want = j_build_zero_shot(CLASSES, template="a photo of the {}.", bpe_path=merges,
                             config=jcfg, variables={"params": jtext})
    got = build_zero_shot_text_features(CLASSES, template="a photo of the {}.",
                                        bpe_path=merges, config=cfg,
                                        state=convert_openclip(state)[1], device="cpu")
    assert got.shape == (3, 16) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL * float(np.abs(want).max()), rtol=0)
    assert np.abs(got[0] - got[1]).max() > 1e-3


def test_a_real_text_tower_refuses_the_hash_tokenizer(state, monkeypatch, tmp_path):
    from distdiff_tpu_torch.weights.openclip import convert_openclip

    monkeypatch.delenv("DISTDIFF_CLIP_BPE", raising=False)
    _, cfg = _text_configs("gelu")
    with pytest.raises(RuntimeError, match="merges"):
        build_zero_shot_text_features(CLASSES, config=cfg, state=convert_openclip(state)[1],
                                      checkpoint_dir=str(tmp_path), device="cpu")
    # without a real tower the hash ids are allowed: seeded random features
    a = build_zero_shot_text_features(CLASSES, config=cfg, device="cpu")
    b = build_zero_shot_text_features(CLASSES, config=cfg, device="cpu")
    assert a.shape == (3, 16) and np.array_equal(a, b)
    assert not os.listdir(tmp_path)


def test_create_model_builds_the_zero_shot_head_from_class_names(state, merges, tmp_path,
                                                                  monkeypatch):
    """``create_model("open_clip_vit_b32", weight_path=..., class_names=...)``
    (the JAX factory's signature): the head from "a photo of a {}." through
    the file's text tower; ``class_text_features`` given takes its place."""
    import distdiff_tpu_torch.models.guide.factory as factory
    from distdiff_tpu_torch.weights.openclip import convert_openclip

    _, cfg = _text_configs("gelu")
    monkeypatch.setattr(factory, "CLIPViTConfig", tiny_clip_vit_config)
    monkeypatch.setattr(factory, "zero_shot_text_config", lambda activation: cfg)
    path = str(tmp_path / "openclip.safetensors")
    _write(state, path, ".safetensors", False)
    gm = factory.create_model("open_clip_vit_b32", 3, weight_path=path, class_names=CLASSES,
                              bpe_path=merges, device="cpu")
    want = build_zero_shot_text_features(CLASSES, bpe_path=merges, config=cfg,
                                         state=convert_openclip(state)[1], device="cpu")
    assert gm.feature_dim == 16 and np.array_equal(gm.class_text_features.numpy(), want)
    given = np.ones((3, 16), np.float32)
    gm = factory.create_model("open_clip_vit_b32", 3, weight_path=path, class_names=CLASSES,
                              class_text_features=given, device="cpu")
    assert np.array_equal(gm.class_text_features.numpy(), given)
