"""The port's guide zoo against the JAX package's on the CPU: ResNeXt and
Wide ResNet (ResNet-50's topology with the JAX ``groups``,
``width_per_group`` and ``width_mult`` fields, cut to two stages of one
block) and MobileNetV2 at full width, on weights drawn with numpy in the
JAX tree and carried across by ``weights/from_jax.py``: ``encode_image``
(avg and max), logits, one training forward's output and BatchNorm running
statistics, and the input gradient of the summed per-sample hierarchical
energy. Then each full-width arch's geometry against the JAX module's,
key for key and shape for shape (``jax.eval_shape``, the port on the meta
device), and its parameter total against the published one; both guide
loaders on torchvision-layout state dicts and the JAX tree saved flat;
``freeze_backbone`` on MobileNetV2 against the JAX ``train_fc`` mask.

Tolerance: fp32 on both sides (the JAX tests run at "highest" matmul
precision); outputs within TOL = 1e-5 of their largest magnitude and 1e-4
relative, which summation order alone stays within (about 1e-6 here); the
training forward at TRAIN_TOL (its test says why)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distdiff_tpu.guidance.energy import hierarchical_energy_per_sample as j_energy
from distdiff_tpu.models.guide.clip_vit import CLIPViT as JCLIPViT
from distdiff_tpu.models.guide.clip_vit import CLIPViTConfig as JCLIPViTConfig
from distdiff_tpu.models.guide.factory import GuideModel as JGuideModel
from distdiff_tpu.models.guide.factory import load_weights as j_load_weights
from distdiff_tpu.models.guide.mobilenet import MobileNetV2 as JMobileNetV2
from distdiff_tpu.models.guide.mobilenet import MobileNetV2Config as JMobileNetV2Config
from distdiff_tpu.models.guide.resnet import ResNet as JResNet
from distdiff_tpu.models.guide.resnet import ResNetConfig as JResNetConfig
from distdiff_tpu.train import TrainConfig as JTrainConfig
from distdiff_tpu.train import make_optimizer as j_make_optimizer
from distdiff_tpu_torch.guidance import hierarchical_energy_per_sample
from distdiff_tpu_torch.models.guide.clip_vit import CLIPViT, CLIPViTConfig
from distdiff_tpu_torch.models.guide.factory import (
    ARCHS,
    GuideModel,
    create_model,
    load_weights,
    zero_shot_text_config,
)
from distdiff_tpu_torch.models.guide.mobilenet import MobileNetV2, MobileNetV2Config
from distdiff_tpu_torch.models.guide.resnet import (
    ResNet,
    ResNetConfig,
    resnext50_config,
    wideresnet50_config,
)
from distdiff_tpu_torch.models.text_encoder import CLIPTextEncoder
from distdiff_tpu_torch.train.classifier import freeze_backbone
from distdiff_tpu_torch.weights.from_jax import key_table, state_dict_from_jax
from distdiff_tpu_torch.weights.openclip import (
    CLIP_VIT_B32_TOTAL,
    openclip_vit_b32_state_shapes,
    state_size,
)
from torch_parity import flat_variables, seeded_variables

torch.set_num_threads(1)

C, K, B = 5, 3, 2
TOL = 1e-5        # of the largest magnitude; 10x that relative
TRAIN_TOL = 5e-4  # the training forward (see its test)
SIDE = 64  # MobileNetV2's last map is 2x2 here, so max and avg pooling differ

# arch -> (JAX config, port config) at the reduced depth the tests run
CFGS = {
    "resnext50": (JResNetConfig(stage_sizes=(1, 1), base_width=32, groups=8, width_per_group=4,
                                num_classes=C),
                  ResNetConfig(stage_sizes=(1, 1), base_width=32, groups=8, width_per_group=4,
                               num_classes=C)),
    "wideresnet50": (JResNetConfig(stage_sizes=(1, 1), base_width=16, width_mult=2.0,
                                   num_classes=C),
                     ResNetConfig(stage_sizes=(1, 1), base_width=16, width_mult=2.0,
                                  num_classes=C)),
    "mobilenetv2": (JMobileNetV2Config(num_classes=C), MobileNetV2Config(num_classes=C)),
}
CNNS = tuple(CFGS)


def _modules(arch):
    jcfg, cfg = CFGS[arch]
    if arch == "mobilenetv2":
        return JMobileNetV2(jcfg), MobileNetV2(cfg, device="cpu"), cfg
    return JResNet(jcfg), ResNet(cfg, device="cpu"), cfg


def _protos(dim, seed):
    rng = np.random.default_rng(seed)
    gp = rng.standard_normal((C, dim)).astype(np.float32)
    lp = rng.standard_normal((C, K, dim)).astype(np.float32)
    return gp, lp


def _jax_outputs(jmodule):
    """One jitted function of (variables, x, targets, prototypes) giving
    every JAX value the tests compare: features by pooling, logits, the
    training forward and its batch_stats, the energy's input gradient."""
    def fn(v, x, t, gp, lp):
        def enc(x, pooling):
            return jmodule.apply(v, x, pooling, method=jmodule.encode_image)

        out, mut = jmodule.apply(v, x, train=True, mutable=["batch_stats"])
        grad = jax.grad(lambda x: j_energy(enc(x, "avg"), t, gp, lp).sum())(x)
        return {"avg": enc(x, "avg"), "max": enc(x, "max"), "logits": jmodule.apply(v, x),
                "train_logits": out, "batch_stats": mut["batch_stats"], "grad": grad}
    return jax.jit(fn)


@pytest.fixture(scope="module")
def cases():
    """Per CNN: the JAX module, its seeded variables, the inputs, the JAX
    outputs and the jitted function that gave them (reused with other
    weights)."""
    out = {}
    for i, arch in enumerate(CNNS):
        jmodule, _, cfg = _modules(arch)
        rng = np.random.default_rng(10 + i)
        x = rng.uniform(-1, 1, (B, SIDE, SIDE, 3)).astype(np.float32)
        t = np.array([1, 3], np.int32)
        variables = seeded_variables(jmodule, x, seed=i)
        fn = _jax_outputs(jmodule)
        dim = 1280 if arch == "mobilenetv2" else cfg.feature_dim
        gp, lp = _protos(dim, i)
        want = jax.tree.map(np.asarray, fn(variables, x, t, gp, lp))
        out[arch] = dict(jmodule=jmodule, variables=variables, x=x, t=t, gp=gp, lp=lp,
                         want=want, fn=fn)
    return out


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.detach().numpy() if isinstance(want, torch.Tensor) else want
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=10 * tol, atol=tol * scale)


def _port(arch, variables):
    _, module, cfg = _modules(arch)
    module.load_state_dict(state_dict_from_jax(variables, cfg))
    module.requires_grad_(False)
    return module


@pytest.mark.parametrize("arch", CNNS)
@pytest.mark.parametrize("pooling", ["avg", "max"])
def test_encode_image_matches_jax(cases, arch, pooling):
    c = cases[arch]
    module = _port(arch, c["variables"])
    got = module.encode_image(torch.from_numpy(c["x"]), pooling)
    assert got.shape == c["want"][pooling].shape
    _close(got, c["want"][pooling])
    if pooling == "max":  # the two poolings differ at this size
        assert np.abs(c["want"]["max"] - c["want"]["avg"]).max() > 1e-2


@pytest.mark.parametrize("arch", CNNS)
def test_logits_match_jax(cases, arch):
    c = cases[arch]
    module = _port(arch, c["variables"])
    with torch.no_grad():
        logits = module(torch.from_numpy(c["x"]))
    assert logits.shape == (B, C)
    _close(logits, c["want"]["logits"])


@pytest.mark.parametrize("arch", CNNS)
def test_training_forward_and_batchnorm_statistics_match_jax(cases, arch):
    """One forward in training mode: the output on the batch's statistics,
    and the running statistics flax's momentum-0.9 rule writes. Each
    BatchNorm normalises by the variance of B * h * w values a channel
    (8 at MobileNetV2's last stage), which flax takes as E[x^2] - E[x]^2
    and torch in two passes; over MobileNetV2's 52 BatchNorms the fp32
    difference grows to about 1e-4 of the output (6e-5 at 96^2), so these
    are held at TRAIN_TOL. A wrong statistic (the unbiased variance, the
    momentum) moves them by 1e-2 or more."""
    c = cases[arch]
    _, _, cfg = _modules(arch)
    module = _port(arch, c["variables"]).train()
    with torch.no_grad():
        out = module(torch.from_numpy(c["x"]))
    _close(out, c["want"]["train_logits"], TRAIN_TOL)
    want = state_dict_from_jax({"params": c["variables"]["params"],
                                "batch_stats": c["want"]["batch_stats"]}, cfg)
    before = state_dict_from_jax(c["variables"], cfg)
    got = module.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 10
    for k in stats:
        _close(got[k], want[k], TRAIN_TOL)
        assert not torch.equal(got[k], before[k]), f"{k} did not move"


@pytest.mark.parametrize("arch", CNNS)
def test_energy_input_gradient_matches_jax(cases, arch):
    """The guidance's gradient through the guide: d/dx of the summed
    per-sample hierarchical energy of ``encode_image(x)``."""
    c = cases[arch]
    module = _port(arch, c["variables"])
    x = torch.from_numpy(c["x"]).requires_grad_(True)
    e = hierarchical_energy_per_sample(module.encode_image(x), torch.from_numpy(c["t"]).long(),
                                       torch.from_numpy(c["gp"]), torch.from_numpy(c["lp"]))
    e.sum().backward()
    assert float(np.abs(c["want"]["grad"]).max()) > 0
    _close(x.grad, c["want"]["grad"])


# --------------------------------------------------------- full geometry

def _full(arch):
    """(JAX module, port config, input side) of the full-width arch."""
    if arch == "resnext50":
        from distdiff_tpu.models.guide.resnet import resnext50_config as j_cfg

        return JResNet(j_cfg(1000)), resnext50_config(1000), 64
    if arch == "wideresnet50":
        from distdiff_tpu.models.guide.resnet import wideresnet50_config as j_cfg

        return JResNet(j_cfg(1000)), wideresnet50_config(1000), 64
    if arch == "mobilenetv2":
        return JMobileNetV2(JMobileNetV2Config()), MobileNetV2Config(), 64
    return JCLIPViT(JCLIPViTConfig()), CLIPViTConfig(), 224


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


@pytest.mark.parametrize("arch", ["resnext50", "wideresnet50", "mobilenetv2",
                                  "open_clip_vit_b32"])
def test_full_width_geometry_matches_the_jax_module_key_for_key(arch):
    jmodule, cfg, side = _full(arch)
    shapes = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, side, side, 3)))
    want = _flat(dict(shapes))
    got = {path: shape for path, shape, _ in key_table(cfg).values()}
    assert got == want


@pytest.mark.parametrize("arch,total", [("resnext50", 25_028_904), ("wideresnet50", 68_883_240),
                                        ("mobilenetv2", 3_504_872),
                                        ("open_clip_vit_b32", CLIP_VIT_B32_TOTAL)])
def test_full_width_parameter_totals_are_the_published_ones(arch, total):
    """torchvision's resnext50_32x4d, wide_resnet50_2 and mobilenet_v2 at
    1000 classes; CLIP ViT-B/32 is the image tower, the B/32 text tower
    and ``logit_scale``, as the OpenCLIP state enumerates it."""
    def count(m):
        return sum(p.numel() for p in m.parameters())

    if arch == "open_clip_vit_b32":
        n = (count(CLIPViT(CLIPViTConfig(), device="meta"))
             + count(CLIPTextEncoder(zero_shot_text_config(), device="meta")) + 1)
        assert state_size(openclip_vit_b32_state_shapes()) == total
        gm = create_model(arch, 1000, device="meta")
        assert gm.feature_dim == 512
    else:
        gm = create_model(arch, 1000, device="meta")
        n = count(gm.module)
        assert gm.feature_dim == (1280 if arch == "mobilenetv2" else 2048)
    assert n == total


def test_create_model_builds_every_jax_arch():
    from distdiff_tpu.models.guide.factory import ARCHS as J_ARCHS

    assert ARCHS == J_ARCHS
    with pytest.raises(ValueError, match="unknown arch"):
        create_model("vit_h14", 3, device="meta")


# ------------------------------------------------------------ the loaders

def _perturbed(variables, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a * (1 + 0.05 * rng.standard_normal(a.shape))).astype(
        np.float32), variables)


@pytest.mark.parametrize("arch", CNNS)
def test_torchvision_state_dicts_load_in_both_loaders(cases, arch, tmp_path):
    """A reference ``checkpoint.pth.tar`` in torchvision's names (a
    ``module.`` prefix, bookkeeping beside it) through both packages'
    ``load_weights``: the same features."""
    c = cases[arch]
    _, module, cfg = _modules(arch)
    new = _perturbed(c["variables"], 7)
    state = state_dict_from_jax(new, cfg)
    path = str(tmp_path / "guide.pth.tar")
    torch.save({"epoch": 3, "state_dict": {"module." + k: v for k, v in state.items()}}, path)
    jgm = JGuideModel(arch=arch, module=c["jmodule"], variables=jax.tree.map(
        jnp.asarray, c["variables"]), feature_dim=0, num_classes=C)
    j_load_weights(jgm, path)
    gm = GuideModel(arch=arch, module=module.requires_grad_(False), feature_dim=0,
                    num_classes=C)
    load_weights(gm, path)
    want = c["fn"](jgm.variables, c["x"], c["t"], c["gp"], c["lp"])
    _close(gm.encode_image(torch.from_numpy(c["x"])), np.asarray(want["avg"]))
    assert np.abs(np.asarray(want["avg"]) - c["want"]["avg"]).max() > 1e-4  # new weights


@pytest.mark.parametrize("arch", CNNS + ("open_clip_vit_b32",))
def test_the_jax_tree_saved_flat_loads_for_every_arch(cases, arch, tmp_path):
    if arch == "open_clip_vit_b32":
        from distdiff_tpu.models.guide.clip_vit import tiny_clip_vit_config as j_tiny

        from distdiff_tpu_torch.models.guide.clip_vit import tiny_clip_vit_config

        cfg = tiny_clip_vit_config()
        variables = seeded_variables(JCLIPViT(j_tiny()), np.zeros((1, 32, 32, 3)), 3)
        module = CLIPViT(cfg, device="cpu")
    else:
        _, module, cfg = _modules(arch)
        variables = cases[arch]["variables"]
    path = str(tmp_path / "guide.npz")
    np.savez(path, **flat_variables(variables))
    gm = GuideModel(arch=arch, module=module, feature_dim=0, num_classes=C)
    load_weights(gm, path)
    want = state_dict_from_jax(variables, cfg)
    got = gm.module.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], v), k


def test_freeze_backbone_on_mobilenetv2_is_the_jax_mask(cases):
    """The leaves ``freeze_backbone`` leaves trainable are those the JAX
    ``train_fc`` mask selects (``classifier`` here, not ``fc``)."""
    c = cases["mobilenetv2"]
    _, module, cfg = _modules("mobilenetv2")
    freeze_backbone(module)
    table = key_table(cfg)
    got = {table[n][0] for n, p in module.named_parameters() if p.requires_grad}
    # the JAX mask, read from the masked optimiser's state: a masked-out
    # leaf holds optax's MaskedNode in place of a momentum trace
    tx = j_make_optimizer(JTrainConfig(train_fc_only=True), 1)
    state = tx.init(c["variables"]["params"])
    traces = [s for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda n: isinstance(n, optax.TraceState))
        if isinstance(s, optax.TraceState)]
    assert len(traces) == 1
    want = {"params/" + "/".join(k.key for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(traces[0].trace)[0]}
    assert got == want == {"params/classifier/kernel", "params/classifier/bias"}
    with pytest.raises(ValueError, match="no"):  # the CLIP ViT has no head to train
        freeze_backbone(create_model("open_clip_vit_b32", 3, device="meta").module)



def test_open_clip_trains_as_the_jax_trainer_does(monkeypatch):
    """``-a open_clip_vit_b32`` in the trainers: the JAX trainer's
    classifier is the image tower itself (its logits are the embedding,
    no zero-shot head, no BatchNorm), trained by the same SGD; one step of
    each trainer from the same weights (the tiny tower, batch 8 of 32^2,
    targets below its 16-wide embedding): the same loss, accuracy and
    updated weights."""
    import distdiff_tpu_torch.models.guide.factory as factory
    from distdiff_tpu.models.guide.clip_vit import tiny_clip_vit_config as j_tiny
    from distdiff_tpu.train import create_train_state as j_create_train_state
    from distdiff_tpu.train import make_train_step as j_make_train_step

    from distdiff_tpu_torch.models.guide.clip_vit import tiny_clip_vit_config
    from distdiff_tpu_torch.train import (
        TrainConfig,
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    rng = np.random.default_rng(9)
    x = rng.uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 16, 8).astype(np.int32)
    m = np.ones(8, bool)
    jmodule = JCLIPViT(j_tiny())
    variables = seeded_variables(jmodule, x, 5)
    tx = j_make_optimizer(JTrainConfig(lr=0.1, epochs=1), 1)
    jstate = j_create_train_state(jmodule, jax.tree.map(jnp.asarray, variables), tx)
    jstate, jm = j_make_train_step(jmodule, tx)(jstate, x, y, m)

    monkeypatch.setattr(factory, "CLIPViTConfig", tiny_clip_vit_config)
    gm = create_model("open_clip_vit_b32", 3, device="cpu", trainable=True)
    assert gm.module.training and all(p.requires_grad for p in gm.module.parameters())
    gm.module.load_state_dict(state_dict_from_jax(variables, tiny_clip_vit_config()))
    ptx = make_optimizer(gm.module, TrainConfig(lr=0.1, epochs=1), 1)
    state, pm = make_train_step(gm.module, ptx)(create_train_state(gm.module, ptx), x, y, m)
    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
    assert float(pm["acc"]) == pytest.approx(float(jm["acc"]), abs=1e-4)
    want = state_dict_from_jax({"params": jax.tree.map(np.asarray, jstate.params)},
                               tiny_clip_vit_config())
    got = state.module.state_dict()
    before = state_dict_from_jax(variables, tiny_clip_vit_config())
    for k, w in want.items():  # fp32 parameters of order 0.1: a few ulps
        torch.testing.assert_close(got[k], w, atol=1e-6, rtol=0, msg=k)
    assert max(float((w - before[k]).abs().max()) for k, w in want.items()) > 1e-3
