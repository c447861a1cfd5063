"""The port's trainer (``distdiff_tpu_torch/train``) against the JAX
package's on the CPU, at ``tiny_resnet`` with 7 classes, 32^2 images and
batches of 8 (one row on each of the JAX tests' 8 host devices): the train
step (Nesterov SGD, weight decay, the per-update cosine, ``accumulate=2``,
a padded tail, label smoothing) with its metrics, parameters and BatchNorm
running statistics; the eval step; ``train_fc`` on a frozen backbone; and a
run split between the two packages through the ``TrainState`` converter.

Both sides compute in fp32 from the same weights (the JAX init carried over
by ``weights/from_jax.py``) and the same numpy batches; they differ only in
summation order, about 5e-7 after four steps here. Tolerance: 1e-5
absolute on losses, weights and statistics; accuracies equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distdiff_tpu.models.guide.resnet import ResNet as JResNet
from distdiff_tpu.models.guide.resnet import tiny_resnet_config as j_tiny_config
from distdiff_tpu.train import TrainConfig as JTrainConfig
from distdiff_tpu.train import create_train_state as j_create_train_state
from distdiff_tpu.train import make_eval_step as j_make_eval_step
from distdiff_tpu.train import make_optimizer as j_make_optimizer
from distdiff_tpu.train import make_train_step as j_make_train_step
from distdiff_tpu_torch.models.guide import create_model
from distdiff_tpu_torch.models.guide.resnet import tiny_resnet_config
from distdiff_tpu_torch.train import (
    TrainConfig,
    create_train_state,
    cross_entropy,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from distdiff_tpu_torch.weights.from_jax import load_jax_train_state, state_dict_from_jax

torch.set_num_threads(1)

C, B, S = 7, 8, 32
ATOL = 1e-5
STEPS_PER_EPOCH = 2


@pytest.fixture(scope="module")
def init():
    """The JAX module and its initial variables as numpy."""
    module = JResNet(j_tiny_config(C))
    variables = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)))
    return module, jax.tree.map(np.asarray, variables)


def _batches(n=4, seed=0):
    """``n`` batches of B; the last holds 5 real rows, padded as the
    loader pads (the last real row repeated, masked out)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = rng.standard_normal((B, S, S, 3)).astype(np.float32)
        y = rng.integers(0, C, B).astype(np.int32)
        m = np.ones(B, bool)
        if i == n - 1:
            x[5:], y[5:], m[5:] = x[4], y[4], False
        out.append((x, y, m))
    return out


def _jax_side(module, variables, **cfg):
    ls = cfg.get("label_smoothing", 0.0)
    tx = j_make_optimizer(JTrainConfig(lr=0.1, epochs=2, weight_decay=5e-4, **cfg),
                          STEPS_PER_EPOCH)
    state = j_create_train_state(module, jax.tree.map(jnp.asarray, variables), tx)
    return state, j_make_train_step(module, tx, label_smoothing=ls)


def _port_side(variables, **cfg):
    ls = cfg.get("label_smoothing", 0.0)
    gm = create_model("tiny_resnet", C, device="cpu", trainable=True)
    gm.module.load_state_dict(state_dict_from_jax(variables, tiny_resnet_config(C)))
    tx = make_optimizer(gm.module, TrainConfig(lr=0.1, epochs=2, weight_decay=5e-4, **cfg),
                        STEPS_PER_EPOCH)
    return create_train_state(gm.module, tx), make_train_step(gm.module, tx,
                                                              label_smoothing=ls)


def _as_state_dict(jstate):
    return state_dict_from_jax(jax.tree.map(np.asarray, {
        "params": jstate.params, "batch_stats": jstate.batch_stats}), tiny_resnet_config(C))


def _assert_weights_close(module, want, keys=None):
    got = module.state_dict()
    keys = [k for k in (keys or want) if not k.endswith("num_batches_tracked")]
    for k in keys:
        torch.testing.assert_close(got[k], want[k], atol=ATOL, rtol=0, msg=k)


@pytest.mark.parametrize("accumulate,label_smoothing", [(1, 0.0), (2, 0.1)],
                         ids=["plain", "accumulate2_smoothing"])
def test_train_steps_match_the_jax_train_step(init, accumulate, label_smoothing):
    module, variables = init
    cfg = dict(accumulate=accumulate, label_smoothing=label_smoothing)
    jstate, jstep = _jax_side(module, variables, **cfg)
    state, step = _port_side(variables, **cfg)
    for x, y, m in _batches():
        jstate, jm = jstep(jstate, x, y, m)
        state, pm = step(state, x, y, m)
        assert abs(float(pm["loss"]) - float(jm["loss"])) <= ATOL
        assert float(pm["acc"]) == pytest.approx(float(jm["acc"]), abs=1e-4)
    want = _as_state_dict(jstate)
    _assert_weights_close(state.module, want)
    # the optimiser made 4 / accumulate updates on the cosine over 4
    assert state.tx.count == 4 // accumulate
    # the running variance, the statistic torch's own rule would get wrong
    bn = state.module.layer2[0].bn3
    assert bn.num_batches_tracked.item() == 4
    torch.testing.assert_close(bn.running_var, want["layer2.0.bn3.running_var"],
                               atol=ATOL, rtol=0)
    assert not torch.allclose(bn.running_var, torch.ones_like(bn.running_var))


@pytest.mark.parametrize("shape", [(2, 3, 3, 4), (8, 5, 5, 16), (4, 1, 1, 8)])
def test_batchnorm_running_statistics_follow_flax(shape):
    """Three training batches through the port's BatchNorm2d and flax's
    BatchNorm (momentum 0.9): the same outputs and running statistics, to
    1e-6; torch's own BatchNorm2d (the unbiased variance) is further off."""
    import flax.linen as nn

    from distdiff_tpu_torch.models.guide.resnet import BatchNorm2d

    rng = np.random.default_rng(sum(shape))
    jbn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    xs = [(rng.standard_normal(shape) * 2 + 1).astype(np.float32) for _ in range(3)]
    jvars = jbn.init(jax.random.PRNGKey(0), xs[0])
    port, stock = BatchNorm2d(shape[-1]), torch.nn.BatchNorm2d(shape[-1])
    for x in xs:
        jy, mut = jbn.apply(jvars, x, mutable=["batch_stats"])
        jvars = {"params": jvars["params"], "batch_stats": mut["batch_stats"]}
        tx = torch.from_numpy(x).permute(0, 3, 1, 2)
        y = port(tx)
        stock(tx)
        np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jy),
                                   atol=1e-5, rtol=0)
    want = np.asarray(jvars["batch_stats"]["var"])
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(jvars["batch_stats"]["mean"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(port.running_var.numpy(), want, atol=1e-6, rtol=0)
    assert np.abs(stock.running_var.numpy() - want).max() > 1e-4
    assert port.num_batches_tracked.item() == 3
    # eval mode is torchvision's own path, on the running statistics
    port.eval()
    stock.load_state_dict(port.state_dict())
    stock.eval()
    assert torch.equal(port(tx), stock(tx))


def test_eval_step_matches_the_jax_eval_step(init):
    module, variables = init
    # statistics that are not the initial ones
    rng = np.random.default_rng(3)
    stats = jax.tree.map(lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32),
                         variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    gm = create_model("tiny_resnet", C, device="cpu", trainable=True)
    gm.module.load_state_dict(state_dict_from_jax(variables, tiny_resnet_config(C)))
    jeval, peval = j_make_eval_step(module), make_eval_step(gm.module)
    for x, y, m in _batches(2, seed=5):
        want = jeval(variables["params"], variables["batch_stats"], x, y, m)
        got = peval(x, y, m)
        for g, w in zip(got, want):
            assert float(g) == pytest.approx(float(w), abs=ATOL * 10)
    # the port's eval leaves no trace on the module's statistics
    _assert_weights_close(gm.module, state_dict_from_jax(variables, tiny_resnet_config(C)))


def test_cross_entropy_masks_and_smooths_as_jax():
    from distdiff_tpu.train import cross_entropy as j_cross_entropy

    rng = np.random.default_rng(1)
    logits = rng.standard_normal((6, C)).astype(np.float32)
    y = rng.integers(0, C, 6)
    for mask in (np.ones(6, bool), np.array([1, 1, 0, 1, 0, 0], bool), np.zeros(6, bool)):
        for ls in (0.0, 0.2):
            want = float(j_cross_entropy(logits, y, mask, ls))
            got = float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(y),
                                      torch.from_numpy(mask), ls))
            assert got == pytest.approx(want, abs=1e-6)


def test_train_fc_follows_jax_on_a_frozen_backbone(init):
    """The JAX package's ``train_fc`` moves the backbone too (``optax.masked``
    passes a masked-out leaf's gradient through as its update; ROADMAP §3),
    so its reference here is held to a frozen backbone: after each JAX step
    every parameter but the fc layer's is set back to its initial value,
    and the BatchNorm statistics the step wrote are kept. The port's fc and
    running statistics follow that reference; its backbone's parameters do
    not move at all, its buffers do."""
    module, variables = init
    jstate, jstep = _jax_side(module, variables, train_fc_only=True)
    state, step = _port_side(variables, train_fc_only=True)
    before = {k: v.clone() for k, v in state.module.state_dict().items()}
    frozen = {k: v for k, v in variables["params"].items() if k != "fc"}
    for x, y, m in _batches(3, seed=7):
        jstate, jm = jstep(jstate, x, y, m)
        jstate = jstate.replace(
            params={**jax.tree.map(jnp.asarray, frozen), "fc": jstate.params["fc"]})
        state, pm = step(state, x, y, m)
        assert abs(float(pm["loss"]) - float(jm["loss"])) <= ATOL
    after = state.module.state_dict()
    params = {n for n, _ in state.module.named_parameters()}
    for k in params:
        if not k.startswith("fc."):
            assert torch.equal(after[k], before[k]), f"{k} moved under train_fc"
    assert not torch.equal(after["fc.weight"], before["fc.weight"])
    buffers = [k for k in after if k not in params and not k.endswith("num_batches_tracked")]
    assert len(buffers) > 2 and all(not torch.equal(after[k], before[k]) for k in buffers)
    _assert_weights_close(state.module, _as_state_dict(jstate), ["fc.weight", "fc.bias",
                                                                  *buffers])
    assert state.module.bn1.num_batches_tracked.item() == 3
    # only the fc layer is trained; the backbone takes no gradient
    assert [n for n, p in state.module.named_parameters() if p.requires_grad] == [
        "fc.weight", "fc.bias"]


def test_a_run_split_between_the_packages_matches_jax_alone(init):
    """3 JAX steps, the ``TrainState`` carried over (weights, statistics,
    the momentum trace, the schedule's count and, at accumulate 2, a
    half-filled accumulation), then 3 port steps: the same as 6 JAX
    steps."""
    module, variables = init
    cfg = dict(accumulate=2)
    batches = _batches(6, seed=11)
    jstate, jstep = _jax_side(module, variables, **cfg)
    for x, y, m in batches[:3]:
        jstate, _ = jstep(jstate, x, y, m)
    state, step = _port_side(variables, **cfg)
    load_jax_train_state(state, jax.tree.map(np.asarray, jstate))
    assert (state.tx.count, state.tx.mini_step) == (1, 1) and state.tx.acc is not None
    for x, y, m in batches[3:]:
        jstate, jm = jstep(jstate, x, y, m)
        state, pm = step(state, x, y, m)
        assert abs(float(pm["loss"]) - float(jm["loss"])) <= ATOL
    _assert_weights_close(state.module, _as_state_dict(jstate))
    assert state.tx.count == 3


def test_sharded_training_raises_naming_its_roadmap_item():
    gm = create_model("tiny_resnet", C, device="cpu", trainable=True)
    tx = make_optimizer(gm.module, TrainConfig(), 1)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        make_train_step(gm.module, tx, mesh=object())
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        make_eval_step(gm.module, mesh=object())


def test_resnet50_width_and_utils_match_jax():
    """ResNet-50 at full width with 100 classes (the trainer's default
    model) has the JAX model's parameter count; ``accuracy`` and
    ``AverageMeter`` agree with the JAX package's."""
    from distdiff_tpu.models.guide import create_model as j_create_model
    from distdiff_tpu.utils import AverageMeter as JAverageMeter
    from distdiff_tpu.utils.metrics import accuracy as j_accuracy
    from distdiff_tpu.utils.misc import count_param as j_count_param
    from distdiff_tpu_torch.utils import AverageMeter, accuracy
    from distdiff_tpu_torch.utils.misc import count_param

    jg = j_create_model("resnet50", num_classes=100, lazy_init=True)
    gm = create_model("resnet50", 100, device="meta")
    assert count_param(gm.module) == j_count_param(jg.variables["params"]) == 23_712_932
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((12, C)).astype(np.float32)
    logits[3, :2] = 5.0  # a tie: both rank by index
    y = rng.integers(0, C, 12)
    got = accuracy(torch.from_numpy(logits), torch.from_numpy(y), (1, 3, 5))
    want = j_accuracy(logits, y, (1, 3, 5))
    assert [float(g) for g in got] == pytest.approx([float(w) for w in want], abs=1e-5)
    meters = AverageMeter(), JAverageMeter()
    for val, n in ((2.5, 3), (1.0, 1), (4.0, 0)):
        for m in meters:
            m.update(val, n)
    assert vars(meters[0]) == vars(meters[1])
