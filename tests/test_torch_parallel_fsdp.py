"""The port's data-parallel and FSDP train steps (``train/classifier.py``
with a mesh, ``parallel/fsdp.py``) on ``["cpu"] * n`` meshes, against the
JAX package's mesh step (its 8 virtual devices) and the port's one-device
step on the same weights and batches, as the JAX package's own FSDP test
holds its step to its data-parallel one: losses at rtol 1e-5; parameters
and BatchNorm running statistics at rtol 2e-5 (atol 2e-6) against JAX's;
the statistics at that tolerance against the one-device step's (BatchNorm
normalises over the whole batch on every shard); FSDP's momentum, shard by
shard, against the mesh step's. The one-device step's parameters are not
held here: its native ``batch_norm`` ends 6.2e-5 from a float64 run of
the same step on these batches, where the mesh step (and JAX's) end within
3e-7 of it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distdiff_tpu.models.guide.resnet import ResNet as JResNet
from distdiff_tpu.models.guide.resnet import tiny_resnet_config as j_tiny_config
from distdiff_tpu.train import TrainConfig as JTrainConfig
from distdiff_tpu.train import create_train_state as j_create_train_state
from distdiff_tpu.train import make_optimizer as j_make_optimizer
from distdiff_tpu.train import make_train_step as j_make_train_step
from distdiff_tpu_torch.models.guide import create_model
from distdiff_tpu_torch.models.guide.resnet import tiny_resnet_config
from distdiff_tpu_torch.parallel import fsdp
from distdiff_tpu_torch.parallel.mesh import make_mesh
from distdiff_tpu_torch.train import (
    TrainConfig,
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from distdiff_tpu_torch.weights.from_jax import state_dict_from_jax

torch.set_num_threads(1)

C, B, S, STEPS = 2, 16, 16, 3
CFG = dict(lr=0.05, epochs=2, weight_decay=1e-4)
RTOL, ATOL = 2e-5, 2e-6


def _batches():
    rng = np.random.RandomState(0)
    labels = rng.randint(0, C, B).astype(np.int32)
    images = np.where(labels[:, None, None, None] == 1, rng.rand(B, S, S, 3) * 0.5 + 0.5,
                      rng.rand(B, S, S, 3) * 0.5).astype(np.float32)
    mask = np.ones(B, bool)
    mask[-3:] = False  # a padded tail
    return [(np.roll(images, i, 0), np.roll(labels, i), mask) for i in range(STEPS)]


@pytest.fixture(scope="module")
def reference():
    """The JAX mesh step's losses and final variables after STEPS steps,
    and the initial variables (numpy)."""
    module = JResNet(j_tiny_config(C))
    variables = jax.tree.map(np.asarray, jax.jit(module.init)(jax.random.PRNGKey(0),
                                                              jnp.zeros((1, S, S, 3))))
    tx = j_make_optimizer(JTrainConfig(**CFG), 4)
    state = j_create_train_state(module, jax.tree.map(jnp.asarray, variables), tx)
    step = j_make_train_step(module, tx)  # the 8-device data mesh
    losses = []
    for x, y, m in _batches():
        state, metrics = step(state, x, y, m)
        losses.append(float(metrics["loss"]))
    final = state_dict_from_jax(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}), tiny_resnet_config(C))
    return variables, losses, final


def _state(variables):
    gm = create_model("tiny_resnet", C, device="cpu", trainable=True)
    gm.module.load_state_dict(state_dict_from_jax(variables, tiny_resnet_config(C)))
    tx = make_optimizer(gm.module, TrainConfig(**CFG), 4)
    return gm.module, tx, create_train_state(gm.module, tx)


def _run(step, state):
    losses = []
    for x, y, m in _batches():
        state, metrics = step(state, x, y, m)
        losses.append(float(metrics["loss"]))
    return state, losses


def _assert_state_close(got, want, what, only=""):
    for k, v in want.items():
        if not k.endswith("num_batches_tracked") and only in k:
            np.testing.assert_allclose(got[k].detach().numpy(), v.detach().numpy(),
                                       rtol=RTOL, atol=ATOL, err_msg=f"{what}: {k}")


def _momentum(tx, module):
    names = {id(p): n for n, p in module.named_parameters()}
    return {names[id(p)]: tx.sgd.state[p]["momentum_buffer"] for p in tx.params}


@pytest.fixture(scope="module")
def one_device(reference):
    module, tx, state = _state(reference[0])
    state, losses = _run(make_train_step(module, tx), state)
    return state, losses


@pytest.fixture(scope="module")
def mesh_runs(reference):
    """The mesh step's final state and losses on 2 and 4 devices."""
    out = {}
    for n in (2, 4):
        module, tx, state = _state(reference[0])
        out[n] = _run(make_train_step(module, tx, mesh=make_mesh(["cpu"] * n)), state)
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_the_mesh_step_matches_jax_and_the_one_device_step(reference, one_device, mesh_runs,
                                                           n):
    _, jlosses, jfinal = reference
    ref_state, ref_losses = one_device
    state, losses = mesh_runs[n]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    sd = state.module.state_dict()
    _assert_state_close(sd, jfinal, "jax")
    _assert_state_close(sd, ref_state.module.state_dict(), "one device", only="running_")
    assert int(sd["bn1.num_batches_tracked"]) == STEPS
    # the eval step on the mesh counts what the one-device step counts
    x, y, m = _batches()[0]
    want = make_eval_step(ref_state.module)(x, y, m)
    got = make_eval_step(state.module, mesh=make_mesh(["cpu"] * n))(x, y, m)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_fsdp_matches_jax_and_the_mesh_step(reference, one_device, mesh_runs, n):
    _, jlosses, jfinal = reference
    ref_state, _ = one_device
    mesh_state, mesh_losses = mesh_runs[n]
    module, tx, state = _state(reference[0])
    before = {k: v.clone() for k, v in module.state_dict().items()}
    mesh = make_mesh(["cpu"] * n)
    step, fs = fsdp.make_fsdp_train_step(module, tx, state, mesh=mesh, min_shard_elems=512)
    split = [k for k, parts in fs.shards.items() if len(parts) > 1]
    assert split and all(len(fs.shards[k]) == n for k in split)
    fs, losses = _run(step, fs)
    np.testing.assert_allclose(losses, mesh_losses, rtol=1e-5)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    full = fs.unshard().state_dict()
    _assert_state_close(full, mesh_state.module.state_dict(), "mesh step")
    _assert_state_close(full, jfinal, "jax")
    _assert_state_close(full, ref_state.module.state_dict(), "one device", only="running_")
    # each shard's momentum is its slice of the mesh step's
    ref_m = _momentum(mesh_state.tx, mesh_state.module)
    for k in split:
        dim = [a is not None for a in fs.shardings[k].spec].index(True)
        got = torch.cat([fs.tx.sgd.state[s]["momentum_buffer"] for s in fs.shards[k]], dim)
        np.testing.assert_allclose(got.numpy(), ref_m[k].numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    # the state it came from is as it was: nothing of it was aliased
    for k, v in module.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_fsdp_sharding_splits_the_largest_dim_the_mesh_divides(reference):
    module, tx, state = _state(reference[0])
    mesh = make_mesh(["cpu"] * 4)
    shardings = fsdp.fsdp_sharding(state, mesh, min_shard_elems=512)
    split = 0
    for name, p in module.named_parameters():
        spec = tuple(shardings[name].spec)
        if p.numel() < 512:
            assert all(a is None for a in spec), name
            continue
        if any(a is not None for a in spec):
            split += 1
            dim = spec.index("data")
            assert p.shape[dim] % 4 == 0 and p.shape[dim] == max(
                s for s in p.shape if s % 4 == 0), name
    assert split >= 4
    assert fsdp.MIN_SHARD_ELEMS == 2 ** 14
    assert all(all(a is None for a in s.spec)
               for s in fsdp.fsdp_sharding(state, mesh).values())  # all small at 2**14
