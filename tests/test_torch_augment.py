"""The port's augmentations (``distdiff_tpu_torch/train/augment``) against
the JAX package's on the CPU.

Items at tolerance 0 on one ``np.random.default_rng`` each side:
``AutoAugmentCIFAR10``, ``RandAugment`` and ``Cutout`` inside
``cli.train_transform``'s transform stack (uint8 after the policy, float32
bit for bit after ``Normalize``), ``GridMask`` batches, ``augment_and_mix``
and ``AugMixDataset`` items, ``rand_bbox``, ``cutmix_data`` and
``mixup_data``. The three losses and their gradients within 1e-6 (fp32 on
both sides, a padded mask). ``make_train_step(loss_fn=)`` against the JAX
step at ``tiny_resnet``. And the mixing trainers' steps over three
batches, each against the JAX package's ``mixup_data`` / ``cutmix_data``
and loss evaluated eagerly on that batch: the JAX CLI's jitted step reads
the first batch's targets and lambda on every step, the port's must not."""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from distdiff_tpu.cli import train_transform as j_cli
from distdiff_tpu.data import transforms as jtf
from distdiff_tpu.models.guide.resnet import ResNet as JResNet
from distdiff_tpu.models.guide.resnet import tiny_resnet_config as j_tiny_config
from distdiff_tpu.train import TrainConfig as JTrainConfig
from distdiff_tpu.train import create_train_state as j_create_train_state
from distdiff_tpu.train import cross_entropy as j_cross_entropy
from distdiff_tpu.train import make_optimizer as j_make_optimizer
from distdiff_tpu.train import make_train_step as j_make_train_step
from distdiff_tpu.train import augment as ja
from distdiff_tpu.train.augment import tv_policies as j_tv
from distdiff_tpu_torch.cli import train_transform as cli
from distdiff_tpu_torch.data import transforms as tf
from distdiff_tpu_torch.models.guide import create_model
from distdiff_tpu_torch.models.guide.resnet import tiny_resnet_config
from distdiff_tpu_torch.train import (
    TrainConfig,
    create_train_state,
    cross_entropy,
    make_optimizer,
    make_train_step,
)
from distdiff_tpu_torch.train import augment as pa
from distdiff_tpu_torch.train.augment import tv_policies
from distdiff_tpu_torch.weights.from_jax import state_dict_from_jax

torch.set_num_threads(1)

LOSS_TOL = 1e-6
C = 5


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    bands = [(x * (4 + k) + y * (1 + 2 * k) + 50 * np.cos(y / (2 + k))) % 256 for k in range(3)]
    return np.clip(np.stack(bands, -1) + rng.integers(-30, 31, (h, w, 3)), 0,
                   255).astype(np.uint8)


SHAPES = [(40, 52), (37, 29), (64, 64)]


@pytest.mark.parametrize("policy", ["autoaug", "randaug"])
def test_policies_equal_jax_on_one_generator(policy):
    """The policy alone (uint8) and the CLI's whole stack around it (float32
    after Normalize), item by item, on one generator per item."""
    ours = tv_policies.AutoAugmentCIFAR10() if policy == "autoaug" else tv_policies.RandAugment()
    theirs = j_tv.AutoAugmentCIFAR10() if policy == "autoaug" else j_tv.RandAugment()
    args = argparse.Namespace(input_size=32, transform_type=policy)
    stack, j_stack = cli.build_transform(args), j_cli.build_transform(args)
    for i, (h, w) in enumerate(SHAPES):
        img = _image(h, w, i)
        for s in range(12):
            got = ours(img, np.random.default_rng((s, i)))
            want = np.asarray(theirs(Image.fromarray(img), np.random.default_rng((s, i))))
            np.testing.assert_array_equal(got, want, err_msg=f"{policy} {h}x{w} seed {s}")
            got = stack(img, np.random.default_rng((s, i, 1)))
            want = j_stack(Image.fromarray(img), np.random.default_rng((s, i, 1)))
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    assert pa.AutoAugmentCIFAR is tv_policies.AutoAugmentCIFAR10


@pytest.mark.parametrize("transform_type", ["default", "cutout"])
def test_transform_stacks_equal_jax(transform_type):
    args = argparse.Namespace(input_size=24, transform_type=transform_type)
    stack, j_stack = cli.build_transform(args), j_cli.build_transform(args)
    for i, (h, w) in enumerate(SHAPES):
        img = _image(h, w, 10 + i)
        for s in range(6):
            got = stack(img, np.random.default_rng(s))
            want = j_stack(Image.fromarray(img), np.random.default_rng(s))
            np.testing.assert_array_equal(got, want)
            if transform_type == "cutout":
                assert (got == 0).any()
    arr = np.random.default_rng(0).standard_normal((9, 11, 3)).astype(np.float32)
    for length in (2, 4, 16):
        np.testing.assert_array_equal(pa.Cutout(length)(arr, np.random.default_rng(length)),
                                      ja.Cutout(length)(arr, np.random.default_rng(length)))


def test_gridmask_batches_equal_jax():
    """Masks at the probability's ramp points, on non-square and square
    batches (each mask turned 0 or 1 degree as Pillow turns an "L" image)."""
    rng = np.random.default_rng(0)
    for b, h, w in ((6, 32, 32), (5, 40, 27), (4, 224, 224)):
        images = rng.standard_normal((b, h, w, 3)).astype(np.float32)
        ours, theirs = pa.GridMask(), ja.GridMask()
        for epoch in (0, 1, 2, 9):
            ours.set_prob(epoch, 2)
            theirs.set_prob(epoch, 2)
            assert ours.prob == theirs.prob
            r1, r2 = np.random.default_rng((b, epoch)), np.random.default_rng((b, epoch))
            got, want = ours(images, r1), theirs(images, r2)
            np.testing.assert_array_equal(got, want)
            assert r1.random() == r2.random()
        assert (got == 0).any() and not np.array_equal(got, images)
    for angle_seed in range(8):
        m1 = pa.GridMask()._one_mask(50, 71, np.random.default_rng(angle_seed))
        m2 = ja.GridMask()._one_mask(50, 71, np.random.default_rng(angle_seed))
        assert m1.dtype == m2.dtype == np.float32
        np.testing.assert_array_equal(m1, m2)


def _array_stage():
    return tf.Compose([tf.ToArray(), tf.Normalize(tf.IMAGENET_MEAN, tf.IMAGENET_STD)])


def _j_array_stage():
    return jtf.Compose([jtf.ToArray(), jtf.Normalize(jtf.IMAGENET_MEAN, jtf.IMAGENET_STD)])


def test_augment_and_mix_equals_jax():
    to_array, j_to_array = _array_stage(), _j_array_stage()
    for i, (h, w) in enumerate(SHAPES):
        img = _image(h, w, 20 + i)
        for s in range(6):
            kw = dict(severity=1 + s % 3, depth=-1 if s < 4 else s - 3)
            got = pa.augment_and_mix(img, lambda a: to_array(a), rng=np.random.default_rng(s), **kw)
            want = ja.augment_and_mix(Image.fromarray(img), lambda p: j_to_array(p),
                                      rng=np.random.default_rng(s), **kw)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


class _Items:
    """A base dataset of raw items, as the loader's datasets are with their
    transform None: uint8 arrays for the port, PIL images for JAX."""

    def __init__(self, images, as_pil):
        self.images, self.as_pil = images, as_pil

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        img = self.images[i]
        return (Image.fromarray(img) if self.as_pil else img), i % C


def test_augmix_dataset_items_equal_jax():
    images = [_image(h, w, 30 + i) for i, (h, w) in enumerate(SHAPES * 2)]
    ours = pa.AugMixDataset(_Items(images, False), tf.Compose(cli._geometric_stages(24)),
                            lambda a: _array_stage()(a), seed=3)
    j_geo = jtf.Compose([jtf.Resize(27), jtf.RandomRotation(15), jtf.RandomCrop(24),
                         jtf.RandomHorizontalFlip()])
    theirs = ja.AugMixDataset(_Items(images, True), j_geo, lambda p: _j_array_stage()(p), seed=3)
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for i in range(len(images)):
            (got, gy), (want, wy) = ours[i], theirs[i]
            assert got.shape == (3, 24, 24, 3) and got.dtype == want.dtype and gy == wy
            np.testing.assert_array_equal(got, want)


def test_batch_mixing_draws_equal_jax():
    rng = np.random.default_rng(4)
    images = rng.standard_normal((8, 20, 28, 3)).astype(np.float32)
    targets = rng.integers(0, C, 8).astype(np.int32)
    for s in range(5):
        for ours, theirs in ((pa.mixup_data, ja.mixup_data), (pa.cutmix_data, ja.cutmix_data)):
            got = ours(images, targets, rng=np.random.default_rng(s))
            want = theirs(images, targets, rng=np.random.default_rng(s))
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
        for lam in (0.0, 0.3, 0.99):
            assert pa.rand_bbox(20, 28, lam, np.random.default_rng(s)) == ja.rand_bbox(
                20, 28, lam, np.random.default_rng(s))


def _logits(n, seed):
    return np.random.default_rng(seed).standard_normal((n, C)).astype(np.float32) * 3


MASKS = [np.ones(6, bool), np.array([1, 1, 1, 1, 0, 0], bool)]


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("loss", ["jsd", "soft_target", "mixup"])
def test_losses_and_gradients_equal_jax(loss, padded):
    mask = MASKS[padded]
    rng = np.random.default_rng(6)
    ta, tb = rng.integers(0, C, 6), rng.integers(0, C, 6)
    lam = 0.37
    if loss == "jsd":
        arrays = [_logits(6, k) for k in range(3)]

        def ours(*lg):
            return pa.jsd_consistency_loss(*lg, torch.from_numpy(mask))

        def theirs(*lg):
            return ja.jsd_consistency_loss(*lg, mask)
    elif loss == "soft_target":
        arrays = [_logits(6, 0)]

        def ours(lg):
            return pa.soft_target_cross_entropy(lg, torch.from_numpy(ta), torch.from_numpy(tb),
                                                lam, torch.from_numpy(mask))

        def theirs(lg):
            return ja.soft_target_cross_entropy(lg, ta, tb, lam, mask)
    else:
        arrays = [_logits(6, 1)]

        def ours(lg):
            return pa.mixup_criterion(cross_entropy, lg, torch.from_numpy(ta),
                                      torch.from_numpy(tb), lam, torch.from_numpy(mask))

        def theirs(lg):
            return ja.mixup_criterion(j_cross_entropy, lg, ta, tb, lam, mask)
    tensors = [torch.from_numpy(a).requires_grad_() for a in arrays]
    value = ours(*tensors)
    value.backward()
    want, grads = jax.value_and_grad(theirs, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    assert value.dtype == torch.float32
    assert abs(float(value.detach()) - float(want)) <= LOSS_TOL
    for t, g in zip(tensors, grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=LOSS_TOL, rtol=0)
    if padded:  # the padded rows take no gradient
        assert all(float(t.grad[4:].abs().max()) == 0.0 for t in tensors)


# ------------------------------------------------------------- train steps

B, S = 8, 24


@pytest.fixture(scope="module")
def init():
    module = JResNet(j_tiny_config(C))
    variables = jax.jit(module.init)(jax.random.PRNGKey(1), jnp.zeros((1, S, S, 3)))
    return module, jax.tree.map(np.asarray, variables)


def _port_model(variables, steps_per_epoch):
    gm = create_model("tiny_resnet", C, device="cpu", trainable=True)
    gm.module.load_state_dict(state_dict_from_jax(variables, tiny_resnet_config(C)))
    tx = make_optimizer(gm.module, TrainConfig(lr=0.1, epochs=1), steps_per_epoch)
    return gm.module, tx


def _batches(n, seed, views=1):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        x = rng.standard_normal((B, views, S, S, 3)).astype(np.float32)
        y = rng.integers(0, C, B).astype(np.int32)
        m = np.ones(B, bool)
        if i == n - 1:
            m[6:] = False
        out.append((x[:, 0] if views == 1 else x, y, m))
    return out


def test_train_step_with_a_loss_fn_matches_the_jax_step(init):
    """The augmix trainer's step (three views packed into the batch axis,
    cross-entropy on the clean view plus 12 x JSD) through
    ``make_train_step(loss_fn=)`` on both sides: losses, accuracies
    (taken against the repeated targets) and weights after three steps."""
    module, variables = init
    loss_fn, on_batch, _ = cli.batch_stage("augmix", np.random.default_rng(0))
    j_tx = j_make_optimizer(JTrainConfig(lr=0.1, epochs=1), 3)
    j_state = j_create_train_state(module, jax.tree.map(jnp.asarray, variables), j_tx)

    def j_loss(logits, targets, mask):
        lc, l1, l2 = logits[0::3], logits[1::3], logits[2::3]
        return (j_cross_entropy(lc, targets[0::3], mask[0::3])
                + 12.0 * ja.jsd_consistency_loss(lc, l1, l2, mask[0::3]))

    j_step = j_make_train_step(module, j_tx, loss_fn=j_loss)
    pmod, tx = _port_model(variables, 3)
    state, step = create_train_state(pmod, tx), make_train_step(pmod, tx, loss_fn=loss_fn)
    for x, y, m in _batches(3, 2, views=3):
        batch = on_batch(x, y, m)
        assert batch[0].shape == (3 * B, S, S, 3) and batch[2].sum() == 3 * m.sum()
        j_state, jm = j_step(j_state, *batch)
        state, pm = step(state, *batch)
        assert abs(float(pm["loss"]) - float(jm["loss"])) <= 1e-5
        assert float(pm["acc"]) == pytest.approx(float(jm["acc"]), abs=1e-4)
    want = state_dict_from_jax(jax.tree.map(np.asarray, {
        "params": j_state.params, "batch_stats": j_state.batch_stats}), tiny_resnet_config(C))
    for k, v in pmod.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(v, want[k], atol=1e-5, rtol=0, msg=k)


@pytest.mark.parametrize("transform_type", ["mixup", "cutmix"])
def test_mixing_steps_use_each_batchs_own_targets_and_lambda(init, transform_type):
    """Three port steps through the CLI's ``batch_stage``: each step's loss
    equals the JAX loss evaluated eagerly on that step's logits with that
    batch's own (targets_a, targets_b, lambda) from the JAX package's
    ``mixup_data`` / ``cutmix_data`` on the same generator; the first
    batch's would give another loss on every later step."""
    _, variables = init
    loss_fn, on_batch, _ = cli.batch_stage(transform_type, np.random.default_rng(11))
    j_rng = np.random.default_rng(11)
    j_mix = ja.mixup_data if transform_type == "mixup" else ja.cutmix_data

    def j_loss(logits, ta, tb, lam, mask):
        if transform_type == "mixup":
            return (lam * j_cross_entropy(logits, ta, mask)
                    + (1 - lam) * j_cross_entropy(logits, tb, mask))
        return ja.soft_target_cross_entropy(logits, ta, tb, lam, mask)

    seen = []

    def spy(logits, targets, mask):
        seen.append(logits.detach().numpy().copy())
        return loss_fn(logits, targets, mask)

    pmod, tx = _port_model(variables, 3)
    state, step = create_train_state(pmod, tx), make_train_step(pmod, tx, loss_fn=spy)
    draws = []
    for i, (x, y, m) in enumerate(_batches(3, 5)):
        mixed, ta, tb, lam = j_mix(x, y, rng=j_rng)
        draws.append((ta, tb, lam))
        got = on_batch(x, y, m)
        np.testing.assert_array_equal(got[0], mixed)
        state, pm = step(state, *got)
        want = float(j_loss(seen[i], ta, tb, lam, m))
        assert abs(float(pm["loss"]) - want) <= LOSS_TOL, f"step {i}"
        if i:
            stale = float(j_loss(seen[i], *draws[0], m))
            assert abs(stale - want) > 100 * LOSS_TOL, f"step {i} cannot tell a stale batch"
    assert len({lam for _, _, lam in draws}) == 3
