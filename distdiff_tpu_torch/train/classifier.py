"""Classifier training on one device (port of
``distdiff_tpu/train/classifier.py``; the reference's ``train.py`` engine).

Optimisation recipe (reference ``train.py:155-158``): SGD with momentum 0.9,
Nesterov and weight decay, the learning rate on a cosine over every
optimiser update of the run, cross-entropy. ``Optimizer`` is the JAX
package's optax chain (``add_decayed_weights`` then ``sgd``) as torch's SGD,
whose ``momentum_buffer`` is optax's trace; ``accumulate`` keeps
``optax.MultiSteps``' rules; ``train_fc_only`` trains the head (``fc`` or
``classifier``) on a frozen backbone.

Padded-tail batches are handled by a boolean mask weighting the loss and
metrics; the padded rows still enter BatchNorm's batch statistics, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

SHARDED = "ROADMAP queue 1 item 8"


@dataclasses.dataclass
class TrainConfig:
    lr: float = 0.1
    epochs: int = 100
    momentum: float = 0.9
    nesterov: bool = True
    weight_decay: float = 5e-4
    label_smoothing: float = 0.0
    train_fc_only: bool = False   # --train_fc linear probe (train.py:150-155)
    accumulate: int = 1           # --accumulate grad accumulation


def freeze_backbone(module: torch.nn.Module) -> None:
    """A linear probe: every parameter but the head's (``fc.``, or
    MobileNetV2's ``classifier.``, as the JAX mask takes) takes no
    gradient. BatchNorm still updates its running statistics in training,
    as the JAX package's step writes ``batch_stats`` back on every step.
    A module with no such head (the CLIP ViT) raises: the JAX mask selects
    nothing there, and its optimiser then passes every gradient through
    as the update."""
    heads = 0
    for name, p in module.named_parameters():
        p.requires_grad_(name.startswith(("fc.", "classifier.")))
        heads += p.requires_grad
    if not heads:
        raise ValueError("--train_fc trains the fc or classifier head, and this model has none")


class Optimizer:
    """``optax.chain(add_decayed_weights(wd), sgd(cosine, momentum,
    nesterov))`` on a module's parameters, wrapped in ``optax.MultiSteps``
    when ``cfg.accumulate > 1``.

    ``step()`` takes the gradients in the parameters' ``.grad`` (one
    micro-batch). The rate of update ``count`` is ``cosine_decay_schedule``
    over ``epochs * steps_per_epoch`` updates. With ``accumulate = k`` the
    gradients are averaged over k micro-batches as MultiSteps averages them
    (``acc += (g - acc) / (n + 1)``), and every k-th micro-batch makes one
    update: the weight decay is applied once, the schedule advances once
    (so a run's cosine goes 1/k of its way), and a part-filled
    accumulation carries over into the next epoch."""

    def __init__(self, module: torch.nn.Module, cfg: TrainConfig, steps_per_epoch: int):
        self.cfg = cfg
        self.decay_steps = max(cfg.epochs * steps_per_epoch, 1)
        self.params = [p for p in module.parameters() if p.requires_grad]
        self.sgd = torch.optim.SGD(self.params, lr=cfg.lr, momentum=cfg.momentum,
                                   nesterov=cfg.nesterov, weight_decay=cfg.weight_decay)
        self.count = 0       # updates made: the schedule's step
        self.mini_step = 0   # micro-batches in the running accumulation
        self.acc: Optional[list] = None

    def lr(self) -> float:
        t = min(self.count, self.decay_steps) / self.decay_steps
        return self.cfg.lr * 0.5 * (1.0 + math.cos(math.pi * t))

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    def step(self) -> None:
        k = self.cfg.accumulate
        if k > 1:
            grads = [p.grad for p in self.params]
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, self.mini_step + 1)
            torch._foreach_add_(self.acc, diff)
            self.mini_step += 1
            if self.mini_step < k:
                return
            for p, a in zip(self.params, self.acc):
                p.grad = a
            self.acc, self.mini_step = None, 0
        for group in self.sgd.param_groups:
            group["lr"] = self.lr()
        self.sgd.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"sgd": self.sgd.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.sgd.load_state_dict(state["sgd"])
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        acc = state["acc"]
        self.acc = None if acc is None else [
            a.to(p.device) for a, p in zip(acc, self.params)]


def make_optimizer(module: torch.nn.Module, cfg: TrainConfig,
                   steps_per_epoch: int) -> Optimizer:
    """The optimiser of ``cfg`` on ``module``; ``train_fc_only`` freezes the
    backbone first (``freeze_backbone``)."""
    if cfg.train_fc_only:
        freeze_backbone(module)
    return Optimizer(module, cfg, steps_per_epoch)


@dataclasses.dataclass
class TrainState:
    """The module (its weights and BatchNorm statistics) and its optimiser."""

    module: torch.nn.Module
    tx: Optimizer


def create_train_state(module: torch.nn.Module, tx: Optimizer) -> TrainState:
    return TrainState(module=module, tx=tx)


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """The masked mean of the rows' cross-entropy, against one-hot targets
    smoothed by ``label_smoothing``."""
    n_cls = logits.shape[-1]
    onehot = F.one_hot(targets.long(), n_cls).float()
    if label_smoothing > 0:
        onehot = onehot * (1 - label_smoothing) + label_smoothing / n_cls
    ll = (onehot * F.log_softmax(logits.float(), -1)).sum(-1)
    w = mask.float()
    return -(ll * w).sum() / w.sum().clamp_min(1.0)


def _device_of(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def _batch(images, targets, mask, device):
    def put(a):
        return (a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))).to(device)
    return put(images), put(targets).long(), put(mask)


def _single_device(mesh, state_shardings) -> None:
    if mesh is not None or state_shardings is not None:
        raise NotImplementedError(f"the port's trainer runs on one device; a mesh or "
                                  f"sharded state waits for {SHARDED}")


def make_train_step(module: torch.nn.Module, tx: Optimizer, mesh=None,
                    label_smoothing: float = 0.0, loss_fn: Optional[Callable] = None,
                    state_shardings=None):
    """``step(state, images, targets, mask) -> (state, metrics)``: one
    training forward (BatchNorm on the batch's statistics), the masked loss,
    its backward and ``tx.step()``. ``images`` are NHWC, on the host or the
    module's device; ``metrics`` holds the loss and the masked top-1
    accuracy in percent against ``targets``, as device scalars.
    ``loss_fn(logits, targets, mask) -> scalar`` replaces cross-entropy
    (the cutmix, augmix and mixup trainers); the step runs eagerly, so it
    is called anew on every batch."""
    _single_device(mesh, state_shardings)
    device = _device_of(module)

    def step(state: TrainState, images, targets, mask):
        x, t, m = _batch(images, targets, mask, device)
        state.module.train()
        logits = state.module(x)
        if loss_fn is None:
            loss = cross_entropy(logits, t, m, label_smoothing)
        else:
            loss = loss_fn(logits, t, m)
        state.tx.zero_grad()
        loss.backward()
        state.tx.step()
        with torch.no_grad():
            w = m.float()
            acc = ((logits.argmax(-1) == t) * w).sum() / w.sum().clamp_min(1.0)
        return state, {"loss": loss.detach(), "acc": acc * 100.0}

    return step


def make_eval_step(module: torch.nn.Module, mesh=None):
    """``eval(images, targets, mask) -> (correct top-1, correct
    top-min(5, C), rows, loss sum)`` over the mask's rows, with BatchNorm on
    its running statistics. Ties rank by class index, as the JAX package's
    stable ``argsort`` ranks them."""
    _single_device(mesh, None)
    device = _device_of(module)

    @torch.no_grad()
    def step(images, targets, mask):
        x, t, m = _batch(images, targets, mask, device)
        module.eval()
        logits = module(x)
        w = m.float()
        k = min(5, logits.shape[-1])
        hit = torch.argsort(-logits, dim=-1, stable=True)[:, :k] == t[:, None]
        c1 = (hit[:, :1].any(-1) * w).sum()
        c5 = (hit.any(-1) * w).sum()
        loss = cross_entropy(logits, t, m)
        return c1, c5, w.sum(), loss * w.sum()

    return step
