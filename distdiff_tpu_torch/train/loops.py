"""Epoch loops with the reference's logging and checkpoint plumbing (port
of ``distdiff_tpu/train/loops.py``; reference ``train.py`` shape).

Writes the same artifacts in the same places as the JAX package: the
tab-separated ``log.txt`` with the reference's five columns
(``train.py:195``), the per-epoch checkpoint and its best alias (the
reference's ``checkpoint.pth.tar`` and ``model_best.pth.tar``,
``utils/checkpoints.py``), and ``results.yaml`` with ``best_accuracy`` and
``last_accuracy`` (``train.py:216-221``), byte for byte as PyYAML's
``dump`` writes that mapping, so ``parse_logs`` reads both packages' runs.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

from distdiff_tpu_torch.data.datasets import BatchLoader
from distdiff_tpu_torch.train.classifier import TrainConfig, TrainState
from distdiff_tpu_torch.utils import AverageMeter, Logger
from distdiff_tpu_torch.utils import checkpoints as ckpt

LOG_COLUMNS = ["Learning Rate", "Train Loss", "Valid Loss", "Train Acc.", "Valid Acc."]


def run_epoch(train_step, state: TrainState, loader: BatchLoader,
              on_batch: Optional[Callable] = None):
    losses, accs = AverageMeter(), AverageMeter()
    for images, targets, mask in loader:
        if on_batch is not None:
            images, targets, mask = on_batch(images, targets, mask)
        state, metrics = train_step(state, images, targets, mask)
        n = int(mask.sum())
        losses.update(float(metrics["loss"]), n)
        accs.update(float(metrics["acc"]), n)
    return state, losses.avg, accs.avg


def evaluate(eval_step, loader: BatchLoader):
    """(mean loss, top-1 %, top-5 %) over the loader's real rows."""
    c1 = c5 = n = loss_sum = 0.0
    for images, targets, mask in loader:
        a, b, w, l = eval_step(images, targets, mask)
        c1 += float(a); c5 += float(b); n += float(w); loss_sum += float(l)
    n = max(n, 1.0)
    return loss_sum / n, 100.0 * c1 / n, 100.0 * c5 / n


def _yaml_float(x: float) -> str:
    """A float as PyYAML's ``represent_float`` writes it."""
    if x != x:
        return ".nan"
    if x in (float("inf"), float("-inf")):
        return ".inf" if x > 0 else "-.inf"
    value = repr(x).lower()
    if "." not in value and "e" in value:
        value = value.replace("e", ".0e", 1)
    return value


def write_results(path: str, result: dict) -> None:
    """``yaml.dump`` of a mapping of str to float (keys sorted, one
    ``key: value`` line each), without PyYAML: the card's machine has none."""
    with open(path, "w") as f:
        for key in sorted(result):
            f.write(f"{key}: {_yaml_float(float(result[key]))}\n")


def fit(
    train_step,
    eval_step,
    state: TrainState,
    train_loader: BatchLoader,
    test_loader: BatchLoader,
    cfg: TrainConfig,
    checkpoint_dir: str,
    lr_at_epoch: Callable[[int], float],
    resume: bool = False,
    start_epoch: int = 0,
    best_acc: float = 0.0,
    on_batch: Optional[Callable] = None,
    on_epoch: Optional[Callable] = None,
) -> dict:
    os.makedirs(checkpoint_dir, exist_ok=True)
    logger = Logger(os.path.join(checkpoint_dir, "log.txt"), title="distdiff", resume=resume)
    logger.set_names(LOG_COLUMNS)

    test_acc = 0.0
    for epoch in range(start_epoch, cfg.epochs):
        t0 = time.time()
        if on_epoch is not None:
            # epoch-indexed augmentation state (e.g. GridMask's prob ramp,
            # reference train_transform.py:379-382)
            on_epoch(epoch)
        lr = lr_at_epoch(epoch)
        state, train_loss, train_acc = run_epoch(train_step, state, train_loader, on_batch)
        test_loss, test_acc, test_acc5 = evaluate(eval_step, test_loader)
        logger.append([lr, train_loss, test_loss, train_acc, test_acc])
        is_best = test_acc > best_acc
        best_acc = max(test_acc, best_acc)
        print(
            f"Epoch: [{epoch + 1} | {cfg.epochs}] LR: {lr:.6f} "
            f"train {train_loss:.4f}/{train_acc:.2f}% "
            f"test {test_loss:.4f}/{test_acc:.2f}% "
            f"(best {best_acc:.2f}%) {time.time() - t0:.1f}s",
            flush=True,
        )
        ckpt.save_train_checkpoint(checkpoint_dir, state, epoch + 1, best_acc, is_best)
    logger.close()

    result = {"best_accuracy": float(best_acc), "last_accuracy": float(test_acc)}
    write_results(os.path.join(checkpoint_dir, "results.yaml"), result)
    return result
