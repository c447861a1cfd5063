"""Trainer checkpoints in the reference's own files (port of the training
half of ``distdiff_tpu/utils/checkpoints.py``; reference ``train.py:341-346``).

Each epoch writes ``{dir}/checkpoint.pth.tar`` and, when the epoch is the
best so far, copies it to ``{dir}/model_best.pth.tar``. The file is a dict:
``state_dict`` (torchvision's names, so the guide loader and
``generate_data --encoder_weight_path`` read it as they read a reference
checkpoint), ``optimizer`` (SGD's state with the schedule's step and a
part-filled accumulation), ``epoch`` and ``best_acc``. The JAX package
writes orbax directories instead, which the card's machine cannot read.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch

CHECKPOINT = "checkpoint.pth.tar"
BEST = "model_best.pth.tar"
ORBAX_ROUTE = (
    "is an orbax checkpoint of the JAX package; the port resumes from the "
    f"{CHECKPOINT} it writes itself. To carry a JAX run over, restore its TrainState "
    "to numpy on a host with JAX (distdiff_tpu.utils.checkpoints.restore_pytree) and "
    "load it with distdiff_tpu_torch.weights.from_jax.load_jax_train_state")


def save_train_checkpoint(out_dir: str, state: Any, epoch: int, best_acc: float,
                          is_best: bool) -> None:
    """Epoch checkpoint and best alias (reference semantics)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, CHECKPOINT)
    torch.save({"state_dict": state.module.state_dict(), "optimizer": state.tx.state_dict(),
                "epoch": epoch, "best_acc": best_acc}, path)
    if is_best:
        shutil.copyfile(path, os.path.join(out_dir, BEST))


def load_train_checkpoint(path: str, state: Any) -> Optional[dict]:
    """Restore ``state`` (its module and optimiser, in place) from a
    checkpoint file or the directory that holds ``checkpoint.pth.tar``;
    ``{"state", "epoch", "best_acc"}``, or None where there is none. An
    orbax directory raises and names the route across."""
    if os.path.isdir(os.path.join(path, "checkpoint")):
        raise NotImplementedError(f"{os.path.join(path, 'checkpoint')} {ORBAX_ROUTE}")
    if os.path.isdir(path):
        path = os.path.join(path, CHECKPOINT)
    if not os.path.exists(path):
        return None
    device = next(state.module.parameters()).device
    saved = torch.load(path, map_location=device, weights_only=True)
    state.module.load_state_dict(saved["state_dict"])
    state.tx.load_state_dict(saved["optimizer"])
    return {"state": state, "epoch": int(saved["epoch"]),
            "best_acc": float(saved["best_acc"])}
