from distdiff_tpu_torch.train.classifier import (
    TrainConfig,
    TrainState,
    create_train_state,
    cross_entropy,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from distdiff_tpu_torch.train.loops import evaluate, fit, run_epoch

__all__ = [
    "TrainConfig",
    "TrainState",
    "create_train_state",
    "cross_entropy",
    "make_optimizer",
    "make_train_step",
    "make_eval_step",
    "fit",
    "run_epoch",
    "evaluate",
]
