"""The port's ``cli.train_transform`` at its batch- and loss-level
``--transform_type`` values (cutmix, augmix, gridmask, mixup) against the
JAX package's CLI on the CPU, ``log.txt`` row for row under
``test_torch_train_transform_cli.py``'s tolerances, on the same tree,
seed and starting weights.

augmix and gridmask run two epochs (GridMask's probability ramps from 0 at
the first epoch). mixup and cutmix run one training step, a batch of 32
over the 24 items of the control: the JAX CLI's jitted step reads the
first batch's targets and lambda on every later step, so it is a
reference for the first step only (``test_torch_augment.py`` holds the
port's later steps to each batch's own draws)."""

import pytest
import torch
from test_torch_train_transform_cli import assert_logs_match, files, run_both  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("transform_type,epochs,extra", [
    ("cutmix", 1, ["--train-batch", "32"]),
    ("augmix", 2, []),
    ("gridmask", 2, []),
    ("mixup", 1, ["--train-batch", "32"]),
], ids=["cutmix", "augmix", "gridmask", "mixup"])
def test_batch_and_loss_level_runs_match_the_jax_cli(files, tmp_path,  # noqa: F811
                                                     transform_type, epochs, extra):
    dirs = run_both(files, str(tmp_path), transform_type, epochs, extra)
    assert_logs_match(files, dirs, epochs)
