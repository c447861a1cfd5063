"""Classifier trainer CLI (port of ``distdiff_tpu/cli/train.py``; the
reference's ``train.py`` role, "obtain guide model", ``README.md:39-46``):
train an ``--arch`` classifier on the original dataset and write per-epoch
``checkpoint.pth.tar`` with its ``model_best.pth.tar`` alias, ``log.txt``
and ``results.yaml``. Flags keep the reference vocabulary
(``train.py:33-78``). Runs on the card; ``DISTDIFF_PLATFORM=cpu`` asks for
the CPU. Original images are read as PNG only (``data/datasets.py``).

Usage:
  python -m distdiff_tpu_torch.cli.train -d caltech-101 -a resnet50 \\
      --checkpoint checkpoint/caltech-101/resnet50/seed1 --manualSeed 1
"""

from __future__ import annotations

import argparse
import math

import torch

from distdiff_tpu_torch.cli.common import (
    add_dataset_args,
    add_train_args,
    cli_device,
    ensure_dir,
    set_seed,
    setup_logging,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train classifier on original data")
    add_dataset_args(p)
    add_train_args(p)
    return p.parse_args(argv)


def build_dataset(args, train_tf=None, test_tf=None, raw_train=False):
    """``raw_train``: leave the train split untransformed (raw uint8 items),
    for the augmix trainer, which wraps it in ``AugMixDataset`` and applies
    the geometric and array stages itself."""
    from distdiff_tpu_torch.data import load_dataset
    from distdiff_tpu_torch.data.transforms import eval_transform, train_transform

    return load_dataset(
        args.dataset,
        None if raw_train else (train_tf or train_transform(args.input_size)),
        test_tf or eval_transform(args.input_size),
        data_root=args.data_root,
    )


def build_model(args, num_classes: int, device: torch.device):
    from distdiff_tpu_torch.models.guide import create_model

    return create_model(args.arch, num_classes=num_classes, weight_path=args.encoder_weight_path,
                        input_size=args.input_size, device=device,
                        pretrained=args.pretrained, trainable=True)


def run_training(args, loaded, device: torch.device, extra_train_datasets=()):
    """Shared by the train and train_expanded CLIs."""
    from distdiff_tpu_torch.data.datasets import BatchLoader, ConcatDataset
    from distdiff_tpu_torch.device import disable_tf32
    from distdiff_tpu_torch.train import (
        TrainConfig,
        create_train_state,
        evaluate,
        fit,
        make_eval_step,
        make_optimizer,
        make_train_step,
    )
    from distdiff_tpu_torch.utils import checkpoints as ckpt

    disable_tf32()
    gm = build_model(args, loaded.num_classes, device)
    train_ds = loaded.train
    if extra_train_datasets:
        train_ds = ConcatDataset([train_ds, *extra_train_datasets])

    train_loader = BatchLoader(train_ds, args.train_batch, shuffle=True,
                               seed=args.manualSeed or 0, drop_last=False)
    test_loader = BatchLoader(loaded.test, args.test_batch)

    cfg = TrainConfig(
        lr=args.lr,
        epochs=args.epochs,
        momentum=args.momentum,
        weight_decay=args.weight_decay,
        train_fc_only=args.train_fc,
        accumulate=args.accumulate,
    )
    tx = make_optimizer(gm.module, cfg, steps_per_epoch=len(train_loader))
    state = create_train_state(gm.module, tx)
    train_step = make_train_step(gm.module, tx)
    eval_step = make_eval_step(gm.module)

    if args.evaluate:
        loss, acc1, acc5 = evaluate(eval_step, test_loader)
        print(f"Evaluation: loss {loss:.4f} top1 {acc1:.2f}% top5 {acc5:.2f}%")
        return {"best_accuracy": acc1, "last_accuracy": acc1}

    def lr_at_epoch(e):
        # cosine annealing over epochs (train.py:158): what log.txt prints;
        # the optimiser's rate follows the cosine over its updates
        return args.lr * 0.5 * (1 + math.cos(math.pi * e / args.epochs))

    start_epoch, best_acc = 0, 0.0
    resume = False
    if args.resume:
        restored = ckpt.load_train_checkpoint(args.resume, state)
        if restored is not None:
            state = restored["state"]
            start_epoch = int(restored["epoch"])
            best_acc = float(restored["best_acc"])
            resume = True
            print(f"Resumed from {args.resume} at epoch {start_epoch}")

    result = fit(
        train_step, eval_step, state, train_loader, test_loader, cfg,
        ensure_dir(args.checkpoint), lr_at_epoch,
        resume=resume, start_epoch=start_epoch, best_acc=best_acc,
    )
    print("Best acc:")
    print(result["best_accuracy"])
    return result


def main(argv=None):
    args = parse_args(argv)
    setup_logging()
    device = cli_device()
    set_seed(args.manualSeed)
    loaded = build_dataset(args)
    return run_training(args, loaded, device)


if __name__ == "__main__":
    main()
