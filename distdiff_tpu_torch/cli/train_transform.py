"""Expansion x transformation-augmentation matrix (port of
``distdiff_tpu/cli/train_transform.py``; the reference's
``train_transform.py``): train with ``--transform_type`` in
default/autoaug/randaug/cutout (transform-level), cutmix/augmix/gridmask/
mixup (batch- or loss-level), over the original data replicated
(expand_num+1)x, or original ⊕ expanded with ``--expand_num`` images a
source (``train_transform.py:158-169,230-258``). Runs on the card;
``DISTDIFF_PLATFORM=cpu`` asks for the CPU. Original images are read as
PNG only (``data/datasets.py``).

Usage:
  python -m distdiff_tpu_torch.cli.train_transform -d caltech-101 \\
      --transform_type randaug --expand_num 5 \\
      --data_expanded_dir data/caltech-101_expansion/save/distdiff_batch_5x \\
      --checkpoint checkpoint/caltech-101/resnet50_randaug/seed1 --manualSeed 1
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from distdiff_tpu_torch.cli.common import (
    add_dataset_args,
    add_train_args,
    cli_device,
    ensure_dir,
    set_seed,
    setup_logging,
)
from distdiff_tpu_torch.cli.train import build_dataset, build_model

TRANSFORM_TYPES = (
    "default", "autoaug", "randaug", "cutout",
    "cutmix", "augmix", "gridmask", "mixup",
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Expansion x augmentation trainer")
    add_dataset_args(p)
    add_train_args(p)
    p.add_argument("--transform_type", type=str, default="default",
                   choices=TRANSFORM_TYPES)
    p.add_argument("--data_expanded_dir", type=str, nargs="*", default=[])
    p.add_argument("--expand_num", type=int, default=5)
    return p.parse_args(argv)


def _geometric_stages(size: int) -> list:
    from distdiff_tpu_torch.data.transforms import (
        RandomCrop,
        RandomHorizontalFlip,
        RandomRotation,
        Resize,
    )

    return [Resize(int(size * 256 / 224)), RandomRotation(15), RandomCrop(size),
            RandomHorizontalFlip()]


def build_transform(args):
    """Transform-level augmentation stack (``get_transform``,
    ``train_transform.py:101-144``)."""
    from distdiff_tpu_torch.data.transforms import (
        IMAGENET_MEAN,
        IMAGENET_STD,
        Compose,
        Normalize,
        ToArray,
    )
    from distdiff_tpu_torch.train.augment import AutoAugmentCIFAR, Cutout, RandAugment

    size = args.input_size
    stack = _geometric_stages(size)
    if args.transform_type == "autoaug":
        stack.append(AutoAugmentCIFAR())
    elif args.transform_type == "randaug":
        stack.append(RandAugment(2, 9))
    stack += [ToArray(), Normalize(IMAGENET_MEAN, IMAGENET_STD)]
    if args.transform_type == "cutout":
        stack.append(Cutout(size // 4))
    return Compose(stack)


def batch_stage(transform_type: str, rng: np.random.Generator):
    """``(loss_fn, on_batch, gridmask)`` of a ``--transform_type``: the
    loss that replaces cross-entropy (None for it), the function
    ``on_batch(images, targets, mask)`` that ``fit`` applies to each
    loaded batch, and the ``GridMask`` whose probability ``fit``'s
    ``on_epoch`` ramps (None but for gridmask). Batch-level draws come
    from ``rng``."""
    from distdiff_tpu_torch.train import cross_entropy
    from distdiff_tpu_torch.train.augment import (
        GridMask,
        cutmix_data,
        jsd_consistency_loss,
        mixup_criterion,
        mixup_data,
        soft_target_cross_entropy,
    )

    if transform_type in ("mixup", "cutmix"):
        mix_fn = mixup_data if transform_type == "mixup" else cutmix_data
        mix_state = {}

        def loss_fn(logits, targets, mask):
            # the step runs eagerly, so this reads the targets and lam that
            # on_batch has just drawn for this batch
            ta, tb = (torch.from_numpy(mix_state[k]).to(logits.device) for k in ("ta", "tb"))
            lam = mix_state["lam"]
            if transform_type == "mixup":
                return mixup_criterion(cross_entropy, logits, ta, tb, lam, mask)
            return soft_target_cross_entropy(logits, ta, tb, lam, mask)

        def on_batch(images, targets, mask):
            mixed, ta, tb, lam = mix_fn(images, targets, rng=rng)
            mix_state.update(ta=ta, tb=tb, lam=lam)
            return mixed, targets, mask

        return loss_fn, on_batch, None

    if transform_type == "augmix":
        # 3-view JSD loss: the views packed into the batch axis (B*3)
        def loss_fn(logits, targets, mask):
            lc, l1, l2 = logits[0::3], logits[1::3], logits[2::3]
            ce = cross_entropy(lc, targets[0::3], mask[0::3])
            return ce + 12.0 * jsd_consistency_loss(lc, l1, l2, mask[0::3])

        def on_batch(images, targets, mask):
            # images arrive as [B, 3, H, W, C] from AugMixDataset's items
            b = images.shape[0]
            flat = images.reshape(b * 3, *images.shape[2:])
            return flat, np.repeat(targets, 3), np.repeat(mask, 3)

        return loss_fn, on_batch, None

    gridmask = GridMask() if transform_type == "gridmask" else None

    def on_batch(images, targets, mask):
        if gridmask is not None:
            images = gridmask(images, rng)
        return images, targets, mask

    return None, on_batch, gridmask


def main(argv=None):
    args = parse_args(argv)
    setup_logging()
    device = cli_device()
    set_seed(args.manualSeed)

    from distdiff_tpu_torch.data.datasets import (
        BatchLoader,
        ConcatDataset,
        DatasetByClassNames,
        RepeatDataset,
    )
    from distdiff_tpu_torch.device import disable_tf32
    from distdiff_tpu_torch.train import (
        TrainConfig,
        create_train_state,
        fit,
        make_eval_step,
        make_optimizer,
        make_train_step,
    )
    from distdiff_tpu_torch.train.augment import AugMixDataset

    disable_tf32()
    is_augmix = args.transform_type == "augmix"
    # augmix applies its own stages inside AugMixDataset: the base datasets
    # stay raw (transform None) and the wrapper makes 3-view stacks
    # (reference train_transform.py:256-271)
    tf = None if is_augmix else build_transform(args)
    loaded = build_dataset(args, train_tf=tf, raw_train=is_augmix)

    if args.data_expanded_dir:
        expanded = [
            DatasetByClassNames(root, loaded.classnames, tf, expand_num=args.expand_num)
            for root in args.data_expanded_dir
        ]
        train_ds = ConcatDataset([loaded.train, *expanded])
        # exact (N+1)x ratio assert (train_transform.py:249)
        expected = len(loaded.train) * (args.expand_num + 1)
        assert len(train_ds) == expected, (
            f"expansion ratio mismatch: {len(train_ds)} != {expected}"
        )
    else:
        # no-expansion control: original x (expand_num+1) replicas (:245)
        train_ds = RepeatDataset(loaded.train, args.expand_num + 1)

    if is_augmix:
        from distdiff_tpu_torch.data.transforms import (
            IMAGENET_MEAN,
            IMAGENET_STD,
            Compose,
            Normalize,
            ToArray,
        )

        train_ds = AugMixDataset(
            train_ds, Compose(_geometric_stages(args.input_size)),
            Compose([ToArray(), Normalize(IMAGENET_MEAN, IMAGENET_STD)]),
            seed=args.manualSeed or 0)

    gm = build_model(args, loaded.num_classes, device)
    train_loader = BatchLoader(train_ds, args.train_batch, shuffle=True,
                               seed=args.manualSeed or 0)
    test_loader = BatchLoader(loaded.test, args.test_batch)

    cfg = TrainConfig(lr=args.lr, epochs=args.epochs, momentum=args.momentum,
                      weight_decay=args.weight_decay)
    tx = make_optimizer(gm.module, cfg, steps_per_epoch=len(train_loader))
    state = create_train_state(gm.module, tx)
    eval_step = make_eval_step(gm.module)

    loss_fn, on_batch, gridmask = batch_stage(args.transform_type,
                                              np.random.default_rng(args.manualSeed or 0))
    train_step = make_train_step(gm.module, tx, loss_fn=loss_fn)

    def lr_at_epoch(e):
        return args.lr * 0.5 * (1 + math.cos(math.pi * e / args.epochs))

    # GridMask's prob ramps linearly with the epoch index (the reference,
    # train_transform.py:381, ramps over 80 epochs; capped by the run's own
    # budget so that short runs still apply the mask), through fit's on_epoch
    on_epoch = ((lambda e: gridmask.set_prob(e, min(80, args.epochs)))
                if gridmask is not None else None)

    result = fit(
        train_step, eval_step, state, train_loader, test_loader, cfg,
        ensure_dir(args.checkpoint), lr_at_epoch, on_batch=on_batch,
        on_epoch=on_epoch,
    )
    print("Best acc:")
    print(result["best_accuracy"])
    return result


if __name__ == "__main__":
    main()
