"""Train on original ⊕ expanded data (port of
``distdiff_tpu/cli/train_expanded.py``; the reference's
``train_expanded_data_concat_original.py``): the same trainer, with one or
more ``--data_expanded_dir`` trees (the generator's
``{out}/{classname}/*.png``) concatenated onto the original trainset
(``:148-156``).

Usage:
  python -m distdiff_tpu_torch.cli.train_expanded -d caltech-101 -a resnet50 \\
      --data_expanded_dir data/caltech-101_expansion/save/distdiff_batch_5x \\
      --checkpoint checkpoint/caltech-101/resnet50_expanded/seed1
"""

from __future__ import annotations

import argparse

from distdiff_tpu_torch.cli.common import (
    add_dataset_args,
    add_train_args,
    cli_device,
    set_seed,
    setup_logging,
)
from distdiff_tpu_torch.cli.train import build_dataset, run_training


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train on original + expanded data")
    add_dataset_args(p)
    add_train_args(p)
    p.add_argument(
        "--data_expanded_dir", type=str, nargs="+", required=True,
        help="one or more expanded-image trees ({root}/{classname}/*.png)",
    )
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    setup_logging()
    device = cli_device()
    set_seed(args.manualSeed)
    loaded = build_dataset(args)

    from distdiff_tpu_torch.data.datasets import DatasetByClassNames
    from distdiff_tpu_torch.data.transforms import train_transform

    expanded = [
        DatasetByClassNames(root, loaded.classnames, train_transform(args.input_size))
        for root in args.data_expanded_dir
    ]
    for root, ds in zip(args.data_expanded_dir, expanded):
        print(f"expanded dir {root}: {len(ds)} images")
    return run_training(args, loaded, device, extra_train_datasets=expanded)


if __name__ == "__main__":
    main()
