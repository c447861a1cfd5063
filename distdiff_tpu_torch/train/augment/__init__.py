"""Training-time augmentations (port of ``distdiff_tpu/train/augment``) on
``[H, W, C]`` uint8 numpy arrays with Pillow's bytes, and their losses on
torch tensors."""

from distdiff_tpu_torch.train.augment.augmix import (
    AugMixDataset,
    augment_and_mix,
    jsd_consistency_loss,
)
from distdiff_tpu_torch.train.augment.cutmix import (
    cutmix_data,
    rand_bbox,
    soft_target_cross_entropy,
)
from distdiff_tpu_torch.train.augment.gridmask import GridMask
from distdiff_tpu_torch.train.augment.mixup import mixup_criterion, mixup_data
from distdiff_tpu_torch.train.augment.pil_ops import (
    AUGMENTATIONS,
    AUGMENTATIONS_ALL,
    AutoAugmentCIFAR,
    Cutout,
    RandAugment,
)

__all__ = [
    "AugMixDataset",
    "augment_and_mix",
    "jsd_consistency_loss",
    "cutmix_data",
    "rand_bbox",
    "soft_target_cross_entropy",
    "GridMask",
    "mixup_data",
    "mixup_criterion",
    "AUGMENTATIONS",
    "AUGMENTATIONS_ALL",
    "RandAugment",
    "AutoAugmentCIFAR",
    "Cutout",
]
