"""torchvision-exact AutoAugment (CIFAR-10 policy) and RandAugment (port of
``distdiff_tpu/train/augment/tv_policies.py``; the reference's
``--transform_type autoaug`` / ``randaug``, ``train_transform.py:101-144``,
which call ``torchvision.transforms.AutoAugment(AutoAugmentPolicy.CIFAR10)``
and ``RandAugment()``).

The 25-sub-policy CIFAR-10 table, torchvision's ``_augmentation_space``
magnitude bins and its ``_apply_op`` on the PIL backend (enhancements as
``enhance(1 + magnitude)``, shear as the affine matrix ``(1, m, 0, 0, 1,
0)``, integer-truncated translations, NEAREST resampling, zero fill), on
``[H, W, C]`` uint8 arrays with Pillow's bytes (``pillow.py``,
``data/transforms.py``). Randomness comes from a caller-supplied numpy
``Generator``, drawn in the JAX package's order.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from distdiff_tpu_torch.data.transforms import NEAREST, affine, rotate
from distdiff_tpu_torch.train.augment import pillow

# --------------------------------------------------------------------------
# The published CIFAR-10 policy: 25 sub-policies of two
# (op_name, probability, magnitude_bin) stages; bin is None for
# parameterless ops. Verbatim torchvision AutoAugmentPolicy.CIFAR10.
# --------------------------------------------------------------------------
CIFAR10_POLICY: List[Tuple[Tuple[str, float, Optional[int]],
                           Tuple[str, float, Optional[int]]]] = [
    (("Invert", 0.1, None), ("Contrast", 0.2, 6)),
    (("Rotate", 0.7, 2), ("TranslateX", 0.3, 9)),
    (("Sharpness", 0.8, 1), ("Sharpness", 0.9, 3)),
    (("ShearY", 0.5, 8), ("TranslateY", 0.7, 9)),
    (("AutoContrast", 0.5, None), ("Equalize", 0.9, None)),
    (("ShearY", 0.2, 7), ("Posterize", 0.3, 7)),
    (("Color", 0.4, 3), ("Brightness", 0.6, 7)),
    (("Sharpness", 0.3, 9), ("Brightness", 0.7, 9)),
    (("Equalize", 0.6, None), ("Equalize", 0.5, None)),
    (("Contrast", 0.6, 7), ("Sharpness", 0.6, 5)),
    (("Color", 0.7, 7), ("TranslateX", 0.5, 8)),
    (("Equalize", 0.3, None), ("AutoContrast", 0.4, None)),
    (("TranslateY", 0.4, 3), ("Sharpness", 0.2, 6)),
    (("Brightness", 0.9, 6), ("Color", 0.2, 8)),
    (("Solarize", 0.5, 2), ("Invert", 0.0, None)),
    (("Equalize", 0.2, None), ("AutoContrast", 0.6, None)),
    (("Equalize", 0.2, None), ("Equalize", 0.6, None)),
    (("Color", 0.9, 9), ("Equalize", 0.6, None)),
    (("AutoContrast", 0.8, None), ("Solarize", 0.2, 8)),
    (("Brightness", 0.1, 3), ("Color", 0.7, 0)),
    (("Solarize", 0.4, 5), ("AutoContrast", 0.9, None)),
    (("TranslateY", 0.9, 9), ("TranslateY", 0.7, 9)),
    (("AutoContrast", 0.9, None), ("Solarize", 0.8, 3)),
    (("Equalize", 0.8, None), ("Invert", 0.1, None)),
    (("TranslateY", 0.7, 9), ("AutoContrast", 0.9, None)),
]


def augmentation_space(num_bins: int, height: int, width: int,
                       *, include_identity: bool,
                       include_invert: bool) -> Dict[str, Tuple[np.ndarray, bool]]:
    """torchvision ``_augmentation_space``: name -> (magnitude bins, signed).

    AutoAugment uses ``num_bins=10`` with Invert and no Identity;
    RandAugment uses ``num_bins=num_magnitude_bins`` with Identity and no
    Invert. Dict ORDER is part of the contract (RandAugment samples op
    indices uniformly over it).
    """
    space: Dict[str, Tuple[np.ndarray, bool]] = {}
    if include_identity:
        space["Identity"] = (np.array(0.0), False)
    space.update({
        "ShearX": (np.linspace(0.0, 0.3, num_bins), True),
        "ShearY": (np.linspace(0.0, 0.3, num_bins), True),
        "TranslateX": (np.linspace(0.0, 150.0 / 331.0 * width, num_bins), True),
        "TranslateY": (np.linspace(0.0, 150.0 / 331.0 * height, num_bins), True),
        "Rotate": (np.linspace(0.0, 30.0, num_bins), True),
        "Brightness": (np.linspace(0.0, 0.9, num_bins), True),
        "Color": (np.linspace(0.0, 0.9, num_bins), True),
        "Contrast": (np.linspace(0.0, 0.9, num_bins), True),
        "Sharpness": (np.linspace(0.0, 0.9, num_bins), True),
        # numpy rounds half to even, as torch.round does
        "Posterize": (8 - np.round(np.arange(num_bins) / ((num_bins - 1) / 4)), False),
        "Solarize": (np.linspace(255.0, 0.0, num_bins), False),
        "AutoContrast": (np.array(0.0), False),
        "Equalize": (np.array(0.0), False),
    })
    if include_invert:
        space["Invert"] = (np.array(0.0), False)
    return space


def apply_op(img: np.ndarray, op_name: str, magnitude: float,
             resample: int = NEAREST) -> np.ndarray:
    """torchvision ``_apply_op`` on the PIL backend (NEAREST, zero fill)."""
    if op_name == "ShearX":
        # F.affine(shear=[degrees(atan(m)), 0], center=[0,0]): at angle 0
        # its inverse matrix reduces to the classic shear matrix
        return affine(img, (1.0, magnitude, 0.0, 0.0, 1.0, 0.0), resample)
    if op_name == "ShearY":
        return affine(img, (1.0, 0.0, 0.0, magnitude, 1.0, 0.0), resample)
    if op_name == "TranslateX":
        # F.affine(translate=[int(m), 0]) about the image centre: the
        # inverse matrix is a pure offset of -int(m)
        return affine(img, (1.0, 0.0, -int(magnitude), 0.0, 1.0, 0.0), resample)
    if op_name == "TranslateY":
        return affine(img, (1.0, 0.0, 0.0, 0.0, 1.0, -int(magnitude)), resample)
    if op_name == "Rotate":
        return rotate(img, magnitude, resample)
    if op_name == "Brightness":
        return pillow.brightness(img, 1.0 + magnitude)
    if op_name == "Color":
        return pillow.color(img, 1.0 + magnitude)
    if op_name == "Contrast":
        return pillow.contrast(img, 1.0 + magnitude)
    if op_name == "Sharpness":
        return pillow.sharpness(img, 1.0 + magnitude)
    if op_name == "Posterize":
        return pillow.posterize(img, int(magnitude))
    if op_name == "Solarize":
        return pillow.solarize(img, magnitude)
    if op_name == "AutoContrast":
        return pillow.autocontrast(img)
    if op_name == "Equalize":
        return pillow.equalize(img)
    if op_name == "Invert":
        return pillow.invert(img)
    if op_name == "Identity":
        return img
    raise ValueError(f"unknown op {op_name!r}")


def _default_rng(rng):
    if rng is None:
        return np.random.default_rng(np.random.randint(2 ** 31))
    return rng


class AutoAugmentCIFAR10:
    """Exact torchvision ``AutoAugment(AutoAugmentPolicy.CIFAR10)``.

    Per call: pick one of the 25 sub-policies uniformly; for each of its
    two stages draw an application coin against the stage probability and
    an independent sign coin; look the stage's magnitude bin up in the
    10-bin space for the actual image size; apply with NEAREST resampling.
    """

    policies = CIFAR10_POLICY

    def __call__(self, img: np.ndarray, rng=None) -> np.ndarray:
        r = _default_rng(rng)
        sub = self.policies[int(r.integers(len(self.policies)))]
        space = augmentation_space(10, img.shape[0], img.shape[1],
                                   include_identity=False,
                                   include_invert=True)
        for op_name, prob, magnitude_id in sub:
            if r.random() > prob:
                continue
            magnitudes, signed = space[op_name]
            magnitude = (float(magnitudes[magnitude_id])
                         if magnitude_id is not None else 0.0)
            if signed and int(r.integers(2)) == 0:
                magnitude = -magnitude
            img = apply_op(img, op_name, magnitude)
        return img


class RandAugment:
    """Exact torchvision ``RandAugment(num_ops, magnitude,
    num_magnitude_bins)``: ``num_ops`` uniform draws over the 14-op space
    (Identity included, Invert excluded), each applied unconditionally at
    the fixed ``magnitude`` bin with a fair sign flip on signed ops."""

    def __init__(self, num_ops: int = 2, magnitude: int = 9,
                 num_magnitude_bins: int = 31):
        self.num_ops = num_ops
        self.magnitude = magnitude
        self.num_magnitude_bins = num_magnitude_bins

    def __call__(self, img: np.ndarray, rng=None) -> np.ndarray:
        r = _default_rng(rng)
        space = augmentation_space(self.num_magnitude_bins,
                                   img.shape[0], img.shape[1],
                                   include_identity=True,
                                   include_invert=False)
        names: Sequence[str] = list(space)
        for _ in range(self.num_ops):
            op_name = names[int(r.integers(len(names)))]
            magnitudes, signed = space[op_name]
            magnitude = (float(magnitudes[self.magnitude])
                         if magnitudes.ndim > 0 else 0.0)
            if signed and int(r.integers(2)):
                magnitude = -magnitude
            img = apply_op(img, op_name, magnitude)
        return img
