"""Severity-scaled op bank (port of ``distdiff_tpu/train/augment/pil_ops.py``;
reference ``augmentations/augmentations.py``) plus the transform-level
policies ``train_transform`` selects through ``--transform_type``
(randaug / autoaug / cutout, reference ``train_transform.py:101-144``).

Images are ``[H, W, C]`` uint8 arrays where the JAX package has PIL
images; each op gives Pillow's bytes (``pillow.py``, ``data/transforms.py``
``affine`` and ``rotate``). Severity as in the reference bank: every
application draws ``sample_level(n)``, uniform in [0.1, n], then scales by
maxval/10 (``augmentations/augmentations.py:10-38``); translations scale
by the image's own size. Every op takes an optional numpy Generator and
draws from it in the JAX package's order; without one it falls back to
the global numpy stream.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np

from distdiff_tpu_torch.data.transforms import BILINEAR, affine
from distdiff_tpu_torch.data.transforms import rotate as _rotate
from distdiff_tpu_torch.train.augment import pillow


def _rng(rng):
    return rng if rng is not None else np.random.default_rng(
        np.random.randint(2**31)
    )


def sample_level(n: float, rng=None) -> float:
    """Uniform in [0.1, n] per application (augmentations.py:36-38)."""
    return float(_rng(rng).uniform(0.1, n))


def _int_param(level: float, maxval: float) -> int:
    return int(level * maxval / 10)


def _float_param(level: float, maxval: float) -> float:
    return float(level) * maxval / 10.0


def autocontrast(img, severity=1, rng=None):
    return pillow.autocontrast(img)


def equalize(img, severity=1, rng=None):
    return pillow.equalize(img)


def posterize(img, severity=1, rng=None):
    bits = 4 - _int_param(sample_level(severity, rng), 4)
    return pillow.posterize(img, max(1, bits))


def rotate(img, severity=1, rng=None):
    r = _rng(rng)
    deg = _int_param(sample_level(severity, r), 30)
    if r.random() > 0.5:
        deg = -deg
    return _rotate(img, deg, BILINEAR)


def solarize(img, severity=1, rng=None):
    return pillow.solarize(img, 256 - _int_param(sample_level(severity, rng), 256))


def _affine(img, matrix):
    return affine(img, matrix, BILINEAR)


def shear_x(img, severity=1, rng=None):
    r = _rng(rng)
    s = _float_param(sample_level(severity, r), 0.3)
    if r.random() > 0.5:
        s = -s
    return _affine(img, (1, s, 0, 0, 1, 0))


def shear_y(img, severity=1, rng=None):
    r = _rng(rng)
    s = _float_param(sample_level(severity, r), 0.3)
    if r.random() > 0.5:
        s = -s
    return _affine(img, (1, 0, 0, s, 1, 0))


def translate_x(img, severity=1, rng=None):
    # PIL's img.size is (width, height): x scales by the width
    r = _rng(rng)
    t = _int_param(sample_level(severity, r), img.shape[1] / 3)
    if r.random() > 0.5:
        t = -t
    return _affine(img, (1, 0, t, 0, 1, 0))


def translate_y(img, severity=1, rng=None):
    r = _rng(rng)
    t = _int_param(sample_level(severity, r), img.shape[0] / 3)
    if r.random() > 0.5:
        t = -t
    return _affine(img, (1, 0, 0, 0, 1, t))


def color(img, severity=1, rng=None):
    return pillow.color(img, _float_param(sample_level(severity, rng), 1.8) + 0.1)


def contrast(img, severity=1, rng=None):
    return pillow.contrast(img, _float_param(sample_level(severity, rng), 1.8) + 0.1)


def brightness(img, severity=1, rng=None):
    return pillow.brightness(img, _float_param(sample_level(severity, rng), 1.8) + 0.1)


def sharpness(img, severity=1, rng=None):
    return pillow.sharpness(img, _float_param(sample_level(severity, rng), 1.8) + 0.1)


# AugMix's default bank excludes the color ops that overlap ImageNet-C
# (reference ``augmentations`` list, augmentations/augmentations.py:127-131).
AUGMENTATIONS: List[Callable] = [
    autocontrast, equalize, posterize, rotate, solarize,
    shear_x, shear_y, translate_x, translate_y,
]

AUGMENTATIONS_ALL: List[Callable] = AUGMENTATIONS + [
    color, contrast, brightness, sharpness,
]


# Transform-level 'randaug'/'autoaug' are the torchvision-exact policies of
# tv_policies.py, re-exported here under the JAX package's names.
from distdiff_tpu_torch.train.augment.tv_policies import (  # noqa: E402,F401
    AutoAugmentCIFAR10,
    RandAugment,
)

AutoAugmentCIFAR = AutoAugmentCIFAR10


class Cutout:
    """Zero out a random square patch (transform-level 'cutout')."""

    def __init__(self, length: int = 16):
        self.length = length

    def __call__(self, arr: np.ndarray, rng=None) -> np.ndarray:
        r = _rng(rng)
        h, w = arr.shape[:2]
        y = int(r.integers(h))
        x = int(r.integers(w))
        y1, y2 = np.clip([y - self.length // 2, y + self.length // 2], 0, h)
        x1, x2 = np.clip([x - self.length // 2, x + self.length // 2], 0, w)
        arr = arr.copy()
        arr[y1:y2, x1:x2] = 0.0
        return arr
