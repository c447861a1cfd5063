"""Host-side image transforms on ``[H, W, C]`` uint8 numpy arrays (port of
``distdiff_tpu/data/transforms.py``).

The JAX package resizes and rotates with PIL, which the machine with the
card lacks. ``Resize`` reproduces Pillow's ``BILINEAR`` resampling bit for
bit: a triangle filter widened by the scale factor when it downscales,
coefficients normalised and rounded to 22-bit fixed point, a horizontal
pass then a vertical pass, each rounded to uint8. ``resize_bicubic`` does
the same with Pillow's ``BICUBIC`` filter (a = -0.5, support 2). ``affine`` reproduces
``Image.transform(AFFINE)`` at ``BILINEAR`` and ``NEAREST`` bit for bit,
and ``rotate`` (``RandomRotation``) ``Image.rotate`` through it.
The random transforms draw from the caller's ``np.random.Generator`` in
the JAX package's order, so their choices are its choices. Every transform
is ``fn(image, rng) -> image``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# Pillow's fixed point for 8-bit resampling (Resample.c PRECISION_BITS)
_PRECISION_BITS = 32 - 8 - 2


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img, rng: Optional[np.random.Generator] = None):
        rng = rng or np.random.default_rng()
        for t in self.transforms:
            img = t(img, rng)
        return img


def _triangle(x: np.ndarray) -> np.ndarray:
    """Pillow's bilinear filter (support 1)."""
    return np.where(np.abs(x) < 1.0, 1.0 - np.abs(x), 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic filter (``Resample.c`` ``bicubic_filter``, a = -0.5,
    support 2), in its order of operations."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(in_size: int, out_size: int, kernel=_triangle, support: float = 1.0):
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for a
    filter of the given support: the first input index of each output and
    its fixed-point weights ``[out_size, ksize]``, zero past the window."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    taps = np.arange(ksize)
    w = kernel(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for k in range(ksize):  # Pillow sums the taps in order
        ww = ww + w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    fixed = np.trunc(np.where(w < 0, -0.5, 0.5) + w * (1 << _PRECISION_BITS))
    return xmin, fixed.astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int, kernel=_triangle,
                   support: float = 1.0) -> np.ndarray:
    """One pass of Pillow's 8-bit resampling along ``axis`` (1: width,
    0: height), rounded and clipped to uint8 (``clip8``: a negative sum,
    which the bicubic lobes allow, reads 0). The sums fit int32, as in
    Pillow: the weights add up to about 2^22, their magnitudes to less than
    2^23."""
    in_size = img.shape[axis]
    xmin, kk = _coeffs(in_size, out_size, kernel, support)
    kk = kk.astype(np.int32)
    shape = [1] * img.ndim
    shape[axis] = out_size
    acc = np.full((1,) * img.ndim, 1 << (_PRECISION_BITS - 1), np.int32)
    for k in range(kk.shape[1]):
        idx = np.minimum(xmin + k, in_size - 1)
        acc = acc + np.take(img, idx, axis=axis).astype(np.int32) * kk[:, k].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _resize(img: np.ndarray, size_hw, kernel, support: float) -> np.ndarray:
    h, w = size_hw
    if img.shape[1] != w:
        img = _resample_axis(img, w, 1, kernel, support)
    if img.shape[0] != h:
        img = _resample_axis(img, h, 0, kernel, support)
    return img


def resize_bilinear(img: np.ndarray, size_hw) -> np.ndarray:
    """``[H, W, C]`` uint8 -> ``[h, w, C]`` as Pillow's
    ``resize((w, h), BILINEAR)``: the horizontal pass first, each pass only
    where its size changes."""
    return _resize(img, size_hw, _triangle, 1.0)


def resize_bicubic(img: np.ndarray, size_hw) -> np.ndarray:
    """``[H, W, C]`` uint8 -> ``[h, w, C]`` as Pillow's
    ``resize((w, h), BICUBIC)``, bit for bit, in the same two passes."""
    return _resize(img, size_hw, _bicubic, 2.0)


class Resize:
    """int -> the short side; (h, w) -> that exact size. Bilinear."""

    def __init__(self, size):
        self.size = size

    def __call__(self, img: np.ndarray, rng) -> np.ndarray:
        h, w = img.shape[:2]
        if isinstance(self.size, int):
            scale = self.size / min(w, h)
            new = (max(1, round(h * scale)), max(1, round(w * scale)))
        else:
            new = tuple(self.size)
        return resize_bilinear(img, new)


class CenterCrop:
    """The centre ``size`` square; where the image is smaller, the crop box
    reaches past it and reads black, as PIL's ``crop`` does."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, img: np.ndarray, rng) -> np.ndarray:
        h, w = img.shape[:2]
        s = self.size
        left, top = max(0, (w - s) // 2), max(0, (h - s) // 2)
        out = np.zeros((s, s) + img.shape[2:], img.dtype)
        part = img[top:top + s, left:left + s]
        out[:part.shape[0], :part.shape[1]] = part
        return out


class RandomCrop:
    def __init__(self, size: int):
        self.size = size

    def __call__(self, img: np.ndarray, rng) -> np.ndarray:
        h, w = img.shape[:2]
        s = self.size
        if w < s or h < s:
            img = resize_bilinear(img, (max(h, s), max(w, s)))
            h, w = img.shape[:2]
        left = int(rng.integers(0, w - s + 1))
        top = int(rng.integers(0, h - s + 1))
        return img[top:top + s, left:left + s]


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img: np.ndarray, rng) -> np.ndarray:
        if rng.random() < self.p:
            return img[:, ::-1]
        return img


# Pillow's resampling filters (``PIL.Image.Resampling``)
NEAREST, BILINEAR = 0, 2


def _affine_bilinear(img: np.ndarray, matrix) -> np.ndarray:
    """Pillow's ``ImagingGenericTransform`` with the bilinear filter: each
    output pixel's centre mapped into the source in float64, 0 where that
    point falls outside the image, else the four neighbours (clamped to the
    edge) interpolated in float64 and truncated to uint8 (``Geometry.c``
    ``bilinear_filter8`` / ``bilinear_filter32RGB``)."""
    a, b, c, d, e, f = matrix
    h, w = img.shape[:2]
    yo, xo = np.mgrid[0:h, 0:w].astype(np.float64)
    xo += 0.5
    yo += 0.5
    xin = a * xo + b * yo + c
    yin = d * xo + e * yo + f
    inside = (xin >= 0.0) & (xin < w) & (yin >= 0.0) & (yin < h)
    xin -= 0.5
    yin -= 0.5
    x0, y0 = np.floor(xin), np.floor(yin)
    dx, dy = (xin - x0)[..., None], (yin - y0)[..., None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    xa, xb = np.clip(x0, 0, w - 1), np.clip(x0 + 1, 0, w - 1)
    ya, yb = np.clip(y0, 0, h - 1), np.clip(y0 + 1, 0, h - 1)
    src = img.astype(np.float64)
    top = src[ya, xa] + (src[ya, xb] - src[ya, xa]) * dx
    bottom = src[yb, xa] + (src[yb, xb] - src[yb, xa]) * dx
    out = (top + (bottom - top) * dy).astype(np.uint8)
    out[~inside] = 0
    return out


def _affine_nearest(img: np.ndarray, matrix) -> np.ndarray:
    """Pillow's nearest-neighbour ``ImagingTransformAffine``. A matrix
    without shear (``b == d == 0``) takes ``ImagingScaleAffine``: the
    source column of output column x is the float64 running sum
    ``c + a/2 + a + ... + a``, floored (likewise the rows). Any other takes
    ``affine_fixed``: the centre's offsets and the four coefficients
    rounded to 16.16 fixed point and stepped in integers, so a source
    index is ``(c' + b' y + a' x) >> 16``, not the floor of the exact
    mapped centre (they part where that lies within ~y/2^17 of an integer).
    Pillow steps in float64 only past 32768 px, which raises here."""
    a, b, c, d, e, f = matrix
    h, w = img.shape[:2]
    if b == 0 and d == 0:
        xs = np.cumsum(np.r_[c + a * 0.5, np.full(w - 1, a)])
        ys = np.cumsum(np.r_[f + e * 0.5, np.full(h - 1, e)])
        xi = np.where(xs < 0, -1, np.trunc(xs)).astype(np.int64)[None, :]
        yi = np.where(ys < 0, -1, np.trunc(ys)).astype(np.int64)[:, None]
    else:
        for x, y in ((0, 0), (w, h), (0, h), (w, 0)):
            if abs(x * a + y * b + c) >= 32768.0 or abs(x * d + y * e + f) >= 32768.0:
                raise ValueError(f"affine: a {h}x{w} image mapped past 32768 px, where "
                                 "Pillow leaves 16.16 fixed point")

        def fix(v):
            return math.floor(v * 65536.0 + 0.5)
        y, x = np.arange(h, dtype=np.int64)[:, None], np.arange(w, dtype=np.int64)[None, :]
        xi = (fix(c + b * 0.5 + a * 0.5) + fix(b) * y + fix(a) * x) >> 16
        yi = (fix(f + e * 0.5 + d * 0.5) + fix(e) * y + fix(d) * x) >> 16
    inside = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = img[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
    out[~inside] = 0
    return out


def affine(img: np.ndarray, matrix, resample: int = BILINEAR) -> np.ndarray:
    """``img`` (``[H, W, C]`` or ``[H, W]`` uint8) through the inverse
    affine ``matrix = (a, b, c, d, e, f)``, as Pillow's
    ``Image.transform(size, AFFINE, matrix, resample)`` gives it: output
    pixel (x, y) reads the source near ``(a x' + b y' + c, d x' + e y' +
    f)``, ``x' = x + 0.5``, and 0 past the edge. ``resample`` is
    ``BILINEAR`` or ``NEAREST``; each follows Pillow's own arithmetic
    (``_affine_bilinear``, ``_affine_nearest``)."""
    matrix = tuple(float(v) for v in matrix)
    flat = img.ndim == 2
    src = img[..., None] if flat else img
    if resample == BILINEAR:
        out = _affine_bilinear(src, matrix)
    elif resample == NEAREST:
        out = _affine_nearest(src, matrix)
    else:
        raise ValueError(f"resample {resample!r}: BILINEAR ({BILINEAR}) or NEAREST ({NEAREST})")
    return out[..., 0] if flat else out


def rotate(img: np.ndarray, angle: float, resample: int = BILINEAR) -> np.ndarray:
    """``img`` rotated by ``angle`` degrees counter-clockwise about its
    centre, as Pillow's ``Image.rotate(angle, resample)`` gives it: the
    inverse affine matrix built as ``Image.rotate`` builds it (cos and sin
    rounded to 15 digits), then ``affine``. At multiples of 90 degrees,
    where Pillow copies or transposes instead, the rounded matrix maps
    pixel centres onto pixel centres, so this gives the same bytes."""
    angle = angle % 360.0
    h, w = img.shape[:2]
    cx, cy = w / 2, h / 2
    rad = -math.radians(angle)
    a, b = round(math.cos(rad), 15), round(math.sin(rad), 15)
    d, e = round(-math.sin(rad), 15), round(math.cos(rad), 15)
    c = a * -cx + b * -cy + 0.0 + cx
    f = d * -cx + e * -cy + 0.0 + cy
    return affine(img, (a, b, c, d, e, f), resample)


class RandomRotation:
    def __init__(self, degrees: float):
        self.degrees = degrees

    def __call__(self, img: np.ndarray, rng) -> np.ndarray:
        return rotate(img, float(rng.uniform(-self.degrees, self.degrees)))


class ToArray:
    """uint8 HWC -> fp32 in [0, 1]."""

    def __call__(self, img: np.ndarray, rng=None) -> np.ndarray:
        return img.astype(np.float32) / 255.0


class Normalize:
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, arr: np.ndarray, rng=None) -> np.ndarray:
        return (arr - self.mean) / self.std


def sd_transform(size: int = 512, center_crop: bool = False) -> Compose:
    """SDDataset preprocessing -> [-1, 1] (reference ``dataloader.py:757-764``)."""
    return Compose([
        Resize(size),
        CenterCrop(size) if center_crop else RandomCrop(size),
        ToArray(),
        Normalize([0.5, 0.5, 0.5], [0.5, 0.5, 0.5]),
    ])


def train_transform(size: int = 224) -> Compose:
    """Downstream training augmentation (reference ``train.py:122-129``)."""
    return Compose([
        Resize(int(size * 256 / 224)),
        RandomRotation(15),
        RandomCrop(size),
        RandomHorizontalFlip(),
        ToArray(),
        Normalize(IMAGENET_MEAN, IMAGENET_STD),
    ])


def eval_transform(size: int = 224) -> Compose:
    """Test-time transform (reference ``train.py:130-135``)."""
    return Compose([
        Resize(int(size * 256 / 224)),
        CenterCrop(size),
        ToArray(),
        Normalize(IMAGENET_MEAN, IMAGENET_STD),
    ])


def prototype_transform(size: int = 224) -> Compose:
    """Exact resize + ImageNet normalisation (reference ``dataloader.py:736-742``)."""
    return Compose([
        Resize((size, size)),
        ToArray(),
        Normalize(IMAGENET_MEAN, IMAGENET_STD),
    ])
