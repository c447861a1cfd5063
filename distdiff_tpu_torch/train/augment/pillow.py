"""The Pillow calls of the augmentation bank as numpy functions on
``[H, W, C]`` uint8 arrays, byte for byte: ``ImageOps.autocontrast``,
``equalize``, ``posterize``, ``solarize`` and ``invert``, and the four
``ImageEnhance`` classes' ``enhance``. The machine with the card has no
PIL. Geometry (``Image.transform(AFFINE)``, ``Image.rotate``) is
``data/transforms.py``'s ``affine`` and ``rotate``.

Each follows Pillow's own arithmetic: the ``ImageOps`` functions build
Pillow's per-band lookup tables (``PIL/ImageOps.py``, cutoff 0 and no
mask), applied as ``Image.point`` applies them (values rounded and clipped
to 0..255). An enhancement is ``Image.blend(degenerate, image, factor)``,
which computes ``deg + factor * (img - deg)`` in float32 and truncates,
clipped to 0..255 (``Blend.c``).
"""

from __future__ import annotations

import numpy as np


def _bands(img: np.ndarray) -> np.ndarray:
    return img[..., None] if img.ndim == 2 else img


def _point(img: np.ndarray, luts) -> np.ndarray:
    """Each band through its own 256-entry table, as ``Image.point`` does."""
    src = _bands(img)
    out = np.empty_like(src)
    for k, lut in enumerate(luts):
        table = np.clip(np.round(np.asarray(lut, np.float64)), 0, 255).astype(np.uint8)
        out[..., k] = table[src[..., k]]
    return out.reshape(img.shape)


def _histograms(img: np.ndarray) -> list:
    src = _bands(img)
    return [np.bincount(src[..., k].ravel(), minlength=256) for k in range(src.shape[-1])]


def autocontrast(img: np.ndarray) -> np.ndarray:
    """``ImageOps.autocontrast(img)``: each band's lowest and highest value
    stretched to 0 and 255, ``int(v * scale + offset)`` in float64; a band
    of one value stays as it is."""
    luts = []
    for h in _histograms(img):
        present = np.flatnonzero(h)
        lo, hi = int(present[0]), int(present[-1])
        if hi <= lo:
            luts.append(np.arange(256))
            continue
        scale = 255.0 / (hi - lo)
        offset = -lo * scale
        luts.append(np.clip(np.trunc(np.arange(256) * scale + offset), 0, 255))
    return _point(img, luts)


def equalize(img: np.ndarray) -> np.ndarray:
    """``ImageOps.equalize(img)``: each band's cumulative histogram in
    steps of ``(n - last bin present) // 255`` pixels; a band of one
    value, or one with a step of 0, stays as it is."""
    luts = []
    for h in _histograms(img):
        histo = h[h > 0]
        step = (int(histo.sum()) - int(histo[-1])) // 255 if len(histo) > 1 else 0
        if not step:
            luts.append(np.arange(256))
            continue
        n = step // 2 + np.concatenate([[0], np.cumsum(h[:-1])])
        luts.append(n // step)
    return _point(img, luts)


def posterize(img: np.ndarray, bits: int) -> np.ndarray:
    """``ImageOps.posterize``: each value's low ``8 - bits`` bits cleared."""
    return img & np.uint8(~(2 ** (8 - bits) - 1) & 255)


def solarize(img: np.ndarray, threshold: float = 128) -> np.ndarray:
    """``ImageOps.solarize``: values at or above ``threshold`` inverted."""
    return np.where(img < threshold, img, 255 - img).astype(np.uint8)


def invert(img: np.ndarray) -> np.ndarray:
    return 255 - img


def blend(degenerate: np.ndarray, img: np.ndarray, factor: float) -> np.ndarray:
    """``Image.blend(degenerate, img, factor)`` on uint8 images."""
    deg = degenerate.astype(np.float32)
    out = deg + np.float32(factor) * (img.astype(np.float32) - deg)
    return np.trunc(np.clip(out, 0.0, 255.0)).astype(np.uint8)


def grayscale(img: np.ndarray) -> np.ndarray:
    """RGB -> Pillow's "L": ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``."""
    rgb = img.astype(np.int64)
    return ((19595 * rgb[..., 0] + 38470 * rgb[..., 1] + 7471 * rgb[..., 2] + 0x8000)
            >> 16).astype(np.uint8)


def smooth(img: np.ndarray) -> np.ndarray:
    """``img.filter(ImageFilter.SMOOTH)``: the 3x3 kernel ``[[1, 1, 1],
    [1, 5, 1], [1, 1, 1]] / 13`` rounded to the nearest value inside; the
    edge rows and columns copied; an image under 3 px on a side copied
    whole. (Pillow sums in float32; the exact sum / 13 lies at least 1/26
    from a rounding edge, far past that error.)"""
    h, w = img.shape[:2]
    out = img.copy()
    if h < 3 or w < 3:
        return out
    src = img.astype(np.int32)
    acc = 4 * src[1:-1, 1:-1]
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            acc = acc + src[dy:h - 2 + dy, dx:w - 2 + dx]
    out[1:-1, 1:-1] = (2 * acc + 13) // 26
    return out


def brightness(img: np.ndarray, factor: float) -> np.ndarray:
    """``ImageEnhance.Brightness(img).enhance(factor)``: blended with black."""
    return blend(np.zeros_like(img), img, factor)


def color(img: np.ndarray, factor: float) -> np.ndarray:
    """``ImageEnhance.Color(img).enhance(factor)``: blended with its grey."""
    return blend(np.repeat(grayscale(img)[..., None], img.shape[-1], -1), img, factor)


def contrast(img: np.ndarray, factor: float) -> np.ndarray:
    """``ImageEnhance.Contrast(img).enhance(factor)``: blended with a flat
    image of its grey's mean, ``int(mean + 0.5)``."""
    grey = grayscale(img)
    mean = int(float(grey.sum(dtype=np.int64)) / grey.size + 0.5)
    return blend(np.full_like(img, mean), img, factor)


def sharpness(img: np.ndarray, factor: float) -> np.ndarray:
    """``ImageEnhance.Sharpness(img).enhance(factor)``: blended with its
    ``smooth``."""
    return blend(smooth(img), img, factor)
