"""Image grids (port of ``distdiff_tpu/utils/visualize.py``). The grid is
written through the port's own PNG encoder (``parallel/driver.py``
``save_png``): the card's machine has no PIL."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def make_grid(images: np.ndarray, ncols: Optional[int] = None, pad: int = 2,
              pad_value: float = 1.0) -> np.ndarray:
    """[N, H, W, C] float images -> one [GH, GW, C] grid array."""
    n, h, w, c = images.shape
    ncols = ncols or int(math.ceil(math.sqrt(n)))
    nrows = int(math.ceil(n / ncols))
    grid = np.full((nrows * (h + pad) + pad, ncols * (w + pad) + pad, c), pad_value,
                   images.dtype)
    for i in range(n):
        r, col = divmod(i, ncols)
        y = pad + r * (h + pad)
        x = pad + col * (w + pad)
        grid[y:y + h, x:x + w] = images[i]
    return grid


def save_image_grid(path: str, images: np.ndarray, ncols: Optional[int] = None) -> None:
    """``images`` in [0, 1] (clipped) as one 8-bit PNG grid, rounded as the
    JAX package rounds (``x * 255 + 0.5``, truncated)."""
    from distdiff_tpu_torch.parallel.driver import save_png

    save_png(path, make_grid(np.clip(images, 0, 1), ncols))
