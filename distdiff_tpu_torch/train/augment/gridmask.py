"""GridMask occlusion (port of ``distdiff_tpu/train/augment/gridmask.py``;
reference ``augmentations/grid.py``): a grid-patterned zero mask with
rotation, its application probability ramped over epochs, applied to
whole batches on the host."""

from __future__ import annotations

import numpy as np

from distdiff_tpu_torch.data.transforms import NEAREST, rotate


class GridMask:
    def __init__(self, d1: int = 24, d2: int = 33, rotate: int = 1,
                 ratio: float = 0.4, prob: float = 0.8):
        self.d1, self.d2 = d1, d2
        self.rotate = rotate
        self.ratio = ratio
        self.max_prob = prob
        self.prob = prob

    def set_prob(self, epoch: int, max_epoch: int) -> None:
        """Linear ramp to max prob over the schedule (grid.py:25-27)."""
        self.prob = self.max_prob * min(1.0, epoch / max(max_epoch, 1))

    def _one_mask(self, h: int, w: int, rng: np.random.Generator) -> np.ndarray:
        hh = int(1.5 * max(h, w))
        d = int(rng.integers(self.d1, self.d2))
        keep = int(np.ceil(d * self.ratio))
        mask = np.ones((hh, hh), np.float32)
        st = int(rng.integers(0, d))
        for i in range(hh // d + 1):
            s = d * i + st
            mask[s : s + d - keep, :] = 0.0
        st = int(rng.integers(0, d))
        for i in range(hh // d + 1):
            s = d * i + st
            mask[:, s : s + d - keep] = 0.0
        if self.rotate:
            # Image.fromarray(L).rotate(angle): Pillow's default NEAREST
            angle = int(rng.integers(0, self.rotate + 1))
            mask = rotate((mask * 255).astype(np.uint8), angle, NEAREST).astype(
                np.float32) / 255.0
        off_h = (hh - h) // 2
        off_w = (hh - w) // 2
        return mask[off_h : off_h + h, off_w : off_w + w]

    def __call__(self, images: np.ndarray, rng=None) -> np.ndarray:
        """images: [B, H, W, C]; each image masked independently with
        probability ``self.prob``."""
        rng = rng or np.random.default_rng()
        out = images.copy()
        b, h, w, _ = images.shape
        for i in range(b):
            if rng.random() < self.prob:
                out[i] *= self._one_mask(h, w, rng)[:, :, None]
        return out
