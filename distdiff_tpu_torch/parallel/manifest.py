"""Work manifest for expansion: the resume and sharding bookkeeping (port of
``distdiff_tpu/parallel/manifest.py``; pure Python, the port's own copy).

The pending work units are every (dataset index, image_i) pair whose output
PNG does not exist yet, restricted to one ``split`` of ``total_split``
contiguous ranges (several GPUs run one process each, one split apiece).
The driver takes them in batch-sized chunks, the last one padded.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Sequence, Tuple


def output_path(output_dir: str, class_name: str, image_path: str, image_i: int) -> str:
    """``{out}/{class}/{stem}_expand_{i}.png``."""
    stem = os.path.basename(image_path).split(".")[0]
    return os.path.join(output_dir, class_name, f"{stem}_expand_{image_i}.png")


@dataclasses.dataclass(frozen=True)
class WorkUnit:
    dataset_index: int
    image_i: int
    out_path: str


def split_range(n: int, split: int, total_split: int) -> Tuple[int, int]:
    """The contiguous range of items of one split."""
    per = n // total_split
    start = split * per
    end = n if split == total_split - 1 else (split + 1) * per
    return start, end


def build_manifest(image_paths: Sequence[str], class_names: Sequence[str], output_dir: str,
                   num_images_per_prompt: int, first_image_index: int = 0, split: int = 0,
                   total_split: int = 1, skip_existing: bool = True) -> List[WorkUnit]:
    """``class_names`` is per item. Units whose PNG exists are skipped."""
    lo, hi = split_range(len(image_paths), split, total_split)
    units: List[WorkUnit] = []
    for di in range(lo, hi):
        for image_i in range(first_image_index, num_images_per_prompt):
            out = output_path(output_dir, class_names[di], image_paths[di], image_i)
            if skip_existing and os.path.exists(out):
                continue
            units.append(WorkUnit(di, image_i, out))
    return units


def chunk_units(units: Sequence[WorkUnit], global_batch: int
                ) -> List[Tuple[List[WorkUnit], List[bool]]]:
    """Fixed-size batches; the tail repeats its last unit with mask False."""
    out = []
    for i in range(0, len(units), global_batch):
        chunk = list(units[i: i + global_batch])
        mask = [True] * len(chunk)
        while len(chunk) < global_batch:
            chunk.append(chunk[-1])
            mask.append(False)
        out.append((chunk, mask))
    return out
