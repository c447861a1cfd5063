"""Expansion driver on one device: manifest -> batches -> PNGs (port of
``distdiff_tpu/parallel/driver.py``; the mesh and its sharding wait for the
multi-GPU slice).

One ``torch.Generator`` per work unit, seeded from (seed, dataset index,
image_i), makes a unit's draws, so its image does not depend on the batch
it is in. One batch stays in flight: the images of batch i are copied to
pinned host memory behind the device's work, and are written as PNGs on a
thread pool while the host issues batch i + 1.

The PNG writer needs only the standard library (``zlib``, ``struct``): the
machine with the card has no PIL.
"""

from __future__ import annotations

import collections
import logging
import os
import struct
import time
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from distdiff_tpu_torch.device import resolve_device
from distdiff_tpu_torch.parallel.manifest import WorkUnit, build_manifest, chunk_units
from distdiff_tpu_torch.sampling.conditioning import cond_stack

log = logging.getLogger("distdiff.driver")

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def save_png(path: str, image01: np.ndarray) -> None:
    """image01: ``[H, W, 3]`` float in [0, 1] -> an 8-bit PNG, rounded as
    the reference rounds (``clip(x * 255 + 0.5, 0, 255)`` then truncation to
    uint8). zlib level 1: the writer threads share the host's CPU."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.clip(np.asarray(image01) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    if c not in _COLOR_TYPES:
        raise ValueError(f"save_png takes 1, 3 or 4 channels, got {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    data = (_PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def read_png(path: str) -> np.ndarray:
    """Read back what ``save_png`` writes: an 8-bit, non-interlaced PNG whose
    scanlines all use filter 0. ``[H, W, C]`` uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos: pos + 4])
        tag, body = data[pos + 4: pos + 8], data[pos + 8: pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
    w, h, depth, color, _, _, interlace = header
    channels = {v: k for k, v in _COLOR_TYPES.items()}.get(color)
    if depth != 8 or interlace or channels is None:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey/RGB/RGBA PNGs are read")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * channels)
    if rows[:, 0].any():
        raise ValueError(f"{path}: only filter 0 scanlines are read")
    return rows[:, 1:].reshape(h, w, channels)


def unit_seed(seed: int, unit: WorkUnit) -> int:
    """The seed of a work unit's generator, from (seed, dataset index,
    image_i)."""
    return int(np.random.SeedSequence([seed, unit.dataset_index, unit.image_i])
               .generate_state(1)[0])


class ExpansionDriver:
    """Runs the expansion over a manifest of (image, image_i) work units.

    ``expand_fn(latents, cond, uncond, targets, generators) -> images01``
    is the pipeline's hot path (``ExpansionPipeline.make_split_expand()``),
    ``generators`` one per sample. ``sd_dataset`` has ``image_paths``,
    ``class_names``, ``labels`` and items with ``latent``, ``cond``,
    ``uncond`` and ``target``.
    """

    def __init__(self, expand_fn: Callable, sd_dataset, output_dir: str,
                 batch_size: int = 1, seed: int = 0, writer_threads: int = 4,
                 device: Union[str, torch.device, None] = None):
        self._expand = expand_fn
        self.sd = sd_dataset
        self.output_dir = output_dir
        self.global_batch = batch_size
        self.seed = seed
        self.device = resolve_device("cuda" if device is None else device)
        self.n_devices = 1
        self._writers = ThreadPoolExecutor(max_workers=writer_threads)

    def close(self) -> None:
        self._writers.shutdown(wait=True)

    def generators(self, units: Sequence[WorkUnit]) -> List[torch.Generator]:
        return [torch.Generator(device=self.device).manual_seed(unit_seed(self.seed, u))
                for u in units]

    def _batch(self, units: Sequence[WorkUnit]):
        items = [self.sd[u.dataset_index] for u in units]
        dev = self.device
        latents = torch.stack([torch.as_tensor(it.latent) for it in items]).to(dev)
        cond = cond_stack([it.cond for it in items]).to(dev)
        uncond = cond_stack([it.uncond for it in items]).to(dev)
        targets = torch.as_tensor([int(it.target) for it in items], device=dev)
        return latents, cond, uncond, targets, self.generators(units)

    def run(self, num_images_per_prompt: int, first_image_index: int = 0, split: int = 0,
            total_split: int = 1, skip_existing: bool = True, max_units: Optional[int] = None,
            progress: Optional[Callable[[int, int], None]] = None) -> dict:
        class_per_item = [self.sd.class_names[lab] for lab in self.sd.labels]
        units = build_manifest(self.sd.image_paths, class_per_item, self.output_dir,
                               num_images_per_prompt, first_image_index, split, total_split,
                               skip_existing)
        if max_units is not None:
            units = units[:max_units]
        chunks = chunk_units(units, self.global_batch)
        log.info("expansion manifest: %d pending units in %d batches of %d",
                 len(units), len(chunks), self.global_batch)
        t0 = time.time()
        written = 0
        pending = []
        # (time, images written) after each drained batch: the first entry
        # absorbs the warm-up, the slope over the rest is the steady rate
        drain_marks: List = []
        inflight = collections.deque()

        def drain():
            nonlocal written
            chunk_, mask_, host, done = inflight.popleft()
            if done is not None:
                done.synchronize()  # this batch's copy only
            for u, m, img in zip(chunk_, mask_, host.numpy()):
                if m:
                    pending.append(self._writers.submit(save_png, u.out_path, img))
                    written += 1
            drain_marks.append((time.time(), written))

        for bi, (chunk, mask) in enumerate(chunks):
            images = self._expand(*self._batch(chunk)).float()
            if images.is_cuda:
                host = torch.empty(images.shape, dtype=images.dtype, pin_memory=True)
                host.copy_(images, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                host, done = images, None
            inflight.append((chunk, mask, host, done))
            if len(inflight) >= 2:
                drain()
            if progress is not None:
                progress(bi + 1, len(chunks))
        while inflight:
            drain()
        for f in pending:
            f.result()
        dt = time.time() - t0
        stats = {"units": len(units), "written": written, "seconds": dt,
                 "images_per_sec": written / dt if dt > 0 else 0.0,
                 "images_per_sec_per_device": written / dt / self.n_devices if dt > 0 else 0.0}
        if len(drain_marks) >= 2:
            (t_a, w_a), (t_b, w_b) = drain_marks[0], drain_marks[-1]
            if t_b > t_a and w_b > w_a:
                stats["images_per_sec_steady"] = (w_b - w_a) / (t_b - t_a)
                stats["images_per_sec_steady_per_device"] = (
                    stats["images_per_sec_steady"] / self.n_devices)
        log.info("expansion done: %s", stats)
        return stats
