"""Dataset primitives (port of ``distdiff_tpu/data/datasets.py``):
``load_image``, the per-item augmentation seed, ``ImageListDataset``,
``ArrayDataset``, the expanded-tree reader ``DatasetByClassNames``, the
``ConcatDataset``, ``RepeatDataset`` and ``SubsetDataset`` combinators,
``BatchLoader``, and the PNG codec (``read_png``, ``write_png``).

Images are ``[H, W, 3]`` uint8 numpy arrays. The machine with the card has
neither PIL nor torchvision, so ``load_image`` decodes PNG with the standard
library (``zlib``, ``struct``): 8-bit, non-interlaced, grey, grey+alpha,
RGB, RGBA and palette images, every scanline filter, converted to RGB as
PIL's ``convert("RGB")`` does. Anything else raises and names the routes
for such datasets: build the latent and prototype caches on a host that
has PIL (generation), or train from a PNG copy of the tree made there.
"""

from __future__ import annotations

import os
import re
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import numpy as np

# Global data-augmentation seed (set from the seed flag through
# cli.common.set_seed). The per-item RNG is derived from (seed, epoch,
# index), so one seed reproduces one augmentation stream.
_DATA_SEED = [0]


def set_data_seed(seed: int) -> None:
    _DATA_SEED[0] = int(seed)


def _item_rng(seed: Optional[int], epoch: int, idx: int) -> np.random.Generator:
    s = _DATA_SEED[0] if seed is None else seed
    return np.random.default_rng((s, epoch, idx))


# ------------------------------------------------------------- PNG decoder

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (8-bit)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
CACHE_ROUTE = (
    "the port decodes 8-bit non-interlaced PNG only (the machine with the card "
    "has no PIL). For other images, build the latent cache (save/vae_embedding/"
    "{dataset}/{model}/image_latents*.npy) and the prototype cache (save/prototypes/"
    "{arch}/{dataset}/class_wise_prototype_K*.npz) on a host that has PIL, with "
    "either package (both write the same files), and run from the directory that "
    "holds save/. To train on such a dataset, train from a PNG copy of its tree made "
    "on a host that has PIL: Image.open(p).convert(\"RGB\").save(q) for each image p "
    "of {data_root}/{dataset}, q the same path under a new root ending in .png "
    "(ImageOps.exif_transpose before convert where a file carries an EXIF "
    "orientation); a copy so made has exactly the pixels the JAX package's "
    "load_image sees")


# One wavefront decode at a time: its numpy calls are many and small, and
# each one over 500 elements lets go of the GIL, so decodes on several
# loader threads hand the GIL from core to core at every call and run
# slower together than one after another (scripts/torch_png_decode.py).
_WAVEFRONT_LOCK = threading.Lock()


def _unfilter_wavefront(rows: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the filters of an image with Average (3) or Paeth (4) rows.
    Those predict a pixel from its decoded left neighbour, so a row cannot
    be undone at once; but pixel (y, x) needs only (y, x - 1), (y - 1, x)
    and (y - 1, x - 1), so every pixel of one anti-diagonal t = y + x is
    undone together, each by its own row's filter. The diagonals are kept
    as the rows of ``dec`` (``dec[t + 2, y + 1]`` is pixel (y, t - y); a
    zero row y = -1 and zero diagonals before each row's start give the
    predictors' zeros at the edges)."""
    w = stride // bpp
    n = h + w - 1
    ys = np.arange(h)[:, None]
    ts = ys + np.arange(w)[None]
    raw = np.zeros((n, h, bpp), np.int16)
    raw[ts, ys] = rows[:, 1:].reshape(h, w, bpp)
    dec = np.zeros((n + 2, h + 1, bpp), np.int16)
    ftype = rows[:, :1]
    is_sub, is_up, is_avg, is_paeth = (ftype == k for k in (1, 2, 3, 4))
    for t in range(n):
        lo, hi = max(0, t - w + 1), min(h, t + 1)  # the rows that diagonal t crosses
        a, b, c = dec[t + 1, lo + 1:hi + 1], dec[t + 1, lo:hi], dec[t, lo:hi]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = (a * is_sub[lo:hi] + b * is_up[lo:hi] + ((a + b) >> 1) * is_avg[lo:hi]
                + paeth * is_paeth[lo:hi])
        dec[t + 2, lo + 1:hi + 1] = (raw[t, lo:hi] + pred) & 255
    return dec[ts + 2, ys + 1].astype(np.uint8).reshape(h, stride)


def _unfilter(data: bytes, h: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """Undo the five PNG scanline filters: ``[h, stride]`` uint8. Without
    Average or Paeth rows each row is undone at once; with them, by
    anti-diagonals (``_unfilter_wavefront``)."""
    if len(data) < h * (stride + 1):
        raise ValueError(f"{path}: image data is {len(data)} bytes, "
                               f"{h} rows need {h * (stride + 1)}")
    rows = np.frombuffer(data, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    bad = np.flatnonzero(rows[:, 0] > 4)
    if len(bad):
        raise ValueError(f"{path}: scanline {bad[0]} has filter type {rows[bad[0], 0]}")
    if (rows[:, 0] >= 3).any():
        with _WAVEFRONT_LOCK:
            return _unfilter_wavefront(rows, h, stride, bpp)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, raw = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = raw
        elif ftype == 1:  # Sub: a running sum (mod 256) along each channel
            cur = np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        else:  # Up
            cur = raw + prev
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit, non-interlaced PNG: ``[H, W, C]`` uint8 in its own
    samples (grey 1, grey+alpha 2, RGB 3, RGBA 4; a palette image is looked
    up into RGB)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG: {CACHE_ROUTE}")
    pos, idat, header, palette = 8, [], None, None
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {tag!r}")
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        elif tag == b"eXIf":
            raise ValueError(f"{path}: EXIF orientation is not applied here: "
                                   f"{CACHE_ROUTE}")
        elif tag[:1].isupper():  # a critical chunk this decoder does not know
            raise ValueError(f"{path}: critical chunk {tag!r}: {CACHE_ROUTE}")
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, compression, filtering, interlace = header
    if (depth != 8 or color not in _CHANNELS or compression or filtering or interlace
            or (color == 3 and palette is None)):
        raise ValueError(
            f"{path}: bit depth {depth}, colour type {color}, interlace {interlace}: "
            f"{CACHE_ROUTE}")
    c = _CHANNELS[color]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c, path).reshape(h, w, c)
    if color == 3:
        # indices past the palette read black
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        return table[pixels[:, :, 0]]
    return pixels


_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, arr: np.ndarray, level: int = 6) -> None:
    """``[H, W]`` or ``[H, W, C]`` uint8 (C = 1, 3 or 4) -> an 8-bit,
    non-interlaced PNG at ``path``, every row with filter 0, compressed at
    zlib ``level``; ``read_png`` gives the same array back."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    if c not in _COLOR_TYPES:
        raise ValueError(f"write_png takes 1, 3 or 4 channels, got {c}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    data = (PNG_SIGNATURE + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _png_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def load_image(path: str) -> np.ndarray:
    """An image file as ``[H, W, 3]`` uint8 RGB, as PIL's
    ``convert("RGB")`` gives it: grey is repeated over the three channels,
    alpha is dropped."""
    px = read_png(path)
    c = px.shape[2]
    if c in (1, 2):
        return np.repeat(px[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])


# ------------------------------------------------------------- datasets

class ImageListDataset:
    """Images given by explicit (path, label) lists."""

    def __init__(self, image_paths: Sequence[str], labels: Sequence[int],
                 transform: Optional[Callable] = None, seed: Optional[int] = None):
        if len(image_paths) != len(labels):
            raise ValueError(f"{len(image_paths)} paths for {len(labels)} labels")
        self.image_paths = list(image_paths)
        self.labels = list(labels)
        self.transform = transform
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, idx: int):
        img = load_image(self.image_paths[idx])
        if self.transform is not None:
            img = self.transform(img, _item_rng(self.seed, self.epoch, idx))
        return img, self.labels[idx]


class ArrayDataset:
    """In-memory ``(N, H, W[, C])`` uint8 images and labels."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 transform: Optional[Callable] = None, seed: Optional[int] = None):
        self.images = images
        self.labels = np.asarray(labels).reshape(-1)
        self.transform = transform
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int):
        arr = self.images[idx]
        if arr.ndim == 2:
            arr = np.repeat(arr[:, :, None], 3, axis=2)
        if self.transform is not None:
            arr = self.transform(arr, _item_rng(self.seed, self.epoch, idx))
        return arr, int(self.labels[idx])


_EXPAND_RE = re.compile(r"_expand_(\d+)\.(png|jpg|jpeg)$", re.IGNORECASE)
_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


class DatasetByClassNames(ImageListDataset):
    """Reader for the generated-expansion tree ``{root}/{classname}/*.png``
    (reference ``train_expanded_data_concat_original.py:91-117``). A class
    without a directory contributes nothing. ``expand_num`` keeps only the
    images whose ``_expand_{i}`` index is below it (reference
    ``train_transform.py:158-169``); None keeps every image."""

    def __init__(self, root: str, class_names: Sequence[str],
                 transform: Optional[Callable] = None, expand_num: Optional[int] = None):
        paths: List[str] = []
        labels: List[int] = []
        for ci, name in enumerate(class_names):
            cdir = os.path.join(root, name)
            if not os.path.isdir(cdir):
                continue
            for fname in sorted(os.listdir(cdir)):
                if not fname.lower().endswith(_IMG_EXTS):
                    continue
                if expand_num is not None:
                    m = _EXPAND_RE.search(fname)
                    if m is not None and int(m.group(1)) >= expand_num:
                        continue
                paths.append(os.path.join(cdir, fname))
                labels.append(ci)
        super().__init__(paths, labels, transform)


class ConcatDataset:
    """original ⊕ expanded (reference
    ``train_expanded_data_concat_original.py:153-156``). An item keeps its
    index within its own dataset, and so its augmentation draws."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def set_epoch(self, epoch: int) -> None:
        for d in self.datasets:
            if hasattr(d, "set_epoch"):
                d.set_epoch(epoch)

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, idx: int):
        di = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        return self.datasets[di][idx - int(self._offsets[di])]


class RepeatDataset:
    """N× replication (the no-expansion control arm, reference
    ``train_transform.py:245``)."""

    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = times

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.dataset) * self.times

    def __getitem__(self, idx: int):
        return self.dataset[idx % len(self.dataset)]


class SubsetDataset:
    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx: int):
        return self.dataset[self.indices[idx]]


class BatchLoader:
    """Threaded prefetching batch iterator -> (images ``[B, ...]``, labels
    ``[B]``, mask ``[B]``). With ``shuffle`` each epoch's order is
    ``np.random.default_rng(seed + epoch)``'s permutation, as in the JAX
    package. With ``drop_last=False`` the final short batch is padded to
    the full batch size by repeating its last item, and ``mask`` marks the
    real rows; ``collate(items, batch_size)`` replaces that assembly. Items
    load on the pool; batches are put together on the caller's thread."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False, num_threads: int = 4,
                 collate: Optional[Callable] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_threads = num_threads
        self.collate = collate
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        return idx

    def _assemble(self, items):
        if self.collate is not None:
            return self.collate(items, self.batch_size)
        imgs = np.stack([np.asarray(it[0], np.float32) for it in items])
        labels = np.asarray([it[1] for it in items], np.int32)
        mask = np.ones(len(items), bool)
        pad = self.batch_size - len(items)
        if pad > 0:  # pad the ragged tail
            imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, 0)])
            labels = np.concatenate([labels, np.repeat(labels[-1:], pad)])
            mask = np.concatenate([mask, np.zeros(pad, bool)])
        return imgs, labels, mask

    def __iter__(self):
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)
        idx = self._indices()
        bs = self.batch_size
        ex = ThreadPoolExecutor(max_workers=self.num_threads)
        try:
            # the items of up to three batches load on the pool while the
            # caller uses the current one
            pending = []
            for bi in range(len(self)):
                pending.append([ex.submit(self.dataset.__getitem__, int(i))
                                for i in idx[bi * bs:(bi + 1) * bs]])
                if len(pending) > 2:
                    yield self._assemble([f.result() for f in pending.pop(0)])
            for batch in pending:
                yield self._assemble([f.result() for f in batch])
        finally:
            ex.shutdown(wait=False, cancel_futures=True)
        self.epoch += 1
