"""The safetensors file format with the standard library (the port's
counterpart of ``safetensors.numpy.load_file``/``save_file``, which the JAX
package uses; the machine with the card may not have the package).

A file is an 8-byte little-endian header length, a JSON header mapping each
name to ``{"dtype", "shape", "data_offsets"}`` (offsets into the bytes that
follow it; an optional ``"__metadata__"`` entry of strings), then the raw
little-endian tensor bytes. This module reads and writes F32, F16, BF16 and
I64 (position ids) and refuses any other dtype.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct
from typing import Dict, Mapping, Union

import numpy as np
import torch

# safetensors dtype -> (torch dtype, little-endian numpy dtype of its bytes)
DTYPES = {
    "F32": (torch.float32, np.dtype("<f4")),
    "F16": (torch.float16, np.dtype("<f2")),
    "BF16": (torch.bfloat16, np.dtype("<u2")),
    "I64": (torch.int64, np.dtype("<i8")),
}
_BY_TORCH = {t: name for name, (t, _) in DTYPES.items()}
_BY_NUMPY = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16",
             np.dtype(np.int64): "I64"}


def _refuse(dtype, path: str):
    raise ValueError(f"{path}: safetensors dtype {dtype} is not read or written here "
                     f"(only {', '.join(DTYPES)})")


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, as CPU tensors in the file's
    dtype, in the header's order."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        (n,) = struct.unpack("<Q", mm[:8])
        header = json.loads(mm[8:8 + n])
        header.pop("__metadata__", None)
        base, size = 8 + n, len(mm) - 8 - n
        for name, info in header.items():
            if info["dtype"] not in DTYPES:
                _refuse(info["dtype"], path)
            tdtype, npdtype = DTYPES[info["dtype"]]
            shape = tuple(info["shape"])
            lo, hi = info["data_offsets"]
            count = math.prod(shape)
            if not 0 <= lo <= hi <= size or hi - lo != count * npdtype.itemsize:
                raise ValueError(f"{path}: {name}: data_offsets {lo, hi} do not hold "
                                 f"{info['dtype']} {list(shape)} in {size} bytes")
            arr = np.frombuffer(mm, npdtype, count, base + lo).copy().reshape(shape)
            t = torch.from_numpy(arr.astype(arr.dtype.newbyteorder("=")))
            out[name] = t.view(tdtype) if info["dtype"] == "BF16" else t
    return out


def _as_bytes(name: str, value: Union[torch.Tensor, np.ndarray], path: str):
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype not in _BY_TORCH:
            _refuse(t.dtype, path)
        dtype = _BY_TORCH[t.dtype]
        arr = (t.view(torch.int16) if dtype == "BF16" else t).numpy()
    else:
        arr = np.ascontiguousarray(value)
        if arr.dtype not in _BY_NUMPY:
            _refuse(arr.dtype, path)
        dtype = _BY_NUMPY[arr.dtype]
    arr = arr.astype(DTYPES[dtype][1], copy=False)
    return dtype, list(arr.shape), arr.tobytes()


def save_file(tensors: Mapping[str, Union[torch.Tensor, np.ndarray]], path: str) -> None:
    """Write ``tensors`` (torch tensors or numpy arrays) as a safetensors
    file. As the package does, the tensors are laid out by element size,
    largest first, then by name, and the header is padded with spaces to a
    multiple of 8 bytes, so every tensor starts aligned to its element."""
    entries = [(name, *_as_bytes(name, v, path)) for name, v in tensors.items()]
    entries.sort(key=lambda e: (-DTYPES[e[1]][1].itemsize, e[0]))
    header: Dict[str, object] = {}
    pos = 0
    for name, dtype, shape, data in entries:
        header[name] = {"dtype": dtype, "shape": shape, "data_offsets": [pos, pos + len(data)]}
        pos += len(data)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for _, _, _, data in entries:
            f.write(data)
