"""Judging the timed path's output: the PNGs it wrote, read back, against
the plain fp32 reference's images of the same units, rounded to 8 bits as
a PNG holds them; in guided cells also the latents that the program's first
denoise span hands the guidance step (plan index g0), against the
reference's latents there.

The reference runs after the window, once the program's state is freed: its
fp32 weights are remade from the seed (the same values the program was
served, widened), and it expands each sampled unit alone. TF32 is off, so
its products are fp32.
"""

from __future__ import annotations

import contextlib
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench.harness.weights import make_state, served_dtype, sub_seed
from portbench.reference import lowp, models
from portbench.reference.expand import Expansion, to_levels

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def read_png(path: str) -> np.ndarray:
    """An 8-bit RGB or RGBA, non-interlaced PNG as ``[H, W, C]`` uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, color, _, _, interlace = header
    channels = {2: 3, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: depth {depth}, color type {color}, interlace {interlace}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * channels)
    out = np.zeros((h, w * channels), np.int32)
    prev = np.zeros(w * channels, np.int32)
    for y in range(h):
        kind, row = raw[y, 0], raw[y, 1:].astype(np.int32)
        if kind == 0:
            cur = row
        elif kind == 2:
            cur = (row + prev) & 255
        else:  # 1 Sub, 3 Average, 4 Paeth need the pixel to the left
            cur = np.zeros_like(row)
            for x in range(w * channels):
                a = cur[x - channels] if x >= channels else 0
                b = prev[x]
                c = prev[x - channels] if x >= channels else 0
                if kind == 1:
                    p = a
                elif kind == 3:
                    p = (a + b) // 2
                else:
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    p = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (row[x] + p) & 255
        out[y], prev = cur, cur
    return out.reshape(h, w, channels).astype(np.uint8)


def gaps(written: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    """How far one written image lies from the reference's, in 8-bit
    levels: the root mean square, the mean and the largest absolute gap, and
    the share (%) of values more than 8 levels off."""
    d = np.abs(written[..., :3].astype(np.float64) - ref.astype(np.float64))
    return {"rms_levels": float(np.sqrt(np.mean(d * d))),
            "mean_abs_levels": float(np.mean(d)),
            "max_abs_levels": float(np.max(d)),
            "over8_pct": float(100.0 * np.mean(d > 8))}


def latent_gaps(program: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    """How far one unit's latents at g0 lie from the reference's: the root
    mean square of the gap, over that of the reference's latents (%), and
    the share (%) of values more than 0.05 off. The guidance step that
    follows amplifies any rounding, so these see the denoise loop's
    precision before it does."""
    d = np.abs(program.astype(np.float64) - ref.astype(np.float64))
    return {"lat_rms_pct": float(100.0 * np.sqrt(np.mean(d * d) / np.mean(
                ref.astype(np.float64) ** 2))),
            "lat_over0.05_pct": float(100.0 * np.mean(d > 0.05))}


def slot_plan(batches: int, batch: int, seed: int) -> List[Tuple[int, int]]:
    """The (batch, slot) pairs judged: one unit at each slot of the batch,
    each from a window batch drawn from the seed, so that a fault confined
    to some slots of every batch is always seen."""
    rng = np.random.default_rng(sub_seed(seed, "sample"))
    return [(int(rng.integers(batches)), s) for s in range(batch)]


def reference_states(cfg: dict, seed: int, device, mods) -> Dict[str, Dict[str, torch.Tensor]]:
    """The seeded weights in their served type, widened to fp32."""
    out = {}
    for part, m in mods.items():
        st = make_state(m, sub_seed(seed, part), served_dtype(cfg, part), device)
        out[part] = {k: v.float() if v.is_floating_point() else v for k, v in st.items()}
        del st
    return out


def reference_images(cfg: dict, traffic: dict, seed: int, inputs, units, device,
                     fp8: bool = False, g0_latents: Optional[list] = None) -> List[np.ndarray]:
    """The reference's 8-bit images of ``units``, one unit at a time; with
    ``fp8``, those of the low-precision control (``reference/lowp.py``).
    In a guided cell, ``g0_latents`` receives each unit's latents at g0
    ([h, w, c] fp32)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        mods = models.build(cfg, "meta")
        for part, sd in reference_states(cfg, seed, device, mods).items():
            mods[part].load_state_dict(sd, strict=True, assign=True)
            mods[part].requires_grad_(False).eval()
        exp = Expansion(cfg, traffic, mods["unet"], mods["vae"], mods["guide"],
                        inputs.global_protos.float(), inputs.local_protos.float())
        rounding = lowp.fp8_products(mods.values()) if fp8 else contextlib.nullcontext()
        out = []

        def put(a):
            return torch.as_tensor(np.asarray(a), device=device)[None].float()

        def cond_put(c):
            return {k: put(v) for k, v in c.items()} if isinstance(c, dict) else put(c)

        with torch.no_grad(), rounding:
            for u in units:
                target = inputs.labels[u.dataset_index]
                noise, gamma0, beta0 = inputs.unit_draws(
                    [u.dataset_index * inputs.per_prompt + u.image_i])
                at_g0 = [] if g0_latents is not None else None
                img = exp.images(put(inputs.latents[u.dataset_index]),
                                 cond_put(inputs.cond_of(target)), cond_put(inputs.uncond),
                                 torch.tensor([target], device=device), noise.float(),
                                 gamma0.float(), beta0.float(), at_g0=at_g0)
                out.append(to_levels(img)[0])
                if at_g0:
                    g0_latents.append(at_g0[0][0].cpu().numpy())
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{number: {"value", "limit"}} of the numbers that have a limit."""
    return {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}

