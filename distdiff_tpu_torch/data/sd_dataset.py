"""Generation-side dataset: images, cached VAE latents and text embeddings
(port of ``distdiff_tpu/data/sd_dataset.py``).

* Per-class text embeddings are computed once from the dataset's caption
  template (or, with ``language_enhance``, one per sentence of the
  per-class bank ``{data_root}/{dataset}_le.pkl``), plus the uncond ("")
  embedding. A conditioning value is a text-context array, or SDXL's
  ``{"ctx", "add"}`` dict of arrays, handled key by key
  (``sampling/conditioning.py``).
* The VAE latents of every train image are encoded in batches and cached at
  ``save/vae_embedding/{dataset}/{model}/image_latents.npy``: the JAX
  package's path and ``.npy`` format, so a cache written by either package
  is read by the other.
* Items carry (latent, cond, uncond, class name, path, target), which
  ``ExpansionDriver`` batches onto the device.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Callable, List, Optional, Sequence

import numpy as np

from distdiff_tpu_torch.data.datasets import load_image
from distdiff_tpu_torch.data.registry import load_dataset
from distdiff_tpu_torch.data.templates import template_for
from distdiff_tpu_torch.data.transforms import sd_transform
from distdiff_tpu_torch.sampling.conditioning import (
    cond_asarray,
    cond_index,
    cond_leading_dim,
    cond_stack,
)

VAE_EMBED_DIR = "save/vae_embedding"


@dataclasses.dataclass
class SDItem:
    latent: np.ndarray   # [h, w, 4] scaled VAE latent
    # [T, D] text embedding, or SDXL's {"ctx": [T, 2048], "add": [2816]}
    cond: object
    uncond: object       # the "" embedding, in the same form
    class_name: str
    image_path: str
    target: int


class SDDataset:
    def __init__(
        self,
        dataset: str,
        encode_text_fn: Callable[[Sequence[str]], np.ndarray],
        encode_images_fn: Callable[[np.ndarray], np.ndarray],
        model_name: str = "CompVis/stable-diffusion-v1-4",
        size: int = 512,
        center_crop: bool = False,
        language_enhance: bool = False,
        data_root: Optional[str] = None,
        cache_root: str = ".",
        encode_batch: int = 8,
    ):
        """``encode_text_fn``: prompts -> ``[N, T, D]`` (SDXL: ``{"ctx":
        [N, T, D], "add": [N, A]}``); ``encode_images_fn``:
        ``[b, size, size, 3]`` images in [-1, 1] -> scaled latents."""
        self.dataset_name = dataset
        self.size = size
        self.center_crop = center_crop
        self.rng = np.random.default_rng(0)
        self.loaded = load_dataset(dataset, data_root=data_root)
        self.class_names = self.loaded.classnames
        train = self.loaded.train
        self.image_paths = list(train.image_paths)
        self.labels = list(train.labels)
        self.transform = sd_transform(size, center_crop)

        self.language_enhance = language_enhance
        if language_enhance:
            # per-class sentence bank (reference dataloader.py:770-778)
            le_path = os.path.join(data_root or "./data", f"{dataset}_le.pkl")
            with open(le_path, "rb") as f:
                bank = pickle.load(f)
            bank = {k.replace("_", " "): v for k, v in bank.items()}
            self.class_embeds = [cond_asarray(encode_text_fn(list(bank[c])))
                                 for c in self.class_names]
        else:
            template = template_for(dataset)
            self.class_embeds = cond_asarray(
                encode_text_fn([template.format(c) for c in self.class_names]))
        self.uncond_embed = cond_index(cond_asarray(encode_text_fn([""])), 0)
        self.latents = self._load_or_encode_latents(encode_images_fn, model_name,
                                                    cache_root, encode_batch)

    # ------------------------------------------------------------------
    def cache_path(self, model_name: str, cache_root: str = ".") -> str:
        """The latent cache: the reference's name at 512 without centre crop,
        suffixed with the size (and ``_cc``) otherwise, so that another
        geometry never reads stale latents."""
        suffix = ("" if (self.size == 512 and not self.center_crop)
                  else f"_{self.size}" + ("_cc" if self.center_crop else ""))
        return os.path.join(cache_root, VAE_EMBED_DIR, self.dataset_name,
                            model_name.replace("/", "--"), f"image_latents{suffix}.npy")

    def _load_or_encode_latents(self, encode_images_fn, model_name, cache_root,
                                encode_batch) -> np.ndarray:
        path = self.cache_path(model_name, cache_root)
        if os.path.exists(path):
            latents = np.load(path)
            if len(latents) == len(self.image_paths):
                return latents
        os.makedirs(os.path.dirname(path), exist_ok=True)
        out = []
        n = len(self.image_paths)
        for i in range(0, n, encode_batch):
            chunk = self.image_paths[i:i + encode_batch]
            imgs = np.stack([self.transform(load_image(p), self.rng) for p in chunk])
            pad = encode_batch - len(chunk)
            if pad:  # one batch shape for every encoder call
                imgs = np.concatenate([imgs, np.repeat(imgs[-1:], pad, 0)])
            out.append(np.asarray(encode_images_fn(imgs))[:len(chunk)])
        latents = np.concatenate(out, 0).astype(np.float32)
        np.save(path, latents)
        return latents

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, idx: int) -> SDItem:
        target = self.labels[idx]
        if self.language_enhance:
            sents = self.class_embeds[target]
            cond = cond_index(sents, int(self.rng.integers(0, cond_leading_dim(sents))))
        else:
            cond = cond_index(self.class_embeds, target)
        return SDItem(latent=self.latents[idx], cond=cond, uncond=self.uncond_embed,
                      class_name=self.class_names[target],
                      image_path=self.image_paths[idx], target=int(target))


def collate_sd(items: List[SDItem]):
    """Stack SDItems into batch arrays (reference ``collate_fn``,
    ``generate_data.py:642-684``); conditioning key by key, as numpy."""
    return {
        "latents": np.stack([it.latent for it in items]),
        "cond": cond_asarray(cond_stack([it.cond for it in items])),
        "uncond": cond_asarray(cond_stack([it.uncond for it in items])),
        "targets": np.asarray([it.target for it in items], np.int32),
        "class_names": [it.class_name for it in items],
        "image_paths": [it.image_path for it in items],
    }
