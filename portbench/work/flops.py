"""FLOPs per image of a cell's recipe, counted once: the plain steps, the
rollout's forward and backward, the decodes and the guide, without the
recomputation of the program's ``rollout_remat`` mode.

They are counted by ``torch.utils.flop_counter.FlopCounterMode`` over the
reference modules on the meta device (no memory, no arithmetic), one piece
at a time for one image: a CFG step, a rollout step forward and backward
(its UNet step, decode, resize, guide and energy, differentiated to its
input), and the final decode. Counted are the matrix products and
convolutions, which are nearly all of the work; elementwise operations,
norms and softmax are not.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import models
from portbench.reference.expand import Expansion
from portbench.work.recipe import latent_side, steps


def per_image(cfg: dict, traffic: dict) -> float:
    mods = models.build(cfg, "meta")
    side = latent_side(cfg)
    lc = cfg["vae"]["latent_channels"]
    text = cfg["text"]
    dev = torch.device("meta")
    feat = mods["guide"].fc.in_features
    classes, k = traffic["classes"], traffic["guidance"]["K"]

    def z(*shape):
        return torch.zeros(shape, device=dev)

    def ctx():
        c = z(1, text["context_length"], text["context_width"])
        if "pooled_width" in text:
            return {"ctx": c, "add": z(1, cfg["unet"]["projection_class_embeddings_input_dim"])}
        return c

    exp = Expansion(cfg, traffic, mods["unet"], mods["vae"], mods["guide"],
                    z(classes, feat), z(classes, k, feat), remat=False)
    target = torch.zeros(1, dtype=torch.long, device=dev)
    x = z(1, side, side, lc)
    st = steps(traffic)

    def count(fn) -> float:
        with FlopCounterMode(display=False) as counter:
            fn()
        return float(counter.get_total_flops())

    def rollout():
        xx = x.clone().requires_grad_(True)
        with torch.enable_grad():
            _, e = exp.rollout_step(xx, exp.start, ctx(), ctx(), target)
            torch.autograd.grad(e.sum(), (xx,))

    total = st.plain * count(lambda: exp.eps(x, exp.start, ctx(), ctx()))
    total += count(lambda: exp.vae.decode(x))
    if st.period:
        total += st.period * count(rollout)
    return total
