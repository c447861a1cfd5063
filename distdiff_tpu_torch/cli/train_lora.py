"""LoRA fine-tuning CLI for the diffusion UNet (port of
``distdiff_tpu/cli/train_lora.py``): adapt the generative prior to the
target dataset before expansion,

    python -m distdiff_tpu_torch.cli.train_lora \\
        --dataset cifar100-s --output_dir ./lora_runs/c100 \\
        --sd_checkpoint /path/to/stable-diffusion-v1-5 \\
        --rank 8 --steps 2000 --batch 8

then expand with the adapter merged in:

    python -m distdiff_tpu_torch.cli.generate_data ... \\
        --lora ./lora_runs/c100/lora.npz

The JAX CLI's flags and defaults. It reuses ``generate_data``'s
``build_pipeline`` (guidance off; weights from ``--sd_checkpoint``), its
tokenizer and the ``SDDataset`` VAE-latent and text caches: batches come
from the latent cache. The step is ``train/lora.py``'s, with ``torch.optim.AdamW``
(optax's ``adamw``). The batch draws follow the JAX CLI's numpy order
(``default_rng(seed)``: the batch's indices, then under ``-le`` one
sentence a label); the timesteps, the noise and the adapter's init come
from ``torch.Generator``s seeded from ``--seed`` where JAX uses
``PRNGKey(seed + 1)`` and ``PRNGKey(seed)``. The adapter file is the JAX
package's ``.npz``, so either package's ``generate_data --lora`` takes it.

It runs on the card; ``DISTDIFF_PLATFORM=cpu`` runs it on the CPU (with
``--tiny``, the toy config). ``--params_path`` (the JAX package's orbax
tree) raises ``NotImplementedError`` naming ROADMAP queue 1 item 8.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from distdiff_tpu_torch.cli.common import cli_device, set_seed, setup_logging
from distdiff_tpu_torch.train.lora import (
    draw_t_noise,
    init_lora,
    make_lora_train_step,
    make_optimizer,
    save_lora,
)

log = logging.getLogger("distdiff.train_lora")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--model", type=str, default="sd15",
                   choices=["sd15", "sd21", "sdxl"])
    p.add_argument("--pretrained_model_name_or_path", type=str,
                   default="CompVis/stable-diffusion-v1-4",
                   help="cache naming only (as in generate_data)")
    p.add_argument("--sd_checkpoint", type=str, default=None)
    p.add_argument("--params_path", type=str, default=None)
    p.add_argument("--bpe_path", type=str, default=None)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--language_enhance", "-le", action="store_true")
    p.add_argument("--tiny", action="store_true",
                   help="tiny pipeline config (tests/smoke)")
    # LoRA hyperparameters
    p.add_argument("--rank", type=int, default=8)
    p.add_argument("--alpha", type=float, default=None,
                   help="LoRA scale; default = rank (delta at full strength)")
    p.add_argument("--targets", type=str, default="to_q-to_k-to_v-to_out",
                   help="'-'-separated Dense-module name prefixes to adapt")
    # optimization
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--save_every", type=int, default=0,
                   help="also checkpoint every N steps (0 = final only)")
    return p.parse_args(argv)


def _pipeline_args(args):
    """The namespace ``generate_data.build_pipeline`` reads (guidance
    off)."""
    return argparse.Namespace(
        model=args.model, tiny=args.tiny, resolution=args.resolution,
        steps=50, scheduler="ddim", deep_cache=False, cache_interval=3, cache_branch=0,
        params_path=args.params_path, sd_checkpoint=args.sd_checkpoint,
        guidance_type="none", guidance_step=20, guidance_period=2,
        guidance_step_in_plan=False, rho=10.0, constraint_value=0.2, gs=1.0, ls=1.0, K=1,
        optimize_targets="global-local", guidance_scale=7.5,
        do_classifier_free_guidance=True, strength=0.5, offset_noise=False,
        text_to_img=False, seed=args.seed, lora=None, lora_alpha=None, int8=False,
        save_params=None, mesh_model=1, arch="resnet50",
    )


def main(argv=None):
    args = parse_args(argv)
    setup_logging()
    device = cli_device()
    set_seed(args.seed)

    from distdiff_tpu_torch.cli.generate_data import build_pipeline, check_ported
    from distdiff_tpu_torch.data import SDDataset
    from distdiff_tpu_torch.models import load_tokenizer
    from distdiff_tpu_torch.sampling.conditioning import (
        cond_asarray,
        cond_index,
        cond_leading_dim,
        cond_stack,
    )

    pargs = _pipeline_args(args)
    check_ported(pargs)  # before any file is written
    os.makedirs(args.output_dir, exist_ok=True)
    pipe = build_pipeline(pargs, device)
    tokenizer = load_tokenizer(
        args.bpe_path, max_length=pipe.config.text_encoder.max_length,
        vocab_size=pipe.config.text_encoder.vocab_size, checkpoint_dir=args.sd_checkpoint,
        strict=bool(args.sd_checkpoint) and not args.tiny)

    if pipe.is_sdxl:
        def encode_text_fn(prompts):
            ids = torch.as_tensor(tokenizer(list(prompts)), device=device).long()
            return cond_asarray(pipe.encode_text_pair(ids, ids))
    else:
        def encode_text_fn(prompts):
            ids = torch.as_tensor(tokenizer(list(prompts)), device=device).long()
            return pipe.encode_text(ids).float().cpu().numpy()

    def encode_images_fn(images):
        return pipe.encode_images(torch.as_tensor(images, device=device)).float().cpu().numpy()

    sd = SDDataset(args.dataset, encode_text_fn=encode_text_fn,
                   encode_images_fn=encode_images_fn,
                   model_name=args.pretrained_model_name_or_path,
                   size=pipe.config.sample_size, language_enhance=args.language_enhance,
                   data_root=args.data_root, seed=args.seed, model=args.model)
    latents = np.asarray(sd.latents, np.float32)
    labels = np.asarray(sd.labels, np.int64)
    log.info("dataset %s: %d images, latent grid %s", args.dataset, len(sd), latents.shape[1:])

    alpha = float(args.alpha if args.alpha is not None else args.rank)
    targets = tuple(args.targets.split("-"))
    unet = pipe.unet
    lora = init_lora(torch.Generator().manual_seed(args.seed), unet, rank=args.rank,
                     targets=targets)
    log.info("LoRA rank %d over %d leaves (%s), alpha=%g", args.rank, len(lora),
             ",".join(targets), alpha)
    opt = make_optimizer(lora, lr=args.lr, weight_decay=args.weight_decay)
    step_fn = make_lora_train_step(unet, pipe.sched, opt, alpha=alpha)
    n_train = len(pipe.sched.alphas_cumprod)

    rng = np.random.default_rng(args.seed)
    tgen = torch.Generator().manual_seed(args.seed + 1)
    t0 = time.time()
    running = []
    for step in range(1, args.steps + 1):
        idx = rng.integers(0, len(sd), size=args.batch)
        batch_lat = torch.as_tensor(latents[idx], device=device)
        if sd.language_enhance:
            conds = []
            for lab in labels[idx]:
                bank = sd.class_embeds[int(lab)]
                conds.append(cond_index(bank, int(rng.integers(0, cond_leading_dim(bank)))))
            ctx = cond_stack(conds)
        else:
            ctx = cond_index(sd.class_embeds, labels[idx])
        ctx = ({k: torch.as_tensor(v, device=device) for k, v in ctx.items()}
               if isinstance(ctx, dict) else torch.as_tensor(ctx, device=device))
        t, noise = draw_t_noise(tgen, args.batch, batch_lat.shape[1:], n_train)
        loss = step_fn(lora, batch_lat, ctx, t.to(device), noise.to(device))
        running.append(float(loss))
        if step % args.log_every == 0 or step == args.steps:
            log.info("step %d/%d  loss %.4f  (%.2f steps/s)", step, args.steps,
                     float(np.mean(running[-args.log_every:])), step / (time.time() - t0))
        if args.save_every and step % args.save_every == 0:
            save_lora(os.path.join(args.output_dir, f"lora_{step:06d}.npz"), lora, alpha=alpha)

    out = os.path.join(args.output_dir, "lora.npz")
    save_lora(out, lora, alpha=alpha)
    log.info("saved %s (final loss %.4f, %.1fs)", out, float(np.mean(running[-10:])),
             time.time() - t0)
    print(f"lora saved: {out}")
    return out


if __name__ == "__main__":
    main()
