"""Closed-loop accuracy protocol: expansion -> downstream training -> delta.

The port of ``scripts/quality_loop.py``, the reference's evaluation harness
run as ONE command: expand a small dataset with guided diffusion, train a
downstream classifier over N seeds on original⊕expanded, and report
mean±std accuracy against the baselines (the reference's
``scripts/exps/train_expand.sh:9-31`` loops seeds 1..3 over
``train_expanded_data_concat_original.py``; its ``parse_logs.py:21-66``
aggregates):

  1. guided expansion   (generate_data --guidance_type transform_guidance)
  2. unguided expansion (generate_data --guidance_type none)
  3. downstream training, N seeds x {original-only, ⊕unguided, ⊕guided}
  4. parse_logs aggregation -> a mean±std comparison table

Default mode fabricates a toy dataset (PNGs written with the standard
library) and runs the tiny pipeline config; ``--train_vae`` and
``--train_unet`` first pre-train the tiny VAE (reconstruction) and the tiny
UNet (denoising) on it, ``--train_guide`` the guide encoder. Every stage is
the port's own CLI called in-process (``cli.generate_data``, ``cli.train``,
``cli.train_expanded``, ``cli.parse_logs``), with the JAX script's argv.

It runs on the card; ``DISTDIFF_PLATFORM=cpu`` runs it on the CPU:

  python -m distdiff_tpu_torch.cli.quality_loop --workdir OUT --seeds 1 2 \\
      --epochs 2 --train_guide --train_vae --vae_steps 50 \\
      --train_unet --unet_steps 50

With real SD weights and a real dataset root it is the reference
measurement itself:

  python -m distdiff_tpu_torch.cli.quality_loop \\
      --dataset caltech-101 --data_root ./data --no-tiny \\
      --sd_checkpoint /path/to/stable-diffusion-v1-4 \\
      --arch resnet50 --epochs 100 --train_batch 64 --lr 0.1 \\
      --num_images_per_prompt 5 --seeds 1 2 3
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os

import numpy as np
import torch

from distdiff_tpu_torch.cli.common import cli_device
from distdiff_tpu_torch.cli.generate_data import build_pipeline
from distdiff_tpu_torch.cli.generate_data import parse_args as gparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset", default="breastmnist")
    p.add_argument("--data_root", default=None,
                   help="existing dataset root; default fabricates a toy "
                        "class-dir tree under --workdir")
    p.add_argument("--workdir", default="quality_loop_out")
    p.add_argument("--arch", default="tiny_resnet")
    p.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--train_batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--input_size", type=int, default=16)
    p.add_argument("--num_images_per_prompt", type=int, default=1)
    p.add_argument("--resolution", type=int, default=32)
    p.add_argument("--sd_checkpoint", default=None)
    p.add_argument("--no-tiny", dest="tiny", action="store_false",
                   help="real pipeline geometry (needs --sd_checkpoint)")
    p.add_argument("--guidance_step", type=int, default=4)
    p.add_argument("--guidance_period", type=int, default=2)
    p.add_argument("--K", type=int, default=2)
    p.add_argument("--strength", type=float, default=0.5,
                   help="img2img noising strength for the expansions")
    p.add_argument("--guidance_scale", type=float, default=7.5,
                   help="CFG scale for the expansions")
    p.add_argument("--steps", type=int, default=None,
                   help="DDIM steps for the expansions (more steps keep "
                        "the guidance window inside the executed span at "
                        "low --strength)")
    # the same protocol under the alternative generation modes, so that a
    # mode's speed can be paired with its downstream accuracy
    p.add_argument("--scheduler", default="ddim",
                   choices=["ddim", "dpmpp"],
                   help="sampling solver for BOTH expansion arms")
    p.add_argument("--deep_cache", action="store_true",
                   help="DeepCache on both expansion arms")
    p.add_argument("--int8", action="store_true",
                   help="int8 w8a8 denoise spans on both expansion arms")
    p.add_argument("--guided_mode", default="transform_guidance",
                   choices=["transform_guidance", "direct_guidance"],
                   help="guidance type for the guided arm")
    # fabricated-dataset scale (ignored when --data_root is given)
    p.add_argument("--n_classes", type=int, default=2)
    p.add_argument("--n_train", type=int, default=6)
    p.add_argument("--n_test", type=int, default=4)
    p.add_argument("--toy_size", type=int, default=20)
    p.add_argument("--toy_noise", type=float, default=45.0,
                   help="per-pixel noise sigma in the fabricated data")
    p.add_argument("--toy_jitter", type=float, default=0.0,
                   help="per-IMAGE class-color jitter sigma; raise toward "
                        "the inter-class color distance to pull baseline "
                        "accuracy off 100%% (class distributions overlap, "
                        "so extra in-distribution data genuinely helps)")
    # reference protocol step 1 ("obtain guide model"): train the guide
    # encoder on the ORIGINAL data first and feed its checkpoint to the
    # expansion, instead of guiding with random features
    p.add_argument("--train_guide", action="store_true")
    p.add_argument("--guide_epochs", type=int, default=None,
                   help="epochs for the guide-encoder pre-training "
                        "(default: same as --epochs)")
    # the tiny config's random VAE destroys its input (decode(encode(x))
    # is far from x); this stage trains it on reconstruction, so that the
    # tiny loop runs in the regime of the real pipeline's trained VAE
    p.add_argument("--train_vae", action="store_true")
    p.add_argument("--vae_steps", type=int, default=800)
    # the tiny config's random UNet moves latents away from the data; this
    # stage trains it with the eps-prediction MSE (SD's objective) on the
    # VAE latents of the original images, conditioned on the per-class
    # prompt embeddings the expansion uses, with 10% uncond dropout for CFG
    p.add_argument("--train_unet", action="store_true")
    p.add_argument("--unet_steps", type=int, default=2000)
    return p.parse_args(argv)


@contextlib.contextmanager
def data_seed_kept():
    """Leave the per-item data seed (``data/datasets.py`` ``_DATA_SEED``,
    which each CLI's ``set_seed`` sets) as it was before the block."""
    from distdiff_tpu_torch.data import datasets

    kept = list(datasets._DATA_SEED)
    try:
        yield
    finally:
        datasets._DATA_SEED[:] = kept


def fabricate_toy_dataset(root: str, n_classes: int = 2, n_train: int = 6,
                          n_test: int = 4, size: int = 20,
                          noise: float = 45.0, jitter: float = 0.0):
    """Class-per-dir medmnist-style tree with learnable color structure.

    Each class gets a fixed random mean-color signature; every IMAGE draws
    its own color at class mean + N(0, jitter) (so with jitter on the order
    of the inter-class distance the class-conditional distributions overlap
    and the tiny train split undersamples them — the regime where dataset
    expansion can genuinely move test accuracy), then per-pixel noise on
    top. With jitter=0 a class-positioned bright stripe keeps the
    trivially separable smoke behavior. The draws are the JAX script's.
    """
    from distdiff_tpu_torch.data.datasets import write_png

    classes = [f"class_{i:02d}" for i in range(n_classes)]
    base = os.path.join(root, "medmnist", "breastmnist")
    crng = np.random.RandomState(1234)
    colors = crng.randint(40, 200, (n_classes, 3))
    for ci, cat in enumerate(classes):
        for split, n in (("train", n_train), ("test", n_test)):
            rng = np.random.RandomState(7919 * ci + (0 if split == "train" else 1))
            for k in range(n):
                img_color = colors[ci] + rng.normal(0.0, jitter, 3)
                arr = rng.normal(img_color, noise, (size, size, 3))
                if jitter == 0.0:
                    row = (ci * size) // max(n_classes, 1)
                    arr[row, :, :] += 40.0  # class-positioned bright stripe
                arr = np.clip(arr, 0, 255).astype(np.uint8)
                write_png(os.path.join(base, split, cat, f"{split}_{k}.png"), arr)
    return root


def run_expansion(args, guidance_type: str, out_dir: str,
                  encoder_weight_path=None, params_path=None):
    from distdiff_tpu_torch.cli import generate_data as cli_gen

    argv = [
        "-d", args.dataset, "--data_root", args.data_root,
        "--guidance_type", guidance_type,
        "--guidance_step", str(args.guidance_step),
        "--guidance_period", str(args.guidance_period), "--K", str(args.K),
        "--num_images_per_prompt", str(args.num_images_per_prompt),
        "--train_batch_size", "1",
        # the calibrated recipes were measured at constraint 0.2: pin it,
        # since the CLI's default is the reference's 0.8
        "--constraint_value", "0.2",
        "--strength", str(args.strength),
        "--guidance_scale", str(args.guidance_scale),
        "--output_dir", out_dir, "--seed", "0",
        "--resolution", str(args.resolution),
    ]
    if args.steps is not None:
        argv += ["--steps", str(args.steps)]
    if args.scheduler != "ddim":
        argv += ["--scheduler", args.scheduler]
    if args.deep_cache:
        argv += ["--deep_cache"]
    if args.int8:
        argv += ["--int8"]
    if args.tiny:
        argv += ["--tiny"]
    if args.sd_checkpoint:
        argv += ["--sd_checkpoint", args.sd_checkpoint]
    if encoder_weight_path:
        argv += ["--encoder_weight_path", encoder_weight_path]
    if params_path:
        argv += ["--params_path", params_path]
    with data_seed_kept():
        stats = cli_gen.main(argv)
    print(f"[quality_loop] expansion ({guidance_type}): "
          f"{stats['written']} images -> {out_dir}", flush=True)
    return stats


def _reused(out_path: str, what: str) -> bool:
    if os.path.isdir(out_path) and os.listdir(out_path):
        print(f"[quality_loop] reuse pretrained {what} params {out_path}", flush=True)
        return True
    return False


def _tiny_pipeline(args, params_path=None):
    """The pipeline ``cli.generate_data`` builds under ``--tiny
    --resolution R --seed 0`` (and ``--params_path``), on ``cli_device()``."""
    gargv = ["-d", args.dataset, "--output_dir", "unused", "--tiny",
             "--resolution", str(args.resolution), "--seed", "0"]
    if params_path:
        gargv += ["--params_path", params_path]
    return build_pipeline(gparse(gargv))


def _images(files, size: int, device) -> torch.Tensor:
    """The PNGs as the JAX script reads them: RGB, Pillow's bicubic resize
    to ``size``^2, then ``/ 127.5 - 1`` in fp32; NHWC on ``device``."""
    from distdiff_tpu_torch.data.datasets import load_image
    from distdiff_tpu_torch.data.transforms import resize_bicubic

    imgs = np.stack([
        np.asarray(resize_bicubic(load_image(f), (size, size)), np.float32) / 127.5 - 1.0
        for f in files
    ])
    return torch.as_tensor(imgs, device=device)


def make_adam(module: torch.nn.Module) -> torch.optim.Adam:
    """``optax.adam(2e-3)``: torch's defaults (b1 0.9, b2 0.999, eps 1e-8
    added to the bias-corrected sqrt(v)) are optax's with its eps_root 0."""
    module.requires_grad_(True)
    return torch.optim.Adam(module.parameters(), lr=2e-3)


def vae_loss(vae, x: torch.Tensor, scaling_factor: float):
    """(loss, mse, rms): pixel MSE + a tiny KL (keeps the posterior sane) + a
    term pulling the SCALED latent's RMS (what the img2img path noises)
    toward 1, on the posterior mean."""
    mean, logvar = vae.encode_moments(x)
    recon = vae.decode(mean)
    mse = torch.mean((recon - x) ** 2)
    kl = torch.mean(0.5 * (mean ** 2 + torch.exp(logvar) - 1.0 - logvar))
    rms = torch.sqrt(torch.mean((mean * scaling_factor) ** 2) + 1e-8)
    return mse + 1e-4 * kl + 0.05 * (rms - 1.0) ** 2, mse, rms


def vae_train_step(vae, optimizer: torch.optim.Optimizer, x: torch.Tensor,
                   scaling_factor: float):
    """One full-batch Adam step of the VAE on ``vae_loss``; returns (loss,
    mse, rms) before the update, as detached tensors."""
    with torch.enable_grad():
        loss, mse, rms = vae_loss(vae, x, scaling_factor)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
    optimizer.step()
    return loss.detach(), mse.detach(), rms.detach()


def pretrain_tiny_vae(args, out_path: str) -> str:
    """Train the tiny pipeline's VAE to reconstruct the original images and
    save the pipeline's parameters (``weights/params_io.py``) for
    ``--params_path``. ``--vae_steps 0`` saves them untouched; a non-empty
    ``out_path`` is reused."""
    from distdiff_tpu_torch.weights.params_io import save_params

    if _reused(out_path, "VAE"):
        return out_path
    pipe = _tiny_pipeline(args)
    size = pipe.config.sample_size
    files = sorted(glob.glob(os.path.join(
        args.data_root, "medmnist", args.dataset, "train", "*", "*.png")))
    assert files, args.data_root
    x = _images(files, size, pipe.device)
    sf = pipe.config.vae.scaling_factor
    opt = make_adam(pipe.vae)
    mse = rms = float("nan")  # --vae_steps 0: save the tree untouched
    for _ in range(args.vae_steps):
        _, mse, rms = vae_train_step(pipe.vae, opt, x, sf)
    pipe.vae.requires_grad_(False)
    print(f"[quality_loop] tiny VAE pretrained: recon mse {float(mse):.4f}, "
          f"scaled-latent rms {float(rms):.2f} ({args.vae_steps} steps)",
          flush=True)
    save_params(out_path, pipe, "sd15")
    return out_path


def draw_unet_inputs(generator: torch.Generator, latent_shape, n_train: int):
    """One step's draws: timesteps uniform over ``[0, n_train)``, standard
    normal noise of the latents' shape, and the 10% uncond drop mask."""
    from distdiff_tpu_torch.train.lora import draw_t_noise

    t, noise = draw_t_noise(generator, latent_shape[0], latent_shape[1:], n_train)
    drop = torch.rand(latent_shape[0], generator=generator, device=generator.device) < 0.1
    return t, noise, drop


def unet_loss(unet, sched, latents, labels, ctx_bank, t, noise, drop):
    """The denoising MSE (the eps target, or v under ``v_prediction``) at
    the given draws, each sample conditioned on its class prompt or, where
    ``drop``, on the uncond prompt (``ctx_bank[-1]``)."""
    from distdiff_tpu_torch.train.lora import denoising_loss

    cls_ctx = ctx_bank[labels]
    unc_ctx = ctx_bank[-1][None].expand_as(cls_ctx)
    ctx = torch.where(drop[:, None, None], unc_ctx, cls_ctx)
    return denoising_loss(unet, sched, latents, ctx, t, noise)


def unet_train_step(unet, optimizer: torch.optim.Optimizer, sched, latents, labels,
                    ctx_bank, t, noise, drop) -> torch.Tensor:
    """One full-batch Adam step of the UNet on ``unet_loss`` at the given
    draws; returns the loss before the update, detached."""
    with torch.enable_grad():
        loss = unet_loss(unet, sched, latents, labels, ctx_bank, t, noise, drop)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
    optimizer.step()
    return loss.detach()


def pretrain_tiny_unet(args, in_params_path, out_path: str) -> str:
    """Denoising pre-training for the tiny UNet (the objective behind the
    reference's SD checkpoint): eps-prediction MSE over uniformly sampled
    timesteps on the VAE latents of the original train images, conditioned
    on the per-class prompt embeddings (``data/templates.py``) with 10%
    uncond dropout so the CFG pair at generation time is meaningful. Starts
    from ``in_params_path`` (the --train_vae output) when given, so the
    latents being denoised are the ones generation will actually traverse.
    The draws come from one ``torch.Generator`` seeded 0."""
    from distdiff_tpu_torch.data.templates import template_for
    from distdiff_tpu_torch.models import load_tokenizer
    from distdiff_tpu_torch.weights.params_io import save_params

    if _reused(out_path, "UNet"):
        return out_path
    pipe = _tiny_pipeline(args, in_params_path)
    size = pipe.config.sample_size
    sf = pipe.config.vae.scaling_factor
    dev = pipe.device

    train_root = os.path.join(args.data_root, "medmnist", args.dataset, "train")
    classes = sorted(
        d for d in os.listdir(train_root)
        if os.path.isdir(os.path.join(train_root, d)))
    files, labels = [], []
    for ci, cat in enumerate(classes):
        fs = sorted(glob.glob(os.path.join(train_root, cat, "*.png")))
        files += fs
        labels += [ci] * len(fs)
    assert files, train_root
    x = _images(files, size, dev)
    y = torch.as_tensor(labels, dtype=torch.int64, device=dev)

    with torch.no_grad():  # latents as the img2img path sees them: mean * sf
        latents = pipe.vae.encode_moments(x)[0] * sf
    # per-class ctx through the template, tokenizer and text encoder the
    # expansion uses; index -1 is uncond ("")
    template = template_for(args.dataset)
    tok = load_tokenizer(
        max_length=pipe.config.text_encoder.max_length,
        vocab_size=pipe.config.text_encoder.vocab_size, strict=False)
    prompts = [template.format(c) for c in classes] + [""]
    ctx_bank = pipe.encode_text(torch.as_tensor(tok(prompts), device=dev).long())

    n_train = len(pipe.sched.alphas_cumprod)
    opt = make_adam(pipe.unet)
    gen = torch.Generator(device=dev).manual_seed(0)
    loss = float("nan")  # --unet_steps 0: save the tree untouched
    for _ in range(args.unet_steps):
        t, noise, drop = draw_unet_inputs(gen, latents.shape, n_train)
        loss = unet_train_step(pipe.unet, opt, pipe.sched, latents, y, ctx_bank, t, noise,
                               drop)
    pipe.unet.requires_grad_(False)
    print(f"[quality_loop] tiny UNet pretrained: denoise loss "
          f"{float(loss):.4f} ({args.unet_steps} steps, {len(files)} images, "
          f"{len(classes)} classes)", flush=True)
    save_params(out_path, pipe, "sd15")
    return out_path


def train_guide_encoder(args, ckpt_root: str) -> str:
    """Reference protocol step 1: train the guide encoder on the original
    data and return its best checkpoint for ``--encoder_weight_path``.
    Prototypes then come from TRAINED features instead of random init,
    which is what makes the energy class-aware."""
    from distdiff_tpu_torch.cli import train as cli_train

    ckpt = os.path.join(ckpt_root, "guide_encoder")
    best = os.path.join(ckpt, "model_best.pth.tar")
    if not os.path.exists(os.path.join(ckpt, "results.yaml")):
        with data_seed_kept():
            cli_train.main([
                "-d", args.dataset, "--data_root", args.data_root,
                "-a", args.arch,
                "--epochs", str(args.guide_epochs or args.epochs),
                "--train-batch", str(args.train_batch),
                "--test-batch", str(args.train_batch),
                "--input_size", str(args.input_size), "--lr", str(args.lr),
                "--manualSeed", "0", "--checkpoint", ckpt,
            ])
    print(f"[quality_loop] guide encoder trained -> {best}", flush=True)
    return best


def run_training(args, variant: str, expanded_dir, ckpt_root: str):
    """One variant x all seeds through the downstream trainer CLIs."""
    from distdiff_tpu_torch.cli import train as cli_train
    from distdiff_tpu_torch.cli import train_expanded as cli_train_expanded

    for seed in args.seeds:
        ckpt = os.path.join(ckpt_root, variant, f"seed{seed}")
        if os.path.exists(os.path.join(ckpt, "results.yaml")):
            print(f"[quality_loop] skip existing {ckpt}", flush=True)
            continue
        argv = [
            "-d", args.dataset, "--data_root", args.data_root,
            "-a", args.arch, "--epochs", str(args.epochs),
            "--train-batch", str(args.train_batch),
            "--test-batch", str(args.train_batch),
            "--input_size", str(args.input_size), "--lr", str(args.lr),
            "--manualSeed", str(seed), "--checkpoint", ckpt,
        ]
        with data_seed_kept():
            if expanded_dir is None:
                cli_train.main(argv)
            else:
                cli_train_expanded.main(argv + ["--data_expanded_dir", expanded_dir])


def aggregate(ckpt_root: str, variants):
    from distdiff_tpu_torch.cli.parse_logs import collect

    table = {}
    for v in variants:
        perfs = collect(os.path.join(ckpt_root, v), multi=True)
        table[v] = {
            "n": len(perfs),
            "mean": float(np.mean(perfs)) if perfs else None,
            "std": float(np.std(perfs)) if perfs else None,
        }
    return table


def main(argv=None):
    args = parse_args(argv)
    if not args.tiny and (args.train_vae or args.train_unet):
        raise SystemExit(
            "--train_vae/--train_unet pre-train the TINY pipeline geometry "
            "and would silently shadow --sd_checkpoint via --params_path; "
            "with --no-tiny the checkpoint is already a trained "
            "denoiser — drop these flags.")
    cli_device()  # the card, or DISTDIFF_PLATFORM=cpu; raises before anything is written
    os.makedirs(args.workdir, exist_ok=True)
    if args.data_root is None:
        args.data_root = fabricate_toy_dataset(
            os.path.join(args.workdir, "data"), n_classes=args.n_classes,
            n_train=args.n_train, n_test=args.n_test, size=args.toy_size,
            noise=args.toy_noise, jitter=args.toy_jitter)

    ckpt_root = os.path.join(args.workdir, "checkpoint")
    encoder_path = (
        train_guide_encoder(args, ckpt_root) if args.train_guide else None)
    params_path = (
        pretrain_tiny_vae(args, os.path.join(args.workdir, "sd_params"))
        if args.train_vae else None)
    if args.train_unet:
        params_path = pretrain_tiny_unet(
            args, params_path, os.path.join(args.workdir, "sd_params_unet"))

    guided_dir = os.path.join(args.workdir, "expanded_guided")
    unguided_dir = os.path.join(args.workdir, "expanded_unguided")
    run_expansion(args, args.guided_mode, guided_dir,
                  encoder_weight_path=encoder_path, params_path=params_path)
    run_expansion(args, "none", unguided_dir,
                  encoder_weight_path=encoder_path, params_path=params_path)
    run_training(args, "original", None, ckpt_root)
    run_training(args, "unguided", unguided_dir, ckpt_root)
    run_training(args, "guided", guided_dir, ckpt_root)

    table = aggregate(ckpt_root, ["original", "unguided", "guided"])
    print("\n=== quality loop: downstream accuracy (mean ± std over "
          f"{len(args.seeds)} seeds) ===")
    for v, row in table.items():
        if row["mean"] is None:
            print(f"{v:<10s}  (no results)")
        else:
            print(f"{v:<10s}  {row['mean']:6.2f} ± {row['std']:.2f}  "
                  f"(n={row['n']})")
    g, u, o = table["guided"], table["unguided"], table["original"]
    if g["mean"] is not None and u["mean"] is not None:
        print(f"delta guided-vs-unguided: {g['mean'] - u['mean']:+.2f}")
    if g["mean"] is not None and o["mean"] is not None:
        print(f"delta guided-vs-original: {g['mean'] - o['mean']:+.2f}")
    with open(os.path.join(args.workdir, "quality_loop.json"), "w") as f:
        json.dump(table, f, indent=2)
    return table


if __name__ == "__main__":
    main()
