"""Guided dataset expansion CLI (port of ``distdiff_tpu/cli/generate_data.py``):
the reference's ``generate_data.py`` role with its full flag vocabulary and
defaults, vestigial DreamBooth flags accepted as logged no-ops.

Pipeline: the SD-1.5 (or with ``--model sd21`` SD-2.1 768-v, with
``--model sdxl`` SDXL-base) pipeline with weights from a diffusers-layout
directory (``--sd_checkpoint``; seeded
random weights with a loud warning otherwise), sampled by DDIM or
``--scheduler dpmpp`` (DPM-Solver++(2M)), optionally with ``--deep_cache``
-> ``SDDataset`` with its text-embedding and VAE-latent caches -> the guide
(``--encoder_weight_path``) and its cached prototypes -> ``ExpansionDriver``
writing ``{output_dir}/{classname}/{stem}_expand_{i}.png``. The guide is any
of the JAX package's archs (``-a``; the default ``open_clip_vit_b32``, whose
OpenCLIP checkpoint also brings the text tower that encodes the zero-shot
head from the dataset's template and class names, tokenised with
``--bpe_path``).

It runs on the card; ``DISTDIFF_PLATFORM=cpu`` runs it on the CPU (with
``--tiny``, the toy config; with ``--tiny --model sd21`` the toy config in
v-prediction, with ``--tiny --model sdxl`` ``PipelineConfig.sdxl_tiny``).
SDXL's conditioning is the ``{"ctx", "add"}`` dict of ``encode_text_pair``,
both towers fed the same tokenization. ``--lora FILE`` (``cli.train_lora``'s
adapter, or the JAX package's: the same ``.npz``) is merged into the UNet
after the checkpoint load and the bf16 cast. ``--int8`` runs the UNet of
the plain denoise spans on the int8 w8a8 route (``ops/quant.py``;
approximate, with or without ``--deep_cache``). ``--save_params DIR``
writes the pipeline's parameters after the load, the cast and the merge;
``--params_path`` reads such a directory, or a flat ``.npz`` of the JAX
package's tree, in place of ``--sd_checkpoint`` (``weights/params_io.py``).
The expansion runs on a mesh of the process's devices
(``parallel.mesh.make_expand_mesh``): the batch splits over its ``data``
axis, and ``--mesh_model N`` > 1 makes it ``data x model``, each model
group of N devices holding one UNet whose transformer blocks are
tensor-parallel (``parallel/tp.py``); N must divide the device count. One
card is a one-device mesh.

Usage (the reference recipe, ``scripts/exps/expand_diff.sh``):
  python -m distdiff_tpu_torch.cli.generate_data -d caltech-101 -a resnet50 \
      --sd_checkpoint DIR --encoder_weight_path checkpoint/.../model_best.pth.tar \
      --guidance_type transform_guidance --strength 0.5 --K 3 --rho 10.0 \
      --guidance_step 20 --guidance_period 2 --constraint_value 0.2 \
      --num_images_per_prompt 5 --output_dir data/caltech-101_expansion/...
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os

import numpy as np
import torch

from distdiff_tpu_torch.cli.common import (
    add_dataset_args,
    cli_device,
    set_seed,
    setup_logging,
)

log = logging.getLogger("distdiff.generate")


def _str2bool(v: str) -> bool:
    s = str(v).strip().lower()
    if s in ("true", "1", "yes", "y", "on"):
        return True
    if s in ("false", "0", "no", "n", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected true/false, got {v!r}")


def build_parser():
    p = argparse.ArgumentParser(description="DistDiff-style guided expansion")
    add_dataset_args(p)
    p.add_argument("--pretrained_model_name_or_path", type=str,
                   default="CompVis/stable-diffusion-v1-4",
                   help="checkpoint id used for cache paths; pass a local "
                        "diffusers dir via --sd_checkpoint for real weights")
    p.add_argument("--sd_checkpoint", type=str, default=None,
                   help="local diffusers-format SD checkpoint dir to convert")
    p.add_argument("--model", type=str, default="sd15",
                   choices=["sd15", "sd21", "sdxl"],
                   help="diffusion backbone: sd15 (reference recipe), sd21 "
                        "(SD-2.1 768-v: OpenCLIP-H text tower, v-prediction; "
                        "pass --resolution 768), sdxl (SDXL-base: dual text "
                        "towers, additive conditioning; pass --resolution "
                        "1024)")
    p.add_argument("--params_path", type=str, default=None,
                   help="parameters written by --save_params (or a flat .npz "
                        "of the JAX package's tree); takes precedence over "
                        "--sd_checkpoint")
    p.add_argument("--arch", "-a", type=str, default="open_clip_vit_b32")
    p.add_argument("--encoder_weight_path", type=str, default=None)
    p.add_argument("--guidance_type", type=str, default=None,
                   choices=["transform_guidance", "direct_guidance", "none"],
                   help="default: unguided expansion, as in the reference "
                        "(its default None takes neither guidance branch, "
                        "generate_data.py:1203-1210)")
    p.add_argument("--constraint_value", type=float, default=0.8)
    p.add_argument("--steps", type=int, default=None,
                   help="DDIM steps (the reference parses but hardcodes 50, "
                        "generate_data.py:217,1043 — here the flag is live; "
                        "default: the model config's plan, 50 / tiny 10)")
    p.add_argument("--scheduler", type=str, default="ddim",
                   choices=["ddim", "dpmpp"],
                   help="sampling solver: ddim (the reference's) or dpmpp "
                        "(DPM-Solver++(2M))")
    p.add_argument("--deep_cache", action="store_true",
                   help="DeepCache-style deep-feature caching in the plain "
                        "denoise spans (approximate, opt-in; ddim only)")
    p.add_argument("--cache_interval", type=int, default=3,
                   help="full UNet step every N steps under --deep_cache")
    p.add_argument("--cache_branch", type=int, default=0,
                   help="down level the cache cuts below (0 = shallowest "
                        "= fastest)")
    p.add_argument("--int8", action="store_true",
                   help="w8a8 int8 UNet denoise spans (ops/quant.py; "
                        "approximate, opt-in; the guidance steps and the VAE "
                        "stay exact)")
    p.add_argument("--K", type=int, default=3)
    p.add_argument("--guidance_step", type=int, default=1)
    p.add_argument("--guidance_period", type=int, default=1)
    p.add_argument("--guidance_step_in_plan", action="store_true",
                   help="beyond-reference: shift a guidance window that "
                        "falls before the img2img start into the executed "
                        "span (short --steps plans stay guided) instead of "
                        "the reference's silent unguided clamp")
    p.add_argument("--total_split", type=int, default=1,
                   help="deliberate default divergence: the reference "
                        "defaults to 8 because its launcher fans one process "
                        "per GPU; the default here is all the work in one "
                        "process (run one process per GPU with --split)")
    p.add_argument("--split", type=int, default=0)
    p.add_argument("--mesh_model", type=int, default=1,
                   help="tensor-parallel group size: each UNet's transformer "
                        "blocks shard over this many devices (data x model "
                        "mesh, parallel/tp.py); must divide the device count")
    p.add_argument("--num_images_per_prompt", type=int, default=4)
    p.add_argument("--first_image_index", type=int, default=0)
    p.add_argument("--optimize_targets", type=str, default=None,
                   help="'-'-separated subset of global_prototype,"
                        "local_prototype; default: both when guided (the "
                        "reference's None default crashes its guided path "
                        "— we fall back instead)")
    p.add_argument("--rho", type=float, default=10.0)
    p.add_argument("--gs", type=float, default=1.0)
    p.add_argument("--ls", type=float, default=1.0)
    p.add_argument("--strength", type=float, default=0.9,
                   help="img2img noising strength (reference default 0.9; "
                        "the published recipe passes 0.5)")
    p.add_argument("--language_enhance", "-le", action="store_true")
    p.add_argument("--text_to_img", action="store_true")
    p.add_argument("--offset_noise", action="store_true",
                   help="add 0.1x per-channel offset to the img2img noise "
                        "(generate_data.py:1164-1168)")
    p.add_argument("--output_dir", type=str, default="data_expand")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--train_batch_size", type=int, default=2,
                   help="batch size")
    p.add_argument("--guidance_scale", type=float, default=7.5)
    # The reference declares this flag `type=bool` (generate_data.py:452-457)
    # so `--do_classifier_free_guidance False` is TRUTHY there — a footgun,
    # not a contract. We deviate deliberately: accept true/false strings and
    # parse them properly (documented in PARITY.md).
    p.add_argument("--do_classifier_free_guidance", type=_str2bool,
                   nargs="?", const=True, default=True,
                   help="true/false (default true); bare flag means true")
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--bpe_path", type=str, default=None,
                   help="CLIP BPE merges file for real tokenization")
    p.add_argument("--tiny", action="store_true",
                   help="toy config (with DISTDIFF_PLATFORM=cpu it runs on "
                        "the CPU)")
    p.add_argument("--max_units", type=int, default=None,
                   help="cap pending work units (smoke runs)")
    p.add_argument("--fused_program", action="store_true",
                   help="run make_expand_fn (one function for the whole "
                        "trajectory) instead of SplitExpand")
    p.add_argument("--lora", type=str, default=None,
                   help="LoRA adapter .npz (cli.train_lora output) merged "
                        "into the UNet weights before sampling")
    p.add_argument("--lora_alpha", type=float, default=None,
                   help="override the alpha stored in the --lora file")
    p.add_argument("--save_params", type=str, default=None,
                   help="write the pipeline's parameters (after the checkpoint "
                        "load and the --lora merge) to this directory, for "
                        "--params_path")
    # --- vestigial reference flags: accepted for drop-in compatibility so
    # published commands (e.g. the reference's expand_diff.sh passes
    # --gradient_checkpointing) run unchanged; each is a no-op here.
    # main() logs a notice when one is set.
    compat = p.add_argument_group(
        "reference compatibility (accepted and ignored)")
    compat.add_argument("--gradient_checkpointing", action="store_true",
                        help="no-op: each guidance rollout step is "
                             "always checkpointed")
    compat.add_argument("--enable_xformers_memory_efficient_attention",
                        action="store_true",
                        help="no-op: the flash-attention kernels are "
                             "always on")
    compat.add_argument("--mixed_precision", type=str, default=None,
                        choices=["no", "fp16", "bf16"],
                        help="no-op: bf16 activations / fp32 statistics "
                             "are the fixed policy")
    compat.add_argument("--allow_tf32", action="store_true",
                        help="no-op: the fp32 guide runs with TF32 off")
    compat.add_argument("--local_rank", type=int, default=-1,
                        help="no-op: one process drives one card")
    compat.add_argument("--report_to", type=str, default=None,
                        help="no-op: the reference's tracker logged an "
                             "empty dict")
    compat.add_argument("--gradient_accumulation_steps", type=int, default=1,
                        help="no-op in generation (as in the reference)")
    compat.add_argument("--dataloader_num_workers", type=int, default=0,
                        help="no-op: the driver writes PNGs on its own "
                             "threads")
    # The remaining dead DreamBooth-trainer flags (the reference parses them
    # at generate_data.py:164-639 but its generation path never reads them).
    # Hidden from --help to keep it readable; the group description above
    # plus docs/migration.md document the policy.
    for name in _DEAD_STORE_TRUE:
        compat.add_argument("--" + name, action="store_true",
                            help=argparse.SUPPRESS)
    for name, typ in _DEAD_VALUE:
        compat.add_argument("--" + name, type=typ, default=None,
                            help=argparse.SUPPRESS)
    compat.add_argument("--validation_images", nargs="+", default=None,
                        help=argparse.SUPPRESS)
    return p


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    # Reference-default normalization: its default guidance_type None takes
    # neither guidance branch (generate_data.py:1203-1210) == our "none";
    # its optimize_targets None CRASHES its guided path, so when guided we
    # fall back to both prototype energies instead.
    if args.guidance_type is None:
        args.guidance_type = "none"
    if args.optimize_targets is None:
        args.optimize_targets = "global_prototype-local_prototype"
    return args


_DEAD_STORE_TRUE = (
    "center_crop", "random_flip", "with_prior_preservation",
    "train_text_encoder", "scale_lr", "use_8bit_adam",
    "pre_compute_text_embeddings", "text_encoder_use_attention_mask",
    "skip_save_text_encoder", "set_grads_to_none",
)

_DEAD_VALUE = (
    ("cache_dir", str), ("caption_column", str), ("checkpointing_steps", int),
    ("checkpoints_total_limit", int), ("class_data_dir", str),
    ("class_labels_conditioning", str), ("class_prompt", str),
    ("dataset_config_name", str), ("dataset_name", str),
    ("image_column", str), ("instance_data_dir", str),
    ("instance_prompt", str), ("logging_dir", str),
    ("lr_num_cycles", int), ("lr_power", float), ("lr_scheduler", str),
    ("lr_warmup_steps", int), ("max_grad_norm", float),
    ("max_train_samples", int), ("max_train_steps", int),
    ("num_class_images", int), ("num_train_epochs", int),
    ("prior_generation_precision", str), ("prior_loss_weight", float),
    ("resume_from_checkpoint", str), ("revision", str),
    ("sample_batch_size", int), ("snr_gamma", float),
    ("tokenizer_max_length", int), ("tokenizer_name", str),
    ("train_data_dir", str), ("val_batch_size", int),
    ("validation_scheduler", str), ("variant", str),
)


_COMPAT_IGNORED = (
    ("gradient_checkpointing", False),
    ("enable_xformers_memory_efficient_attention", False),
    ("mixed_precision", None),
    ("allow_tf32", False),
    ("local_rank", -1),
    ("report_to", None),
    ("gradient_accumulation_steps", 1),
    ("dataloader_num_workers", 0),
    ("validation_images", None),
) + tuple((name, False) for name in _DEAD_STORE_TRUE) \
  + tuple((name, None) for name, _ in _DEAD_VALUE)


def _warn_compat_flags(args) -> None:
    set_flags = [name for name, default in _COMPAT_IGNORED
                 if getattr(args, name, default) != default]
    if set_flags:
        log.info("reference-compatibility flags accepted and ignored: %s",
                 ", ".join(set_flags))


def check_ported(args) -> None:
    """Raise before anything is written: ``ValueError`` for a
    ``--mesh_model`` that does not divide the device count (as the JAX
    package's ``make_expand_mesh`` asserts), ``NotImplementedError`` for a
    ``--params_path`` the port does not read (an orbax directory), naming
    the ``.npz`` route; none is ignored quietly."""
    if args.mesh_model != 1:
        from distdiff_tpu_torch.parallel.mesh import make_expand_mesh

        make_expand_mesh(args.mesh_model)
    if args.params_path:
        from distdiff_tpu_torch.weights.params_io import params_route

        params_route(args.params_path)


def build_pipeline(args, device=None):
    """The pipeline of ``args`` (``--model``, ``--scheduler``,
    ``--deep_cache``, ``--int8``) on ``device`` (default: ``cli_device()``),
    with the weights of ``--params_path`` or else ``--sd_checkpoint`` when
    given and the ``--lora`` adapter merged into its UNet."""
    from distdiff_tpu_torch.config import GuidanceConfig, PipelineConfig
    from distdiff_tpu_torch.sampling import ExpansionPipeline, SamplerConfig, cast_params_bf16

    check_ported(args)
    device = cli_device() if device is None else device
    if args.tiny:
        if args.model == "sdxl":
            config = PipelineConfig.sdxl_tiny(sample_size=min(args.resolution, 64))
        else:
            config = PipelineConfig.tiny(sample_size=min(args.resolution, 64))
        if args.model == "sd21":  # the toy config in SD-2.1's v-prediction
            config = dataclasses.replace(config, prediction_type="v_prediction")
        guide_input = config.sample_size
    elif args.model == "sdxl":
        config = PipelineConfig.sdxl_base(sample_size=args.resolution)
        guide_input = 224
    elif args.model == "sd21":
        config = PipelineConfig.sd21(sample_size=args.resolution)
        guide_input = 224
    else:
        config = dataclasses.replace(PipelineConfig.sd15(), sample_size=args.resolution)
        guide_input = 224
    if args.steps is not None:
        config = dataclasses.replace(config, num_inference_steps=args.steps)
    config = dataclasses.replace(config, scheduler=args.scheduler)
    if args.deep_cache:
        config = dataclasses.replace(config, deep_cache=True, cache_interval=args.cache_interval,
                                     cache_branch=args.cache_branch)
        if config.scheduler != "ddim":  # refused before any cache is built
            raise NotImplementedError(
                "deep_cache composes with the DDIM solver only (config.scheduler='ddim')")
    if args.int8:
        config = dataclasses.replace(config, int8=True)
    gcfg = GuidanceConfig(
        guidance_type=args.guidance_type,
        guidance_step=args.guidance_step,
        guidance_period=args.guidance_period,
        rho=args.rho,
        constraint_value=args.constraint_value,
        gs=args.gs,
        ls=args.ls,
        K=args.K,
        optimize_targets=tuple(args.optimize_targets.split("-")),
        guide_input_size=guide_input,
        step_in_plan=args.guidance_step_in_plan,
    )
    pipe = ExpansionPipeline.create(
        config,
        sampler_cfg=SamplerConfig(
            guidance_scale=args.guidance_scale,
            do_classifier_free_guidance=args.do_classifier_free_guidance),
        guidance_cfg=gcfg, strength=args.strength, offset_noise=args.offset_noise,
        seed=args.seed, device=device)
    if config.unet.dtype == torch.bfloat16:
        cast_params_bf16(pipe)
    if args.params_path:
        from distdiff_tpu_torch.weights.params_io import load_params

        # strict, as the checkpoint load; it takes precedence, as in the JAX CLI
        load_params(args.params_path, pipe, args.model)
        log.info("loaded the pipeline's parameters from %s (validated)", args.params_path)
    elif args.sd_checkpoint:
        from distdiff_tpu_torch.weights.convert import load_sd_checkpoint, load_sdxl_checkpoint

        # strict: a missing, extra or mis-shaped key raises
        (load_sdxl_checkpoint if pipe.is_sdxl else load_sd_checkpoint)(args.sd_checkpoint, pipe)
        log.info("loaded SD checkpoint from %s (validated)", args.sd_checkpoint)
    else:
        log.warning("NO SD WEIGHTS PROVIDED — using random init. Pass --sd_checkpoint "
                    "(a local diffusers directory) or --params_path for real generation.")
    if args.lora:
        # baked into the stored (bf16 at full width) weights once, before sampling
        from distdiff_tpu_torch.train.lora import load_lora, merge_lora

        lora, alpha = load_lora(args.lora, device=device)
        if args.lora_alpha is not None:
            alpha = args.lora_alpha
        merge_lora(pipe.unet, lora, alpha)
        log.info("merged LoRA adapter %s (alpha=%g, %d leaves)", args.lora, alpha, len(lora))
    if (gcfg.guidance_type in ("transform_guidance", "direct_guidance")
            and not pipe.guidance_active(text_to_img=args.text_to_img)):
        # the reference silently produces unguided samples here; say so
        log.warning(
            "guidance window (guidance_step=%d from the end of a %d-step plan) falls "
            "before the strength-%.2f img2img start index — outputs will be UNGUIDED "
            "(reference-parity clamp; raise --strength or --steps, or lower "
            "--guidance_step)", gcfg.guidance_step, config.num_inference_steps,
            args.strength)
    return pipe


def prototype_cache_path(arch: str, dataset: str, k: int) -> str:
    """The reference's prototype cache (the JAX package's path)."""
    return os.path.join("save/prototypes", arch, dataset, f"class_wise_prototype_K{k}.npz")


@torch.no_grad()
def prepare_guide_and_prototypes(args, pipe, sd):
    """The guide (``--encoder_weight_path``) and its prototypes, read from
    the cache ``save/prototypes/{arch}/{dataset}/class_wise_prototype_K{K}.npz``
    or extracted over the train images and cached there. An
    ``open_clip_vit_b32`` guide whose checkpoint brought a text tower gets
    its zero-shot head: the dataset's template filled with each class name,
    tokenised with ``--bpe_path`` (or the SD checkpoint's merges file),
    through that tower with its detected activation."""
    from distdiff_tpu_torch.data.datasets import BatchLoader, ImageListDataset
    from distdiff_tpu_torch.data.transforms import prototype_transform
    from distdiff_tpu_torch.models.guide import create_model
    from distdiff_tpu_torch.prototypes import (
        build_prototypes,
        load_prototypes,
        normalize_prototypes,
        save_prototypes,
    )

    num_classes = len(sd.class_names)
    arch = args.arch if not args.tiny else "tiny_resnet"
    size = pipe.guidance_cfg.guide_input_size
    guide = create_model(arch, num_classes=num_classes, weight_path=args.encoder_weight_path,
                         input_size=size, device=pipe.device)
    if arch == "open_clip_vit_b32" and guide.text_state is not None:
        from distdiff_tpu_torch.data.templates import template_for
        from distdiff_tpu_torch.models.guide.factory import build_zero_shot_text_features

        guide.class_text_features = torch.as_tensor(build_zero_shot_text_features(
            sd.class_names, template=template_for(args.dataset), state=guide.text_state,
            bpe_path=args.bpe_path, checkpoint_dir=args.sd_checkpoint,
            activation=guide.text_activation, device=pipe.device), device=pipe.device)
    proto_path = prototype_cache_path(arch, args.dataset, args.K)
    if os.path.exists(proto_path):
        gp, lp = load_prototypes(proto_path)
        log.info("loaded prototypes from %s", proto_path)
        return guide, gp, lp
    ds = ImageListDataset(sd.image_paths, sd.labels, prototype_transform(size))
    feats, labels = [], []
    for imgs, tgt, mask in BatchLoader(ds, batch_size=16, num_threads=4):
        f = guide.encode_image(torch.as_tensor(imgs, device=pipe.device)).float().cpu().numpy()
        f = f / (np.linalg.norm(f, axis=-1, keepdims=True) + 1e-12)
        feats.append(f[mask])  # the padded tail rows are dropped
        labels.append(tgt[mask])
    gp, lp = build_prototypes(np.concatenate(feats, 0), np.concatenate(labels, 0),
                              num_classes, k=args.K)
    save_prototypes(proto_path, gp, lp)
    gp, lp = normalize_prototypes(gp, lp)
    log.info("extracted prototypes -> %s", proto_path)
    return guide, gp, lp


def main(argv=None):
    args = parse_args(argv)
    setup_logging()
    _warn_compat_flags(args)
    device = cli_device()
    set_seed(args.seed)

    from distdiff_tpu_torch.data import SDDataset
    from distdiff_tpu_torch.models import load_tokenizer
    from distdiff_tpu_torch.parallel import ExpansionDriver

    pipe = build_pipeline(args, device)
    if args.save_params:
        from distdiff_tpu_torch.weights.params_io import save_params

        size = save_params(args.save_params, pipe, args.model)
        log.info("saved the pipeline's parameters to %s (%d bytes)", args.save_params, size)
    tokenizer = load_tokenizer(
        args.bpe_path, max_length=pipe.config.text_encoder.max_length,
        vocab_size=pipe.config.text_encoder.vocab_size, checkpoint_dir=args.sd_checkpoint,
        # real weights with hash-tokenized prompts would be silently wrong
        # text conditioning; refuse unless this is a toy run
        strict=bool(args.sd_checkpoint or args.params_path) and not args.tiny)

    if pipe.is_sdxl:
        from distdiff_tpu_torch.sampling.conditioning import cond_asarray

        def encode_text_fn(prompts):
            # both towers take the same CLIP-BPE ids, as in the JAX package
            # (diffusers' tokenizer_2 pads with "!" where this pads with
            # the end-of-text token)
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
                   data_root=args.data_root, model=args.model)
    if args.guidance_type != "none":
        guide, gp, lp = prepare_guide_and_prototypes(args, pipe, sd)
        pipe.guide = guide
        pipe.global_protos = torch.as_tensor(gp, device=device)
        pipe.local_protos = torch.as_tensor(lp, device=device)

    from distdiff_tpu_torch.ops.attention import set_tp_attention
    from distdiff_tpu_torch.parallel.mesh import make_expand_mesh

    mesh = make_expand_mesh(args.mesh_model)
    param_shardings = None
    if args.mesh_model > 1:
        # tensor-parallel expansion: the reference's column/row rules on the
        # UNet's transformer layers, everything else replicated; attention
        # runs on each model device's own heads (ops/attention.py)
        from distdiff_tpu_torch.parallel.tp import unet_param_shardings

        param_shardings = unet_param_shardings(mesh, pipe.unet)
        set_tp_attention(mesh)
        log.info("tensor-parallel expansion: mesh %s", mesh.shape)
    run_mesh = mesh if mesh.size > 1 else None
    if args.fused_program:
        expand_fn = pipe.make_expand_fn(text_to_img=args.text_to_img, mesh=run_mesh,
                                        param_shardings=param_shardings)
    else:
        expand_fn = pipe.make_split_expand(text_to_img=args.text_to_img, mesh=run_mesh,
                                           param_shardings=param_shardings)
    driver = ExpansionDriver(expand_fn, sd, args.output_dir,
                             batch_size=args.train_batch_size, seed=args.seed, device=device,
                             mesh=run_mesh)
    try:
        stats = driver.run(num_images_per_prompt=args.num_images_per_prompt,
                           first_image_index=args.first_image_index, split=args.split,
                           total_split=args.total_split, max_units=args.max_units)
    finally:
        driver.close()
        set_tp_attention(None)  # the routing ends with the run
    print(f"expansion finished: {stats['written']} images in {stats['seconds']:.1f}s "
          f"({stats['images_per_sec_per_device']:.3f} img/s/device)")
    return stats


if __name__ == "__main__":
    main()
