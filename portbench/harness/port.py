"""The program under test, driven as ``cli.generate_data`` drives it without
``--fused_program``: ``ExpansionDriver.run`` over
``ExpansionPipeline.make_split_expand()``, one batch in flight, the pinned
copy-back and the PNG writer threads, PNGs into a fresh directory.

The pipeline is assembled from the configuration file's published numbers
and the seeded weights, loaded strictly by their diffusers and torchvision
names. The draws of each work unit (noise, gamma0, beta0) are the
benchmark's, handed to ``SplitExpand`` by keyword: the driver's
``generators`` hook passes the units themselves through to the expand
function, which looks their draws up.

In a guided cell, the latents that ``init_span`` hands the guidance step
are kept for the (batch, slot) pairs of ``keep_g0`` (a copy each, on the
device, no synchronisation), for the comparison after the window.

With ``trace`` every batch records CUDA events on the stream around the
expand call and around ``SplitExpand``'s ``init_span``, ``guide`` and
``span_decode`` (no synchronisation), under ``record_function`` spans of
the same names. ``torch.profiler`` records the device alone over
``profile_batches`` batches before the last (the measured slice: no host
operation is recorded, so the profiler adds little host time), and the host
and the device over the last batch, whose host operations label the idle
gaps.
"""

from __future__ import annotations

import collections
import dataclasses
import time
import types
from typing import List, Optional

import torch

SPANS = ("init_span", "guide", "span_decode")


def _per_level(value):
    """A per-level config list as the port's tuple; a single value as is."""
    return tuple(value) if isinstance(value, (list, tuple)) else value


def pipeline_config(cfg: dict, traffic: dict, int8: bool = False):
    """The port's ``PipelineConfig`` of a configuration file and a traffic
    mix."""
    from distdiff_tpu_torch.config import PipelineConfig, UNetConfig, VAEConfig

    from portbench.harness.weights import DTYPES

    u, v = cfg["unet"], cfg["vae"]
    dtype = DTYPES[cfg["dtype"]]
    text_time = u.get("addition_embed_type") == "text_time"
    ucfg = UNetConfig(
        in_channels=u["in_channels"], out_channels=u["out_channels"],
        block_out_channels=tuple(u["block_out_channels"]),
        layers_per_block=u["layers_per_block"],
        cross_attention=tuple(t.startswith("CrossAttn") for t in u["down_block_types"]),
        transformer_depth=_per_level(u.get("transformer_layers_per_block", 1)),
        num_attention_heads=_per_level(u["attention_head_dim"]),
        cross_attention_dim=u["cross_attention_dim"],
        addition_embed_dim=u["projection_class_embeddings_input_dim"] if text_time else None,
        linear_projection=bool(u.get("use_linear_projection", False)), dtype=dtype)
    vcfg = VAEConfig(
        in_channels=v["in_channels"], out_channels=v["out_channels"],
        latent_channels=v["latent_channels"],
        block_out_channels=tuple(v["block_out_channels"]),
        layers_per_block=v["layers_per_block"], scaling_factor=v["scaling_factor"],
        dtype=dtype)
    return PipelineConfig(
        unet=ucfg, vae=vcfg, sample_size=cfg["sample_size"],
        num_inference_steps=traffic["steps"],
        prediction_type=cfg["scheduler"].get("prediction_type", "epsilon"),
        scheduler=traffic.get("scheduler", "ddim"), int8=int8,
        max_text_length=cfg["text"]["context_length"])


def build_pipeline(cfg: dict, traffic: dict, states: dict, inputs, device, int8: bool = False):
    """The port's ``ExpansionPipeline`` on ``states`` (modules built on the
    meta device, then given the seeded tensors by a strict load)."""
    from distdiff_tpu_torch.config import GuidanceConfig
    from distdiff_tpu_torch.device import disable_tf32
    from distdiff_tpu_torch.models.guide.factory import create_model
    from distdiff_tpu_torch.models.unet import UNet2DConditionModel
    from distdiff_tpu_torch.models.vae import AutoencoderKL
    from distdiff_tpu_torch.sampling import ExpansionPipeline, SamplerConfig
    from distdiff_tpu_torch.schedulers import build_schedule

    pcfg = pipeline_config(cfg, traffic, int8)
    if torch.device(device).type == "cuda":
        disable_tf32()
    mods = {"unet": UNet2DConditionModel(pcfg.unet, device="meta"),
            "vae": AutoencoderKL(pcfg.vae, device="meta")}
    for name, m in mods.items():
        m.to(pcfg.unet.dtype if name == "unet" else pcfg.vae.dtype)
    g = cfg["guide"]
    guide = create_model(g["arch"], g["num_classes"], device="meta")
    mods["guide"] = guide.module
    for name, m in mods.items():
        m.load_state_dict(states[name], strict=True, assign=True)
        m.requires_grad_(False).eval()
    s = cfg["scheduler"]
    sched = build_schedule(
        pcfg.scheduler, pcfg.num_inference_steps, prediction_type=pcfg.prediction_type,
        num_train_timesteps=s["num_train_timesteps"], beta_start=s["beta_start"],
        beta_end=s["beta_end"], beta_schedule=s["beta_schedule"],
        steps_offset=s["steps_offset"], set_alpha_to_one=s["set_alpha_to_one"])
    tg = traffic["guidance"]
    gcfg = GuidanceConfig(
        guidance_type=tg["type"], guidance_step=tg.get("step", 20),
        guidance_period=tg.get("period", 2), rho=tg.get("rho", 10.0),
        constraint_value=tg.get("constraint_value", 0.2), gs=tg.get("gs", 1.0),
        ls=tg.get("ls", 1.0), K=tg["K"], guide_input_size=g["input_size"])
    return ExpansionPipeline(
        config=pcfg, sampler_cfg=SamplerConfig(guidance_scale=traffic["guidance_scale"]),
        guidance_cfg=gcfg, sched=sched, unet=mods["unet"], vae=mods["vae"],
        text_encoder=None, device=torch.device(device), guide=guide,
        global_protos=inputs.global_protos, local_protos=inputs.local_protos,
        strength=traffic["strength"])


class Dataset:
    """What ``SDDataset`` hands the driver: item paths, class names and
    labels, and items of (latent, cond, uncond, target) held on the host."""

    def __init__(self, inputs):
        self.inputs = inputs
        n_cls = len(inputs.global_protos)
        self.image_paths = [f"item{i:04d}.png" for i in range(len(inputs.labels))]
        self.class_names = [f"class{c:04d}" for c in range(n_cls)]
        self.labels = list(inputs.labels)

    def __getitem__(self, idx):
        target = self.labels[idx]
        return types.SimpleNamespace(latent=self.inputs.latents[idx],
                                     cond=self.inputs.cond_of(target),
                                     uncond=self.inputs.uncond, target=target)


@dataclasses.dataclass
class BatchRecord:
    units: list
    start: Optional[object] = None      # CUDA events, trace mode only
    end: Optional[object] = None
    spans: dict = dataclasses.field(default_factory=lambda: collections.defaultdict(list))
    host_start: float = 0.0
    g0: dict = dataclasses.field(default_factory=dict)   # slot -> latents at g0


class PortRun:
    """The program's timed path for one cell, and its bookkeeping."""

    def __init__(self, cfg: dict, traffic: dict, states: dict, inputs, device,
                 trace: bool = False, int8: bool = False, expand_hook=None):
        from distdiff_tpu_torch.parallel import ExpansionDriver

        self.inputs = inputs
        self.device = torch.device(device)
        self.trace = trace and self.device.type == "cuda"
        self.pipe = build_pipeline(cfg, traffic, states, inputs, device, int8)
        self.se = self.pipe.make_split_expand()
        self.batch = traffic["batch"]
        self.records: List[BatchRecord] = []
        self.profile_from: Optional[int] = None   # first batch of the measured slice
        self.prof_device = self.prof_host = None
        self.expand_hook = expand_hook            # tests: breaks the timed path
        self.keep_g0: dict = {}                   # batch index -> slots whose g0 latents
        if self.se.guided:                        # the comparison reads
            self._keep_init_span()
        if self.trace:
            for name in SPANS:
                self._wrap_span(name)

        class Driver(ExpansionDriver):
            def generators(self, units):
                return list(units)

        self.driver = Driver(self.expand, Dataset(inputs), output_dir="", batch_size=self.batch,
                             writer_threads=traffic["writer_threads"], device=device)

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _keep_init_span(self):
        orig = self.se.init_span

        def keep(*args, **kwargs):
            out = orig(*args, **kwargs)
            slots = self.keep_g0.get(len(self.records) - 1)
            if slots:
                self.records[-1].g0.update(zip(slots, out[list(slots)].float()))
            return out

        self.se.init_span = keep

    def _wrap_span(self, name):
        orig = getattr(self.se, name)

        def timed(*args, **kwargs):
            with torch.profiler.record_function(f"portbench.{name}"):
                a = self._event()
                out = orig(*args, **kwargs)
                self.records[-1].spans[name].append((a, self._event()))
            return out

        setattr(self.se, name, timed)

    def expand(self, latents, cond, uncond, targets, units):
        rec = BatchRecord(units=list(units), host_start=time.perf_counter())
        self.records.append(rec)
        if self.profile_from is not None:
            self._profile(len(self.records) - 1)
        per = self.inputs.per_prompt
        noise, gamma0, beta0 = self.inputs.unit_draws(
            u.dataset_index * per + u.image_i for u in units)
        if self.trace:
            with torch.profiler.record_function("portbench.batch"):
                rec.start = self._event()
                out = self.se(latents, cond, uncond, targets, noise=noise, gamma0=gamma0,
                              beta0=beta0)
                rec.end = self._event()
        else:
            out = self.se(latents, cond, uncond, targets, noise=noise, gamma0=gamma0,
                          beta0=beta0)
        if self.expand_hook is not None:
            out = self.expand_hook(out, units)
        return out

    def _profile(self, index: int) -> None:
        from torch.profiler import ProfilerActivity, profile

        if index == self.profile_from:
            self.prof_device = profile(activities=[ProfilerActivity.CUDA])
            self.prof_device.start()
        elif index == self.label_at:
            torch.cuda.synchronize()  # the measured slice's device work is all recorded
            self.prof_device.stop()
            self.prof_host = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof_host.start()

    def run(self, output_dir: str, batches: int, profile_batches: int = 0) -> dict:
        """``batches`` whole batches through ``ExpansionDriver.run`` into
        ``output_dir``; the records of this run replace the last run's. With
        ``profile_batches``, the measured slice is that many batches before
        the last, which labels the gaps."""
        self.records = []
        self.driver.output_dir = output_dir
        self.profile_from = batches - profile_batches - 1 if profile_batches else None
        self.label_at = batches - 1
        self.prof_device = self.prof_host = None
        stats = self.driver.run(num_images_per_prompt=self.inputs.per_prompt,
                                max_units=batches * self.batch)
        if self.prof_host is not None:
            self.prof_host.stop()
        return stats

    def close(self):
        self.driver.close()
