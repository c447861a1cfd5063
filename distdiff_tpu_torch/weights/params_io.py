"""The pipeline's parameter files: ``--save_params DIR`` and
``--params_path`` of ``cli/generate_data.py`` and ``cli/train_lora.py``
(the port's counterpart of the JAX CLI's orbax tree, which the card's
machine cannot read: it has neither JAX nor orbax).

A port directory holds one safetensors file per module, in the module's
own state-dict names and dtypes (``weights/safetensors.py``):
``unet.safetensors``, ``vae.safetensors``, ``text_encoder.safetensors`` and,
under SDXL, ``text_encoder_2.safetensors``; beside them ``params.json``
names the ``--model`` and the modules' geometry (their configs). It is
written after the checkpoint load, the bf16 cast and the ``--lora`` merge,
so it holds the weights the run sampled with. An existing directory is
replaced, as the JAX package's ``save_pytree`` replaces one.

``--params_path`` takes such a directory, or a flat ``.npz`` of the JAX
package's parameter tree (its ``pipe.params``: keys ``unet/...``,
``vae/...``, ``text/...`` and ``text_2/...`` joined with ``/``, float32 or
float16 leaves), converted by ``weights/from_jax.py``
``state_dict_from_jax``. Both load strictly: a missing, extra or misshapen
key raises and names the key, and a directory written for another
``--model`` raises and names both. An orbax directory raises and names the
``.npz`` route.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from distdiff_tpu_torch.weights.convert import check_state
from distdiff_tpu_torch.weights.from_jax import state_dict_from_jax
from distdiff_tpu_torch.weights.safetensors import load_file, save_file

MANIFEST = "params.json"
FORMAT = "distdiff_tpu_torch pipeline parameters, version 1"
# (file stem and pipeline attribute, key of the JAX package's params tree)
MODULES = (("unet", "unet"), ("vae", "vae"), ("text_encoder", "text"),
           ("text_encoder_2", "text_2"))
NPZ_ROUTE = (
    "the port reads its own --save_params directories and a flat .npz of the JAX "
    "package's parameter tree: on a host with JAX, restore the tree to numpy "
    "(distdiff_tpu.utils.checkpoints.restore_pytree), flatten it with keys joined by "
    "'/' (unet/..., vae/..., text/..., text_2/...) as float32, and np.savez it")


def modules(pipe) -> Iterator[Tuple[str, str, torch.nn.Module]]:
    """(name, JAX tree key, module) of each diffusion module the pipeline
    has (``text_encoder_2`` only under SDXL)."""
    for name, jax_key in MODULES:
        module = getattr(pipe, name, None)
        if module is not None:
            yield name, jax_key, module


def geometry(pipe) -> Dict[str, dict]:
    """Each module's config as JSON values (dtypes by name)."""
    def plain(v):
        return str(v) if isinstance(v, torch.dtype) else v

    return json.loads(json.dumps({
        name: {k: plain(v) for k, v in dataclasses.asdict(m.config).items()}
        for name, _, m in modules(pipe)}))


def save_params(path: str, pipe, model: str) -> int:
    """Write ``pipe``'s diffusion modules to the directory ``path``
    (replaced if it exists); returns the bytes written."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    for name, _, module in modules(pipe):
        save_file(module.state_dict(), os.path.join(path, f"{name}.safetensors"))
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump({"format": FORMAT, "model": model, "geometry": geometry(pipe)}, f,
                  indent=1)
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


def params_route(path: str) -> str:
    """``"port"`` for a directory ``save_params`` wrote, ``"npz"`` for a
    ``.npz`` file; any other directory (the JAX package's orbax tree) raises
    ``NotImplementedError`` naming the ``.npz`` route."""
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, MANIFEST)):
            return "port"
        raise NotImplementedError(
            f"{path} is not a parameter directory of the port (no {MANIFEST}); an orbax "
            f"checkpoint of the JAX package is not read here: {NPZ_ROUTE}")
    if not os.path.exists(path):
        raise FileNotFoundError(f"--params_path {path} does not exist")
    if not path.endswith(".npz"):
        raise ValueError(f"--params_path {path}: {NPZ_ROUTE}")
    return "npz"


def _port_states(path: str, pipe, model: str) -> Dict[str, Dict[str, torch.Tensor]]:
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{path}: {MANIFEST} is not of the format {FORMAT!r}")
    if manifest["model"] != model:
        raise ValueError(f"{path} holds --model {manifest['model']} parameters; this run "
                         f"is --model {model}")
    want = geometry(pipe)
    for name in sorted(set(want) | set(manifest["geometry"])):
        got = manifest["geometry"].get(name)
        if got != want.get(name):
            fields = sorted(k for k in set(got or {}) | set(want.get(name) or {})
                            if (got or {}).get(k) != (want.get(name) or {}).get(k))
            raise ValueError(f"{path}: {name} was saved with another geometry "
                             f"(differs in {fields or 'presence'})")
    return {name: load_file(os.path.join(path, f"{name}.safetensors"))
            for name, _, _ in modules(pipe)}


def _npz_states(path: str, pipe) -> Dict[str, Dict[str, torch.Tensor]]:
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    states = {}
    for name, jax_key, module in modules(pipe):
        prefix = jax_key + "/"
        sub = {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}
        states[name] = state_dict_from_jax(sub, module.config)
        for k in list(flat):
            if k.startswith(prefix):
                del flat[k]
    if flat:
        raise KeyError(f"{path}: {len(flat)} leaves belong to no module of this pipeline "
                       f"(first: {sorted(flat)[:3]})")
    return states


@torch.no_grad()
def load_params(path: str, pipe, model: str) -> Dict[str, int]:
    """Load ``path`` (a port directory or a JAX ``.npz``) into ``pipe``'s
    diffusion modules, strictly, each tensor cast to its module's dtype and
    device; returns the tensors loaded per module."""
    route = params_route(path)
    states = _port_states(path, pipe, model) if route == "port" else _npz_states(path, pipe)
    loaded = {}
    for name, _, module in modules(pipe):
        check_state(name, states[name], module)
        module.load_state_dict(states[name])
        loaded[name] = len(states[name])
    return loaded
