"""The port's closed-loop quality protocol (``distdiff_tpu_torch/cli/
quality_loop.py``) against the JAX script (``scripts/quality_loop.py``,
loaded as ``tests/test_quality_loop.py`` loads it): the parsers, the
bicubic resize against Pillow, the toy trees, both pre-trainings, the
aggregation and the ``--no-tiny`` refusal; and, marked slow, the loop end
to end on the CPU.

The pre-trainings: one JAX run of the VAE's at 0 and at 3 steps gives the
initial and the trained tree, one of the UNet's at 3 steps the trained
tree (at 0 it saves its input tree untouched), each read back with
``restore_pytree``. Both packages start from one tree: the JAX pipeline's
parameters drawn with numpy (``seeded_pipeline_tree``, patched into the
JAX pipeline's ``init_params``; a JAX init compiles for ~20 s), handed to
the port as a ``--params_path`` ``.npz``. The UNet's runs start from the
JAX VAE run's 3-step tree, and the port's takes JAX's draws
(``PRNGKey(0)``'s chain, patched into ``draw_unet_inputs``).

Tolerances: both are fp32 on the same weights, images and draws, and
differ in summation order (XLA's against torch's convolutions and
reductions; optax's Adam takes sqrt(v / bc2) where torch's takes
sqrt(v) / sqrt(bc2)). Adam moves an element by about lr (2e-3) a step
whatever its gradient's size, so an element whose gradient is within fp32
noise of 0 moves either way in either run. The tiny models have such
elements by construction: a GroupNorm of one channel a group cancels every
per-channel constant before it (the convolution biases that feed the
residual streams, the UNet's time projections), so their true gradient is
0. ``_held`` tells them apart by the port's first-step gradient and holds
them to ``2 lr`` a step; every other element to ``PARAM_TOL`` (lr / 20)
but for a share ``SHARE_TOL``. The printed losses are held to 1e-4.
"""

import copy
import importlib.util
import os
import re

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from distdiff_tpu.data import datasets as j_datasets
from distdiff_tpu.utils.checkpoints import restore_pytree
from distdiff_tpu_torch.cli import quality_loop as ql
from distdiff_tpu_torch.config import PipelineConfig
from distdiff_tpu_torch.data import datasets as t_datasets
from distdiff_tpu_torch.data.datasets import load_image
from distdiff_tpu_torch.data.transforms import resize_bicubic
from distdiff_tpu_torch.weights.from_jax import key_table, state_dict_from_jax
from distdiff_tpu_torch.weights.safetensors import load_file
from torch_parity import flat_variables

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
LR = 2e-3
PARAM_TOL = 1e-4    # an element of a trained tree, |port - JAX| (lr / 20)
SHARE_TOL = 1e-4    # the share of elements past PARAM_TOL (each within 2 lr a step)
NOISE = 1e-6        # a first-step gradient at most this share of the module's largest
LOSS_TOL = 1e-4     # the printed mse, rms and denoise loss
TOY = dict(n_classes=3, n_train=4, n_test=2, size=20, noise=45.0)


def _load_jax_script():
    path = os.path.join(ROOT, "scripts", "quality_loop.py")
    spec = importlib.util.spec_from_file_location("quality_loop", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jql():
    return _load_jax_script()


def _parser_actions(parse_args):
    import argparse

    seen = {}

    def capture(self, *a, **k):
        seen["parser"] = self
        raise SystemExit(0)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            parse_args([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    p = seen["parser"]
    return p.description, [
        (tuple(a.option_strings), a.dest, a.default, a.type, a.nargs, a.choices, a.required,
         a.help, a.const) for a in p._actions]


def test_parser_takes_the_jax_scripts_flags_and_defaults(jql):
    assert _parser_actions(ql.parse_args) == _parser_actions(jql.parse_args)
    assert vars(ql.parse_args([])) == vars(jql.parse_args([]))
    argv = ["--seeds", "4", "5", "--no-tiny", "--toy_jitter", "55", "--steps", "20"]
    assert vars(ql.parse_args(argv)) == vars(jql.parse_args(argv))


@pytest.mark.parametrize("src,dst", [((20, 20), (32, 32)), ((37, 23), (16, 48)),
                                     ((64, 64), (24, 24))])
def test_resize_bicubic_equals_pillow(src, dst):
    rng = np.random.RandomState(sum(src + dst))
    img = rng.randint(0, 256, src + (3,)).astype(np.uint8)
    img[::5] = 255 * (img[::5] > 127)  # hard edges: the bicubic lobes under- and overshoot
    want = np.asarray(Image.fromarray(img).resize(dst[::-1], Image.BICUBIC))
    got = resize_bicubic(img, dst)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _tree_pixels(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            out[os.path.relpath(path, root)] = path
    return out


@pytest.mark.parametrize("jitter", [0.0, 55.0])
def test_toy_tree_has_the_jax_scripts_pixels(jql, tmp_path, jitter):
    jql.fabricate_toy_dataset(str(tmp_path / "jax"), jitter=jitter, **TOY)
    ql.fabricate_toy_dataset(str(tmp_path / "port"), jitter=jitter, **TOY)
    want, got = _tree_pixels(tmp_path / "jax"), _tree_pixels(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert len(got) == TOY["n_classes"] * (TOY["n_train"] + TOY["n_test"])
    for rel in want:
        jpx = np.asarray(Image.open(want[rel]).convert("RGB"))
        np.testing.assert_array_equal(load_image(got[rel]), jpx, err_msg=rel)
        np.testing.assert_array_equal(np.asarray(Image.open(got[rel]).convert("RGB")), jpx)


def _jax_draws(n, latent_shape, n_train, steps):
    """The draws of the JAX script's UNet step, in its key chain."""
    key = jax.random.PRNGKey(0)
    draws = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        kt, kn, kd = jax.random.split(sub, 3)
        t = jax.random.randint(kt, (n,), 0, n_train)
        noise = jax.random.normal(kn, latent_shape, jax.numpy.float32)
        drop = jax.random.uniform(kd, (n,)) < 0.1
        draws.append(tuple(torch.from_numpy(np.array(a)) for a in (t, noise, drop)))
    return draws


def seeded_pipeline_tree(cfg, seed=0):
    """The JAX tiny pipeline's parameter tree (unet, vae, text), its paths
    and shapes from the port's converter tables (``weights/from_jax.py``
    ``key_table``, the port's modules on the meta device: no JAX init
    traced or compiled), filled with seeded numpy draws as
    ``torch_parity.seeded_variables`` fills a guide's: kernels normal over
    the square root of their fan-in, scales 1 + normal * 0.1, every other
    leaf normal * 0.1."""
    rng = np.random.default_rng(seed)
    tree = {}
    for name, sub in (("unet", cfg.unet), ("vae", cfg.vae), ("text", cfg.text_encoder)):
        for _, (path, shape, _) in sorted(key_table(sub).items()):
            *parents, leaf = f"{name}/{path}".split("/")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            if leaf == "kernel":
                value = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
            elif leaf == "scale":
                value = 1 + 0.1 * rng.standard_normal(shape)
            else:
                value = 0.1 * rng.standard_normal(shape)
            node[leaf] = value.astype(np.float32)
    return tree


def _printed(out, pattern):
    return [float(x) for x in re.search(pattern, out).groups()]


def _captured(fn, *a):
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*a)
    return buf.getvalue()


@pytest.fixture(scope="module")
def runs(jql, tmp_path_factory):
    """The JAX script's VAE pre-training at 0 and 3 steps and its UNet
    pre-training at 3 steps (at 0 it saves its input tree, the VAE run's),
    and the port's at 0 and 3 steps each, with the port's gradients at its
    first step of each."""
    d = tmp_path_factory.mktemp("quality_loop")
    root = str(d / "data")
    jql.fabricate_toy_dataset(root, **TOY)
    init = seeded_pipeline_tree(CFG)
    init_npz = str(d / "init.npz")
    np.savez(init_npz, **flat_variables(init))
    out = {"d": d, "printed": {}, "grads": {}}

    def argv(*extra):
        return ["--data_root", root, "--workdir", str(d / "unused")] + list(extra)

    with pytest.MonkeyPatch.context() as mp:
        from distdiff_tpu.sampling import pipeline as j_pipeline

        mp.setattr(j_pipeline, "init_params", lambda *a, **k: copy.deepcopy(init))
        for steps in (0, STEPS):
            a = jql.parse_args(argv("--vae_steps", str(steps)))
            out["printed"][("jvae", steps)] = _captured(jql.pretrain_tiny_vae, a,
                                                        str(d / f"jvae{steps}"))
            out[("jvae", steps)] = jax.tree.map(np.asarray,
                                                restore_pytree(str(d / f"jvae{steps}")))
        a = jql.parse_args(argv("--unet_steps", str(STEPS)))
        out["printed"][("junet", STEPS)] = _captured(jql.pretrain_tiny_unet, a,
                                                     str(d / f"jvae{STEPS}"),
                                                     str(d / f"junet{STEPS}"))
        out[("junet", STEPS)] = jax.tree.map(np.asarray,
                                             restore_pytree(str(d / f"junet{STEPS}")))
    vae_npz = str(d / "jvae.npz")
    np.savez(vae_npz, **flat_variables(out[("jvae", STEPS)]))

    n = TOY["n_classes"] * TOY["n_train"]
    fed = iter(_jax_draws(n, (n, 16, 16, 4), 1000, STEPS))
    real_build, real_adam = ql.build_pipeline, ql.make_adam

    def build_on_seeded_tree(gargs):  # the port's pipeline on the JAX run's start
        if not gargs.params_path:
            gargs.params_path = init_npz
        return real_build(gargs)

    def jax_draw(gen, shape, n_train):
        assert (tuple(shape), n_train) == ((n, 16, 16, 4), 1000)
        return next(fed)

    def recording_adam(module):  # keeps each parameter's gradient at the first step
        opt = real_adam(module)
        names = {id(p): k for k, p in module.named_parameters()}
        grads = {}

        def first(optimizer, args, kwargs):
            if not grads:
                grads.update({names[id(p)]: p.grad.detach().clone()
                              for g in optimizer.param_groups for p in g["params"]})
        opt.register_step_pre_hook(first)
        out["grads"][type(module).__name__] = grads
        return opt

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DISTDIFF_PLATFORM", "cpu")
        mp.setattr(ql, "build_pipeline", build_on_seeded_tree)
        mp.setattr(ql, "draw_unet_inputs", jax_draw)
        mp.setattr(ql, "make_adam", recording_adam)
        for steps in (0, STEPS):
            a = ql.parse_args(argv("--vae_steps", str(steps)))
            out["printed"][("tvae", steps)] = _captured(ql.pretrain_tiny_vae, a,
                                                        str(d / f"tvae{steps}"))
        for steps in (0, STEPS):
            a = ql.parse_args(argv("--unet_steps", str(steps)))
            out["printed"][("tunet", steps)] = _captured(ql.pretrain_tiny_unet, a, vae_npz,
                                                         str(d / f"tunet{steps}"))
    assert next(fed, None) is None  # every JAX draw was taken
    return out


CFG = PipelineConfig.tiny(sample_size=32)
MODULES = {"unet": ("unet", CFG.unet), "vae": ("vae", CFG.vae),
           "text_encoder": ("text", CFG.text_encoder)}


def _module_state(path, name):
    return load_file(os.path.join(path, f"{name}.safetensors"))


def _jax_state(tree, name):
    key, cfg = MODULES[name]
    return state_dict_from_jax(tree[key], cfg)


def _same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def _held(got: dict, want: dict, start: dict, grads: dict):
    """A trained module against JAX's. An element whose gradient at the
    first step is within fp32 noise of 0 (at most NOISE of the module's
    largest: a bias or a time projection that a one-channel GroupNorm
    cancels, whose true gradient is 0) moves by up to lr a step either
    way in either run: held to 2 lr a step. Every other element: within
    PARAM_TOL, but for a share of SHARE_TOL (each still within 2 lr a
    step). Most elements moved by more than 10 PARAM_TOL."""
    assert sorted(got) == sorted(want) == sorted(grads)
    top = max(float(g.abs().max()) for g in grads.values())
    diff = torch.cat([(got[k] - want[k]).abs().flatten() for k in want])
    noise = torch.cat([(grads[k].abs() <= NOISE * top).flatten() for k in want])
    moved = torch.cat([(got[k] - start[k]).abs().flatten() for k in want])
    assert float(diff.max()) <= 2 * LR * STEPS + 1e-6
    assert float(noise.float().mean()) < 0.05, "most gradients are above the noise"
    share = float((diff[~noise] > PARAM_TOL).float().mean())
    assert share <= SHARE_TOL, share
    assert float((moved[~noise] > 10 * PARAM_TOL).float().mean()) > 0.5
    return float(diff[~noise].max()), share


def test_vae_pretraining_lands_on_the_jax_tree(runs):
    """0 steps: the port saves the tree it started from, which is JAX's 0-step
    tree, exactly. 3 steps: the VAE on JAX's within the limits of ``_held``,
    the UNet and the text encoder untouched."""
    d = runs["d"]
    for name in MODULES:
        _same(_module_state(str(d / "tvae0"), name), _jax_state(runs[("jvae", 0)], name))
        got = _module_state(str(d / f"tvae{STEPS}"), name)
        want = _jax_state(runs[("jvae", STEPS)], name)
        if name == "vae":
            _held(got, want, _jax_state(runs[("jvae", 0)], name),
                  runs["grads"]["AutoencoderKL"])
        else:
            _same(got, want)
    pattern = r"mse ([\d.]+), .* rms ([\d.]+)"
    mse, rms = _printed(runs["printed"][("jvae", STEPS)], pattern)
    tmse, trms = _printed(runs["printed"][("tvae", STEPS)], pattern)
    assert abs(tmse - mse) <= LOSS_TOL and abs(trms - rms) <= 0.01  # printed with 4 and 2 digits
    assert "nan" in runs["printed"][("tvae", 0)] and "(0 steps)" in runs["printed"][("tvae", 0)]


def test_unet_pretraining_on_jax_draws_lands_on_the_jax_tree(runs):
    """From the JAX VAE run's 3-step tree (a ``.npz`` to the port), on
    JAX's draws: 0 steps saves that tree; 3 steps move the UNet onto JAX's
    within the limits of ``_held`` and leave the VAE and the text encoder
    as they were."""
    d = runs["d"]
    start = runs[("jvae", STEPS)]
    for name in MODULES:
        _same(_module_state(str(d / "tunet0"), name), _jax_state(start, name))
        got = _module_state(str(d / f"tunet{STEPS}"), name)
        want = _jax_state(runs[("junet", STEPS)], name)
        if name == "unet":
            _held(got, want, _jax_state(start, name), runs["grads"]["UNet2DConditionModel"])
        else:
            _same(got, want)
            _same(want, _jax_state(start, name))
    pattern = r"denoise loss ([\d.]+)"
    assert abs(_printed(runs["printed"][("tunet", STEPS)], pattern)[0]
               - _printed(runs["printed"][("junet", STEPS)], pattern)[0]) <= LOSS_TOL


def test_pretraining_reuses_a_filled_directory(runs, capsys):
    d = runs["d"]
    args = ql.parse_args(["--data_root", str(d / "data")])
    assert ql.pretrain_tiny_vae(args, str(d / "tvae0")) == str(d / "tvae0")
    assert ql.pretrain_tiny_unet(args, None, str(d / "tunet0")) == str(d / "tunet0")
    out = capsys.readouterr().out
    assert "reuse pretrained VAE params" in out and "reuse pretrained UNet params" in out


def _write_results(root, variant, seed, acc, legacy=False):
    run = os.path.join(root, variant, f"seed{seed}")
    os.makedirs(run)
    if legacy:  # the reference's log.txt only
        with open(os.path.join(run, "log.txt"), "w") as f:
            f.write(f"Epoch 3\nThe best performance:{acc}\n")
    else:
        with open(os.path.join(run, "results.yaml"), "w") as f:
            f.write(f"best_accuracy: {acc}\nbest_epoch: 3\n")


def test_aggregate_gives_the_jax_table(jql, tmp_path, monkeypatch):
    root = str(tmp_path / "checkpoint")
    for seed, acc in ((1, 75.0), (2, 77.5), (3, 80.25)):
        _write_results(root, "guided", seed, acc)
    _write_results(root, "unguided", 1, 62.5)
    _write_results(root, "unguided", 2, 70.0, legacy=True)
    os.makedirs(os.path.join(root, "original"))
    variants = ["original", "unguided", "guided"]
    want = jql.aggregate(root, variants)
    assert ql.aggregate(root, variants) == want
    assert want["guided"]["n"] == 3 and want["original"]["mean"] is None


def test_no_tiny_refuses_pretraining_as_the_jax_script_does(jql, tmp_path):
    for flag in ("--train_vae", "--train_unet"):
        argv = ["--no-tiny", flag, "--workdir", str(tmp_path / "ql")]
        with pytest.raises(SystemExit) as want:
            jql.main(argv)
        with pytest.raises(SystemExit) as got:
            ql.main(argv)
        assert str(got.value) == str(want.value) and "drop these flags" in str(got.value)
        assert not os.path.exists(tmp_path / "ql")


def test_each_cli_call_leaves_the_data_seed_as_it_found_it(monkeypatch, tmp_path):
    """Every CLI the loop calls seeds the per-item data seed
    (``cli.common.set_seed``); the loop puts it back after each call, so a
    later caller in the process sees the seed it had (``ROADMAP.md`` §3,
    "An order-dependent test")."""
    from distdiff_tpu_torch.cli import common
    from distdiff_tpu_torch.cli import generate_data as t_gen
    from distdiff_tpu_torch.cli import train as t_train
    from distdiff_tpu_torch.cli import train_expanded as t_train_expanded

    monkeypatch.setattr(t_datasets, "_DATA_SEED", [11])
    calls = []

    def fake_main(argv):
        seed = int(argv[argv.index("--manualSeed") + 1]) if "--manualSeed" in argv else 0
        common.set_seed(seed)
        calls.append((seed, t_datasets._DATA_SEED[0]))
        return {"written": 0}

    for mod in (t_gen, t_train, t_train_expanded):
        monkeypatch.setattr(mod, "main", fake_main)
    args = ql.parse_args(["--data_root", str(tmp_path), "--seeds", "3", "4"])
    ql.run_training(args, "original", None, str(tmp_path / "ckpt"))
    ql.run_training(args, "guided", str(tmp_path / "exp"), str(tmp_path / "ckpt"))
    ql.run_expansion(args, "none", str(tmp_path / "out"))
    ql.train_guide_encoder(args, str(tmp_path / "ckpt"))
    assert calls == [(3, 3), (4, 4), (3, 3), (4, 4), (0, 0), (0, 0)]
    assert t_datasets._DATA_SEED == [11]


@pytest.mark.slow
def test_torch_quality_loop_end_to_end(tmp_path, monkeypatch):
    """``tests/test_quality_loop.py``'s run, on the port, on the CPU."""
    import json

    monkeypatch.chdir(tmp_path)  # save/ caches land in tmp
    monkeypatch.setenv("DISTDIFF_PLATFORM", "cpu")
    monkeypatch.setattr(t_datasets, "_DATA_SEED", list(t_datasets._DATA_SEED))
    monkeypatch.setattr(j_datasets, "_DATA_SEED", list(j_datasets._DATA_SEED))
    table = ql.main([
        "--workdir", str(tmp_path / "ql"),
        "--seeds", "1", "2",
        "--epochs", "2", "--train_batch", "8", "--input_size", "16",
        "--num_images_per_prompt", "1",
    ])
    for variant in ("original", "unguided", "guided"):
        assert table[variant]["n"] == 2, (variant, table)
        assert table[variant]["mean"] is not None
        assert 0.0 <= table[variant]["mean"] <= 100.0
    assert os.path.isdir(tmp_path / "ql" / "expanded_guided")
    assert os.path.isdir(tmp_path / "ql" / "expanded_unguided")
    assert os.path.exists(
        tmp_path / "ql" / "checkpoint" / "guided" / "seed1" / "results.yaml")
    with open(tmp_path / "ql" / "quality_loop.json") as f:
        assert set(json.load(f)) == {"original", "unguided", "guided"}
