"""``cli.train_lora`` and ``generate_data --lora`` in the port against the
JAX package's CLIs on the CPU: the parser's dests and defaults, the refusal
of ``--params_path``, a ``--tiny`` run of both trainers on one toy PNG tree
and one synth checkpoint, the port's on the JAX run's own draws (the
adapter's init from ``PRNGKey(seed)``, each step's timesteps and noise
from ``fold_in(PRNGKey(seed + 1), step)``, patched into the port CLI's
``init_lora`` and ``draw_t_noise``), and the UNet each ``generate_data``
builds with the port's adapter merged in.

Tolerances: both runs are fp32 on the same weights, batches and draws.
Their inputs, encoded by each package, differ by ~1e-6, and their sums
by summation order, which holds the logged losses to 1e-5 and each
step's adapter gradients, recorded where each CLI hands them to its
optimiser, to 1e-4 of the largest of ``a``'s (or of ``b``'s) over the
adapter (a leaf whose gradients are 1e-7 of the largest reads up to 3e-3
of its own). At the first step ``b`` is 0, so ``a``'s gradient is exactly
0 and AdamW moves ``a`` by its weight decay alone: ``a`` after that step
is held to 2 ulp. AdamW moves an element by ``lr * m / (sqrt(v) + eps)``,
about ``lr`` a step whatever the gradient's size, so an element whose
gradient is within fp32 noise of 0 may move the other way: the adapters
after each step are held to ``2 lr`` a step in an element, and the share
of elements more than ``lr / 10`` apart to ``SHARE_TOL`` (read: none more
than ``lr / 20``)."""

import argparse
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from distdiff_tpu.cli import generate_data as j_gen
from distdiff_tpu.cli import train_lora as j_cli
from distdiff_tpu.config import PipelineConfig as JPipelineConfig
from distdiff_tpu.models import UNet2DCondition
from distdiff_tpu.train import lora as jl
from distdiff_tpu.weights.synth import write_synth_checkpoint as j_write_synth
from distdiff_tpu_torch.cli import generate_data as gen
from distdiff_tpu_torch.cli import train_lora as cli
from distdiff_tpu_torch.train import lora as tl
from distdiff_tpu_torch.weights.from_jax import state_dict_from_jax

torch.set_num_threads(1)

CLASSES = ("alpha", "beta")
STEPS, BATCH, LR, SEED = 3, 4, 1e-4, 0
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
WD = 1e-2  # the CLIs' default --weight_decay
# the share of an adapter's elements more than lr / 10 from the JAX run's
SHARE_TOL = 1e-3


def _actions(parser):
    return {a.dest: (a.default, tuple(a.option_strings), type(a).__name__, a.choices,
                     a.const, a.nargs, a.required, getattr(a.type, "__name__", a.type))
            for a in parser._actions}


def _parser(mod, monkeypatch):
    """The parser ``mod.parse_args`` builds (its ``parse_args`` stopped)."""
    captured = []

    def grab(parser, argv=None):
        captured.append(parser)
        raise SystemExit

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(SystemExit):
            mod.parse_args([])
    return captured[0]


def test_parser_has_the_jax_parsers_dests_and_defaults(monkeypatch):
    got, want = _actions(_parser(cli, monkeypatch)), _actions(_parser(j_cli, monkeypatch))
    assert len(want) == 22 and got == want
    argv = ["--dataset", "dtd", "--output_dir", "o", "-le", "--model", "sdxl", "--rank", "4",
            "--targets", "proj", "--alpha", "2"]
    assert vars(cli.parse_args(argv)) == vars(j_cli.parse_args(argv))


def test_params_path_is_refused_naming_its_roadmap_item(tmp_path, monkeypatch):
    monkeypatch.setenv("DISTDIFF_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="--params_path.*ROADMAP queue 1 item 8"):
        cli.main(["--dataset", "breastmnist", "--output_dir", "never_written", "--tiny",
                  "--params_path", "params"])
    assert os.listdir(tmp_path) == []


@pytest.fixture(scope="module")
def toy_files(tmp_path_factory):
    """A 2-class medmnist-style tree of 20x20 PNGs and a tiny fp32 diffusers
    checkpoint with its tokenizer files, shared by both CLIs."""
    root = tmp_path_factory.mktemp("files")
    base = root / "data" / "medmnist" / "breastmnist"
    for ci, cat in enumerate(CLASSES):
        shade = 40 + 170 * ci
        for split, n in (("train", 3), ("test", 1)):
            os.makedirs(base / split / cat)
            for k in range(n):
                Image.new("RGB", (20, 20), (shade, shade // 2, 10 + 30 * k)).save(
                    base / split / cat / f"img_{k}.png")
    # fp32: the JAX package merges an adapter into the checkpoint's own
    # dtype, the port into the UNet's stored one (fp32 at the toy config)
    ckpt = j_write_synth(str(root / "ckpt"), JPipelineConfig.tiny(sample_size=32), seed=5,
                         dtype=np.float32)
    return str(root / "data"), ckpt


def _argv(toy_files, out):
    data, ckpt = toy_files
    return ["--dataset", "breastmnist", "--data_root", data, "--output_dir", out, "--tiny",
            "--sd_checkpoint", ckpt, "--resolution", "32", "--steps", str(STEPS),
            "--batch", str(BATCH), "--lr", str(LR), "--seed", str(SEED), "--log_every", "1",
            "--save_every", "2"]


def _jax_draws(step, shape):
    """The JAX CLI's draws of ``step``: ``make_lora_train_step`` splits
    ``fold_in(PRNGKey(seed + 1), step)`` into the timesteps' and the
    noise's keys."""
    rng_t, rng_n = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(SEED + 1), step))
    t = jax.random.randint(rng_t, (shape[0],), 0, 1000)
    noise = jax.random.normal(rng_n, shape, jnp.float32)
    return torch.from_numpy(np.array(t)).long(), torch.from_numpy(np.array(noise))


def _numpy(lora):
    return {k: {p: np.array(v) for p, v in pair.items()} for k, pair in lora.items()}


@pytest.fixture(scope="module")
def runs(toy_files, tmp_path_factory):
    """Both CLIs' runs (the port's on the JAX run's draws): each working
    directory, its logged losses and, for each step, the adapter's
    gradients and the adapter they were taken at, as each CLI hands them to
    its optimiser."""
    out = {}
    cwd = os.getcwd()
    handler = _Records()
    logger = logging.getLogger("distdiff.train_lora")
    level = logger.level
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    adamw = optax.adamw
    try:
        jsteps = []

        def recording_adamw(*args, **kwargs):
            tx = adamw(*args, **kwargs)

            def update(grads, state, params=None):
                jax.debug.callback(lambda g, p: jsteps.append((_numpy(g), _numpy(p))),
                                   grads, params, ordered=True)
                return tx.update(grads, state, params)

            return optax.GradientTransformation(tx.init, update)

        work = tmp_path_factory.mktemp("jax")
        os.chdir(work)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(optax, "adamw", recording_adamw)
            j_cli.main(_argv(toy_files, "runs"))
        out["jax"] = (str(work), handler.take(), jsteps)

        shapes = jax.eval_shape(UNet2DCondition(JPipelineConfig.tiny().unet).init,
                                jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)),
                                jnp.zeros((1,), jnp.int32), jnp.zeros((1, 16, 32)))["params"]
        calls, psteps = [], []

        def init_lora(generator, unet, rank=4, targets=tl.DEFAULT_TARGETS, dtype=None):
            jlora = jl.init_lora(jax.random.PRNGKey(SEED), shapes, rank=rank, targets=targets)
            device = next(unet.parameters()).device
            return {k: {p: torch.from_numpy(np.array(v)).to(device).requires_grad_()
                        for p, v in pair.items()} for k, pair in jlora.items()}

        def draw_t_noise(generator, batch, shape, n_train):
            calls.append(n_train)
            return _jax_draws(len(calls), (batch, *shape))

        def make_optimizer(lora, lr, weight_decay):
            opt = tl.make_optimizer(lora, lr=lr, weight_decay=weight_decay)
            step = opt.step

            def recording_step(*args, **kwargs):
                psteps.append(tuple({k: {p: getattr(v, field).detach().numpy().copy()
                                         for p, v in pair.items()} for k, pair in lora.items()}
                                    for field in ("grad", "data")))
                return step(*args, **kwargs)

            opt.step = recording_step
            return opt

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cli, "init_lora", init_lora)
            mp.setattr(cli, "draw_t_noise", draw_t_noise)
            mp.setattr(cli, "make_optimizer", make_optimizer)
            mp.setenv("DISTDIFF_PLATFORM", "cpu")
            work = tmp_path_factory.mktemp("port")
            os.chdir(work)
            cli.main(_argv(toy_files, "runs"))
        assert calls == [1000] * STEPS
        out["port"] = (str(work), handler.take(), psteps)
    finally:
        os.chdir(cwd)
        logger.removeHandler(handler)
        logger.setLevel(level)
    return out


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def take(self):
        out = [r.args[2] for r in self.records if r.msg.startswith("step ")]
        self.records = []
        return out


def _files(workdir):
    return sorted(os.path.relpath(os.path.join(d, f), workdir)
                  for d, _, fs in os.walk(workdir) for f in fs)


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _diffs(got, want, keys):
    return np.concatenate([np.abs(got[k] - want[k]).ravel() for k in keys])


def test_tiny_train_lora_matches_the_jax_cli(runs):
    (jwork, jloss, _), (work, loss, _) = runs["jax"], runs["port"]
    # the same adapters and latent cache at the same paths
    assert _files(work) == _files(jwork) == sorted([
        "runs/lora.npz", "runs/lora_000002.npz",
        "save/vae_embedding/breastmnist/CompVis--stable-diffusion-v1-4/image_latents_32.npy"])
    lat = "save/vae_embedding/breastmnist/CompVis--stable-diffusion-v1-4/image_latents_32.npy"
    np.testing.assert_allclose(np.load(os.path.join(work, lat)),
                               np.load(os.path.join(jwork, lat)), atol=1e-5, rtol=0)
    assert len(loss) == len(jloss) == STEPS
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_TOL, atol=0)
    for name, steps in (("runs/lora_000002.npz", 2), ("runs/lora.npz", STEPS)):
        got, want = np.load(os.path.join(work, name)), np.load(os.path.join(jwork, name))
        assert sorted(got.files) == sorted(want.files) and len(got.files) == 2 * 32 + 1
        assert float(got["__alpha__"]) == float(want["__alpha__"]) == 8.0
        for key in want.files:
            assert got[key].shape == want[key].shape and got[key].dtype == np.float32, key
        diffs = _diffs(got, want, [k for k in want.files if k != "__alpha__"])
        share = float(np.mean(diffs > LR / 10))
        assert diffs.max() <= 2 * LR * steps and share <= SHARE_TOL, (name, diffs.max(), share)
        # the steps moved the adapter: b is no longer 0
        assert max(np.abs(want[k]).max() for k in want.files if k.endswith("::b")) > 0


def test_tiny_train_lora_takes_the_jax_clis_steps(runs):
    """Each step's adapter gradients, and the adapter each step starts
    from, as both CLIs hand them to their optimisers."""
    jsteps, psteps = runs["jax"][2], runs["port"][2]
    assert len(jsteps) == len(psteps) == STEPS
    keys = sorted(jsteps[0][0])
    assert len(keys) == 32
    for step, ((jgrad, jstate), (grad, state)) in enumerate(zip(jsteps, psteps), 1):
        assert sorted(grad) == sorted(state) == keys, step
        for p in ("a", "b"):
            err = _rel(*(np.concatenate([g[k][p].ravel() for k in keys]) for g in (grad, jgrad)))
            assert err <= GRAD_TOL, (step, p, err)
        for k in keys:
            if step == 1:
                # the same init, b = 0: a's gradient is exactly 0 on both sides
                for p in ("a", "b"):
                    np.testing.assert_array_equal(state[k][p], jstate[k][p])
                assert not state[k]["b"].any() and not grad[k]["a"].any(), k
                assert not jgrad[k]["a"].any(), k
            elif step == 2:
                # so the first step moved a by AdamW's weight decay alone
                decayed = psteps[0][1][k]["a"] * np.float32(1 - LR * WD)
                for want in (jstate[k]["a"], decayed):
                    np.testing.assert_array_max_ulp(state[k]["a"], want, maxulp=2)
        diffs = np.concatenate([_diffs(state[k], jstate[k], ("a", "b")) for k in keys])
        share = float(np.mean(diffs > LR / 10))
        assert diffs.max() <= 2 * LR * (step - 1) and share <= SHARE_TOL, (step, diffs.max(),
                                                                          share)


def _gen_argv(toy_files, extra=()):
    data, ckpt = toy_files
    return ["-d", "breastmnist", "--data_root", data, "--tiny", "--sd_checkpoint", ckpt,
            "--num_images_per_prompt", "1", "--train_batch_size", "2", "--max_units", "2",
            "--output_dir", "out", "--seed", "0", "--resolution", "32", *extra]


def test_generate_data_merges_the_adapter_as_the_jax_cli_does(toy_files, runs, tmp_path,
                                                             monkeypatch):
    adapter = os.path.join(runs["port"][0], "runs", "lora.npz")
    jpipe = j_gen.build_pipeline(j_gen.parse_args(_gen_argv(
        toy_files, ["--lora", adapter, "--lora_alpha", "3"])))
    monkeypatch.setenv("DISTDIFF_PLATFORM", "cpu")
    plain = gen.build_pipeline(gen.parse_args(_gen_argv(toy_files))).unet.state_dict()
    pipe = gen.build_pipeline(gen.parse_args(_gen_argv(
        toy_files, ["--lora", adapter, "--lora_alpha", "3"])))
    got = pipe.unet.state_dict()
    want = state_dict_from_jax(jax.tree.map(np.asarray, jpipe.params["unet"]), pipe.config.unet)
    names = {name for name, _ in tl.lora_table(pipe.unet).values()}
    assert len(names) == 32
    for k, v in got.items():
        # fp32 W + (a @ b) * scale over a rank-8 product: at most one ulp
        torch.testing.assert_close(v, want[k], atol=0, rtol=2.0 ** -23 if k in names else 0,
                                   msg=k)
        assert torch.equal(v, plain[k]) != (k in names), k
    # an adapter whose b is 0 leaves every byte of the UNet as it was
    lora, _ = tl.load_lora(adapter)
    for pair in lora.values():
        pair["b"].zero_()
    tl.save_lora(str(tmp_path / "zero.npz"), lora, alpha=8.0)
    zero = gen.build_pipeline(gen.parse_args(_gen_argv(
        toy_files, ["--lora", str(tmp_path / "zero.npz")]))).unet.state_dict()
    for k, v in zero.items():
        assert torch.equal(v, plain[k]), k
    # and the CLI runs with it to the images
    monkeypatch.chdir(tmp_path)
    stats = gen.main(_gen_argv(toy_files, ["--lora", adapter]))
    assert stats["written"] == 2


@pytest.mark.parametrize("model", ["sd21", "sdxl"])
def test_tiny_train_lora_runs_other_models(toy_files, tmp_path, monkeypatch, model):
    """``--model sd21`` (the toy config in v-prediction) and ``sdxl``
    (``sdxl_tiny``, the dict conditioning) at ``--tiny``, on their own
    random weights: the adapter's keys are the JAX package's for the
    model, and the latent cache's name carries the model."""
    data, _ = toy_files
    monkeypatch.setenv("DISTDIFF_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    cli.main(["--dataset", "breastmnist", "--data_root", data, "--output_dir", "run",
              "--tiny", "--model", model, "--resolution", "32", "--steps", "2", "--batch", "2",
              "--rank", "2", "--targets", "to_q-proj"])
    jcfg = (JPipelineConfig.sdxl_tiny() if model == "sdxl" else JPipelineConfig.tiny()).unet
    args = [jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 16, jcfg.cross_attention_dim))]
    if jcfg.addition_embed_dim:
        args.append(jnp.zeros((1, jcfg.addition_embed_dim)))
    shapes = jax.eval_shape(UNet2DCondition(jcfg).init, jax.random.PRNGKey(0), *args)["params"]
    got = np.load(tmp_path / "run" / "lora.npz")
    want = jl.lora_keys(shapes, ("to_q", "proj"))
    assert sorted(got.files) == sorted(["__alpha__"] + [f"{k}::{p}" for k in want
                                                        for p in ("a", "b")])
    assert float(got["__alpha__"]) == 2.0
    assert any(np.abs(got[f"{k}::b"]).max() > 0 for k in want)
    assert _files(str(tmp_path)) == sorted([
        "run/lora.npz", "save/vae_embedding/breastmnist/CompVis--stable-diffusion-v1-4/"
        f"image_latents_32_{model}.npy"])
