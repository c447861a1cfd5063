"""The port's trainer CLIs (``cli.train``, ``cli.train_expanded``) against
the JAX package's on the CPU: the parsers' dests and defaults, the device
rule, and both CLIs end to end at ``tiny_resnet`` on one PNG tree with one
seed and one starting ``.pth.tar`` (2 epochs, then a resume for a third;
the expanded run over a tree in ``ExpansionDriver``'s layout), their
``log.txt`` rows held against the JAX CLIs' row by row. Then the port's checkpoint round trip
and its ``model_best.pth.tar`` read back by the guide loader.

Tolerance: the learning-rate column equal; losses within 1e-4 (fp32 on
both sides, three epochs of SGD at lr 0.1 from the same weights and
batches; they differ by summation order only, some 1e-6 here); accuracies
equal, and where one differs the test names the rows of the port's final
evaluation whose two top logits lie within 1e-4 of each other (an argmax
tie), the only cause it accepts for a difference in them."""

import argparse
import contextlib
import io
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from distdiff_tpu.cli import train as j_train
from distdiff_tpu.cli import train_expanded as j_train_expanded
from distdiff_tpu.models.guide import create_model as j_create_model
from distdiff_tpu_torch.cli import train, train_expanded
from distdiff_tpu_torch.models.guide import create_model
from distdiff_tpu_torch.models.guide.resnet import tiny_resnet_config
from distdiff_tpu_torch.train import (
    TrainConfig,
    create_train_state,
    make_optimizer,
    make_train_step,
)
from distdiff_tpu_torch.utils import checkpoints
from distdiff_tpu_torch.weights.from_jax import state_dict_from_jax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ("alpha", "beta", "gamma")
LOSS_TOL = 1e-4
TIE = 1e-4


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


@pytest.mark.parametrize("port,jax_", [(train, j_train), (train_expanded, j_train_expanded)],
                         ids=["train", "train_expanded"])
def test_parsers_have_the_jax_parsers_dests_and_defaults(port, jax_, monkeypatch):
    got, want = _actions(_parser(port, monkeypatch)), _actions(_parser(jax_, monkeypatch))
    assert len(want) >= 19 and got == want
    argv = ["-d", "dtd", "-a", "tiny_resnet", "--train-batch", "8", "--wd", "1e-4",
            "--train_fc", "--accumulate", "2", "-e", "--manualSeed", "3"]
    if port is train_expanded:
        argv += ["--data_expanded_dir", "a", "b"]
    assert vars(port.parse_args(argv)) == vars(jax_.parse_args(argv))


@pytest.mark.parametrize("mod", [train, train_expanded], ids=["train", "train_expanded"])
def test_the_clis_run_on_the_card_unless_asked_for_the_cpu(mod, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("DISTDIFF_PLATFORM", raising=False)
    argv = ["-a", "tiny_resnet", "--checkpoint", str(tmp_path / "never_written"),
            "--data_expanded_dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="DISTDIFF_PLATFORM=cpu"):
        mod.main(argv if mod is train_expanded else argv[:-2])
    assert not os.path.exists(tmp_path / "never_written")


def test_modules_run_as_programs():
    for mod in ("train", "train_expanded", "parse_logs"):
        out = subprocess.run([sys.executable, "-m", f"distdiff_tpu_torch.cli.{mod}", "--help"],
                             cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0 and "usage" in out.stdout, (mod, out.stderr)


def _image(h, w, seed, tint):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 200, (h, w, 3))
    img[..., tint] += 55
    return img.astype(np.uint8)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 3-class medmnist-layout PNG tree (6 train, 3 test images a class,
    20-40 px, never square), an expanded tree in ``ExpansionDriver``'s
    layout (two classes, two
    images each) and a tiny_resnet ``.pth.tar`` of the JAX initial weights."""
    root = tmp_path_factory.mktemp("files")
    base = root / "data" / "medmnist" / "breastmnist"
    k = 0
    for ci, cat in enumerate(CLASSES):
        for split, n in (("train", 6), ("test", 3)):
            os.makedirs(base / split / cat)
            for j in range(n):
                h, w = 20 + (7 * k) % 21, 21 + (11 * k) % 19
                Image.fromarray(_image(h, w + (w == h), k, ci)).save(
                    base / split / cat / f"{j}.png")
                k += 1
        if ci != 1:
            os.makedirs(root / "expanded" / cat)
            for j in range(2):
                Image.fromarray(_image(32, 32, 100 + k, ci)).save(
                    root / "expanded" / cat / f"0_expand_{j}.png")
                k += 1
    jg = j_create_model("tiny_resnet", num_classes=3, input_size=32)
    state = state_dict_from_jax(jax.tree.map(np.asarray, jg.variables), tiny_resnet_config(3))
    torch.save({"state_dict": {"module." + k: v for k, v in state.items()}},
               str(root / "start.pth.tar"))
    return {"data": str(root / "data"), "expanded": str(root / "expanded"),
            "start": str(root / "start.pth.tar")}


def _argv(files, run_dir, epochs, extra=()):
    return ["-d", "breastmnist", "--data_root", files["data"], "-a", "tiny_resnet",
            "--input_size", "32", "--train-batch", "8", "--test-batch", "8",
            "--epochs", str(epochs), "--manualSeed", "1", "--encoder_weight_path",
            files["start"], "--checkpoint", run_dir, *extra]


def _runs(files, base, train_mod, expanded_mod):
    """Two epochs, a resume for a third, and an expanded run of two epochs;
    the run directories and the --evaluate line."""
    dirs = {name: os.path.join(base, name) for name in ("train", "expanded")}
    quiet = contextlib.redirect_stdout(io.StringIO())
    with quiet:
        train_mod.main(_argv(files, dirs["train"], 2))
        train_mod.main(_argv(files, dirs["train"], 3, ["--resume", dirs["train"]]))
        expanded_mod.main(_argv(files, dirs["expanded"], 2,
                                ["--data_expanded_dir", files["expanded"]]))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_mod.main(_argv(files, os.path.join(base, "eval"), 1, ["-e"]))
    return dirs, buf.getvalue().strip()


@pytest.fixture(scope="module")
def jax_runs(files, tmp_path_factory):
    return _runs(files, str(tmp_path_factory.mktemp("jax")), j_train, j_train_expanded)


@pytest.fixture(scope="module")
def port_runs(files, tmp_path_factory):
    os.environ["DISTDIFF_PLATFORM"] = "cpu"
    try:
        return _runs(files, str(tmp_path_factory.mktemp("port")), train, train_expanded)
    finally:
        del os.environ["DISTDIFF_PLATFORM"]


def _log(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0].split("\t"), [[float(v) for v in line.split("\t")] for line in lines[1:]]


def _near_ties(run_dir, files, num_classes=3):
    """Rows of the port's final test evaluation whose top two logits lie
    within TIE."""
    from distdiff_tpu_torch.data import load_dataset
    from distdiff_tpu_torch.data.transforms import eval_transform

    gm = create_model("tiny_resnet", num_classes, device="cpu",
                      weight_path=os.path.join(run_dir, "checkpoint.pth.tar"))
    test = load_dataset("breastmnist", None, eval_transform(32), data_root=files["data"]).test
    ties = []
    with torch.no_grad():
        for i in range(len(test)):
            logits = gm.module(torch.from_numpy(test[i][0][None]))[0]
            top = torch.topk(logits, 2).values
            if float(top[0] - top[1]) < TIE:
                ties.append((test.image_paths[i], logits.tolist()))
    return ties


@pytest.mark.parametrize("run", ["train", "expanded"])
def test_cli_logs_match_the_jax_clis_epoch_by_epoch(files, jax_runs, port_runs, run):
    (jdirs, _), (pdirs, _) = jax_runs, port_runs
    jnames, jrows = _log(os.path.join(jdirs[run], "log.txt"))
    names, rows = _log(os.path.join(pdirs[run], "log.txt"))
    assert names == jnames and len(rows) == len(jrows) == (3 if run == "train" else 2)
    for epoch, (row, jrow) in enumerate(zip(rows, jrows)):
        assert row[0] == jrow[0], f"epoch {epoch + 1}: learning rate"
        for col in (1, 2):
            assert abs(row[col] - jrow[col]) <= LOSS_TOL, f"epoch {epoch + 1}: {names[col]}"
        for col in (3, 4):
            if row[col] != jrow[col]:
                ties = _near_ties(pdirs[run], files)
                pytest.fail(f"epoch {epoch + 1}: {names[col]} {row[col]} against the JAX "
                            f"CLI's {jrow[col]}; near argmax ties in the port's last "
                            f"evaluation: {ties or 'none, so not a tie'}")
    for name in ("checkpoint.pth.tar", "model_best.pth.tar", "results.yaml"):
        assert os.path.exists(os.path.join(pdirs[run], name))


def test_evaluate_prints_the_jax_line(jax_runs, port_runs):
    assert port_runs[1] == jax_runs[1] and port_runs[1].startswith("Evaluation: loss")


def test_model_best_loads_as_a_guide_with_the_trained_logits(port_runs):
    """``model_best.pth.tar`` through the guide loader (``generate_data
    --encoder_weight_path``) gives the logits of the module it saved."""
    best = os.path.join(port_runs[0]["train"], "model_best.pth.tar")
    guide = create_model("tiny_resnet", 3, device="cpu", weight_path=best)
    trained = create_model("tiny_resnet", 3, device="cpu", trainable=True).module
    trained.load_state_dict(torch.load(best, weights_only=True)["state_dict"])
    trained.eval()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 32, 32, 3)).astype(
        np.float32))
    with torch.no_grad():
        assert torch.equal(guide.module(x), trained(x))


def test_checkpoint_round_trip_restores_module_and_optimiser(tmp_path):
    gm = create_model("tiny_resnet", 3, device="cpu", trainable=True)
    tx = make_optimizer(gm.module, TrainConfig(epochs=2, accumulate=2), 3)
    state = create_train_state(gm.module, tx)
    step = make_train_step(gm.module, tx)
    rng = np.random.default_rng(0)
    for _ in range(3):  # one update and a half-filled accumulation
        state, _ = step(state, rng.standard_normal((4, 16, 16, 3)).astype(np.float32),
                        rng.integers(0, 3, 4), np.ones(4, bool))
    checkpoints.save_train_checkpoint(str(tmp_path), state, 5, 42.5, is_best=False)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint.pth.tar"]
    fresh = create_model("tiny_resnet", 3, device="cpu", trainable=True)
    ftx = make_optimizer(fresh.module, TrainConfig(epochs=2, accumulate=2), 3)
    restored = checkpoints.load_train_checkpoint(str(tmp_path), create_train_state(fresh.module,
                                                                                    ftx))
    assert (restored["epoch"], restored["best_acc"]) == (5, 42.5)
    for k, v in gm.module.state_dict().items():
        assert torch.equal(fresh.module.state_dict()[k], v), k
    assert (ftx.count, ftx.mini_step) == (tx.count, tx.mini_step) == (1, 1)
    for a, b in zip(ftx.acc, tx.acc):
        assert torch.equal(a, b)
    for p, q in zip(ftx.params, tx.params):
        assert torch.equal(ftx.sgd.state[p]["momentum_buffer"], tx.sgd.state[q]["momentum_buffer"])
    # a file path resumes as well as its directory
    again = checkpoints.load_train_checkpoint(os.path.join(str(tmp_path), "checkpoint.pth.tar"),
                                              create_train_state(fresh.module, ftx))
    assert again["epoch"] == 5
