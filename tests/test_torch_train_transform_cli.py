"""The port's ``cli.train_transform`` against the JAX package's on the CPU:
its parser (dests, defaults and choices), the device rule, the four
transform-level ``--transform_type`` runs (default, autoaug, randaug,
cutout; two epochs over the original-only control, the original tree
replicated ``expand_num + 1`` times) and a run over original ⊕ expanded
with its exact ``(N+1)x`` ratio, at ``tiny_resnet`` on one PNG tree with
one seed and one starting ``.pth.tar``, ``log.txt`` held row for row
against the JAX CLI's. The batch- and loss-level runs are in
``test_torch_train_transform_mix_cli.py``.

Tolerance, as ``test_torch_train_cli.py``'s: the learning-rate column
equal; losses within 1e-4; accuracies equal, and where one differs the
test names the rows of the port's final evaluation whose two top logits
lie within 1e-4 of each other (an argmax tie), the only cause it accepts."""

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
from test_torch_train_cli import _actions, _image, _log, _near_ties, _parser

from distdiff_tpu.cli import train_transform as j_cli
from distdiff_tpu.models.guide import create_model as j_create_model
from distdiff_tpu_torch.cli import train_transform as cli
from distdiff_tpu_torch.models.guide.resnet import tiny_resnet_config
from distdiff_tpu_torch.weights.from_jax import state_dict_from_jax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ("alpha", "beta", "gamma")
TRAIN, TEST = 4, 2
LOSS_TOL = 1e-4


def write_files(root):
    """A 3-class medmnist-layout PNG tree (4 train, 2 test images a class,
    20-40 px, never square), an expanded tree in ``ExpansionDriver``'s
    layout with ``_expand_0`` and ``_expand_1`` of every train image, and a
    tiny_resnet ``.pth.tar`` of the JAX initial weights."""
    base = os.path.join(root, "data", "medmnist", "breastmnist")
    k = 0
    for ci, cat in enumerate(CLASSES):
        for split, n in (("train", TRAIN), ("test", TEST)):
            os.makedirs(os.path.join(base, split, cat))
            for j in range(n):
                h, w = 20 + (7 * k) % 21, 21 + (11 * k) % 19
                Image.fromarray(_image(h, w + (w == h), k, ci)).save(
                    os.path.join(base, split, cat, f"{j}.png"))
                k += 1
        os.makedirs(os.path.join(root, "expanded", cat))
        for j in range(TRAIN):
            for i in range(2):
                Image.fromarray(_image(32, 32, 100 + k, ci)).save(
                    os.path.join(root, "expanded", cat, f"{j}_expand_{i}.png"))
                k += 1
    jg = j_create_model("tiny_resnet", num_classes=3, input_size=32)
    state = state_dict_from_jax(jax.tree.map(np.asarray, jg.variables), tiny_resnet_config(3))
    torch.save({"state_dict": {"module." + k: v for k, v in state.items()}},
               os.path.join(root, "start.pth.tar"))
    return {"data": os.path.join(root, "data"), "expanded": os.path.join(root, "expanded"),
            "start": os.path.join(root, "start.pth.tar")}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_files(str(tmp_path_factory.mktemp("files")))


def argv(files, run_dir, transform_type, epochs, extra=()):
    return ["-d", "breastmnist", "--data_root", files["data"], "-a", "tiny_resnet",
            "--input_size", "32", "--train-batch", "8", "--test-batch", "8",
            "--epochs", str(epochs), "--manualSeed", "1", "--encoder_weight_path",
            files["start"], "--checkpoint", run_dir, "--transform_type", transform_type,
            "--expand_num", "1", *extra]


def run_both(files, base, transform_type, epochs, extra=()):
    """The JAX CLI's and the port's runs (the port on the CPU); their run
    directories."""
    dirs = {}
    for name, mod in (("jax", j_cli), ("port", cli)):
        dirs[name] = os.path.join(base, name)
        env = {"DISTDIFF_PLATFORM": "cpu"} if mod is cli else {}
        with contextlib.redirect_stdout(io.StringIO()), _env(env):
            mod.main(argv(files, dirs[name], transform_type, epochs, extra))
    return dirs


@contextlib.contextmanager
def _env(values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def assert_logs_match(files, dirs, epochs):
    jnames, jrows = _log(os.path.join(dirs["jax"], "log.txt"))
    names, rows = _log(os.path.join(dirs["port"], "log.txt"))
    assert names == jnames and len(rows) == len(jrows) == epochs
    for epoch, (row, jrow) in enumerate(zip(rows, jrows)):
        assert row[0] == jrow[0], f"epoch {epoch + 1}: learning rate"
        for col in (1, 2):
            assert abs(row[col] - jrow[col]) <= LOSS_TOL, (
                f"epoch {epoch + 1}: {names[col]} {row[col]} against {jrow[col]}")
        for col in (3, 4):
            if row[col] != jrow[col]:
                ties = _near_ties(dirs["port"], files)
                pytest.fail(f"epoch {epoch + 1}: {names[col]} {row[col]} against the JAX "
                            f"CLI's {jrow[col]}; near argmax ties in the port's last "
                            f"evaluation: {ties or 'none, so not a tie'}")
    for name in ("checkpoint.pth.tar", "model_best.pth.tar", "results.yaml"):
        assert os.path.exists(os.path.join(dirs["port"], name))


def test_parser_has_the_jax_parsers_dests_defaults_and_choices(monkeypatch):
    got, want = _actions(_parser(cli, monkeypatch)), _actions(_parser(j_cli, monkeypatch))
    assert len(want) >= 22 and got == want
    assert got["transform_type"][3] == cli.TRANSFORM_TYPES == j_cli.TRANSFORM_TYPES
    for tt in cli.TRANSFORM_TYPES:
        a = ["-a", "tiny_resnet", "--transform_type", tt, "--expand_num", "2",
             "--data_expanded_dir", "x", "y", "--wd", "1e-4"]
        assert vars(cli.parse_args(a)) == vars(j_cli.parse_args(a))
    with pytest.raises(SystemExit), contextlib.redirect_stderr(io.StringIO()):
        cli.parse_args(["--transform_type", "blur"])


def test_the_cli_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("DISTDIFF_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="DISTDIFF_PLATFORM=cpu"):
        cli.main(["-a", "tiny_resnet", "--checkpoint", str(tmp_path / "never_written")])
    assert not os.path.exists(tmp_path / "never_written")


def test_module_runs_as_a_program():
    out = subprocess.run([sys.executable, "-m", "distdiff_tpu_torch.cli.train_transform",
                          "--help"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "--transform_type" in out.stdout, out.stderr


@pytest.mark.parametrize("transform_type", ["default", "autoaug", "randaug", "cutout"])
def test_transform_level_runs_match_the_jax_cli(files, tmp_path, transform_type):
    dirs = run_both(files, str(tmp_path), transform_type, 2)
    assert_logs_match(files, dirs, 2)


def test_expanded_run_matches_the_jax_cli_and_holds_the_ratio(files, tmp_path):
    """``--data_expanded_dir`` at ``--expand_num 1``: 12 originals and their
    12 ``_expand_0`` images, 24 = 12 x 2 as the assert demands; at
    ``--expand_num 3`` the tree holds 24 expanded images where 36 are due,
    and both CLIs refuse before training."""
    extra = ["--data_expanded_dir", files["expanded"]]
    dirs = run_both(files, str(tmp_path), "default", 1, extra)
    assert_logs_match(files, dirs, 1)
    bad = argv(files, str(tmp_path / "bad"), "default", 1, extra)
    bad[bad.index("--expand_num") + 1] = "3"
    for mod in (j_cli, cli):
        with _env({"DISTDIFF_PLATFORM": "cpu"}), pytest.raises(
                AssertionError, match="expansion ratio mismatch: 36 != 48"):
            mod.main(bad)
    assert not os.path.exists(tmp_path / "bad")
