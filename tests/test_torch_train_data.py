"""The training side of the port's data and records against the JAX
package's on the CPU: ``RandomRotation`` against Pillow's rotate (exact),
``train_transform`` / ``eval_transform`` against the JAX package's on the
same ``np.random.Generator`` (exact: the same uint8 pixels and the same
float32 arithmetic), ``BatchLoader`` with ``shuffle`` over
``DatasetByClassNames``, ``ConcatDataset``, ``RepeatDataset`` and
``SubsetDataset`` on one PNG tree (exact), ``log.txt`` and ``results.yaml``
byte for byte, ``parse_logs`` on both packages' run directories, and the
training modules' imports with PIL, PyYAML, matplotlib and orbax absent."""

import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from distdiff_tpu.cli import parse_logs as j_parse_logs
from distdiff_tpu.data import datasets as jds
from distdiff_tpu.data import transforms as jtf
from distdiff_tpu.utils.logger import Logger as JLogger
from distdiff_tpu_torch.cli import parse_logs
from distdiff_tpu_torch.data import datasets as ds
from distdiff_tpu_torch.data import transforms as tf
from distdiff_tpu_torch.data.datasets import load_image
from distdiff_tpu_torch.train.loops import write_results
from distdiff_tpu_torch.utils import Logger, checkpoints

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ["ant", "bee", "cat"]


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    smooth = np.stack([(x * 5 + y * (2 + k) + 30 * np.sin(x / (4 + k))) % 256
                       for k in range(3)], -1)
    return np.clip(smooth + rng.integers(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8)


# ------------------------------------------------------------- transforms

@pytest.mark.parametrize("seed", range(4))
def test_rotation_equals_pillow_exactly(seed):
    rng = np.random.default_rng(seed)
    shapes = [tuple(int(v) for v in rng.integers(5, 90, 2)) for _ in range(6)] + [(33, 33)]
    angles = list(rng.uniform(-15, 15, 6)) + [0.0, 90.0, 180.0, 270.0, -360.0, 45.0]
    for i, (h, w) in enumerate(shapes):
        img = _image(h, w, seed * 10 + i)
        for angle in angles:
            want = np.asarray(Image.fromarray(img).rotate(angle, resample=Image.BILINEAR))
            got = tf.rotate(img, float(angle))
            np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} at {angle}")


@pytest.mark.parametrize("size", [32, 224])
def test_train_and_eval_transforms_match_jax_on_one_generator(size):
    for i, (h, w) in enumerate([(61, 47), (300, 410), (240, 180)]):
        img = _image(h, w, i)
        for epoch in range(3):
            draws = (7, epoch, i)
            want = jtf.train_transform(size)(Image.fromarray(img), np.random.default_rng(draws))
            got = tf.train_transform(size)(img, np.random.default_rng(draws))
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
        want = jtf.eval_transform(size)(Image.fromarray(img), np.random.default_rng(0))
        np.testing.assert_array_equal(tf.eval_transform(size)(img, None), want)


def test_flip_draws_as_jax():
    img = _image(9, 13, 0)
    for s in range(20):
        want = np.asarray(jtf.RandomHorizontalFlip()(Image.fromarray(img),
                                                     np.random.default_rng(s)))
        np.testing.assert_array_equal(tf.RandomHorizontalFlip()(img, np.random.default_rng(s)),
                                      want)


# ------------------------------------------------------------- datasets

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """An original tree ``{root}/orig/{class}/*.png`` and, in
    ``ExpansionDriver``'s layout, an expanded tree
    ``{root}/exp/{class}/{stem}_expand_{i}.png`` (one class left without a
    directory)."""
    root = tmp_path_factory.mktemp("tree")
    k = 0
    for ci, name in enumerate(CLASSES):
        for j in range(3):
            os.makedirs(root / "orig" / name, exist_ok=True)
            Image.fromarray(_image(20 + 3 * j, 26 - ci, k)).save(
                root / "orig" / name / f"im{j}.png")
            k += 1
        if name != "bee":
            os.makedirs(root / "exp" / name, exist_ok=True)
            for j in range(3):
                Image.fromarray(_image(24, 24, 100 + k)).save(
                    root / "exp" / name / f"im0_expand_{j}.png")
                k += 1
            (root / "exp" / name / "notes.txt").write_text("not an image")
    return str(root)


def _both(tree, expand_num=None):
    """(port, JAX) datasets: original ⊕ expanded, repeated and subset."""
    out = []
    for pkg, tfm in ((ds, tf), (jds, jtf)):
        orig = pkg.DatasetByClassNames(os.path.join(tree, "orig"), CLASSES, tfm.train_transform(16))
        exp = pkg.DatasetByClassNames(os.path.join(tree, "exp"), CLASSES, tfm.train_transform(16),
                                      expand_num=expand_num)
        cat = pkg.ConcatDataset([orig, exp])
        out.append(pkg.ConcatDataset([cat, pkg.SubsetDataset(pkg.RepeatDataset(orig, 2),
                                                              [8, 1, 17])]))
    return out


def test_expanded_tree_reader_matches_jax(tree):
    for n in (None, 1, 2):
        port = ds.DatasetByClassNames(os.path.join(tree, "exp"), CLASSES, expand_num=n)
        jax_ = jds.DatasetByClassNames(os.path.join(tree, "exp"), CLASSES, expand_num=n)
        assert port.image_paths == jax_.image_paths and port.labels == jax_.labels
        assert len(port) == 2 * (3 if n is None else n)


@pytest.mark.parametrize("drop_last", [False, True])
def test_shuffled_loader_matches_jax_over_epochs(tree, drop_last, monkeypatch):
    # the per-item draws follow each package's data seed, which a CLI run
    # earlier in the same process may have set (set_seed): the same here
    for pkg in (ds, jds):
        monkeypatch.setattr(pkg, "_DATA_SEED", [0])
    port, jax_ = _both(tree, expand_num=2)
    assert len(port) == len(jax_) == 9 + 4 + 3
    pl = ds.BatchLoader(port, 5, shuffle=True, seed=3, drop_last=drop_last, num_threads=2)
    # (the JAX loader needs four threads: it assembles batches on its pool)
    jl = jds.BatchLoader(jax_, 5, shuffle=True, seed=3, drop_last=drop_last, num_threads=4)
    assert len(pl) == len(jl) == (3 if drop_last else 4)
    for epoch in range(2):
        got, want = list(pl), list(jl)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        if not drop_last:
            assert got[-1][2].tolist() == [True, False, False, False, False]
    assert pl.epoch == jl.epoch == 2


def test_loader_collate_takes_the_items_and_batch_size(tree):
    port, _ = _both(tree)
    seen = []

    def collate(items, bs):
        seen.append((len(items), bs))
        return len(items)
    assert list(ds.BatchLoader(port, 7, collate=collate, num_threads=1)) == [7, 7, 4]
    assert seen == [(7, 7), (7, 7), (4, 7)]


def test_load_image_refusal_names_the_png_copy_route(tmp_path):
    path = str(tmp_path / "photo.jpg")
    Image.fromarray(_image(8, 8, 0)).save(path, format="JPEG")
    with pytest.raises(ValueError, match="PNG copy") as e:
        load_image(path)
    assert 'Image.open(p).convert("RGB").save(q)' in str(e.value)
    # a copy made so reads as the JAX package's load_image reads the JPEG
    copy = str(tmp_path / "photo.png")
    Image.open(path).convert("RGB").save(copy)
    np.testing.assert_array_equal(load_image(copy), np.asarray(jds.load_image(path)))


# ------------------------------------------------------------- records

LOG_ROWS = [[0.1, 2.302585, 2.2, 10.0, 12.5], [0.05, 1.0000004, 0.9999996, 66.666667, 1e-7],
            [0.0, 1e-17, 123456.789, 100.0, 0.0]]


@pytest.mark.parametrize("resume", [False, True])
def test_log_txt_is_byte_equal_to_jax(tmp_path, resume):
    names = ["Learning Rate", "Train Loss", "Valid Loss", "Train Acc.", "Valid Acc."]
    paths = []
    for cls, sub in ((Logger, "port"), (JLogger, "jax")):
        os.makedirs(tmp_path / sub)
        path = str(tmp_path / sub / "log.txt")
        lg = cls(path, title="distdiff")
        lg.set_names(names)
        lg.append(LOG_ROWS[0])
        lg.close()
        if resume:
            lg = cls(path, title="distdiff", resume=True)
            lg.set_names(names)
            for row in LOG_ROWS[1:]:
                lg.append(row)
            assert lg.numbers["Train Loss"][0] == 2.302585
            lg.close()
        paths.append(path)
    port, jax_ = (open(p, "rb").read() for p in paths)
    assert port == jax_ and port.count(b"\n") == (4 if resume else 2)


@pytest.mark.parametrize("best,last", [(12.5, 10.0), (33.33333333333333, 100.0),
                                       (1e-17, 0.0), (66.66666666666667, 5e-324),
                                       (float("nan"), float("inf"))])
def test_results_yaml_is_byte_equal_to_jax(tmp_path, best, last):
    result = {"best_accuracy": best, "last_accuracy": last}
    write_results(str(tmp_path / "port.yaml"), result)
    with open(tmp_path / "jax.yaml", "w") as f:
        yaml.dump(result, f)
    assert open(tmp_path / "port.yaml", "rb").read() == open(tmp_path / "jax.yaml", "rb").read()
    got = parse_logs.read_results(str(tmp_path / "jax.yaml"))
    want = yaml.safe_load(open(tmp_path / "jax.yaml"))
    assert got.keys() == want.keys()
    for k in got:
        assert (got[k] == want[k]) or (got[k] != got[k] and want[k] != want[k])


def test_parse_logs_reads_both_packages_runs_alike(tmp_path):
    exp = tmp_path / "exp"
    for i, acc in enumerate((41.0, 43.5, 47.25)):
        os.makedirs(exp / f"seed{i}")
        if i == 0:  # a run of the JAX trainer
            with open(exp / "seed0" / "results.yaml", "w") as f:
                yaml.dump({"best_accuracy": acc, "last_accuracy": acc - 1}, f)
        elif i == 1:  # a run of the port's
            write_results(str(exp / "seed1" / "results.yaml"),
                          {"best_accuracy": acc, "last_accuracy": acc - 1})
        else:  # a legacy log
            (exp / "seed2" / "log.txt").write_text(f"...\nThe best performance:{acc}\n")
    os.makedirs(exp / "empty")
    outs = []
    for mod in (parse_logs, j_parse_logs):
        for argv in ([str(exp), "--multi"], [str(exp / "seed1")], [str(exp / "empty")]):
            buf = io.StringIO()
            with redirect_stdout(buf):
                perfs = mod.main(argv)
            outs.append((perfs, buf.getvalue()))
    assert outs[:3] == outs[3:]
    assert outs[0][0] == [41.0, 43.5, 47.25]
    assert "Average  of 3 files is 43.92 +- 2.57" in outs[0][1]


def test_resuming_from_an_orbax_directory_names_the_route(tmp_path):
    os.makedirs(tmp_path / "checkpoint")
    with pytest.raises(NotImplementedError, match="load_jax_train_state"):
        checkpoints.load_train_checkpoint(str(tmp_path), state=None)
    assert checkpoints.load_train_checkpoint(str(tmp_path / "nothing"), state=None) is None


def test_training_modules_import_without_pil_yaml_matplotlib_or_orbax():
    """As on the card's machine: each of these set to None in
    ``sys.modules`` makes its import fail; the trainer's modules (the
    augmentations too) import and its CLIs parse."""
    code = (
        "import sys\n"
        "for m in ('PIL', 'yaml', 'matplotlib', 'orbax', 'jax', 'flax', 'optax'):\n"
        "    sys.modules[m] = None\n"
        "import distdiff_tpu_torch.cli.train as t, distdiff_tpu_torch.cli.train_expanded\n"
        "import distdiff_tpu_torch.cli.parse_logs, distdiff_tpu_torch.train\n"
        "import distdiff_tpu_torch.utils.checkpoints, distdiff_tpu_torch.utils.logger\n"
        "import distdiff_tpu_torch.utils.misc, distdiff_tpu_torch.weights.from_jax\n"
        "import distdiff_tpu_torch.train.augment, distdiff_tpu_torch.cli.train_transform as tt\n"
        "assert t.parse_args(['-a', 'tiny_resnet']).arch == 'tiny_resnet'\n"
        "assert tt.parse_args(['--transform_type', 'augmix']).transform_type == 'augmix'\n"
        "print('imported')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and "imported" in out.stdout, out.stderr
