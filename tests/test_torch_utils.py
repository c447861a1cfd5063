"""The port's helpers against the JAX package's on the CPU: the classname
tables and lookups, the prompt banks, ``make_grid`` and the pixels
``save_image_grid`` writes (decoded), ``PhaseTimer``'s report and the
memory counters' keys, and the batch-mean energies with their gradients
(fp32 on both sides, held at 1e-6 relative)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from distdiff_tpu.guidance import energy as j_energy
from distdiff_tpu.utils import classnames as j_classnames
from distdiff_tpu.utils import prompts as j_prompts
from distdiff_tpu.utils import visualize as j_visualize
from distdiff_tpu_torch.guidance import energy
from distdiff_tpu_torch.parallel import read_png
from distdiff_tpu_torch.utils import classnames, profiling, prompts, visualize

torch.set_num_threads(1)


def test_classname_tables_and_lookups_are_the_jax_packages():
    for name in ("CIFAR10_CLASSES", "CIFAR100_CLASSES", "IMAGENET_CLASSES",
                 "IMAGENET_R_CLASSES", "COUNTRY211_CLASSES", "CLASS_TO_SYNSET",
                 "SYNSET_TO_CLASS"):
        assert getattr(classnames, name) == getattr(j_classnames, name), name
    assert len(classnames.IMAGENET_CLASSES) == 1000
    for label in ("tench", "goldfish", *classnames.IMAGENET_CLASSES[500::499]):
        wnid = classnames.imagenet_class_to_synset(label)
        assert wnid == j_classnames.imagenet_class_to_synset(label)
        assert classnames.imagenet_synset_to_class(wnid) == label
    for ds in ("caltech-101", "stanford_cars", "imagenet", "country211", "breastmnist",
               "unknown"):
        assert classnames.get_num_classes(ds) == j_classnames.get_num_classes(ds)


def test_prompt_banks_are_the_jax_packages():
    names = ["dog", "sea urchin"]
    assert prompts.expand_templates(names) == j_prompts.expand_templates(names)
    assert prompts.expand_templates(names, ["{} texture."]) == \
        j_prompts.expand_templates(names, ["{} texture."])
    assert prompts.zero_shot_prompts(names) == j_prompts.zero_shot_prompts(names)
    assert prompts.CUPL_PROMPTS == j_prompts.CUPL_PROMPTS
    for ds in prompts.PHOTO_PROMPTS:
        assert prompts.return_photo_prompts(ds) == j_prompts.return_photo_prompts(ds)
    for ds in prompts.CUPL_PROMPTS:
        assert prompts.cupl_prompts(ds) == j_prompts.cupl_prompts(ds)
    with pytest.raises(KeyError):
        prompts.return_photo_prompts("no such dataset")


@pytest.mark.parametrize("n,ncols,pad", [(5, 3, 1), (4, None, 2), (7, 2, 0), (1, None, 3)])
def test_make_grid_matches_jax(n, ncols, pad):
    images = np.random.default_rng(n).uniform(-0.2, 1.2, (n, 6, 9, 3)).astype(np.float32)
    got = visualize.make_grid(images, ncols=ncols, pad=pad)
    want = j_visualize.make_grid(images, ncols=ncols, pad=pad)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_save_image_grid_writes_the_jax_pixels(tmp_path):
    """The JAX package writes through PIL, the port through its own PNG
    encoder: the decoded pixels are equal (images outside [0, 1] clipped,
    rounding ``x * 255 + 0.5`` down)."""
    images = np.random.default_rng(0).uniform(-0.2, 1.2, (5, 7, 11, 3)).astype(np.float32)
    images[0, 0, 0] = [0.5 / 255, 254.5 / 255, 1.0]  # on the rounding edges
    port, jax_ = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
    visualize.save_image_grid(port, images, ncols=2)
    j_visualize.save_image_grid(jax_, images, ncols=2)
    got = read_png(port)
    want = np.asarray(Image.open(jax_))
    assert got.shape == want.shape == (3 * 9 + 2, 2 * 13 + 2, 3)
    assert np.array_equal(got, want)
    assert np.array_equal(np.asarray(Image.open(port)), want)


def test_phase_timer_reports_as_jax(monkeypatch):
    from distdiff_tpu.utils.profiling import PhaseTimer as JPhaseTimer

    clock = iter([0.0, 1.5, 2.0, 2.25, 3.0, 3.5, 4.0, 4.75] * 2)
    monkeypatch.setattr("time.perf_counter", lambda: next(clock))
    timers = (profiling.PhaseTimer(sync=False), JPhaseTimer(sync=False))
    for t in timers:
        for name in ("encode", "denoise", "encode", "decode"):
            with t.phase(name):
                pass
    port, jax_ = timers
    assert port.report() == jax_.report()
    assert dict(port.counts) == {"encode": 2, "denoise": 1, "decode": 1}
    assert port.report().splitlines()[0].startswith("encode ")
    monkeypatch.undo()
    # with sync on and no card in use, nothing to wait for
    with profiling.PhaseTimer().phase("x"):
        pass


def test_memory_stats_and_trace_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert profiling.device_memory_stats() == {}
    with profiling.trace(None):
        pass
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


@pytest.fixture(scope="module")
def energy_inputs():
    rng = np.random.default_rng(3)
    f = rng.standard_normal((6, 12)).astype(np.float32)
    t = np.array([0, 2, 1, 2, 0, 3], np.int32)
    gp = rng.standard_normal((4, 12)).astype(np.float32)
    lp = rng.standard_normal((4, 3, 12)).astype(np.float32)
    return f, t, gp, lp


@pytest.mark.parametrize("which", ["global", "local", "hierarchical", "hierarchical_global",
                                   "hierarchical_weighted"])
def test_batch_mean_energies_and_gradients_match_jax(energy_inputs, which):
    f, t, gp, lp = energy_inputs
    if which == "global":
        jfn, fn, args = j_energy.global_energy, energy.global_energy, (gp,)
    elif which == "local":
        jfn, fn, args = j_energy.local_energy, energy.local_energy, (lp,)
    else:
        jfn, fn = j_energy.hierarchical_energy, energy.hierarchical_energy
        args = {"hierarchical": (gp, lp), "hierarchical_global": (gp, None),
                "hierarchical_weighted": (gp, lp, 0.3, 2.0)}[which]
    want, jgrad = jax.value_and_grad(
        lambda x: jfn(x, jnp.asarray(t), *args))(jnp.asarray(f))
    x = torch.from_numpy(f).requires_grad_(True)
    targs = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args)
    got = fn(x, torch.from_numpy(t).long(), *targs)
    got.backward()
    assert got.ndim == 0
    assert got.item() == pytest.approx(float(want), rel=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-7)
    per = energy.hierarchical_energy_per_sample(
        torch.from_numpy(f), torch.from_numpy(t).long(),
        *(targs if which.startswith("hier") else
          (targs[0], None) if which == "global" else (None, targs[0])))
    assert got.item() == pytest.approx(per.mean().item(), rel=1e-6)
