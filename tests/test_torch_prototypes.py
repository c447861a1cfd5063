"""The port's prototype extraction against the JAX package's: guide features
from the tiny guide on the same weights, the average-linkage clustering and
``build_prototypes`` on the same features, and the normalised ``.npz``
round trip."""

import jax
import numpy as np
import pytest
import torch

from distdiff_tpu.models.guide import create_model as j_create_model
from distdiff_tpu.prototypes import agglomerative_average as j_agglomerative_average
from distdiff_tpu.prototypes import build_prototypes as j_build_prototypes
from distdiff_tpu.prototypes import extract_features as j_extract_features
from distdiff_tpu.prototypes import load_prototypes as j_load_prototypes
from distdiff_tpu.prototypes import normalize_prototypes as j_normalize_prototypes
from distdiff_tpu_torch.models.guide import create_model
from distdiff_tpu_torch.models.guide.resnet import tiny_resnet_config
from distdiff_tpu_torch.prototypes import (
    agglomerative_average,
    build_prototypes,
    extract_features,
    load_prototypes,
    normalize_prototypes,
    save_prototypes,
)
from distdiff_tpu_torch.weights.from_jax import state_dict_from_jax

torch.set_num_threads(1)


def _features(n, d, classes, seed):
    rng = np.random.RandomState(seed)
    centres = rng.randn(classes, 3, d) * 2.0
    labels = rng.randint(0, classes, n)
    which = rng.randint(0, 3, n)
    f = centres[labels, which] + 0.3 * rng.randn(n, d)
    return (f / np.linalg.norm(f, axis=1, keepdims=True)).astype(np.float32), labels


@pytest.mark.parametrize("n,k", [(30, 3), (7, 2), (3, 3), (12, 5)])
def test_clustering_matches_jax(n, k):
    x, _ = _features(n, 16, 1, seed=n)
    # the same float64 Lance-Williams updates in the same order: exact
    np.testing.assert_array_equal(agglomerative_average(x, k), j_agglomerative_average(x, k))


def test_build_and_normalize_prototypes_match_jax():
    feats, labels = _features(90, 24, 6, seed=1)
    labels[labels == 5] = 4  # class 5 has no sample: its prototypes stay zero
    labels[0] = 3
    labels[labels == 3] = 2
    labels[0] = 3  # class 3 has one sample: its one mean repeats K times
    got = build_prototypes(feats, labels, 6, k=3)
    want = j_build_prototypes(feats, labels, 6, k=3)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=1e-7, rtol=0)  # same numpy arithmetic
    assert not got[0][5].any() and np.all(got[1][3] == got[1][3][0])
    for g, w in zip(normalize_prototypes(*got), j_normalize_prototypes(*want)):
        np.testing.assert_allclose(g, w, atol=1e-7, rtol=0)


def test_save_load_round_trip_matches_jax(tmp_path):
    gp, lp = build_prototypes(*_features(40, 8, 4, seed=2), 4, k=2)
    path = str(tmp_path / "protos" / "class_wise_prototype_K2.npz")
    save_prototypes(path, gp, lp)
    for g, w in zip(load_prototypes(path), j_load_prototypes(path[:-4])):
        np.testing.assert_array_equal(g, w)


def test_extract_features_matches_jax():
    jg = j_create_model("tiny_resnet", num_classes=3, input_size=32)
    guide = create_model("tiny_resnet", num_classes=3, device="cpu")
    guide.module.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, jg.variables), tiny_resnet_config(3)))
    rng = np.random.RandomState(4)
    batches = [(rng.rand(4, 32, 32, 3).astype(np.float32), rng.randint(0, 3, 4))
               for _ in range(3)]
    feats, labels = extract_features(guide.encode_image, batches, device="cpu")
    want_f, want_l = j_extract_features(jax.jit(lambda x: jg.encode_image(x)), batches)
    assert feats.shape == (12, guide.feature_dim) and feats.dtype == np.float32
    np.testing.assert_array_equal(labels, want_l)
    # fp32 guide on the same weights, L2-normalised: summation order only
    np.testing.assert_allclose(feats, want_f, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(feats, axis=1), 1.0, atol=1e-6)
    gp, lp = build_prototypes(feats, labels, 3, k=2)
    assert gp.shape == (3, guide.feature_dim) and lp.shape == (3, 2, guide.feature_dim)
