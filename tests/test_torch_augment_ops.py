"""The port's numpy image ops against Pillow and against the JAX package's
PIL ops, at tolerance 0 (the same uint8 bytes): ``data/transforms.py``'s
``affine`` sampler against ``Image.transform(AFFINE)`` and ``rotate``
against ``Image.rotate``, at BILINEAR and NEAREST, on 2-D and RGB arrays
of odd and even sizes from 5 to 240 px; ``train/augment/pillow.py``'s
bank against ``ImageOps`` and ``ImageEnhance``; each severity op of
``pil_ops`` and each ``apply_op`` of ``tv_policies`` against the JAX
package's on the same generator, which must also be left in the same
state."""

import numpy as np
import pytest
import torch
from PIL import Image, ImageEnhance, ImageOps

from distdiff_tpu.train.augment import pil_ops as j_pil_ops
from distdiff_tpu.train.augment import tv_policies as j_tv
from distdiff_tpu_torch.data import transforms as tf
from distdiff_tpu_torch.train.augment import pil_ops, pillow, tv_policies

torch.set_num_threads(1)

RESAMPLE = {"nearest": (tf.NEAREST, Image.NEAREST), "bilinear": (tf.BILINEAR, Image.BILINEAR)}


def _image(h, w, seed, flat=False):
    """A smooth gradient with noise: every value class, and edges that
    interpolation and the SMOOTH filter see."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    bands = [(x * (3 + k) + y * (2 + k) + 40 * np.sin(x / (3 + k))) % 256 for k in range(3)]
    img = np.clip(np.stack(bands, -1) + rng.integers(-25, 26, (h, w, 3)), 0, 255)
    img = img.astype(np.uint8)
    return img[..., 0] if flat else img


def _sizes(seed, n):
    rng = np.random.default_rng(seed)
    sizes = [(5, 6), (6, 5), (240, 240), (239, 64), (31, 200)]
    return sizes + [tuple(int(v) for v in rng.integers(5, 241, 2)) for _ in range(n)]


@pytest.mark.parametrize("layout", ["2d", "rgb"])
@pytest.mark.parametrize("resample", ["nearest", "bilinear"])
def test_affine_and_rotate_equal_pillow(resample, layout):
    """Shears, translations and general matrices through ``affine``, and
    ``rotate`` at non-integer angles and at multiples of 90 (Pillow's copy
    and transposes), each against Pillow."""
    ours, theirs = RESAMPLE[resample]
    flat = layout == "2d"
    rng = np.random.default_rng(1 + 2 * flat + (resample == "nearest"))
    for i, (h, w) in enumerate(_sizes(int(rng.integers(100)), 7)):
        img = _image(h, w, i, flat)
        pim = Image.fromarray(img)
        s = float(rng.uniform(-0.3, 0.3))
        t = float(int(rng.integers(-w // 2, w // 2 + 1)))
        general = tuple(float(v) for v in rng.uniform(-1.2, 1.2, 6) * [1, 1, w, 1, 1, h])
        for m in ((1, s, 0, 0, 1, 0), (1, 0, 0, s, 1, 0), (1, 0, t, 0, 1, 0),
                  (1, 0, 0, 0, 1, -t), general):
            want = np.asarray(pim.transform((w, h), Image.AFFINE, m, resample=theirs))
            np.testing.assert_array_equal(tf.affine(img, m, ours), want,
                                          err_msg=f"{h}x{w} {layout} {resample} {m}")
        for angle in (float(rng.uniform(-30, 30)), float(rng.uniform(-180, 180)), 1.0,
                      0.0, 90.0, 180.0, -90.0, 270.0, 450.0):
            want = np.asarray(pim.rotate(angle, resample=theirs))
            np.testing.assert_array_equal(tf.rotate(img, angle, ours), want,
                                          err_msg=f"{h}x{w} {layout} {resample} at {angle}")


def test_nearest_takes_pillows_fixed_point_not_the_exact_centre():
    """Pillow maps a sheared or rotated pixel in 16.16 fixed point, and its
    index then differs in places from the floor of the exact mapped centre
    (GridMask's 1-degree turn of a 200 px mask here): the sampler keeps
    Pillow's."""
    img = _image(200, 200, 0, flat=True)
    want = np.asarray(Image.fromarray(img).rotate(1, resample=Image.NEAREST))
    np.testing.assert_array_equal(tf.rotate(img, 1, tf.NEAREST), want)
    cos, sin = round(np.cos(np.radians(-1)), 15), round(np.sin(np.radians(-1)), 15)
    yo, xo = np.mgrid[0:200, 0:200] + 0.5
    xi = np.floor(cos * (xo - 100) + sin * (yo - 100) + 100).astype(int)
    yi = np.floor(-sin * (xo - 100) + cos * (yo - 100) + 100).astype(int)
    inside = (xi >= 0) & (xi < 200) & (yi >= 0) & (yi < 200)
    exact = np.where(inside, img[yi.clip(0, 199), xi.clip(0, 199)], 0)
    assert (exact != want).any()


def test_affine_refuses_what_pillow_leaves_fixed_point_for():
    with pytest.raises(ValueError, match="32768"):
        tf.affine(_image(8, 8, 0), (1, 0.5, 40000, 0, 1, 0), tf.NEAREST)
    with pytest.raises(ValueError, match="BILINEAR"):
        tf.affine(_image(8, 8, 0), (1, 0, 0, 0, 1, 0), 3)


def _bank_images():
    """RGB images of many kinds: noise, narrow ranges, one-valued bands,
    tiny sizes (the SMOOTH filter copies an image under 3 px), and 2-D
    ones for the ImageOps functions."""
    rng = np.random.default_rng(7)
    out = []
    for k, (h, w) in enumerate(_sizes(3, 5) + [(1, 1), (2, 9), (3, 3), (9, 2)]):
        kind = k % 4
        if kind == 0:
            img = rng.integers(0, 256, (h, w, 3))
        elif kind == 1:
            img = rng.integers(40, 90, (h, w, 3))
        elif kind == 2:
            img = np.full((h, w, 3), int(rng.integers(256)))
            img[..., 1] = rng.integers(0, 3, (h, w))
        else:
            img = _image(h, w, k)
        out.append(img.astype(np.uint8))
    return out


FACTORS = (0.0, 0.1, 0.55, 1.0, 1.9, -0.4, 2.7)


@pytest.mark.parametrize("op", ["autocontrast", "equalize", "posterize", "solarize",
                                "invert", "brightness", "color", "contrast", "sharpness"])
def test_pillow_bank_equals_pillow(op):
    for i, img in enumerate(_bank_images()):
        pim = Image.fromarray(img)
        if op in ("autocontrast", "equalize", "invert"):
            cases = [(getattr(pillow, op)(img), getattr(ImageOps, op)(pim))]
            flat = img[..., i % 3]
            cases.append((getattr(pillow, op)(flat), getattr(ImageOps, op)(Image.fromarray(flat))))
        elif op == "posterize":
            cases = [(pillow.posterize(img, b), ImageOps.posterize(pim, b)) for b in range(1, 9)]
        elif op == "solarize":
            cases = [(pillow.solarize(img, t), ImageOps.solarize(pim, t))
                     for t in (0, 1, 127.5, 128, 200.3, 255, 256)]
        else:
            enhancer = getattr(ImageEnhance, op.capitalize())(pim)
            cases = [(getattr(pillow, op)(img, f), enhancer.enhance(f)) for f in FACTORS]
        for got, want in cases:
            want = np.asarray(want)
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"{op} on image {i} {img.shape}")


SEVERITY_OPS = [op.__name__ for op in j_pil_ops.AUGMENTATIONS_ALL]


@pytest.mark.parametrize("name", SEVERITY_OPS)
def test_severity_ops_equal_jax_on_one_generator(name):
    """Each op of ``AUGMENTATIONS_ALL`` at severities 1 and 3 against the
    JAX package's: the same bytes, and the generator left where the JAX
    op leaves it. Non-square images show ``translate_x`` scaling by the
    width."""
    assert [op.__name__ for op in pil_ops.AUGMENTATIONS_ALL] == SEVERITY_OPS
    assert [op.__name__ for op in pil_ops.AUGMENTATIONS] == [
        op.__name__ for op in j_pil_ops.AUGMENTATIONS]
    ours, theirs = getattr(pil_ops, name), getattr(j_pil_ops, name)
    for i, (h, w) in enumerate([(9, 40), (40, 9), (32, 32), (61, 47), (224, 224)]):
        img = _image(h, w, i)
        for s in range(4):
            for severity in (1, 3):
                r1, r2 = np.random.default_rng((s, i)), np.random.default_rng((s, i))
                got = ours(img, severity, rng=r1)
                want = np.asarray(theirs(Image.fromarray(img), severity, rng=r2))
                np.testing.assert_array_equal(got, want, err_msg=f"{name} {h}x{w} seed {s}")
                assert r1.random() == r2.random()
    assert pil_ops.sample_level(3, np.random.default_rng(5)) == j_pil_ops.sample_level(
        3, np.random.default_rng(5))


@pytest.mark.parametrize("space", ["autoaugment", "randaugment"])
def test_apply_op_equals_jax_over_the_space(space):
    """Every op of torchvision's space at several of its bins, both signs,
    on non-square images (the translations' bins scale by height and
    width), against the JAX package's ``apply_op``."""
    auto = space == "autoaugment"
    bins = 10 if auto else 31
    for i, (h, w) in enumerate([(23, 57), (64, 48), (32, 32)]):
        img = _image(h, w, 20 + i)
        ours = tv_policies.augmentation_space(bins, h, w, include_identity=not auto,
                                              include_invert=auto)
        theirs = j_tv.augmentation_space(bins, h, w, include_identity=not auto,
                                         include_invert=auto)
        assert list(ours) == list(theirs)
        for name, (mags, signed) in ours.items():
            np.testing.assert_array_equal(mags, theirs[name][0])
            assert signed == theirs[name][1]
            picks = [float(mags[k]) for k in (1, bins // 2, bins - 1)] if mags.ndim else [0.0]
            for mag in picks + ([-m for m in picks] if signed else []):
                got = tv_policies.apply_op(img, name, mag)
                want = np.asarray(j_tv.apply_op(Image.fromarray(img), name, mag))
                np.testing.assert_array_equal(got, want, err_msg=f"{name} at {mag}, {h}x{w}")
    assert tv_policies.CIFAR10_POLICY == j_tv.CIFAR10_POLICY
    with pytest.raises(ValueError, match="unknown op"):
        tv_policies.apply_op(_image(5, 5, 0), "Blur", 1.0)
