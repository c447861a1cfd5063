"""The port's ``data/`` package against the JAX package (and PIL) on the
same files and seeds: the stdlib PNG decoder, the transforms (Pillow's
bilinear resize reproduced bit for bit), the dataset registry, and
``SDDataset`` with its text embeddings and its latent cache, which either
package reads from the other."""

import os
import pickle
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from distdiff_tpu.config import PipelineConfig as JPipelineConfig
from distdiff_tpu.data import SDDataset as JSDDataset
from distdiff_tpu.data import load_dataset as j_load_dataset
from distdiff_tpu.data import transforms as jT
from distdiff_tpu.models.tokenizer import HashTokenizer as JHashTokenizer
from distdiff_tpu.sampling import ExpansionPipeline as JExpansionPipeline
from distdiff_tpu_torch.config import PipelineConfig
from distdiff_tpu_torch.data import (
    DATASETS,
    ArrayDataset,
    BatchLoader,
    ImageListDataset,
    SDDataset,
    collate_sd,
    load_dataset,
    load_image,
    read_png,
    template_for,
)
from distdiff_tpu_torch.data import transforms as T
from distdiff_tpu_torch.models import HashTokenizer
from distdiff_tpu_torch.parallel import save_png
from distdiff_tpu_torch.sampling import ExpansionPipeline
from distdiff_tpu_torch.weights.from_jax import state_dict_from_jax
from torch_parity import jax_init_params

torch.set_num_threads(1)


def _rng_image(h, w, c, seed, smooth=False):
    rng = np.random.default_rng(seed)
    if smooth:  # gradients and waves, which PIL's adaptive filters encode
        y, x = np.mgrid[0:h, 0:w]
        img = np.stack([(x * 7 + y * (3 + k) + 40 * np.sin(x / (5 + k))) % 256
                        for k in range(c)], -1)
        return img.astype(np.uint8)
    return rng.integers(0, 256, (h, w, c), dtype=np.uint8)


# ------------------------------------------------------------------- PNG

@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "P+tRNS"])
@pytest.mark.parametrize("smooth", [False, True])
def test_png_decoder_equals_pil(tmp_path, mode, smooth):
    h, w = 37, 23  # odd sizes
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}.get(mode, 1)
    arr = _rng_image(h, w, c, seed=len(mode), smooth=smooth)
    path = str(tmp_path / "x.png")
    if mode.startswith("P"):
        img = Image.fromarray(arr[:, :, 0] % 200, "L").convert("P")
        img.putpalette(list(np.random.default_rng(1).integers(0, 256, 200 * 3)))
        if mode == "P+tRNS":
            img.info["transparency"] = 5
        img.save(path)
    else:
        Image.fromarray(arr if c > 1 else arr[:, :, 0], mode).save(path)
    pil = Image.open(path)
    if not mode.startswith("P"):
        native = np.asarray(pil)
        np.testing.assert_array_equal(read_png(path), native.reshape(h, w, -1))
    np.testing.assert_array_equal(load_image(path), np.asarray(pil.convert("RGB")))
    assert load_image(path).shape == (h, w, 3) and load_image(path).dtype == np.uint8


def _filter_rows(arr, filters):
    """Encode ``[h, w, c]`` uint8 with the given scanline filter per row."""
    h, w, c = arr.shape
    x = arr.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        cur = x[y]
        up = x[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        f = filters[y]
        if f == 0:
            raw = cur
        elif f == 1:
            raw = cur - left
        elif f == 2:
            raw = cur - up
        elif f == 3:
            raw = cur - (left + up) // 2
        else:
            p = left + up - upleft
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
            raw = cur - pred
        out.append(bytes([f]) + (raw % 256).astype(np.uint8).tobytes())
    return b"".join(out)


def _png(arr, filters, color=None, interlace=0, depth=8):
    h, w, c = arr.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c] if color is None else color

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    header = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(_filter_rows(arr, filters)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("c", [1, 3, 4])
def test_png_decoder_takes_all_five_filters(tmp_path, c):
    arr = _rng_image(31, 17, c, seed=c, smooth=c == 3)
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png(arr, [y % 5 for y in range(31)]))
    np.testing.assert_array_equal(read_png(path), arr)
    np.testing.assert_array_equal(load_image(path), np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("filters", ["paeth", "average", "mixed"])
def test_png_decoder_on_threads_equals_pil(tmp_path, filters):
    """Files with Paeth or Average rows (undone by anti-diagonals, one
    decode at a time) decoded on four threads at once, in tall, wide, one
    row and one column images."""
    from concurrent.futures import ThreadPoolExecutor

    rows = {"paeth": lambda y: 4, "average": lambda y: 3, "mixed": lambda y: (4, 3, 1, 2, 0)[y % 5]}
    paths = []
    for i, (h, w) in enumerate([(40, 9), (9, 40), (1, 23), (23, 1), (17, 17), (30, 31)]):
        arr = _rng_image(h, w, 3, seed=i, smooth=i % 2 == 0)
        paths.append(str(tmp_path / f"{i}.png"))
        with open(paths[-1], "wb") as f:
            f.write(_png(arr, [rows[filters](y) for y in range(h)]))
    with ThreadPoolExecutor(4) as ex:
        got = list(ex.map(load_image, paths * 3))
    for path, img in zip(paths * 3, got):
        np.testing.assert_array_equal(img, np.asarray(Image.open(path).convert("RGB")))


def test_png_decoder_refuses_what_it_does_not_take(tmp_path):
    arr = _rng_image(9, 7, 3, seed=0)
    cases = {
        "jpeg": lambda p: Image.fromarray(arr).save(p, format="JPEG"),
        "16-bit": lambda p: Image.fromarray(arr[:, :, 0].astype(np.uint16) * 200).save(
            p, format="PNG"),
        "1-bit": lambda p: Image.fromarray(arr[:, :, 0] > 128).save(p, format="PNG"),
        "interlaced": lambda p: open(p, "wb").write(_png(arr, [0] * 9, interlace=1)),
    }
    for name, write in cases.items():
        path = str(tmp_path / f"{name}.img")
        write(path)
        with pytest.raises(ValueError, match="save/vae_embedding") as e:
            load_image(path)
        assert "save/prototypes" in str(e.value), name
    bad = bytearray(_png(arr, [0] * 9))
    bad[40] ^= 1  # inside the IDAT chunk: its CRC no longer holds
    with open(tmp_path / "crc.png", "wb") as f:
        f.write(bytes(bad))
    with pytest.raises(ValueError, match="CRC"):
        read_png(str(tmp_path / "crc.png"))


def test_driver_read_png_is_the_decoder(tmp_path):
    from distdiff_tpu_torch.parallel import driver

    assert driver.read_png is read_png
    img = np.random.default_rng(0).random((5, 9, 3)).astype(np.float32)
    save_png(str(tmp_path / "x.png"), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "x.png")),
                                  np.asarray(Image.open(tmp_path / "x.png")))


# ------------------------------------------------------------- transforms

SIZES = [(300, 400), (401, 203), (37, 60), (512, 512), (20, 700), (1000, 333)]


@pytest.mark.parametrize("hw", SIZES)
def test_resize_equals_pillow_bilinear(hw):
    arr = _rng_image(*hw, 3, seed=hw[0], smooth=hw[0] % 2 == 0)
    for size in (32, 224, 512, (64, 48), (224, 224)):
        want = np.asarray(jT.Resize(size)(Image.fromarray(arr), None))
        got = T.Resize(size)(arr, None)
        np.testing.assert_array_equal(got, want)  # bit for bit: tolerance 0


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("seed", [0, 1])
def test_sd_and_prototype_transforms_equal_jax(hw, seed):
    arr = _rng_image(*hw, 3, seed=seed + hw[1], smooth=seed == 1)
    pil = Image.fromarray(arr)
    for size, center in ((512, False), (32, False), (48, True)):
        want = jT.sd_transform(size, center)(pil, np.random.default_rng(seed))
        got = T.sd_transform(size, center)(arr, np.random.default_rng(seed))
        assert got.dtype == want.dtype == np.float32 and got.shape == (size, size, 3)
        np.testing.assert_array_equal(got, want)  # the same operations: exact
    want = jT.prototype_transform(224)(pil, np.random.default_rng(seed))
    np.testing.assert_array_equal(T.prototype_transform(224)(arr, None), want)


@pytest.mark.parametrize("hw", [(20, 30), (50, 10), (64, 64)])
def test_crops_at_and_past_the_edges_equal_jax(hw):
    arr = _rng_image(*hw, 3, seed=3)
    pil = Image.fromarray(arr)
    for s in (16, 40):
        np.testing.assert_array_equal(T.CenterCrop(s)(arr, None),
                                      np.asarray(jT.CenterCrop(s)(pil, None)))
        np.testing.assert_array_equal(T.RandomCrop(s)(arr, np.random.default_rng(s)),
                                      np.asarray(jT.RandomCrop(s)(pil, np.random.default_rng(s))))


def test_array_dataset_and_batch_loader_pad_the_tail():
    images = _rng_image(5, 12, 12, seed=0).reshape(5, 12, 12)
    ds = ArrayDataset(images, np.arange(5), T.Compose([T.ToArray()]))
    batches = list(BatchLoader(ds, batch_size=2, num_threads=2))
    assert [b[0].shape for b in batches] == [(2, 12, 12, 3)] * 3
    np.testing.assert_array_equal(batches[-1][2], [True, False])
    np.testing.assert_array_equal(batches[-1][1], [4, 4])
    np.testing.assert_array_equal(batches[0][0][1, :, :, 0], images[1] / np.float32(255.0))


# --------------------------------------------------------------- registry

def _tiny_png(path, value=0):
    save_png(path, np.full((2, 3, 3), value / 255.0, np.float32))


def _write_tree(root, dataset, classes, train_dir="train", test_dir="test", n=(2, 1)):
    for split, count in ((train_dir, n[0]), (test_dir, n[1])):
        for ci, c in enumerate(classes):
            for i in range(count):
                _tiny_png(os.path.join(root, dataset, split, c, f"img_{i}.png"), ci)


def _same_loaded(got, want):
    assert got.classnames == want.classnames
    for a, b in ((got.train, want.train), (got.test, want.test)):
        assert a.image_paths == b.image_paths and list(a.labels) == list(b.labels)


def test_load_dataset_class_dir_tree_equals_jax(tmp_path):
    _write_tree(str(tmp_path), "imagenette2-320", ["n01_tench", "n02_dog", "b"],
                test_dir="val")
    _same_loaded(load_dataset("imagenette2-320", data_root=str(tmp_path)),
                 j_load_dataset("imagenette2-320", data_root=str(tmp_path)))
    _write_tree(str(tmp_path / "medmnist"), "pathmnist", ["x_y", "z"])
    got = load_dataset("pathmnist", data_root=str(tmp_path))
    _same_loaded(got, j_load_dataset("pathmnist", data_root=str(tmp_path)))
    assert got.classnames == ["x y", "z"] and set(DATASETS) >= {"pathmnist", "caltech-101"}


def test_load_dataset_caltech_drops_two_classes_as_jax(tmp_path):
    classes = [f"c_{i:03d}" for i in range(100)] + ["BACKGROUND_Google", "Faces_easy"]
    _write_tree(str(tmp_path), "caltech-101", classes, n=(1, 1))
    got = load_dataset("caltech-101", data_root=str(tmp_path))
    _same_loaded(got, j_load_dataset("caltech-101", data_root=str(tmp_path)))
    assert got.num_classes == 100 and "Faces easy" not in got.classnames


def test_load_dataset_split_files_equal_jax(tmp_path):
    root = tmp_path / "dtd"
    for c in ("banded", "zig_zag"):
        os.makedirs(root / "images" / c)
    os.makedirs(root / "labels")
    for name, lines in (("train1.txt", ["banded/a.jpg", "zig_zag/b.jpg"]),
                        ("val1.txt", ["zig_zag/c.jpg", ""]), ("test1.txt", ["banded/d.jpg"])):
        with open(root / "labels" / name, "w") as f:
            f.write("\n".join(lines) + "\n")
    _same_loaded(load_dataset("dtd", data_root=str(tmp_path)),
                 j_load_dataset("dtd", data_root=str(tmp_path)))
    with pytest.raises(ValueError, match="not supported"):
        load_dataset("mnist", data_root=str(tmp_path))


# -------------------------------------------------------------- SDDataset

SAMPLE = 32
CLASSES = ("alpha", "beta_cat")


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """A breastmnist-style PNG tree of odd-sized images, and the JAX and
    port pipelines on the same (JAX-initialised) weights."""
    root = tmp_path_factory.mktemp("data")
    for ci, c in enumerate(CLASSES):
        for k in range(3 - ci):
            h, w = (45, 37) if k % 2 else (29, 53)
            img = _rng_image(h, w, 3, seed=10 * ci + k, smooth=k == 0)
            base = root / "medmnist" / "breastmnist"
            os.makedirs(base / "train" / c, exist_ok=True)
            os.makedirs(base / "test" / c, exist_ok=True)
            Image.fromarray(img).save(base / "train" / c / f"img_{k}.png")
    with open(root / "breastmnist_le.pkl", "wb") as f:
        pickle.dump({"alpha": ["a photo of alpha", "alpha again", "third"],
                     "beta_cat": ["one beta cat"]}, f)
    jcfg = JPipelineConfig.tiny(sample_size=SAMPLE)
    jpipe = JExpansionPipeline.create(jcfg, params=jax_init_params(jcfg))
    params = jax.tree.map(np.asarray, jpipe.params)
    cfg = PipelineConfig.tiny(sample_size=SAMPLE)
    tpipe = ExpansionPipeline.create(cfg, device="cpu")
    tpipe.vae.load_state_dict(state_dict_from_jax(params["vae"], cfg.vae))
    tpipe.text_encoder.load_state_dict(state_dict_from_jax(params["text"], cfg.text_encoder))
    return str(root), jpipe, tpipe


def _encoders(toy):
    _, jpipe, tpipe = toy
    jtok, ttok = JHashTokenizer(1000, 16), HashTokenizer(1000, 16)
    j_text = jax.jit(lambda p, i: jpipe.encode_text(p, i))
    j_img = jax.jit(lambda p, x: jpipe.encode_images(p, x))

    def jax_fns():
        return (lambda prompts: np.asarray(j_text(jpipe.params, jnp.asarray(jtok(list(prompts))))),
                lambda im: np.asarray(j_img(jpipe.params, jnp.asarray(im))))

    def port_fns():
        return (lambda prompts: tpipe.encode_text(torch.from_numpy(ttok(list(prompts))).long())
                .numpy(),
                lambda im: tpipe.encode_images(torch.from_numpy(im)).numpy())
    return jax_fns(), port_fns()


def _refuse(_):
    raise AssertionError("the latent cache should have been read")


@pytest.mark.parametrize("language_enhance", [False, True])
def test_sd_dataset_matches_jax(toy, tmp_path, language_enhance):
    root = toy[0]
    (jt, ji), (tt, ti) = _encoders(toy)
    kw = dict(size=SAMPLE, data_root=root, encode_batch=2, language_enhance=language_enhance)
    want = JSDDataset("breastmnist", jt, ji, cache_root=str(tmp_path / "jax"), **kw)
    got = SDDataset("breastmnist", tt, ti, cache_root=str(tmp_path / "port"), **kw)
    assert got.class_names == want.class_names == ["alpha", "beta cat"]
    assert got.image_paths == want.image_paths and got.labels == want.labels
    # fp32 text encoder and VAE encoder on the same weights: summation order
    if language_enhance:
        assert [e.shape for e in got.class_embeds] == [(3, 16, 32), (1, 16, 32)]
        for g, w in zip(got.class_embeds, want.class_embeds):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0)
    else:
        assert got.class_embeds.shape == (2, 16, 32)
        np.testing.assert_allclose(got.class_embeds, want.class_embeds, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.uncond_embed, want.uncond_embed, atol=1e-5, rtol=0)
    assert got.latents.shape == (5, SAMPLE // 2, SAMPLE // 2, 4)
    # the same crops (RandomCrop draws) and the same VAE: 1e-5 on latents ~O(1)
    np.testing.assert_allclose(got.latents, want.latents, atol=1e-5, rtol=0)
    for i in range(5):
        g, w = got[i], want[i]
        assert (g.class_name, g.image_path, g.target) == (w.class_name, w.image_path, w.target)
        np.testing.assert_allclose(g.cond, np.asarray(w.cond), atol=1e-5, rtol=0)
    batch = collate_sd([got[i] for i in range(5)])
    assert batch["latents"].shape == (5, 16, 16, 4) and batch["cond"].shape == (5, 16, 32)
    assert list(batch["targets"]) == [0, 0, 0, 1, 1]


def test_latent_caches_are_read_across_packages(toy, tmp_path):
    root = toy[0]
    (jt, ji), (tt, ti) = _encoders(toy)
    kw = dict(size=SAMPLE, data_root=root, encode_batch=2)
    jax_ds = JSDDataset("breastmnist", jt, ji, cache_root=str(tmp_path / "a"), **kw)
    port_reads = SDDataset("breastmnist", tt, _refuse, cache_root=str(tmp_path / "a"), **kw)
    path = port_reads.cache_path("CompVis/stable-diffusion-v1-4", str(tmp_path / "a"))
    assert os.path.exists(path) and path.endswith("image_latents_32.npy")
    np.testing.assert_array_equal(port_reads.latents, jax_ds.latents)
    port_ds = SDDataset("breastmnist", tt, ti, cache_root=str(tmp_path / "b"), **kw)
    jax_reads = JSDDataset("breastmnist", jt, _refuse, cache_root=str(tmp_path / "b"), **kw)
    np.testing.assert_array_equal(jax_reads.latents, port_ds.latents)
    assert template_for("breastmnist") == "a breast ultrasound image of {}."


def test_latent_cache_is_keyed_on_the_model(toy, tmp_path):
    """An SD-1.5 latent cache at 1024 is not read under ``--model sdxl``
    (another VAE, scaled by 0.13025) nor ``sd21``: each model encodes and
    reads back its own file; SD-1.5's keeps the JAX package's name."""
    root, jpipe, _ = toy
    _, (tt, _) = _encoders(toy)

    def encoder(value):
        def encode(images):
            assert images.shape[1:] == (1024, 1024, 3)
            return np.full((len(images), 128, 128, 4), value, np.float32)
        return encode

    kw = dict(size=1024, data_root=root, encode_batch=4, cache_root=str(tmp_path))
    made = {model: SDDataset("breastmnist", tt, encoder(v), model=model, **kw)
            for model, v in (("sd15", 1.0), ("sdxl", 2.0), ("sd21", 3.0))}
    ckpt = "CompVis/stable-diffusion-v1-4"
    paths = {m: ds.cache_path(ckpt, str(tmp_path)) for m, ds in made.items()}
    assert [os.path.basename(p) for p in paths.values()] == [
        "image_latents_1024.npy", "image_latents_1024_sdxl.npy", "image_latents_1024_sd21.npy"]
    j_ds = JSDDataset.__new__(JSDDataset)
    j_ds.dataset_name, j_ds.size, j_ds.center_crop = "breastmnist", 1024, False
    assert paths["sd15"] == j_ds._cache_path(ckpt, str(tmp_path))
    for (model, ds), v in zip(made.items(), (1.0, 2.0, 3.0)):
        assert ds.latents.shape == (5, 128, 128, 4) and (ds.latents == v).all(), model
        again = SDDataset("breastmnist", tt, _refuse, model=model, **kw)
        np.testing.assert_array_equal(again.latents, ds.latents)


def test_image_list_dataset_seeds_each_item():
    from distdiff_tpu_torch.data.datasets import _item_rng, set_data_seed

    set_data_seed(7)
    a = _item_rng(None, 0, 3).integers(0, 1 << 30)
    assert a == np.random.default_rng((7, 0, 3)).integers(0, 1 << 30)
    ds = ImageListDataset(["a", "b"], [0, 1])
    assert len(ds) == 2
    with pytest.raises(ValueError):
        ImageListDataset(["a"], [0, 1])
