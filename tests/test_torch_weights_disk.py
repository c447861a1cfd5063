"""Weights from disk: the port's diffusers-checkpoint loader, its synthetic
checkpoint writer, its stdlib safetensors reader and writer, and the guide's
``load_weights``, each against the JAX package (or the ``safetensors``
package) on the same files, at the tiny config."""

import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load_numpy
from safetensors.numpy import save_file as st_save_numpy
from safetensors.torch import load_file as st_load_torch
from safetensors.torch import save_file as st_save_torch

from distdiff_tpu.config import PipelineConfig as JPipelineConfig
from distdiff_tpu.models.guide import create_model as j_create_model
from distdiff_tpu.models.guide.factory import load_weights as j_load_weights
from distdiff_tpu.sampling import ExpansionPipeline as JExpansionPipeline
from distdiff_tpu.weights.convert import convert_sd_checkpoint
from distdiff_tpu.weights.synth import state_shapes_for_config as j_state_shapes
from distdiff_tpu.weights.synth import write_synth_checkpoint as j_write_synth
from distdiff_tpu_torch.config import PipelineConfig
from distdiff_tpu_torch.models import CLIPTokenizer, load_tokenizer
from distdiff_tpu_torch.models.guide import create_model
from distdiff_tpu_torch.models.guide.factory import load_weights
from distdiff_tpu_torch.models.guide.resnet import tiny_resnet_config
from distdiff_tpu_torch.sampling import ExpansionPipeline
from distdiff_tpu_torch.weights.convert import load_sd_checkpoint
from distdiff_tpu_torch.weights.from_jax import state_dict_from_jax
from distdiff_tpu_torch.weights.safetensors import load_file, save_file
from distdiff_tpu_torch.weights.synth import state_shapes_for_config, write_synth_checkpoint

torch.set_num_threads(1)

SAMPLE = 32
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNET_FILE = os.path.join("unet", "diffusion_pytorch_model.safetensors")


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A tiny fp16 checkpoint written by the JAX package's writer."""
    cfg = JPipelineConfig.tiny(sample_size=SAMPLE)
    return j_write_synth(str(tmp_path_factory.mktemp("jck") / "ckpt"), cfg, seed=3)


def _port_pipe():
    return ExpansionPipeline.create(PipelineConfig.tiny(sample_size=SAMPLE), device="cpu")


def test_checkpoint_loads_into_the_port_as_into_jax(jax_checkpoint):
    jcfg = JPipelineConfig.tiny(sample_size=SAMPLE)
    params = convert_sd_checkpoint(jax_checkpoint, config=jcfg)
    jpipe = JExpansionPipeline.create(jcfg, params=params)
    tpipe = _port_pipe()
    loaded = load_sd_checkpoint(jax_checkpoint, tpipe)
    assert loaded == {"unet": 208, "vae": 124, "text": 36}
    # the tokenizer files beside the weights give CLIP's BPE, on both sides
    tok = load_tokenizer(checkpoint_dir=jax_checkpoint, max_length=16, vocab_size=1000,
                         strict=True)
    assert isinstance(tok, CLIPTokenizer)
    ids = tok(["a photo of a dog", ""])
    rng = np.random.RandomState(0)
    ls = tpipe.config.latent_size
    x = (rng.randn(2, ls, ls, 4) * 0.5).astype(np.float32)
    ctx = np.array(jpipe.encode_text(params, jnp.asarray(ids)))
    got_ctx = tpipe.encode_text(torch.from_numpy(ids).long()).numpy()
    # fp32 on both sides from the same fp16 weights: summation order only
    np.testing.assert_allclose(got_ctx, ctx, atol=1e-5, rtol=0)
    eps = np.asarray(jpipe.unet_apply(params, jnp.asarray(x), jnp.asarray([500, 500]),
                                      jnp.asarray(ctx)))
    with torch.no_grad():
        got_eps = tpipe.unet(torch.from_numpy(x), torch.tensor([500, 500]),
                             torch.from_numpy(ctx)).numpy()
    assert np.abs(eps).max() > 1e-3
    np.testing.assert_allclose(got_eps, eps, atol=1e-4, rtol=0)
    img = np.asarray(jpipe.decode_latents(params, jnp.asarray(x)))
    with torch.no_grad():
        got_img = tpipe.decode_latents(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_img, img, atol=1e-4, rtol=0)


def _edited_copy(src, dst, edit):
    """A copy of checkpoint ``src`` at ``dst`` with the UNet state edited."""
    import shutil

    shutil.copytree(src, dst)
    path = os.path.join(dst, UNET_FILE)
    state = st_load_numpy(path)
    edit(state)
    st_save_numpy(state, path)
    return dst


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_a_faulty_key_raises_on_both_sides(jax_checkpoint, tmp_path, fault):
    first = "down_blocks.0.resnets.0.conv1.weight"

    def edit(state):
        if fault == "missing":
            state.pop(first)
        elif fault == "extra":
            # a name the JAX key map takes, on a leaf its template lacks
            state["down_blocks.0.resnets.0.conv3.weight"] = state[first]
        else:
            state[first] = state[first][:, :-1]

    ckpt = _edited_copy(jax_checkpoint, str(tmp_path / "ckpt"), edit)
    with pytest.raises((ValueError, AssertionError)):
        convert_sd_checkpoint(ckpt, config=JPipelineConfig.tiny(sample_size=SAMPLE))
    name = {"missing": first, "extra": "conv3.weight", "shape": first}[fault]
    with pytest.raises(ValueError, match=name.replace(".", r"\.")):
        load_sd_checkpoint(ckpt, _port_pipe())
    # non-strict: the matching keys load, the faulty one is passed over
    if fault != "missing":
        assert load_sd_checkpoint(ckpt, _port_pipe(), strict=False)["unet"] == 208 - (
            fault == "shape")


def test_t5_text_encoder_is_refused_on_both_sides(jax_checkpoint, tmp_path):
    import shutil

    ckpt = str(tmp_path / "ckpt")
    shutil.copytree(jax_checkpoint, ckpt)
    with open(os.path.join(ckpt, "text_encoder", "config.json"), "w") as f:
        json.dump({"architectures": ["T5EncoderModel"]}, f)
    with pytest.raises(NotImplementedError, match="T5"):
        convert_sd_checkpoint(ckpt, config=JPipelineConfig.tiny(sample_size=SAMPLE))
    with pytest.raises(NotImplementedError, match="T5"):
        load_sd_checkpoint(ckpt, _port_pipe())


def test_position_ids_are_taken_and_checked(jax_checkpoint, tmp_path):
    import shutil

    ckpt = str(tmp_path / "ckpt")
    shutil.copytree(jax_checkpoint, ckpt)
    path = os.path.join(ckpt, "text_encoder", "model.safetensors")
    state = st_load_numpy(path)
    state["text_model.embeddings.position_ids"] = np.arange(16, dtype=np.int64)[None]
    st_save_numpy(state, path)
    assert load_sd_checkpoint(ckpt, _port_pipe())["text"] == 36
    state["text_model.embeddings.position_ids"] = np.zeros((1, 16), np.int64)
    st_save_numpy(state, path)
    with pytest.raises(ValueError, match="position_ids"):
        load_sd_checkpoint(ckpt, _port_pipe())


def test_synth_writer_matches_jax_key_by_key(jax_checkpoint, tmp_path):
    ckpt = write_synth_checkpoint(str(tmp_path / "port"), PipelineConfig.tiny(sample_size=SAMPLE),
                                  seed=3)
    for sub, name in (("unet", "diffusion_pytorch_model"), ("vae", "diffusion_pytorch_model"),
                      ("text_encoder", "model")):
        rel = os.path.join(sub, name + ".safetensors")
        want = st_load_numpy(os.path.join(jax_checkpoint, rel))
        got = st_load_numpy(os.path.join(ckpt, rel))
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype == np.float16
            np.testing.assert_array_equal(got[k], want[k])  # the same draws: exact
    for name in ("merges.txt", "vocab.json"):
        with open(os.path.join(ckpt, "tokenizer", name), "rb") as a, \
                open(os.path.join(jax_checkpoint, "tokenizer", name), "rb") as b:
            assert a.read() == b.read()


def test_sd15_geometry_matches_jax_shapes():
    got = state_shapes_for_config(PipelineConfig.sd15())
    want = j_state_shapes(JPipelineConfig())
    assert list(got) == list(want) == ["vae", "text", "unet"]
    for comp in want:
        assert list(got[comp].items()) == list(want[comp].items()), comp
    totals = {c: sum(int(np.prod(s)) for s in got[c].values()) for c in got}
    assert totals == {"unet": 859_520_964, "vae": 83_653_863, "text": 123_060_480}
    # the port's own modules carry exactly these keys and shapes
    from distdiff_tpu_torch.models import AutoencoderKL, CLIPTextEncoder, UNet2DConditionModel

    cfg = PipelineConfig.sd15()
    for comp, module in (("unet", UNet2DConditionModel(cfg.unet, device="meta")),
                         ("vae", AutoencoderKL(cfg.vae, device="meta")),
                         ("text", CLIPTextEncoder(cfg.text_encoder, device="meta"))):
        assert {k: tuple(v.shape) for k, v in module.state_dict().items()} == got[comp]


def test_sdxl_geometry_raises_naming_the_roadmap():
    """SDXL's geometry is ported (it raised before): the port's key sets at
    the JAX package's ``sdxl_tiny`` are the JAX writer's, and the port's
    modules carry exactly them. What still raises naming the ROADMAP item
    is the CLI's ``--int8`` (``test_torch_cli.py``)."""
    from distdiff_tpu_torch.models import CLIPTextEncoder, UNet2DConditionModel

    got = state_shapes_for_config(JPipelineConfig.sdxl_tiny())
    assert got == j_state_shapes(JPipelineConfig.sdxl_tiny())
    cfg = PipelineConfig.sdxl_tiny()
    assert got == state_shapes_for_config(cfg)
    for comp, module in (("unet", UNet2DConditionModel(cfg.unet, device="meta")),
                         ("text_2", CLIPTextEncoder(cfg.text_encoder_2, device="meta"))):
        assert {k: tuple(v.shape) for k, v in module.state_dict().items()} == got[comp]


# ------------------------------------------------------------- safetensors

def test_safetensors_round_trip_against_the_package(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {
        "f32": torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)),
        "f16": torch.from_numpy(rng.standard_normal((7,)).astype(np.float16)),
        "bf16": torch.randn(4, 3, 2).bfloat16(),
        "i64": torch.arange(77)[None],
        "empty": torch.zeros(0, 3),
        "scalar": torch.tensor(2.5),
    }
    # the port writes, the package reads
    save_file(tensors, str(tmp_path / "port.safetensors"))
    back = st_load_torch(str(tmp_path / "port.safetensors"))
    assert set(back) == set(tensors)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    # the package writes (with a metadata entry), the port reads
    st_save_torch(tensors, str(tmp_path / "pkg.safetensors"), metadata={"format": "pt"})
    got = load_file(str(tmp_path / "pkg.safetensors"))
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    # numpy arrays write as the package's numpy writer reads them
    save_file({"a": np.arange(6, dtype=np.float32).reshape(2, 3)}, str(tmp_path / "np.safetensors"))
    np.testing.assert_array_equal(st_load_numpy(str(tmp_path / "np.safetensors"))["a"],
                                  np.arange(6, dtype=np.float32).reshape(2, 3))


def test_safetensors_refuses_other_dtypes(tmp_path):
    st_save_numpy({"x": np.zeros(3, np.float64)}, str(tmp_path / "f64.safetensors"))
    with pytest.raises(ValueError, match="F64"):
        load_file(str(tmp_path / "f64.safetensors"))
    with pytest.raises(ValueError, match="int32"):
        save_file({"x": torch.zeros(3, dtype=torch.int32)}, str(tmp_path / "x.safetensors"))
    with pytest.raises(ValueError, match="float64"):
        save_file({"x": np.zeros(3)}, str(tmp_path / "x.safetensors"))


def test_port_imports_no_safetensors_package():
    bad = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "distdiff_tpu_torch")):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module] if isinstance(node, ast.ImportFrom)
                         and node.level == 0 else [])
                bad += [f"{path}: {n}" for n in names if n.split(".")[0] == "safetensors"]
    assert not bad, bad


# ------------------------------------------------------------------- guide

@pytest.fixture(scope="module")
def jax_guide():
    return j_create_model("tiny_resnet", num_classes=5, input_size=32)


def _guide_state(jg):
    """The JAX guide's variables as the reference's torchvision state dict."""
    state = state_dict_from_jax(jax.tree.map(np.asarray, jg.variables), tiny_resnet_config(5))
    return {k: v.clone() for k, v in state.items()}


@pytest.mark.parametrize("fmt", [".pth.tar", ".safetensors", ".npz"])
def test_guide_weights_encode_as_jax_loads_them(jax_guide, tmp_path, fmt):
    # other weights than the ones the JAX guide was built with
    state = {k: (v * 0.9 + 0.01 if v.is_floating_point() else v)
             for k, v in _guide_state(jax_guide).items()}
    path = str(tmp_path / ("guide" + fmt))
    if fmt == ".pth.tar":
        # the reference's form: DataParallel prefix, bookkeeping beside it,
        # and a key the model lacks (skipped by both loaders)
        torch.save({"epoch": 3, "state_dict": dict(
            {"module." + k: v for k, v in state.items()}, **{"module.head.weight": torch.ones(2)})},
            path)
    elif fmt == ".safetensors":
        save_file(state, path)
    else:
        flat = {}
        jvars = jax.tree.map(np.asarray, jax_guide.variables)

        def walk(tree, prefix):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, f"{prefix}{k}/")
                else:
                    flat[prefix + k] = v * 0.9 + 0.01
        walk(jvars, "")
        flat["params/extra/kernel"] = np.ones(3, np.float32)  # ignored by both
        np.savez(path, **flat)
    jg = j_create_model("tiny_resnet", num_classes=5, input_size=32)
    j_load_weights(jg, path)
    tg = create_model("tiny_resnet", num_classes=5, weight_path=path, device="cpu")
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    want = np.asarray(jg.encode_image(jnp.asarray(x)))
    got = tg.encode_image(torch.from_numpy(x)).numpy()
    assert np.abs(want - np.asarray(jax_guide.encode_image(jnp.asarray(x)))).max() > 1e-4
    # fp32 convolutions on both sides: summation order only
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_guide_loader_refusals(jax_guide, tmp_path):
    state = _guide_state(jax_guide)
    tg = create_model("tiny_resnet", num_classes=5, device="cpu")
    wrong = str(tmp_path / "wrong.pth.tar")
    torch.save({"state_dict": dict(state, **{"fc.weight": torch.zeros(7, 32)})}, wrong)
    with pytest.raises(ValueError, match="fc.weight"):
        load_weights(tg, wrong)
    none = str(tmp_path / "none.pth.tar")
    torch.save({"state_dict": {"head.weight": torch.zeros(2)}}, none)
    with pytest.raises(ValueError, match="no weights matched"):
        load_weights(tg, none)
    with pytest.raises(NotImplementedError, match="orbax"):
        load_weights(tg, str(tmp_path))
    # an OpenCLIP state (ported since) into a guide of another arch: the
    # image tower's keys do not fit it
    clip = str(tmp_path / "clip.pth")
    torch.save({"visual.conv1.weight": torch.zeros(8, 3, 4, 4)}, clip)
    with pytest.raises(ValueError, match="OpenCLIP conversion mismatch"):
        load_weights(tg, clip)
    npz = str(tmp_path / "short.npz")
    np.savez(npz, **{"params/conv1/kernel": np.zeros((7, 7, 3, 8), np.float32)})
    with pytest.raises(KeyError, match="missing"):
        load_weights(tg, npz)


@pytest.mark.parametrize("arch", ["resnext50", "wideresnet50", "mobilenetv2",
                                  "open_clip_vit_b32"])
def test_unported_guide_archs_raise_naming_the_roadmap(arch, tmp_path):
    """These archs are ported now (``tests/test_torch_guides.py``): each is
    built, and what the port still does not read, an orbax directory of
    the JAX package, raises and names the route across."""
    gm = create_model(arch, num_classes=3, device="meta")
    assert gm.arch == arch and gm.feature_dim in (512, 1280, 2048)
    with pytest.raises(NotImplementedError, match="orbax"):
        load_weights(gm, str(tmp_path))
