"""The port's CLIP tokenizer and text encoder against the JAX package's: the
same ids from the same merges file (one the test writes, as
``tests/test_utils.py`` does) and from the hash stand-in, the tiny text
encoder's hidden states on the same weights (the JAX init, carried over
with ``state_dict_from_jax``), and its key map over CLIP-L's geometry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distdiff_tpu.config import TextEncoderConfig as JTextEncoderConfig
from distdiff_tpu.models.text_encoder import CLIPTextEncoder as JCLIPTextEncoder
from distdiff_tpu.models.tokenizer import CLIPTokenizer as JCLIPTokenizer
from distdiff_tpu.models.tokenizer import load_tokenizer as j_load_tokenizer
from distdiff_tpu_torch.config import TextEncoderConfig
from distdiff_tpu_torch.models import (
    CLIPTextEncoder,
    CLIPTokenizer,
    HashTokenizer,
    discover_bpe,
    load_tokenizer,
)
from distdiff_tpu_torch.weights.from_jax import key_table, state_dict_from_jax

torch.set_num_threads(1)

PROMPTS = ["a photo of a lower tower", "Lowered towers, newer!", "  low&lower\tpower 42 ",
           "", "it's the owl's tower &amp; more"]
MERGES = "#version\nl o\nlo w</w>\ne r</w>\nlo w\nt o\nto w\nw er</w>\np o\n"


@pytest.fixture
def merges_path(tmp_path):
    path = tmp_path / "tokenizer" / "merges.txt"
    path.parent.mkdir()
    path.write_text(MERGES)
    return str(path)


def test_clip_tokenizer_ids_match_jax(merges_path):
    # exact: the same pure-Python BPE on the same merges
    for max_length in (8, 16):
        got = CLIPTokenizer(merges_path, max_length=max_length)(PROMPTS)
        want = JCLIPTokenizer(merges_path, max_length=max_length)(PROMPTS)
        assert got.dtype == np.int32 and got.shape == (len(PROMPTS), max_length)
        np.testing.assert_array_equal(got, want)
    tok = CLIPTokenizer(merges_path)
    assert len(tok.encode("low")) == 1  # l+o, then lo+w</w>


def test_hash_tokenizer_and_loader_match_jax(merges_path, monkeypatch):
    monkeypatch.delenv("DISTDIFF_CLIP_BPE", raising=False)
    got = load_tokenizer(None, max_length=12, vocab_size=1000)
    want = j_load_tokenizer(None, max_length=12, vocab_size=1000)
    assert isinstance(got, HashTokenizer)
    np.testing.assert_array_equal(got(PROMPTS), want(PROMPTS))  # exact
    with pytest.raises(RuntimeError, match="refusing"):
        load_tokenizer(None, strict=True)
    ckpt = merges_path.rsplit("/tokenizer/", 1)[0]
    assert discover_bpe(ckpt) == (merges_path, None)
    tok = load_tokenizer(None, max_length=10, checkpoint_dir=ckpt, strict=True)
    assert isinstance(tok, CLIPTokenizer)
    np.testing.assert_array_equal(
        tok(PROMPTS), j_load_tokenizer(None, max_length=10, checkpoint_dir=ckpt)(PROMPTS))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("activation", ["quick_gelu", "gelu"])
def test_tiny_text_encoder_matches_jax(activation):
    jcfg = JTextEncoderConfig(**{**JTextEncoderConfig.tiny().__dict__, "activation": activation})
    cfg = TextEncoderConfig(**{**TextEncoderConfig.tiny().__dict__, "activation": activation})
    ids = HashTokenizer(vocab_size=cfg.vocab_size, max_length=cfg.max_length)(PROMPTS[:3])
    mod = JCLIPTextEncoder(jcfg)
    params = jax.jit(mod.init)(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    want = np.asarray(jax.jit(mod.apply)({"params": params}, jnp.asarray(ids)))
    enc = CLIPTextEncoder(cfg, device="cpu")
    enc.load_state_dict(state_dict_from_jax(_np(params), cfg))
    with torch.no_grad():
        got = enc(torch.from_numpy(ids).long())
    assert got.dtype == torch.float32 and got.shape == (3, cfg.max_length, cfg.hidden_size)
    # fp32 through two blocks and three layer norms: summation order only
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


def test_key_map_covers_clip_l_geometry():
    """Every JAX leaf of CLIP-L's text tower (SD-1.5) has exactly one port
    key of the matching shape, and the names are transformers'."""
    want = jax.eval_shape(JCLIPTextEncoder(JTextEncoderConfig.sd15()).init,
                          jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32))["params"]
    table = key_table(TextEncoderConfig.sd15())
    got = {path: shape for path, shape, _ in table.values()}
    assert len(got) == len(table) == 12 * 16 + 4
    assert got == _shapes(want)
    assert "text_model.encoder.layers.11.self_attn.q_proj.weight" in table
    assert "text_model.embeddings.position_embedding.weight" in table
