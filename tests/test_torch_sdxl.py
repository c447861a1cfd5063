"""SDXL in the port against the JAX package at ``PipelineConfig.sdxl_tiny``
(fp32, CPU): the published geometry's parameter counts from shapes alone,
one synth checkpoint in SDXL's diffusers layout written by both writers and
loaded strictly by both loaders, the UNet's additive conditioning, the two
text towers' taps, the time-id embedding, the dict conditioning helpers,
``encode_text_pair``, ``SDXLPipeline`` (text-to-image and img2img), and the
guided expansion under transform and direct guidance, DPM-Solver++ and
DeepCache, fused, split and chunked. The random draws are the JAX side's."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import GUIDE_KW, run_both, tiny_pipelines, to_torch

from distdiff_tpu.config import PipelineConfig as JPipelineConfig
from distdiff_tpu.sampling import conditioning as j_cond
from distdiff_tpu.sampling import sdxl as j_sdxl
from distdiff_tpu.weights import sd15_geometry as j_geometry
from distdiff_tpu.weights.convert import convert_sdxl_checkpoint
from distdiff_tpu.weights.synth import write_synth_checkpoint as j_write_synth
from distdiff_tpu_torch.config import PipelineConfig
from distdiff_tpu_torch.models import CLIPTextEncoder, UNet2DConditionModel
from distdiff_tpu_torch.sampling import conditioning as cond
from distdiff_tpu_torch.sampling import sdxl
from distdiff_tpu_torch.weights import sd15_geometry as geometry
from distdiff_tpu_torch.weights.convert import load_sdxl_checkpoint
from distdiff_tpu_torch.weights.safetensors import load_file, save_file
from distdiff_tpu_torch.weights.synth import COMPONENT_FILES, write_synth_checkpoint

torch.set_num_threads(1)

SAMPLE = 32
# fp32 on both sides, the same weights and draws: summation order only. The
# towers and one UNet call hold to 1e-5; a whole sampling run, through ten
# UNet calls, the decode and (guided) the guide's gradient, to 2e-4 of
# images in [0, 1], as the SD-1.x expand of test_torch_guided_expand.py.
TOL_LAYER = 1e-5
TOL_RUN = 2e-4


def _count(shapes):
    return sum(math.prod(s) for s in shapes.values())


def test_published_geometry_counts_without_allocating():
    unet, text2 = geometry.sdxl_unet_state_shapes(), geometry.sdxl_text2_state_shapes()
    assert _count(unet) == geometry.PARAM_TOTALS["sdxl_unet"] == \
        j_geometry.PARAM_TOTALS["sdxl_unet"] == 2_567_463_684
    assert _count(text2) == geometry.PARAM_TOTALS["sdxl_text2"] == \
        j_geometry.PARAM_TOTALS["sdxl_text2"] == 694_659_840
    assert unet == j_geometry.sdxl_unet_state_shapes()
    assert text2 == j_geometry.sdxl_text2_state_shapes()
    # the port's modules at PipelineConfig.sdxl_base(), on the meta device
    # (no storage), hold exactly those keys and shapes
    cfg = PipelineConfig.sdxl_base()
    assert (cfg.sample_size, cfg.latent_size, cfg.vae.scaling_factor) == (1024, 128, 0.13025)
    for want, module in ((unet, UNet2DConditionModel(cfg.unet, device="meta")),
                         (text2, CLIPTextEncoder(cfg.text_encoder_2, device="meta"))):
        assert {k: tuple(v.shape) for k, v in module.state_dict().items()} == want
    text1 = CLIPTextEncoder(cfg.text_encoder, device="meta")
    assert _count({k: v.shape for k, v in text1.state_dict().items()}) == \
        geometry.PARAM_TOTALS["text"]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    tcfg = PipelineConfig.sdxl_tiny(sample_size=SAMPLE)
    path = write_synth_checkpoint(str(tmp_path_factory.mktemp("sdxl")), tcfg, seed=3,
                                  scale=0.1, dtype=np.float32, tokenizer=False)
    return path, tcfg


def test_the_synth_checkpoint_is_the_jax_writers(checkpoint, tmp_path):
    path, _ = checkpoint
    jpath = j_write_synth(str(tmp_path), JPipelineConfig.sdxl_tiny(sample_size=SAMPLE), seed=3,
                          scale=0.1, dtype=np.float32, tokenizer=False)
    assert sorted(COMPONENT_FILES) == ["text", "text_2", "unet", "vae"]
    for sub, name in COMPONENT_FILES.values():
        got, want = load_file(f"{path}/{sub}/{name}"), load_file(f"{jpath}/{sub}/{name}")
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    unet = load_file(f"{path}/unet/diffusion_pytorch_model.safetensors")
    text2 = load_file(f"{path}/text_encoder_2/model.safetensors")
    assert tuple(unet["add_embedding.linear_1.weight"].shape) == (64, 64)
    assert tuple(unet["down_blocks.1.attentions.0.proj_in.weight"].shape) == (32, 32)
    assert "down_blocks.0.attentions.0.norm.weight" not in unet
    assert tuple(text2["text_projection.weight"].shape) == (16, 32)


@pytest.mark.parametrize("fault", ["missing", "misshapen"])
def test_the_strict_loader_names_a_faulty_key(checkpoint, tmp_path, fault):
    import shutil

    path, tcfg = checkpoint
    bad = str(tmp_path / "bad")
    shutil.copytree(path, bad)
    f = f"{bad}/text_encoder_2/model.safetensors"
    state = load_file(f)
    if fault == "missing":
        del state["text_projection.weight"]
    else:
        state["text_projection.weight"] = torch.zeros(16, 31)
    save_file(state, f)
    pipe = sdxl.SDXLPipeline.create(tcfg, device="cpu")
    with pytest.raises(ValueError, match=r"text_2: .*text_projection\.weight"):
        load_sdxl_checkpoint(bad, pipe)


@pytest.fixture(scope="module")
def pipelines(checkpoint):
    """(jpipe, numpy params, tpipe): the JAX and the port's guided SDXL
    pipelines, each on the synth checkpoint through its strict loader."""
    path, tcfg = checkpoint
    jcfg = JPipelineConfig.sdxl_tiny(sample_size=SAMPLE)
    jparams = convert_sdxl_checkpoint(path, config=jcfg)  # strict
    jpipe, params, tpipe = tiny_pipelines(jcfg, tcfg, params=jparams)
    loaded = load_sdxl_checkpoint(path, tpipe)  # strict
    assert loaded == {k: len(getattr(tpipe, a).state_dict()) for k, a in
                      (("unet", "unet"), ("vae", "vae"), ("text", "text_encoder"),
                       ("text_2", "text_encoder_2"))}
    assert tpipe.is_sdxl and jpipe.is_sdxl
    return jpipe, jax.tree.map(np.asarray, jpipe.full_params()), tpipe


def _ids(b=2, seed=4):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 900, (b, 16)).astype(np.int32)
    ids[:, 9:] = 0  # a shorter prompt: the end-of-text token is not last
    ids[:, 8] = 999
    return ids


def test_unet_with_added_cond_matches_jax_and_refuses_without(pipelines):
    jpipe, params, tpipe = pipelines
    rng = np.random.RandomState(5)
    ls = tpipe.config.latent_size
    x = (rng.randn(2, ls, ls, 4) * 0.2).astype(np.float32)
    ctx = rng.randn(2, 16, 48).astype(np.float32)
    add = rng.randn(2, 64).astype(np.float32)
    t = np.array([700, 300])
    want = np.asarray(jax.jit(jpipe.unet.apply)({"params": params["unet"]}, jnp.asarray(x),
                                                jnp.asarray(t), jnp.asarray(ctx),
                                                jnp.asarray(add)))
    got = tpipe.unet(*(torch.from_numpy(a) for a in (x, t, ctx, add)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_LAYER, rtol=0)
    # the additive vector moves the output
    other = tpipe.unet(*(torch.from_numpy(a) for a in (x, t, ctx, 0 * add)))
    assert (other - got).abs().max() > 1e-3
    with pytest.raises(ValueError, match="added_cond"):
        tpipe.unet(*(torch.from_numpy(a) for a in (x, t, ctx)))


def test_text_taps_match_jax(pipelines):
    jpipe, params, tpipe = pipelines
    ids = _ids()
    jids, tids = jnp.asarray(ids), torch.from_numpy(ids).long()
    te1, te2 = jpipe.text_encoder, jpipe.text_encoder_2
    want1 = te1.apply({"params": params["text"]}, jids, method=te1.penultimate_hidden)
    want2, want_pool = te2.apply({"params": params["text_2"]}, jids, method=te2.sdxl_outputs)
    want_enc = te2.apply({"params": params["text_2"]}, jids, method=te2.encode_pooled)
    got1 = tpipe.text_encoder.penultimate_hidden(tids)
    got2, got_pool = tpipe.text_encoder_2.sdxl_outputs(tids)
    got_enc = tpipe.text_encoder_2.encode_pooled(tids)
    assert got1.shape == (2, 16, 16) and got2.shape == (2, 16, 32) and got_pool.shape == (2, 16)
    for got, want in ((got1, want1), (got2, want2), (got_pool, want_pool),
                      (got_enc, want_enc)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL_LAYER,
                                   rtol=0)
    np.testing.assert_allclose(got_enc.detach().numpy(), got_pool.detach().numpy(), atol=1e-6)
    # CLIP-L has no projection: its sdxl_outputs give no pooled output
    assert tpipe.text_encoder.sdxl_outputs(tids)[1] is None


def test_time_ids_embedding_matches_jax():
    ids = np.array([[1024, 1024, 0, 0, 1024, 1024], [896, 1152, 64, 32, 1024, 1024]],
                   np.float32)
    for dim in (256, 8):
        want = np.asarray(j_sdxl.time_ids_embedding(jnp.asarray(ids), dim))
        got = sdxl.time_ids_embedding(torch.from_numpy(ids), dim).numpy()
        assert got.shape == (2, 6 * dim)
        # both round id x frequency to fp32 (one ulp is 6.1e-5 at 1024),
        # then XLA's and torch's cos and sin differ by a few such ulps
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(sdxl.default_time_ids(3, 1024).numpy(),
                                  np.asarray(j_sdxl.default_time_ids(3, 1024)))
    # 1280 pooled + 6 x 256 = 2816, SDXL-base's addition_embed_dim
    assert 1280 + 6 * 256 == PipelineConfig.sdxl_base().unet.addition_embed_dim


def test_cond_helpers_on_dicts_match_jax():
    rng = np.random.RandomState(0)
    a = {"ctx": rng.randn(4, 3, 2).astype(np.float32), "add": rng.randn(4, 2).astype(np.float32)}
    b = {k: v + 1 for k, v in a.items()}
    ta, tb = to_torch(a), to_torch(b)
    assert cond.cond_leading_dim(ta) == j_cond.cond_leading_dim(a) == 4
    assert cond.cond_leading_dim(ta["ctx"]) == 4
    checks = [
        (cond.cond_slice(ta, 1, 3), j_cond.cond_slice(a, 1, 3)),
        (cond.cond_index(ta, 2), j_cond.cond_index(a, 2)),
        (cond.cond_stack([cond.cond_index(ta, i) for i in (2, 0, 1)]),
         j_cond.cond_stack([j_cond.cond_index(a, i) for i in (2, 0, 1)])),
        (cond.cond_stack([cond.cond_index(a, 1)] * 2), j_cond.cond_stack([j_cond.cond_index(a, 1)] * 2)),
        (cond.cond_concat(ta, tb), j_cond.cond_concat(a, b)),
        (cond.cond_to(a, "cpu"), a),
    ]
    for got, want in checks:
        assert set(got) == {"ctx", "add"} and all(torch.is_tensor(v) for v in got.values())
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    back = cond.cond_asarray(ta)
    assert all(isinstance(v, np.ndarray) for v in back.values())
    # a bare tensor goes through the same functions
    np.testing.assert_array_equal(cond.cond_concat(ta["ctx"], tb["ctx"]).numpy(),
                                  np.concatenate([a["ctx"], b["ctx"]]))


def _jax_pair(jpipe, params, ids):
    return jax.tree.map(np.asarray, jpipe.encode_text_pair(params, jnp.asarray(ids),
                                                           jnp.asarray(ids)))


def test_encode_text_pair_matches_jax(pipelines):
    jpipe, params, tpipe = pipelines
    ids = _ids()
    want = _jax_pair(jpipe, params, ids)
    tids = torch.from_numpy(ids).long()
    got = tpipe.encode_text_pair(tids, tids)
    assert got["ctx"].shape == (2, 16, 48) and got["add"].shape == (2, 64)
    for k in ("ctx", "add"):
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=TOL_LAYER, rtol=0)
    time_ids = np.array([[40, 24, 4, 0, 32, 32]] * 2, np.float32)
    want = jpipe.encode_text_pair(params, jnp.asarray(ids), jnp.asarray(ids),
                                  jnp.asarray(time_ids))
    got = tpipe.encode_text_pair(tids, tids, torch.from_numpy(time_ids))
    np.testing.assert_allclose(got["add"].numpy(), np.asarray(want["add"]), atol=TOL_LAYER,
                               rtol=0)


def _conds(jpipe, params):
    ids = _ids()
    return _jax_pair(jpipe, params, ids), _jax_pair(jpipe, params, np.zeros_like(ids))


@pytest.fixture(scope="module")
def sdxl_pipes(checkpoint):
    """The JAX and the port's ``SDXLPipeline`` (CFG 5, strength 0.5) on the
    synth checkpoint."""
    path, tcfg = checkpoint
    jcfg = JPipelineConfig.sdxl_tiny(sample_size=SAMPLE)
    jparams = convert_sdxl_checkpoint(path, config=jcfg)
    jpipe = j_sdxl.SDXLPipeline.create(
        jcfg, sampler_cfg=j_sdxl.SamplerConfig(guidance_scale=5.0), params=jparams)
    tpipe = sdxl.SDXLPipeline.create(tcfg, sampler_cfg=sdxl.SamplerConfig(guidance_scale=5.0),
                                     device="cpu")
    load_sdxl_checkpoint(path, tpipe)
    return jpipe, tpipe


@pytest.mark.parametrize("text_to_img", [True, False], ids=["t2i", "img2img"])
def test_sdxl_pipeline_matches_jax(sdxl_pipes, text_to_img):
    jpipe, tpipe = sdxl_pipes
    ids = _ids()
    j1, j2 = jnp.asarray(ids), jnp.asarray(ids)
    ctx, pooled = jpipe.encode_prompt(jpipe.params, j1, j2)
    uctx, upooled = jpipe.encode_prompt(jpipe.params, 0 * j1, 0 * j2)
    tids = torch.from_numpy(ids).long()
    got_cond = tpipe.encode_prompt(tids, tids)
    np.testing.assert_allclose(got_cond["ctx"].numpy(), np.asarray(ctx), atol=TOL_LAYER, rtol=0)
    np.testing.assert_allclose(got_cond["add"].numpy(), np.asarray(jpipe.added_cond(pooled)),
                               atol=TOL_LAYER, rtol=0)
    ls = tpipe.config.latent_size
    lat = (np.random.RandomState(6).randn(2, ls, ls, 4) * 0.13).astype(np.float32)
    key = jax.random.key(2)  # one typed key: one draw for the batch
    # both entry points draw the noise as one standard normal of the
    # latents' shape from the key
    noise = np.array(jax.random.normal(key, lat.shape, jnp.float32))
    jargs = (ctx, jpipe.added_cond(pooled), uctx, jpipe.added_cond(upooled))
    want = np.asarray(jax.jit(jpipe.make_sample_fn(text_to_img))(
        jpipe.params, jnp.asarray(lat), *jargs, key))
    c_ctx, c_add, u_ctx, u_add = (torch.from_numpy(np.asarray(a)) for a in jargs)
    got = tpipe.make_sample_fn(text_to_img)(torch.from_numpy(lat),
                                            {"ctx": c_ctx, "add": c_add},
                                            {"ctx": u_ctx, "add": u_add},
                                            noise=torch.from_numpy(noise))
    assert got.shape == (2, SAMPLE, SAMPLE, 3) and float(got.min()) >= 0 and got.max() <= 1
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_RUN, rtol=0)


def _guided(gtype):
    return dict(GUIDE_KW, guidance_type=gtype)


@pytest.fixture(scope="module")
def fused_transform(pipelines):
    """The JAX package's and the port's ``make_expand_fn`` under transform
    guidance (``pipelines``' guidance) on the same inputs and draws, one
    key a sample: (JAX's images, the port's, the port's inputs and
    draws)."""
    jpipe, params, tpipe = pipelines
    assert tpipe.guidance_cfg.guidance_type == jpipe.guidance_cfg.guidance_type == \
        "transform_guidance"
    return run_both(jpipe, params, tpipe, "fused", conds=_conds(jpipe, params), per_sample=True)


@pytest.mark.parametrize("gtype", ["transform_guidance", "direct_guidance"])
def test_guided_expand_matches_jax(checkpoint, gtype, request):
    if gtype == "transform_guidance":  # the pipelines fixture's guidance
        ref, got, _ = request.getfixturevalue("fused_transform")
    else:
        path, tcfg = checkpoint
        jcfg = JPipelineConfig.sdxl_tiny(sample_size=SAMPLE)
        jpipe, params, tpipe = tiny_pipelines(jcfg, tcfg, guide_kw=_guided(gtype),
                                              params=convert_sdxl_checkpoint(path, config=jcfg))
        load_sdxl_checkpoint(path, tpipe)
        ref, got, _ = run_both(jpipe, params, tpipe, "fused", conds=_conds(jpipe, params))
    assert got.shape == ref.shape == (2, SAMPLE, SAMPLE, 3)
    np.testing.assert_allclose(got, ref, atol=TOL_RUN, rtol=0)


@pytest.mark.parametrize("split_kw", [{}, dict(guide_chunk=1, decode_chunk=1)],
                         ids=["whole", "chunked"])
def test_split_and_chunked_expand_match_jax(pipelines, split_kw, request):
    """SplitExpand, whole and with the guidance and the decode on one-sample
    chunks of the {"ctx", "add"} dicts, against the JAX package and against
    the port's own make_expand_fn on the same draws (the same arithmetic:
    1e-5). The JAX reference is the ``make_expand_fn`` run of
    ``fused_transform`` on the same per-sample keys: the JAX package's
    ``tests/test_sdxl_guided.py`` (``test_sdxl_split_matches_fused``) holds
    its SplitExpand to its ``make_expand_fn``, and a chunk's samples are
    independent of the others (one key a sample)."""
    jpipe, params, tpipe = pipelines
    ref, fused, (targs, kw) = request.getfixturevalue("fused_transform")
    got = tpipe.make_split_expand(**split_kw)(*targs, **kw).numpy()
    np.testing.assert_allclose(got, ref, atol=TOL_RUN, rtol=0)
    np.testing.assert_allclose(got, fused, atol=1e-5, rtol=0)


@pytest.mark.parametrize("option", ["dpmpp", "deep_cache"])
def test_solver_and_cache_match_jax(checkpoint, option):
    """DPM-Solver++ and DeepCache on SDXL's dict conditioning, unguided (the
    guidance splices run the same rollout under every solver; the JAX
    expand's compile of a guided run takes most of a minute)."""
    path, tcfg = checkpoint
    edit = {"dpmpp": dict(scheduler="dpmpp"),
            "deep_cache": dict(deep_cache=True, cache_interval=2, cache_branch=0)}[option]
    jcfg = dataclasses.replace(JPipelineConfig.sdxl_tiny(sample_size=SAMPLE), **edit)
    tcfg = dataclasses.replace(tcfg, **edit)
    jpipe, params, tpipe = tiny_pipelines(jcfg, tcfg, guide_kw=_guided("none"),
                                          params=convert_sdxl_checkpoint(path, config=jcfg))
    load_sdxl_checkpoint(path, tpipe)
    ref, got, _ = run_both(jpipe, params, tpipe, "fused", conds=_conds(jpipe, params))
    np.testing.assert_allclose(got, ref, atol=TOL_RUN, rtol=0)


def test_lazy_init_allocates_only_the_bf16_tensors():
    """build_diffusion_modules(lazy=True): every new tensor the build makes
    off the meta device is one of the modules' bf16 tensors (no fp32 copy,
    no temporary), each filled with LAZY_FILL."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from distdiff_tpu_torch.models.init import LAZY_FILL, build_diffusion_modules

    allocs = []

    class RecordAllocations(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            seen = {t.untyped_storage().data_ptr()
                    for t in torch.utils._pytree.tree_leaves((args, kwargs))
                    if isinstance(t, torch.Tensor) and t.device.type != "meta"}
            for t in torch.utils._pytree.tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.device.type != "meta" \
                        and t.untyped_storage().data_ptr() not in seen:
                    allocs.append((t.dtype, t.untyped_storage().nbytes()))
            return out

    with RecordAllocations():
        mods = build_diffusion_modules(PipelineConfig.sdxl_tiny(), torch.device("cpu"),
                                       lazy=True)
    tensors = [t for m in mods for t in list(m.parameters()) + list(m.buffers())]
    floating = [t for t in tensors if t.is_floating_point()]
    assert len(mods) == 4 and floating
    for t in floating:
        assert t.dtype == torch.bfloat16 and bool((t == LAZY_FILL).all())
    assert not any(d == torch.float32 for d, _ in allocs)
    assert sum(n for _, n in allocs) == sum(t.untyped_storage().nbytes() for t in tensors)
