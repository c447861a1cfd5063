"""The port's int8 w8a8 route (``ops/quant.py``, ``QConv2d``/``QLinear``,
``config.int8``) against the JAX package's (``distdiff_tpu/ops/quant.py``,
``QConv``/``QDense``):

* the quantizers, ``qconv`` (stride 1 and 2) and ``qdot`` on seeded
  inputs in fp32 and bf16: the int8 values, the scales and the int32
  accumulators at tolerance 0, the outputs within 1 ulp of their dtype;
* the padding the card's ``torch._int_mm`` gets (rows to more than 16,
  depth and width to multiples of 8), with the card's branch taken on the
  CPU and ``_int_mm`` replaced by a checker;
* the layers on the route: the port's ``QConv2d``/``QLinear`` paths, mapped
  to the JAX tree, are the JAX UNet's ``QConv``/``QDense`` paths at SD-1.5,
  SD-2.1 and SDXL topologies;
* the tiny UNet's CFG epsilon under int8 against JAX's int8 UNet with
  each quantized layer's input pinned to the port's: within EPS_TOL, at
  least 10 EPS_TOL below the int8-versus-exact gap;
* the guided ``make_expand_fn`` and ``SplitExpand``, the same under
  DeepCache (unguided) and ``sdxl_tiny``'s text-to-image and img2img under
  int8, on the JAX draws, held layer by layer: each int8 layer's first and
  last call of the run against JAX's ``qconv``/``qdot`` on that call's
  input, and the count of calls (one a layer in each plain-span UNet
  call, none in the guidance update or the decode);
* the guidance update and the VAE decode unchanged, bit for bit, by
  ``config.int8``, with no int8 product in them; the flag restored after an
  exception.

Why pinned and layer by layer: the quantizer is discontinuous. Both
packages quantize equal fp32 values to equal int8 values, but their fp32
sums differ in order by ~1e-6 of a value, which moves a value across a
rounding boundary (one level, 1/127 of the tensor's largest) here and
there, and a moved level moves every later layer. Unpinned, one CFG
epsilon of the tiny UNet differs from JAX's by 2e-5 to 4e-2 on the mean
from one input to the next, where int8 moves it from exact by ~5e-2; a
1e-7 relative change of the port's own input moves it by 4.5e-2; and
whole trajectories drift as far apart as int8 is from exact. Pinned, the
epsilon agrees to 5e-6 where the gap is 2.8e-1 (max abs)."""

import dataclasses
import threading

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import inputs, jax_draws, tiny_pipelines

from distdiff_tpu.config import PipelineConfig as JPipelineConfig
from distdiff_tpu.config import UNetConfig as JUNetConfig
from distdiff_tpu.models import UNet2DCondition
from distdiff_tpu.models.layers import QConv, QDense
from distdiff_tpu.ops import quant as jq
from distdiff_tpu_torch.config import PipelineConfig, UNetConfig
from distdiff_tpu_torch.guidance import transform_guidance
from distdiff_tpu_torch.models import UNet2DConditionModel
from distdiff_tpu_torch.models.layers import Conv2d, Linear, QConv2d, QLinear
from distdiff_tpu_torch.ops import quant
from distdiff_tpu_torch.sampling import sdxl
from distdiff_tpu_torch.weights.from_jax import map_unet_key

torch.set_num_threads(1)

SAMPLE = 32
EPS_TOL = 1e-4
DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _bits(a: np.ndarray) -> np.ndarray:
    """fp32 or bf16 values as signed integers that step by 1 an ulp."""
    u = a.view(np.int32 if a.dtype.itemsize == 4 else np.int16).astype(np.int64)
    return np.where(u < 0, -(u & (2 ** (8 * a.dtype.itemsize - 1) - 1)), u)


def _assert_ulp(got: torch.Tensor, want, maxulp: int = 1) -> None:
    g = (got.view(torch.int16) if got.dtype == torch.bfloat16 else got).numpy()
    w = np.asarray(want)
    w = w.view(np.int16) if w.dtype.itemsize == 2 else w
    assert np.abs(_bits(g) - _bits(w)).max() <= maxulp


def _conv_inputs(dtype, seed=0, c=16, o=24):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 9, 10, c)) * 3).astype(np.float32)
    w = (rng.standard_normal((3, 3, c, o)) * 0.1).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    return (torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2), torch.from_numpy(w).permute(3, 2, 0, 1),
            jnp.asarray(x).astype(jdt), jnp.asarray(w))


# ------------------------------------------------------------------- the ops

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_quantizers_match_jax(dtype):
    tx, tw, jx, jw = _conv_inputs(dtype)
    q, s = quant.quant_act(tx)
    jqx, js = jq._quant_act(jx)
    np.testing.assert_array_equal(q.permute(0, 2, 3, 1).numpy(), np.asarray(jqx))
    assert q.dtype == torch.int8 and float(s) == float(js)
    assert int(q.abs().max()) == 127
    qw, sw = quant.quant_w(tw)
    jqw, jsw = jq._quant_w(jw)
    np.testing.assert_array_equal(qw.permute(2, 3, 1, 0).numpy(), np.asarray(jqw))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(jsw))
    # a Dense kernel: [in, out] in JAX, [out, in] here
    qd, sd = quant.quant_w(tw[:, :, 0, 0])
    jqd, jsd = jq._quant_w(jw[0, 0])
    np.testing.assert_array_equal(qd.t().numpy(), np.asarray(jqd))
    np.testing.assert_array_equal(sd.numpy(), np.asarray(jsd))
    # an all-zero tensor: the scale's floor, zero values
    z, sz = quant.quant_act(torch.zeros(3, 4))
    jz, jsz = jq._quant_act(jnp.zeros((3, 4)))
    assert float(sz) == float(jsz) == np.float32(1e-8) and not z.any() and not np.any(jz)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_qconv_matches_jax(dtype, stride):
    tx, tw, jx, jw = _conv_inputs(dtype, seed=stride)
    # the int8 operands and the int32 accumulator: tolerance 0
    qx, _ = quant.quant_act(tx)
    qw, _ = quant.quant_w(tw)
    cols, (b, ho, wo) = quant.im2col(qx.permute(0, 2, 3, 1), (3, 3), (stride, stride), (1, 1))
    acc = quant.int_mm(cols, qw.permute(0, 2, 3, 1).reshape(qw.shape[0], -1))
    jacc = jax.lax.conv_general_dilated(
        jq._quant_act(jx)[0], jq._quant_w(jw)[0], (stride, stride), ((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    assert acc.dtype == torch.int32 and (b, ho, wo) == jacc.shape[:3]
    np.testing.assert_array_equal(acc.numpy().reshape(jacc.shape), np.asarray(jacc))
    got = quant.qconv(tx, tw, (stride, stride), (1, 1), out_dtype=tx.dtype)
    want = jq.qconv(jx, jw, strides=(stride, stride), padding=((1, 1), (1, 1)),
                    out_dtype=jx.dtype)
    assert got.dtype == tx.dtype and got.is_contiguous(memory_format=torch.channels_last)
    _assert_ulp(got.permute(0, 2, 3, 1).contiguous(), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_qdot_matches_jax(dtype):
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 5, 32)) * 2).astype(np.float32)
    w = (rng.standard_normal((32, 40)) * 0.2).astype(np.float32)
    tx, jx = torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)
    tw = torch.from_numpy(w).t().contiguous()
    acc = quant.int_mm(quant.quant_act(tx)[0].reshape(-1, 32), quant.quant_w(tw)[0])
    jacc = jax.lax.dot_general(jq._quant_act(jx)[0], jq._quant_w(jnp.asarray(w))[0],
                               (((2,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.numpy().reshape(jacc.shape), np.asarray(jacc))
    got = quant.qdot(tx, tw, out_dtype=tdt)
    assert got.shape == (2, 5, 40) and got.dtype == tdt
    _assert_ulp(got, jq.qdot(jx, jnp.asarray(w), out_dtype=jdt))


@pytest.mark.parametrize("m,k,n", [(16, 64, 40), (4, 60, 20), (17, 72, 24), (256, 288, 32)])
def test_card_branch_pads_to_what_int_mm_takes(monkeypatch, m, k, n):
    """The CUDA branch, taken on the CPU with ``torch._int_mm`` replaced by
    a checker of its CUDA rules (more than 16 rows, depth and width
    multiples of 8) and of the layout the route passes (both operands
    K-contiguous): the padded product, cut back, is the plain one."""
    seen = []

    def int_mm(a, b):
        assert a.dtype == b.dtype == torch.int8
        assert a.shape[0] > 16 and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0
        assert a.is_contiguous() and b.stride() == (1, b.shape[0])
        seen.append((tuple(a.shape), tuple(b.shape)))
        return (a.long() @ b.long()).to(torch.int32)

    monkeypatch.setattr(quant, "_on_cpu", lambda x: False)
    monkeypatch.setattr(torch, "_int_mm", int_mm)
    gen = torch.Generator().manual_seed(m)
    a = torch.randint(-127, 128, (m, k), generator=gen).to(torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=gen).to(torch.int8)
    quant.reset_counts()
    got = quant.int_mm(a, w)
    assert got.shape == (m, n) and torch.equal(got, quant.int_mm_reference(a, w))
    mp, kp, np_ = quant.int_mm_padding(m, k, n)
    assert mp == (32 if m <= 16 else m) and kp % 8 == 0 and np_ % 8 == 0
    assert seen == [((mp, kp), (kp, np_))] and quant.product_shapes == {(mp, kp, np_): 1}
    quant.reset_counts()


def test_int_mm_refuses_other_devices_and_types():
    a = torch.zeros(32, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        quant.int_mm(a.to("meta"), a.to("meta"))
    with pytest.raises(TypeError, match="int8"):
        quant.int_mm(a.float(), a)


def test_layers_take_the_route_only_while_the_flag_is_on():
    gen = torch.Generator().manual_seed(0)
    conv, lin = QConv2d(8, 16, 3, padding=1), QLinear(8, 24)
    plain_conv, plain_lin = Conv2d(8, 16, 3, padding=1), Linear(8, 24)
    plain_conv.load_state_dict(conv.state_dict())
    plain_lin.load_state_dict(lin.state_dict())
    x, t = torch.randn(2, 8, 5, 6, generator=gen), torch.randn(2, 3, 8, generator=gen)
    assert torch.equal(conv(x), plain_conv(x)) and torch.equal(lin(t), plain_lin(t))
    with quant.int8_inference():
        y, z = conv(x), lin(t)
    assert torch.equal(y, quant.qconv(x, conv.weight, (1, 1), (1, 1), torch.float32)
                       + conv.bias[:, None, None])
    assert torch.equal(z, quant.qdot(t, lin.weight, torch.float32) + lin.bias)
    assert (y - plain_conv(x)).abs().max() > 1e-3


def test_flag_is_restored_after_an_exception_and_stays_in_its_thread():
    assert not quant.int8_enabled()
    with pytest.raises(RuntimeError, match="inside"):
        with quant.int8_inference():
            assert quant.int8_enabled()
            with quant.int8_inference():
                pass
            assert quant.int8_enabled()
            seen = []
            th = threading.Thread(target=lambda: seen.append(quant.int8_enabled()))
            th.start()
            th.join(timeout=30)
            assert seen == [False]
            raise RuntimeError("inside")
    assert not quant.int8_enabled()


# --------------------------------------------------- the layers on the route

def _jax_int8_paths(cfg) -> set:
    """The JAX UNet's QConv/QDense module paths, traced (no compile)."""
    got = set()

    def record(next_fun, args, kwargs, context):
        if isinstance(context.module, (QConv, QDense)) and context.method_name == "__call__":
            got.add("/".join(context.module.scope.path))
        return next_fun(*args, **kwargs)

    x = jnp.zeros((1, 16, 16, 4))
    ctx = jnp.zeros((1, 4, cfg.cross_attention_dim))
    add = (jnp.zeros((1, cfg.addition_embed_dim)),) if cfg.addition_embed_dim else ()
    with nn.intercept_methods(record):
        jax.eval_shape(UNet2DCondition(cfg).init, jax.random.PRNGKey(0), x, jnp.array([1]),
                       ctx, *add)
    return got


@pytest.mark.parametrize("topology,count", [("sd15", 82), ("sd21", 82), ("sdxl_base", 178)])
def test_the_route_covers_exactly_the_jax_qconv_and_qdense_layers(topology, count):
    unet = UNet2DConditionModel(getattr(UNetConfig, topology)(), device="meta")
    got = {map_unet_key(f"{name}.weight").rsplit("/", 1)[0]
           for name, m in unet.named_modules() if isinstance(m, (QConv2d, QLinear))}
    want = _jax_int8_paths(dataclasses.replace(getattr(JUNetConfig, topology)(), remat=False))
    assert got == want and len(got) == count
    # the resnets' shortcuts, the projections and the attention stay off it
    assert not any(p.endswith(("conv_shortcut", "proj_in", "proj_out", "to_q", "to_out",
                               "time_emb_proj")) for p in got)


# ------------------------------------------------------- the tiny pipelines

def _cfgs(**kw):
    return (dataclasses.replace(JPipelineConfig.tiny(sample_size=SAMPLE), **kw),
            dataclasses.replace(PipelineConfig.tiny(sample_size=SAMPLE), **kw))


@pytest.fixture(scope="module")
def pipelines():
    """(jpipe, params, tpipe): both tiny guided pipelines under int8 on the
    JAX init (``tests/torch_parity.py``)."""
    return tiny_pipelines(*_cfgs(int8=True))


def _int8_products(monkeypatch):
    products = []
    real = quant.int_mm
    monkeypatch.setattr(quant, "int_mm", lambda a, w: products.append(a.shape) or real(a, w))
    return products


def _exact(pipe, **kw):
    return dataclasses.replace(pipe, config=dataclasses.replace(pipe.config, int8=False, **kw))


def _mean_abs(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).mean())


def _path(name: str) -> str:
    """A port UNet module name as its JAX module path."""
    return map_unet_key(f"{name}.weight").rsplit("/", 1)[0]


def _int8_layers(unet):
    return [(_path(n), m) for n, m in unet.named_modules() if isinstance(m, (QConv2d, QLinear))]


class LayerCalls:
    """Every call of the port UNet's int8 layers while the route is on:
    (JAX path, module, input, output), the tensors NHWC (or ``[..., C]``)
    numpy."""

    def __init__(self, unet):
        self.calls = []
        self.handles = []
        for path, m in _int8_layers(unet):
            self.handles.append(m.register_forward_hook(
                lambda mod, args, out, path=path: self.record(path, mod, args[0], out)))

    def record(self, path, mod, x, out) -> None:
        if quant.int8_enabled():
            self.calls.append((path, mod, _nhwc(x), _nhwc(out)))

    def close(self):
        for h in self.handles:
            h.remove()


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return (t.permute(0, 2, 3, 1) if t.ndim == 4 else t).detach().numpy()


def _ends(calls) -> list:
    """Each layer's first and last call of a run."""
    first, last = {}, {}
    for i, c in enumerate(calls):
        first.setdefault(c[0], i)
        last[c[0]] = i
    return [calls[i] for i in sorted(set(first.values()) | set(last.values()))]


def _held_layer_by_layer(calls, unet_params=None) -> None:
    """Each recorded int8 layer call against JAX's ``qconv``/``qdot`` (and
    the bias, as ``QConv``/``QDense`` add it) on the same input, with the
    JAX tree's weights (or, without ``unet_params``, the module's own in
    JAX's layout), op by op as written (under ``jit`` XLA rewrites the
    division and the rescale, which moves a level here and there): within
    1 ulp. A run's calls are held at each layer's first and last call
    (``_ends``; eager JAX takes ~30 ms a call)."""
    for path, mod, x, out in calls:
        if unet_params is None:
            w = mod.weight.detach()
            kernel = (w.permute(2, 3, 1, 0) if w.ndim == 4 else w.t()).numpy()
            bias = mod.bias.detach().numpy()
        else:
            leaf = unet_params
            for k in path.split("/"):
                leaf = leaf[k]
            kernel, bias = leaf["kernel"], leaf["bias"]
        if isinstance(mod, QLinear):
            want = jq.qdot(jnp.asarray(x), kernel, out_dtype=jnp.float32)
        else:
            want = jq.qconv(jnp.asarray(x), kernel, strides=tuple(mod.stride),
                            padding=((1, 1), (1, 1)), out_dtype=jnp.float32)
        _assert_ulp(torch.from_numpy(out), want + bias)


def _pinned_eps(jpipe):
    """JAX's int8 CFG epsilon with each ``QConv``/``QDense`` given the
    port's input for that layer (``pins``, by path), jitted."""
    eps = jpipe.eps_fn()

    def run(params, x, t, cond, uncond, pins):
        def pin(next_fun, args, kwargs, context):
            if isinstance(context.module, (QConv, QDense)) and context.method_name == "__call__":
                args = (pins["/".join(context.module.scope.path)],) + tuple(args[1:])
            return next_fun(*args, **kwargs)

        with nn.intercept_methods(pin):
            return eps(params, x, t, cond, uncond)
    return jax.jit(run)


def test_cfg_epsilon_under_int8_matches_jax(pipelines):
    """One CFG epsilon of the tiny UNet under int8 against JAX's int8 UNet
    run with each quantized layer's input pinned to the port's: within
    EPS_TOL, which is at least 10x below the int8-versus-exact gap. (Unpinned,
    the two differ by what moved levels make of fp32 summation order: the
    module's docstring.) Every layer call also against JAX's op."""
    jpipe, params, tpipe = pipelines
    rng = np.random.RandomState(4)
    ls = tpipe.config.latent_size
    x = rng.randn(2, ls, ls, 4).astype(np.float32)
    cond, uncond = (rng.randn(2, 8, 32).astype(np.float32) for _ in range(2))
    t = np.array(500, np.int32)
    targs = [torch.from_numpy(a) for a in (x, t, cond, uncond)]
    rec = LayerCalls(tpipe.unet)
    try:
        got = tpipe.eps_fn()(*targs).numpy()
    finally:
        rec.close()
    assert len(rec.calls) == 26 and len({c[0] for c in rec.calls}) == 26
    _held_layer_by_layer(rec.calls, params["unet"])
    pins = {path: xin for path, _, xin, _ in rec.calls}
    want = np.asarray(_pinned_eps(jpipe)(params, x, t, cond, uncond, pins))
    exact = np.asarray(jax.jit(jpipe.eps_fn(exact=True))(params, x, t, cond, uncond))
    err, gap = np.abs(got - want).max(), np.abs(want - exact).max()
    print(f"int8 epsilon: port against pinned JAX {err:.3e}, int8 against exact {gap:.3e}")
    assert err <= EPS_TOL and 10 * EPS_TOL <= gap, (err, gap)
    port_exact = _exact(tpipe).eps_fn()(*targs).numpy()
    assert np.abs(port_exact - exact).max() <= 1e-5  # the exact UNets: summation order


def _draws(lat, key):
    return dict(zip(("noise", "gamma0", "beta0"),
                    (torch.from_numpy(a) for a in jax_draws(jax.random.key(key), lat))))


@pytest.mark.parametrize("path", ["fused", "split"])
def test_guided_int8_expand_matches_jax_layer_by_layer(pipelines, path, monkeypatch):
    """``make_expand_fn`` and ``SplitExpand`` under int8 on the JAX
    expand's draws: every int8 layer call of the run against JAX's op on
    its input, 26 of them in each of the five plain-span UNet calls and
    none in the guidance update or the decode; the images moved from the
    exact run's."""
    _, params, tpipe = pipelines
    lat, cond, uncond, targets = inputs(tpipe.config.latent_size, 32, seed=1)
    draws = _draws(lat, 7)
    targs = [torch.from_numpy(a) for a in (lat, cond, uncond, targets)]
    products = _int8_products(monkeypatch)
    rec = LayerCalls(tpipe.unet)
    try:
        fn = tpipe.make_expand_fn() if path == "fused" else tpipe.make_split_expand()
        got = fn(*targs, **draws).numpy()
    finally:
        rec.close()
    start, n, guided, _, _ = tpipe.window()
    assert guided and n - start == 5 and len(rec.calls) == len(products) == 26 * 5
    _held_layer_by_layer(_ends(rec.calls), params["unet"])
    exact = _exact(tpipe)
    exact_fn = exact.make_expand_fn() if path == "fused" else exact.make_split_expand()
    assert _mean_abs(got, exact_fn(*targs, **draws).numpy()) > 1e-3


def test_int8_deep_cache_expand_matches_jax_layer_by_layer(pipelines):
    """int8 with DeepCache (interval 2, branch 0), unguided, through
    ``make_expand_fn`` and ``SplitExpand``: both run the full and the
    shallow calls on the route (three full calls of 26 layers and two
    shallow ones of 12), each layer call against JAX's op on its input."""
    _, params, tpipe = pipelines
    tp = dataclasses.replace(
        tpipe, config=dataclasses.replace(tpipe.config, deep_cache=True, cache_interval=2),
        guidance_cfg=dataclasses.replace(tpipe.guidance_cfg, guidance_type="none"))
    lat, cond, uncond, targets = inputs(tp.config.latent_size, 32, seed=2)
    targs = [torch.from_numpy(a) for a in (lat, cond, uncond, targets)]
    images = []
    for make in (tp.make_expand_fn, tp.make_split_expand):
        rec = LayerCalls(tp.unet)
        try:
            images.append(make()(*targs, **_draws(lat, 3)).numpy())
        finally:
            rec.close()
        shallow = {_path(n) for n, m in tp.unet.named_modules()
                   if isinstance(m, (QConv2d, QLinear)) and n.startswith(
                       ("down_blocks.0.resnets", "down_blocks.0.attentions", "up_blocks.1."))}
        assert len(shallow) == 12
        assert len(rec.calls) == 3 * 26 + 2 * len(shallow)
        _held_layer_by_layer(_ends(rec.calls), params["unet"])
    np.testing.assert_array_equal(images[0], images[1])


def test_guidance_update_and_decode_are_exact_under_int8(pipelines, monkeypatch):
    """The guidance update and the VAE decode run no int8 product and give
    the same bits with ``config.int8`` as without; a span's epsilon runs
    one product a layer."""
    tpipe = pipelines[2]
    products = _int8_products(monkeypatch)
    rng = np.random.RandomState(5)
    ls = tpipe.config.latent_size
    lat = torch.from_numpy((rng.randn(2, ls, ls, 4) * 0.5).astype(np.float32))
    cond, uncond = (torch.from_numpy(rng.randn(2, 8, 32).astype(np.float32)) for _ in range(2))
    gamma0 = torch.from_numpy(rng.rand(2, 1, 1, 4).astype(np.float32))
    beta0 = torch.from_numpy(rng.randn(2, 1, 1, 4).astype(np.float32))
    targets = torch.tensor([1, 2])
    out = {}
    for label, pipe in (("int8", tpipe), ("exact", _exact(tpipe))):
        g0 = pipe.window()[3]
        new, score, grads = transform_guidance(pipe.guidance_context(), lat, cond, uncond,
                                               targets, g0, gamma0, beta0)
        out[label] = (new, score, *grads, pipe.decode_latents(lat))
    assert not products
    for a, b in zip(out["int8"], out["exact"]):
        assert torch.equal(a, b)
    tpipe.eps_fn()(lat, torch.tensor(500), cond, uncond)
    layers = [m for m in tpipe.unet.modules() if isinstance(m, (QConv2d, QLinear))]
    assert len(products) == len(layers) == 26


# ------------------------------------------------------------------- SDXL

@pytest.fixture(scope="module")
def sdxl_pipe():
    """The port's ``SDXLPipeline`` at ``sdxl_tiny`` under int8 (seeded
    weights, CFG 5, strength 0.5); its layers are held against JAX's ops
    with their own weights."""
    tcfg = dataclasses.replace(PipelineConfig.sdxl_tiny(sample_size=SAMPLE), int8=True)
    return sdxl.SDXLPipeline.create(tcfg, sampler_cfg=sdxl.SamplerConfig(guidance_scale=5.0),
                                    seed=2, device="cpu")


@pytest.mark.parametrize("text_to_img", [True, False], ids=["t2i", "img2img"])
def test_sdxl_int8_sampling_matches_jax_layer_by_layer(sdxl_pipe, text_to_img):
    """``SDXLPipeline``'s text-to-image (10 steps) and img2img (5) under
    int8: every int8 layer call of every step (42 layers at sdxl_tiny)
    against JAX's op on its input; the images moved from the exact
    run's."""
    tpipe = sdxl_pipe
    rng = np.random.RandomState(6)
    ls = tpipe.config.latent_size
    lat = (rng.randn(2, ls, ls, 4) * 0.13).astype(np.float32)
    c = [torch.from_numpy(rng.randn(*s).astype(np.float32))
         for s in ((2, 16, 48), (2, 64), (2, 16, 48), (2, 64))]
    args = (torch.from_numpy(lat), {"ctx": c[0], "add": c[1]}, {"ctx": c[2], "add": c[3]})
    noise = torch.from_numpy(np.array(jax.random.normal(jax.random.key(2), lat.shape)))
    rec = LayerCalls(tpipe.unet)
    try:
        got = tpipe.make_sample_fn(text_to_img)(*args, noise=noise).numpy()
    finally:
        rec.close()
    layers = len(_int8_layers(tpipe.unet))
    assert got.shape == (2, SAMPLE, SAMPLE, 3)
    assert len(rec.calls) == layers * (10 if text_to_img else 5)
    _held_layer_by_layer(_ends(rec.calls))
    exact = _exact(tpipe).make_sample_fn(text_to_img)(*args, noise=noise).numpy()
    assert _mean_abs(got, exact) > 1e-3
