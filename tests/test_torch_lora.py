"""``train/lora.py`` in the port against the JAX package's: the adapted
leaves of SD-1.5, SD-2.1 and SDXL-base (from shapes alone) at the default
and at custom targets, the identity init, the leaves a merge moves, the
merged weights, the denoising loss and its gradients on the JAX side's
draws (epsilon, v-prediction and ``sdxl_tiny``'s dict conditioning, the
UNet's inner checkpoints on and off), one AdamW update against optax's, and
adapter files read across the packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distdiff_tpu.config import PipelineConfig as JPipelineConfig
from distdiff_tpu.config import UNetConfig as JUNetConfig
from distdiff_tpu.models import UNet2DCondition
from distdiff_tpu.schedulers.ddim import make_schedule as j_make_schedule
from distdiff_tpu.train import lora as jl
from distdiff_tpu_torch.config import PipelineConfig, UNetConfig
from distdiff_tpu_torch.models import UNet2DConditionModel
from distdiff_tpu_torch.models.layers import with_remat
from distdiff_tpu_torch.schedulers import make_schedule
from distdiff_tpu_torch.train import lora as tl
from distdiff_tpu_torch.weights.from_jax import state_dict_from_jax

torch.set_num_threads(1)

# fp32 on both sides, the same weights, adapter and draws: only the
# summation order differs, ~1e-6 relative through one UNet call and its
# backward. Gradients are held relative to their largest element.
TOL_LOSS = 1e-5
TOL_GRAD = 1e-4
LR = 1e-3


def _init_args(jcfg, batch=2, side=8):
    args = [jnp.zeros((batch, side, side, 4)), jnp.zeros((batch,), jnp.int32),
            jnp.zeros((batch, 6, jcfg.cross_attention_dim))]
    if jcfg.addition_embed_dim:
        args.append(jnp.zeros((batch, jcfg.addition_embed_dim)))
    return args


@pytest.mark.parametrize("model", ["sd15", "sd21", "sdxl_base"])
def test_adapted_leaves_are_the_jax_packages(model):
    jcfg, tcfg = getattr(JUNetConfig, model)(), getattr(UNetConfig, model)()
    shapes = jax.eval_shape(UNet2DCondition(jcfg).init, jax.random.PRNGKey(0),
                            *_init_args(jcfg, 1))["params"]
    unet = UNet2DConditionModel(tcfg, device="meta")
    for targets in (tl.DEFAULT_TARGETS, ("proj",), ("ff", "conv", "time")):
        assert tl.lora_keys(unet, targets) == jl.lora_keys(shapes, targets), targets
    table = tl.lora_table(unet)
    n = sum(8 * (i + o) for _, (i, o) in table.values())
    want = {"sd15": (128, 1_594_368), "sd21": (128, 1_659_904),
            "sdxl_base": (560, 11_612_160)}[model]
    assert (len(table), n) == want
    if model == "sd15":
        # SD-1.x's proj_in is a 1x1 convolution here, a 2-D Dense in JAX
        name, shape = tl.lora_table(unet, ("proj",))["down_0_attn_0/proj_in/kernel"]
        assert name == "down_blocks.0.attentions.0.proj_in.weight" and shape == (320, 320)
        assert unet.get_parameter(name).shape == (320, 320, 1, 1)


# ------------------------------------------------------------ tiny parity

CASES = {
    "epsilon": (JUNetConfig.tiny, UNetConfig.tiny, "epsilon"),
    "v_prediction": (JUNetConfig.tiny, UNetConfig.tiny, "v_prediction"),
    "sdxl": (lambda: JPipelineConfig.sdxl_tiny().unet,
             lambda: PipelineConfig.sdxl_tiny().unet, "epsilon"),
}


_PARAMS = {}


def _case(name, side=8, batch=2):
    """The JAX UNet and its params (numpy; initialised once a module), the
    port's UNet on them (a new one each call, inner checkpoints on), the
    two schedules, latents and a context."""
    jmake, tmake, pred = CASES[name]
    # the JAX step without its nn.remat compiles faster and gives the same
    # values; the port's UNet keeps its checkpoints (with_remat turns them off)
    jcfg = dataclasses.replace(jmake(), remat=False)
    tcfg = dataclasses.replace(tmake(), remat=True)
    junet = UNet2DCondition(jcfg)
    key = (jmake, side, batch)
    if key not in _PARAMS:
        _PARAMS[key] = jax.tree.map(np.asarray, jax.jit(junet.init)(
            jax.random.PRNGKey(0), *_init_args(jcfg, batch, side))["params"])
    params = _PARAMS[key]
    unet = UNet2DConditionModel(tcfg, device="cpu")
    unet.load_state_dict(state_dict_from_jax(params, tcfg))
    unet.requires_grad_(False)
    rng = np.random.RandomState(1)
    lat = (rng.randn(batch, side, side, 4) * 0.5).astype(np.float32)
    ctx = rng.randn(batch, 6, jcfg.cross_attention_dim).astype(np.float32)
    if jcfg.addition_embed_dim:
        ctx = {"ctx": ctx, "add": rng.randn(batch, jcfg.addition_embed_dim).astype(np.float32)}
    return (junet, params, j_make_schedule(10, prediction_type=pred), unet,
            make_schedule(10, prediction_type=pred), lat, ctx)


def _to_port(jlora):
    return {k: {p: torch.from_numpy(np.array(v)).requires_grad_() for p, v in pair.items()}
            for k, pair in jlora.items()}


def _perturbed(params, rank=4, seed=2, targets=jl.DEFAULT_TARGETS):
    """A JAX adapter with b != 0 (numpy leaves)."""
    lora = jl.init_lora(jax.random.PRNGKey(seed), params, rank=rank, targets=targets)
    rng = np.random.RandomState(seed)
    return {k: {"a": np.asarray(p["a"]), "b": (0.05 * rng.randn(*p["b"].shape)).astype(np.float32)}
            for k, p in lora.items()}


def test_init_is_the_identity_and_a_merge_moves_only_the_targets():
    _, params, _, unet, _, lat, ctx = _case("epsilon")
    lora = tl.init_lora(torch.Generator().manual_seed(1), unet, rank=4)
    assert sorted(lora) == jl.lora_keys(params)
    for key, pair in lora.items():
        assert pair["a"].shape[1] == pair["b"].shape[0] == 4 and not pair["b"].any()
        assert pair["a"].requires_grad and pair["b"].requires_grad
    x, t, c = torch.from_numpy(lat), torch.tensor([5, 9]), torch.from_numpy(ctx)
    with torch.no_grad():
        ref = unet(x, t, c)
        with tl.apply_lora(unet, lora, alpha=8.0):
            out = unet(x, t, c)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    before = {k: v.clone() for k, v in unet.state_dict().items()}
    moved = _to_port(_perturbed(params))
    with tl.apply_lora(unet, moved, alpha=2.0):
        inside = {k: v.clone() for k, v in unet.state_dict().items()}
    # the block puts every parameter back, the same objects in the same order
    assert list(unet.state_dict()) == list(before)
    for k, v in unet.state_dict().items():
        assert torch.equal(v, before[k]), k
    names = {tl.lora_table(unet)[key][0] for key in moved}
    for k in before:
        if k in names:
            assert not torch.equal(inside[k], before[k]), k
        else:
            assert torch.equal(inside[k], before[k]), k
    bad = dict(moved, **{"not/a/real/leaf/kernel": moved[sorted(moved)[0]]})
    with pytest.raises(KeyError, match="not/a/real/leaf/kernel"):
        with tl.apply_lora(unet, bad):
            pass
    with pytest.raises(KeyError):
        tl.merge_lora(unet, bad)
    for k, v in unet.state_dict().items():
        assert torch.equal(v, before[k]), k
    with pytest.raises(ValueError, match="no LoRA targets"):
        tl.init_lora(torch.Generator(), unet, targets=("nothing",))


def test_merged_weights_are_the_jax_merge():
    _, params, _, unet, _, _, _ = _case("epsilon")
    targets = tl.DEFAULT_TARGETS + ("proj",)  # proj_in/proj_out: 1x1 convolutions here
    jlora = _perturbed(params, rank=3, targets=targets)
    want = state_dict_from_jax(
        jax.tree.map(np.asarray, jl.merge_lora(params, jlora, alpha=5.0)), unet.config)
    tl.merge_lora(unet, _to_port(jlora), alpha=5.0)
    got = unet.state_dict()
    names = {tl.lora_table(unet, targets)[k][0] for k in jlora}
    assert any(got[n].ndim == 4 for n in names)
    for k, v in got.items():
        # fp32 W + (a @ b) * scale over a rank-3 product: at most one ulp
        torch.testing.assert_close(v, want[k], atol=0, rtol=2.0 ** -23 if k in names else 0,
                                   msg=k)


def _jax_step(junet, params, jsched, lat, ctx, jlora, alpha, key):
    """JAX's ``make_lora_train_step`` under optax's adamw: (loss, the
    gradients it took, the updated adapter), numpy; the gradients are
    recorded by a transformation chained before adamw."""
    def capture():
        def update(g, state, params=None):
            return g, g
        return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p), update)

    tx = optax.chain(capture(), optax.adamw(LR, weight_decay=1e-2))
    apply_fn = None
    if isinstance(ctx, dict):
        def apply_fn(p, x, t, c):
            return junet.apply({"params": p}, x, t, c["ctx"], c["add"])
    step = jax.jit(jl.make_lora_train_step(junet, jsched, tx, alpha=alpha, apply_fn=apply_fn))
    lora, opt_state, loss = step(jlora, tx.init(jlora), params, jnp.asarray(lat),
                                 jax.tree.map(jnp.asarray, ctx), key)
    return (float(loss), jax.tree.map(np.asarray, opt_state[0]), jax.tree.map(np.asarray, lora))


def _jax_draws(key, lat):
    """The step's own draws from ``key``: timesteps and noise."""
    rng_t, rng_n = jax.random.split(key)
    t = jax.random.randint(rng_t, (lat.shape[0],), 0, 1000)
    return (torch.from_numpy(np.array(t)).long(),
            torch.from_numpy(np.array(jax.random.normal(rng_n, lat.shape, jnp.float32))))


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax_on_its_draws_with_and_without_inner_remat(case):
    junet, params, jsched, unet, sched, lat, ctx = _case(case)
    jlora, alpha, key = _perturbed(params), 4.0, jax.random.PRNGKey(11)
    jloss, jgrads, jnew = _jax_step(junet, params, jsched, lat, ctx, jlora, alpha, key)
    t, noise = _jax_draws(key, lat)
    x = torch.from_numpy(lat)
    c = ({k: torch.from_numpy(v) for k, v in ctx.items()} if isinstance(ctx, dict)
         else torch.from_numpy(ctx))
    grads = {}
    for remat in (True, False):
        model = with_remat(unet, remat)
        loss, grads[remat] = tl.lora_value_and_grad(model, sched, _to_port(jlora), x, c, t,
                                                    noise, alpha)
        assert abs(float(loss) - jloss) <= TOL_LOSS * abs(jloss), (remat, float(loss), jloss)
        for k in jlora:
            for p in ("a", "b"):
                err = _rel(grads[remat][k][p].numpy(), jgrads[k][p])
                assert err <= TOL_GRAD, (remat, k, p, err)
    # the inner checkpoints recompute the same forward: the same gradients
    for k in jlora:
        for p in ("a", "b"):
            torch.testing.assert_close(grads[True][k][p], grads[False][k][p], atol=1e-7,
                                       rtol=1e-5)
    # one AdamW update from the same state: about lr * sign(g) an element,
    # so an element whose gradient is within fp32 noise of 0 may move by 2 lr
    lora = _to_port(jlora)
    step = tl.make_lora_train_step(unet, sched, tl.make_optimizer(lora, LR, 1e-2), alpha)
    assert abs(float(step(lora, x, c, t, noise)) - jloss) <= TOL_LOSS * abs(jloss)
    diffs = np.concatenate([np.abs(lora[k][p].detach().numpy() - jnew[k][p]).ravel()
                            for k in jlora for p in ("a", "b")])
    assert diffs.max() <= 2 * LR and np.mean(diffs > 1e-6) <= 1e-3, (diffs.max(),
                                                                    np.mean(diffs > 1e-6))


def test_adapter_files_are_read_across_packages(tmp_path):
    _, params, _, unet, _, _, _ = _case("epsilon")
    jlora = _perturbed(params, rank=2)
    jl.save_lora(str(tmp_path / "jax.npz"), jlora, alpha=6.0)
    lora, alpha = tl.load_lora(str(tmp_path / "jax.npz"))
    assert alpha == 6.0 and sorted(lora) == sorted(jlora)
    for k in jlora:
        for p in ("a", "b"):
            np.testing.assert_array_equal(lora[k][p].numpy(), jlora[k][p])
    tl.save_lora(str(tmp_path / "port.npz"), lora, alpha=alpha)
    back, jalpha = jl.load_lora(str(tmp_path / "port.npz"))
    assert jalpha == 6.0
    want = np.load(str(tmp_path / "jax.npz"))
    got = np.load(str(tmp_path / "port.npz"))
    assert sorted(got.files) == sorted(want.files)
    for name in want.files:
        assert got[name].dtype == want[name].dtype == np.float32
        np.testing.assert_array_equal(got[name], want[name])
    m_j = jl.merge_lora(params, back, jalpha)
    tl.merge_lora(unet, lora, alpha)
    for k, v in state_dict_from_jax(jax.tree.map(np.asarray, m_j), unet.config).items():
        torch.testing.assert_close(unet.state_dict()[k], v, atol=0, rtol=2.0 ** -23)


def test_draws_and_a_few_steps_learn():
    _, _, _, unet, sched, lat, ctx = _case("epsilon")
    gen = torch.Generator().manual_seed(3)
    t, noise = tl.draw_t_noise(gen, 2, (8, 8, 4), 1000)
    assert t.dtype == torch.int64 and t.shape == (2,) and 0 <= int(t.min()) <= int(t.max()) < 1000
    assert noise.dtype == torch.float32 and noise.shape == (2, 8, 8, 4)
    lora = tl.init_lora(torch.Generator().manual_seed(4), unet, rank=4)
    step = tl.make_lora_train_step(unet, sched, tl.make_optimizer(lora, 1e-2, 0.0), 4.0)
    x, c = torch.from_numpy(lat), torch.from_numpy(ctx)
    fixed = [tl.draw_t_noise(gen, 2, (8, 8, 4), 1000) for _ in range(2)]
    losses = [float(step(lora, x, c, *fixed[i % 2])) for i in range(12)]
    assert np.mean(losses[-2:]) < np.mean(losses[:2]) * 0.9, losses
    assert all(not p.requires_grad for p in unet.parameters())
    assert any(lora[k]["b"].abs().max() > 0 for k in lora)
