"""The port's MoE layer and model against the JAX package's, on the CPU.

f32 throughout, params carried across with params_from_numpy. Dispatch
(which expert slot each (token, choice) claims): exact; combine weights
1e-6; logits and outputs 1e-4 absolute (the two sides sum in another
order); aux losses, the loss and its gradients 1e-5 / 1e-4. Twins of the
route and moe_forward cases of tests/test_parallel_extra.py (:27, :35,
:43), plus the cases where torch and JAX could part: equal router logits
(lax.top_k keeps the lower index first), overflow at the default capacity
(the claim order decides who drops) and the pad mask. The train step
against JAX's ``make_moe_train_step`` on a 1-device mesh, dense and flash
(the JAX side's Pallas kernels in interpret mode): loss 1e-5, Adam moments
1e-6, params 1e-5 where |g| >= 1e-7 (tests/test_torch_train.py's rule),
the second step's loss 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.sharding import NamedSharding

from gpu_provisioner_tpu.models import moe as jm
from gpu_provisioner_tpu.models import train as jtrain
from gpu_provisioner_tpu.parallel.topology import make_mesh
from gpu_provisioner_tpu_torch.models import moe as tm
from gpu_provisioner_tpu_torch.models import train as ttrain
from gpu_provisioner_tpu_torch.models.convert import params_from_numpy

JCFG = dataclasses.replace(jm.PRESETS_MOE["tiny-moe"], dtype="float32")
JPARAMS = jm.init_moe_model(jax.random.key(0), JCFG)
TPARAMS = params_from_numpy(jax.tree.map(np.asarray, JPARAMS), device="cpu")
ATOL = 1e-4


def _tcfg(jcfg):
    return tm.MoEConfig(**dataclasses.asdict(jcfg))


def _normal(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, JCFG.vocab_size, shape,
                                                dtype=np.int32)


def _routes(logits, k, cap, mask=None):
    """(port dispatch, port combine, JAX dispatch, JAX combine) as numpy."""
    td_, tc_ = tm.route(torch.from_numpy(logits), k, cap,
                        token_mask=None if mask is None
                        else torch.from_numpy(mask))
    jd_, jc_ = jm.route(jnp.asarray(logits), k, cap,
                        token_mask=None if mask is None
                        else jnp.asarray(mask))
    return td_.numpy(), tc_.numpy(), np.asarray(jd_), np.asarray(jc_)


def _same_route(logits, k, cap, mask=None):
    td_, tc_, jd_, jc_ = _routes(logits, k, cap, mask)
    np.testing.assert_array_equal(td_, jd_)
    np.testing.assert_allclose(tc_, jc_, atol=1e-6)
    return td_, tc_


def test_route_top1_ample_capacity_places_every_token():
    dispatch, combine = _same_route(_normal(0, (2, 16, 4)), 1, cap=16)
    assert dispatch.sum() == 2 * 16
    np.testing.assert_allclose(combine.sum(axis=(2, 3)), 1.0, atol=1e-5)


def test_route_capacity_drops_overflow():
    logits = np.zeros((1, 8, 4), np.float32)
    logits[:, :, 0] = 10.0      # every token prefers expert 0
    dispatch, _ = _same_route(logits, 1, cap=2)
    assert dispatch[..., 0, :].sum() == 2.0
    assert dispatch.sum() == 2.0


@pytest.mark.parametrize("case", ["all-equal", "pairs", "top-tie"])
def test_route_breaks_ties_toward_the_lower_expert_as_lax_top_k(case):
    """Equal router logits (a zero hidden vector gives them): lax.top_k
    keeps the lower index first, torch.topk promises no order."""
    E = 8
    if case == "all-equal":
        logits = np.zeros((2, 6, E), np.float32)
    elif case == "pairs":    # experts tied in pairs, at random levels
        logits = np.repeat(_normal(1, (2, 6, E // 2)), 2, axis=-1)
    else:                    # the top two tie, the rest lower
        logits = _normal(2, (2, 6, E)) - 10.0
        logits[..., 5] = logits[..., 2] = 3.0
    dispatch, _ = _same_route(logits, 2, cap=12)
    if case == "all-equal":  # experts 0 and 1 take every token
        assert dispatch[..., :2, :].sum() == 2 * 6 * 2
    if case == "top-tie":
        assert dispatch[..., [2, 5], :].sum() == 2 * 6 * 2


def test_route_overflow_at_the_default_capacity_claims_in_jax_order():
    """Skewed logits at capacity(cfg, S): tokens drop, and the same ones."""
    cfg = _tcfg(JCFG)
    S = 32
    logits = _normal(3, (2, S, cfg.n_experts))
    logits[..., 1] += 2.0            # expert 1 oversubscribed
    cap = tm.capacity(cfg, S)
    assert cap == jm.capacity(JCFG, S) == 20
    dispatch, _ = _same_route(logits, cfg.experts_per_token, cap)
    assert dispatch.sum() < 2 * S * cfg.experts_per_token   # some dropped
    assert dispatch.sum(axis=1).max() == 1.0     # one token a slot a row


def test_route_masked_tokens_claim_nothing():
    logits = _normal(4, (2, 10, 4))
    mask = np.ones((2, 10), bool)
    mask[1, :6] = False
    dispatch, combine = _same_route(logits, 2, cap=3, mask=mask)
    assert dispatch[1, :6].sum() == 0 and combine[1, :6].sum() == 0


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cap", [None, 3, 24])
def test_moe_ffn_matches_jax(masked, cap):
    """One layer's FFN with and without a pad mask, at the default
    capacity, a small one that drops and the drop-free one (S)."""
    B, S = 2, 24
    x = _normal(5, (B, S, JCFG.dim))
    mask = None
    if masked:
        mask = np.ones((B, S), bool)
        mask[0, :5] = False
    jlp = jax.tree.map(lambda a: a[0], JPARAMS["moe"])
    tlp = {k: v[0] for k, v in TPARAMS["moe"].items()}
    jout, jaux = jm.moe_ffn(jnp.asarray(x), jlp, JCFG,
                            token_mask=None if mask is None
                            else jnp.asarray(mask), cap_override=cap)
    tout, taux = tm.moe_ffn(torch.from_numpy(x), tlp, _tcfg(JCFG),
                            token_mask=None if mask is None
                            else torch.from_numpy(mask), cap_override=cap,
                            aux=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL)
    for name in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   atol=1e-5, rtol=1e-6)
    out, none = tm.moe_ffn(torch.from_numpy(x), tlp, _tcfg(JCFG),
                           token_mask=None if mask is None
                           else torch.from_numpy(mask), cap_override=cap)
    assert none is None
    torch.testing.assert_close(out, tout, atol=0, rtol=0)


def test_moe_forward_shapes_and_aux():
    cfg = tm.PRESETS_MOE["tiny-moe"]
    params = tm.init_moe_model(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    tokens = torch.zeros(2, 16, dtype=torch.int32)
    logits, aux = tm.moe_forward(params, tokens, cfg)
    assert tuple(logits.shape) == (2, 16, cfg.vocab_size)
    assert set(aux) == {"load_balance", "router_z"}
    assert float(aux["load_balance"]) >= 1.0   # ≥ 1 by construction (Switch)


@pytest.mark.parametrize("remat", [False, True])
def test_moe_forward_matches_jax(remat):
    jcfg = dataclasses.replace(JCFG, remat=remat)
    toks = _tokens(6, (2, 32))
    jlog, jaux = jm.moe_forward(JPARAMS, jnp.asarray(toks), jcfg)
    tlog, taux = tm.moe_forward(TPARAMS, torch.from_numpy(toks),
                                _tcfg(jcfg))
    np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(jlog),
                               atol=ATOL)
    for name in jaux:
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("remat", [False, True])
def test_moe_loss_and_grads_match_jax(remat):
    jcfg = dataclasses.replace(JCFG, remat=remat)
    toks = _tokens(7, (2, 33))
    inputs, targets = toks[:, :-1], toks[:, 1:]
    jloss, jgrads = jax.value_and_grad(jm.moe_loss_fn)(
        JPARAMS, jnp.asarray(inputs), jnp.asarray(targets), jcfg)
    params = jax.tree.map(lambda t: t.clone().requires_grad_(True), TPARAMS)
    tloss = tm.moe_loss_fn(params, torch.from_numpy(inputs),
                           torch.from_numpy(targets), _tcfg(jcfg))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               atol=1e-5)
    for path, jg in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        t = params
        for key in path:
            t = t[key.key]
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   atol=ATOL, err_msg=str(path))


def test_init_moe_model_layout():
    """No dense FFN in the backbone; experts in the storage dtype, the
    router and lm_head in f32; the JAX tree's shapes."""
    cfg = tm.PRESETS_MOE["tiny-moe"]
    params = tm.init_moe_model(cfg, torch.Generator().manual_seed(0),
                               device="cpu", dtype=torch.bfloat16)
    assert not {"w_gate", "w_up", "w_down"} & set(params["backbone"]
                                                  ["blocks"])
    assert params["moe"]["router"].dtype == torch.float32
    assert params["backbone"]["lm_head"].dtype == torch.float32
    for w in ("w_gate", "w_up", "w_down"):
        assert params["moe"][w].dtype == torch.bfloat16
    shapes = jax.tree.map(lambda a: tuple(a.shape), JPARAMS)
    assert jax.tree.map(lambda t: tuple(t.shape), params) == shapes
    with pytest.raises(ValueError, match="generator on cpu"):
        tm.init_moe_model(cfg, torch.Generator(), device="meta")


def test_params_from_numpy_keeps_the_router_in_f32():
    tree = jax.tree.map(np.asarray, JPARAMS)
    params = params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    assert params["moe"]["router"].dtype == torch.float32
    assert params["backbone"]["lm_head"].dtype == torch.float32
    assert params["moe"]["w_up"].dtype == torch.bfloat16
    assert params["backbone"]["blocks"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(params["moe"]["router"].numpy(),
                                  tree["moe"]["router"])


def _named(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _level0(jitted, *args):
    """``jitted`` compiled for ``args`` at LLVM's optimisation level 0 (a
    third less CPU to compile a program that runs twice)."""
    return jitted.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


@pytest.mark.parametrize("impl,S", [("dense", 32), ("flash", 128)])
def test_moe_train_step_matches_jax(impl, S):
    """make_moe_train_step against JAX's from the same params and batch:
    the loss, the AdamW moments and the updated params, then a second
    step's loss."""
    jcfg = dataclasses.replace(JCFG, attn_impl=impl)
    mesh = make_mesh(1, devices=[jax.devices()[0]])
    put = lambda x: jax.device_put(jnp.asarray(x),
                                   NamedSharding(mesh, jtrain.BATCH_SPEC))
    opt = jtrain.default_optimizer()
    jparams = jtrain.shard_params(jax.tree.map(jnp.copy, JPARAMS), mesh,
                                  specs=jm.moe_model_specs(jcfg))
    jstate = opt.init(jparams)
    toks = [_tokens(20 + i, (2, S + 1)) for i in range(2)]
    inp, tgt = put(toks[0][:, :-1]), put(toks[0][:, 1:])
    attn = jtrain.make_attn_fn(mesh, impl=impl)
    grad = jax.jit(lambda p, a, b: jax.grad(jm.moe_loss_fn)(p, a, b, jcfg,
                                                            attn))
    jgrads = _level0(grad, jparams, inp, tgt)(jparams, inp, tgt)
    jstep = _level0(jm.make_moe_train_step(mesh, jcfg, opt), jparams, jstate,
                    inp, tgt)
    jparams, jstate, jloss = jstep(jparams, jstate, inp, tgt)

    params, optimizer = ttrain.train_state_from(
        jax.tree.map(torch.clone, TPARAMS))
    step = tm.make_moe_train_step(_tcfg(jcfg), optimizer)
    loss = step(params, *(torch.from_numpy(a)
                          for a in (toks[0][:, :-1], toks[0][:, 1:])))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    mu, nu = _named(jstate[0].mu), _named(jstate[0].nu)
    want_p, g = _named(jparams), _named(jgrads)
    assert _named(params).keys() == want_p.keys()
    excluded = 0
    for name, p in _named(params).items():
        st = optimizer.state[p]
        np.testing.assert_allclose(st["exp_avg"].numpy(),
                                   np.asarray(mu[name]), atol=1e-6,
                                   err_msg=name)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                   np.asarray(nu[name]), atol=1e-6,
                                   err_msg=name)
        gj = np.asarray(g[name])
        steady = (np.abs(gj) >= 1e-7) | (gj == 0)
        excluded += int((~steady).sum())
        np.testing.assert_allclose(p.detach().numpy()[steady],
                                   np.asarray(want_p[name])[steady],
                                   atol=1e-5, err_msg=name)
    n = sum(p.numel() for p in ttrain.param_leaves(params))
    assert excluded < n // 1000, f"{excluded} of {n} elements excluded"

    inp2, tgt2 = put(toks[1][:, :-1]), put(toks[1][:, 1:])
    _, _, jloss2 = jstep(jparams, jstate, inp2, tgt2)
    loss2 = step(params, *(torch.from_numpy(a)
                           for a in (toks[1][:, :-1], toks[1][:, 1:])))
    np.testing.assert_allclose(loss2.item(), float(jloss2), rtol=1e-5)


def test_make_moe_train_state_keeps_f32_masters():
    cfg = tm.PRESETS_MOE["tiny-moe"]
    params, optimizer = tm.make_moe_train_state(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    leaves = ttrain.param_leaves(params)
    assert all(p.dtype == torch.float32 and p.requires_grad for p in leaves)
    assert type(optimizer) is torch.optim.AdamW
    assert {id(p) for g in optimizer.param_groups
            for p in g["params"]} == {id(p) for p in leaves}
