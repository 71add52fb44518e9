"""The port's training step against the JAX package's, on the CPU.

``tiny`` in f32; JAX params carry across through numpy (params_from_numpy),
token batches come from a numpy seed. With attn_impl="flash" at S=128 the
JAX backward runs its Pallas kernels #6/#7 in interpret mode and the port
runs their plain versions. Tolerances: loss 1e-5, gradients 1e-4 absolute
(matmuls and the attention sums run in another order on the two sides),
Adam moments 1e-6; updated params 1e-5, except where |g| < 1e-7: there
Adam's first step is about lr·sign(g), so a gradient that rounds to the
other sign moves its element by up to 2·lr. The test counts them (2 of
106816 with these inputs) and keeps g = 0 (the embedding rows of absent
tokens), which moves by the decay alone on both sides.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from gpu_provisioner_tpu.models import llama as jl
from gpu_provisioner_tpu.models import train as jtrain
from gpu_provisioner_tpu.parallel.topology import make_mesh
from gpu_provisioner_tpu_torch.models import llama as tl
from gpu_provisioner_tpu_torch.models import train as ttrain
from gpu_provisioner_tpu_torch.models.convert import params_from_numpy

JCFG = dataclasses.replace(jl.PRESETS["tiny"], dtype="float32")
JPARAMS = jl.init_params(jax.random.key(0), JCFG)


def _tcfg(jcfg, **kw):
    return tl.LlamaConfig(**{**dataclasses.asdict(jcfg), **kw})


def _state(params=JPARAMS):
    """A fresh port train state holding a copy of the JAX params."""
    return ttrain.train_state_from(
        params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"))


def _batch(seed, B, S):
    toks = np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, (B, S + 1), dtype=np.int32)
    return toks[:, :-1], toks[:, 1:]


def _named(tree):
    """{path: leaf} of a nested dict, in the tree's order."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{n}": x for n, x in _named(v).items()})
        else:
            out[k] = v
    return out


def _port_grads(params, cfg, inp, tgt):
    loss = ttrain.loss_fn(params, torch.from_numpy(inp),
                          torch.from_numpy(tgt), cfg)
    leaves = ttrain.param_leaves(params)
    return loss, dict(zip(_named(params), torch.autograd.grad(loss, leaves)))


@pytest.mark.parametrize("impl,S", [("dense", 64), ("flash", 128)])
def test_loss_and_grads_match_jax_value_and_grad(impl, S):
    jcfg = dataclasses.replace(JCFG, attn_impl=impl)
    inp, tgt = _batch(1, 2, S)
    jloss, jgrads = jax.value_and_grad(jtrain.loss_fn)(
        JPARAMS, jnp.asarray(inp), jnp.asarray(tgt), jcfg)
    params, _ = _state()
    loss, grads = _port_grads(params, _tcfg(jcfg), inp, tgt)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = _named(jgrads)
    assert grads.keys() == want.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]),
                                   atol=1e-4, err_msg=name)


def test_train_step_matches_jax_adamw_step():
    """One step of each, from the same params and batch: optax.adamw's
    moments and update against torch AdamW's, then a second step's loss."""
    inp, tgt = _batch(2, 4, 64)
    mesh = make_mesh(1, devices=[jax.devices()[0]])
    put = lambda x: jax.device_put(jnp.asarray(x),
                                   NamedSharding(mesh, jtrain.BATCH_SPEC))
    opt = jtrain.default_optimizer()
    jparams = jtrain.shard_params(jax.tree.map(jnp.copy, JPARAMS), mesh, JCFG)
    jstate = opt.init(jparams)
    jgrads = jax.grad(jtrain.loss_fn)(JPARAMS, jnp.asarray(inp),
                                      jnp.asarray(tgt), JCFG)
    jstep = jtrain.make_train_step(mesh, JCFG, opt)
    jparams, jstate, jloss = jstep(jparams, jstate, put(inp), put(tgt))

    params, optimizer = _state()
    step = ttrain.make_train_step(_tcfg(JCFG), optimizer)
    loss = step(params, torch.from_numpy(inp), torch.from_numpy(tgt))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)

    adam = jstate[0]
    mu, nu = _named(adam.mu), _named(adam.nu)
    want_p, g = _named(jparams), _named(jgrads)
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
        steady = (np.abs(gj) >= 1e-7) | (gj == 0)   # 0: decay alone, exact
        excluded += int((~steady).sum())
        np.testing.assert_allclose(p.detach().numpy()[steady],
                                   np.asarray(want_p[name])[steady],
                                   atol=1e-5, err_msg=name)
    n = sum(p.numel() for p in ttrain.param_leaves(params))
    assert excluded < n // 1000, f"{excluded} of {n} elements excluded"

    inp2, tgt2 = _batch(3, 4, 64)
    _, _, jloss2 = jstep(jparams, jstate, put(inp2), put(tgt2))
    loss2 = step(params, torch.from_numpy(inp2), torch.from_numpy(tgt2))
    np.testing.assert_allclose(loss2.item(), float(jloss2), rtol=1e-5)


@pytest.mark.parametrize("impl,S", [("dense", 32), ("flash", 128)])
def test_remat_matches_no_remat(impl, S):
    inp, tgt = _batch(4, 2, S)
    cfg = _tcfg(JCFG, attn_impl=impl)
    params, _ = _state()
    loss, grads = _port_grads(params, cfg, inp, tgt)
    rloss, rgrads = _port_grads(params, dataclasses.replace(cfg, remat=True),
                                inp, tgt)
    assert rloss.item() == pytest.approx(loss.item(), rel=1e-6)
    for name, g in grads.items():
        torch.testing.assert_close(rgrads[name], g, atol=1e-6, rtol=1e-6)


def test_train_step_loss_decreases():
    cfg = _tcfg(JCFG)
    params, optimizer = ttrain.make_train_state(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in ttrain.param_leaves(params))
    step = ttrain.make_train_step(cfg, optimizer)
    inp, tgt = (torch.from_numpy(a) for a in _batch(5, 8, 64))
    loss0 = step(params, inp, tgt)
    for _ in range(3):
        loss = step(params, inp, tgt)
    assert torch.isfinite(loss0) and loss.item() < loss0.item()


def test_make_train_state_builds_the_given_optimizer():
    """optimizer= (a callable on the leaves) replaces default_optimizer:
    with plain SGD the step moves each master by lr·g exactly."""
    cfg = _tcfg(JCFG)
    params, optimizer = ttrain.make_train_state(
        cfg, torch.Generator().manual_seed(0), device="cpu",
        optimizer=lambda leaves: torch.optim.SGD(leaves, lr=0.5))
    assert type(optimizer) is torch.optim.SGD
    inp, tgt = _batch(9, 2, 32)
    before = [p.detach().clone() for p in ttrain.param_leaves(params)]
    ttrain.make_train_step(cfg, optimizer)(params, torch.from_numpy(inp),
                                           torch.from_numpy(tgt))
    for p, p0 in zip(ttrain.param_leaves(params), before):
        torch.testing.assert_close(p.detach(), p0 - 0.5 * p.grad,
                                   atol=0, rtol=0)


def test_train_step_refuses_params_it_does_not_own():
    params, optimizer = _state()
    step = ttrain.make_train_step(_tcfg(JCFG), optimizer)
    other, _ = _state()
    inp, tgt = (torch.from_numpy(a) for a in _batch(6, 1, 16))
    with pytest.raises(ValueError, match="not the tree"):
        step(other, inp, tgt)


def test_bf16_activations_keep_f32_masters_and_grads():
    """The training layout: f32 masters, bf16 activations, f32 gradients
    (each use casts the master; autograd casts the gradient back)."""
    cfg = _tcfg(JCFG, dtype="bfloat16", attn_impl="flash")
    params, optimizer = _state()
    inp, tgt = _batch(7, 2, 128)
    loss, grads = _port_grads(params, cfg, inp, tgt)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads.values())
    want, _ = _port_grads(params, _tcfg(JCFG, attn_impl="flash"), inp, tgt)
    assert loss.item() == pytest.approx(want.item(), rel=2e-2)


def test_make_forward_is_the_forward():
    cfg = _tcfg(JCFG)
    params, _ = _state()
    toks = torch.from_numpy(_batch(8, 1, 16)[0])
    with torch.no_grad():
        torch.testing.assert_close(ttrain.make_forward(cfg)(params, toks),
                                   tl.forward(params, toks, cfg),
                                   atol=0, rtol=0)


def _bf16_ulp(x):
    """One bf16 ulp at each |x| (8 significant bits)."""
    return np.ldexp(1.0, np.frexp(np.abs(x).astype(np.float32))[1] - 8)


def test_bf16_mu_step_matches_optax_adamw_mu_dtype():
    """default_optimizer(mu_dtype=bf16) against optax.adamw(mu_dtype=
    bfloat16): one step of each from the same params and batch (mu in bf16
    within 1e-6 plus one bf16 ulp: the f32 mu agrees to 1e-6 before its
    cast rounds it once; nu 1e-6; params 1e-5 where |g| >= 1e-7), then a
    second step's loss."""
    inp, tgt = _batch(10, 4, 64)
    mesh = make_mesh(1, devices=[jax.devices()[0]])
    put = lambda x: jax.device_put(jnp.asarray(x),
                                   NamedSharding(mesh, jtrain.BATCH_SPEC))
    opt = jtrain.default_optimizer(mu_dtype=jnp.bfloat16)
    jparams = jtrain.shard_params(jax.tree.map(jnp.copy, JPARAMS), mesh, JCFG)
    jstate = opt.init(jparams)
    jgrads = jax.grad(jtrain.loss_fn)(JPARAMS, jnp.asarray(inp),
                                      jnp.asarray(tgt), JCFG)
    jstep = jtrain.make_train_step(mesh, JCFG, opt)
    jparams, jstate, jloss = jstep(jparams, jstate, put(inp), put(tgt))

    params, optimizer = ttrain.train_state_from(
        params_from_numpy(jax.tree.map(np.asarray, JPARAMS), device="cpu"),
        functools.partial(ttrain.default_optimizer, mu_dtype=torch.bfloat16))
    assert type(optimizer) is ttrain.AdamWMu
    step = ttrain.make_train_step(_tcfg(JCFG), optimizer)
    loss = step(params, torch.from_numpy(inp), torch.from_numpy(tgt))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)

    adam = jstate[0]
    mu, nu = _named(adam.mu), _named(adam.nu)
    want_p, g = _named(jparams), _named(jgrads)
    excluded = 0
    for name, p in _named(params).items():
        st = optimizer.state[p]
        assert st["exp_avg"].dtype == torch.bfloat16, name
        want_mu = np.asarray(mu[name]).astype(np.float32)
        assert (np.abs(st["exp_avg"].float().numpy() - want_mu)
                <= 1e-6 + _bf16_ulp(want_mu)).all(), name
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

    inp2, tgt2 = _batch(11, 4, 64)
    _, _, jloss2 = jstep(jparams, jstate, put(inp2), put(tgt2))
    loss2 = step(params, torch.from_numpy(inp2), torch.from_numpy(tgt2))
    np.testing.assert_allclose(loss2.item(), float(jloss2), rtol=1e-5)


def test_default_optimizer_without_mu_dtype_is_torch_adamw():
    params, _ = _state()
    opt = ttrain.default_optimizer(ttrain.param_leaves(params))
    assert type(opt) is torch.optim.AdamW
    assert opt.defaults["lr"] == 3e-4 and opt.defaults["weight_decay"] == 0.1
