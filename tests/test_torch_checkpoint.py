"""The port's checkpointing (models/checkpoint.py) against the JAX package's,
on the CPU.

Twins of tests/test_checkpoint.py's single-device cases: the layout
refusal (:56), a checkpoint without a layout entry (:75; the port cannot
read orbax files, so it writes its own format without the entry), the
manager's schedule and rotation (:94), and the round trip of :26 without
its second mesh (that half waits for the multi-GPU slice). Then what the
port adds: the manager's saved and kept steps equal to orbax's on the same
step sequence, a save that fails midway, resume parity with a JAX run, and
a JAX optimizer state carried across (adam_state_from_numpy). ``tiny`` in
f32; the JAX mesh is make_mesh(1, devices=[jax.devices()[0]]). Restored
leaves and the port's own resumed run are held bitwise; the port against
JAX as tests/test_torch_train.py holds it (loss 1e-5, moments 1e-6,
params 1e-5 where |g| >= 1e-7); a bf16 mu within 1e-6 plus one bf16 ulp:
the f32 mu before its cast agrees to 1e-6, and the cast rounds once.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp
from jax.sharding import NamedSharding
from torch.distributed.checkpoint.api import CheckpointException

from gpu_provisioner_tpu.models import checkpoint as jck
from gpu_provisioner_tpu.models import llama as jl
from gpu_provisioner_tpu.models import train as jtrain
from gpu_provisioner_tpu.parallel.topology import make_mesh
from gpu_provisioner_tpu_torch.models import checkpoint as ck
from gpu_provisioner_tpu_torch.models import llama as tl
from gpu_provisioner_tpu_torch.models import train as ttrain
from gpu_provisioner_tpu_torch.models.convert import (adam_state_from_numpy,
                                                      params_from_numpy)

JCFG = dataclasses.replace(jl.PRESETS["tiny"], dtype="float32")
TCFG = tl.LlamaConfig(**dataclasses.asdict(JCFG))
JPARAMS = jl.init_params(jax.random.key(0), JCFG)
MU = {"f32": None, "bf16": (torch.bfloat16, jnp.bfloat16)}


def _opt(mu="f32"):
    """The port's optimizer callable for a mu dtype name."""
    return functools.partial(ttrain.default_optimizer,
                             mu_dtype=MU[mu] and MU[mu][0])


def _state(mu="f32", params=JPARAMS):
    """A fresh port train state holding a copy of JAX params."""
    return ttrain.train_state_from(
        params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"),
        _opt(mu))


def _batch(seed, B=4, S=32):
    toks = np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, (B, S + 1), dtype=np.int32)
    return toks[:, :-1], toks[:, 1:]


def _steps(params, opt, seeds):
    step = ttrain.make_train_step(TCFG, opt)
    return [step(params, *(torch.from_numpy(a) for a in _batch(s))).item()
            for s in seeds]


def _named(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_named(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _leaves(params, opt):
    """Every tensor of the checkpoint tree (params, mu, nu, count), by
    name, as copies."""
    return {k: v.detach().clone() for k, v in _named(
        {"params": params, "opt_state": ck.adam_state_tree(params, opt)})
        .items()}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("mu", ["f32", "bf16"])
def test_checkpoint_roundtrip_restores_equal_leaves_and_next_loss(tmp_path,
                                                                  mu):
    """Twin of :26 on one device: every leaf (params, mu in its own dtype,
    nu, count) and the step round-trip, and the next step's loss is the
    uninterrupted state's, bitwise."""
    params, opt = _state(mu)
    _steps(params, opt, [1])
    ck.save_train_state(tmp_path / "ckpt", params, opt, step=1)
    r_params, r_opt, step = ck.restore_train_state(tmp_path / "ckpt", TCFG,
                                                   _opt(mu), device="cpu")
    assert step == 1 and type(r_opt) is type(opt)
    saved = _leaves(params, opt)
    _assert_same(_leaves(r_params, r_opt), saved)
    assert int(saved["opt_state/count"]) == 1
    assert saved["opt_state/mu/lm_head"].dtype == (
        torch.float32 if mu == "f32" else torch.bfloat16)
    assert _steps(r_params, r_opt, [2]) == _steps(params, opt, [2])
    with pytest.raises(ValueError, match="already exists"):
        ck.save_train_state(tmp_path / "ckpt", params, opt, step=2)


def test_checkpoint_refuses_pipeline_layout_mismatch(tmp_path):
    """Twin of :56: a checkpoint stamped with an interleaved pipeline layout
    does not restore through a logical-order target."""
    params, opt = _state()
    ck.save_train_state(tmp_path / "ckpt", params, opt, step=3, n_stages=2,
                        n_chunks=2)
    with pytest.raises(ValueError, match="pipeline layout"):
        ck.restore_train_state(tmp_path / "ckpt", TCFG, _opt(), device="cpu")
    _, _, step = ck.restore_train_state(tmp_path / "ckpt", TCFG, _opt(),
                                        device="cpu", n_stages=2, n_chunks=2)
    assert step == 3


def test_checkpoint_restores_pre_layout_format(tmp_path):
    """Twin of :75: a checkpoint with no 'layout' entry restores, as
    logical order."""
    params, opt = _state()
    _steps(params, opt, [1])
    dcp.save({"params": params, "opt_state": ck.adam_state_tree(params, opt),
              "step": 5}, checkpoint_id=tmp_path / "old")
    r_params, r_opt, step = ck.restore_train_state(tmp_path / "old", TCFG,
                                                   _opt(), device="cpu")
    assert step == 5
    _assert_same(_leaves(r_params, r_opt), _leaves(params, opt))
    with pytest.raises(ValueError, match="pipeline layout"):
        ck.restore_train_state(tmp_path / "old", TCFG, _opt(), device="cpu",
                               n_stages=2)


def test_checkpoint_manager_rotates_and_resumes(tmp_path):
    """Twin of :94: the first step seen, then every interval; the newest
    two kept; restore_latest the newest (None on an empty directory)."""
    params, opt = _state()
    mgr = ck.TrainCheckpointManager(tmp_path / "ckpts", TCFG, _opt(),
                                    device="cpu", max_to_keep=2,
                                    save_interval_steps=2)
    try:
        assert mgr.restore_latest() is None and mgr.latest_step() is None
        saved = [s for s in range(1, 7) if mgr.maybe_save(s, params, opt)]
        assert saved == [1, 2, 4, 6]
        mgr.wait_until_finished()
        assert mgr.latest_step() == 6
        assert sorted(int(p.name) for p in (tmp_path / "ckpts").iterdir()
                      if p.name.isdigit()) == [4, 6]
        r_params, r_opt, step = mgr.restore_latest()
        assert step == 6
        _assert_same(_leaves(r_params, r_opt), _leaves(params, opt))
    finally:
        mgr.close()


def _jax_state(mesh, opt):
    jparams = jtrain.shard_params(jax.tree.map(jnp.copy, JPARAMS), mesh,
                                  JCFG)
    return jparams, opt.init(jparams)


@pytest.mark.parametrize("interval,keep,steps", [
    (2, 2, list(range(1, 7))),
    (3, 2, [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]),
    (3, 3, [2, 3, 3, 5, 6, 7, 9, 12, 13]),
])
def test_manager_schedule_matches_orbax(tmp_path, interval, keep, steps):
    """The same step sequence through the JAX manager (orbax's bookkeeping)
    and the port's: the same steps saved, the same kept, the same latest;
    then a second manager over each directory (a restart) keeps agreeing."""
    mesh = make_mesh(1, devices=[jax.devices()[0]])
    jopt = jtrain.default_optimizer()
    jparams, jstate = _jax_state(mesh, jopt)
    params, opt = _state()

    def kept(d):
        return sorted(int(p.name) for p in d.iterdir() if p.name.isdigit())

    def both(seq):
        jm = jck.TrainCheckpointManager(tmp_path / "j", mesh, JCFG, jopt,
                                        max_to_keep=keep,
                                        save_interval_steps=interval)
        tm = ck.TrainCheckpointManager(tmp_path / "t", TCFG, _opt(),
                                       device="cpu", max_to_keep=keep,
                                       save_interval_steps=interval)
        try:
            js = [s for s in seq if jm.maybe_save(s, jparams, jstate)]
            ts = [s for s in seq if tm.maybe_save(s, params, opt)]
            jm.wait_until_finished()
            assert ts == js
            assert kept(tmp_path / "t") == kept(tmp_path / "j")
            assert tm.latest_step() == jm.latest_step()
        finally:
            jm.close()
            tm.close()

    both(steps)
    both([steps[-1], steps[-1] + 1, steps[-1] + interval,
          2 * (steps[-1] + interval)])


def test_a_save_that_fails_midway_leaves_the_previous_checkpoint(
        tmp_path, monkeypatch):
    """The data files are written, the metadata write raises: the previous
    checkpoint stays the latest and restores, and nothing of the failed
    save is left beside it; the next save goes through."""
    params, opt = _state()
    mgr = ck.TrainCheckpointManager(tmp_path / "ckpts", TCFG, _opt(),
                                    device="cpu", save_interval_steps=1)
    assert mgr.maybe_save(1, params, opt)
    at_one = _leaves(params, opt)
    _steps(params, opt, [1])

    def dies(self, metadata, results):
        raise OSError("the disk went away")

    with monkeypatch.context() as m:
        m.setattr(dcp.FileSystemWriter, "finish", dies)
        with pytest.raises(CheckpointException, match="went away"):
            mgr.maybe_save(2, params, opt)
    assert mgr.latest_step() == 1
    assert [p.name for p in (tmp_path / "ckpts").iterdir()] == ["1"]
    r_params, r_opt, step = mgr.restore_latest()
    assert step == 1
    _assert_same(_leaves(r_params, r_opt), at_one)
    assert mgr.maybe_save(2, params, opt) and mgr.latest_step() == 2


def _level0(jitted, *args):
    """``jitted`` compiled for ``args`` at LLVM's optimisation level 0: each
    program here runs a few times, and compiles with a third less CPU."""
    return jitted.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _jax_steps(n, opt, seeds):
    """JAX's train step over the first n ``seeds`` from JPARAMS → (losses,
    params, opt_state, the gradients of the last step)."""
    mesh = make_mesh(1, devices=[jax.devices()[0]])
    put = lambda x: jax.device_put(jnp.asarray(x),
                                   NamedSharding(mesh, jtrain.BATCH_SPEC))
    jparams, jstate = _jax_state(mesh, opt)
    step, losses = None, []
    for i, s in enumerate(seeds[:n]):
        inp, tgt = (put(a) for a in _batch(s))
        if i == n - 1:
            grad = jax.jit(lambda p, a, b: jax.grad(jtrain.loss_fn)(
                p, a, b, JCFG))
            grads = _level0(grad, jparams, inp, tgt)(jparams, inp, tgt)
        step = step or _level0(jtrain.make_train_step(mesh, JCFG, opt),
                               jparams, jstate, inp, tgt)
        jparams, jstate, loss = step(jparams, jstate, inp, tgt)
        losses.append(float(loss))
    return losses, jparams, jstate, grads


def test_resume_parity_with_jax(tmp_path):
    """JAX trains 4 steps; the port trains 2 from the same init, saves,
    restores and trains 2: its losses within 1e-5 of JAX's and bitwise
    equal to its own uninterrupted run."""
    seeds = [11, 12, 13, 14]
    jlosses = _jax_steps(4, jtrain.default_optimizer(), seeds)[0]
    params, opt = _state()
    uninterrupted = _steps(params, opt, seeds)
    params, opt = _state()
    first = _steps(params, opt, seeds[:2])
    ck.save_train_state(tmp_path / "ckpt", params, opt, step=2)
    del params, opt
    params, opt, step = ck.restore_train_state(tmp_path / "ckpt", TCFG,
                                               _opt(), device="cpu")
    resumed = first + _steps(params, opt, seeds[2:])
    assert step == 2 and resumed == uninterrupted
    np.testing.assert_allclose(resumed, jlosses, rtol=1e-5)


def _bf16_ulp(x):
    """One bf16 ulp at each |x| (8 significant bits)."""
    return np.ldexp(1.0, np.frexp(np.abs(x).astype(np.float32))[1] - 8)


@pytest.mark.parametrize("mu", ["f32", "bf16"])
def test_adam_state_from_numpy_takes_jax_third_step(mu):
    """A JAX state after 2 steps, carried across (params and
    ScaleByAdamState), takes its 3rd step in the port as in JAX."""
    seeds = [21, 22, 23]
    jopt = jtrain.default_optimizer(mu_dtype=MU[mu] and MU[mu][1])
    _, jparams2, jstate2, _ = _jax_steps(2, jopt, seeds)
    params, opt = _state(mu, jparams2)
    adam = jax.tree.map(np.asarray, jstate2[0])
    adam_state_from_numpy(adam, params, opt)
    if mu == "bf16":     # an f32-mu optimizer refuses a bf16 mu
        other, other_opt = _state("f32", jparams2)
        with pytest.raises(ValueError, match="mu is torch.bfloat16"):
            adam_state_from_numpy(adam, other, other_opt)
    jlosses, jparams3, jstate3, g3 = (
        _jax_steps(3, jtrain.default_optimizer(mu_dtype=MU[mu] and MU[mu][1]),
                   seeds))
    loss = _steps(params, opt, seeds[2:])[0]
    np.testing.assert_allclose(loss, jlosses[2], rtol=1e-5)
    mu3, nu3 = _named(jstate3[0].mu), _named(jstate3[0].nu)
    want_p, g = _named(jparams3), _named(g3)
    excluded = 0
    for name, p in _named(params).items():
        st = opt.state[p]
        assert int(st["step"]) == int(jstate3[0].count) == 3
        got_mu = st["exp_avg"].float().numpy()
        want_mu = np.asarray(mu3[name]).astype(np.float32)
        tol = 1e-6 + (0 if mu == "f32" else _bf16_ulp(want_mu))
        assert (np.abs(got_mu - want_mu) <= tol).all(), name
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                   np.asarray(nu3[name]), atol=1e-6,
                                   err_msg=name)
        gj = np.asarray(g[name])
        steady = (np.abs(gj) >= 1e-7) | (gj == 0)
        excluded += int((~steady).sum())
        np.testing.assert_allclose(p.detach().numpy()[steady],
                                   np.asarray(want_p[name])[steady],
                                   atol=1e-5, err_msg=name)
    n = sum(p.numel() for p in ttrain.param_leaves(params))
    assert excluded < n // 1000, f"{excluded} of {n} elements excluded"
