"""The port's ring and zigzag attention (parallel/ring.py, through
models/train.py's make_attn_fn) against the JAX package's, on the CPU.

A module fixture spawns one 4-rank gloo world that computes every case
(jobs.attention_case: each rank's blocks, assembled here); each test holds
one case against the JAX function on the 8-device CPU mesh, on the same
numpy inputs. Twins of tests/test_workload.py:

- :131 the dense ring (causal or not × MHA/GQA, f32, atol 1e-5): the JAX
  ring at make_mesh(8, sp=4), the port's over 4 ranks;
- :143 make_attn_fn on a mesh with seq 1 is plain dense attention;
- :217 the flash ring's merge at shapes the kernels do not tile (each step
  the dense-with-lse path, in both packages);
- :232 the flash ring at kernel-tiling shapes (S_local 128) with its
  gradients (out 2e-5, dq/dk/dv 5e-4): the JAX ring runs its Pallas kernels
  in interpret mode, the port's CPU path their plain versions, with the lse
  cotangent through the merge;
- :268 and :288 the zigzag ring (its schedule at sp 4, then chunk pairs of
  128 with gradients at sp 2): the port's dense and flash zigzag against
  the JAX make_attn_fn(mesh, seq_schedule="zigzag") (dense pairs, as that
  test runs it);

and tests/test_ops.py:633, make_attn_fn(mesh, "flash") on (data, model)
shards (the port's ranks hold their batch rows and heads). Where the JAX
spec leaves the batch unsharded (P(None, "seq", None, None)), every port
rank takes all rows, but for the zigzag chunk pairs, whose 4 rows the
port's data axis splits (attention is row by row: the same function).
"""

import gc
from functools import partial

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from gpu_provisioner_tpu.models.train import make_attn_fn
from gpu_provisioner_tpu.parallel import make_mesh
from gpu_provisioner_tpu.parallel.ring import dense_attention, ring_attention
from gpu_provisioner_tpu_torch.parallel import jobs, launch

SEQ = P(None, "seq", None, None)


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_caches():
    """Drops what this module compiled once it is done: a later test in the
    same worker (the control plane's event-loop stall budget) would
    otherwise pay for those objects in every full garbage collection."""
    yield
    jax.clear_caches()
    gc.collect()


def _qkv(seed, B, S, Hq, Hkv, D, grads=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, D), np.float32)
    k, v = (rng.standard_normal((B, S, Hkv, D), np.float32)
            for _ in range(2))
    out = {"q": q, "k": k, "v": v}
    if grads:
        out["dout"] = rng.standard_normal((B, S, Hq, D), np.float32)
    return out


SMALL = {kv: _qkv(0, 2, 64, 4, kv, 16) for kv in (4, 2)}
TILED = _qkv(1, 1, 256, 2, 1, 128, grads=True)
ZIGZAG = _qkv(2, 4, 512, 2, 1, 128, grads=True)
ON_MESH = _qkv(3, 4, 128, 4, 2, 32)

CASES = {}
for causal in (True, False):
    for kv in (4, 2):
        for impl in ("dense", "flash"):
            CASES[("ring", impl, causal, kv)] = dict(
                mesh={"sp": 4}, **SMALL[kv], impl=impl, causal=causal,
                replicate_batch=True)
for kv in (4, 2):
    for impl in ("dense", "flash"):
        CASES[("zigzag", impl, kv)] = dict(
            mesh={"sp": 4}, **SMALL[kv], schedule="zigzag", impl=impl,
            replicate_batch=True)
CASES["tiled"] = dict(mesh={"sp": 2}, **TILED, impl="flash",
                      replicate_batch=True)
for impl in ("dense", "flash"):
    CASES[("zigzag_tiled", impl)] = dict(mesh={"sp": 2}, **ZIGZAG,
                                         schedule="zigzag", impl=impl)
CASES["on_mesh"] = dict(mesh={"tp": 2}, **ON_MESH, impl="flash")
KEYS = list(CASES)


@pytest.fixture(scope="module")
def world():
    """{case key: every rank's attention_case result}, and the mesh case of
    an unsharded sequence, from one 4-rank world."""
    cases = [{"kind": "attention", **CASES[k]} for k in KEYS]
    cases.append({"kind": "mesh", "mesh": {}})
    res = launch.spawn_ranks(jobs.run_cases, 4, backend="gloo", device="cpu",
                             timeout_s=240, args=(cases, "cpu"))
    out = {k: [r[i] for r in res] for i, k in enumerate(KEYS)}
    out["mesh"] = [r[-1] for r in res]
    return out


def _port(world, key, name):
    c = CASES[key]
    shape = (c["k"] if name in ("dk", "dv") else c["q"]).shape
    return jobs.assemble(world[key], name, shape)


def _jax_ring(inputs, mesh, **kw):
    fn = jax.jit(jax.shard_map(
        partial(ring_attention, axis_name="seq", **kw), mesh=mesh,
        in_specs=(SEQ,) * 3, out_specs=SEQ, check_vma=False))
    put = lambda x: jax.device_put(x, NamedSharding(mesh, SEQ))
    return np.asarray(fn(*(put(inputs[n]) for n in "qkv")))


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_ring_matches_jax_ring_fp32(world, impl, causal, kv_heads):
    """:131 (dense) and :217 (flash, each step below the kernels' tiling)."""
    want = _jax_ring(SMALL[kv_heads], make_mesh(8, sp=4), causal=causal,
                     impl=impl)
    got = _port(world, ("ring", impl, causal, kv_heads), "out")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_ring_single_shard_degenerates_to_dense(world):
    """:143: seq 1 → make_attn_fn(mesh) is plain dense attention."""
    assert all(r["dense_is_default"] for r in world["mesh"])
    assert make_attn_fn(make_mesh(8, sp=1, tp=1)) is dense_attention


def _grads(fn, inputs, mesh):
    """(out, dq, dk, dv) of fn on seq-sharded inputs, the cotangent
    inputs["dout"]."""
    put = lambda x: jax.device_put(x, NamedSharding(mesh, SEQ))
    args = [put(inputs[n]) for n in "qkv"]
    out, vjp = jax.vjp(fn, *args)
    return (np.asarray(out),
            *(np.asarray(g) for g in vjp(put(inputs["dout"]))))


def _hold(world, key, want, out_tol=2e-5, grad_tol=5e-4):
    for name, w in zip(("out", "dq", "dk", "dv"), want):
        tol = out_tol if name == "out" else grad_tol
        np.testing.assert_allclose(_port(world, key, name), w, atol=tol,
                                   rtol=tol, err_msg=f"{key} {name}")


def test_ring_flash_kernel_path_matches_jax_with_grads(world):
    """:232: S_local = 128 at sp 2, so every live step is a flash call (the
    JAX kernels in interpret mode); gradients through the lse merge."""
    mesh = make_mesh(8, sp=2, tp=1, dp=4)
    fn = jax.jit(jax.shard_map(
        partial(ring_attention, axis_name="seq", causal=True, impl="flash"),
        mesh=mesh, in_specs=(SEQ,) * 3, out_specs=SEQ, check_vma=False))
    _hold(world, "tiled", _grads(fn, TILED, mesh))


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_zigzag_ring_matches_jax_zigzag(world, impl, kv_heads):
    """:268: the balanced schedule at sp 4; the port's blocks are of the
    permuted sequence, assembled at their global positions."""
    mesh = make_mesh(8, sp=4, tp=1, dp=2)
    attn = make_attn_fn(mesh, seq_schedule="zigzag")
    put = lambda x: jax.device_put(x, NamedSharding(mesh, SEQ))
    want = np.asarray(jax.jit(attn)(*(put(SMALL[kv_heads][n])
                                      for n in "qkv")))
    got = _port(world, ("zigzag", impl, kv_heads), "out")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def zigzag_tiled_jax():
    mesh = make_mesh(8, sp=2, tp=1, dp=4)
    attn = jax.jit(make_attn_fn(mesh, seq_schedule="zigzag"))
    return _grads(attn, ZIGZAG, mesh)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_zigzag_kernel_path_matches_jax_with_grads(world, zigzag_tiled_jax,
                                                   impl):
    """:288: chunk pairs of 128 at sp 2 with gradients; the port's flash
    zigzag makes every live pair a flash call (its plain version here)."""
    _hold(world, ("zigzag_tiled", impl), zigzag_tiled_jax)


def test_flash_on_data_and_model_shards_matches_jax(world):
    """tests/test_ops.py:633: make_attn_fn(mesh, "flash") with seq 1, each
    rank on its batch rows and heads."""
    mesh = make_mesh(8, sp=1, tp=2)
    spec = P(("slice", "data"), "seq", "model", None)
    put = lambda x: jax.device_put(x, NamedSharding(mesh, spec))
    want = np.asarray(jax.jit(make_attn_fn(mesh, impl="flash"))(
        *(put(ON_MESH[n]) for n in "qkv")))
    np.testing.assert_allclose(_port(world, "on_mesh", "out"), want,
                               atol=2e-5, rtol=2e-5)
