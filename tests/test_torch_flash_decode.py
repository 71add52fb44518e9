"""flash_decode's split schedule on the CPU, against the JAX package.

On the card, flash_decode (csrc/flash_decode.cuh) gives each (batch, kv
head, row block) unit's live key tiles to several CTAs in equal shares and
merges their partials by log-sum-exp in a second launch. No CUDA kernel
runs here, so the tests hold the schedule's CPU twin in
ops/flash_attention.py (``_decode_tiles``, ``_decode_shares``,
``_decode_merge``, run whole by ``_decode_split_plain``: each share's
partial from attention_plain on that share's keys alone) against JAX
``flash_attention_decode`` in interpret mode (as tests/test_torch_flash.py
runs it), on the same numpy inputs, at 1e-5 in f32 (the merge sums in
another order), at 1, 3 and 9 splits (9 is more than the live tiles of a
256-position cache), at head dim 16 and, for the edge cases, 32; the
plan's rules (rows a unit, splits); and the
launch path's layouts and workspace, with the card stood in (``_on_card``,
``_run``). tests/test_torch_cuda.py holds the kernel itself.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_provisioner_tpu_torch.models import decode as td
from gpu_provisioner_tpu_torch.ops import flash_attention as tfa
from tests.test_torch_flash import DECODE_CASES, _cache, _rand

# the JAX ops package re-exports flash_attention, shadowing the module name
jfa = importlib.import_module("gpu_provisioner_tpu.ops.flash_attention")
TOL = dict(atol=1e-5, rtol=1e-5)
SPLITS = (1, 3, 9)


def _check_splits(B, S, Hq, Hkv, ML, start, pads, int8, window, sinks, seed,
                  D=16):
    """JAX flash_attention_decode (interpret mode) against the split twin at
    each of SPLITS, f32, head dim D (16, the tiny presets', by default)."""
    assert tfa.decode_flash_supported(ML, Hq, Hkv, S=S)
    (q,) = _rand(seed, (B, S, Hq, D))
    (jk, jv, jkw), (tk, tv, tkw) = _cache(seed + 1, B, Hkv, ML, D, int8)
    if pads is not None:
        jkw["pad_lens"] = jnp.asarray(pads, jnp.int32)
        tkw["pad_lens"] = torch.tensor(pads)
    st = np.asarray(start, np.int32)
    want = np.asarray(jfa.flash_attention_decode(
        jnp.asarray(q), jk, jv, jnp.asarray(st), interpret=True,
        window=window, sinks=sinks, **jkw))
    t_start = torch.from_numpy(st) if st.ndim else int(st)
    for n in SPLITS:
        got = tfa._decode_split_plain(torch.from_numpy(q), tk, tv, t_start, n,
                                      window=window, sinks=sinks, **tkw)
        np.testing.assert_allclose(got.numpy(), want, **TOL,
                                   err_msg=f"{n} splits")


@pytest.mark.parametrize("start,S,pads,int8,window,sinks", DECODE_CASES)
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_split_schedule_matches_jax_decode(start, S, pads, int8, window,
                                           sinks, kv_heads):
    """tests/test_torch_flash.py's decode cases (B=2, Hq 4, ML 256)."""
    _check_splits(2, S, 4, kv_heads, 256, start, [20, 0] if pads else None,
                  int8, window, sinks, 50 + S)


# (B, S, Hq, Hkv, start, pads, window, sinks) at ML 512: a live range
# shorter than one share, a pad floor past the first share, a window band
# and its sinks in different shares, per-row starts more than ML / 2 apart,
# B=1, S=16 at group 4 (64 rows: one unit), S=16 at group 8 (128 rows: two
# row blocks of 64)
EDGE_CASES = [
    (2, 1, 4, 2, [10, 500], None, None, 0),
    (2, 1, 4, 2, [300, 400], [200, 0], None, 0),
    (2, 1, 4, 1, [450, 420], [5, 70], 64, 3),
    (2, 5, 4, 2, [500, 20], [4, 0], None, 0),
    (1, 1, 4, 4, 333, None, 100, 2),
    (2, 16, 8, 2, [400, 37], [3, 0], 120, 2),
    (1, 16, 8, 1, 300, [9], None, 0),
]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,S,Hq,Hkv,start,pads,window,sinks", EDGE_CASES)
def test_split_schedule_edges_match_jax_decode(B, S, Hq, Hkv, start, pads,
                                               window, sinks, int8):
    _check_splits(B, S, Hq, Hkv, 512, start, pads, int8, window, sinks, 70)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,S,Hq,Hkv,start,pads,window,sinks", EDGE_CASES)
def test_split_schedule_edges_match_jax_decode_at_head_dim_32(
        B, S, Hq, Hkv, start, pads, window, sinks, int8):
    """The same edges at head dim 32 (the fast bench_engine and
    bench_moe_decode models' heads), where the kernel's P V runs in four
    row groups of 32 threads."""
    _check_splits(B, S, Hq, Hkv, 512, start, pads, int8, window, sinks, 71,
                  D=32)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("B,S,Hq,Hkv,start,pads,window,sinks", EDGE_CASES)
def test_split_schedule_edges_match_jax_decode_at_head_dim_120(
        B, S, Hq, Hkv, start, pads, window, sinks, int8):
    """The same edges at head dim 120 (H2O-Danube3-4B's heads), where the
    kernel's P V keeps D = 128's one row group (threads 0..119 owning a
    column) and an int8 row of 120 bytes is copied in 8-byte pieces, its
    score product 7 whole chunks and a tail of 8 values."""
    _check_splits(B, S, Hq, Hkv, 512, start, pads, int8, window, sinks, 72,
                  D=120)


def _window_skips(kv0, min_qpos, window, pad, sinks):
    """fa::window_skips (csrc/flash_common.cuh), tile by tile."""
    if not window:
        return False
    below = kv0 + tfa._TILE - 1 < min_qpos - window + 1
    return below and not (sinks > 0 and kv0 <= pad + sinks - 1)


@pytest.mark.parametrize("window", [None, 1, 64, 100, 1000])
def test_live_tiles_are_the_tiles_the_window_keeps(window):
    """_decode_tiles' two runs are exactly the tiles of [pad floor, causal
    frontier) that fa::window_skips keeps, in order, for any start, pad,
    sinks and rows; each share of them is a contiguous slice, the shares
    cover the list once and differ in size by at most one."""
    rng = np.random.default_rng(0 if window is None else window)
    for _ in range(400):
        Sk = int(rng.choice([256, 512, 2048]))
        start = int(rng.integers(0, Sk))
        pad = int(rng.integers(0, start + 1))
        sinks = int(rng.choice([0, 1, 4, 70]))
        first_s = int(rng.integers(0, 4))
        last_s = first_s + int(rng.integers(0, 4))
        lo, a_end, b0, hi = tfa._decode_tiles(start, pad, first_s, last_s, Sk,
                                              window, sinks)
        live = list(range(lo, a_end)) + list(range(b0, hi))
        frontier = -(-min(Sk, start + last_s + 1) // tfa._TILE)
        want = [j for j in range(pad // tfa._TILE, frontier)
                if not _window_skips(j * tfa._TILE, start + first_s, window,
                                     pad, sinks)]
        assert live == want
        for n in (1, 3, 7, 32):
            shares = tfa._decode_shares(lo, hi, n, a_end=a_end, b0=b0)
            assert len(shares) == n and sum(shares, []) == live
            sizes = [len(s) for s in shares]
            assert max(sizes) - min(sizes) <= 1


def test_decode_plan():
    """Rows a unit (the smallest instance that holds S·group rows, 64 at
    most), units, and the splits: about two CTAs an SM, at most one a
    cache tile and DECODE_MAX_SPLITS, at least one."""
    assert tfa._decode_rows(1) == (4, 1) and tfa._decode_rows(4) == (4, 1)
    assert tfa._decode_rows(20) == (32, 1) and tfa._decode_rows(64) == (64, 1)
    assert tfa._decode_rows(128) == (64, 2) and tfa._decode_rows(65) == (64, 2)
    # the serving step (B=4, GQA 32/8, S=1, ML 2048) on 132 SMs
    assert tfa._decode_plan(4, 1, 32, 8, 2048, 132) == (4, 32, 9)
    assert tfa._decode_plan(4, 16, 32, 8, 2048, 132) == (64, 32, 9)
    assert tfa._decode_plan(1, 1, 32, 8, 2048, 132) == (4, 8, 32)
    assert tfa._decode_plan(1, 1, 32, 8, 128, 132) == (4, 8, 2)
    assert tfa._decode_plan(64, 1, 32, 8, 2048, 132) == (4, 512, 1)
    assert tfa._decode_splits(1, 1 << 20, 132) == tfa.DECODE_MAX_SPLITS


@pytest.fixture
def launches(monkeypatch):
    """Stands the card in: flash_attention_decode takes its launch path on
    CPU tensors up to the C entry (``_run``), which records the argument
    struct; the SM count is the H100's 132."""
    seen = []
    monkeypatch.setattr(tfa, "_on_card", lambda t: True)
    monkeypatch.setattr(tfa, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(tfa, "_run", lambda kernel, a, dev: seen.append(
        (kernel, a)))
    return seen


@pytest.mark.parametrize("dtype,int8", [(torch.float32, False),
                                        (torch.bfloat16, False),
                                        (torch.bfloat16, True)])
def test_decode_launch_plans_its_splits_and_workspace(launches, dtype, int8):
    """The serving step's shape: 32 units of 4 rows, 9 splits, a workspace
    of units × splits × R × (D + 2) f32 values; one count on the counter of
    the cache's kind."""
    B, Hq, Hkv, ML, D = 4, 32, 8, 2048, 128
    q = torch.zeros(B, 1, Hq, D, dtype=dtype)
    kc = torch.zeros(B, Hkv, ML, D, dtype=dtype)
    kw = {}
    if int8:
        kc, kw["k_scale"] = td._quantize_kv(kc)
        kw["v_scale"] = kw["k_scale"]
    tfa.reset_launches()
    with torch.no_grad():
        tfa.flash_attention_decode(q, kc, kc, torch.tensor([5, 9, 2, 7]),
                                   **kw)
    (kernel, a), = launches
    assert kernel == "flash_decode" and a.splits == 9
    assert a.ws_floats == 32 * 9 * 4 * (D + 2) and a.ws
    assert a.kv_dtype == (2 if int8 else tfa._KV_DTYPES[dtype])
    assert tfa.LAUNCHES["flash_decode_int8" if int8 else "flash_decode"] == 1
    assert sum(tfa.LAUNCHES.values()) == 1


def test_decode_launch_with_one_split_has_no_workspace(launches):
    B, Hq, Hkv, D = 64, 32, 8, 128
    q = torch.zeros(B, 1, Hq, D)
    kc = torch.zeros(B, Hkv, 256, D)
    with torch.no_grad():
        tfa.flash_attention_decode(q, kc, kc, 100)
    (_, a), = launches
    assert a.splits == 1 and not a.ws and a.ws_floats == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_decode_lays_out_a_cache_its_ring_cannot_copy(launches, dtype):
    """flash_decode copies K/V tiles in 16-byte chunks in every dtype (4 f32,
    8 bf16 or 16 int8 values): a direct launch refuses a cache view whose
    position stride is no whole number of chunks, before the kernel library
    (nvcc, a card) is asked for; flash_attention_decode hands the kernel a
    contiguous copy instead and the aligned cache as it is."""
    B, Hq, Hkv, ML, D = 1, 4, 1, 256, 128
    act = torch.float32 if dtype == torch.float32 else torch.bfloat16
    q = torch.zeros(B, 1, Hq, D, dtype=act)
    wide = torch.zeros(B, Hkv, ML, D + 2, dtype=dtype)[..., :D]
    ok = torch.zeros(B, Hkv, ML, D, dtype=dtype)
    kw = {}
    if dtype == torch.int8:
        kw = dict(k_scale=torch.ones(B, Hkv, ML, 1),
                  v_scale=torch.ones(B, Hkv, ML, 1))
    with pytest.raises(ValueError, match=r"flash_decode: k strides"):
        tfa._launch("flash_decode", q, wide, ok, 7, causal=True, scale=1.0,
                    **kw)
    assert launches == []
    with torch.no_grad():
        tfa.flash_attention_decode(q, wide, ok, 7, **kw)
    (_, a), = launches
    assert a.k != wide.data_ptr() and a.k % 16 == 0
    assert (a.k_sh, a.k_ss) == (ML * D, D)
    assert a.v == ok.data_ptr()
    # q is read element by element: any row stride
    tfa._check_tc_copies("flash_decode", q=q[:, :, :, :D - 4], k=ok, v=ok)
