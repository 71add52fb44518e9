"""The flattened-triangle path of the port against the JAX package's.

``triangular=True`` takes csrc/flash_tri.cuh on the card: a persistent
launch over the flat list of live causal tiles, with a fixup launch that
merges the rows cut between CTAs' shares. No CUDA kernel runs here, so the
tests hold, on the CPU:
- the port's flash_attention[_with_lse](triangular=True) (its plain
  versions) against JAX triangular=True, whose Pallas kernels #3, #8 and #9
  run in interpret mode with RESIDENT_KV_BUDGET at 0 (the shapes and
  tolerances of tests/test_ops.py's triangular test: 2e-5 forward, 1e-4
  gradients, f32);
- tri_dispatch against the kernels the JAX package traces;
- the schedule's CPU twins (the module's _tri_decode and _tri_shares,
  and here _tri_segments and _tri_fixup_pieces, twins of flash_tri.cuh's
  Walk and cut_row) against the JAX decode and against coverage and
  balance, and the cut-row merge rebuilt from the plain versions over
  key/query ranges plus _lse_merge, equal to the unsplit result at 1e-5;
- _lse_merge against the JAX one, sliding-window training against
  jax.value_and_grad, and the bench twins' keys against bench.py's.
"""

import ast
import dataclasses
import gc
import importlib
import importlib.util
from collections import defaultdict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_provisioner_tpu.models import llama as jl
from gpu_provisioner_tpu.models import train as jtrain
from gpu_provisioner_tpu.parallel import ring as jring
from gpu_provisioner_tpu_torch import bench as tbench
from gpu_provisioner_tpu_torch.models import llama as tl
from gpu_provisioner_tpu_torch.models import train as ttrain
from gpu_provisioner_tpu_torch.models.convert import params_from_numpy
from gpu_provisioner_tpu_torch.ops import flash_attention as tfa
from gpu_provisioner_tpu_torch.parallel import ring as tring

# the JAX ops package re-exports flash_attention, shadowing the module name
jfa = importlib.import_module("gpu_provisioner_tpu.ops.flash_attention")
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_caches():
    """Drops what this module compiled once it is done (a later test in the
    same worker would pay for those objects in every garbage collection)."""
    yield
    jax.clear_caches()
    gc.collect()

def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("with_lse", [True, False])
@pytest.mark.parametrize("Hq,Hkv,D", [
    pytest.param(2, 1, 32, id="2-1"), pytest.param(4, 2, 32, id="4-2"),
    pytest.param(2, 1, 64, id="2-1-d64"),
    pytest.param(4, 2, 64, id="4-2-d64")])
def test_triangular_matches_jax_triangular(monkeypatch, Hq, Hkv, D,
                                           with_lse):
    """Forward, gradients and (with_lse) an lse cotangent: the port's
    flash_attention[_with_lse](triangular=True) against the JAX tri kernels
    in interpret mode (streaming forced, 128-blocks: a 3-row triangle), at
    head dim 32 and 64 (the tri kernels take 64 on the card)."""
    monkeypatch.setattr(jfa, "RESIDENT_KV_BUDGET", 0)
    monkeypatch.setattr(tfa, "RESIDENT_KV_BUDGET", 0)
    S = 384
    q, k, v, g_out, g_lse = _rand(7, (1, S, Hq, D), (1, S, Hkv, D),
                                  (1, S, Hkv, D), (1, S, Hq, D), (1, Hq, S))
    if not with_lse:
        g_lse = np.zeros_like(g_lse)
    outs, vjp = jax.vjp(lambda *a: jfa.flash_attention_with_lse(
        *a, triangular=True, block_q=128, block_k=128, interpret=True),
        *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp((jnp.asarray(g_out), jnp.asarray(g_lse)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    if with_lse:
        out, lse = tfa.flash_attention_with_lse(*leaves, triangular=True)
        grads = torch.autograd.grad((out, lse), leaves,
                                    (torch.from_numpy(g_out),
                                     torch.from_numpy(g_lse)))
        np.testing.assert_allclose(lse.detach().numpy(), np.asarray(outs[1]),
                                   atol=2e-5, rtol=2e-5)
    else:
        out = tfa.flash_attention(*leaves, triangular=True)
        grads = torch.autograd.grad(out, leaves, torch.from_numpy(g_out))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(outs[0]),
                               atol=2e-5, rtol=2e-5)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)


TRI_KERNELS = ("_kernel_tri", "_bwd_dq_kernel_tri", "_bwd_dkv_kernel_tri")


def _jax_tri_kernels(monkeypatch, S, dtype, **kw):
    """The flattened-triangle kernels the JAX package traces for one
    forward and backward of flash_attention_with_lse (abstractly, through
    jax.eval_shape: nothing runs)."""
    seen = set()
    for name in TRI_KERNELS:
        def record(*a, _name=name, _fn=getattr(jfa, name), **k):
            seen.add(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(jfa, name, record)

    def fwd_bwd(q, k, v):
        outs, vjp = jax.vjp(lambda *a: jfa.flash_attention_with_lse(
            *a, interpret=True, **kw), q, k, v)
        return vjp(outs)

    q = jax.ShapeDtypeStruct((1, S, 2, 128), dtype)
    kv = jax.ShapeDtypeStruct((1, S, 1, 128), dtype)
    jax.eval_shape(fwd_bwd, q, kv, kv)
    return seen


@pytest.mark.parametrize("S,dtype", [(2048, "bfloat16"), (4096, "float32"),
                                     (8192, "float32"), (12288, "bfloat16"),
                                     (16384, "bfloat16")])
def test_tri_dispatch_takes_the_triangle_where_jax_does(monkeypatch, S,
                                                        dtype):
    """Over causal × window × triangular, at S on either side of the
    resident budget for each dtype: the port's decision equals the set of
    tri kernels the JAX package traces (forward: _kernel_tri; backward:
    both _bwd_*_kernel_tri)."""
    itemsize = jnp.dtype(dtype).itemsize
    for causal in (True, False):
        for window in (None, 1024):
            for triangular in (True, False):
                kw = dict(causal=causal, window=window, triangular=triangular)
                seen = _jax_tri_kernels(monkeypatch, S, dtype, **kw)
                want = ("_kernel_tri" in seen,
                        {"_bwd_dq_kernel_tri", "_bwd_dkv_kernel_tri"} <= seen)
                assert tfa.tri_dispatch(S, 128, itemsize, **kw) == want, kw
                assert seen in (set(), set(TRI_KERNELS[1:]),
                                set(TRI_KERNELS)), seen


@pytest.mark.parametrize("n", [181, 1024])
def test_tri_decode_matches_jax_exactly(n):
    t = np.arange(n * (n + 1) // 2)
    r, c = tfa._tri_decode(t)
    jr, jc = jfa._tri_decode(jnp.asarray(t, jnp.int32), n)
    np.testing.assert_array_equal(r, np.asarray(jr))
    np.testing.assert_array_equal(c, np.asarray(jc))
    kj, qi = tfa._tri_decode_rev(t, n)
    jkj, jqi = jfa._tri_decode_rev(jnp.asarray(t, jnp.int32), n)
    np.testing.assert_array_equal(kj, np.asarray(jkj))
    np.testing.assert_array_equal(qi, np.asarray(jqi))
    assert (c <= r).all() and (qi >= kj).all()


@pytest.mark.parametrize("W,P", [(3, 132), (42, 264), (132, 132),
                                 (4_202_496, 264), (12_345, 7)])
def test_tri_shares_cover_every_tile_once_in_balance(W, P):
    shares = tfa._tri_shares(W, P)
    assert len(shares) == P and shares[0][0] == 0 and shares[-1][1] == W
    assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
    sizes = [hi - lo for lo, hi in shares]
    assert sum(sizes) == W and max(sizes) - min(sizes) <= 1


def _tri_segments(W: int, n: int, P: int) -> list:
    """Twin of flash_tri.cuh's Walk: every CTA's run over its share, one
    (cta, slot, bh, r, c0, c1, whole) per segment (tiles c0..c1 of row r of
    (batch, head) bh; n rows per bh). ``whole``: the row lies whole in the
    share and is finalised in place; else its partial goes to workspace
    ``slot``, 2·cta for a share's first segment, 2·cta + 1 for its last."""
    tiles = n * (n + 1) // 2
    segs = []
    for cta, (t, hi) in enumerate(tfa._tri_shares(W, P)):
        if t >= hi:
            continue
        bh = t // tiles
        r, c = (int(x) for x in tfa._tri_decode(t - bh * tiles))
        seg = 0
        while t < hi:
            c1 = min(r, c + hi - t - 1)
            segs.append((cta, 2 * cta + (seg > 0), bh, r, c, c1,
                         c == 0 and c1 == r))
            t += c1 - c + 1
            seg, c, r = seg + 1, 0, r + 1
            if r == n:
                r, bh = 0, bh + 1
    return segs


def _tri_fixup_pieces(W: int, n: int, P: int) -> dict:
    """Twin of flash_tri.cuh's cut_row and for_each_piece: {(bh, r): [slot,
    ...]}, for every row cut between shares, the workspace slots its fixup
    merges, in flat order. Only the row of a share's last tile can start in
    the share and end past it; the CTA of that share owns its fixup."""
    tiles = n * (n + 1) // 2
    shares = tfa._tri_shares(W, P)
    rows = {}
    for cta, (lo, hi) in enumerate(shares):
        if lo >= hi:
            continue
        bh = (hi - 1) // tiles
        r, c = (int(x) for x in tfa._tri_decode(hi - 1 - bh * tiles))
        start = hi - 1 - c
        end = start + r + 1
        if start < lo or end <= hi:
            continue
        slots = [2 * cta + (start > lo)]
        for c2 in range(cta + 1, P):
            lo2, hi2 = shares[c2]
            if lo2 < hi2:
                slots.append(2 * c2)
            if hi2 >= end:
                break
        rows[(bh, r)] = slots
    return rows


def _cut_rows(W, n, P):
    """{(bh, r): [(c0, c1, slot), ...]} of the rows cut between shares, in
    flat order, from the walk's twin; checks every tile is walked once and
    no workspace slot is written twice."""
    rows, slots, walked = defaultdict(list), set(), 0
    for _, slot, bh, r, c0, c1, whole in _tri_segments(W, n, P):
        walked += c1 - c0 + 1
        if not whole:
            assert slot not in slots
            slots.add(slot)
            rows[(bh, r)].append((c0, c1, slot))
    assert walked == W
    return rows


# (B·heads, n, P): the card's grids (P 264 forward, 132 dQ, 396 dK/dV on
# an H100) at phase 8's shapes, and small ones with W < P, a share inside
# one row and rows cut into three or more pieces; then chip_smoke.py phase
# 19's triangular=True passes at head dims 32 (S 50176, 8/4 heads) and 16
# (S 98816, 4/2), at the grids of D = 64's shared memory (528 forward, 396
# dQ and dK/dV)
SCHEDULES = [(1, 2, 132), (2, 6, 132), (32, 32, 264), (16, 64, 396),
             (16, 128, 132), (8, 512, 264), (4, 1024, 396), (6, 7, 5),
             (1, 9, 2), (6, 40, 7), (3, 11, 40), (8, 784, 528),
             (4, 784, 396), (4, 1544, 528), (2, 1544, 396)]


@pytest.mark.parametrize("heads,n,P", SCHEDULES)
def test_fixup_merges_exactly_the_pieces_of_every_cut_row(heads, n, P):
    """The fixup's twin finds every cut row once, with its pieces' slots in
    flat order, and the pieces tile the row from column 0 to r."""
    W = heads * n * (n + 1) // 2
    cut = _cut_rows(W, n, P)
    fixup = _tri_fixup_pieces(W, n, P)
    assert fixup.keys() == cut.keys()
    for (bh, r), pieces in cut.items():
        assert fixup[(bh, r)] == [slot for _, _, slot in pieces]
        assert pieces[0][0] == 0 and pieces[-1][1] == r
        assert all(a[1] + 1 == b[0] for a, b in zip(pieces, pieces[1:]))


def test_schedules_reach_the_edge_cases():
    """W < P (empty shares), a share inside one row, and a row cut into
    three or more pieces all occur among SCHEDULES."""
    small, inside, three = False, False, False
    for heads, n, P in SCHEDULES:
        W = heads * n * (n + 1) // 2
        small |= W < P
        segs = _tri_segments(W, n, P)
        inside |= any(c0 > 0 and c1 < r for _, _, _, r, c0, c1, _ in segs)
        three |= any(len(p) >= 3 for p in _cut_rows(W, n, P).values())
    assert small and inside and three


@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("P", [5, 13, 40])
def test_cut_row_merge_equals_the_unsplit_result(P, D):
    """The kernels' arithmetic on cut rows, rebuilt on the CPU: every
    segment of the walk's twin computed by the plain versions over its key
    range (forward, dQ) or query range (dK/dV), cut rows merged in flat
    order (_lse_merge for the forward, sums for the backward), equals the
    unsplit plain result at 1e-5. Tile edge 16 at S=96 (6 rows), at head
    dims 16 (tiny's) and 32 (the fast bench_engine model's), which the
    triangle kernels take."""
    B, S, Hq, Hkv, E = 1, 96, 4, 2, 16
    n, group = S // E, Hq // Hkv
    q, k, v, dout = (torch.from_numpy(a) for a in _rand(
        11, (B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, Hq, D)))
    out, lse = tfa.attention_plain(q, k.transpose(1, 2), v.transpose(1, 2), 0)
    want = tfa.attention_bwd_plain(q, k, v, out, lse, dout)

    # forward and dQ: rows (h, qi), tiles kj ascending
    got_o, got_l = torch.zeros_like(out), torch.zeros_like(lse)
    got_dq = torch.zeros_like(q)
    pieces = defaultdict(list)
    for _, _, bh, r, c0, c1, whole in _tri_segments(B * Hq * n * (n + 1)
                                                        // 2, n, P):
        h, rows = bh % Hq, slice(r * E, (r + 1) * E)
        keys = slice(c0 * E, (c1 + 1) * E)
        o, l = tfa.attention_plain(
            q[:, rows, h:h + 1], k[:, keys, h // group:h // group + 1]
            .transpose(1, 2), v[:, keys, h // group:h // group + 1]
            .transpose(1, 2), r * E - c0 * E)
        kmask = torch.zeros(1, S, 1, 1)
        kmask[:, keys] = 1
        dq = tfa.attention_bwd_plain(q, k * kmask, v * kmask, out, lse,
                                     dout)[0][:, rows, h:h + 1]
        pieces[(h, r)].append((o, l, dq))
        assert whole == (len(pieces[(h, r)]) == 1 and c0 == 0 and c1 == r)
    for (h, r), ps in pieces.items():
        rows = slice(r * E, (r + 1) * E)
        o, l = torch.zeros_like(ps[0][0]), torch.full_like(ps[0][1],
                                                           tfa.NEG_INF)
        for po, pl, _ in ps:
            o, l = tring._lse_merge(o, l, po, pl)
        got_o[:, rows, h:h + 1], got_l[:, h:h + 1, rows] = o, l
        got_dq[:, rows, h:h + 1] = sum(p[2] for p in ps)
    torch.testing.assert_close(got_o, out, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got_l, lse, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got_dq, want[0], atol=1e-5, rtol=1e-5)

    # dK/dV: rows (kv head, kj = n-1-r), tiles qi = n-1-c descending, the
    # group's q-heads inside each tile
    got_dk, got_dv = torch.zeros_like(k), torch.zeros_like(v)
    for _, _, bh, r, c0, c1, _ in _tri_segments(B * Hkv * n * (n + 1)
                                                    // 2, n, P):
        kvh, kj = bh % Hkv, n - 1 - r
        qmask = torch.zeros(1, S, 1, 1)
        qmask[:, (n - 1 - c1) * E:(n - c0) * E] = 1
        _, dk, dv = tfa.attention_bwd_plain(q * qmask, k, v, out, lse,
                                            dout * qmask)
        keys = slice(kj * E, (kj + 1) * E)
        got_dk[:, keys, kvh] += dk[:, keys, kvh]
        got_dv[:, keys, kvh] += dv[:, keys, kvh]
    torch.testing.assert_close(got_dk, want[1], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(got_dv, want[2], atol=1e-5, rtol=1e-5)


def test_lse_merge_matches_jax_with_masked_partials():
    """Running and new partials with NEG_INF rows on either side and on
    both (weight 0; both masked stays finite with L = NEG_INF)."""
    B, S, H, D = 2, 16, 3, 8
    o, oi, L, li = _rand(12, (B, S, H, D), (B, S, H, D), (B, H, S), (B, H, S))
    L[0, :, :4] = li[0, :, 2:6] = tfa.NEG_INF
    L[1, 0, :] = li[1, 0, :] = tfa.NEG_INF
    got = tring._lse_merge(*(torch.from_numpy(x) for x in (o, L, oi, li)))
    want = jring._lse_merge(*(jnp.asarray(x) for x in (o, L, oi, li)))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)
    assert (got[1][1, 0] == tfa.NEG_INF).all()


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_sliding_window_training_matches_jax_value_and_grad(impl):
    """bench_long_context's second half at tiny size: a sliding-window
    model's loss and gradients (window 32 at S=128, f32) against
    jax.value_and_grad; flash runs the windowed Pallas kernels in
    interpret mode on the JAX side. Loss 1e-5, gradients 1e-4."""
    jcfg = dataclasses.replace(jl.PRESETS["tiny"], dtype="float32",
                               attn_impl=impl, sliding_window=32)
    jparams = jl.init_params(jax.random.key(3), jcfg)
    toks = np.random.default_rng(13).integers(0, jcfg.vocab_size, (2, 129),
                                              dtype=np.int32)
    inp, tgt = toks[:, :-1], toks[:, 1:]
    jloss, jgrads = jax.value_and_grad(jtrain.loss_fn)(
        jparams, jnp.asarray(inp), jnp.asarray(tgt), jcfg)
    params, _ = ttrain.train_state_from(params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu"))
    cfg = tl.LlamaConfig(**dataclasses.asdict(jcfg))
    loss = ttrain.loss_fn(params, torch.from_numpy(inp),
                          torch.from_numpy(tgt), cfg)
    grads = torch.autograd.grad(loss, ttrain.param_leaves(params))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = _named(jgrads)
    names = list(_named(params))
    assert sorted(names) == sorted(want)
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]),
                                   atol=1e-4, err_msg=name)


def _named(tree):
    """{path: leaf} of a nested dict, in the tree's order."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{n}": x for n, x in _named(v).items()})
        else:
            out[k] = v
    return out


def _section_keys(name):
    """The result keys bench.py's section ``name`` writes (dict literals
    and ``out[...] =``), error records left out."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    keys = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                       ast.Name) \
                and node.targets[0].id == "out" \
                and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Subscript) and isinstance(node.ctx,
                                                          ast.Store) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "out":
            keys.add(node.slice.value)
    return {k for k in keys if "error" not in k}


def test_bench_twins_return_the_jax_sections_keys():
    fo = tbench.bench_flash_op(False, "cpu", shape=(1, 128, 2, 1, 16),
                               streaming_shape=(1, 256, 2, 1, 16))
    assert set(fo) == _section_keys("bench_flash_op")
    assert all(v > 0 for v in fo.values())
    cfg = tl.LlamaConfig(vocab_size=64, dim=32, n_layers=1, n_heads=2,
                         n_kv_heads=1, hidden_dim=64, dtype="float32",
                         attn_impl="flash", remat=True)
    lc = tbench.bench_long_context(False, "cpu", cfg=cfg, seq_len=32,
                                   window=8)
    assert set(lc) == _section_keys("bench_long_context") | {"losses",
                                                             "swa_losses"}
    assert (lc["seq_len"], lc["swa_seq_len"], lc["swa_window"]) == (32, 128, 8)
    assert all(np.isfinite(lc["losses"] + lc["swa_losses"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tbench.bench_long_context(True)


def _hack_module(name):
    """A script of hack/ as a module (it imports no JAX)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "hack"
                                                  / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("Hq,Hkv,window,D", [
    pytest.param(2, 1, None, 128, id="2-1"),
    pytest.param(4, 2, None, 128, id="4-2"),
    pytest.param(2, 1, 160, 128, id="2-1-window"),
    pytest.param(4, 2, 160, 128, id="4-2-window"),
    pytest.param(2, 1, None, 64, id="2-1-d64"),
    pytest.param(4, 2, None, 64, id="4-2-d64"),
    pytest.param(2, 1, 160, 64, id="2-1-window-d64"),
    pytest.param(4, 2, 160, 64, id="4-2-window-d64"),
    pytest.param(4, 1, None, 80, id="4-1-d80"),
    pytest.param(4, 1, 160, 80, id="4-1-window-d80"),
    pytest.param(4, 4, None, 96, id="4-4-d96"),
    pytest.param(4, 4, 160, 96, id="4-4-window-d96"),
    pytest.param(4, 1, None, 256, id="4-1-d256"),
    pytest.param(4, 1, 160, 256, id="4-1-window-d256"),
    pytest.param(4, 4, None, 100, id="4-4-d100"),
    pytest.param(4, 4, 160, 100, id="4-4-window-d100"),
    pytest.param(4, 1, None, 120, id="4-1-d120"),
    pytest.param(4, 1, 160, 120, id="4-1-window-d120")])
def test_tensor_core_rounding_stays_within_half_the_card_tolerance(
        monkeypatch, Hq, Hkv, window, D):
    """ROADMAP Queue C 12: the bf16 tensor-core kernels round P (as bf16
    hi + lo in the forward, once in dK/dV) and dS to bf16 before their
    second product; the JAX kernels keep both in f32. The CPU replay of the
    kernels' arithmetic (hack/torch_tri_bf16_replay.py) on bf16 values
    from a numpy seed, against JAX on the same values (Pallas in interpret
    mode; in f32, so that both sides stop before the last rounding to
    bf16): without a window against triangular=True (streaming forced),
    out, dQ, dK and dV (each gradient relative to its largest value)
    within 5e-3, lse within 5e-5, half the card's 1e-2 and 1e-4, so
    rounding alone never spends the card's tolerance; with a window the
    rectangular flash_bwd_dkv's dK and dV, from the plain forward's out and
    lse, against the JAX rectangular kernels' VJP, within 5e-3; at head
    dims 128 and 64, 80 and 96 at H2O-Danube-1.8B's GQA group of 4 and
    Phi-3-mini's of 1, 256 at Gemma-2B's multi-query group, 100 at
    OpenLLaMA-3B's group of 1 and 120 at H2O-Danube3-4B's of 4 (every head
    dim's kernels round at the same points; at 256 each CTA on its column
    half)."""
    replay = _hack_module("torch_tri_bf16_replay")
    monkeypatch.setattr(jfa, "RESIDENT_KV_BUDGET", 0)
    S = 384
    q, k, v, dout = replay.inputs(21, 1, S, Hq, Hkv, D)
    outs, vjp = jax.vjp(lambda *a: jfa.flash_attention_with_lse(
        *a, triangular=window is None, window=window, block_q=128,
        block_k=128, interpret=True),
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)))
    jdq, jdk, jdv = (np.asarray(g) for g in vjp(
        (jnp.asarray(dout.float().numpy()), jnp.zeros_like(outs[1]))))
    scale = D ** -0.5

    def rel(got, want):
        return np.abs(got.numpy() - want).max() / np.abs(want).max()

    if window is None:
        out, lse = replay.replay_fwd(q, k, v, scale)
        dq = replay.replay_dq(q, k, v, dout, out, lse, scale)
        assert np.abs(out.numpy() - np.asarray(outs[0])).max() <= 5e-3
        assert np.abs(lse.numpy() - np.asarray(outs[1])).max() <= 5e-5
        assert rel(dq, jdq) <= 5e-3
    else:
        out, lse = tfa.attention_plain(q.float(), k.float().transpose(1, 2),
                                       v.float().transpose(1, 2), 0,
                                       window=window)
    dk, dv = replay.replay_dkv(q, k, v, dout, out, lse, scale, window=window)
    assert rel(dk, jdk) <= 5e-3
    assert rel(dv, jdv) <= 5e-3


def test_tri_wrapper_refuses_misaligned_bf16_copies():
    """The bf16 tensor-core kernels copy rows in 16-byte chunks: a bf16
    input they copy with a stride that is not a whole number of chunks, or
    a base off a 16-byte boundary, raises ValueError naming it, before the
    kernel library is asked for; dK/dV copies q, k, v and dout too. f32
    inputs (FMA tile steps) take any strides."""
    S, Hq = 128, 2
    bf = torch.bfloat16
    row = Hq * 128 + 4          # a row stride of 260 elements
    q = torch.zeros(1, S, row, dtype=bf).as_strided(
        (1, S, Hq, 128), (S * row, row, 128, 1))
    k = torch.zeros(1, S, 1, 128, dtype=bf)
    with pytest.raises(ValueError, match=r"flash_fwd_tri: q strides"):
        tfa._launch_tri("flash_fwd_tri", q, k, k, scale=1.0)
    qa = torch.zeros(1, S, Hq, 128, dtype=bf)
    dout = torch.zeros(S * Hq * 128 + 1, dtype=bf)[1:].view(1, S, Hq, 128)
    lse = torch.zeros(1, Hq, S)
    with pytest.raises(ValueError, match=r"flash_bwd_dq_tri: dout is not "
                                         r"16-byte aligned"):
        tfa._launch_tri("flash_bwd_dq_tri", qa, k, k, scale=1.0, dout=dout,
                        lse=lse, delta=lse)
    with pytest.raises(ValueError, match=r"flash_bwd_dkv_tri: q strides"):
        tfa._check_tc_copies("flash_bwd_dkv_tri", q=q, k=k, v=k, dout=dout)
    tfa._check_tc_copies("flash_fwd_tri", q=q.float(), k=k, v=k)


def test_tri_wrapper_checks_before_it_builds():
    """_launch_tri refuses what the kernels do not take before it asks for
    the kernel library (which needs nvcc and a card): head dim 48 (the
    kernels take 16, 32, 64 and 128)."""
    q = torch.zeros(1, 128, 4, 48)
    with pytest.raises(ValueError, match="head dim 48"):
        tfa._launch_tri("flash_fwd_tri", q, q[:, :, :2], q[:, :, :2],
                        scale=1.0)
    q = torch.zeros(1, 128, 4, 128)
    with pytest.raises(ValueError, match="needs dout, lse and delta"):
        tfa._launch_tri("flash_bwd_dq_tri", q, q[:, :, :2], q[:, :, :2],
                        scale=1.0)
