"""Flash attention for Hopper: wrappers, gates and plain versions.

Twin of ``gpu_provisioner_tpu/ops/flash_attention.py``:
``flash_attention`` / ``flash_attention_with_lse`` (Pallas ``_kernel_resident``
and ``_kernel`` forward, ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``
backward, differentiable in out and lse as ``_flash_lse_diff`` is; with
``triangular=True`` the flattened-triangle ``_kernel_tri``,
``_bwd_dq_kernel_tri`` and ``_bwd_dkv_kernel_tri`` where the JAX package
takes them, ``tri_dispatch``),
``flash_attention_cached`` (``_kernel_cached``) and
``flash_attention_decode`` (``_kernel_decode``), with the same gates
(``_auto_block``, the ``tiles`` test, ``cached_flash_supported``,
``decode_flash_supported``), so the port dispatches exactly where the JAX
package does, and the dense result for shapes that do not tile (which
autograd differentiates, as JAX does).

Each wrapper launches its hand-written CUDA kernel (``csrc/flash_fwd.cuh``,
``csrc/flash_decode.cuh``, ``csrc/flash_bwd.cuh``, ``csrc/flash_tri.cuh``) on
a CUDA tensor, or
raises; on a CPU tensor it runs the plain PyTorch version of the same
function (``attention_plain``, ``attention_bwd_plain``). Nothing else picks
between the two.

What bounds the kernels on an H100: the forward, dQ and dK/dV of
self-attention and of a cached prefill are compute-bound (4, 6 and 8·D
operations per attended pair and q-head against a few bytes per position),
the decode kernel's short query blocks read the cache (bytes). So every
bf16 instance but the decode kernel's runs on the tensor cores (the int8
cache's prefill too, its tiles widened exactly to bf16): one warpgroup per
64-row tile, ``wgmma`` on swizzled bf16 tiles fed by a ``cp.async`` ring
over the live key (or query) tiles only, the mask on fragments; the f32
instances stay f32 FMA, the exactness instances. The decode kernel spreads
each (batch, kv head)'s live cache over many CTAs (split-KV, a share of
the live tiles each, partials merged by log-sum-exp in a second launch),
streams it through a ``cp.async`` ring in the cache's own dtype and stays
f32 FMA for every dtype. Deliberate differences from the JAX module:

- ``flash_attention_cached`` and ``flash_attention_decode`` raise if an
  input requires grad: their JAX twins have no VJP;
- no ``interpret`` argument (the plain version is the CPU path);
- ``triangular=True`` takes ``csrc/flash_tri.cuh``: on the TPU the flat
  triangle saves the dead cells of the sequential grid, which the CUDA
  kernels' loops over live tiles skip anyway; on the card it is a
  persistent launch that gives every CTA an equal share of the live tiles
  (balance), with a fixup launch for the rows cut between shares. The
  decode and the shares of its schedule have CPU twins here
  (``_tri_decode``, ``_tri_decode_rev``, ``_tri_shares``) that the tests
  check; it runs the rectangular kernels' tile steps;
- ``flash_attention_decode`` splits each (batch, kv head)'s live cache
  tiles among several CTAs and merges their partials by log-sum-exp (the
  sums in another order); its schedule has a CPU twin here
  (``_decode_tiles``, ``_decode_shares``, ``_decode_merge``,
  ``_decode_split_plain``) that the tests hold against JAX;
- every bf16 kernel but the decode runs on the tensor cores
  (``csrc/flash_tc.cuh``'s tile steps): the forward's P as two bf16 terms
  (hi + lo), P and dS each rounded to bf16 before their second product in
  the backward, where the JAX kernels keep them f32 (ROADMAP Queue C 12,
  14; an int8 cache widens exactly to bf16 with its scales on the score
  and P columns, Queue C 15); these kernels, and the decode kernel's K/V
  ring in every dtype, need 16-byte aligned inputs (``_check_tc_copies``,
  a ValueError on a direct launch), and the model paths (the autograd
  forward and backward, ``flash_attention_cached``,
  ``flash_attention_decode``) copy an input or cotangent that is not
  (``_tc_layout``), where the JAX kernels take any layout;
- no block sizes: the CUDA kernels pick their own tiles, and the gates keep
  the JAX block rule (``_auto_block``);
- head dims 16, 32, 64, 80, 96 and 128 in every kernel (``_HEAD_DIMS``; at
  32 and 16 the tensor-core tile is the 64-wide one partly filled, at 80
  and 96 the 128-wide one, each from a source of its own: ``_cuda.entry``);
  on a CUDA tensor any other head dim raises a ValueError naming it before
  a kernel is built or launched (no plain fallback), where the JAX kernels
  take any head dim;
- the dK/dV kernels fold GQA inside the block instead of writing f32
  per-q-head arrays and summing them after;
- a plain launch counter per kernel, ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _cuda

NEG_INF = -1.0e30  # mask value; finite so exp() underflows instead of NaN-ing
DEFAULT_BLOCK = 512
DECODE_MAX_S = 16   # short-block bound: decode steps / verify blocks
# flash_decode's split schedule (csrc/flash_decode.cuh): the row counts of its
# instances, the most CTAs that share one unit's live tiles, and its tile
DECODE_ROWS = (4, 8, 16, 32, 64)
DECODE_MAX_SPLITS = 32
_TILE = 64
# K+V bytes (in the input dtype) the TPU keeps resident in VMEM before its
# forward switches to the streaming grid, where triangular=True applies: a
# copy of the JAX constant, kept so the port takes the triangle exactly
# where the JAX package does (bf16 at D 128: S > 12288; at D 64: S > 24576)
RESIDENT_KV_BUDGET = 6 * 1024 * 1024

# launches per kernel, counted where its wrapper launches it; an int8 cache
# has its own counts (the int8 instances of flash_fwd and flash_decode), and
# flash_decode's merge launch is counted with its split launch (one C entry)
LAUNCHES = {"flash_fwd": 0, "flash_cached": 0, "flash_cached_int8": 0,
            "flash_decode": 0, "flash_decode_int8": 0,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "flash_fwd_tri": 0,
            "flash_bwd_dq_tri": 0, "flash_bwd_dkv_tri": 0}

_ACT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# the head dims every kernel is built for
_HEAD_DIMS = (16, 32, 64, 80, 96, 128)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _auto_block(S: int) -> int:
    """Largest aligned block <= DEFAULT_BLOCK that tiles S (the JAX gate's
    block rule, kept so the port takes a kernel exactly where JAX does)."""
    b = min(DEFAULT_BLOCK, S)
    while b >= 128:
        if S % b == 0:
            return b
        b //= 2
    return DEFAULT_BLOCK  # won't tile; the caller takes the dense path


def tri_dispatch(S: int, D: int, itemsize: int, *, causal: bool,
                 triangular: bool, window) -> tuple[bool, bool]:
    """(forward, backward): whether self-attention that tiles takes the
    flattened-triangle kernels, exactly where the JAX package's _flash and
    _flash_bwd_impl do. Both need causal, triangular and no window (_auto_block
    always gives block_q == block_k); the forward also needs the streaming
    regime, K+V past RESIDENT_KV_BUDGET. Anywhere else the flag is a no-op."""
    tri = bool(causal and triangular and window is None)
    return tri and 2 * S * D * itemsize > RESIDENT_KV_BUDGET, tri


def _tri_decode(t):
    """Flat index t of a triangle → (row r, column c <= r), row r starting
    at r(r+1)/2: the twin of the JAX _tri_decode and of flash_tri.cuh's
    tri_decode, in exact integers (numpy int64, ints or arrays): the float
    square root is a seed, the two corrections decide."""
    t = np.asarray(t, dtype=np.int64)
    r = np.floor((np.sqrt(8.0 * t + 1.0) - 1.0) / 2.0).astype(np.int64)
    r = np.where(r * (r + 1) // 2 > t, r - 1, r)
    r = np.where((r + 1) * (r + 2) // 2 <= t, r + 1, r)
    return r, t - r * (r + 1) // 2


def _tri_decode_rev(t, n: int):
    """The dK/dV triangle (qi >= kj): flat index → (kj, qi), row u = n-1-kj
    walking qi down from n-1 to kj, as the JAX _tri_decode_rev."""
    u, v = _tri_decode(t)
    return n - 1 - u, n - 1 - v


def _tri_shares(W: int, P: int) -> list:
    """CTA c's share [c·W/P, (c+1)·W/P) of W flat tiles among P CTAs."""
    return [(c * W // P, (c + 1) * W // P) for c in range(P)]


def _decode_rows(rows: int) -> tuple[int, int]:
    """(R, row blocks) of flash_decode for a unit of ``rows`` = S·group query
    rows: R the smallest instance that holds them, 64 at most, and the row
    blocks of R that cover them (csrc/flash_decode.cuh launch_rows)."""
    R = next((r for r in DECODE_ROWS if r >= rows), DECODE_ROWS[-1])
    return R, -(-rows // R)


def _decode_splits(units: int, max_len: int, sms: int) -> int:
    """The CTAs that share each of ``units`` (batch, kv head, row block)
    units' live key tiles: about two CTAs an SM in all, at most one a cache
    tile and DECODE_MAX_SPLITS. From shapes alone: the host never reads the
    starts (a device tensor; reading it would sync)."""
    return max(1, min(-(-2 * sms // units), max_len // _TILE,
                      DECODE_MAX_SPLITS))


def _window_first_tile(min_qpos: int, window) -> int:
    """The first key tile not wholly below the window of the row at
    ``min_qpos`` (csrc/flash_common.cuh fa::window_first_tile)."""
    x = min_qpos - (window or 0) - (_TILE - 2)
    return -(-x // _TILE) if window and x > 0 else 0


def _decode_tiles(start: int, pad: int, first_s: int, last_s: int, Sk: int,
                  window=None, sinks: int = 0) -> tuple[int, int, int, int]:
    """A unit's live key tiles as two runs, [lo, a_end) (the sink tiles under
    a window) then [b0, hi): the pad floor's tile to the causal frontier of
    the unit's last row (position start + last_s), less the tiles wholly
    below the window of its first row (start + first_s) that do not overlap
    the sinks [pad, pad + sinks) (fa::window_skips). The twin of
    csrc/flash_decode.cuh's live_tiles."""
    hi_pos = min(Sk, start + last_s + 1)
    lo = pad // _TILE
    hi = -(-hi_pos // _TILE) if hi_pos > 0 else 0
    wlo = _window_first_tile(start + first_s, window)
    sink_end = (pad + sinks - 1) // _TILE + 1 if window and sinks > 0 else 0
    a_end = max(lo, min(hi, sink_end))
    return lo, a_end, max(lo, wlo, a_end), hi


def _decode_shares(lo_tile: int, hi_tile: int, n_split: int, *,
                   a_end=None, b0=None) -> list:
    """The key tiles each of ``n_split`` CTAs walks: CTA c takes [c·n/P,
    (c+1)·n/P) of the n live tiles [lo_tile, a_end) + [b0, hi_tile) (by
    default the whole run [lo_tile, hi_tile)), in order; a share may be
    empty."""
    a_end = lo_tile if a_end is None else a_end
    b0 = lo_tile if b0 is None else b0
    live = list(range(lo_tile, a_end)) + list(range(b0, hi_tile))
    n = len(live)
    return [live[c * n // n_split:(c + 1) * n // n_split]
            for c in range(n_split)]


def _decode_merge(parts):
    """Normalised partials [(out [..., S, H, D], lse [..., H, S])] of the
    same rows over disjoint key sets → (out f32, lse): the log-sum-exp
    merge of flash_decode's merge launch; rows no part attended (lse =
    NEG_INF everywhere) give zeros and NEG_INF."""
    lses = torch.stack([lse.float() for _, lse in parts])
    M = lses.amax(0)
    w = torch.where(lses > NEG_INF / 2, torch.exp(lses - M), 0.0)
    L = w.sum(0)
    w = w / torch.where(L > 0, L, 1.0)
    out = sum(wi.transpose(-1, -2)[..., None] * o.float()
              for wi, (o, _) in zip(w, parts))
    return out, torch.where(L > 0, M + torch.log(torch.where(L > 0, L, 1.0)),
                            NEG_INF)


def _decode_split_plain(q, k_cache, v_cache, start, n_split: int, *,
                        scale=None, pad_lens=None, k_scale=None,
                        v_scale=None, window=None, sinks: int = 0):
    """The CPU twin of flash_decode's split schedule, the function of
    flash_attention_decode: for each (batch, kv head, row block) unit
    (_decode_rows), its live key tiles (_decode_tiles) cut into ``n_split``
    shares (_decode_shares), each share's partial computed by
    attention_plain on the keys of its tiles alone (a run of tiles at key
    offset k0 is the cache slice from k0 with positions, pad and start
    shifted by k0), and the partials merged by log-sum-exp
    (_decode_merge). Returns out [B,S,Hq,D] f32."""
    B, S, Hq, D = q.shape
    Hkv, Sk = k_cache.shape[1], k_cache.shape[2]
    group, rows = Hq // Hkv, S * (Hq // Hkv)
    R, blocks = _decode_rows(rows)
    starts = _start_vector(start, B, q.device).tolist()
    pads = [0] * B if pad_lens is None else pad_lens.long().tolist()
    out = torch.zeros(B, S, Hq, D)
    for b in range(B):
        for h in range(Hkv):
            heads = slice(h * group, (h + 1) * group)
            for rb in range(blocks):
                r0, r1 = rb * R, min(rb * R + R, rows)
                lo, a_end, b0, hi = _decode_tiles(
                    starts[b], pads[b], r0 // group, (r1 - 1) // group, Sk,
                    window, sinks)
                parts = []
                for share in _decode_shares(lo, hi, n_split, a_end=a_end,
                                            b0=b0):
                    while share:   # each run of consecutive tiles
                        n = next((i for i in range(1, len(share))
                                  if share[i] != share[i - 1] + 1),
                                 len(share))
                        k0, k1 = share[0] * _TILE, min(share[n - 1] * _TILE
                                                       + _TILE, Sk)
                        share = share[n:]
                        sl = (slice(b, b + 1), slice(h, h + 1),
                              slice(k0, k1))
                        kw = dict(scale=scale, window=window, sinks=sinks,
                                  pad_lens=torch.tensor([pads[b] - k0]))
                        if k_scale is not None:
                            kw.update(k_scale=k_scale[sl], v_scale=v_scale[sl])
                        parts.append(attention_plain(
                            q[b:b + 1, :, heads], k_cache[sl], v_cache[sl],
                            starts[b] - k0, **kw))
                if not parts:
                    continue
                o, _ = _decode_merge(parts)             # [1, S, group, D]
                for r in range(r0, r1):
                    out[b, r // group, h * group + r % group] = \
                        o[0, r // group, r % group]
    return out


def _check_no_grad(*tensors) -> None:
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise NotImplementedError(
            "the KV-cache attention wrappers are forward-only, as their JAX "
            "twins are (no VJP): call them under torch.no_grad()")


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lies on the card, where a wrapper launches its kernel
    (the module's one device test; the CPU tests stand it in to reach the
    launch path's checks and layouts)."""
    return t.device.type == "cuda"


def _require_cpu(t: torch.Tensor) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"no attention kernel for device {t.device}")


def _start_vector(start, B: int, device) -> torch.Tensor:
    """start (int, or a tensor of 1 or B values) → int64 [B]."""
    if isinstance(start, torch.Tensor):
        st = start.to(device=device, dtype=torch.long).reshape(-1)
        if st.numel() not in (1, B):
            raise ValueError(f"start must be scalar or [B={B}]; got "
                             f"{tuple(start.shape)}")
        return st.expand(B)
    return torch.full((B,), int(start), dtype=torch.long, device=device)


def attention_plain(q, k, v, start, *, causal: bool = True,
                    scale: float | None = None, pad_lens=None, k_scale=None,
                    v_scale=None, window: int | None = None, sinks: int = 0):
    """Plain PyTorch version of every forward kernel: (out [B,S,Hq,D] in
    q's dtype, lse [B,Hq,S] f32).

    q [B,S,Hq,D] at positions start_b + 0..S-1 (``start`` an int or 1 or B
    values); k/v head-major [B,Hkv,Sk,D] (a transposed view of token-major
    K/V works), int8 with ``k_scale``/``v_scale`` [B,Hkv,Sk,1] f32. Key kp
    is attendable from query position qp iff (!causal or kp <= qp),
    kp >= pad_b, and with a window (kp > qp - window or kp < pad_b + sinks).
    Fully-masked rows (pad-query rows among them) give zeros and lse =
    NEG_INF, as the kernels do."""
    B, S, Hq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf = kf * k_scale
        vf = vf * v_scale
    qg = q.float().reshape(B, S, Hkv, group, D)
    s = torch.einsum("bshgd,bhkd->bhgsk", qg, kf) * scale
    q_pos = (_start_vector(start, B, q.device)[:, None]
             + torch.arange(S, device=q.device))[:, :, None]       # [B,S,1]
    k_pos = torch.arange(Sk, device=q.device)[None, None, :]      # [1,1,Sk]
    pad = (torch.zeros(B, dtype=torch.long, device=q.device)
           if pad_lens is None else pad_lens.to(q.device).long())
    keep = k_pos >= pad[:, None, None]
    if causal:
        keep = keep & (k_pos <= q_pos)
    if window is not None:
        wkeep = k_pos > q_pos - window
        if sinks:
            wkeep = wkeep | (k_pos < (pad + sinks)[:, None, None])
        keep = keep & wkeep
    s = torch.where(keep[:, None, None], s, NEG_INF)
    m = s.amax(dim=-1)                                           # [B,Hkv,g,S]
    p = torch.exp(s - m[..., None])
    p = torch.where((m > NEG_INF / 2)[..., None], p, 0.0)
    l = p.sum(dim=-1)
    safe_l = torch.where(l > 0, l, 1.0)
    o = torch.einsum("bhgsk,bhkd->bshgd", p, vf)
    o = o / safe_l.permute(0, 3, 1, 2)[..., None]
    lse = torch.where(l > 0, m + torch.log(safe_l), NEG_INF)
    return o.reshape(B, S, Hq, D).to(q.dtype), lse.reshape(B, Hq, S)


def _launch(kernel: str, q, k, v, start, *, causal: bool, scale: float,
            pad_lens=None, k_scale=None, v_scale=None, window=None,
            sinks: int = 0, want_lse: bool = False):
    """Checks what the CUDA kernel takes, allocates the outputs and launches
    ``kernel`` on the current stream. k/v are head-major [B,Hkv,Sk,D] views
    (any strides, head dim contiguous; the bf16 ``flash_fwd`` takes 16-byte
    chunks of q, k and v, ``flash_decode`` of k and v: ``_check_tc_copies``).
    ``flash_decode`` also gets its split plan (``_decode_plan``) and, with
    more than one split, the f32 workspace of its partials."""
    B, S, Hq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dev = q.device
    for name, t in (("k", k), ("v", v), ("k_scale", k_scale),
                    ("v_scale", v_scale)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in _ACT_DTYPES:
        raise TypeError(f"q dtype {q.dtype}: the kernel takes float32 or "
                        "bfloat16")
    int8 = k_scale is not None
    want_kv = torch.int8 if int8 else q.dtype
    if k.dtype != want_kv or v.dtype != want_kv:
        raise TypeError(f"k/v dtype {k.dtype}/{v.dtype}; expected {want_kv}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head dim {D}: {kernel} takes head dims "
                         f"{_HEAD_DIMS}")
    if tuple(k.shape) != (B, Hkv, Sk, D) or k.shape != v.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0; got {Hq}/{Hkv}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the head dim of q, k and v must be contiguous")
    if int8:
        if v_scale is None or k_scale.dtype != torch.float32 \
                or v_scale.dtype != torch.float32:
            raise TypeError("int8 K/V need float32 k_scale and v_scale")
        if tuple(k_scale.shape) != (B, Hkv, Sk, 1) \
                or k_scale.shape != v_scale.shape \
                or k_scale.stride() != v_scale.stride():
            raise ValueError("k_scale/v_scale must be [B,Hkv,Sk,1] with "
                             "equal strides")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    _check_tc_copies(kernel, q=q, k=k, v=v)

    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, Hq, S), dtype=torch.float32, device=dev)
           if want_lse else None)
    a = _cuda.FlashArgs()
    a.q, a.k, a.v, a.out = q.data_ptr(), k.data_ptr(), v.data_ptr(), \
        out.data_ptr()
    a.lse = lse.data_ptr() if lse is not None else None
    a.q_sb, a.q_ss, a.q_sh = q.stride(0), q.stride(1), q.stride(2)
    a.k_sb, a.k_sh, a.k_ss = k.stride(0), k.stride(1), k.stride(2)
    a.v_sb, a.v_sh, a.v_ss = v.stride(0), v.stride(1), v.stride(2)
    a.o_sb, a.o_ss, a.o_sh = out.stride(0), out.stride(1), out.stride(2)
    if int8:
        a.k_scale, a.v_scale = k_scale.data_ptr(), v_scale.data_ptr()
        a.sc_sb, a.sc_sh, a.sc_ss = (k_scale.stride(0), k_scale.stride(1),
                                     k_scale.stride(2))
    keep = []   # device temporaries referenced until the launch is queued
    if isinstance(start, torch.Tensor):
        st = start.to(device=dev, dtype=torch.int32).reshape(-1).contiguous()
        if st.numel() not in (1, B):
            raise ValueError(f"start must be scalar or [B={B}]; got "
                             f"{tuple(start.shape)}")
        keep.append(st)
        a.starts, a.n_start = st.data_ptr(), st.numel()
    else:
        a.start, a.n_start = int(start), 1
    if pad_lens is not None:
        pl = pad_lens.to(device=dev, dtype=torch.int32).contiguous()
        if pl.shape != (B,):
            raise ValueError(f"pad_lens must be [B={B}]")
        keep.append(pl)
        a.pad_lens = pl.data_ptr()
    a.act_dtype, a.kv_dtype = _ACT_DTYPES[q.dtype], _KV_DTYPES[k.dtype]
    a.B, a.Sq, a.Sk, a.Hq, a.Hkv, a.D = B, S, Sk, Hq, Hkv, D
    a.causal, a.window, a.sinks = int(causal), window or 0, sinks
    a.scale = scale
    if kernel == "flash_decode":
        R, units, a.splits = _decode_plan(B, S, Hq, Hkv, Sk, _sm_count(dev))
        if a.splits > 1:
            ws = torch.empty(units * a.splits * R * (D + 2),
                             dtype=torch.float32, device=dev)
            keep.append(ws)
            a.ws, a.ws_floats = ws.data_ptr(), ws.numel()
    _run(kernel, a, dev)
    return out, lse


_SMS: dict = {}


def _sm_count(dev) -> int:
    """The SM count of card ``dev`` (cached)."""
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev.index]


def _decode_plan(B: int, S: int, Hq: int, Hkv: int, max_len: int,
                 sms: int) -> tuple[int, int, int]:
    """(R, units, splits) of a flash_decode launch: rows per unit
    (_decode_rows), (batch, kv head, row block) units, and the CTAs that
    share each unit's live tiles (_decode_splits)."""
    R, blocks = _decode_rows(S * (Hq // Hkv))
    units = B * Hkv * blocks
    return R, units, _decode_splits(units, max_len, sms)


def _run(kernel: str, a, dev) -> None:
    """Launches ``kernel``'s C entry at the struct's head dim
    (``_cuda.entry``) with argument struct ``a`` on ``dev``'s current
    stream; raises on a non-zero cudaError."""
    fn = _cuda.kernel(_cuda.entry(kernel, a.D))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(ctypes.byref(a), stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed with cudaError {rc}")


def _bwd_delta(out, dout, g_lse):
    """Δ = rowsum(dO∘O) in f32, minus the lse cotangent when there is one
    (∂lse/∂S = P, so it folds into Δ): [B, Hq, S]."""
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    return delta if g_lse is None else delta - g_lse.float()


def attention_bwd_plain(q, k, v, out, lse, dout, g_lse=None, *,
                        causal: bool = True, scale: float | None = None,
                        window: int | None = None):
    """Plain PyTorch version of both backward kernels: (dq, dk, dv) of
    self-attention q [B,S,Hq,D], k/v [B,S,Hkv,D] at positions 0..S-1, given
    the forward's out [B,S,Hq,D] and lse [B,Hq,S] f32, the cotangent dout of
    out and, or None, g_lse of lse. The explicit math of the JAX package's
    _rebuild_p_ds, _bwd_dq_step and _bwd_dkv_step, not autograd: P =
    exp(S − lse), zero where masked and on rows with lse = NEG_INF; dS =
    P∘(dP − Δ)·scale; dQ = dS K, dK = dSᵀ Q, dV = Pᵀ dO, the group's q-heads
    summed onto their kv head. f32 throughout; each gradient is returned in
    its input's dtype."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    group = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    qf = q.float().reshape(B, S, Hkv, group, D)
    gf = dout.float().reshape(B, S, Hkv, group, D)
    kf, vf = k.float(), v.float()
    pos = torch.arange(S, device=q.device)
    keep = torch.ones(S, S, dtype=torch.bool, device=q.device)
    if causal:
        keep = pos[None, :] <= pos[:, None]
    if window is not None:
        keep = keep & (pos[None, :] > pos[:, None] - window)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    s = torch.where(keep, s, NEG_INF)
    lse_ = lse.float().reshape(B, Hkv, group, S, 1)
    p = torch.where(lse_ > NEG_INF / 2, torch.exp(s - lse_), 0.0)
    del s
    dp = torch.einsum("bqhgd,bkhd->bhgqk", gf, vf)
    delta = _bwd_delta(out, dout, g_lse).reshape(B, Hkv, group, S, 1)
    ds = p * (dp - delta) * scale
    del dp
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(B, S, Hq, D)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_self_attention(kernel, q, k, v, dout=None, lse=None,
                          delta=None) -> None:
    """What the self-attention kernels (flash_bwd.cuh, flash_tri.cuh) take:
    q/k/v (and dout) token-major [B,S,H,D] on one device in one of the
    kernels' dtypes, head dim 16, 32, 64, 80, 96 or 128 (``_HEAD_DIMS``)
    contiguous, GQA dividing; lse and delta, where given, contiguous
    float32 [B,Hq,S]. Raises naming ``kernel``."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    dev = q.device
    named = [("k", k), ("v", v), ("dout", dout), ("lse", lse),
             ("delta", delta)]
    for name, t in named:
        if t is not None and t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    if q.dtype not in _ACT_DTYPES:
        raise TypeError(f"q dtype {q.dtype}: the kernel takes float32 or "
                        "bfloat16")
    acts = [t for t in (k, v, dout) if t is not None]
    if any(t.dtype != q.dtype for t in acts):
        raise TypeError("k/v/dout dtypes "
                        + "/".join(str(t.dtype) for t in acts)
                        + f"; expected {q.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head dim {D}: {kernel} takes head dims "
                         f"{_HEAD_DIMS}")
    if tuple(k.shape) != (B, S, Hkv, D) or k.shape != v.shape \
            or (dout is not None and dout.shape != q.shape):
        raise ValueError(f"shapes q {tuple(q.shape)}, k/v {tuple(k.shape)}/"
                         f"{tuple(v.shape)}, dout "
                         f"{None if dout is None else tuple(dout.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"GQA needs Hq % Hkv == 0; got {Hq}/{Hkv}")
    if any(t.stride(-1) != 1 for t in [q] + acts):
        raise ValueError("the head dim of q, k, v and dout must be "
                         "contiguous")
    for name, t in named[3:]:
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != (B, Hq, S)
                              or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 "
                             f"[B={B}, Hq={Hq}, S={S}]")


def _launch_bwd(kernel: str, q, k, v, dout, lse, delta, *, causal: bool,
                scale: float, window=None):
    """Checks what the backward kernels take, allocates ``kernel``'s outputs
    and launches it on the current stream: ``flash_bwd_dq`` → dq [B,S,Hq,D]
    in q's dtype, ``flash_bwd_dkv`` → (dk, dv) [B,S,Hkv,D] in k's. q/k/v/dout
    token-major with the head dim contiguous (in bf16, ``flash_bwd_dkv``
    takes 16-byte chunks: ``_check_tc_copies``); lse and delta [B,Hq,S]
    f32."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    dev = q.device
    _check_self_attention(kernel, q, k, v, dout, lse, delta)
    _check_tc_copies(kernel, q=q, k=k, v=v, dout=dout)
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")

    a = _cuda.FlashBwdArgs()
    a.q, a.k, a.v, a.dout = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                             dout.data_ptr())
    a.lse, a.delta = lse.data_ptr(), delta.data_ptr()
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (dout, "do")):
        for ax, st in zip("bsh", t.stride()[:3]):
            setattr(a, f"{name}_s{ax}", st)
    if kernel == "flash_bwd_dq":
        outs = (torch.empty((B, S, Hq, D), dtype=q.dtype, device=dev),)
        names = ("dq",)
    else:
        outs = tuple(torch.empty((B, S, Hkv, D), dtype=k.dtype, device=dev)
                     for _ in range(2))
        names = ("dk", "dv")
    for t, name in zip(outs, names):
        setattr(a, name, t.data_ptr())
        for ax, st in zip("bsh", t.stride()[:3]):
            setattr(a, f"{name}_s{ax}", st)
    a.act_dtype = _ACT_DTYPES[q.dtype]
    a.B, a.S, a.Hq, a.Hkv, a.D = B, S, Hq, Hkv, D
    a.causal, a.window, a.scale = int(causal), window or 0, scale
    _run(kernel, a, dev)
    LAUNCHES[kernel] += 1
    return outs[0] if len(outs) == 1 else outs


# the kernels whose instances copy 16-byte chunks of the named inputs into
# shared memory (cp.async): the bf16 tensor-core instances (flash_fwd with a
# bf16 or an int8 cache; its f32 instances read element by element, any
# row stride), and every instance of flash_decode (its K/V ring, in the
# cache's dtype; it reads q element by element)
_TC_COPIED = {"flash_fwd": ("q", "k", "v"),
              "flash_decode": ("k", "v"),
              "flash_bwd_dq": ("q", "k", "v", "dout"),
              "flash_fwd_tri": ("q", "k", "v"),
              "flash_bwd_dq_tri": ("q", "k", "v", "dout"),
              "flash_bwd_dkv_tri": ("q", "k", "v", "dout"),
              "flash_bwd_dkv": ("q", "k", "v", "dout")}


def _tc_copy_fault(t, any_dtype: bool = False) -> str | None:
    """Why a kernel cannot copy ``t`` in 16-byte chunks (rows of D values:
    a 16-byte aligned base, batch, position and head strides of whole
    chunks), or None when it can. Only bf16 is checked unless
    ``any_dtype`` (f32 chunks hold 4 values, int8 chunks 16)."""
    if t.dtype != torch.bfloat16 and not any_dtype:
        return None
    if t.data_ptr() % 16:
        return "is not 16-byte aligned"
    chunk = 16 // t.element_size()
    sb, ss, sh = t.stride()[:3]
    if sb % chunk or ss % chunk or sh % chunk:
        return (f"strides {(sb, ss, sh)} are not multiples of {chunk} "
                "elements (16 bytes)")
    return None


def _check_tc_copies(kernel: str, **tensors) -> None:
    """Raises ValueError naming the first input that ``kernel``'s instance
    for these dtypes copies and cannot (``_tc_copy_fault``); the f32
    instances of every kernel but flash_decode copy nothing."""
    if kernel != "flash_decode" and tensors["q"].dtype != torch.bfloat16:
        return
    for name in _TC_COPIED.get(kernel, ()):
        fault = _tc_copy_fault(tensors[name], any_dtype=True)
        if fault:
            raise ValueError(f"{kernel}: {name} {fault}")


def _tc_layout(t, any_dtype: bool = False):
    """``t`` itself when every kernel takes its layout (head dim contiguous
    and ``_tc_copy_fault`` clear: in bf16, or in any dtype with
    ``any_dtype``), else a contiguous copy in fresh, aligned storage: a
    layout copy, the same values."""
    if t.stride(-1) == 1 and _tc_copy_fault(t, any_dtype) is None:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch_tri(kernel: str, q, k, v, *, scale: float, dout=None, lse=None,
                delta=None):
    """Checks what the flattened-triangle kernels take (causal
    self-attention, no window; in bf16 the 16-byte chunks the tensor-core
    kernels copy, ``_check_tc_copies``), allocates ``kernel``'s outputs and
    its f32 workspace (two slots per CTA of the persistent grid; its size
    depends on the dtype and the head dim) and queues its main
    launch and its fixup on the current stream: ``flash_fwd_tri`` → (out
    [B,S,Hq,D], lse [B,Hq,S] f32), ``flash_bwd_dq_tri`` → dq,
    ``flash_bwd_dkv_tri`` → (dk, dv). q/k/v/dout token-major with the head
    dim contiguous; lse and delta (the backward's) [B,Hq,S] f32."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    dev = q.device
    fwd = kernel == "flash_fwd_tri"
    if not fwd and (dout is None or lse is None or delta is None):
        raise ValueError(f"{kernel} needs dout, lse and delta")
    _check_self_attention(kernel, q, k, v, dout, lse, delta)
    _check_tc_copies(kernel, q=q, k=k, v=v, dout=dout)
    act = _ACT_DTYPES[q.dtype]
    P = _cuda.tri_ctas(kernel, act, D, dev.index)
    ws = torch.empty(P * _cuda.tri_ws_floats(kernel, act, D),
                     dtype=torch.float32, device=dev)
    a = _cuda.FlashTriArgs()
    if fwd:
        lse = torch.empty((B, Hq, S), dtype=torch.float32, device=dev)
        outs = {"o": torch.empty((B, S, Hq, D), dtype=q.dtype, device=dev)}
    elif kernel == "flash_bwd_dq_tri":
        outs = {"dq": torch.empty((B, S, Hq, D), dtype=q.dtype, device=dev)}
    else:
        outs = {n: torch.empty((B, S, Hkv, D), dtype=k.dtype, device=dev)
                for n in ("dk", "dv")}
    for name, t in (("q", q), ("k", k), ("v", v), ("do", dout), *outs.items()):
        if t is None:
            continue
        setattr(a, {"do": "dout", "o": "out"}.get(name, name), t.data_ptr())
        for ax, st in zip("bsh", t.stride()[:3]):
            setattr(a, f"{name}_s{ax}", st)
    a.lse = lse.data_ptr()
    a.delta = delta.data_ptr() if delta is not None else None
    a.ws, a.ws_floats = ws.data_ptr(), ws.numel()
    a.act_dtype = act
    a.B, a.S, a.Hq, a.Hkv, a.D, a.ctas = B, S, Hq, Hkv, D, P
    a.scale = scale
    _run(kernel, a, dev)
    LAUNCHES[kernel] += 1
    if fwd:
        return outs["o"], lse
    return outs["dq"] if "dq" in outs else (outs["dk"], outs["dv"])


def flash_attention_bwd(q, k, v, out, lse, dout, g_lse=None, *,
                        causal: bool = True, scale: float | None = None,
                        window: int | None = None, triangular: bool = False):
    """(dq, dk, dv) of self-attention from the forward's out and lse, as
    attention_bwd_plain defines them: on a CUDA tensor the dQ kernel and the
    dK/dV kernel (Δ computed here), their flattened-triangle versions where
    tri_dispatch says so; on a CPU tensor attention_bwd_plain."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _on_card(q):
        delta = _bwd_delta(out, dout, g_lse).contiguous()
        if tri_dispatch(q.shape[1], q.shape[-1], q.element_size(),
                        causal=causal, triangular=triangular,
                        window=window)[1]:
            kw = dict(scale=scale, dout=dout, lse=lse, delta=delta)
            dq = _launch_tri("flash_bwd_dq_tri", q, k, v, **kw)
            dk, dv = _launch_tri("flash_bwd_dkv_tri", q, k, v, **kw)
            return dq, dk, dv
        kw = dict(causal=causal, scale=scale, window=window)
        dq = _launch_bwd("flash_bwd_dq", q, k, v, dout, lse, delta, **kw)
        dk, dv = _launch_bwd("flash_bwd_dkv", q, k, v, dout, lse, delta, **kw)
        return dq, dk, dv
    _require_cpu(q)
    return attention_bwd_plain(q, k, v, out, lse, dout, g_lse, causal=causal,
                               scale=scale, window=window)


class _FlashAttention(torch.autograd.Function):
    """Self-attention differentiable in out and lse: the twin of the JAX
    package's ``_flash_lse_diff`` (custom_vjp, flash_attention.py). Forward
    saves (q, k, v, out, lse); backward runs flash_attention_bwd with the
    cotangents of both outputs. CUDA tensors take the kernels, CPU tensors
    the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, triangular):
        if _on_card(q):
            # a caller may hand over any layout (a strided q, a narrow of a
            # fused projection): copy what the kernels would refuse
            ql, kl, vl = (_tc_layout(t) for t in (q, k, v))
            if tri_dispatch(q.shape[1], q.shape[-1], q.element_size(),
                            causal=causal, triangular=triangular,
                            window=window)[0]:
                out, lse = _launch_tri("flash_fwd_tri", ql, kl, vl,
                                       scale=scale)
            else:
                out, lse = _launch("flash_fwd", ql, kl.transpose(1, 2),
                                   vl.transpose(1, 2), 0, causal=causal,
                                   scale=scale, window=window, want_lse=True)
                LAUNCHES["flash_fwd"] += 1
        else:
            _require_cpu(q)
            out, lse = attention_plain(q, k.transpose(1, 2),
                                       v.transpose(1, 2), 0, causal=causal,
                                       scale=scale, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, scale, window, triangular)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, window, triangular = ctx.mask
        g_out = torch.zeros_like(out) if g_out is None else g_out
        # autograd may hand over any layout (the narrow of a torch.cat's
        # gradient, say): copy what the kernels would refuse
        q, k, v, g_out = (_tc_layout(t) for t in (q, k, v, g_out))
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g_out, g_lse,
                                         causal=causal, scale=scale,
                                         window=window, triangular=triangular)
        return dq, dk, dv, None, None, None, None


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             scale: float = None, window: int = None,
                             triangular: bool = False):
    """Self-attention q [B,S,Hq,D], k/v [B,S,Hkv,D] → (out [B,S,Hq,D],
    lse [B,Hq,S] f32), differentiable in both. Takes the kernels when S
    tiles into the (JAX) blocks and GQA divides; any other shape gets the
    dense path, which autograd differentiates. ``triangular=True``: the
    flattened-triangle kernels where the JAX package takes them
    (tri_dispatch: causal, no window; the forward only past
    RESIDENT_KV_BUDGET), the same function on another schedule; elsewhere a
    no-op."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    if scale is None:
        scale = D ** -0.5
    tiles = (S % _auto_block(S) == 0 and Hq % Hkv == 0
             and q.shape[1] == k.shape[1])
    if not tiles:   # the dense result, as the JAX package gives
        return attention_plain(q, k.transpose(1, 2), v.transpose(1, 2), 0,
                               causal=causal, scale=scale, window=window)
    return _FlashAttention.apply(q, k, v, causal, scale, window, triangular)


def flash_attention(q, k, v, *, causal: bool = True, scale: float = None,
                    window: int = None, triangular: bool = False):
    """Drop-in for dense_attention: q [B,S,Hq,D], k/v [B,S,Hkv,D] →
    [B,S,Hq,D]. One backward serves this and the with_lse variant: the
    dropped lse has no cotangent, so Δ takes none."""
    return flash_attention_with_lse(q, k, v, causal=causal, scale=scale,
                                    window=window, triangular=triangular)[0]


def cached_flash_supported(S: int, max_len: int, Hq: int, Hkv: int) -> bool:
    """True iff flash_attention_cached serves these shapes (the JAX gate:
    S and max_len tile into >=128-aligned blocks, GQA divides)."""
    bq, bk = _auto_block(S), _auto_block(max_len)
    return (S % bq == 0 and max_len % bk == 0 and Hq % Hkv == 0
            and bq >= 128 and bk >= 128)


def flash_attention_cached(q, k_cache, v_cache, start, *, scale: float = None,
                           k_scale=None, v_scale=None, pad_lens=None,
                           window: int = None, sinks: int = 0):
    """Fresh queries q [B,S,Hq,D] at cache positions start..start+S-1
    against the head-major cache k/v [B,Hkv,max_len,D] (those positions
    already written) → [B,S,Hq,D]. ``start``: one position for all rows (an
    int or a one-element tensor). ``k_scale``/``v_scale`` [B,Hkv,max_len,1]:
    int8 cache. ``pad_lens`` [B]: left pads; pad-query rows emit zero.
    ``window``/``sinks``: sliding window with attention sinks counted from
    each row's pad. Callers gate on cached_flash_supported()."""
    _check_no_grad(q, k_cache, v_cache)
    if isinstance(start, torch.Tensor) and start.numel() != 1:
        raise ValueError("flash_attention_cached takes one start for all "
                         "rows; per-row starts go to flash_attention_decode")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kw = dict(causal=True, scale=scale, pad_lens=pad_lens, k_scale=k_scale,
              v_scale=v_scale, window=window, sinks=sinks)
    if _on_card(q):
        if q.dtype == torch.bfloat16:   # the tensor-core instances
            q, k_cache, v_cache = (_tc_layout(t, any_dtype=True)
                                   for t in (q, k_cache, v_cache))
        out, _ = _launch("flash_fwd", q, k_cache, v_cache, start, **kw)
        LAUNCHES["flash_cached_int8" if k_scale is not None
                 else "flash_cached"] += 1
        return out
    _require_cpu(q)
    return attention_plain(q, k_cache, v_cache, start, **kw)[0]


def decode_flash_supported(max_len: int, Hq: int, Hkv: int,
                           S: int = 1) -> bool:
    """True iff flash_attention_decode serves these shapes (max_len tiles
    into >=128-aligned kv blocks, GQA divides, query block short)."""
    bk = _auto_block(max_len)
    return (max_len % bk == 0 and bk >= 128 and Hq % Hkv == 0
            and 1 <= S <= DECODE_MAX_S)


def flash_attention_decode(q, k_cache, v_cache, start, *, scale: float = None,
                           k_scale=None, v_scale=None, pad_lens=None,
                           window: int = None, sinks: int = 0):
    """A short query block q [B,S,Hq,D] (S <= DECODE_MAX_S) at cache
    positions start_b..start_b+S-1 against the head-major cache → [B,S,Hq,D].
    ``start`` is an int, or a tensor of 1 or B values (per-row lengths, as
    the serving engine's slots have). Pads, int8, window and sinks as in
    flash_attention_cached. Callers gate on decode_flash_supported()."""
    _check_no_grad(q, k_cache, v_cache)
    S = q.shape[1]
    if not 1 <= S <= DECODE_MAX_S:
        raise ValueError(f"decode kernel serves short query blocks "
                         f"(S<={DECODE_MAX_S}); got S={S}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    kw = dict(causal=True, scale=scale, pad_lens=pad_lens, k_scale=k_scale,
              v_scale=v_scale, window=window, sinks=sinks)
    if _on_card(q):
        k_cache, v_cache = (_tc_layout(t, any_dtype=True)
                            for t in (k_cache, v_cache))
        out, _ = _launch("flash_decode", q, k_cache, v_cache, start, **kw)
        LAUNCHES["flash_decode_int8" if k_scale is not None
                 else "flash_decode"] += 1
        return out
    _require_cpu(q)
    return attention_plain(q, k_cache, v_cache, start, **kw)[0]
