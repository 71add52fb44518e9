"""Flash attention for Hopper: wrappers, gates and plain versions.

Twin of ``gpu_provisioner_tpu/ops/flash_attention.py``'s forward surface:
``flash_attention`` / ``flash_attention_with_lse`` (Pallas ``_kernel_resident``
and ``_kernel``), ``flash_attention_cached`` (``_kernel_cached``) and
``flash_attention_decode`` (``_kernel_decode``), with the same gates
(``_auto_block``, the ``tiles`` test, ``cached_flash_supported``,
``decode_flash_supported``), so the port dispatches exactly where the JAX
package does, and the dense result for shapes that do not tile.

Each wrapper launches its hand-written CUDA kernel (``csrc/flash_fwd.cu``,
``csrc/flash_decode.cu``) on a CUDA tensor, or raises; on a CPU tensor it
runs ``attention_plain``, the plain PyTorch version of the same function.
Nothing else picks between the two. Deliberate differences from the JAX
module:

- forward only: every wrapper raises if an input requires grad (the
  backward kernels come with the training slice);
- no ``interpret`` argument (the plain version is the CPU path) and no
  ``triangular`` option (its kernels, #3/#8/#9, are not ported yet);
- no block sizes: the CUDA kernels pick their own tiles, and the gates keep
  the JAX block rule (``_auto_block``);
- head dim 128 only (every Llama preset's); another head dim raises on a
  CUDA tensor;
- a plain launch counter per wrapper, ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

NEG_INF = -1.0e30  # mask value; finite so exp() underflows instead of NaN-ing
DEFAULT_BLOCK = 512
DECODE_MAX_S = 16   # short-block bound: decode steps / verify blocks

# kernel launches per wrapper, counted where each launches its kernel
LAUNCHES = {"flash_fwd": 0, "flash_cached": 0, "flash_decode": 0}

_ACT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (128,)


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


def _check_no_grad(*tensors) -> None:
    if any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "flash attention is forward-only in this port: the backward "
            "kernels come with the training slice")


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
    (any strides, head dim contiguous)."""
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
        raise ValueError(f"head dim {D}: the kernel takes {_HEAD_DIMS}")
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
    fn = getattr(_cuda.library(kernel), kernel)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(ctypes.byref(a), stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed with cudaError {rc}")
    return out, lse


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             scale: float = None, window: int = None):
    """Self-attention q [B,S,Hq,D], k/v [B,S,Hkv,D] → (out [B,S,Hq,D],
    lse [B,Hq,S] f32). Takes the kernel when S tiles into the (JAX)
    blocks and GQA divides; any other shape gets the dense path."""
    _check_no_grad(q, k, v)
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    if scale is None:
        scale = D ** -0.5
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)    # views, no copy
    tiles = (S % _auto_block(S) == 0 and Hq % Hkv == 0
             and q.shape[1] == k.shape[1])
    if not tiles:   # the dense result, as the JAX package gives
        return attention_plain(q, kh, vh, 0, causal=causal, scale=scale,
                               window=window)
    if q.device.type == "cuda":
        out_lse = _launch("flash_fwd", q, kh, vh, 0, causal=causal,
                          scale=scale, window=window, want_lse=True)
        LAUNCHES["flash_fwd"] += 1
        return out_lse
    _require_cpu(q)
    return attention_plain(q, kh, vh, 0, causal=causal, scale=scale,
                           window=window)


def flash_attention(q, k, v, *, causal: bool = True, scale: float = None,
                    window: int = None):
    """Drop-in for dense_attention: q [B,S,Hq,D], k/v [B,S,Hkv,D] →
    [B,S,Hq,D]."""
    return flash_attention_with_lse(q, k, v, causal=causal, scale=scale,
                                    window=window)[0]


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
    if q.device.type == "cuda":
        out, _ = _launch("flash_fwd", q, k_cache, v_cache, start, **kw)
        LAUNCHES["flash_cached"] += 1
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
    if q.device.type == "cuda":
        out, _ = _launch("flash_decode", q, k_cache, v_cache, start, **kw)
        LAUNCHES["flash_decode"] += 1
        return out
    _require_cpu(q)
    return attention_plain(q, k_cache, v_cache, start, **kw)[0]
