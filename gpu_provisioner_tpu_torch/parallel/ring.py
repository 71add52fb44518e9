"""Dense single-device attention: the twin of the dense half of
``gpu_provisioner_tpu/parallel/ring.py`` (``dense_attention_with_lse`` and
``dense_attention``), and its ``_lse_merge``, the merge of normalised
partial attentions by their logsumexp (the plain version of the forward
fixup of ``ops/csrc/flash_tri.cu``; the ring schedules will merge with it).

This is the ``attn_impl="dense"`` path. It is the same function as the
flash kernels' plain version, so it calls ``attention_plain`` on token-major
K/V views, leaving one masked-softmax body to keep in step with the
kernels. The ring and zigzag sequence-parallel schedules of the JAX module
are not ported yet; they come with the multi-GPU slice.
"""

from __future__ import annotations

import torch

from ..ops.flash_attention import NEG_INF, attention_plain


def dense_attention_with_lse(q, k, v, *, causal: bool = True,
                             scale: float | None = None,
                             window: int | None = None, sinks: int = 0):
    """Exact attention returning (out [B,Sq,Hq,D], lse [B,Hq,Sq] f32).
    q [B,Sq,Hq,D], k/v [B,Sk,Hkv,D]. Fully-masked rows yield zeros and
    lse = NEG_INF, the kernels' convention. ``window``: query i attends keys
    in (i - window, i]; ``sinks``: keys at positions < sinks stay
    attendable (an OR against the window bound, never widening causality)."""
    return attention_plain(q, k.transpose(1, 2), v.transpose(1, 2), 0,
                           causal=causal, scale=scale, window=window,
                           sinks=sinks)


def dense_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, window: int | None = None,
                    sinks: int = 0):
    """dense_attention_with_lse without the lse."""
    return dense_attention_with_lse(q, k, v, causal=causal, scale=scale,
                                    window=window, sinks=sinks)[0]


def _lse_merge(o, L, o_i, lse_i):
    """Merge a normalized partial (o_i [B,Sq,H,D], lse_i [B,H,Sq]) into the
    running (o, L): O = (O·w + O_i·w_i)/(w + w_i), L = M + log(w + w_i),
    w = exp(L − M). The NEG_INF sentinel marks fully-masked partials
    (weight 0); both guards keep masked×masked merges finite. o comes back
    in f32."""
    o_i = o_i.float()
    M = torch.maximum(L, lse_i)
    w_old = torch.where(L > NEG_INF / 2, torch.exp(L - M), 0.0)
    w_new = torch.where(lse_i > NEG_INF / 2, torch.exp(lse_i - M), 0.0)
    z = w_old + w_new
    safe = torch.where(z > 0, z, 1.0)
    wo = (w_old / safe).transpose(1, 2)[..., None]
    wn = (w_new / safe).transpose(1, 2)[..., None]
    o = o * wo + o_i * wn
    L = torch.where(z > 0, M + torch.log(safe), NEG_INF)
    return o, L
