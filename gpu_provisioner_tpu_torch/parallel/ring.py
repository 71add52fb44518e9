"""Dense single-device attention: the twin of the dense half of
``gpu_provisioner_tpu/parallel/ring.py`` (``dense_attention_with_lse`` and
``dense_attention``).

This is the ``attn_impl="dense"`` path. It is the same function as the
flash kernels' plain version, so it calls ``attention_plain`` on token-major
K/V views, leaving one masked-softmax body to keep in step with the
kernels. The ring and zigzag sequence-parallel schedules of the JAX module
are not ported yet; they come with the multi-GPU slice.
"""

from __future__ import annotations

from ..ops.flash_attention import attention_plain


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
