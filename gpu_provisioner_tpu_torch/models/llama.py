"""Llama-family decoder in PyTorch.

Twin of ``gpu_provisioner_tpu/models/llama.py``: the same ``LlamaConfig``
fields and ``PRESETS``, the same parameter layout (stacked ``[L, ...]``
blocks, ``x @ W`` weight orientation, so JAX params carry across unchanged
through ``models/convert.py``), and the same math: an f32 RMSNorm cast back
to the activation dtype before the scale, the half-split rotary embedding,
SwiGLU, and f32 logits. Deliberate differences:

- an eager Python loop over the layers in place of ``lax.scan``/``jit``,
  with ``cfg.remat`` as ``torch.utils.checkpoint`` per block (the twin of
  ``jax.checkpoint``);
- ``init_params`` draws from a ``torch.Generator`` on the target device and,
  for serving, stores the matrices, embedding and norm scales in the
  activation dtype once (the JAX code keeps f32 masters and casts at every
  use, which gives the same numbers); ``lm_head`` stays f32, as the logits
  product is f32. The train state asks for ``cfg.param_dtype`` masters
  (``models/train.py``), which the product code casts at each use;
- ``attn_impl="flash"`` resolves to this package's CUDA kernels;
- no ``param_specs``: tensor parallelism comes with the multi-GPU slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..parallel.ring import dense_attention


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8            # GQA; == n_heads → MHA
    hidden_dim: int = 11008        # SwiGLU inner width
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"        # activation / matmul dtype
    param_dtype: str = "float32"   # the JAX package's master weights
    remat: bool = False            # checkpoint each block (memory ↔ FLOPs)
    seq_schedule: str = "ring"     # sequence parallelism (multi-GPU slice)
    attn_impl: str = "dense"       # "dense" | "flash" (CUDA kernels; the
                                   # dense result for shapes that don't tile)
    kv_cache_dtype: str = "auto"   # "auto" (= act dtype) | "int8"
    sliding_window: Optional[int] = None   # query p attends (p-window, p]
    attn_sinks: int = 0            # first REAL tokens kept attendable under
                                   # a sliding window (StreamingLLM)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def act_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


PRESETS = {
    "llama-7b": LlamaConfig(),
    "llama-1b": LlamaConfig(dim=2048, n_layers=16, n_heads=16, n_kv_heads=8,
                            hidden_dim=5504),
    "mistral-7b-ish": LlamaConfig(vocab_size=32000, dim=4096, n_layers=32,
                                  n_heads=32, n_kv_heads=8, hidden_dim=14336,
                                  max_seq_len=32768, sliding_window=4096),
    "tiny": LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, hidden_dim=128, max_seq_len=128),
}


def resolve_attn(impl: str, window: Optional[int] = None,
                 sinks: int = 0) -> Callable:
    """cfg.attn_impl → attention callable (the one dispatch point). Unknown
    values raise instead of silently running dense. A window with sinks
    stays dense for self-attention, as in the JAX package."""
    if impl not in ("flash", "dense"):
        raise ValueError(
            f"unknown attn_impl {impl!r}; expected 'dense'|'flash'")
    if sinks and window is None:
        raise ValueError(
            f"attn_sinks={sinks} requires sliding_window — without a "
            "window every key is already attendable")
    if sinks < 0:
        raise ValueError(f"attn_sinks must be >= 0, got {sinks}")
    if window is not None:
        if window <= 0:
            raise ValueError(
                f"sliding_window must be positive, got {window} "
                "(use None to disable)")
        if impl == "flash" and not sinks:
            from ..ops.flash_attention import flash_attention
            return partial(flash_attention, window=window)
        return partial(dense_attention, window=window, sinks=sinks)
    if impl == "flash":
        from ..ops.flash_attention import flash_attention
        return flash_attention
    return dense_attention


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None, dtype: Optional[torch.dtype] = None) -> dict:
    """Stacked-layer parameters with the JAX layout, normal(0, fan_in^-1/2)
    drawn in f32 from ``generator`` on ``device`` (default cuda). Matrices,
    embedding and norms are stored in ``dtype`` (default cfg's activation
    dtype, the serving storage; the train state passes f32 masters),
    lm_head in f32. jax.random cannot be reproduced here: tests carry JAX
    params across with params_from_numpy instead of comparing inits."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    ad = cfg.act_dtype if dtype is None else dtype
    L, D, F_ = cfg.n_layers, cfg.dim, cfg.hidden_dim
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def norm(shape, fan_in, dtype=ad):
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return w.mul_(fan_in ** -0.5).to(dtype)

    return {
        "embed": norm((cfg.vocab_size, D), D),
        "blocks": {
            "wq": norm((L, D, Hq * Dh), D),
            "wk": norm((L, D, Hkv * Dh), D),
            "wv": norm((L, D, Hkv * Dh), D),
            "wo": norm((L, Hq * Dh, D), Hq * Dh),
            "w_gate": norm((L, D, F_), D),
            "w_up": norm((L, D, F_), D),
            "w_down": norm((L, F_, D), F_),
            "ln_attn": torch.ones((L, D), dtype=ad, device=dev),
            "ln_mlp": torch.ones((L, D), dtype=ad, device=dev),
        },
        "ln_final": torch.ones((D,), dtype=ad, device=dev),
        "lm_head": norm((D, cfg.vocab_size), D, torch.float32),
    }


def layer_params(params: dict, layer: int) -> dict:
    """One layer's slice of the stacked blocks (views, no copy)."""
    return {k: v[layer] for k, v in params["blocks"].items()}


def _rmsnorm(x, scale, eps):
    xf = x.float()
    rms = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rms).to(x.dtype) * scale.to(x.dtype)


def _rope(x, positions, theta):
    """Rotary embedding, half-split. x: [B, S, H, D], positions: [B, S] or
    [S]."""
    D = x.shape[-1]
    freqs = theta ** (-torch.arange(0, D, 2, dtype=torch.float32,
                                    device=x.device) / D)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs                   # [B, S, D/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _project_qkv(h, lp, cfg: LlamaConfig, positions):
    """Normed input → roped (q, k, v), shared with models/decode.py."""
    B, S, _ = h.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ad = cfg.act_dtype
    q = (h @ lp["wq"].to(ad)).reshape(B, S, Hq, Dh)
    k = (h @ lp["wk"].to(ad)).reshape(B, S, Hkv, Dh)
    v = (h @ lp["wv"].to(ad)).reshape(B, S, Hkv, Dh)
    return (_rope(q, positions, cfg.rope_theta),
            _rope(k, positions, cfg.rope_theta), v)


def _mlp_half(x, lp, cfg: LlamaConfig):
    """Norm → SwiGLU → residual (shared with models/decode.py)."""
    ad = cfg.act_dtype
    h = _rmsnorm(x, lp["ln_mlp"], cfg.norm_eps)
    gated = F.silu(h @ lp["w_gate"].to(ad)) * (h @ lp["w_up"].to(ad))
    return x + gated @ lp["w_down"].to(ad)


def _block_attention_half(x, lp, cfg: LlamaConfig, positions, attn_fn):
    """Norm → QKV → rope → attention → residual."""
    B, S, _ = x.shape
    h = _rmsnorm(x, lp["ln_attn"], cfg.norm_eps)
    q, k, v = _project_qkv(h, lp, cfg, positions)
    o = attn_fn(q, k, v).reshape(B, S, cfg.n_heads * cfg.head_dim)
    return x + o @ lp["wo"].to(cfg.act_dtype)


def _block(x, lp, cfg: LlamaConfig, positions, attn_fn):
    """One decoder block. x: [B, S, D], lp: this layer's params."""
    x = _block_attention_half(x, lp, cfg, positions, attn_fn)
    return _mlp_half(x, lp, cfg)


def _logits(x, params: dict, cfg: LlamaConfig):
    """Final norm, then the f32 vocabulary product."""
    x = _rmsnorm(x, params["ln_final"], cfg.norm_eps)
    return x.float() @ params["lm_head"].float()


def forward(params: dict, tokens, cfg: LlamaConfig,
            attn_fn: Optional[Callable] = None, positions=None):
    """Logits for next-token prediction. tokens: [B, S] int → [B, S, V]
    f32. ``attn_fn(q, k, v) -> o`` defaults to cfg's attention;
    ``positions`` defaults to arange(S). Differentiable (the serving entry
    points call it under no_grad); ``cfg.remat`` recomputes each block in
    the backward instead of keeping its activations."""
    if attn_fn is None:
        attn_fn = resolve_attn(cfg.attn_impl, cfg.sliding_window,
                               cfg.attn_sinks)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = params["embed"][tokens].to(cfg.act_dtype)                # [B, S, D]
    for layer in range(cfg.n_layers):
        lp = layer_params(params, layer)
        if cfg.remat:
            x = checkpoint(_block, x, lp, cfg, positions, attn_fn,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _block(x, lp, cfg, positions, attn_fn)
    return _logits(x, params, cfg)


class Llama(nn.Module):
    """The model as an ``nn.Module``: holds the parameter tree (frozen,
    forward-only in this slice) and runs ``forward``. ``.params`` is the
    dict the functional API (generate, ServeEngine) takes."""

    def __init__(self, cfg: LlamaConfig, params: dict):
        super().__init__()
        self.cfg = cfg

        def frozen(t):
            return nn.Parameter(t, requires_grad=False)

        self.embed = frozen(params["embed"])
        self.blocks = nn.ParameterDict(
            {k: frozen(v) for k, v in params["blocks"].items()})
        self.ln_final = frozen(params["ln_final"])
        self.lm_head = frozen(params["lm_head"])

    @property
    def params(self) -> dict:
        return {"embed": self.embed, "blocks": dict(self.blocks.items()),
                "ln_final": self.ln_final, "lm_head": self.lm_head}

    def forward(self, tokens, positions=None):
        return forward(self.params, tokens, self.cfg, positions=positions)
