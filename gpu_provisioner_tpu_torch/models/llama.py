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
- tensor parallelism is explicit, not a sharding annotation:
  ``param_specs`` names the dim of each leaf split over ``model``, and with
  a ``tp`` group the forward takes this rank's shards (local head counts,
  ``head_dim`` from the global config), ``comm.copy_to_tp`` before each
  column-parallel product and ``comm.reduce_from_tp`` after ``wo`` and
  ``w_down`` (Megatron's pair, where GSPMD inserts the collectives), a
  vocabulary-parallel embedding (a masked local lookup, then a sum over
  the group) and logits for the rank's vocabulary columns. Without ``tp``
  the forward is the single-device one.
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
from ..parallel.comm import TPGroup, copy_to_tp, reduce_from_tp
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
    seq_schedule: str = "ring"     # "ring" | "zigzag" (balanced causal ring)
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


def normal_init(generator: torch.Generator, device, shape, fan_in: int,
                dtype: torch.dtype) -> torch.Tensor:
    """normal(0, fan_in^-1/2) drawn in f32 from ``generator`` on ``device``,
    stored in ``dtype``; raises when the generator lives elsewhere. With no
    generator on the ``meta`` device (a shape-only init: the checkpoint's
    restore target) nothing is drawn."""
    if generator is None and device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, params on "
                         f"{device}")
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return w.mul_(fan_in ** -0.5).to(dtype)


def init_params(cfg: LlamaConfig, generator: Optional[torch.Generator],
                device=None, dtype: Optional[torch.dtype] = None) -> dict:
    """Stacked-layer parameters with the JAX layout, normal(0, fan_in^-1/2)
    drawn in f32 from ``generator`` on ``device`` (default cuda; no
    generator on ``meta``: shapes and dtypes only). Matrices,
    embedding and norms are stored in ``dtype`` (default cfg's activation
    dtype, the serving storage; the train state passes f32 masters),
    lm_head in f32. jax.random cannot be reproduced here: tests carry JAX
    params across with params_from_numpy instead of comparing inits."""
    dev = resolve_device(device)
    ad = cfg.act_dtype if dtype is None else dtype
    L, D, F_ = cfg.n_layers, cfg.dim, cfg.hidden_dim
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    norm = partial(normal_init, generator, dev, dtype=ad)

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
        "lm_head": norm((D, cfg.vocab_size), D, dtype=torch.float32),
    }


def param_specs(cfg: LlamaConfig) -> dict:
    """The dim of each leaf split over the ``model`` axis (None: replicated),
    the twin of the JAX ``param_specs``' PartitionSpecs: QKV, gate and up
    by columns, ``wo`` and ``w_down`` by rows, the embedding by vocabulary
    rows, ``lm_head`` by vocabulary columns. The stacked layer dim is never
    split."""
    return {
        "embed": 0,
        "blocks": {"wq": 2, "wk": 2, "wv": 2, "wo": 1, "w_gate": 2,
                   "w_up": 2, "w_down": 1, "ln_attn": None, "ln_mlp": None},
        "ln_final": None,
        "lm_head": 1,
    }


def layer_params(params: dict, layer: int) -> dict:
    """One layer's slice of the stacked blocks (views, no copy)."""
    return {k: v[layer] for k, v in params["blocks"].items()}


def layer_list(params: dict) -> list:
    """Every layer's slice of the stacked blocks (views, no copy), from one
    ``unbind`` a stacked leaf. Under autograd its backward stacks the
    layers' gradients once; a layer's ``v[layer]`` would have each layer's
    backward fill a gradient the size of the whole stack with zeros and
    add it to the others (L times the stack's bytes, twice)."""
    blocks = params["blocks"]
    return [dict(zip(blocks, vals))
            for vals in zip(*(v.unbind(0) for v in blocks.values()))]


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


def _project_qkv(h, lp, cfg: LlamaConfig, positions, heads=None):
    """Normed input → roped (q, k, v), shared with models/decode.py.
    ``heads``: this rank's (q, kv) head counts under tensor parallelism
    (default cfg's); the head dim stays cfg's."""
    B, S, _ = h.shape
    Hq, Hkv = heads or (cfg.n_heads, cfg.n_kv_heads)
    Dh = cfg.head_dim
    ad = cfg.act_dtype
    q = (h @ lp["wq"].to(ad)).reshape(B, S, Hq, Dh)
    k = (h @ lp["wk"].to(ad)).reshape(B, S, Hkv, Dh)
    v = (h @ lp["wv"].to(ad)).reshape(B, S, Hkv, Dh)
    return (_rope(q, positions, cfg.rope_theta),
            _rope(k, positions, cfg.rope_theta), v)


def _mlp_half(x, lp, cfg: LlamaConfig, tp: Optional[TPGroup] = None):
    """Norm → SwiGLU → residual (shared with models/decode.py). With ``tp``
    the gate/up columns and ``w_down`` rows are this rank's."""
    ad = cfg.act_dtype
    h = _rmsnorm(x, lp["ln_mlp"], cfg.norm_eps)
    if tp is not None:
        h = copy_to_tp(h, tp)
    gated = F.silu(h @ lp["w_gate"].to(ad)) * (h @ lp["w_up"].to(ad))
    out = gated @ lp["w_down"].to(ad)
    return x + (out if tp is None else reduce_from_tp(out, tp))


def _tp_heads(h, cfg: LlamaConfig, tp: Optional[TPGroup]):
    """(h, heads) for the QKV product: with ``tp`` the normed input through
    ``copy_to_tp`` and this rank's (n_heads / tp, n_kv_heads / tp) head
    counts; without, ``h`` and None (cfg's heads)."""
    if tp is None:
        return h, None
    return copy_to_tp(h, tp), (cfg.n_heads // tp.size,
                               cfg.n_kv_heads // tp.size)


def _block_attention_half(x, lp, cfg: LlamaConfig, positions, attn_fn,
                          tp: Optional[TPGroup] = None):
    """Norm → QKV → rope → attention → residual. With ``tp`` the rank's
    heads (n_heads / tp q heads, n_kv_heads / tp kv heads)."""
    B, S, _ = x.shape
    h, heads = _tp_heads(_rmsnorm(x, lp["ln_attn"], cfg.norm_eps), cfg, tp)
    q, k, v = _project_qkv(h, lp, cfg, positions, heads)
    o = attn_fn(q, k, v).reshape(B, S, q.shape[2] * cfg.head_dim)
    out = o @ lp["wo"].to(cfg.act_dtype)
    return x + (out if tp is None else reduce_from_tp(out, tp))


def _block(x, lp, cfg: LlamaConfig, positions, attn_fn,
           tp: Optional[TPGroup] = None):
    """One decoder block. x: [B, S, D], lp: this layer's params."""
    x = _block_attention_half(x, lp, cfg, positions, attn_fn, tp)
    return _mlp_half(x, lp, cfg, tp)


def _logits(x, params: dict, cfg: LlamaConfig, tp: Optional[TPGroup] = None):
    """Final norm, then the f32 vocabulary product (this rank's vocabulary
    columns under ``tp``)."""
    x = _rmsnorm(x, params["ln_final"], cfg.norm_eps)
    if tp is not None:
        x = copy_to_tp(x, tp)
    return x.float() @ params["lm_head"].float()


def _embed(params: dict, tokens, cfg: LlamaConfig,
           tp: Optional[TPGroup] = None):
    """The token embeddings [B, S, D] in the activation dtype. Under ``tp``
    the rank holds vocabulary rows [rank·V/tp, (rank+1)·V/tp): it looks up
    the tokens it owns, zeros the rest, and the group sums."""
    if tp is None:
        return params["embed"][tokens].to(cfg.act_dtype)
    rows = params["embed"].shape[0]
    local = tokens - tp.rank * rows
    own = (local >= 0) & (local < rows)
    x = params["embed"][local.clamp(0, rows - 1)]
    x = torch.where(own[..., None], x, 0.0).to(cfg.act_dtype)
    return reduce_from_tp(x, tp)


def forward(params: dict, tokens, cfg: LlamaConfig,
            attn_fn: Optional[Callable] = None, positions=None,
            tp: Optional[TPGroup] = None):
    """Logits for next-token prediction. tokens: [B, S] int → [B, S, V]
    f32. ``attn_fn(q, k, v) -> o`` defaults to cfg's attention;
    ``positions`` defaults to arange(S) (pass global positions when the
    sequence is sharded). Differentiable (the serving entry points call it
    under no_grad); ``cfg.remat`` recomputes each block in the backward
    instead of keeping its activations. With ``tp`` the params are this
    rank's shards (``param_specs``) and the logits its V/tp vocabulary
    columns."""
    if attn_fn is None:
        attn_fn = resolve_attn(cfg.attn_impl, cfg.sliding_window,
                               cfg.attn_sinks)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=tokens.device)
    x = _embed(params, tokens, cfg, tp)                          # [B, S, D]
    layers = layer_list(params)
    for layer in range(cfg.n_layers):
        lp = layers[layer]
        if cfg.remat:
            x = checkpoint(_block, x, lp, cfg, positions, attn_fn, tp,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _block(x, lp, cfg, positions, attn_fn, tp)
    return _logits(x, params, cfg, tp)


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
