"""End-to-end serving example: a tensor-parallel world → KV-cache serving.

Twin of ``examples/workloads/serve.py``::

    python -m gpu_provisioner_tpu_torch.examples.serve              # cuda
    python -m gpu_provisioner_tpu_torch.examples.serve --device cpu

Two ranks (``parallel/launch.py``, gloo) form a ``tp=2`` mesh; each holds
its shards of the ``tiny`` model (``shard_params``), and rank 0's lines are
printed:
  1. one-shot generation, fresh-cache prefill then decode steps, greedy and
     sampled (temperature / top-k / top-p; the same seeded generator on
     both ranks);
  2. a ragged batch, left-padded, finishing at eos, with logprobs;
  3. an int8 KV cache; a multi-turn chat (turn 1, two decode steps, turn 2
     on the same cache, its kv heads cut over ``model``,
     ``kv_cache_specs``);
  4. the MoE family, a sliding window, speculative decoding (a self-draft:
     every proposal accepted) and the continuous-batching engine with a
     draft.
With ``TPU_KAITO_BOOTSTRAP=auto`` the process is instead one rank of the
world its pod belongs to: ``parallel/bootstrap.py`` reads its Node's labels
(``NODE_NAME``) and starts the process group, and the same rank body runs
on ``make_mesh(tp=2)`` over that world (``examples.run_bootstrapped``).
Deliberate differences: prompts and sampled streams come from
``torch.Generator`` seeds (``jax.random``'s cannot be reproduced).
"""

from __future__ import annotations

import argparse
import os
from dataclasses import replace

import torch

from ..device import resolve_device
from ..models.decode import (cached_forward, generate, init_kv_cache,
                             kv_cache_specs, serve_shard)
from ..models.engine import ServeEngine
from ..models.llama import PRESETS, init_params, param_specs
from ..models.moe import PRESETS_MOE, init_moe_model, moe_model_specs
from ..models.speculative import speculative_generate
from ..models.train import shard_params
from ..parallel.launch import spawn_ranks
from ..parallel.topology import axis_sizes, make_mesh
from . import run_bootstrapped

WORLD = 2


def rank_main(device: str) -> list:
    """One rank of the example: its printed lines."""
    lines = []
    dev = resolve_device(device)
    cfg = replace(PRESETS["tiny"], max_seq_len=512)
    mesh = make_mesh(tp=2, device=device)
    params = shard_params(
        init_params(cfg, torch.Generator(dev).manual_seed(0), dev), mesh,
        specs=param_specs(cfg))
    lines.append(f"serving on mesh {axis_sizes(mesh)}")
    g = torch.Generator().manual_seed(1)
    # real tokens from [1, vocab): 0 is the ragged demo's pad id
    prompt = torch.randint(1, cfg.vocab_size, (2, 16), generator=g).to(dev)
    serve = dict(device=dev, mesh=mesh)

    greedy = generate(params, prompt, cfg, max_new_tokens=8, **serve)
    sampled = generate(params, prompt, cfg, max_new_tokens=8,
                       temperature=0.8, top_k=32, top_p=0.95,
                       generator=torch.Generator(dev).manual_seed(7),
                       **serve)
    lines.append(f"greedy : {greedy[0].tolist()}")
    lines.append(f"sampled: {sampled[0].tolist()}")

    # ragged batch: left-padded, finishing at eos, with logprobs
    short = prompt[:1, :6]
    pads = torch.zeros((1, 10), dtype=short.dtype, device=dev)
    ragged = torch.cat([torch.cat([pads, short], 1), prompt[1:, :16]], 0)
    out, lps = generate(params, ragged, cfg, max_new_tokens=8, pad_id=0,
                        eos_id=int(greedy[0, -1]), return_logprobs=True,
                        **serve)
    lines.append(f"ragged : {out.tolist()}")
    lines.append(f"logprob: {[round(float(x), 2) for x in lps[0]]}")

    cfg8 = replace(cfg, kv_cache_dtype="int8")
    out8 = generate(params, prompt, cfg8, max_new_tokens=8, **serve)
    lines.append(f"int8   : {out8[0].tolist()}")

    # multi-turn: turn 1, two decode steps, turn 2 on the same cache, whose
    # kv heads (kv_cache_specs: dim 2) are this rank's
    shard = serve_shard(mesh, dev, (params, cfg))
    cache = init_kv_cache(cfg, 2, 256, dev, shard=shard)
    assert cache.k.shape[kv_cache_specs(cfg).k] == cfg.n_kv_heads // 2
    logits, cache = cached_forward(params, prompt, cache, cfg, shard=shard)
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    for _ in range(2):
        logits, cache = cached_forward(params, tok, cache, cfg, shard=shard)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    turn2 = torch.randint(0, cfg.vocab_size, (2, 16), generator=g).to(dev)
    logits, cache = cached_forward(params, turn2, cache, cfg, shard=shard)
    assert int(cache.length) == 16 + 2 + 16
    lines.append(f"multi-turn cache length: {int(cache.length)}")

    # the MoE family through the same generate(), its experts' inner width
    # over ``model``
    moe_cfg = PRESETS_MOE["tiny-moe"]
    moe_params = shard_params(
        init_moe_model(moe_cfg, torch.Generator(dev).manual_seed(3), dev),
        mesh, specs=moe_model_specs(moe_cfg))
    moe_prompt = torch.randint(1, moe_cfg.vocab_size, (2, 12),
                               generator=g).to(dev)
    moe_out = generate(moe_params, moe_prompt, moe_cfg, max_new_tokens=8,
                       max_len=64, **serve)
    lines.append(f"moe    : {moe_out[0].tolist()}")

    swa_out = generate(params, prompt, replace(cfg, sliding_window=8),
                       max_new_tokens=8, **serve)
    lines.append(f"swa    : {swa_out[0].tolist()}")

    # speculative decoding: exactly plain greedy's stream
    spec_out, stats = speculative_generate(
        params, params, prompt, cfg, cfg, max_new_tokens=8, spec_k=4,
        **serve)
    assert torch.equal(spec_out, greedy[:, :8])
    lines.append(f"spec   : {spec_out[0].tolist()} (target calls: "
                 f"{stats['target_calls']} for 8 tokens/row)")

    # continuous batching with a draft: each request's tokens equal its
    # solo stream
    eng = ServeEngine(params, cfg, slots=2, max_len=128,
                      prefill_buckets=(16, 32), draft_params=params,
                      draft_cfg=cfg, spec_k=3, **serve)
    rids = [eng.submit(prompt[0, :n].tolist(), new)
            for n, new in ((9, 6), (16, 8), (12, 5))]
    served = eng.run()
    assert served[rids[1]] == greedy[0, :8].tolist()
    lines.append(f"engine : {len(served)} requests served; "
                 f"req1 {served[rids[1]]}")
    lines.append("done")
    return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="what the ranks compute on (default cuda)")
    args = ap.parse_args(argv)
    from . import serve   # rank_main by its module's name, for the ranks

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        from ..ops import _cuda
        _cuda.build()           # the ranks load the kernels, never build
    if os.environ.get("TPU_KAITO_BOOTSTRAP", "") == "auto":
        lines = run_bootstrapped(serve.rank_main, dev)
    else:
        lines = spawn_ranks(serve.rank_main, WORLD, backend="gloo",
                            device=dev, timeout_s=300, args=(dev.type,))[0]
    if lines is not None:
        print("\n".join(lines))


if __name__ == "__main__":
    main()
