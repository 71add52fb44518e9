"""The port's workload examples and bench twins, on the CPU.

Twins of tests/test_examples.py:79 (the train → checkpoint → resume example
on a world of two gloo ranks, resumed onto a tp=2 mesh, in a subprocess)
and :69 (the serving example on a tp=2 world of two gloo ranks, in a
subprocess), and the ``bench_train_step`` and ``bench_workload`` twins of
the JAX package's bench.py at ``tiny``: their keys, their counts, and the
model FLOPs of a step equal to the JAX section's ``_train_flops`` at
Llama-1B's full size (its params counted by a shape-only init); and the
serving twins (``bench_decode``, ``bench_moe_decode``, ``bench_engine``,
``bench_cached_prefill``) at shrunken shapes: the JAX sections' keys
(bench.py:392-416, :511-513, :648-661, :794-801), and the engine's tokens
the request mix's total.
"""

import ast
import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from gpu_provisioner_tpu.models import llama as jl
from gpu_provisioner_tpu_torch import bench as tbench
from gpu_provisioner_tpu_torch.models import llama as tl
from gpu_provisioner_tpu_torch.models import moe as tm

ROOT = Path(__file__).resolve().parent.parent
TINY = tl.PRESETS["tiny"]


def _run_example(name):
    env = {**os.environ,
           "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get(
               "PYTHONPATH", "")}
    return subprocess.run(
        [sys.executable, "-m", f"gpu_provisioner_tpu_torch.examples.{name}",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)


def test_serve_example_runs():
    """The serving example (a tp=2 world, sampled generation, the
    multi-turn cache continuation, MoE, speculation, the engine) runs end
    to end on the CPU."""
    r = _run_example("serve")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "sampled:" in r.stdout and "done" in r.stdout
    assert "multi-turn cache length: 34" in r.stdout
    assert "'model': 2" in r.stdout.splitlines()[0]


def test_train_resume_example_runs():
    """The example trains at dp 2 over a world of two gloo ranks,
    checkpoints at step 3, is preempted, resumes from the checkpoint on a
    tp=2 mesh (the restore reshards) and finishes."""
    r = _run_example("train_resume")
    assert r.returncode == 0, r.stdout + r.stderr
    out = r.stdout
    assert "'data': 2" in out.splitlines()[0]
    resumed = next(x for x in out.splitlines()
                   if x.startswith("resuming on mesh"))
    assert "'model': 2" in resumed and "'data': 1" in resumed
    assert "checkpointed at step 3" in out
    assert "step 6 (resumed)" in out and out.rstrip().endswith("done")
    assert "step 4:" not in out          # preempted right after step 3


def test_bench_train_step_twin_at_tiny():
    cfg = dataclasses.replace(TINY, attn_impl="flash", remat=True)
    res = tbench.bench_train_step(True, "cpu", cfg=cfg, shape=(2, 64))
    assert set(res) == {"platform", "batch", "seq_len", "step_ms",
                        "tokens_per_s", "flops", "mfu"}
    assert res["platform"] == "cpu" and res["mfu"] is None
    assert (res["batch"], res["seq_len"]) == (2, 64)
    assert res["step_ms"] > 0
    assert res["tokens_per_s"] == 2 * 64 / res["step_ms"] * 1e3


def test_bench_workload_twin_at_tiny():
    res = tbench.bench_workload(True, "cpu", cfg=TINY, shape=(2, 32))
    assert set(res) == {"platform", "tokens_per_s", "step_ms"}
    assert res["platform"] == "cpu" and res["step_ms"] > 0
    assert res["tokens_per_s"] == 2 * 32 / res["step_ms"] * 1e3


def test_train_flops_equal_the_jax_sections():
    """Model FLOPs of bench_train_step's full-size step (Llama-1B, B=8,
    S=2048) equal to the JAX bench.py's _train_flops on the same shapes."""
    spec = importlib.util.spec_from_file_location("jax_bench",
                                                  ROOT / "bench.py")
    jbench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jbench)
    tcfg = tbench.train_step_config(False)
    jcfg = jl.LlamaConfig(**{f.name: getattr(tcfg, f.name)
                             for f in dataclasses.fields(jl.LlamaConfig)})
    shapes = jax.eval_shape(lambda: jl.init_params(jax.random.key(0), jcfg))
    params = tl.init_params(tcfg, None, "meta", dtype=torch.float32)
    B, S = tbench.TRAIN_STEP_SHAPE[False]
    want = jbench._train_flops(shapes, jcfg, B, S)
    assert tbench._train_flops(params, tcfg, B, S) == want
    assert 9.2e13 < want < 9.3e13


def test_fast_train_step_model_is_the_jax_sections():
    """bench_train_step's fast model is the JAX section's (bench.py: the
    first LlamaConfig of bench_train_step, read by ast: 8/4 heads of 64,
    which every port kernel takes), flash and remat, with the same model
    FLOPs at the fast shape."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "bench_train_step")
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "LlamaConfig")
    want = {k.arg: ast.literal_eval(k.value) for k in call.keywords
            if k.arg not in ("attn_impl",)}
    tcfg = tbench.train_step_config(True)
    assert {k: getattr(tcfg, k) for k in want} == want
    assert (tcfg.head_dim, tcfg.attn_impl, tcfg.remat) == (64, "flash", True)
    spec = importlib.util.spec_from_file_location("jax_bench",
                                                  ROOT / "bench.py")
    jbench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jbench)
    jcfg = jl.LlamaConfig(**{f.name: getattr(tcfg, f.name)
                             for f in dataclasses.fields(jl.LlamaConfig)})
    shapes = jax.eval_shape(lambda: jl.init_params(jax.random.key(0), jcfg))
    params = tl.init_params(tcfg, None, "meta", dtype=torch.float32)
    B, S = tbench.TRAIN_STEP_SHAPE[True]
    assert (B, S) == (4, 512)
    assert tbench._train_flops(params, tcfg, B, S) == \
        jbench._train_flops(shapes, jcfg, B, S)


DECODE_KEYS = {"batch", "prompt_len", "new_tokens", "total_ms",
               "decode_tokens_per_s", "sampled_total_ms",
               "decode_tokens_per_s_sampled"}


def test_bench_decode_twin_at_tiny():
    res = tbench.bench_decode(True, "cpu", cfg=TINY, shape=(2, 16, 4),
                              budget=64)
    budget = {f"budget64_{impl}_{k}" for impl in ("flash", "dense")
              for k in ("total_ms", "tokens_per_s")}
    assert set(res) == DECODE_KEYS | budget
    assert (res["batch"], res["prompt_len"], res["new_tokens"]) == (2, 16, 4)
    assert res["decode_tokens_per_s"] == 2 * 4 / res["total_ms"] * 1e3
    assert all(res[k] > 0 for k in budget)


def test_bench_moe_decode_twin_at_tiny():
    res = tbench.bench_moe_decode(True, "cpu",
                                  cfg=tm.PRESETS_MOE["tiny-moe"],
                                  shape=(2, 16, 4))
    assert set(res) == {"batch", "prompt_len", "new_tokens", "n_experts",
                        "total_ms", "decode_tokens_per_s"}
    assert res["n_experts"] == 4 and res["total_ms"] > 0


def test_bench_engine_twin_at_tiny():
    """The engine's tokens are the request mix's total (8, 16, 24 new at
    the fast size), as are the self-draft engine's."""
    res = tbench.bench_engine(True, "cpu", cfg=TINY, shape=(2, 512, 3),
                              prefix_len=64)
    assert set(res) == {
        "requests", "slots", "engine_tokens", "engine_ms",
        "engine_tokens_per_s", "static_ms", "static_tokens_per_s",
        "speedup_vs_static", "spec_engine_selfdraft_ms",
        "spec_engine_selfdraft_tokens_per_s", "spec_selfdraft_cost_ratio",
        "prefix_len", "prefix_cached_ms", "prefix_uncached_ms",
        "prefix_cache_speedup"}
    assert res["engine_tokens"] == 8 + 16 + 24
    assert (res["spec_engine_selfdraft_tokens_per_s"]
            * res["spec_engine_selfdraft_ms"] / 1e3
            == pytest.approx(res["engine_tokens"]))
    assert (res["requests"], res["slots"], res["prefix_len"]) == (3, 2, 64)


def test_bench_cached_prefill_twin_at_a_small_shape():
    res = tbench.bench_cached_prefill(True, "cpu",
                                      shape=(1, 128, 512, 4, 2, 16))
    keys = {"start", "flash_ms", "dense_ms", "flash_speedup"}
    assert set(res) == {"new_tokens", "cache_len"} | keys | {
        "small_prefix_" + k for k in keys}
    assert (res["start"], res["small_prefix_start"]) == (256, 32)
    with pytest.raises(ValueError, match="does not tile"):
        tbench.bench_cached_prefill(True, "cpu", shape=(1, 100, 512, 4, 2,
                                                        16))
