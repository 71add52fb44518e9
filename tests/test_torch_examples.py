"""The port's workload example and training bench twins, on the CPU.

Twin of tests/test_examples.py:79 (the train → checkpoint → resume example,
in a subprocess; its resume onto another mesh waits for the multi-GPU
slice), and the ``bench_train_step`` and ``bench_workload`` twins of the
JAX package's bench.py at ``tiny``: their keys, their counts, and the
model FLOPs of a step equal to the JAX section's ``_train_flops`` at
Llama-1B's full size (its params counted by a shape-only init).
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import torch

from gpu_provisioner_tpu.models import llama as jl
from gpu_provisioner_tpu_torch import bench as tbench
from gpu_provisioner_tpu_torch.models import llama as tl

ROOT = Path(__file__).resolve().parent.parent
TINY = tl.PRESETS["tiny"]


def test_train_resume_example_runs():
    """The example trains, checkpoints at step 3, is preempted, resumes
    from the checkpoint and finishes."""
    env = {**os.environ,
           "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get(
               "PYTHONPATH", "")}
    r = subprocess.run(
        [sys.executable, "-m", "gpu_provisioner_tpu_torch.examples."
         "train_resume", "--device", "cpu"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    out = r.stdout
    assert "checkpointed at step 3" in out and "resuming on device" in out
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
