"""The port's engine registry (observability/fleet.py) and the engine's
registration, against the JAX package's, on the CPU.

Twin of tests/test_fleet.py:230: weak values, default and replaced names,
``engine_stats``; then what the port adds: a ``ServeEngine`` (``tiny``,
CPU) registers itself at construction, its ``stats()`` counts what it
emitted, and a port engine registered into the JAX ``register_engine``
fills the JAX ``tpu_provisioner_engine_*`` gauges through
``update_runtime_gauges`` with its own ``stats()``.
"""

import gc

import pytest
import torch

from gpu_provisioner_tpu.controllers import metrics as jmetrics
from gpu_provisioner_tpu.observability import fleet as jfleet
from gpu_provisioner_tpu_torch.models import engine as te
from gpu_provisioner_tpu_torch.models import llama as tl
from gpu_provisioner_tpu_torch.observability import fleet

CFG = tl.PRESETS["tiny"]
KEYS = {"slots", "slots_active", "queue_depth", "requests_submitted",
        "requests_finished", "tokens_emitted", "prefix_cache_entries",
        "prefix_cache_hits", "prefix_cache_misses"}


class FakeEngine:
    def __init__(self, depth=5):
        self.depth = depth

    def stats(self):
        return {"slots": 8, "slots_active": 3, "queue_depth": self.depth,
                "requests_submitted": 40, "requests_finished": 37,
                "tokens_emitted": 1234, "prefix_cache_entries": 7,
                "prefix_cache_hits": 20, "prefix_cache_misses": 4}


@pytest.fixture(autouse=True)
def _empty_registry():
    fleet.ENGINES.clear()
    yield
    fleet.ENGINES.clear()


def _engine():
    params = tl.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    return te.ServeEngine(params, CFG, slots=2, max_len=64,
                          prefill_buckets=(8, 16), device="cpu")


def test_registry_is_weak_and_names_engines():
    eng = FakeEngine()
    assert fleet.register_engine(eng, name="unit-engine") == "unit-engine"
    assert fleet.engine_stats()["unit-engine"]["queue_depth"] == 5
    other = FakeEngine(depth=9)
    assert fleet.register_engine(other) == "engine-1"
    assert fleet.register_engine(other, name="unit-engine") == "unit-engine"
    assert fleet.engine_stats()["unit-engine"]["queue_depth"] == 9
    # a collected engine drops out of the scrape instead of freezing its
    # last values behind a dead name
    del eng, other
    gc.collect()
    assert fleet.engine_stats() == {}
    assert "unit-engine" not in fleet.ENGINES


def test_serve_engine_registers_at_construction():
    eng = _engine()
    names = [n for n, e in fleet.ENGINES.items() if e is eng]
    assert names == ["engine-0"]
    prompt = torch.randint(1, CFG.vocab_size, (12,),
                           generator=torch.Generator().manual_seed(1))
    ids = [eng.submit(prompt[:n].tolist(), new) for n, new in ((5, 3),
                                                              (12, 4))]
    out = eng.run()
    stats = fleet.engine_stats()["engine-0"]
    assert stats.keys() == KEYS
    assert stats["tokens_emitted"] == sum(len(out[i]) for i in ids) == 7
    assert stats["requests_finished"] == 2 and stats["slots_active"] == 0
    del eng
    gc.collect()
    assert "engine-0" not in fleet.ENGINES


def test_port_engine_fills_the_jax_gauges():
    eng = _engine()
    eng.submit([3, 4, 5], 2)
    eng.run()
    eng.submit([6, 7], 2)                   # one queued request
    name = jfleet.register_engine(eng, name="torch-engine")
    try:
        jmetrics.update_runtime_gauges(object())   # registry sampling only
        st = eng.stats()
        assert jmetrics.ENGINE_QUEUE_DEPTH.labels(
            name)._value.get() == st["queue_depth"] == 1
        assert jmetrics.ENGINE_SLOTS.labels(
            name, "total")._value.get() == st["slots"] == 2
        assert jmetrics.ENGINE_TOKENS_EMITTED.labels(
            name)._value.get() == st["tokens_emitted"] == 2
        assert jmetrics.ENGINE_REQUESTS.labels(
            name, "submitted")._value.get() == 2
        assert jmetrics.ENGINE_PREFIX_CACHE.labels(
            name, "misses")._value.get() == st["prefix_cache_misses"]
    finally:
        jfleet.ENGINES.pop(name, None)
