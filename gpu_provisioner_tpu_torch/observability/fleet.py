"""The serving-engine registry: engines by name, sampled at scrape time.

Twin of the three engine names of ``gpu_provisioner_tpu/observability/
fleet.py`` (``ENGINES``, ``register_engine``, ``engine_stats``); the rest of
that module (latency digests, SLO burn rates) belongs to the control plane
and is not copied. ``models/engine.py``'s ``ServeEngine`` registers itself
at construction, and a scrape (the control plane's
``update_runtime_gauges``, which reads the ``tpu_provisioner_engine_*``
gauges from each engine's ``stats()``) reads ``engine_stats()``.

Deliberate difference: ``engine_stats`` lets an engine whose ``stats()``
raises fail the read (the reference skips it): the port's engines are
always whole once registered.
"""

from __future__ import annotations

import weakref
from typing import Optional

# Serving engines by name → weakly held engine objects exposing
# ``stats()``: an engine collected with its caller drops out of the scrape
# instead of pinning its params alive.
ENGINES: "weakref.WeakValueDictionary[str, object]" = \
    weakref.WeakValueDictionary()


def register_engine(engine, name: Optional[str] = None) -> str:
    """Register a serving engine's ``stats()`` under ``name`` (default
    ``engine-N`` in registration order). Reusing a name replaces the
    previous engine: restart semantics, not an error."""
    if name is None:
        name = f"engine-{len(ENGINES)}"
    ENGINES[name] = engine
    return name


def engine_stats() -> dict[str, dict]:
    """Every live engine's counters, by name."""
    return {name: eng.stats() for name, eng in list(ENGINES.items())}
