"""Recompile sentinel: makes compile-cache misses a first-class,
observable event.

The serving stack's latency story rests on "one compiled program per
(shape, kind)": every program cache (the server's fused/split LRU,
the engine's prefill programs, the slot pool's step/insert programs)
is supposed to go quiet once traffic has warmed its shapes.  A
recompile STORM — an unbounded key (a raw float in a cache key, a
per-request value leaking into a shape) — shows up only as mysterious
tail latency.  The sentinel counts every hit/miss/eviction per cache
kind, exposes them through ``engine/server`` introspection
(``compile_cache_misses`` in /metrics and /info), and optionally
drops a ``compile_miss`` instant event on the telemetry ENGINE track
so /trace and benchmarks/trace_report.py show exactly WHEN each
compile happened relative to the request timeline.

Tests pin the contract directly: after a warmup pass, re-running the
same-shaped plain/sampled/spec co-tenancy schedules must add ZERO
misses (tests/test_analysis.py).

The port's own copy of
``polyaxon_tpu/analysis/recompile.py`` (host-only code, kept here so
the port imports nothing of the JAX package).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

__all__ = ["RecompileSentinel"]


class RecompileSentinel:
    """Thread-safe hit/miss/eviction counters per cache kind.

    ``telemetry`` is duck-typed (anything with ``.instant``) so this
    module never imports the serving package — the serving package
    imports it."""

    def __init__(self, telemetry=None):
        self._lock = threading.Lock()
        self.telemetry = telemetry
        self.misses = 0
        self.hits = 0
        self.evictions = 0
        self.by_kind: Dict[str, Dict[str, int]] = {}

    def _kind(self, kind: str) -> Dict[str, int]:
        d = self.by_kind.get(kind)
        if d is None:
            d = self.by_kind[kind] = {"misses": 0, "hits": 0,
                                      "evictions": 0}
        return d

    def hit(self, kind: str, key=None) -> None:
        with self._lock:
            self.hits += 1
            self._kind(kind)["hits"] += 1

    def miss(self, kind: str, key=None) -> None:
        with self._lock:
            self.misses += 1
            self._kind(kind)["misses"] += 1
        tel = self.telemetry
        if tel is not None:
            # ENGINE track (pid 2, serving/telemetry.py): compiles
            # interleave visually with the step timeline in /trace.
            tel.instant(0, "compile_miss", time.perf_counter(),
                        pid=2, kind=kind,
                        **({"key": repr(key)[:120]}
                           if key is not None else {}))

    def evicted(self, kind: str, key=None) -> None:
        """An LRU pushed a compiled program out — the NEXT use of its
        shape is a guaranteed miss.  Eviction churn with a steady miss
        count means the cache cap is too small for the live shape
        set."""
        with self._lock:
            self.evictions += 1
            self._kind(kind)["evictions"] += 1

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "compile_cache_misses": self.misses,
                "compile_cache_hits": self.hits,
                "compile_cache_evictions": self.evictions,
                "compile_cache_by_kind":
                    {k: dict(v) for k, v in self.by_kind.items()},
            }
