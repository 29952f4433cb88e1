"""Lock-order sanitizer for the serving locks.

Static analysis (rules.LockHoldRule) can see a blocking call inside a
``with device_lock`` body; it cannot see two threads acquiring the
same pair of locks in opposite orders, or a lock held across a slow
device call — both only exist at runtime.  This module wraps the
serving locks in recording proxies:

- every ``acquire`` records the edge (each currently-held lock ->
  newly-acquired lock) in a process-wide acquisition graph keyed by
  lock NAME; acquiring an edge whose reverse has been observed raises
  :class:`LockOrderError` at the acquisition site — the classic
  deadlock is reported deterministically on the FIRST inverted
  acquisition, whether or not the schedule would actually have
  deadlocked this run.  Re-acquiring a lock the same thread already
  holds (threading.Lock self-deadlock) raises too.
- ``release`` checks the hold duration against the sanitizer's
  per-name limits (e.g. ``device_lock`` held longer than a step
  budget).  Violations are recorded in ``sanitizer.violations``
  always, and raised at release when ``raise_on_violation`` — unless
  an exception is already propagating out of the ``with`` block
  (never mask the original error).

Overhead is a dict lookup + list append per acquire under a small
internal mutex — fine for tests and the opt-in ``ptpu serve
--sanitize`` flag, not meant for benchmark runs (the bench keeps it
off by default and says so: benchmarks/bench_serving_load.py).

The port's own copy of
``polyaxon_tpu/analysis/locksan.py`` (host-only code, kept here so
the port imports nothing of the JAX package).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["LockOrderError", "LockHeldTooLongError", "LockSanitizer",
           "SanitizedLock", "LOCK_REGISTRY", "RECEIVER_TYPES"]


# -- the serving lock registry ----------------------------------------
#
# The static analyzer (analysis/lockgraph.py) names a lock by its
# declaring class (``Telemetry._lock`` and ``Replica._lock`` are
# different locks); the runtime sanitizer names a lock by the string
# passed to :meth:`LockSanitizer.wrap`.  This registry is the single
# place the two vocabularies meet: static ``Class.attr`` identities
# that alias the same underlying lock map to one canonical name — the
# wrap name for sanitized locks, so the static graph's edges are
# directly comparable with ``stats()["edges"]``.
#
# The one genuine alias today: ModelServer passes its ``_lock`` into
# DecodeEngine as ``device_lock`` (engine.py takes ``device_lock or
# threading.Lock()``), so acquisitions through either attribute are
# the SAME lock and must share a node or the inversion
# device_lock -> X -> ModelServer._lock would be invisible statically.
LOCK_REGISTRY: Dict[str, str] = {
    "ModelServer._lock": "device_lock",
    "DecodeEngine.device_lock": "device_lock",
    "ModelServer._stats_lock": "_stats_lock",
    "ModelServer._prefix_lock": "_prefix_lock",
}

# Receiver-name conventions the static analyzer uses to type a
# non-``self`` receiver it cannot infer from assignments — e.g. the
# HTTP handler closure's ``ms._stats_lock`` and the legacy
# coalescer's ``self.ms._lock``.  Conventions, not inference: keep the
# list short and only for names used consistently across serving/.
RECEIVER_TYPES: Dict[str, str] = {
    "ms": "ModelServer",
    "sentry": "AnomalySentry",
    "engine": "DecodeEngine",
}


class LockOrderError(RuntimeError):
    """Two locks were acquired in an order whose reverse has also
    been observed — a deadlock waiting for the right schedule."""


class LockHeldTooLongError(RuntimeError):
    """A sanitized lock was held past its configured limit."""


class SanitizedLock:
    """Drop-in ``threading.Lock`` proxy that reports acquire/release
    to its :class:`LockSanitizer` (context manager, ``acquire`` with
    blocking/timeout, ``release``, ``locked``)."""

    def __init__(self, name: str, sanitizer: "LockSanitizer",
                 lock: Optional[threading.Lock] = None):
        self.name = name
        self.san = sanitizer
        self._lock = lock if lock is not None else threading.Lock()

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        self.san._pre_acquire(self.name)
        got = self._lock.acquire(blocking, timeout)
        if got:
            self.san._post_acquire(self.name)
        return got

    def release(self) -> None:
        err = self.san._pre_release(self.name)
        self._lock.release()
        if err is not None and self.san.raise_on_violation:
            raise err

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, exc_type, exc, tb) -> None:
        err = self.san._pre_release(self.name)
        self._lock.release()
        if err is not None and self.san.raise_on_violation \
                and exc_type is None:
            # Never mask an in-flight exception with the sanitizer's.
            raise err

    def __repr__(self) -> str:
        return f"SanitizedLock({self.name!r}, {self._lock!r})"


class LockSanitizer:
    """Process-wide acquisition-graph recorder shared by a set of
    :class:`SanitizedLock` proxies.

    ``max_hold_s`` maps lock NAME -> maximum seconds it may be held
    (omit a name to leave it unbounded; ``device_lock`` is the
    intended customer — a hold longer than one step budget means some
    caller is doing whole-request work under the step lock).
    ``violations`` accumulates (kind, message) tuples whether or not
    ``raise_on_violation`` is set; with ``raise_on_violation=False``
    inversions and long holds are record-only (a server exposing the
    sanitizer in /info reports without crashing traffic).  The one
    exception is same-thread re-acquisition, which raises regardless:
    letting the acquire proceed would REALLY deadlock the thread."""

    def __init__(self, max_hold_s: Optional[Dict[str, float]] = None,
                 raise_on_violation: bool = True):
        self.max_hold_s = dict(max_hold_s or {})
        self.raise_on_violation = bool(raise_on_violation)
        self._mutex = threading.Lock()
        # (held_name, acquired_name) -> True; edges are by NAME, so
        # the graph is tiny and inversion detection is one dict probe
        self._edges: Dict[Tuple[str, str], bool] = {}
        self._tls = threading.local()
        self.violations: List[Tuple[str, str]] = []
        self.acquisitions = 0

    # -- proxy construction --------------------------------------------

    def wrap(self, name: str,
             lock: Optional[threading.Lock] = None) -> SanitizedLock:
        """A sanitized proxy for ``lock`` (or a fresh Lock) under
        ``name`` — names are the graph's nodes, so wrap each distinct
        lock with a distinct name."""
        return SanitizedLock(name, self, lock)

    # -- recording ------------------------------------------------------

    def _held(self) -> List[Tuple[str, float]]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _pre_acquire(self, name: str) -> None:
        held = self._held()
        if any(h == name for h, _ in held):
            # Always raised, even in record-only mode: proceeding
            # would REALLY deadlock this thread on the non-reentrant
            # lock — there is no "observe and continue" option.
            self._note("self-deadlock",
                       f"thread already holds {name!r} and is "
                       f"acquiring it again (threading.Lock is not "
                       f"reentrant)")
            raise LockOrderError(
                f"re-acquiring {name!r} on the same thread")
        inverted = None
        with self._mutex:
            for h, _ in held:
                self._edges[(h, name)] = True
                if (name, h) in self._edges:
                    inverted = h
        if inverted is not None:
            msg = (f"lock-order inversion: this thread holds "
                   f"{inverted!r} while acquiring {name!r}, but the "
                   f"order {name!r} -> {inverted!r} has also been "
                   f"observed — a deadlock under the right schedule")
            self._note("inversion", msg)
            if self.raise_on_violation:
                raise LockOrderError(msg)

    def _post_acquire(self, name: str) -> None:
        self._held().append((name, time.perf_counter()))
        with self._mutex:
            self.acquisitions += 1

    def _pre_release(self, name: str
                     ) -> Optional[LockHeldTooLongError]:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == name:
                _, t0 = held.pop(i)
                break
        else:
            return None       # released by a thread that never
            #                   acquired through the proxy (foreign
            #                   handoff) — nothing to time
        limit = self.max_hold_s.get(name)
        if limit is not None:
            dt = time.perf_counter() - t0
            if dt > limit:
                msg = (f"{name!r} held {dt:.3f}s (limit {limit}s): "
                       f"whole-request work is running under a "
                       f"step-granularity lock")
                self._note("long-hold", msg)
                return LockHeldTooLongError(msg)
        return None

    def _note(self, kind: str, msg: str) -> None:
        with self._mutex:
            self.violations.append((kind, msg))

    # -- introspection --------------------------------------------------

    def stats(self) -> Dict[str, object]:
        with self._mutex:
            return {
                "acquisitions": self.acquisitions,
                "edges": sorted(f"{a}->{b}"
                                for a, b in self._edges),
                "violations": [list(v) for v in self.violations],
            }
