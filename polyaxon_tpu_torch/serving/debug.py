"""Request-scoped debuggability: IDs, causal timelines, live engine
introspection, and the stall watchdog.

The telemetry layer (telemetry.py) and the flight recorder
(profiling.py) answer AGGREGATE questions — histograms, trace rings,
device-time shares.  A production incident asks two different ones:
"what happened to THIS request" and "why is the engine making no
progress right now".  This module is that layer:

- **Request IDs** — every request gets one (the server honors an
  inbound ``X-Request-Id``, else :func:`new_request_id` makes one),
  echoed on EVERY response (success and 4xx/5xx), stamped into the
  access log, every trace-ring span the request emits, the
  ``timings`` block, and the request-history record below.  The ID is
  the correlation key the future multi-replica router tier
  (ROADMAP 3) needs to exist BEFORE it can be debugged.

- :class:`RequestHistory` — a bounded retention ring of terminal
  (completed/failed/shed/cancelled/expired) request records, separate
  from the event trace ring and with its own capacity knob
  (``--request-history``).  Each record is the request's CAUSAL
  timeline: queue wait by class, the admission slot, per-chunk
  prefill, every preemption with the PREEMPTOR's request ID and the
  control-law reason, page-block waits and what unblocked them,
  prefix-cache hit provenance, spec acceptance, and the terminal
  cause.  Served by ``GET /requests/<id>`` and ``GET /requests``.

- :class:`SnapshotBoard` — the ``GET /debug/state`` consistency
  mechanism: the engine builds a host-side snapshot of its internals
  at each step BOUNDARY (slot table, per-class queues with entry
  ages, page pool, lifecycle flags) and publishes it here under
  ``_state_lock``; handlers serve the latest published snapshot plus
  its age.  The contract (docs/DESIGN.md): snapshot construction and
  serving NEVER acquire the device lock — machine-checked by the
  SNAPSHOT-LOCK rule (analysis/rules.py).

- :class:`StallWatchdog` — a monitor thread that declares a STALL
  when work exists (residents or queued streams) but no step boundary
  completes for ``--stall-timeout`` seconds, or a queued request's
  age exceeds ``queue_factor`` times its class queue deadline.  On
  the first detection of an episode it writes a one-shot DIAGNOSTIC
  BUNDLE to disk — forced state snapshot + the trace ring's tail +
  every thread's Python stack (:func:`dump_thread_stacks`) — and
  bumps ``ptpu_serving_stalls_total``: the artifact that turns
  "engine wedged, restart and lose the evidence" into a bug report
  attachment.  It re-arms itself once boundaries resume.

The port's own copy of
``polyaxon_tpu/serving/debug.py`` (host-only code, kept here so
the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import os
import re
import sys
import threading
import time
import traceback
import uuid
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["new_request_id", "sanitize_request_id",
           "format_replica_rid", "parse_replica_rid",
           "RequestHistory", "SnapshotBoard", "StallWatchdog",
           "dump_thread_stacks", "events_to_dicts"]

# Inbound X-Request-Id values are used as log fields, JSON keys, and
# file-name-adjacent strings — constrain them to a sane charset and
# length; anything else gets a generated ID instead (a malformed
# header must not break correlation for everyone else).
_RID_RE = re.compile(r"^[A-Za-z0-9._:\-]{1,128}$")


def new_request_id() -> str:
    """A fresh request ID: 16 hex chars of uuid4 — short enough for
    log lines, collision-safe at any single-replica rate (and the
    router tier will prefix replica IDs, not rely on global
    uniqueness)."""
    return uuid.uuid4().hex[:16]


def sanitize_request_id(raw: Optional[str]) -> Optional[str]:
    """The inbound ``X-Request-Id`` if it is usable, else None (the
    caller generates).  Never raises: a hostile header downgrades to
    a generated ID, not a 500."""
    if not raw or not isinstance(raw, str):
        return None
    raw = raw.strip()
    return raw if _RID_RE.match(raw) else None


# The replica-id prefix the router stamps on forwarded request IDs:
# ``r<N>-<rid>``.  One parse/format pair here instead of string
# splicing at the call sites — the router's forwarding headers, the
# /fleet/requests stitcher, and trace_report.py all have to agree on
# this convention or cross-tier correlation silently breaks.
_REPLICA_RID_RE = re.compile(r"^(r\d+)-(.+)$")


def format_replica_rid(replica_id: str, rid: str) -> str:
    """The request ID forwarded REPLICA-ward for one (request,
    replica) leg: ``r0-<rid>``, length-capped to the same 128-char
    bound :data:`_RID_RE` enforces inbound (a router must never mint
    an ID a replica would reject and regenerate — that breaks the
    correlation the prefix exists for)."""
    return f"{replica_id}-{rid}"[:128]


def parse_replica_rid(prefixed: str):
    """``(replica_id, rid)`` for a router-prefixed request ID, or
    ``(None, prefixed)`` when the ID carries no replica prefix (a
    request that reached the replica directly).  The inverse of
    :func:`format_replica_rid` for well-formed prefixes; never
    raises."""
    if not isinstance(prefixed, str):
        return None, prefixed
    m = _REPLICA_RID_RE.match(prefixed)
    if m is None:
        return None, prefixed
    return m.group(1), m.group(2)


def events_to_dicts(events, t0: float) -> List[Dict[str, Any]]:
    """Render (name, t_start, t_end, args) span tuples as record
    entries: start/duration in ms relative to request submission —
    the same shape as the response ``timings`` block, so a record's
    timeline and a live ``timings`` response read identically."""
    out = []
    for name, a, b, args in events:
        ev = {"name": name,
              "start_ms": round(1e3 * (a - t0), 3),
              "dur_ms": round(1e3 * (b - a), 3)}
        if args:
            ev["args"] = args
        out.append(ev)
    return out


class RequestHistory:
    """Bounded ring of terminal request records, keyed by request ID.

    ``record`` REPLACES an existing record with the same ID (the
    engine's full causal record supersedes a front-end give-up's
    minimal one; a client reusing an ID sees its latest request).
    All methods are thread-safe; records are plain JSON-able dicts.
    ``capacity == 0`` disables recording entirely — ``record`` is one
    attribute check, the same off-switch contract as the trace ring.
    """

    def __init__(self, capacity: int = 256):
        capacity = int(capacity)
        if capacity < 0:
            raise ValueError(
                f"request_history must be >= 0; got {capacity}")
        self.enabled = capacity > 0
        self.capacity = capacity
        self._ring: "deque[Dict[str, Any]]" = deque(
            maxlen=max(1, capacity))
        self._lock = threading.Lock()
        self.recorded_total = 0
        self.evicted_total = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def record(self, rec: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        rid = rec.get("request_id")
        with self._lock:
            if rid is not None:
                for i, old in enumerate(self._ring):
                    if old.get("request_id") == rid:
                        del self._ring[i]
                        break
            if len(self._ring) == self._ring.maxlen:
                self.evicted_total += 1
            self._ring.append(rec)
            self.recorded_total += 1

    def record_front(self, rec: Dict[str, Any]) -> None:
        """Insert a FRONT-END record only when no record exists for
        this ID yet: the engine's full causal record must never be
        clobbered by the handler's minimal status line (the reverse —
        a later engine record replacing a minimal front-end one via
        :meth:`record` — is the intended supersede)."""
        if not self.enabled:
            return
        rid = rec.get("request_id")
        # Check and insert under ONE lock hold: releasing between the
        # existence check and a record() call would let an engine
        # record land in the gap and be clobbered by this minimal one
        # (engine terminal paths wake the waiter BEFORE recording, so
        # the handler genuinely races us here).
        with self._lock:
            if rid is not None and any(
                    old.get("request_id") == rid
                    for old in self._ring):
                return
            if len(self._ring) == self._ring.maxlen:
                self.evicted_total += 1
            self._ring.append(rec)
            self.recorded_total += 1

    def get(self, rid: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            for rec in reversed(self._ring):
                if rec.get("request_id") == rid:
                    return dict(rec)
        return None

    def list(self, status: Optional[str] = None,
             limit: int = 100) -> List[Dict[str, Any]]:
        """Newest-first summaries (the full record stays behind
        ``GET /requests/<id>`` — a list response must stay small)."""
        out = []
        if limit <= 0:
            return out
        with self._lock:
            records = list(self._ring)
        for rec in reversed(records):
            if status is not None and rec.get("status") != status:
                continue
            out.append({k: rec.get(k) for k in (
                "request_id", "status", "kind", "priority", "rows",
                "path", "wall_s", "queue_wait_s", "ttft_s",
                "preempts", "resumes", "error", "t")
                if k in rec})
            if len(out) >= limit:
                break
        return out

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"request_history": self.capacity,
                    "request_records": len(self._ring),
                    "request_records_total": self.recorded_total,
                    "request_records_evicted": self.evicted_total}


class SnapshotBoard:
    """The published engine-state snapshot behind ``GET /debug/state``.

    The engine BUILDS a snapshot at each step boundary (on its own
    thread, outside the device lock) and publishes it here; readers
    get the latest copy plus its age.  ``_state_lock`` guards only
    the reference swap/copy — by the SNAPSHOT-LOCK contract nothing
    under it may acquire the device lock, so a wedged device call can
    never make ``/debug/state`` hang."""

    def __init__(self):
        self._state_lock = threading.Lock()
        self._snapshot: Optional[Dict[str, Any]] = None

    def publish(self, snap: Dict[str, Any]) -> None:
        with self._state_lock:
            self._snapshot = snap

    def latest(self) -> Optional[Dict[str, Any]]:
        with self._state_lock:
            snap = self._snapshot
            return dict(snap) if snap is not None else None


def dump_thread_stacks() -> Dict[str, List[str]]:
    """Every live thread's Python stack, faulthandler-style but
    JSON-able: ``{"<thread name>:<ident>": [frame lines...]}``.  Pure
    stdlib introspection — safe to call from the watchdog while the
    engine thread is wedged inside a device call (the wedged frame is
    exactly the evidence the bundle exists to capture)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for tid, frame in sys._current_frames().items():
        label = f"{names.get(tid, 'unknown')}:{tid}"
        out[label] = [ln.rstrip("\n") for ln in
                      traceback.format_stack(frame)]
    return out


class StallWatchdog(threading.Thread):
    """Declare engine stalls and dump the evidence before a restart
    destroys it.

    Stall condition (checked every ``poll_s``): work exists —
    resident slots or queued streams — and

    - no step boundary completed for ``timeout_s``
      (``engine.last_boundary_t`` stale: the host-bound / wedged-
      device signature of arXiv:2011.03641), or
    - a queued stream's age exceeds ``queue_factor`` x its class
      queue deadline (the sweep should have shed it long ago — if it
      is still queued, the sweep itself is not running).

    First detection of an episode writes ONE diagnostic bundle
    (``stall_<n>.json`` under ``out_dir``): stall metadata, a FORCED
    state snapshot (built on this thread — best effort, labeled
    ``forced``), the last ``trace_tail`` trace events, and every
    thread's stack.  The episode re-arms when a boundary completes
    after the firing, so a recovered engine that stalls again gets a
    fresh bundle.  The watchdog never touches the device lock and
    never raises out of its loop."""

    def __init__(self, engine, telemetry, *, timeout_s: float,
                 out_dir: str = ".", queue_factor: float = 4.0,
                 trace_tail: int = 512,
                 poll_s: Optional[float] = None,
                 extra_state=None):
        if timeout_s <= 0:
            raise ValueError(
                f"stall_timeout_s must be > 0; got {timeout_s}")
        super().__init__(name="stall-watchdog", daemon=True)
        self.engine = engine
        self.telemetry = telemetry
        self.timeout_s = float(timeout_s)
        self.out_dir = out_dir
        self.queue_factor = float(queue_factor)
        self.trace_tail = int(trace_tail)
        self.poll_s = poll_s if poll_s is not None \
            else max(0.02, self.timeout_s / 4.0)
        # Server-level state (draining flag, history stats, sanitizer
        # graph) folded into the bundle's snapshot: a zero-arg
        # callable so the watchdog needs no back-reference to the
        # server.
        self.extra_state = extra_state
        self.stalls_total = 0
        self.last_stall: Optional[Dict[str, Any]] = None
        # NOT ``_stop``: Thread.join() calls its private _stop()
        # internally, and shadowing it with an Event breaks join.
        self._stopped = threading.Event()
        # Armed = no bundle fired for the CURRENT episode; an episode
        # ends (and re-arms the next) when last_boundary_t advances
        # past the boundary observed at firing time.
        self._fired_boundary: Optional[float] = None
        # queue_age episodes are keyed per REQUEST, not per boundary:
        # a healthy-stepping engine advances the boundary every tick,
        # which would re-arm and re-fire the same ancient request on
        # every poll — one bundle per offending rid instead.
        self._fired_queue_rids: set = set()

    def close(self) -> None:
        self._stopped.set()

    def run(self) -> None:
        while not self._stopped.wait(self.poll_s):
            try:
                self.check()
            except Exception:
                # The watchdog is last-resort diagnostics: it must
                # never take the server down, but a broken check
                # should be visible in debug logs.
                import logging

                logging.getLogger(__name__).debug(
                    "stall watchdog check failed", exc_info=True)

    # -- detection -------------------------------------------------------

    def check(self) -> Optional[str]:
        """One detection pass; returns the bundle path when a stall
        fired (tests drive this directly, without the thread)."""
        eng = self.engine
        boundary = eng.last_boundary_t
        if self._fired_boundary is not None:
            if boundary > self._fired_boundary:
                self._fired_boundary = None     # progress: re-arm
            else:
                return None                     # one-shot per episode
        now = time.perf_counter()
        stale_s = now - boundary
        busy = bool(eng._resident) or len(eng.queue) > 0
        reason = None
        detail: Dict[str, Any] = {}
        if busy and stale_s > self.timeout_s:
            reason = "no_step_boundary"
            detail = {"stale_s": round(stale_s, 3),
                      "timeout_s": self.timeout_s}
        else:
            pol = eng.policy
            if pol.queue_deadline_s is not None \
                    or pol.batch_queue_deadline_s is not None:
                queued_rids = set()
                for s in eng.queue.snapshot():
                    queued_rids.add(s.group.rid)
                    qd = pol.class_queue_deadline(s.group.priority)
                    if qd is None:
                        continue
                    age = now - s.group.t_submit
                    if age > self.queue_factor * qd \
                            and s.group.rid \
                            not in self._fired_queue_rids:
                        reason = "queue_age"
                        detail = {
                            "request_id": s.group.rid,
                            "priority": s.group.priority,
                            "age_s": round(age, 3),
                            "class_deadline_s": qd,
                            "factor": self.queue_factor}
                        self._fired_queue_rids.add(s.group.rid)
                        break
                else:
                    # Complete scan, nothing fired: drop fired rids
                    # that left the queue, so the set stays bounded
                    # by queue depth (a partial scan after a fire
                    # must not prune rids it never reached).
                    self._fired_queue_rids &= queued_rids
        if reason is None:
            return None
        return self._fire(reason, detail, boundary)

    # -- the bundle ------------------------------------------------------

    def _fire(self, reason: str, detail: Dict[str, Any],
              boundary: float) -> Optional[str]:
        self._fired_boundary = boundary
        self.stalls_total += 1
        stall = {"reason": reason, **detail,
                 "t": round(time.time(), 3),
                 "stalls_total": self.stalls_total}
        self.last_stall = stall
        bundle = self.build_bundle(stall)
        path = None
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            path = os.path.join(
                self.out_dir,
                f"stall_{self.stalls_total}_{os.getpid()}.json")
            with open(path, "w") as f:
                json.dump(bundle, f, indent=1, default=str)
        except Exception:
            # A read-only disk must not kill the watchdog — the
            # in-memory last_stall and the counter still tell the
            # operator a stall happened.
            import logging

            logging.getLogger(__name__).warning(
                "stall bundle write failed (stall still counted)",
                exc_info=True)
        stall["bundle"] = path
        if self.telemetry is not None:
            from .telemetry import ENGINE_PID

            self.telemetry.instant(
                0, "stall", time.perf_counter(), pid=ENGINE_PID,
                reason=reason, **({"bundle": path} if path else {}))
        print(f"# serving: STALL detected ({reason}) — diagnostic "
              f"bundle: {path or 'WRITE FAILED'}", file=sys.stderr)
        return path

    def build_bundle(self, stall: Dict[str, Any]) -> Dict[str, Any]:
        """The diagnostic bundle dict (also the loadable on-disk
        shape).  Built entirely host-side: forced snapshot, trace
        tail, thread stacks — never the device lock."""
        try:
            state = self.engine.build_debug_snapshot(forced=True)
        except Exception as e:
            # A wedged engine's host structures can be mid-mutation;
            # a partial bundle beats none.
            state = {"error": f"{type(e).__name__}: {e}"}
        if self.extra_state is not None:
            try:
                state["server"] = self.extra_state()
            except Exception as e:
                state["server"] = {
                    "error": f"{type(e).__name__}: {e}"}
        events = []
        if self.telemetry is not None:
            events = self.telemetry.events()[-self.trace_tail:]
        return {"stall": stall,
                "state": state,
                "trace_tail": events,
                "threads": dump_thread_stacks()}

    def status(self) -> Dict[str, Any]:
        return {"armed": True, "timeout_s": self.timeout_s,
                "queue_factor": self.queue_factor,
                "dir": self.out_dir,
                "stalls_total": self.stalls_total,
                **({"last_stall": self.last_stall}
                   if self.last_stall is not None else {})}
