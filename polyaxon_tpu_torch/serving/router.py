"""Replica router tier: fleet-grade fault tolerance in front of N
``ModelServer`` replicas.

The engine is crash-only (supervised restart, requeue-and-resume,
circuit breaker) — but one process is still a single point of
failure: kill the server and every caller is stranded.  This module
is the robustness half of the serving fleet, in the
Podracer decoupled-dataflow mold (arXiv:2104.06272): a front tier
that treats replica death, slowness, and drain as ROUTINE SCHEDULING
EVENTS, with the co-tenancy tail pathologies of arXiv:2011.03641 as
the failure class the retry/hedging policy must never amplify.

- :class:`Replica` — one routed endpoint (URL in production,
  :class:`LocalReplica` spawns an in-process ``ModelServer`` fleet
  for tests/benches).  Per replica: outstanding-request count, the
  last health verdict, and a ``recovery.CircuitBreaker`` whose
  HALF_OPEN state admits exactly ONE live probe request
  (``try_probe``) before the replica re-enters rotation.
- :class:`ReplicaRouter` — probes ``GET /healthz`` on an interval
  (every probe socket carries an EXPLICIT timeout — the SOCKET-
  TIMEOUT rule: a timeout-less probe is how a hung replica wedges
  the router), parses the unified ``{"status", "reason"}`` schema
  (503 ``draining``/``engine_down`` -> out of rotation, recovery ->
  back in after a half-open success probe), and routes with
  least-outstanding load balancing plus RADIX-PREFIX AFFINITY: a
  request whose prompt extends a prefix registered via the router's
  ``/prefill`` goes to the replica whose radix store already holds
  it — unless that replica is saturated or unhealthy (affinity must
  NEVER beat health).
- FAILOVER, not client retries: a replica that dies mid-request gets
  the request replayed on a healthy replica as ``prompt ++
  tokens_received_so_far`` with ``resume_tokens`` (the cross-replica
  resume contract, docs/DESIGN.md — position-keyed RNG makes the
  resumed tokens bitwise identical per seed), governed by a global
  bounded :class:`RetryBudget` (token bucket: retries+hedges may
  never exceed a fraction of live traffic, so a sick fleet degrades
  to fast 503 ``retry_budget`` instead of a retry storm) with
  jittered backoff from the shared ``recovery.RetryPolicy``.
- HEDGING (optional): a request sitting past the p99 watermark fires
  a duplicate to a second replica; the first winner cancels the
  loser by closing its connection — the replica's client-disconnect
  probe cancels the request at its next step boundary (the engine's
  cancel path), so a hedge never double-spends decode budget to
  completion.
- ROLLING RESTART: ``POST /fleet/restart`` drains one replica at a
  time (``/drain``, wait for in-flight zero, restart, re-admit via
  health probe) and never drops the ready count below
  ``min_ready``.  Requests shed by a drain race retry within budget
  — zero failed requests is the contract.
- FLEET CHAOS: ``fleet_faults`` arms the seeded ``faults.FaultPlan``
  replica sites (``replica_kill`` / ``replica_hang`` /
  ``replica_slow``), polled once per routed request, so a fleet
  chaos run's fire pattern is a pure function of the plan.

Observability rides the existing surfaces: one ``router.stats()``
dict renders into ``GET /metrics`` (``ptpu_router_*`` gauges) and
``GET /info``, and ``X-Request-Id`` is forwarded replica-ward with a
replica-id prefix (``r0-<rid>`` — ``debug.format_replica_rid``) so
one request's history is traceable across a failover.

FLEET OBSERVABILITY (the cross-replica tier):

- Router-side REQUEST SPANS: every routed request leaves a causal
  record in a bounded ``debug.RequestHistory`` ring — the route
  decision (chosen replica + why: affinity / least-outstanding /
  half-open probe), every attempt with its send/receive bracket,
  failover replays with their ``resume_tokens`` count, hedge
  fire/win/cancel, and retry-budget denials.
- ``GET /fleet/requests/<id>`` STITCHES that router timeline with
  every involved replica's own ``GET /requests/<rN-id>`` record into
  ONE causal timeline: per-host monotonic clocks are reconciled by
  anchoring each replica segment at the router's SEND timestamp for
  that attempt and clamping it inside the send/receive bracket (a
  replica event can never appear to precede its own request or
  outlive its response — the causal-consistency pin in
  tests/test_torch_fleet.py).
- ``GET /fleet/metrics`` FEDERATES every replica's ``/metrics``:
  each series re-exported with a ``replica=`` label plus fleet
  rollups (``<name>_fleet{agg="sum"|"min"|"max"}``), so one scrape
  covers the tier.
- SLO BURN RATES: declared objectives (``--slo
  availability=99.9,ttft_p99_ms=1000``) are evaluated over a sliding
  window of the router's OWN accounting and exported as
  ``ptpu_router_slo_burn_rate{objective=}`` — burn 1.0 means the
  error budget is being spent exactly at the sustainable rate,
  burn >> 1 is the page.

The port's own copy of ``polyaxon_tpu/serving/router.py`` (host-only
code over HTTP, kept here so the port imports nothing of the JAX
package); its replicas are the port's ``ModelServer``s.
"""

from __future__ import annotations

import http.client
import json
import logging
import re
import socket
import threading
import time
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from .debug import (RequestHistory, events_to_dicts,
                    format_replica_rid, new_request_id,
                    sanitize_request_id)
from .faults import FLEET_SITES, FaultPlan
from .forensics import ForensicsCore, compute_router_ledger
from .recovery import CircuitBreaker, RetryPolicy
from .telemetry import (LATENCY_BUCKETS, Histogram,
                        parse_prometheus_families, render_histogram)

__all__ = ["Replica", "LocalReplica", "ReplicaRouter", "RetryBudget",
           "SLOTracker", "make_router_server"]

logger = logging.getLogger(__name__)


# Structural no-drift contract (tests/test_torch_fleet.py):
# EVERY key of ReplicaRouter.stats() must render on /metrics under
# ``ptpu_router_<key>``, under a rename listed here, or carry an
# explicit exemption reason — a new router counter that skips the
# /metrics surface fails tier-1 instead of shipping dark.
STATS_METRIC_RENAMES = {
    "request_records_evicted":
        "ptpu_router_request_records_evicted_total",
    "rolling_restart": "ptpu_router_rolling_restart_in_progress",
    "fleet_faults_applied": "ptpu_router_fleet_faults_applied_total",
    # The probe-duration histogram's four stats keys all render
    # through ONE telemetry.render_histogram family.
    "probe_duration_buckets": "ptpu_router_probe_duration_seconds",
    "probe_duration_hist": "ptpu_router_probe_duration_seconds",
    "probe_duration_sum": "ptpu_router_probe_duration_seconds",
    "probe_duration_count": "ptpu_router_probe_duration_seconds",
    # The SLO block renders as the labeled burn-rate/target/violation
    # families.
    "slo": "ptpu_router_slo_burn_rate",
}
STATS_METRIC_EXEMPT = {
    "hedge": "config string; hedge activity rides hedges_*_total",
    "fleet_fault_stats": "plan-internal detail; applied counts "
                         "render via fleet_faults_applied_total",
}


_SLO_PCTL_RE = re.compile(r"^(ttft|latency)_p(\d{1,2}(?:\.\d+)?)_ms$")


class SLOTracker:
    """Declared service objectives evaluated over a sliding window of
    the router's own per-request accounting, exported as error-budget
    BURN RATES.

    Objectives (the ``--slo`` spec, comma-separated ``name=value``):

    - ``availability=99.9`` — at most 0.1% of requests may end 5xx
      (router sheds, deadline 504s, replica failures).  4xx client
      errors are EXCLUDED from the window: a bad request spends no
      error budget.
    - ``ttft_p99_ms=1000`` / ``latency_p99_ms=500`` — at most
      (100-99)=1% of COMPLETED requests may exceed the threshold.
      TTFT is client-visible from the router's vantage: the winning
      attempt's queue/hedge time at the router PLUS the replica's
      admission-anchored TTFT (the router injects ``timings`` into
      the forwarded request to read it; full latency stands in when
      a replica reports none).

    Burn rate = (violation rate over the window) / (error-budget
    rate): 1.0 means the budget is being spent exactly at the
    sustainable rate, 0 means no violations in the window, and a
    multi-window alerting stack pages on sustained burn >> 1 —
    Prometheus-side math the router now makes possible from its OWN
    accounting instead of bench-side reconstruction."""

    def __init__(self, objectives: Dict[str, float],
                 window: int = 512):
        if not objectives:
            raise ValueError("slo needs at least one objective")
        if window < 8:
            raise ValueError(
                f"slo window must be >= 8 requests; got {window}")
        self.objectives: Dict[str, Dict[str, float]] = {}
        for name, target in objectives.items():
            target = float(target)
            if name == "availability":
                if not 0.0 < target < 100.0:
                    raise ValueError(
                        f"availability target must be in (0, 100); "
                        f"got {target}")
                budget = (100.0 - target) / 100.0
                self.objectives[name] = {
                    "target": target, "budget": budget}
                continue
            m = _SLO_PCTL_RE.match(name)
            if m is None:
                raise ValueError(
                    f"unknown SLO objective {name!r} (supported: "
                    f"availability=<pct>, ttft_p<q>_ms=<ms>, "
                    f"latency_p<q>_ms=<ms>)")
            q = float(m.group(2))
            if not 0.0 < q < 100.0 or target <= 0:
                raise ValueError(
                    f"objective {name!r} needs 0 < percentile < 100 "
                    f"and a positive threshold; got {target}")
            self.objectives[name] = {
                "target": target, "metric": m.group(1),
                "budget": (100.0 - q) / 100.0}
        self._lock = threading.Lock()
        self._window: "deque[Dict[str, Any]]" = deque(maxlen=window)
        self.violations_total = {name: 0 for name in self.objectives}

    @staticmethod
    def parse(spec: str) -> Dict[str, float]:
        """``"availability=99.9,ttft_p99_ms=1000"`` -> objective
        dict.  Raises ValueError with the offending piece named."""
        out: Dict[str, float] = {}
        for piece in str(spec).split(","):
            piece = piece.strip()
            if not piece:
                continue
            name, sep, value = piece.partition("=")
            if not sep or not name.strip():
                raise ValueError(
                    f"SLO objective {piece!r} must be name=value")
            try:
                out[name.strip()] = float(value)
            except ValueError:
                raise ValueError(
                    f"SLO objective {piece!r} has a non-numeric "
                    f"target")
        if not out:
            raise ValueError(f"empty SLO spec {spec!r}")
        return out

    def observe(self, code: int, *, ttft_s: Optional[float],
                latency_s: float) -> None:
        """One terminal routed request.  4xx client errors are
        excluded entirely (they spend no budget and count in no
        window)."""
        if 400 <= code < 500:
            return
        ok = code == 200
        obs = {"ok": ok, "ttft": ttft_s if ok else None,
               "latency": latency_s if ok else None}
        with self._lock:
            self._window.append(obs)
            for name, o in self.objectives.items():
                if name == "availability":
                    if not ok:
                        self.violations_total[name] += 1
                else:
                    v = obs[o["metric"]]
                    if v is not None and v > o["target"] / 1e3:
                        self.violations_total[name] += 1

    def burn_rates(self) -> Dict[str, float]:
        with self._lock:
            window = list(self._window)
            out = {}
            for name, o in self.objectives.items():
                if name == "availability":
                    n = len(window)
                    bad = sum(1 for w in window if not w["ok"])
                else:
                    vals = [w[o["metric"]] for w in window
                            if w[o["metric"]] is not None]
                    n = len(vals)
                    bad = sum(1 for v in vals
                              if v > o["target"] / 1e3)
                rate = bad / n if n else 0.0
                out[name] = round(rate / o["budget"], 4)
            return out

    def stats(self) -> Dict[str, Any]:
        burns = self.burn_rates()
        with self._lock:
            n = len(self._window)
            return {
                "window": self._window.maxlen,
                "window_observations": n,
                "objectives": {
                    name: {"target": o["target"],
                           "burn_rate": burns[name],
                           "violations_total":
                               self.violations_total[name]}
                    for name, o in self.objectives.items()},
            }


def _attempt_record(att: "_Attempt", n: int, t0: float, *,
                    hedge: bool = False,
                    resume_n: int = 0) -> Dict[str, Any]:
    """ONE attempt-dict shape for every router record (/generate and
    /prefill paths both) — the stitcher keys on n/replica/send_ms/
    recv_ms, so the two paths must never diverge by hand."""
    def rel(t):
        return round(1e3 * (t - t0), 3) if t is not None else None

    return {
        "n": n,
        "replica": att.replica.id,
        "send_ms": rel(att.t_send),
        "recv_ms": rel(att.t_recv),
        "outcome": att.outcome() if att.done.is_set()
        else "abandoned",
        **({"code": att.code} if att.code is not None else {}),
        **({"hedge": True} if hedge else {}),
        **({"resume_tokens": resume_n} if resume_n else {}),
        **({"cancelled": True} if att.cancelled else {}),
    }


def _terminal_status(code: int) -> str:
    """The router record's terminal-status vocabulary — the SAME one
    the replica history uses (server.record_front's mapping), so
    ``GET /fleet/requests?status=`` filters read identically at both
    tiers."""
    if code == 200:
        return "complete"
    if code in (429, 503):
        return "shed"
    if code == 504:
        return "expired"
    if code == 499:
        return "cancelled"
    return "failed"


class RetryBudget:
    """Global bounded retry budget: a token bucket refilled by LIVE
    traffic.

    Every admitted request deposits ``ratio`` tokens (capped at
    ``burst``); every retry or hedge withdraws one.  The invariant —
    retries can never exceed ``ratio`` x live traffic plus the
    ``burst`` head start — is what keeps a sick fleet from
    amplifying itself into a retry storm (arXiv:2011.03641's
    concurrency-limit pathology applied to the router tier): when
    every replica is failing, the bucket drains and callers get FAST
    503 ``retry_budget`` instead of N x the load.  Counters are the
    pinned evidence (``tests/test_torch_fleet.py``): ``withdrawals +
    denied`` exactly accounts for every retry decision ever made."""

    def __init__(self, ratio: float = 0.1, burst: float = 8.0):
        if ratio < 0:
            raise ValueError(f"retry ratio must be >= 0; got {ratio}")
        if burst < 1:
            raise ValueError(f"retry burst must be >= 1; got {burst}")
        self.ratio = float(ratio)
        self.burst = float(burst)
        self._level = float(burst)     # start full: a cold fleet must
        #                                be able to fail over at once
        self._lock = threading.Lock()
        self.deposits_total = 0.0
        self.withdrawals_total = 0
        self.denied_total = 0

    def on_request(self) -> None:
        """One live request admitted: deposit ``ratio`` tokens."""
        with self._lock:
            self._level = min(self.burst, self._level + self.ratio)
            self.deposits_total += self.ratio

    def try_spend(self) -> bool:
        """Withdraw one token for a retry/hedge; False = budget
        exhausted (the caller sheds fast instead of retrying)."""
        with self._lock:
            if self._level >= 1.0:
                self._level -= 1.0
                self.withdrawals_total += 1
                return True
            self.denied_total += 1
            return False

    def level(self) -> float:
        with self._lock:
            return round(self._level, 3)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"retry_budget_level": round(self._level, 3),
                    "retry_budget_ratio": self.ratio,
                    "retry_budget_burst": self.burst,
                    "retry_budget_spent_total": self.withdrawals_total,
                    "retry_budget_denied_total": self.denied_total}


class Replica:
    """One routed endpoint + its health state.

    The health machine mirrors ``recovery.CircuitBreaker`` semantics
    per replica: transport failures (probe or live) are "crashes";
    ``down_after`` of them inside the breaker window trips the
    replica OUT of rotation; after ``cooldown_s`` a healthy probe
    HALF-OPENs it, and exactly one live request (``breaker.
    try_probe``) — or a second consecutive healthy probe — closes it
    back IN.  A 503 from the replica itself (``reason: draining`` /
    ``engine_down`` — the unified /healthz schema) is an HONEST
    not-ready, tracked separately from crash suspicion: it clears
    the moment the replica answers 200 again, with no cooldown."""

    restartable = False

    def __init__(self, url: str, replica_id: str, *,
                 down_after: int = 2, window_s: float = 30.0,
                 cooldown_s: float = 1.0):
        parsed = urlparse(url if "//" in url else "http://" + url)
        if parsed.scheme not in ("http", ""):
            raise ValueError(
                f"replica URL must be http:// (got {url!r}; the "
                f"stdlib router tier does not speak TLS — put it "
                f"behind your ingress)")
        if not parsed.hostname or not parsed.port:
            raise ValueError(
                f"replica URL needs host:port (got {url!r})")
        self.host = parsed.hostname
        self.port = int(parsed.port)
        self.url = f"http://{self.host}:{self.port}"
        self.id = replica_id
        self.breaker = CircuitBreaker(
            threshold=down_after, window_s=window_s,
            cooldown_s=cooldown_s)
        self.health_ok = True          # optimistic until probed
        self.health_reason: Optional[str] = None
        self.draining = False          # router-side rotation latch
        #                                (rolling restart)
        self.consecutive_probe_failures = 0
        self.last_failure_t: Optional[float] = None
        # Wall time of the most recent /healthz probe (seconds): the
        # per-replica twin of the ptpu_router_probe_duration_seconds
        # histogram, so a slow-but-alive replica is identifiable in
        # rotation before it trips the hedge watermark.
        self.last_probe_s: Optional[float] = None
        # Disaggregated-serving role, learned from the /healthz 200
        # body ("prefill" / "decode" / "both"); optimistic "both"
        # until probed — an unprobed replica must stay routable.
        self.role = "both"
        # Per-link calibration: EWMA of the measured
        # wire throughput serving FROM this replica (completed
        # fetches + handoffs) and of its probe round-trip time.  None
        # until a measurement lands; shipped inside prefix hints so
        # the holder-side cost gate runs on observed link truth.
        self.wire_bytes_per_s: Optional[float] = None
        self.rtt_s: Optional[float] = None
        # Estimated host-clock skew vs the router (seconds, EWMA):
        # replica /healthz wall-clock minus the router's midpoint
        # wall-clock for the probe.  A host-clock ESTIMATE (error
        # bounded by the one-way delay asymmetry), exported as
        # ptpu_fleet_clock_skew_seconds{replica=} and used to flag
        # stitched-timeline segments whose silent skew correction
        # exceeds the suspect threshold.
        self.clock_skew_s: Optional[float] = None
        self.requests_total = 0
        self.failures_total = 0
        self._out_lock = threading.Lock()
        self.outstanding = 0

    # -- roles -----------------------------------------------------------

    def decode_capable(self) -> bool:
        return self.role in ("decode", "both")

    def prefill_capable(self) -> bool:
        return self.role in ("prefill", "both")

    # -- link calibration ------------------------------------------------

    _EWMA_ALPHA = 0.3

    # ptpu: lockfree[advisory EWMA gauge: a lost fold costs one sample of calibration accuracy, never correctness]
    def note_link_sample(self, nbytes: int, wall_s: float) -> None:
        """One completed transfer FROM this replica (wire fetch or
        handoff push): fold its observed bytes/s into the link EWMA.
        Tiny payloads are RTT-dominated and would drag the throughput
        estimate toward zero, so they only seed, never update."""
        if wall_s <= 0 or nbytes <= 0:
            return
        bps = nbytes / wall_s
        if self.wire_bytes_per_s is None:
            self.wire_bytes_per_s = bps
        elif nbytes >= 4096:
            a = self._EWMA_ALPHA
            self.wire_bytes_per_s = \
                a * bps + (1 - a) * self.wire_bytes_per_s

    def note_rtt_sample(self, rtt_s: float) -> None:
        """One probe round trip: the link RTT EWMA (the /healthz
        body is tiny, so probe wall time ~= RTT for this tier)."""
        if rtt_s <= 0:
            return
        if self.rtt_s is None:
            self.rtt_s = rtt_s
        else:
            a = self._EWMA_ALPHA
            self.rtt_s = a * rtt_s + (1 - a) * self.rtt_s

    def note_skew_sample(self, skew_s: float) -> None:
        """One probe's clock-skew estimate: replica /healthz ``t``
        minus the router's probe-midpoint wall clock, folded into
        the skew EWMA."""
        if self.clock_skew_s is None:
            self.clock_skew_s = skew_s
        else:
            a = self._EWMA_ALPHA
            self.clock_skew_s = \
                a * skew_s + (1 - a) * self.clock_skew_s

    def link_estimates(self) -> Dict[str, float]:
        """The measured-link keys a prefix hint carries (empty until
        a measurement exists — absent keys leave the holder-side
        policy on its static defaults)."""
        out: Dict[str, float] = {}
        if self.wire_bytes_per_s is not None:
            out["wire_bytes_per_s"] = round(self.wire_bytes_per_s, 1)
        if self.rtt_s is not None:
            out["rtt_s"] = round(self.rtt_s, 6)
        return out

    # -- rotation --------------------------------------------------------

    def eligible(self) -> bool:
        """In rotation for NORMAL routing (HALF_OPEN is handled by
        the router via ``breaker.try_probe`` — one live probe)."""
        return (not self.draining and self.health_ok
                and self.breaker.state == CircuitBreaker.CLOSED)

    def up(self) -> bool:
        """The readiness gauge (``ptpu_router_replica_up``) and the
        rolling restart's min-ready accounting."""
        return self.eligible()

    # ptpu: lockfree[advisory failure stats: the breaker serializes real state under its own lock; these feed metrics]
    def note_failure(self, now: Optional[float] = None) -> None:
        """Transport-level evidence against this replica (probe or
        live request): feeds the breaker."""
        self.failures_total += 1
        self.last_failure_t = time.monotonic() if now is None else now
        self.breaker.record_crash(self.last_failure_t)

    def note_success(self) -> None:
        self.breaker.record_success()

    def maybe_half_open(self) -> None:
        """A healthy probe on an OPEN breaker: half-open once the
        cooldown since the last failure has elapsed (the supervisor's
        cooldown-then-probe cycle, router-side)."""
        if self.breaker.state != CircuitBreaker.OPEN:
            return
        last = self.last_failure_t
        if last is None or time.monotonic() - last \
                >= self.breaker.cooldown_s:
            self.breaker.half_open()

    # -- accounting ------------------------------------------------------

    def inc_outstanding(self) -> None:
        with self._out_lock:
            self.outstanding += 1
            self.requests_total += 1

    def dec_outstanding(self) -> None:
        with self._out_lock:
            self.outstanding = max(0, self.outstanding - 1)

    # -- chaos hooks (LocalReplica implements; URL replicas are not
    #    controllable from here) ----------------------------------------

    def chaos_kill(self) -> bool:
        return False

    def chaos_hang(self) -> bool:
        return False

    def chaos_slow(self, delay_s: float) -> bool:
        return False

    def restart(self) -> None:
        raise RuntimeError(
            f"replica {self.id} ({self.url}) is not restartable "
            f"from this router (URL replicas restart via their own "
            f"orchestrator; drain it with POST {self.url}/drain)")

    def describe(self) -> Dict[str, Any]:
        return {
            "id": self.id, "url": self.url,
            "up": self.up(),
            "state": ("draining" if self.draining
                      else self.breaker.state if not self.health_ok
                      or self.breaker.state != CircuitBreaker.CLOSED
                      else "up"),
            "breaker": self.breaker.state,
            **({"health_reason": self.health_reason}
               if self.health_reason else {}),
            "outstanding": self.outstanding,
            "role": self.role,
            **self.link_estimates(),
            "consecutive_probe_failures":
                self.consecutive_probe_failures,
            **({"last_probe_s": self.last_probe_s}
               if self.last_probe_s is not None else {}),
            **({"clock_skew_s": round(self.clock_skew_s, 6)}
               if self.clock_skew_s is not None else {}),
            "requests_total": self.requests_total,
            "failures_total": self.failures_total,
        }


class _ChaosHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with replica-level chaos hooks: ``killed``
    (connections closed unanswered, listener down), ``hang_event``
    (connections accepted, held silently — the probe-timeout
    pathology), ``slow_s`` (every request slow-walked — the tail
    pathology hedging absorbs).  Tracks live client sockets so
    ``kill`` can reset in-flight connections the way a process death
    would."""

    request_queue_size = 128
    daemon_threads = True

    def __init__(self, addr, handler):
        super().__init__(addr, handler)
        self.killed = False
        self.hang_event = threading.Event()
        self.slow_s = 0.0
        self._conn_lock = threading.Lock()
        self._conns: set = set()

    def process_request(self, request, client_address):
        with self._conn_lock:
            self._conns.add(request)
        super().process_request(request, client_address)

    def shutdown_request(self, request):
        with self._conn_lock:
            self._conns.discard(request)
        super().shutdown_request(request)

    def finish_request(self, request, client_address):
        if self.killed:
            return                      # closed unanswered
        while self.hang_event.is_set() and not self.killed:
            # Hold the connection open, serve nothing: the router's
            # EXPLICIT socket timeouts are what keep this from
            # wedging anything upstream.
            time.sleep(0.02)
        if self.killed:
            return
        if self.slow_s > 0.0:
            time.sleep(self.slow_s)
        super().finish_request(request, client_address)

    def reset_connections(self) -> None:
        """Tear down every live client connection, as a process death
        would.  ``shutdown`` first: a handler's ``rfile``/``wfile`` keep
        the socket's descriptor open past ``close``, so a handler still
        running could otherwise answer the dying server's own error
        (a 500 ``decode engine closed``) — a terminal verdict to the
        router instead of the transport death it should see."""
        with self._conn_lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass


class LocalReplica(Replica):
    """An in-process replica: spawns a ``ModelServer`` from
    ``factory`` behind a chaos-capable HTTP server on a local port.
    The test/bench fleet substrate — and the restart hook the rolling
    restart drives.  ``factory()`` must return a fresh
    ``ModelServer`` (it is called again on ``restart``)."""

    restartable = True

    def __init__(self, factory: Callable[[], Any], replica_id: str,
                 *, host: str = "127.0.0.1", **kw):
        self.factory = factory
        self._spawn_host = host
        self.ms = factory()
        self.srv = _ChaosHTTPServer((host, 0), _replica_handler(
            self.ms))
        self._serve_thread = threading.Thread(
            target=self.srv.serve_forever, daemon=True,
            name=f"replica-{replica_id}")
        self._serve_thread.start()
        port = self.srv.server_address[1]
        super().__init__(f"http://{host}:{port}", replica_id, **kw)

    # -- chaos -----------------------------------------------------------

    def chaos_kill(self) -> bool:
        """Process-death simulation: listener closed (new connections
        refused), in-flight connections reset unanswered, engine
        stopped.  ``restart`` brings a fresh server up on the SAME
        port."""
        self.srv.killed = True
        self.srv.shutdown()
        self.srv.server_close()
        self.srv.reset_connections()
        try:
            self.ms.close()
        except Exception:
            logger.debug("replica %s kill: ModelServer close failed",
                         self.id, exc_info=True)
        return True

    def chaos_hang(self) -> bool:
        self.srv.hang_event.set()
        return True

    def chaos_unhang(self) -> bool:
        self.srv.hang_event.clear()
        return True

    def chaos_slow(self, delay_s: float) -> bool:
        self.srv.slow_s = float(delay_s)
        return True

    def restart(self) -> None:
        """Fresh ``ModelServer`` + HTTP server on the same port (the
        rolling-restart unit).  Also the recovery path after
        ``chaos_kill``."""
        if not self.srv.killed:
            # A live server restarting in place: take the old one
            # down first (the rolling restart drained it already).
            self.srv.killed = True
            self.srv.shutdown()
            self.srv.server_close()
            self.srv.reset_connections()
            try:
                self.ms.close()
            except Exception:
                logger.debug(
                    "replica %s restart: old ModelServer close "
                    "failed", self.id, exc_info=True)
        self.ms = self.factory()
        self.srv = _ChaosHTTPServer((self._spawn_host, self.port),
                                    _replica_handler(self.ms))
        self._serve_thread = threading.Thread(
            target=self.srv.serve_forever, daemon=True,
            name=f"replica-{self.id}")
        self._serve_thread.start()

    def close(self) -> None:
        try:
            self.srv.killed = True
            self.srv.shutdown()
            self.srv.server_close()
            self.srv.reset_connections()
        except Exception:
            logger.debug("replica %s close: HTTP server teardown "
                         "failed", self.id, exc_info=True)
        try:
            self.ms.close()
        except Exception:
            logger.debug("replica %s close: ModelServer close "
                         "failed", self.id, exc_info=True)


def _replica_handler(ms):
    """The ModelServer's own HTTP handler class, mounted on the
    chaos-capable server instead of make_server's plain one."""
    from .server import make_handler

    return make_handler(ms)


class _Attempt:
    """One in-flight forwarded request: its own connection (with an
    EXPLICIT timeout), its own thread, and a cancel that closes the
    socket — which IS the replica-side cancel path (the client-
    disconnect probe evicts the request at the next step
    boundary)."""

    def __init__(self, replica: Replica, method: str, path: str,
                 body: bytes, headers: Dict[str, str],
                 timeout_s: float):
        self.replica = replica
        self.method = method
        self.path = path
        self.body = body
        self.headers = headers
        self.timeout_s = max(0.05, float(timeout_s))
        self.done = threading.Event()
        self.code: Optional[int] = None
        self.resp: Optional[Dict[str, Any]] = None
        self.error: Optional[BaseException] = None
        self.cancelled = False
        # Send/receive bracket (monotonic): the router-side causal
        # anchor the /fleet/requests stitcher reconciles each
        # replica's own clock against — a replica event for this
        # attempt can only have happened inside [t_send, t_recv].
        self.t_send: Optional[float] = None
        self.t_recv: Optional[float] = None
        self._conn: Optional[http.client.HTTPConnection] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "_Attempt":
        self.replica.inc_outstanding()
        self.t_send = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"route-{self.replica.id}")
        self._thread.start()
        return self

    def _run(self) -> None:
        conn = None
        try:
            conn = http.client.HTTPConnection(
                self.replica.host, self.replica.port,
                timeout=self.timeout_s)
            self._conn = conn
            conn.request(self.method, self.path, self.body,
                         self.headers)
            r = conn.getresponse()
            data = r.read()
            self.code = r.status
            try:
                self.resp = json.loads(data)
            except (ValueError, TypeError):
                self.resp = {"error": "replica returned a non-JSON "
                                      "body"}
        except BaseException as e:  # transport verdicts, incl. timeout
            self.error = e
        finally:
            self.t_recv = time.monotonic()
            self.replica.dec_outstanding()
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass
            self.done.set()

    def cancel(self) -> None:
        """First-winner-cancels: closing the connection delivers the
        replica-side cancel (the disconnect probe), so the
        loser stops burning decode budget at its next boundary."""
        self.cancelled = True
        conn = self._conn
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    # -- outcome classification -----------------------------------------

    RETRYABLE_REASONS = frozenset({"draining", "engine_down"})

    def outcome(self) -> str:
        """``ok`` | ``retryable`` | ``terminal`` — the router's whole
        decision space.  Retryable: transport death (connect
        refused/reset, read timeout — a dead or hung replica), 429
        (that replica's queue is full; another may be idle), and the
        replica-level 503s (``draining``/``engine_down``).  Terminal:
        everything else — 400s, poisoned convictions, deterministic
        sheds (``kv_pages`` fails identically fleet-wide; retrying it
        amplifies load for nothing)."""
        if self.error is not None:
            return "retryable"
        if self.code == 200:
            return "ok"
        if self.code == 429:
            return "retryable"
        if self.code == 503:
            reason = (self.resp or {}).get("reason")
            if reason in self.RETRYABLE_REASONS:
                return "retryable"
        return "terminal"


class ReplicaRouter:
    """The front tier: owns N replicas, probes their health, routes
    with least-outstanding + prefix affinity, fails over with a
    bounded retry budget, hedges stragglers, and rolls restarts.
    See the module docstring for the full design."""

    def __init__(self, replicas: List, *,
                 probe_interval_s: float = 0.5,
                 probe_timeout_s: float = 2.0,
                 down_after: int = 2,
                 cooldown_s: float = 1.0,
                 retry_ratio: float = 0.1,
                 retry_burst: float = 8.0,
                 max_attempts: int = 3,
                 retry_policy: Optional[RetryPolicy] = None,
                 request_timeout_s: float = 120.0,
                 hedge: str = "off",
                 hedge_min_s: float = 0.2,
                 affinity: bool = True,
                 affinity_max_outstanding: int = 8,
                 affinity_entries: int = 64,
                 prefix_handoff: bool = True,
                 disagg_min_tokens: int = 16,
                 rebalance_every_s: float = 0.0,
                 min_ready: int = 1,
                 fleet_faults=None,
                 request_history: int = 256,
                 slo=None,
                 slo_window: int = 512,
                 forensics: bool = True,
                 forensics_dir: Optional[str] = None,
                 sentry_window: int = 64,
                 sentry_baseline_windows: int = 4,
                 clock_skew_suspect_s: float = 0.25,
                 autostart: bool = True):
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.replicas: List[Replica] = []
        for i, r in enumerate(replicas):
            if isinstance(r, Replica):
                self.replicas.append(r)
            else:
                r = Replica(str(r), f"r{i}")
                self.replicas.append(r)
            # The ROUTER owns rotation policy: its down_after /
            # cooldown_s knobs configure every replica's breaker,
            # constructed or passed (a passed Replica's ctor-default
            # breaker silently overriding the router's knobs was a
            # real config trap — the test/bench fleets all pass
            # instances).
            r.breaker = CircuitBreaker(
                threshold=down_after, window_s=r.breaker.window_s,
                cooldown_s=cooldown_s)
        ids = [r.id for r in self.replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {ids}")
        if probe_interval_s <= 0 or probe_timeout_s <= 0:
            raise ValueError(
                f"probe_interval_s and probe_timeout_s must be > 0; "
                f"got {probe_interval_s}, {probe_timeout_s}")
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1; got "
                             f"{max_attempts}")
        if request_timeout_s <= 0:
            raise ValueError(f"request_timeout_s must be > 0; got "
                             f"{request_timeout_s}")
        if min_ready < 0:
            raise ValueError(f"min_ready must be >= 0; got "
                             f"{min_ready}")
        if disagg_min_tokens < 1:
            raise ValueError(f"disagg_min_tokens must be >= 1; got "
                             f"{disagg_min_tokens}")
        if rebalance_every_s < 0:
            raise ValueError(f"rebalance_every_s must be >= 0; got "
                             f"{rebalance_every_s}")
        if hedge != "off" and hedge != "p99":
            try:
                float(hedge)
            except (TypeError, ValueError):
                raise ValueError(
                    f"hedge must be 'off', 'p99', or a threshold in "
                    f"seconds; got {hedge!r}")
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.request_timeout_s = float(request_timeout_s)
        self.max_attempts = int(max_attempts)
        self.budget = RetryBudget(retry_ratio, retry_burst)
        self.retry_policy = retry_policy if retry_policy is not None \
            else RetryPolicy(max_attempts=max_attempts,
                             base_delay_s=0.02, max_delay_s=0.5)
        self.hedge = hedge
        self.hedge_min_s = float(hedge_min_s)
        self.affinity_enabled = bool(affinity)
        self.affinity_max_outstanding = int(affinity_max_outstanding)
        # Drain-time cache migration (POST /prefix/handoff before a
        # rolling-restart flush).  Off = the seed per-replica-only
        # behavior: a restart is a cache flush.
        self.prefix_handoff_enabled = bool(prefix_handoff)
        # Disaggregated serving: prompts at or above this length get
        # the two-stage prefill->decode schedule when a dedicated
        # prefill tier exists.  Below it the remote-prefill round
        # trip costs more than decoding the prefill locally (same
        # calculus as PrefixFetchPolicy.min_tokens, and the same
        # default).
        self.disagg_min_tokens = int(disagg_min_tokens)
        # Optional cadence for POST /fleet/prefix/rebalance driven
        # off the federated kv_host_* gauges.  0 (default) = operator
        # trigger only.  One-flight: the cadence
        # thread and an operator POST share the same non-blocking
        # lock, so a slow pass is skipped, never stacked.
        self.rebalance_every_s = float(rebalance_every_s)
        self._rebalance_flight = threading.Lock()
        self._rebalance_thread: Optional[threading.Thread] = None
        self.min_ready = int(min_ready)
        self.fleet_faults = FaultPlan.load(fleet_faults) \
            if fleet_faults is not None else None
        self.draining = False
        # Router-side request spans: the bounded terminal-record ring
        # behind GET /fleet/requests — the SAME RequestHistory
        # machinery each replica runs (serving/debug.py), holding the
        # router's half of a request's causal story (route decisions,
        # attempt brackets, failovers, hedges, budget denials).
        # 0 disables the layer, one attribute check per request.
        self.history = RequestHistory(request_history)
        # ROUTER-SIDE FORENSICS (serving/forensics.py): the router's
        # own phase accumulator + anomaly sentry over its ledger
        # phases (route pick, attempt brackets, remote prefill,
        # retry backoff) — GET /fleet/anomalies merges its findings
        # with every replica's GET /anomalies.
        self.forensics: Optional[ForensicsCore] = None
        if forensics:
            self.forensics = ForensicsCore(
                window=sentry_window,
                baseline_windows=sentry_baseline_windows,
                out_dir=forensics_dir,
                snapshot_fn=self.stats,
                record_fn=self.history.get)
        # Stitched-timeline segments whose estimated replica clock
        # skew exceeds this get flagged ``clock_skew_suspect`` —
        # the silent anchor correction stops hiding a bad clock.
        self.clock_skew_suspect_s = float(clock_skew_suspect_s)
        # Per-probe wall-time histogram: a slow-but-alive replica is
        # visible in rotation BEFORE it trips the hedge watermark.
        self.probe_hist = Histogram(LATENCY_BUCKETS)
        # SLO layer: declared objectives evaluated over a sliding
        # window of the router's own accounting (burn-rate gauges).
        if slo is None:
            self.slo: Optional[SLOTracker] = None
        elif isinstance(slo, SLOTracker):
            self.slo = slo
        else:
            self.slo = SLOTracker(
                SLOTracker.parse(slo) if isinstance(slo, str)
                else dict(slo),
                window=int(slo_window))
        # Prefix-affinity map: registered-prefix token tuple ->
        # ORDERED holder list (primary first), LRU-bounded.
        # Router-side mirror of what the replicas' radix stores
        # hold; longest-match by scan (the registered-prefix
        # population is small — system prompts).  Secondary holders
        # accumulate from drain handoffs and observed wire fetches,
        # so failover and the fetch hint both have somewhere to go
        # when the primary leaves rotation.
        self._affinity: "OrderedDict[Tuple[int, ...], List[str]]" \
            = OrderedDict()
        self._affinity_cap = int(affinity_entries)
        self._affinity_lock = threading.Lock()
        # Latency window for the hedge watermark (the engine's
        # sliding-p99 idiom: recent observations, never the
        # cumulative histogram).
        self._lat_recent: "deque[float]" = deque(maxlen=64)
        self._lat_lock = threading.Lock()
        # Counters (one stats() dict -> /metrics + /info, no drift).
        self._stats_lock = threading.Lock()
        self.requests_total = 0
        self.completed_total = 0
        self.errors_total = 0
        self.shed_total = 0            # router-level fast 503s
        self.failovers_total = 0
        self.resumed_tokens_total = 0
        self.resumes_total = 0         # failovers replayed WITH
        #                                partial output
        self.hedges_fired_total = 0
        self.hedges_won_total = 0
        self.hedges_cancelled_total = 0
        # Metrics federation (GET /fleet/metrics): scrape accounting.
        self.fleet_scrapes_total = 0
        self.fleet_scrape_errors_total = 0
        # Fleet prefix cache (the kv_fleet_* family): hint
        # injections, observed wire fetches, drain handoffs, and the
        # one-copy-somewhere rebalance pass.
        self.kv_fleet_hints_injected_total = 0
        self.kv_fleet_wire_fetches_total = 0
        self.kv_fleet_handoffs_total = 0
        self.kv_fleet_handoff_entries_total = 0
        self.kv_fleet_handoff_failed_total = 0
        self.kv_fleet_rebalances_total = 0
        self.kv_fleet_evict_hints_total = 0
        # Cadenced rebalance (--rebalance-every): runs attempted /
        # failed (operator-triggered passes count only in
        # kv_fleet_rebalances_total, as before).
        self.kv_fleet_rebalance_runs_total = 0
        self.kv_fleet_rebalance_failed_total = 0
        # Disaggregated serving: two-stage schedules taken, and
        # stage-1 (remote prefill) failures degraded to decode-side
        # re-prefill — the counted-never-fatal rung of the ladder.
        self.disagg_prefills_total = 0
        self.disagg_prefill_failed_total = 0
        self.disagg_handoffs_total = 0
        self.fleet_faults_applied: Dict[str, int] = {}
        self._rr = 0                   # least-outstanding tiebreak
        # Rolling restart state (one at a time; POST /fleet/restart).
        # ``restart_state["completed"]`` is per-RUN progress (resets
        # each restart); ``restarts_completed_total`` is the
        # monotonic counter /metrics exports — a Prometheus counter
        # must never go backwards.
        self._restart_lock = threading.Lock()
        self.restarts_completed_total = 0
        self.restart_state: Dict[str, Any] = {
            "in_progress": False, "completed": 0, "rounds_total": 0,
            "last_error": None, "min_ready_floor_observed": None}
        self._stop = False
        self._probe_thread: Optional[threading.Thread] = None
        if autostart:
            self.start()

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        if self._probe_thread is not None \
                and self._probe_thread.is_alive():
            return
        self._stop = False
        self._probe_thread = threading.Thread(
            target=self._probe_loop, daemon=True,
            name="router-probe")
        self._probe_thread.start()
        if self.rebalance_every_s > 0 and (
                self._rebalance_thread is None
                or not self._rebalance_thread.is_alive()):
            self._rebalance_thread = threading.Thread(
                target=self._rebalance_loop, daemon=True,
                name="router-rebalance")
            self._rebalance_thread.start()

    def close(self) -> None:
        self._stop = True
        t = self._probe_thread
        if t is not None:
            t.join(timeout=self.probe_timeout_s
                   * max(2, len(self.replicas)) + 5)
        t = self._rebalance_thread
        if t is not None:
            t.join(timeout=self.probe_timeout_s + 5)

    def drain(self) -> Dict[str, Any]:
        """Router-level drain: stop admitting (503 ``draining``) —
        the replicas keep running; drain them individually or via
        the rolling restart."""
        self.draining = True
        return {"draining": True}

    # -- health probing --------------------------------------------------

    def _http_text(self, replica: Replica, method: str, path: str,
                   *, body: Optional[bytes] = None,
                   timeout_s: Optional[float] = None
                   ) -> Tuple[Optional[int], bytes]:
        """One bounded HTTP exchange with a replica: ``(status, raw
        body)``, or ``(None, b"")`` on transport failure.  The ONE
        copy of the connect/request/read/close sequence the probe,
        drain, re-admission, federation-scrape, and request-stitch
        paths share (every connection carries an explicit timeout —
        SOCKET-TIMEOUT)."""
        conn = None
        try:
            conn = http.client.HTTPConnection(
                replica.host, replica.port,
                timeout=timeout_s if timeout_s is not None
                else self.probe_timeout_s)
            conn.request(method, path, body,
                         {"Content-Type": "application/json"}
                         if body is not None else {})
            r = conn.getresponse()
            return r.status, r.read()
        except (OSError, http.client.HTTPException):
            return None, b""
        finally:
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass

    def _http_json(self, replica: Replica, method: str, path: str,
                   *, body: Optional[bytes] = None
                   ) -> Tuple[Optional[int], Dict[str, Any]]:
        """:meth:`_http_text` with the body parsed as a JSON dict
        (non-dict / non-JSON bodies parse to ``{}``)."""
        status, raw = self._http_text(replica, method, path,
                                      body=body)
        if status is None:
            return None, {}
        try:
            parsed = json.loads(raw)
            if not isinstance(parsed, dict):
                parsed = {}
        except (ValueError, TypeError):
            parsed = {}
        return status, parsed

    def _probe_once(self, replica: Replica) -> None:
        """One /healthz probe.  200 -> healthy (half-open/close the
        breaker per the recovery semantics); 503 with the unified
        schema -> honest not-ready; transport failure -> crash
        evidence.  Every probe's wall time feeds the
        ``ptpu_router_probe_duration_seconds`` histogram and the
        replica's ``last_probe_s`` — the early-warning surface for a
        slow-but-alive replica (a probe that takes 800ms of a 2s
        timeout is a replica already hurting, still in rotation)."""
        t0 = time.monotonic()
        t0_wall = time.time()
        status, parsed = self._http_json(replica, "GET", "/healthz")
        dt = time.monotonic() - t0
        self.probe_hist.observe(dt)
        replica.last_probe_s = round(dt, 6)
        if status is None:
            replica.consecutive_probe_failures += 1
            replica.health_ok = False
            replica.health_reason = "unreachable"
            replica.note_failure()
            return
        replica.consecutive_probe_failures = 0
        # Any completed exchange is an RTT sample for the link
        # calibration EWMA (a /healthz round trip is all overhead —
        # exactly what the wire-fetch cost gate's rtt term models).
        replica.note_rtt_sample(dt)
        if status == 200:
            replica.health_ok = True
            replica.health_reason = None
            # Role discovery: /healthz advertises the replica's
            # serving role, so the router learns the fleet's shape
            # from the same probe that learns its health.  Replicas
            # predating the role field read as "both" (monolithic).
            role = parsed.get("role")
            if role in ("prefill", "decode", "both"):
                replica.role = role
            # Clock-skew ESTIMATE: the replica stamps its /healthz
            # 200 body with its wall clock; against the router's
            # probe-midpoint wall clock that bounds the skew to the
            # one-way delay asymmetry.  Host clocks only — labeled
            # an estimate everywhere it surfaces (the
            # time-truth discipline).
            rt = parsed.get("t")
            if isinstance(rt, (int, float)) \
                    and not isinstance(rt, bool):
                replica.note_skew_sample(
                    float(rt) - (t0_wall + dt / 2.0))
            st = replica.breaker.state
            if st == CircuitBreaker.OPEN:
                replica.maybe_half_open()
            elif st == CircuitBreaker.HALF_OPEN:
                # Second consecutive healthy probe: the half-open
                # success probe an idle fleet needs (live traffic
                # closes it sooner via try_probe + success).
                replica.note_success()
        else:
            replica.health_ok = False
            replica.health_reason = parsed.get(
                "reason", parsed.get("status", f"http_{status}"))

    def _probe_loop(self) -> None:
        while not self._stop:
            for replica in self.replicas:
                if self._stop:
                    return
                self._probe_once(replica)
            deadline = time.monotonic() + self.probe_interval_s
            while not self._stop and time.monotonic() < deadline:
                time.sleep(0.02)

    # -- affinity --------------------------------------------------------

    def _note_prefix(self, toks: Tuple[int, ...],
                     replica_id: str, *,
                     primary: bool = True) -> None:
        """Record ``replica_id`` as a holder of ``toks``.  Primary
        holders (a routed /prefill, a handoff successor) lead the
        list; secondary holders (an observed wire fetch — the
        fetcher keeps a host-tier copy) append behind them."""
        with self._affinity_lock:
            holders = self._affinity.get(toks)
            if holders is None:
                holders = self._affinity[toks] = []
            if replica_id in holders:
                if primary and holders[0] != replica_id:
                    holders.remove(replica_id)
                    holders.insert(0, replica_id)
            elif primary:
                holders.insert(0, replica_id)
            else:
                holders.append(replica_id)
            self._affinity.move_to_end(toks)
            while len(self._affinity) > self._affinity_cap:
                self._affinity.popitem(last=False)

    def _affinity_holders(self, prompt: Optional[List[int]]
                          ) -> List[str]:
        """ORDERED holder list (primary first) for the LONGEST
        registered prefix of this prompt — empty when none."""
        if not self.affinity_enabled or not prompt:
            return []
        best_len, best = 0, []
        with self._affinity_lock:
            for toks, holders in self._affinity.items():
                n = len(toks)
                if n > best_len and n <= len(prompt) \
                        and list(toks) == prompt[:n]:
                    best_len, best = n, list(holders)
        return best

    def _affinity_for(self, prompt: Optional[List[int]]
                      ) -> Optional[str]:
        """The PRIMARY holder of the longest registered prefix of
        this prompt, or None."""
        holders = self._affinity_holders(prompt)
        return holders[0] if holders else None

    def _affinity_replace(self, old_id: str,
                          new_id: Optional[str]) -> None:
        """Re-point every holder entry from ``old_id`` to ``new_id``
        (drain handoff succeeded: the successor now holds what the
        drainee held), or drop ``old_id`` everywhere when ``new_id``
        is None (handoff failed: the restart flushes the drainee's
        store, so the stale binding must not attract traffic)."""
        with self._affinity_lock:
            for toks in list(self._affinity):
                holders = self._affinity[toks]
                if old_id not in holders:
                    continue
                holders.remove(old_id)
                if new_id is not None and new_id not in holders:
                    holders.append(new_id)
                if not holders:
                    del self._affinity[toks]

    # -- replica selection -----------------------------------------------

    def _pick(self, prompt: Optional[List[int]],
              exclude: set, want: str = "any"
              ) -> Tuple[Optional[Replica], str]:
        """``(replica, why)``: least-outstanding among in-rotation
        replicas, with prefix affinity as a PREFERENCE — the affinity
        replica wins only while it is healthy and below the
        saturation bound (affinity must never beat health, pinned).
        ``why`` is the route-decision tag the request-span record
        carries: ``affinity`` / ``least_outstanding`` /
        ``half_open_probe`` / ``none``.

        ``want`` is the role-split capability filter.  ``"decode"``
        is HARD: a role='prefill' replica rejects /generate outright,
        so routing one there just burns an attempt.  ``"prefill"``
        is SOFT — every role physically serves /prefill (a decode
        replica's re-prefill fallback depends on it) — so it narrows
        to prefill-capable replicas only while at least one is in
        rotation."""
        eligible = [r for r in self.replicas
                    if r.id not in exclude and r.eligible()]
        half_open = [r for r in self.replicas
                     if r.id not in exclude and not r.draining
                     and r.health_ok
                     and r.breaker.state == CircuitBreaker.HALF_OPEN]
        if want == "decode":
            eligible = [r for r in eligible if r.decode_capable()]
            half_open = [r for r in half_open if r.decode_capable()]
        elif want == "prefill":
            pref = [r for r in eligible if r.prefill_capable()]
            if pref:
                eligible = pref
                half_open = [r for r in half_open
                             if r.prefill_capable()]
        by_id = {r.id: r for r in eligible}
        # Holders in preference order (primary first): the FIRST
        # surviving, unsaturated one wins — so a failover replay
        # (primary excluded/dead) lands on a secondary holder of the
        # request's prefix instead of a cold least-outstanding pick,
        # and the replay's re-prefill cost drops for free.
        for aff in self._affinity_holders(prompt):
            r = by_id.get(aff)
            if r is not None and r.outstanding \
                    < self.affinity_max_outstanding:
                return r, "affinity"
        if eligible:
            self._rr += 1
            return min(
                eligible,
                key=lambda r: (r.outstanding,
                               (self.replicas.index(r) + self._rr)
                               % len(self.replicas))), \
                "least_outstanding"
        # No closed replica in rotation: offer a HALF_OPEN one its
        # single live probe (exactly one concurrent claimant passes —
        # recovery.CircuitBreaker.try_probe).
        for r in half_open:
            if r.breaker.try_probe():
                return r, "half_open_probe"
        return None, "none"

    def _pick_prefill_tier(self) -> Optional[Replica]:
        """Least-outstanding DEDICATED prefill replica in rotation,
        or None.  The two-stage disagg schedule only activates when
        the fleet actually runs a prefill tier — a 'both' replica
        prefills fine, but bouncing a prompt through one buys no
        decode-lock relief, just an extra hop."""
        tier = [r for r in self.replicas
                if r.role == "prefill" and r.eligible()]
        if not tier:
            return None
        return min(tier, key=lambda r: r.outstanding)

    # -- fleet chaos -----------------------------------------------------

    def _poll_fleet_faults(self) -> None:
        if self.fleet_faults is None:
            return
        for site in FLEET_SITES:
            fired = self.fleet_faults.poll(site)
            if fired is None:
                continue
            idx = fired["replica"] % len(self.replicas)
            replica = self.replicas[idx]
            applied = False
            if site == "replica_kill":
                applied = replica.chaos_kill()
            elif site == "replica_hang":
                applied = replica.chaos_hang()
            elif site == "replica_slow":
                applied = replica.chaos_slow(fired["delay_s"])
            with self._stats_lock:
                key = site if applied else site + "_unsupported"
                self.fleet_faults_applied[key] = \
                    self.fleet_faults_applied.get(key, 0) + 1

    # -- the hedge watermark ---------------------------------------------

    def _observe_latency(self, dt: float) -> None:
        with self._lat_lock:
            self._lat_recent.append(dt)

    def _hedge_after_s(self) -> Optional[float]:
        if self.hedge == "off":
            return None
        if self.hedge != "p99":
            return max(self.hedge_min_s, float(self.hedge))
        with self._lat_lock:
            xs = sorted(self._lat_recent)
        if len(xs) < 8:
            # Too little signal for a p99: hedge only past the floor.
            return self.hedge_min_s if xs else None
        idx = min(len(xs) - 1, int(0.99 * (len(xs) - 1) + 0.9999))
        return max(self.hedge_min_s, xs[idx])

    # -- routing ---------------------------------------------------------

    def _forward_headers(self, replica: Replica,
                         rid: str) -> Dict[str, str]:
        """X-Request-Id forwarded REPLICA-WARD with the replica-id
        prefix (serving/debug.py's convention): the replica's access
        log, trace ring, and /requests/<id> all key on
        ``r0-<rid>`` — one grep string per (request, replica) leg of
        a failover."""
        fwd = format_replica_rid(replica.id, rid)
        return {"Content-Type": "application/json",
                "X-Request-Id": fwd}

    def _race(self, primary: _Attempt, deadline: float,
              payload_bytes: bytes, rid: str, prompt,
              exclude: set, note=None
              ) -> Tuple[_Attempt, Optional[_Attempt]]:
        """Wait the primary out, optionally firing ONE hedge at the
        watermark; returns (winner, loser).  The winner is the first
        attempt to reach a decisive outcome (ok/terminal); a
        retryable loser is just evidence, and a still-running loser
        is CANCELLED (connection close -> replica-side cancel).
        ``note(name, t, **args)`` (optional) receives the hedge
        lifecycle instants for the request-span record."""
        if note is None:
            def note(name, t, **args):
                pass
        hedge_after = self._hedge_after_s()
        hedge: Optional[_Attempt] = None
        t0 = time.monotonic()
        while True:
            now = time.monotonic()
            if now >= deadline:
                # The caller maps this to a retryable timeout on the
                # primary; cancel everything in flight.
                primary.cancel()
                if hedge is not None:
                    hedge.cancel()
                    note("hedge_cancelled", time.monotonic(),
                         replica=hedge.replica.id,
                         reason="deadline")
                    with self._stats_lock:
                        self.hedges_cancelled_total += 1
                return primary, hedge
            if primary.done.is_set() and (
                    hedge is None or hedge.done.is_set()
                    or primary.outcome() != "retryable"):
                # Primary decided (or both are done).
                if hedge is not None and not hedge.done.is_set():
                    hedge.cancel()
                    note("hedge_cancelled", time.monotonic(),
                         replica=hedge.replica.id,
                         reason="primary_won")
                    with self._stats_lock:
                        self.hedges_cancelled_total += 1
                return primary, hedge
            if hedge is not None and hedge.done.is_set() \
                    and hedge.outcome() != "retryable":
                # The hedge won: cancel the straggling primary (the
                # engine's cancel path reclaims its slot).
                primary_live = not primary.done.is_set()
                if primary_live:
                    primary.cancel()
                note("hedge_won", time.monotonic(),
                     replica=hedge.replica.id,
                     **({"cancelled_primary": primary.replica.id}
                        if primary_live else {}))
                with self._stats_lock:
                    self.hedges_won_total += 1
                    if primary_live:
                        self.hedges_cancelled_total += 1
                return hedge, primary
            if hedge is None and hedge_after is not None \
                    and now - t0 >= hedge_after \
                    and not primary.done.is_set():
                second, _why = self._pick(
                    prompt, exclude | {primary.replica.id},
                    want="decode")
                if second is not None and self.budget.try_spend():
                    hedge = _Attempt(
                        second, "POST", "/generate", payload_bytes,
                        self._forward_headers(second, rid),
                        min(self.request_timeout_s,
                            max(0.05, deadline - now))).start()
                    note("hedge_fired", time.monotonic(),
                         replica=second.id,
                         watermark_s=round(hedge_after, 4))
                    with self._stats_lock:
                        self.hedges_fired_total += 1
                else:
                    if second is not None:
                        # A hedge target existed but the budget said
                        # no — the denial is part of the causal story
                        # (budget.denied_total already counted it).
                        note("retry_budget_denied", time.monotonic(),
                             for_="hedge")
                    hedge_after = None      # nothing to hedge onto
            # BLOCK, don't poll: before a hedge exists the only
            # wake-up sources are the primary finishing, the hedge
            # watermark, and the deadline — wait on the primary's
            # event up to the nearest of them.  Once a hedge is in
            # flight there are two events to watch, so a short
            # bounded wait keeps the race responsive (the hedge
            # window is the rare tail case, not the steady state).
            if hedge is None:
                wake = deadline
                if hedge_after is not None:
                    wake = min(wake, t0 + hedge_after)
                primary.done.wait(
                    max(0.001, wake - time.monotonic()))
            elif primary.done.is_set():
                # Primary already decided (retryable, or we'd have
                # returned): the hedge is the only pending event.
                hedge.done.wait(
                    max(0.001, deadline - time.monotonic()))
            else:
                primary.done.wait(0.005)

    def route_generate(self, req: Dict[str, Any],
                       rid: Optional[str] = None
                       ) -> Tuple[int, Dict[str, Any]]:
        """Route one /generate body; returns (status, response).
        Failure handling lives HERE, not in the client: failover with
        resume replay, bounded by the retry budget and
        ``max_attempts``, hedged past the p99 watermark.  The whole
        causal story — route decisions, attempt send/receive
        brackets, failovers, hedges, budget denials — lands in ONE
        terminal record in the router's history ring, the router half
        of ``GET /fleet/requests/<id>``."""
        rid = rid or new_request_id()
        t0 = time.monotonic()
        # Request-span trace: (name, t_start, t_end, args) tuples in
        # the router's monotonic clock, rendered into the record via
        # the same events_to_dicts the replica records use.
        trace: List[Tuple[str, float, float, Dict[str, Any]]] = []
        attempts_log: List[Dict[str, Any]] = []
        # With a TTFT objective armed the router needs the replica's
        # admission-anchored TTFT, so it injects a timings request
        # into the forwarded payload — and strips the block back off
        # the response when the CLIENT never asked for it.
        # Availability/latency objectives need no replica timings
        # (latency is the router's own clock), so they don't tax the
        # replicas with per-stream span rendering.
        slo_inject = self.slo is not None \
            and any(o.get("metric") == "ttft"
                    for o in self.slo.objectives.values()) \
            and not req.get("timings", False)
        partial: List[int] = []        # tokens recovered so far —
        #                                replayed with resume_tokens
        #                                (populated by a streaming
        #                                protocol, which the servers
        #                                do not speak yet; empty
        #                                replays are full replays,
        #                                same contract)

        def note(name, a, b=None, **args):
            trace.append((name, a, a if b is None else b, args))

        def log_attempt(att: _Attempt, *, hedge: bool,
                        resume_n: int) -> None:
            rec = _attempt_record(att, len(attempts_log) + 1, t0,
                                  hedge=hedge, resume_n=resume_n)
            attempts_log.append(rec)
            if att.t_send is not None:
                note("attempt", att.t_send,
                     att.t_recv if att.t_recv is not None
                     else time.monotonic(),
                     replica=att.replica.id, n=rec["n"],
                     outcome=rec["outcome"],
                     **({"code": att.code} if att.code is not None
                        else {}),
                     **({"hedge": True} if hedge else {}))

        def finish(code: int, resp: Dict[str, Any],
                   winner: Optional[_Attempt] = None
                   ) -> Tuple[int, Dict[str, Any]]:
            """Every terminal path funnels through here: the SLO
            observation and the history record are built from the
            same trace the response rode."""
            now = time.monotonic()
            if self.slo is not None:
                ttft_s = None
                if code == 200:
                    tm = ((resp or {}).get("timings") or {}) \
                        .get("ttft_ms")
                    if tm is not None and winner is not None \
                            and winner.t_send is not None:
                        # Client-visible TTFT: router queue/hedge
                        # time up to the WINNING send, plus the
                        # replica's admission-anchored TTFT.
                        ttft_s = (winner.t_send - t0) + tm / 1e3
                    else:
                        ttft_s = now - t0
                self.slo.observe(code, ttft_s=ttft_s,
                                 latency_s=now - t0)
            if slo_inject and isinstance(resp, dict):
                resp.pop("timings", None)
            # Router-side phase ledger (serving/forensics.py): the
            # same trace the record's timeline renders from, so the
            # two views of one request cannot disagree.
            ledger = None
            if self.forensics is not None or self.history.enabled:
                ledger = compute_router_ledger(trace, t0, now)
                if self.forensics is not None:
                    self.forensics.note(ledger, rid)
            if self.history.enabled:
                status = _terminal_status(code)
                replicas_involved: List[str] = []
                for a in attempts_log:
                    if a["replica"] not in replicas_involved:
                        replicas_involved.append(a["replica"])
                rec: Dict[str, Any] = {
                    "request_id": rid,
                    "t": round(time.time(), 3),
                    "path": "/generate",
                    "status": status,
                    "code": code,
                    "wall_s": round(now - t0, 6),
                    "attempts": attempts_log,
                    "replicas": replicas_involved,
                    "resume_tokens": len(partial),
                    "timeline": events_to_dicts(trace, t0),
                    **({"phases": ledger}
                       if ledger is not None else {}),
                }
                if isinstance(resp, dict):
                    if resp.get("reason"):
                        rec["reason"] = resp["reason"]
                    if status != "complete" and resp.get("error"):
                        rec["error"] = str(resp["error"])[:300]
                # "hedged" means a hedge FIRED for this request (the
                # attempt table's truth), not that it won — the
                # response's router.hedged only marks wins, and a
                # record whose summary disagreed with its own
                # attempt table would be poison during an incident.
                if any(a.get("hedge") for a in attempts_log):
                    rec["hedged"] = True
                self.history.record(rec)
            return code, resp

        if self.draining:
            with self._stats_lock:
                self.shed_total += 1
            return finish(503, {"error": "router is draining",
                                "reason": "draining",
                                "request_id": rid})
        self._poll_fleet_faults()
        with self._stats_lock:
            self.requests_total += 1
        self.budget.on_request()
        prompt = None
        rows = req.get("prompt")
        if isinstance(rows, list) and rows:
            prompt = rows[0] if isinstance(rows[0], list) else rows
        deadline_ms = req.get("deadline_ms")
        deadline = t0 + (min(self.request_timeout_s,
                             deadline_ms / 1e3)
                         if isinstance(deadline_ms, (int, float))
                         and not isinstance(deadline_ms, bool)
                         and deadline_ms > 0
                         else self.request_timeout_s)
        # Disaggregated two-stage schedule (docs/SERVING.md
        # "Disaggregated serving"): with a dedicated prefill tier in
        # rotation and a prompt long enough to amortize the handoff,
        # run STAGE 1 — prompt prefill on a prefill replica — before
        # the decode attempt loop.  Success records the prefill
        # replica as the prefix's PRIMARY holder, so the decode
        # replica the loop picks gets a fetch hint naming it and
        # ADMITS the prefill's KV over the wire lane (the kv_handoff)
        # instead of re-prefilling under its own decode lock.  A
        # prompt whose prefix already sits warm on a routable decode
        # replica skips stage 1 — affinity routing lands it there
        # with zero prefill work anywhere.  EVERY stage-1 failure
        # (dead prefill tier, timeout) degrades to decode-side
        # re-prefill: counted, never a request failure.
        disagg: Optional[Replica] = None
        if prompt and len(prompt) >= self.disagg_min_tokens \
                and not req.get("resume_tokens") \
                and all(isinstance(t, int) for t in prompt):
            pre = self._pick_prefill_tier()
            if pre is not None:
                by_id = {r.id: r for r in self.replicas}
                warm_decode = any(
                    h is not None and h.eligible()
                    and h.decode_capable()
                    and h.outstanding < self.affinity_max_outstanding
                    for h in (by_id.get(hid) for hid
                              in self._affinity_holders(prompt)))
                if not warm_decode:
                    disagg = pre
                    tp0 = time.monotonic()
                    p_att = _Attempt(
                        pre, "POST", "/prefill",
                        json.dumps({"prompt": list(prompt)}).encode(),
                        self._forward_headers(pre, rid),
                        min(self.request_timeout_s,
                            max(0.05, deadline - tp0))).start()
                    p_att.done.wait(max(0.05, deadline - tp0) + 1.0)
                    ok = p_att.done.is_set() \
                        and p_att.outcome() == "ok"
                    note("prefill_remote", tp0, time.monotonic(),
                         replica=pre.id,
                         tokens=len(prompt),
                         **({} if ok else {"failed": True}))
                    with self._stats_lock:
                        self.disagg_prefills_total += 1
                        if not ok:
                            self.disagg_prefill_failed_total += 1
                    if ok:
                        pre.note_success()
                        self._note_prefix(tuple(prompt), pre.id)
                    else:
                        if p_att.error is not None \
                                and not p_att.cancelled:
                            pre.note_failure()
                        disagg = None   # hint-less: re-prefill
        exclude: set = set()
        attempt_n = 0
        while True:
            payload = dict(req)
            if slo_inject:
                payload["timings"] = True
            if partial:
                # CROSS-REPLICA RESUME: prompt ++ received tokens,
                # RNG continues at position key len(partial)
                # (docs/DESIGN.md; token-identical per seed).
                payload["prompt"] = list(prompt) + partial
                payload["resume_tokens"] = len(partial)
            replica, why = self._pick(prompt, exclude,
                                      want="decode")
            if replica is None and exclude:
                # Every replica already failed this request once:
                # widen back out rather than shedding while capacity
                # exists (the failed one may have merely been busy).
                note("exclusions_widened", time.monotonic(),
                     excluded=sorted(exclude))
                exclude = set()
                replica, why = self._pick(prompt, exclude,
                                          want="decode")
            if replica is None:
                with self._stats_lock:
                    self.shed_total += 1
                    self.errors_total += 1
                return finish(503, {
                    "error": "no replica in rotation",
                    "reason": "no_replica", "request_id": rid,
                    "router": self._route_info(None, attempt_n,
                                               partial)})
            attempt_n += 1
            hint_holder: Optional[Replica] = None
            if why != "affinity":
                # Routed AWAY from the prefix's holders (saturation,
                # exclusion, drain, role split): hand the chosen
                # replica a FETCH HINT naming a live holder, so its
                # local miss can become a wire fetch instead of a
                # re-prefill.  A DRAINING holder still qualifies —
                # the drain window is exactly when its entries need
                # serving out.  The hint carries the holder link's
                # MEASURED wire_bytes_per_s / rtt_s (EWMA) when they
                # exist, so the fetcher's cost gate runs on observed
                # truth instead of PrefixFetchPolicy's static
                # defaults.
                holders = self._affinity_holders(prompt)
                if holders and replica.id not in holders:
                    by_id = {r.id: r for r in self.replicas}
                    for h in holders:
                        hr = by_id.get(h)
                        if hr is not None and (
                                hr.health_ok
                                or hr.health_reason == "draining"):
                            payload["prefix_hint"] = {
                                "host": hr.host, "port": hr.port,
                                "replica": hr.id,
                                **hr.link_estimates()}
                            hint_holder = hr
                            with self._stats_lock:
                                self.kv_fleet_hints_injected_total \
                                    += 1
                            note("prefix_hint", time.monotonic(),
                                 holder=hr.id)
                            break
            body = json.dumps(payload).encode()
            note("route", time.monotonic(), replica=replica.id,
                 why=why,
                 **({"excluded": sorted(exclude)} if exclude
                    else {}))
            att = _Attempt(
                replica, "POST", "/generate", body,
                self._forward_headers(replica, rid),
                min(self.request_timeout_s,
                    max(0.05, deadline - time.monotonic()))).start()
            winner, loser = self._race(att, deadline, body, rid,
                                       prompt, exclude, note=note)
            hedge_att = winner if winner is not att else loser
            log_attempt(att, hedge=False, resume_n=len(partial))
            if hedge_att is not None:
                log_attempt(hedge_att, hedge=True,
                            resume_n=len(partial))
            out = winner.outcome() if winner.done.is_set() \
                else "retryable"
            if out == "ok":
                winner.replica.note_success()
                resp = dict(winner.resp or {})
                # Recover the tokens generated by THIS attempt so a
                # later consumer (and the stats) see the stitched
                # stream; the replica already returned the FULL
                # sequence (resume replays carry the original budget).
                if partial:
                    with self._stats_lock:
                        self.resumes_total += 1
                        self.resumed_tokens_total += len(partial)
                # Holder learning: the response says where the
                # prefill actually came from.  A wire fetch (or a
                # hit on a replica the map didn't list) means the
                # winner now holds a copy — record it as a SECONDARY
                # holder so the next miss/failover can use it.
                src = resp.get("prefix_source")
                if src == "wire_fetch":
                    with self._stats_lock:
                        self.kv_fleet_wire_fetches_total += 1
                        if disagg is not None:
                            self.disagg_handoffs_total += 1
                    # The replica reports the fetch's measured bytes
                    # and wall — fold them into the HOLDER link's
                    # EWMA (the transfer ran holder -> winner), and
                    # stitch the ``kv_handoff`` span into the
                    # per-request timeline so the handoff cost is
                    # attributed, not guessed.  The span anchors at
                    # the winning attempt's send: the fetch runs at
                    # admission, causally inside the send/receive
                    # bracket.
                    fb = resp.get("prefix_fetch_bytes")
                    fs = resp.get("prefix_fetch_s")
                    if isinstance(fb, int) and fb > 0 \
                            and isinstance(fs, (int, float)) \
                            and not isinstance(fs, bool) and fs > 0:
                        if hint_holder is not None:
                            hint_holder.note_link_sample(
                                fb, float(fs))
                        if winner.t_send is not None:
                            note("kv_handoff", winner.t_send,
                                 winner.t_send + float(fs),
                                 bytes=fb,
                                 **({"holder": hint_holder.id}
                                    if hint_holder is not None
                                    else {}))
                hit_len = resp.get("prefix_hit_len")
                if src in ("wire_fetch", "local_hot",
                           "local_spilled") \
                        and isinstance(hit_len, int) \
                        and prompt and 0 < hit_len <= len(prompt) \
                        and all(isinstance(t, int)
                                for t in prompt[:hit_len]):
                    self._note_prefix(tuple(prompt[:hit_len]),
                                      winner.replica.id,
                                      primary=False)
                resp["request_id"] = rid
                resp["router"] = self._route_info(
                    winner.replica, attempt_n, partial,
                    hedged=(winner is not att))
                self._observe_latency(time.monotonic() - t0)
                with self._stats_lock:
                    self.completed_total += 1
                return finish(200, resp, winner)
            if out == "terminal":
                code = winner.code or 500
                resp = dict(winner.resp or {"error": "replica error"})
                resp["request_id"] = rid
                resp["router"] = self._route_info(
                    winner.replica, attempt_n, partial,
                    hedged=(winner is not att))
                with self._stats_lock:
                    self.errors_total += 1
                return finish(code, resp, winner)
            # Retryable: evidence against the replica, then fail
            # over within budget.  An attempt the ROUTER itself
            # cancelled (deadline expiry, hedge race) is NOT crash
            # evidence — its socket error is self-inflicted, and
            # counting it would let sustained short-deadline traffic
            # breaker-trip perfectly healthy replicas.
            for a in (att, loser):
                if a is not None and a.done.is_set() \
                        and a.outcome() == "retryable" \
                        and a.error is not None \
                        and not a.cancelled:
                    a.replica.note_failure()
                if a is not None:
                    exclude.add(a.replica.id)
            if time.monotonic() >= deadline:
                with self._stats_lock:
                    self.errors_total += 1
                return finish(504, {
                    "error": f"request deadline exhausted after "
                             f"{attempt_n} attempt(s)",
                    "reason": "deadline", "request_id": rid,
                    "router": self._route_info(replica, attempt_n,
                                               partial)})
            if attempt_n >= self.max_attempts:
                with self._stats_lock:
                    self.errors_total += 1
                    self.shed_total += 1
                return finish(503, {
                    "error": f"request failed on {attempt_n} "
                             f"replica(s); attempts exhausted",
                    "reason": "retries_exhausted", "request_id": rid,
                    "router": self._route_info(replica, attempt_n,
                                               partial)})
            if not self.budget.try_spend():
                # The sick-fleet contract: degrade to a FAST 503
                # instead of a retry storm.
                note("retry_budget_denied", time.monotonic(),
                     for_="failover")
                with self._stats_lock:
                    self.errors_total += 1
                    self.shed_total += 1
                return finish(503, {
                    "error": "retry budget exhausted (the fleet is "
                             "failing faster than live traffic "
                             "refills retries)",
                    "reason": "retry_budget", "request_id": rid,
                    "router": self._route_info(replica, attempt_n,
                                               partial)})
            with self._stats_lock:
                self.failovers_total += 1
            note("failover", time.monotonic(),
                 from_replica=replica.id,
                 resume_tokens=len(partial))
            # Jittered backoff (shared RetryPolicy), bounded by the
            # deadline.
            delay = min(self.retry_policy.delay_s(attempt_n - 1),
                        max(0.0, deadline - time.monotonic()))
            if delay > 0:
                time.sleep(delay)

    def _route_info(self, replica: Optional[Replica], attempts: int,
                    partial: List[int], *,
                    hedged: bool = False) -> Dict[str, Any]:
        return {
            **({"replica": replica.id} if replica is not None
               else {}),
            "attempts": attempts,
            **({"hedged": True} if hedged else {}),
            **({"resumed_tokens": len(partial)} if partial else {}),
        }

    def route_prefill(self, req: Dict[str, Any],
                      rid: Optional[str] = None
                      ) -> Tuple[int, Dict[str, Any]]:
        """Forward /prefill to the affinity replica (a growing
        session re-registers where its ancestor lives) or the least-
        outstanding one, and record the prefix -> replica binding the
        affinity router consults."""
        rid = rid or new_request_id()
        t0 = time.monotonic()

        def finish(code: int, resp: Dict[str, Any],
                   att: Optional[_Attempt] = None, why: str = ""
                   ) -> Tuple[int, Dict[str, Any]]:
            if self.history.enabled:
                attempts = []
                if att is not None:
                    attempts.append(_attempt_record(att, 1, t0))
                self.history.record({
                    "request_id": rid,
                    "t": round(time.time(), 3),
                    "path": "/prefill",
                    "status": _terminal_status(code),
                    "code": code,
                    "wall_s": round(time.monotonic() - t0, 6),
                    "attempts": attempts,
                    "replicas": [a["replica"] for a in attempts],
                    **({"why": why} if why else {}),
                    **({"reason": resp.get("reason")}
                       if isinstance(resp, dict)
                       and resp.get("reason") else {}),
                })
            return code, resp

        if self.draining:
            with self._stats_lock:
                self.shed_total += 1
            return finish(503, {"error": "router is draining",
                                "reason": "draining",
                                "request_id": rid})
        prompt = None
        rows = req.get("prompt")
        if isinstance(rows, list) and rows:
            prompt = rows[0] if isinstance(rows[0], list) else rows
        replica, why = self._pick(prompt, set(), want="prefill")
        if replica is None:
            with self._stats_lock:
                self.shed_total += 1
            return finish(503, {"error": "no replica in rotation",
                                "reason": "no_replica",
                                "request_id": rid})
        att = _Attempt(replica, "POST", "/prefill",
                       json.dumps(req).encode(),
                       self._forward_headers(replica, rid),
                       self.request_timeout_s).start()
        att.done.wait(self.request_timeout_s + 1.0)
        if att.outcome() == "ok" and prompt \
                and all(isinstance(t, int) for t in prompt):
            self._note_prefix(tuple(prompt), replica.id)
            resp = dict(att.resp or {})
            resp["request_id"] = rid
            resp["router"] = {"replica": replica.id}
            return finish(200, resp, att, why)
        if att.error is not None:
            replica.note_failure()
            with self._stats_lock:
                self.errors_total += 1
            return finish(503, {"error": f"replica {replica.id} "
                                         f"failed: "
                                         f"{type(att.error).__name__}",
                                "reason": "replica_unreachable",
                                "request_id": rid}, att, why)
        resp = dict(att.resp or {"error": "replica error"})
        resp["request_id"] = rid
        return finish(att.code or 500, resp, att, why)

    # -- fleet observability: cross-tier stitching -----------------------

    def fleet_request(self, rid: str) -> Optional[Dict[str, Any]]:
        """``GET /fleet/requests/<id>``: ONE merged causal timeline
        for a routed request — the router's record (route decisions,
        attempt brackets, failovers, hedges) stitched with every
        involved replica's own ``GET /requests/<rN-id>`` record.

        CLOCK RECONCILIATION: the router and each replica run
        independent monotonic clocks, so replica-local offsets are
        meaningless fleet-wide.  Each replica segment is anchored at
        the router's SEND timestamp for that attempt and clamped
        inside the send/receive bracket — by causality the replica
        processed the request inside that bracket, so the stitched
        ordering is consistent even with arbitrary clock skew (the
        residual error is the one-way network delay, bounded by the
        bracket width; events the clamp had to move carry
        ``clamped: true``).  A re-attempt on the SAME replica shares
        one replica-side record (replace-by-id retention): only the
        LAST attempt's segment carries it, earlier ones read
        ``record_superseded``."""
        rec = self.history.get(rid)
        if rec is None:
            return None
        by_id = {r.id: r for r in self.replicas}
        merged: List[Dict[str, Any]] = []
        for ev in rec.get("timeline", []):
            merged.append({"at_ms": ev.get("start_ms"),
                           **({"dur_ms": ev["dur_ms"]}
                              if ev.get("dur_ms") else {}),
                           "source": "router",
                           "event": ev.get("name"),
                           **({"args": ev["args"]}
                              if ev.get("args") else {})})
        attempts = rec.get("attempts", [])
        # One replica record per replica (replace-by-id retention):
        # fetch it for the LAST attempt on each replica only — and
        # fetch the replicas CONCURRENTLY, like the federation
        # scrape: a failover across hung replicas must not make the
        # endpoint that debugs it pay each timeout back to back.
        last_per_replica = {a["replica"]: a["n"] for a in attempts}
        fetches: Dict[str, List] = {}
        fetch_threads = []
        for replica_id in last_per_replica:
            replica = by_id.get(replica_id)
            if replica is None:
                continue
            fwd = format_replica_rid(replica_id, rid)
            slot: List = [None, {}]
            fetches[replica_id] = slot

            def fetch(replica=replica, fwd=fwd, slot=slot):
                slot[0], slot[1] = self._http_json(
                    replica, "GET", f"/requests/{fwd}")

            t = threading.Thread(target=fetch, daemon=True,
                                 name=f"fleet-stitch-{replica_id}")
            fetch_threads.append(t)
            t.start()
        for t in fetch_threads:
            t.join(timeout=self.probe_timeout_s + 1.0)
        segments: List[Dict[str, Any]] = []
        for att in attempts:
            replica_id = att["replica"]
            seg: Dict[str, Any] = {
                "replica": replica_id,
                "attempt": att["n"],
                "request_id": format_replica_rid(replica_id, rid),
                "send_ms": att.get("send_ms"),
                "recv_ms": att.get("recv_ms"),
            }
            # Clock-skew annotation: the anchor correction below is
            # applied silently; surfacing the replica's ESTIMATED
            # skew (probe-derived, host clocks) — and flagging it
            # past the suspect threshold — stops a bad clock from
            # hiding behind a plausible-looking causal order.
            rep_obj = by_id.get(replica_id)
            if rep_obj is not None \
                    and rep_obj.clock_skew_s is not None:
                seg["clock_skew_est_s"] = round(
                    rep_obj.clock_skew_s, 6)
                # Explicit False = "checked, inside the threshold";
                # an absent key would be ambiguous with "no probe
                # data yet".
                seg["clock_skew_suspect"] = \
                    abs(rep_obj.clock_skew_s) \
                    > self.clock_skew_suspect_s
            if last_per_replica.get(replica_id) != att["n"]:
                # An earlier attempt on a replica a later attempt
                # also hit: the replica's ring keeps only the latest
                # record for this ID.
                seg["record_superseded"] = True
                segments.append(seg)
                continue
            if replica_id not in fetches:
                seg["fetch_error"] = "replica_gone"
                segments.append(seg)
                continue
            status, body = fetches[replica_id]
            if status is None:
                seg["fetch_error"] = "unreachable"
                segments.append(seg)
                continue
            if status != 200:
                seg["fetch_error"] = f"http_{status}"
                if isinstance(body, dict) and body.get("error"):
                    seg["fetch_detail"] = str(body["error"])[:200]
                segments.append(seg)
                continue
            seg["record"] = body
            # Lift the replica-computed phase ledger onto the
            # segment VERBATIM — the per-attempt decomposition of
            # the stitched timeline is the same bytes the replica's
            # history record carries (the no-drift pin: one
            # computation, serving/forensics.py).
            if isinstance(body.get("phases"), dict):
                seg["phases"] = body["phases"]
            seg["clamped_events"] = self._anchor_segment(
                seg, body, merged)
            segments.append(seg)
        merged.sort(key=lambda e: (e.get("at_ms")
                                   if e.get("at_ms") is not None
                                   else 0.0))
        return {
            "request_id": rid,
            "status": rec.get("status"),
            "path": rec.get("path"),
            "wall_s": rec.get("wall_s"),
            "replicas": rec.get("replicas", []),
            "router": rec,
            "segments": segments,
            "timeline": merged,
        }

    @staticmethod
    def _anchor_segment(seg: Dict[str, Any],
                        record: Dict[str, Any],
                        merged: List[Dict[str, Any]]) -> int:
        """Fold one replica record's stream timelines into the
        merged fleet timeline, anchored to the attempt's send/receive
        bracket.  Returns how many events the clamp had to move."""
        send_ms = seg.get("send_ms")
        recv_ms = seg.get("recv_ms")
        if send_ms is None:
            return 0
        clamped = 0
        for stream in record.get("streams", []):
            for ev in stream.get("timeline", []):
                at = send_ms + max(0.0, ev.get("start_ms", 0.0))
                dur = ev.get("dur_ms", 0.0) or 0.0
                was_clamped = False
                if recv_ms is not None:
                    if at > recv_ms:
                        at, was_clamped = recv_ms, True
                    if at + dur > recv_ms:
                        dur, was_clamped = recv_ms - at, True
                if was_clamped:
                    clamped += 1
                merged.append({
                    "at_ms": round(at, 3),
                    **({"dur_ms": round(dur, 3)} if dur else {}),
                    "source": seg["replica"],
                    "event": ev.get("name"),
                    **({"args": ev["args"]} if ev.get("args")
                       else {}),
                    **({"clamped": True} if was_clamped else {}),
                })
        return clamped

    # -- fleet observability: metrics federation -------------------------

    # Families whose fleet rollup is a plain sum (counters and the
    # cumulative histogram/summary component series); gauges get
    # sum AND min/max (a fleet-wide queue_len sum says load, the max
    # says imbalance).
    _SUM_TYPES = frozenset({"counter", "histogram", "summary"})

    def fleet_metrics_text(self) -> str:
        """``GET /fleet/metrics``: the router's own exposition, every
        replica's ``/metrics`` re-exported with a ``replica=`` label,
        and fleet ROLLUPS (``<name>_fleet{agg=...}``) — one scrape
        target for the whole tier.  A replica that fails its scrape
        is reported via ``ptpu_fleet_replica_scrape_ok{replica=}``
        and the ``fleet_scrape_errors_total`` counter; its series are
        simply absent (partial federation beats a 500)."""
        errors = 0
        fam_types: Dict[str, str] = {}
        fam_lines: "OrderedDict[str, List[str]]" = OrderedDict()
        rollup: "OrderedDict[Tuple[str, str], List[float]]" = \
            OrderedDict()
        scrape_ok: List[Tuple[str, int]] = []
        replicas = list(self.replicas)
        # Scrape the fleet CONCURRENTLY: a sequential walk pays each
        # hung replica's full timeout back to back (N x timeout on
        # the scrape path, exactly when the fleet is degraded and a
        # scraper's own timeout is ticking); the fetches are
        # independent, so one thread each, joined within the bounded
        # socket timeout they all share.
        results: List[Optional[Tuple[Optional[int], bytes]]] = \
            [None] * len(replicas)

        def scrape(i: int, replica: Replica) -> None:
            results[i] = self._http_text(replica, "GET", "/metrics")

        threads = [threading.Thread(target=scrape, args=(i, r),
                                    daemon=True,
                                    name=f"fleet-scrape-{r.id}")
                   for i, r in enumerate(replicas)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.probe_timeout_s + 1.0)
        for replica, res in zip(replicas, results):
            status, raw = res if res is not None else (None, b"")
            if status != 200 or not raw:
                errors += 1
                scrape_ok.append((replica.id, 0))
                continue
            try:
                types, samples = parse_prometheus_families(
                    raw.decode("utf-8", "replace"))
            except ValueError:
                errors += 1
                scrape_ok.append((replica.id, 0))
                continue
            scrape_ok.append((replica.id, 1))
            for name, t in types.items():
                fam_types.setdefault(name, t)
            for name, labels, value in samples:
                lab = f'replica="{replica.id}"' \
                    + (f",{labels}" if labels else "")
                fam_lines.setdefault(name, []).append(
                    f"{name}{{{lab}}} {value}")
                try:
                    rollup.setdefault((name, labels),
                                      []).append(float(value))
                except ValueError:
                    pass
        with self._stats_lock:
            self.fleet_scrapes_total += 1
            self.fleet_scrape_errors_total += errors
        # Router's own metrics AFTER the counters above so the scrape
        # that failed is already visible in the exposition it emits.
        lines = [self.metrics_text().rstrip("\n")]
        lines.append("# TYPE ptpu_fleet_replica_scrape_ok gauge")
        for rid_, ok in scrape_ok:
            lines.append(
                f'ptpu_fleet_replica_scrape_ok{{replica="{rid_}"}} '
                f'{ok}')
        for name, ls in fam_lines.items():
            t = self._family_type(name, fam_types)
            if t:
                lines.append(f"# TYPE {name} {t}")
            lines.extend(ls)
        # Fleet rollups: per distinct (family, label-set), summed
        # across replicas — and min/max spread for gauges.
        emitted_type: set = set()
        for (name, labels), values in rollup.items():
            t = self._family_type(name, fam_types)
            if t in self._SUM_TYPES:
                aggs = (("sum", sum(values)),)
            elif t == "gauge":
                aggs = (("sum", sum(values)),
                        ("min", min(values)),
                        ("max", max(values)))
            else:
                continue            # untyped: no meaningful rollup
            rname = f"{name}_fleet"
            if rname not in emitted_type:
                emitted_type.add(rname)
                lines.append(
                    f"# TYPE {rname} "
                    f"{'counter' if t in self._SUM_TYPES else 'gauge'}")
            for agg, v in aggs:
                lab = f'agg="{agg}"' + (f",{labels}" if labels
                                        else "")
                v = round(v, 6)
                lines.append(f"{rname}{{{lab}}} "
                             f"{int(v) if v == int(v) else v}")
        return "\n".join(lines) + "\n"

    @staticmethod
    def _family_type(name: str, types: Dict[str, str]
                     ) -> Optional[str]:
        """The declared TYPE for a SAMPLE name: direct hit, or the
        histogram/summary component suffixes resolved to their
        family's declaration."""
        t = types.get(name)
        if t is not None:
            return t
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix):
                return types.get(name[:-len(suffix)])
        return None

    def fleet_anomalies(self) -> Dict[str, Any]:
        """``GET /fleet/anomalies``: the router sentry's own findings
        (route pick / attempt / retry-backoff phases) merged with
        every replica's ``GET /anomalies``, ranked worst-first by
        score (observed share over baseline EWMA).  Each finding
        carries its ``source`` (``router`` or the replica id) and its
        exemplar request ids — replica exemplars resolve through
        ``GET /fleet/requests/<id>`` once prefixed back to the
        router-visible id.  A replica that fails the fetch is listed
        under ``fetch_errors`` and its findings are simply absent
        (partial forensics beats a 500, same contract as
        ``/fleet/metrics``)."""
        replicas = list(self.replicas)
        results: List[Optional[Tuple[Optional[int], Any]]] = \
            [None] * len(replicas)

        def fetch(i: int, replica: Replica) -> None:
            results[i] = self._http_json(replica, "GET", "/anomalies")

        threads = [threading.Thread(target=fetch, args=(i, r),
                                    daemon=True,
                                    name=f"fleet-anomalies-{r.id}")
                   for i, r in enumerate(replicas)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.probe_timeout_s + 1.0)
        findings: List[Dict[str, Any]] = []
        phase_share: Dict[str, Dict[str, float]] = {}
        fetch_errors: List[str] = []
        if self.forensics is not None:
            own = self.forensics.report()
            for f in own.get("findings", []):
                findings.append({"source": "router", **f})
            phase_share["router"] = own.get("phase_share", {})
        for replica, res in zip(replicas, results):
            status, body = res if res is not None else (None, None)
            if status != 200 or not isinstance(body, dict):
                fetch_errors.append(replica.id)
                continue
            for f in body.get("findings", []):
                findings.append({"source": replica.id, **f})
            share = body.get("phase_share")
            if isinstance(share, dict):
                phase_share[replica.id] = share
        findings.sort(key=lambda f: -float(f.get("score", 0.0)))
        return {"findings": findings,
                "phase_share": phase_share,
                "fetch_errors": fetch_errors,
                "replicas_polled": len(replicas)}

    # -- rolling restart -------------------------------------------------

    def fleet_restart(self) -> Dict[str, Any]:
        """``POST /fleet/restart``: drain-restart every replica, one
        at a time, never dropping the ready count below
        ``min_ready``.  Returns immediately; progress rides
        ``restart_state`` in stats()/info.  409 (RuntimeError) when
        one is already running; ValueError when the fleet has
        non-restartable replicas."""
        not_restartable = [r.id for r in self.replicas
                           if not r.restartable]
        if not_restartable:
            raise ValueError(
                f"replicas {not_restartable} are not restartable "
                f"from this router (URL replicas restart via their "
                f"orchestrator; drain them directly instead)")
        with self._restart_lock:
            if self.restart_state["in_progress"]:
                raise RuntimeError(
                    "a rolling restart is already in progress")
            self.restart_state = {
                "in_progress": True, "completed": 0,
                "rounds_total": len(self.replicas),
                "last_error": None,
                "min_ready_floor_observed": self._ready_count()}
        t = threading.Thread(target=self._rolling_restart_run,
                             daemon=True, name="fleet-restart")
        t.start()
        return dict(self.restart_state)

    def _ready_count(self) -> int:
        return sum(1 for r in self.replicas if r.up())

    def _note_ready_floor(self) -> None:
        n = self._ready_count()
        with self._restart_lock:
            floor = self.restart_state.get(
                "min_ready_floor_observed")
            if floor is None or n < floor:
                self.restart_state["min_ready_floor_observed"] = n

    def _rolling_restart_run(self) -> None:
        err = None
        try:
            for replica in list(self.replicas):
                # Gate: taking this replica out must leave min_ready
                # in rotation.
                gate_deadline = time.monotonic() + 120.0
                while self._ready_count() - (1 if replica.up()
                                             else 0) < self.min_ready:
                    if time.monotonic() > gate_deadline:
                        raise RuntimeError(
                            f"fleet never reached min_ready="
                            f"{self.min_ready}+1 before restarting "
                            f"{replica.id}")
                    time.sleep(0.05)
                replica.draining = True     # out of rotation FIRST:
                #                             new requests route away
                self._note_ready_floor()
                self._drain_replica(replica)
                # Cache half of the drain: push the drainee's prefix
                # entries to a router-chosen successor BEFORE the
                # restart flushes them.  Best-effort by contract —
                # the restart proceeds whatever happens here.
                if self.prefix_handoff_enabled:
                    self._drain_handoff(replica)
                else:
                    # No migration: the restart flushes the store the
                    # drainee's affinity bindings point at.
                    self._affinity_replace(replica.id, None)
                replica.restart()
                self._await_healthy(replica)
                replica.draining = False
                replica.health_ok = True
                replica.health_reason = None
                replica.note_success()      # fresh breaker history
                self._note_ready_floor()
                with self._restart_lock:
                    self.restart_state["completed"] += 1
                    self.restarts_completed_total += 1
        except Exception as e:
            err = f"{type(e).__name__}: {e}"
        finally:
            with self._restart_lock:
                self.restart_state["in_progress"] = False
                self.restart_state["last_error"] = err

    def _drain_replica(self, replica: Replica,
                       timeout_s: float = 120.0) -> None:
        """POST /drain (idempotent) and poll the in-flight snapshot
        to zero — the drain-aware half of the rolling restart."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            status, snap = self._http_json(replica, "POST",
                                           "/drain", body=b"")
            if status == 200 \
                    and snap.get("slots_active", 0) == 0 \
                    and snap.get("queue_len", 0) == 0:
                return
            time.sleep(0.05)
        raise RuntimeError(
            f"replica {replica.id} did not drain within "
            f"{timeout_s}s")

    def _drain_handoff(self, replica: Replica,
                       timeout_s: float = 30.0) -> None:
        """Ask a DRAINED replica to push its prefix entries to a
        successor (POST /prefix/handoff) and re-point the affinity
        map accordingly.  Every failure path is absorbed: a replica
        without the endpoint (no paged engine, older build) answers
        404 and the restart just proceeds with the seed behavior —
        a cold post-restart cache."""
        successor = None
        candidates = [r for r in self.replicas
                      if r.id != replica.id and r.eligible()]
        if candidates:
            successor = min(candidates,
                            key=lambda r: r.outstanding)
        if successor is None:
            # Nowhere to hand off (single-replica fleet, everyone
            # else down): the drainee's entries die with the
            # restart, so the affinity map must forget it.
            with self._stats_lock:
                self.kv_fleet_handoff_failed_total += 1
            self._affinity_replace(replica.id, None)
            return
        t0 = time.monotonic()
        status, raw = self._http_text(
            replica, "POST", "/prefix/handoff",
            body=json.dumps({"host": successor.host,
                             "port": successor.port}).encode(),
            timeout_s=timeout_s)
        wall_s = time.monotonic() - t0
        out: Dict[str, Any] = {}
        if status == 200:
            try:
                parsed = json.loads(raw)
                if isinstance(parsed, dict):
                    out = parsed
            except ValueError:
                pass
        sent = out.get("sent", 0) if status == 200 else 0
        # A completed handoff is a measured transfer FROM the
        # drainee: feed the link calibration EWMA (measurements
        # over defaults).
        pushed = out.get("bytes")
        if status == 200 and isinstance(pushed, int) and pushed > 0:
            replica.note_link_sample(pushed, wall_s)
        with self._stats_lock:
            self.kv_fleet_handoffs_total += 1
            if isinstance(sent, int) and sent > 0:
                self.kv_fleet_handoff_entries_total += sent
            if status != 200:
                self.kv_fleet_handoff_failed_total += 1
        # Successful push: the successor now PRIMARILY holds what
        # the drainee held, so traffic (and fetch hints) follow the
        # entries.  Anything else: drop the drainee's bindings — its
        # restart flushes the store they pointed at.
        self._affinity_replace(
            replica.id,
            successor.id if isinstance(sent, int) and sent > 0
            else None)

    def fleet_prefix_rebalance(self) -> Dict[str, Any]:
        """``POST /fleet/prefix/rebalance``: the one-copy-somewhere
        eviction pass.  Scrape every up replica's ``GET
        /prefix/index`` (stable cross-replica entry keys), find
        prefixes with REDUNDANT host-tier copies, keep the
        most-useful copy — device-tier copies always win (they are a
        replica's live working set and never evicted by hint); among
        host-tier copies the highest hit count survives — and post
        the rest back as ``/prefix/evict`` hints.  Budget freed this
        way goes back to prefixes only one replica holds, which is
        what makes the fleet's aggregate host tier worth more than N
        private ones."""
        inventory: Dict[str, List[Tuple[Replica, Dict[str, Any]]]] \
            = {}
        scraped = []
        for r in self.replicas:
            if not r.up():
                continue
            status, parsed = self._http_json(r, "GET",
                                             "/prefix/index")
            if status != 200 or not isinstance(
                    parsed.get("entries"), list):
                continue
            scraped.append(r.id)
            for ent in parsed["entries"]:
                if isinstance(ent, dict) and \
                        isinstance(ent.get("key"), str):
                    inventory.setdefault(ent["key"], []).append(
                        (r, ent))
        evict: Dict[str, List[str]] = {}   # replica id -> keys
        by_id = {r.id: r for r in self.replicas}
        for key, copies in inventory.items():
            if len(copies) < 2:
                continue
            host_copies = [(r, e) for r, e in copies
                           if e.get("tier") == "host"]
            device_held = any(e.get("tier") == "device"
                              for _, e in copies)
            if not host_copies:
                continue
            if device_held:
                doomed = host_copies
            else:
                # Keep the host copy with the most hits (stable on
                # ties: first scraped) — evict the rest.
                keep = max(host_copies,
                           key=lambda re: re[1].get("hits", 0))
                doomed = [c for c in host_copies if c is not keep]
            for r, _ in doomed:
                evict.setdefault(r.id, []).append(key)
        hinted = 0
        evicted = 0
        for rid_, keys in evict.items():
            hinted += len(keys)
            status, parsed = self._http_json(
                by_id[rid_], "POST", "/prefix/evict",
                body=json.dumps({"keys": keys}).encode())
            if status == 200:
                got = parsed.get("evicted", 0)
                if isinstance(got, int):
                    evicted += got
        with self._stats_lock:
            self.kv_fleet_rebalances_total += 1
            self.kv_fleet_evict_hints_total += hinted
        return {"replicas_scraped": scraped,
                "prefixes_seen": len(inventory),
                "duplicates": sum(
                    1 for c in inventory.values() if len(c) > 1),
                "evict_hints": hinted,
                "evicted": evicted}

    def _rebalance_due(self) -> bool:
        """Cadence gate, read off the federated ``kv_host_*``
        gauges: a rebalance pass can only move host-tier bytes, so
        it runs only while at least TWO up replicas report host-tier
        entries (one holder can't have a redundant copy; zero
        holders have nothing to move).  Keeps the idle-fleet cadence
        at one cheap /info scrape per replica instead of a full
        /prefix/index inventory."""
        holders = 0
        for r in self.replicas:
            if not r.up():
                continue
            status, parsed = self._http_json(r, "GET", "/info")
            entries = parsed.get("kv_host_entries", 0) \
                if status == 200 else 0
            if isinstance(entries, int) and entries > 0:
                holders += 1
                if holders >= 2:
                    return True
        return False

    def _rebalance_loop(self) -> None:
        """The ``--rebalance-every`` cadence thread: drive the same
        one-copy-somewhere pass an operator POST triggers, on a
        timer.  ONE-FLIGHT: the cadence and operator triggers share
        a non-blocking lock, so a slow pass is skipped, never
        stacked; failures are logged and counted, never raised (a
        broken rebalance must not take the cadence thread — or the
        router — down with it)."""
        deadline = time.monotonic() + self.rebalance_every_s
        while not self._stop:
            if time.monotonic() < deadline:
                time.sleep(0.02)
                continue
            deadline = time.monotonic() + self.rebalance_every_s
            if not self._rebalance_flight.acquire(blocking=False):
                continue
            try:
                if not self._rebalance_due():
                    continue
                with self._stats_lock:
                    self.kv_fleet_rebalance_runs_total += 1
                self.fleet_prefix_rebalance()
            except Exception as e:
                with self._stats_lock:
                    self.kv_fleet_rebalance_failed_total += 1
                logger.warning("cadenced prefix rebalance failed: "
                               "%s: %s", type(e).__name__, e)
            finally:
                self._rebalance_flight.release()

    def _await_healthy(self, replica: Replica,
                       timeout_s: float = 120.0) -> None:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            status, _ = self._http_json(replica, "GET", "/healthz")
            if status == 200:
                return
            time.sleep(0.05)
        raise RuntimeError(
            f"replica {replica.id} did not come back healthy "
            f"within {timeout_s}s of its restart")

    # -- observability ---------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """ONE dict behind /metrics and /info (the no-drift contract
        every serving counter family follows) — held STRUCTURALLY by
        tests/test_torch_fleet.py: every key here must render
        on /metrics per STATS_METRIC_RENAMES/STATS_METRIC_EXEMPT."""
        with self._stats_lock:
            counters = {
                "requests_total": self.requests_total,
                "completed_total": self.completed_total,
                "errors_total": self.errors_total,
                "shed_total": self.shed_total,
                "failovers_total": self.failovers_total,
                "resumes_total": self.resumes_total,
                "resumed_tokens_total": self.resumed_tokens_total,
                "hedges_fired_total": self.hedges_fired_total,
                "hedges_won_total": self.hedges_won_total,
                "hedges_cancelled_total": self.hedges_cancelled_total,
                "fleet_scrapes_total": self.fleet_scrapes_total,
                "fleet_scrape_errors_total":
                    self.fleet_scrape_errors_total,
                "kv_fleet_hints_injected_total":
                    self.kv_fleet_hints_injected_total,
                "kv_fleet_wire_fetches_total":
                    self.kv_fleet_wire_fetches_total,
                "kv_fleet_handoffs_total":
                    self.kv_fleet_handoffs_total,
                "kv_fleet_handoff_entries_total":
                    self.kv_fleet_handoff_entries_total,
                "kv_fleet_handoff_failed_total":
                    self.kv_fleet_handoff_failed_total,
                "kv_fleet_rebalances_total":
                    self.kv_fleet_rebalances_total,
                "kv_fleet_evict_hints_total":
                    self.kv_fleet_evict_hints_total,
                "kv_fleet_rebalance_runs_total":
                    self.kv_fleet_rebalance_runs_total,
                "kv_fleet_rebalance_failed_total":
                    self.kv_fleet_rebalance_failed_total,
                "disagg_prefills_total":
                    self.disagg_prefills_total,
                "disagg_prefill_failed_total":
                    self.disagg_prefill_failed_total,
                "disagg_handoffs_total":
                    self.disagg_handoffs_total,
                "fleet_faults_applied":
                    dict(self.fleet_faults_applied),
            }
        with self._restart_lock:
            restart = dict(self.restart_state)
            restarts_total = self.restarts_completed_total
        with self._affinity_lock:
            affinity_entries = len(self._affinity)
        probe_counts, probe_sum, probe_n = \
            self.probe_hist.snapshot()
        return {
            **counters,
            **self.budget.stats(),
            "replicas": [r.describe() for r in self.replicas],
            "replicas_ready": self._ready_count(),
            "draining": self.draining,
            "hedge": self.hedge,
            "affinity_entries": affinity_entries,
            "rolling_restart": restart,
            "rolling_restarts_completed_total": restarts_total,
            # Router-side request spans: ring occupancy/evictions
            # (GET /fleet/requests) — serving/debug.RequestHistory.
            **self.history.stats(),
            # Per-probe wall-time histogram (per-bucket counts, the
            # render_histogram shape — same idiom as the engine's
            # spec-acceptance histogram).
            "probe_duration_buckets": list(self.probe_hist.buckets),
            "probe_duration_hist": probe_counts,
            "probe_duration_sum": round(probe_sum, 6),
            "probe_duration_count": probe_n,
            **({"slo": self.slo.stats()}
               if self.slo is not None else {}),
            **({"fleet_fault_stats": self.fleet_faults.stats()}
               if self.fleet_faults is not None else {}),
        }

    def metrics_text(self) -> str:
        """Prometheus text rendered FROM stats() — the same dict
        /info returns."""
        st = self.stats()
        lines = []

        def counter(name, value):
            lines.append(f"# TYPE ptpu_router_{name} counter")
            lines.append(f"ptpu_router_{name} {value}")

        def gauge(name, value):
            lines.append(f"# TYPE ptpu_router_{name} gauge")
            lines.append(f"ptpu_router_{name} {value}")

        for k in ("requests_total", "completed_total", "errors_total",
                  "shed_total", "failovers_total", "resumes_total",
                  "resumed_tokens_total", "hedges_fired_total",
                  "hedges_won_total", "hedges_cancelled_total",
                  "retry_budget_spent_total",
                  "retry_budget_denied_total",
                  "fleet_scrapes_total",
                  "fleet_scrape_errors_total",
                  "kv_fleet_hints_injected_total",
                  "kv_fleet_wire_fetches_total",
                  "kv_fleet_handoffs_total",
                  "kv_fleet_handoff_entries_total",
                  "kv_fleet_handoff_failed_total",
                  "kv_fleet_rebalances_total",
                  "kv_fleet_evict_hints_total",
                  "kv_fleet_rebalance_runs_total",
                  "kv_fleet_rebalance_failed_total",
                  "disagg_prefills_total",
                  "disagg_prefill_failed_total",
                  "disagg_handoffs_total",
                  "request_records_total"):
            counter(k, st[k])
        counter("request_records_evicted_total",
                st["request_records_evicted"])
        gauge("retry_budget_level", st["retry_budget_level"])
        gauge("retry_budget_ratio", st["retry_budget_ratio"])
        gauge("retry_budget_burst", st["retry_budget_burst"])
        gauge("replicas", len(st["replicas"]))
        gauge("replicas_ready", st["replicas_ready"])
        gauge("draining", int(st["draining"]))
        gauge("affinity_entries", st["affinity_entries"])
        gauge("request_history", st["request_history"])
        gauge("request_records", st["request_records"])
        gauge("rolling_restart_in_progress",
              int(st["rolling_restart"]["in_progress"]))
        counter("rolling_restarts_completed_total",
                st["rolling_restarts_completed_total"])
        # Per-probe wall-time histogram, rendered by the SAME shared
        # telemetry helper as every serving histogram (satellite: a
        # slow-but-alive replica shows up here before the hedge
        # watermark trips).
        lines += render_histogram(
            "ptpu_router_probe_duration_seconds",
            st["probe_duration_buckets"], st["probe_duration_hist"],
            st["probe_duration_sum"], st["probe_duration_count"])
        # SLO layer: burn-rate / target / violation families per
        # declared objective, from the same stats() dict.
        if "slo" in st:
            slo = st["slo"]
            objectives = sorted(slo["objectives"].items())
            lines.append("# TYPE ptpu_router_slo_burn_rate gauge")
            for name, o in objectives:
                lines.append(
                    f'ptpu_router_slo_burn_rate'
                    f'{{objective="{name}"}} {o["burn_rate"]}')
            lines.append("# TYPE ptpu_router_slo_target gauge")
            for name, o in objectives:
                lines.append(
                    f'ptpu_router_slo_target'
                    f'{{objective="{name}"}} {o["target"]}')
            lines.append(
                "# TYPE ptpu_router_slo_violations_total counter")
            for name, o in objectives:
                lines.append(
                    f'ptpu_router_slo_violations_total'
                    f'{{objective="{name}"}} '
                    f'{o["violations_total"]}')
            gauge("slo_window_observations",
                  slo["window_observations"])
        lines.append("# TYPE ptpu_router_replica_up gauge")
        for r in st["replicas"]:
            lines.append(
                f'ptpu_router_replica_up{{replica="{r["id"]}"}} '
                f'{int(r["up"])}')
        lines.append("# TYPE ptpu_router_replica_outstanding gauge")
        for r in st["replicas"]:
            lines.append(
                f'ptpu_router_replica_outstanding'
                f'{{replica="{r["id"]}"}} {r["outstanding"]}')
        lines.append(
            "# TYPE ptpu_router_replica_probe_failures gauge")
        for r in st["replicas"]:
            lines.append(
                f'ptpu_router_replica_probe_failures'
                f'{{replica="{r["id"]}"}} '
                f'{r["consecutive_probe_failures"]}')
        # Most recent probe wall per replica: the labeled twin of the
        # probe-duration histogram, so the SLOW replica is nameable.
        lines.append(
            "# TYPE ptpu_router_replica_last_probe_seconds gauge")
        for r in st["replicas"]:
            if r.get("last_probe_s") is not None:
                lines.append(
                    f'ptpu_router_replica_last_probe_seconds'
                    f'{{replica="{r["id"]}"}} {r["last_probe_s"]}')
        # Estimated per-replica host-clock skew (probe-derived —
        # an ESTIMATE, not device truth): the silent stitcher
        # correction, made visible and alertable.
        lines.append(
            "# TYPE ptpu_fleet_clock_skew_seconds gauge")
        for r in st["replicas"]:
            if r.get("clock_skew_s") is not None:
                lines.append(
                    f'ptpu_fleet_clock_skew_seconds'
                    f'{{replica="{r["id"]}"}} {r["clock_skew_s"]}')
        lines.append(
            "# TYPE ptpu_router_fleet_faults_applied_total counter")
        for site, n in sorted(st["fleet_faults_applied"].items()):
            lines.append(
                f'ptpu_router_fleet_faults_applied_total'
                f'{{site="{site}"}} {n}')
        # Router-side phase forensics families
        # (serving/forensics.py): route/attempt/backoff seconds +
        # shares, and the router sentry's anomaly counter.
        if self.forensics is not None:
            lines += self.forensics.metrics_lines("ptpu_router")
        return "\n".join(lines) + "\n"

    def info(self) -> Dict[str, Any]:
        return {
            "role": "router",
            "min_ready": self.min_ready,
            "max_attempts": self.max_attempts,
            "probe_interval_s": self.probe_interval_s,
            "probe_timeout_s": self.probe_timeout_s,
            "request_timeout_s": self.request_timeout_s,
            "hedge_min_s": self.hedge_min_s,
            "affinity": self.affinity_enabled,
            "affinity_max_outstanding":
                self.affinity_max_outstanding,
            "prefix_handoff": self.prefix_handoff_enabled,
            "disagg_min_tokens": self.disagg_min_tokens,
            "rebalance_every_s": self.rebalance_every_s,
            **self.stats(),
        }


def make_router_server(host: str, port: int,
                       router: ReplicaRouter) -> ThreadingHTTPServer:
    """The router's HTTP front (``ptpu route``): /generate and
    /prefill route to replicas; /healthz answers the SAME unified
    schema the replicas do (503 ``no_replica`` when rotation is
    empty, ``draining`` once drained); /metrics + /info render
    router.stats(); POST /fleet/restart starts the rolling restart.
    Fleet observability: GET /fleet/requests[/<id>] serves the
    router's request-span ring and the cross-tier stitched timeline,
    GET /fleet/metrics federates every replica's /metrics with
    ``replica=`` labels and fleet rollups."""

    class Handler(BaseHTTPRequestHandler):
        def _req_id(self) -> str:
            rid = sanitize_request_id(
                self.headers.get("X-Request-Id"))
            self._rid = rid or new_request_id()
            return self._rid

        def _send(self, code: int, obj: Dict[str, Any]) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Request-Id",
                             getattr(self, "_rid", None)
                             or new_request_id())
            self.end_headers()
            try:
                self.wfile.write(body)
            except OSError:
                pass

        def log_message(self, fmt, *args):
            pass

        def _send_text(self, body: bytes) -> None:
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            try:
                self.wfile.write(body)
            except OSError:
                pass

        def _do_fleet_requests(self, path: str) -> None:
            """The router half of the request-debuggability surface:

            - ``GET /fleet/requests?status=&limit=`` — newest-first
              summaries from the router's terminal-record ring.
            - ``GET /fleet/requests/<id>`` — the STITCHED cross-tier
              causal timeline (router record + every involved
              replica's history record, clock-reconciled)."""
            if not router.history.enabled:
                self._send(400, {
                    "error": "router request history disabled "
                             "(start the router with "
                             "--request-history N)"})
                return
            if path in ("/fleet/requests", "/fleet/requests/"):
                q = parse_qs(urlparse(self.path).query)
                status = (q.get("status") or [None])[0]
                try:
                    limit = int((q.get("limit") or ["100"])[0])
                except ValueError:
                    self._send(400,
                               {"error": "limit must be an int"})
                    return
                self._send(200, {
                    "requests": router.history.list(status=status,
                                                    limit=limit),
                    **router.history.stats()})
                return
            want = path[len("/fleet/requests/"):]
            stitched = router.fleet_request(want)
            if stitched is None:
                self._send(404, {
                    "error": f"no router record for request "
                             f"{want!r} (never routed, or rolled "
                             f"off the "
                             f"{router.history.capacity}-record "
                             f"retention ring)"})
            else:
                self._send(200, stitched)

        def do_GET(self):
            self._req_id()
            path = urlparse(self.path).path
            if path == "/fleet/requests" \
                    or path.startswith("/fleet/requests/"):
                self._do_fleet_requests(path)
                return
            if self.path == "/healthz":
                ready = router._ready_count()
                if router.draining:
                    self._send(503, {"status": "unavailable",
                                     "reason": "draining"})
                elif ready == 0:
                    self._send(503, {"status": "unavailable",
                                     "reason": "no_replica",
                                     "replicas_ready": 0})
                else:
                    self._send(200, {"status": "ok",
                                     "role": "router",
                                     "replicas_ready": ready})
            elif self.path == "/info":
                self._send(200, router.info())
            elif self.path == "/metrics":
                self._send_text(router.metrics_text().encode())
            elif self.path == "/fleet/metrics":
                # Metrics federation: router + every replica's
                # /metrics (replica= labels) + fleet rollups, one
                # Prometheus scrape for the whole tier.
                self._send_text(router.fleet_metrics_text().encode())
            elif self.path == "/fleet/anomalies":
                # Forensics federation: router sentry findings merged
                # with every replica's /anomalies, ranked by score.
                self._send(200, router.fleet_anomalies())
            elif self.path == "/anomalies":
                if router.forensics is None:
                    self._send(400, {"error": "forensics disabled"})
                else:
                    self._send(200, router.forensics.report())
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            rid = self._req_id()
            if self.path == "/fleet/restart":
                try:
                    state = router.fleet_restart()
                    self._send(200, {"started": True, **state})
                except RuntimeError as e:
                    self._send(409, {"error": str(e)})
                except ValueError as e:
                    self._send(400, {"error": str(e)})
                return
            if self.path == "/drain":
                self._send(200, router.drain())
                return
            if self.path == "/fleet/prefix/rebalance":
                # One-copy-somewhere pass over the fleet's host
                # tiers; synchronous (scrapes + hints are bounded
                # HTTP exchanges) and idempotent.
                try:
                    self._send(200, router.fleet_prefix_rebalance())
                except Exception as e:
                    self._send(500, {
                        "error": f"{type(e).__name__}: {e}"})
                return
            if self.path not in ("/generate", "/prefill"):
                self._send(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError(
                        "request body must be a JSON object")
            except ValueError as e:
                self._send(400, {"error": f"bad JSON body: {e}"})
                return
            try:
                if self.path == "/generate":
                    code, resp = router.route_generate(req, rid=rid)
                else:
                    code, resp = router.route_prefill(req, rid=rid)
            except Exception as e:  # never kill the router thread
                code, resp = 500, {
                    "error": f"{type(e).__name__}: {e}",
                    "request_id": rid}
            self._send(code, resp)

    class _RouterHTTPServer(ThreadingHTTPServer):
        request_queue_size = 128
        daemon_threads = True

    return _RouterHTTPServer((host, port), Handler)
