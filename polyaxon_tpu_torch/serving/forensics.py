"""Tail-latency forensics: the canonical phase ledger, rolling
per-phase baselines, and the anomaly sentry.

The observability stack records everything — lifecycle spans
(telemetry.py), terminal request records (debug.RequestHistory),
stitched fleet timelines (router.fleet_request) — but none of it
EXPLAINS a slow tail automatically: a p99 regression still means a
human reading Perfetto dumps.  This module is the explanation layer:

- **Phase ledger** (:func:`compute_ledger`,
  :func:`compute_router_ledger`): a closed-vocabulary decomposition
  of one request's wall time, computed from the SAME span tuples the
  history record and the ``timings`` block already carry.  The
  partition contract (docs/DESIGN.md): phases + explicit
  ``unattributed`` sum EXACTLY to the ledger's wall — internally the
  sweep works in integer microseconds, so the invariant is exact, not
  epsilon-approximate.  One shared function feeds the history record,
  the ``timings`` block, the stitched ``GET /fleet/requests/<id>``
  timeline, and the per-phase /metrics gauges — the surfaces cannot
  drift because there is only one computation.

- **Phase vocabulary**: the ``PHASE_*`` constants below are the ONLY
  legal phase names.  The PHASE-ENUM check (analysis/rules.py) flags
  phase-name string literals anywhere else in serving/, so engine,
  router, and report surfaces can never invent a divergent name.

- :class:`PhaseAccumulator` — cumulative per-phase seconds (the
  ``ptpu_serving_phase_seconds_total{phase=}`` counter family) plus
  the per-request share stream the sentry windows over.

- :class:`AnomalySentry` — rolling per-phase baselines (EWMA of
  window-mean shares + a windowed quantile band) with one-shot
  episode semantics borrowed from debug.StallWatchdog: the FIRST
  window where a phase's share breaks its band files a ranked
  finding, bumps ``ptpu_serving_anomalies_total{phase=}``, and (when
  a forensics directory is armed) writes a diagnostic bundle —
  offending exemplar timeline + state snapshot + trace tail — then
  stays quiet until the phase returns inside its band.

All host-side Python: no device work, no device import, no lock shared
with the engine step — arming forensics cannot cost a recompile and
the bench's ``forensics_overhead`` leg pins the tax under the same
~3% contract as the telemetry layer.

The port's own copy of
``polyaxon_tpu/serving/forensics.py`` (host-only code, kept here so
the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "PHASE_QUEUE_WAIT", "PHASE_DEVICE_LOCK_WAIT", "PHASE_PREFILL",
    "PHASE_ADMIT_WAIT", "PHASE_KV_WIRE_FETCH", "PHASE_KV_HANDOFF",
    "PHASE_DECODE", "PHASE_PREEMPT_GAP", "PHASE_FINALIZE",
    "PHASE_ROUTE_PICK", "PHASE_REPLICA_ATTEMPT",
    "PHASE_PREFILL_REMOTE", "PHASE_RETRY_BACKOFF",
    "PHASE_UNATTRIBUTED", "PHASES", "ROUTER_PHASES",
    "compute_ledger", "compute_router_ledger", "ledger_shares",
    "is_solo_events", "PhaseAccumulator", "AnomalySentry",
    "ForensicsCore",
]

# -- the closed phase vocabulary ---------------------------------------
#
# Replica-side phases (engine + solo paths):
PHASE_QUEUE_WAIT = "queue_wait"          # admission queue (engine)
PHASE_DEVICE_LOCK_WAIT = "device_lock_wait"  # solo-path lock wait
PHASE_PREFILL = "prefill"                # prefill chunk compute
PHASE_ADMIT_WAIT = "admit_wait"          # prefilled, waiting for a
#                                          slot / between own chunks
PHASE_KV_WIRE_FETCH = "kv_wire_fetch"    # cross-replica KV pull
PHASE_KV_HANDOFF = "kv_handoff"          # disagg prefill KV ingest
PHASE_DECODE = "decode"                  # decode residency
PHASE_PREEMPT_GAP = "preempt_gap"        # evicted, waiting to resume
PHASE_FINALIZE = "finalize"              # last event -> wall end
# Router-side phases:
PHASE_ROUTE_PICK = "route_pick"          # arrival -> first send
PHASE_REPLICA_ATTEMPT = "replica_attempt"  # send/recv bracket
PHASE_PREFILL_REMOTE = "prefill_remote"  # disagg stage-1 prefill
PHASE_RETRY_BACKOFF = "retry_backoff"    # between attempts
# Shared:
PHASE_UNATTRIBUTED = "unattributed"      # the explicit remainder

# Canonical order — ledgers, /metrics families, and reports all
# iterate THIS tuple, so exposition order is pinned.
PHASES: Tuple[str, ...] = (
    PHASE_QUEUE_WAIT, PHASE_DEVICE_LOCK_WAIT, PHASE_PREFILL,
    PHASE_ADMIT_WAIT, PHASE_KV_WIRE_FETCH, PHASE_KV_HANDOFF,
    PHASE_DECODE, PHASE_PREEMPT_GAP, PHASE_FINALIZE,
    PHASE_ROUTE_PICK, PHASE_REPLICA_ATTEMPT, PHASE_PREFILL_REMOTE,
    PHASE_RETRY_BACKOFF, PHASE_UNATTRIBUTED,
)

ROUTER_PHASES: Tuple[str, ...] = (
    PHASE_ROUTE_PICK, PHASE_REPLICA_ATTEMPT, PHASE_PREFILL_REMOTE,
    PHASE_RETRY_BACKOFF, PHASE_FINALIZE, PHASE_UNATTRIBUTED,
)

# Span name -> phase, replica side.  "queue" is context-dependent:
# on the engine path it is admission-queue wait, on the solo path it
# brackets the device-lock wait (compute_ledger's ``solo`` flag).
_SPAN_PHASES = {
    "queue": PHASE_QUEUE_WAIT,
    "prefill": PHASE_PREFILL,
    "decode": PHASE_DECODE,
    "solo_decode": PHASE_DECODE,
    "coalesce_decode": PHASE_DECODE,
    "prefix_solo": PHASE_DECODE,
    "prefix_wire_fetch": PHASE_KV_WIRE_FETCH,
    "kv_handoff": PHASE_KV_HANDOFF,
    "prefix_handoff": PHASE_KV_HANDOFF,
}

# Overlap priority (higher wins the elementary segment): the wire
# phases beat the fused solo decode span that brackets them; active
# compute (prefill) beats a concurrent sibling stream's decode
# residency; queue wait loses to everything (it brackets nothing but
# waiting).
_SPAN_PRIO = {
    PHASE_KV_WIRE_FETCH: 6, PHASE_KV_HANDOFF: 6,
    PHASE_PREFILL: 5, PHASE_DECODE: 4,
    PHASE_QUEUE_WAIT: 2, PHASE_DEVICE_LOCK_WAIT: 2,
}

_ROUTER_SPAN_PHASES = {
    "attempt": PHASE_REPLICA_ATTEMPT,
    "prefill_remote": PHASE_PREFILL_REMOTE,
}
_ROUTER_SPAN_PRIO = {
    PHASE_PREFILL_REMOTE: 5, PHASE_REPLICA_ATTEMPT: 4,
}

# Span names whose presence marks a SOLO-path event stream (no
# admission queue; the "queue" span is the device-lock wait).
_SOLO_MARKERS = frozenset(
    {"solo_decode", "coalesce_decode", "prefix_solo"})


def is_solo_events(names) -> bool:
    """True when an event-name iterable carries a solo-path marker
    span — offline consumers (trace_report) use this to pick the
    right ``solo`` flag for :func:`compute_ledger`."""
    return any(n in _SOLO_MARKERS for n in names)


def _gap_phase(prev: Optional[str], trailing: bool) -> str:
    """Classify an uncovered segment by its LEFT neighbor: after a
    prefill chunk the stream is waiting to be admitted (or for its
    next chunk's turn); after a non-final decode span it was evicted
    and is waiting to resume; the trailing gap is response finalize;
    anything else — including the leading gap, and a request with NO
    covered spans at all — stays honest as unattributed."""
    if trailing:
        return PHASE_FINALIZE if prev is not None \
            else PHASE_UNATTRIBUTED
    if prev == PHASE_PREFILL:
        return PHASE_ADMIT_WAIT
    if prev == PHASE_DECODE:
        return PHASE_PREEMPT_GAP
    return PHASE_UNATTRIBUTED


def _router_gap_phase(prev: Optional[str], trailing: bool) -> str:
    if trailing:
        return PHASE_FINALIZE if prev is not None \
            else PHASE_UNATTRIBUTED
    if prev is None or prev == PHASE_PREFILL_REMOTE:
        return PHASE_ROUTE_PICK
    if prev == PHASE_REPLICA_ATTEMPT:
        return PHASE_RETRY_BACKOFF
    return PHASE_UNATTRIBUTED


def _sweep(events, t0: float, t1: float,
           span_phases: Dict[str, str], prio: Dict[str, int],
           gap_phase: Callable[[Optional[str], bool], str],
           queue_phase: str) -> Dict[str, Any]:
    """The shared partition sweep.  ``events`` are ``(name, a, b,
    args)`` span tuples; the ledger window is ``[min(t0, earliest
    event), max(t1, latest event)]`` (caller-paid work — a prefix
    wire fetch — legally precedes submission).  Every elementary
    segment is attributed to the highest-priority covering span, or
    to a gap phase classified by its left neighbor.  Accounting is
    integer microseconds, so phases + unattributed == wall EXACTLY.
    """
    w0, w1 = float(t0), float(t1)
    intervals: List[Tuple[float, float, str]] = []
    for name, a, b, _args in events or ():
        ph = span_phases.get(name)
        if ph == PHASE_QUEUE_WAIT:
            ph = queue_phase
        if ph is None or b <= a:
            continue            # instants and foreign spans: no time
        w0 = min(w0, a)
        w1 = max(w1, b)
        intervals.append((a, b, ph))
    wall_us = max(0, round((w1 - w0) * 1e6))
    totals_us: Dict[str, int] = {}
    if wall_us:
        cuts = {0, wall_us}
        iv_us = []
        for a, b, ph in intervals:
            a_us = min(wall_us, max(0, round((a - w0) * 1e6)))
            b_us = min(wall_us, max(0, round((b - w0) * 1e6)))
            if b_us > a_us:
                iv_us.append((a_us, b_us, ph))
                cuts.add(a_us)
                cuts.add(b_us)
        edges = sorted(cuts)
        prev_cover: Optional[str] = None
        pending_gap = 0          # contiguous uncovered run, in us
        gap_left = prev_cover
        for i in range(len(edges) - 1):
            s, e = edges[i], edges[i + 1]
            cover, cover_prio = None, -1
            for a_us, b_us, ph in iv_us:
                if a_us <= s and b_us >= e:
                    p = prio.get(ph, 0)
                    if p > cover_prio:
                        cover, cover_prio = ph, p
            if cover is None:
                if pending_gap == 0:
                    gap_left = prev_cover
                pending_gap += e - s
            else:
                if pending_gap:
                    gp = gap_phase(gap_left, False)
                    totals_us[gp] = totals_us.get(gp, 0) \
                        + pending_gap
                    pending_gap = 0
                totals_us[cover] = totals_us.get(cover, 0) + (e - s)
                prev_cover = cover
        if pending_gap:
            gp = gap_phase(gap_left, True)
            totals_us[gp] = totals_us.get(gp, 0) + pending_gap
    unattr_us = totals_us.pop(PHASE_UNATTRIBUTED, 0)
    unattr_us += wall_us - (sum(totals_us.values()) + unattr_us)
    if unattr_us < 0:            # defensive: cannot happen, the
        unattr_us = 0            # sweep partitions by construction
    phases = {ph: totals_us[ph] / 1e6
              for ph in PHASES if totals_us.get(ph)}
    ledger: Dict[str, Any] = {
        "wall_s": wall_us / 1e6,
        "phases": phases,
        "unattributed": unattr_us / 1e6,
    }
    ranked = sorted(phases.items(), key=lambda kv: -kv[1])
    if ranked and ranked[0][1] >= unattr_us / 1e6:
        ledger["dominant"] = ranked[0][0]
    elif wall_us:
        ledger["dominant"] = PHASE_UNATTRIBUTED
    return ledger


def compute_ledger(events, t0: float, t1: float, *,
                   solo: bool = False) -> Dict[str, Any]:
    """The replica-side phase ledger for one request: ``events`` are
    the ``(name, a, b, args)`` span tuples a stream (or the union of
    a group's streams) collected, ``[t0, t1]`` the submit->done
    bracket.  ``solo=True`` maps the "queue" span to device-lock
    wait (the solo/coalesce paths queue on the lock, not the
    admission queue)."""
    return _sweep(events, t0, t1, _SPAN_PHASES, _SPAN_PRIO,
                  _gap_phase,
                  PHASE_DEVICE_LOCK_WAIT if solo
                  else PHASE_QUEUE_WAIT)


def compute_router_ledger(events, t0: float,
                          t1: float) -> Dict[str, Any]:
    """The router-side ledger over a request's route trace: attempt
    send/receive brackets, disagg stage-1 prefill, and the gaps
    between them (route pick, retry backoff)."""
    return _sweep(events, t0, t1, _ROUTER_SPAN_PHASES,
                  _ROUTER_SPAN_PRIO, _router_gap_phase,
                  PHASE_QUEUE_WAIT)


def ledger_shares(ledger: Dict[str, Any]) -> Dict[str, float]:
    """Per-phase share of the ledger's wall (unattributed included);
    empty when wall is zero."""
    wall = float(ledger.get("wall_s") or 0.0)
    if wall <= 0:
        return {}
    out = {ph: v / wall
           for ph, v in (ledger.get("phases") or {}).items()}
    un = float(ledger.get("unattributed") or 0.0)
    if un > 0:
        out[PHASE_UNATTRIBUTED] = un / wall
    return out


class PhaseAccumulator:
    """Cumulative per-phase seconds + wall across every noted
    request — the /metrics per-phase family source.  Thread-safe
    (noted from handler and engine threads)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._seconds: Dict[str, float] = {}
        self._wall_s = 0.0
        self.requests_total = 0

    def add(self, ledger: Dict[str, Any]) -> None:
        wall = float(ledger.get("wall_s") or 0.0)
        un = float(ledger.get("unattributed") or 0.0)
        with self._lock:
            self.requests_total += 1
            self._wall_s += wall
            for ph, v in (ledger.get("phases") or {}).items():
                self._seconds[ph] = self._seconds.get(ph, 0.0) + v
            if un:
                self._seconds[PHASE_UNATTRIBUTED] = \
                    self._seconds.get(PHASE_UNATTRIBUTED, 0.0) + un

    def totals(self) -> Dict[str, float]:
        """{phase: cumulative seconds} in canonical order."""
        with self._lock:
            return {ph: round(self._seconds[ph], 6)
                    for ph in PHASES if ph in self._seconds}

    def shares(self) -> Dict[str, float]:
        """{phase: cumulative share of total wall} — the fleet-
        rollup gauge family (a gauge, so the federation layer adds
        min/max spread across replicas)."""
        with self._lock:
            if self._wall_s <= 0:
                return {}
            return {ph: round(self._seconds[ph] / self._wall_s, 6)
                    for ph in PHASES if ph in self._seconds}

    def wall_total_s(self) -> float:
        with self._lock:
            return round(self._wall_s, 6)


class AnomalySentry:
    """Rolling per-phase share baselines + the band detector.

    Requests arrive one ledger at a time (:meth:`note`); every
    ``window`` requests close a WINDOW whose per-phase mean shares
    are compared against the baseline built from PRIOR windows —
    an EWMA of window means plus the high quantile of the retained
    window history.  A phase breaks its band when its window share
    exceeds ``max(ratio * ewma, q_hi + margin)`` AND an absolute
    floor (``min_share`` — a phase that grew from 0.1% to 0.4% of
    wall is noise, not an incident).  Detection stays disarmed until
    ``baseline_windows`` windows exist, so short steady runs can
    never false-positive.

    Episode semantics (StallWatchdog's): the first breaking window
    files ONE finding (counter bump + optional on-disk bundle); the
    episode re-arms when a later window puts the phase back inside
    its band."""

    def __init__(self, *, window: int = 64,
                 baseline_windows: int = 4,
                 history_windows: int = 32,
                 ratio: float = 2.0, margin: float = 0.1,
                 min_share: float = 0.05, alpha: float = 0.3,
                 quantile: float = 0.9,
                 max_findings: int = 32,
                 out_dir: Optional[str] = None,
                 snapshot_fn: Optional[Callable[[], Any]] = None,
                 trace_tail_fn: Optional[Callable[[], Any]] = None,
                 record_fn: Optional[
                     Callable[[str], Any]] = None):
        if window <= 0:
            raise ValueError(
                f"sentry window must be > 0; got {window}")
        self.window = int(window)
        self.baseline_windows = int(baseline_windows)
        self.ratio = float(ratio)
        self.margin = float(margin)
        self.min_share = float(min_share)
        self.alpha = float(alpha)
        self.quantile = float(quantile)
        self.out_dir = out_dir
        self.snapshot_fn = snapshot_fn
        self.trace_tail_fn = trace_tail_fn
        self.record_fn = record_fn
        self._lock = threading.Lock()
        self._cur: List[Dict[str, float]] = []
        # Worst offender per phase inside the current window:
        # {phase: (share, rid)} — the finding's exemplar.
        self._cur_worst: Dict[str, Tuple[float, Optional[str]]] = {}
        self._hist: "deque[Dict[str, float]]" = deque(
            maxlen=max(1, int(history_windows)))
        self._ewma: Dict[str, float] = {}
        self._active: set = set()      # phases inside an episode
        self.windows_closed = 0
        self.anomalies_total: Dict[str, int] = {}
        self.flagged_total = 0
        self.bundles_written = 0
        self._findings: "deque[Dict[str, Any]]" = deque(
            maxlen=max(1, int(max_findings)))

    # -- ingest ---------------------------------------------------------

    def note(self, ledger: Dict[str, Any],
             rid: Optional[str] = None) -> List[Dict[str, Any]]:
        """Feed one request's ledger; returns the findings the
        closing window produced (empty for most calls)."""
        shares = ledger_shares(ledger)
        if not shares:
            return []
        with self._lock:
            self._cur.append(shares)
            for ph, sh in shares.items():
                worst = self._cur_worst.get(ph)
                if worst is None or sh > worst[0]:
                    self._cur_worst[ph] = (sh, rid)
            if len(self._cur) < self.window:
                return []
            return self._close_window()

    def _close_window(self) -> List[Dict[str, Any]]:
        # Called under self._lock with a full window.
        n = len(self._cur)
        wmean: Dict[str, float] = {}
        for shares in self._cur:
            for ph, sh in shares.items():
                wmean[ph] = wmean.get(ph, 0.0) + sh
        wmean = {ph: v / n for ph, v in wmean.items()}
        worst = dict(self._cur_worst)
        self._cur = []
        self._cur_worst = {}
        findings: List[Dict[str, Any]] = []
        armed = self.windows_closed >= self.baseline_windows
        if armed:
            findings = self._detect(wmean, worst)
        # Baseline update AFTER detection — the offending window
        # must not vouch for itself.
        for ph, v in wmean.items():
            prev = self._ewma.get(ph)
            self._ewma[ph] = v if prev is None else \
                self.alpha * v + (1 - self.alpha) * prev
        self._hist.append(wmean)
        self.windows_closed += 1
        return findings

    def _band_hi(self, phase: str) -> float:
        vals = sorted(h.get(phase, 0.0) for h in self._hist)
        if not vals:
            return 0.0
        i = min(len(vals) - 1,
                int(self.quantile * (len(vals) - 1) + 0.999999))
        return vals[i]

    def _detect(self, wmean: Dict[str, float],
                worst: Dict[str, Tuple[float, Optional[str]]]
                ) -> List[Dict[str, Any]]:
        findings: List[Dict[str, Any]] = []
        for ph in PHASES:
            share = wmean.get(ph, 0.0)
            ewma = self._ewma.get(ph, 0.0)
            band_hi = self._band_hi(ph)
            breaking = (share >= self.min_share
                        and share > self.ratio * ewma
                        and share > band_hi + self.margin)
            if not breaking:
                self._active.discard(ph)     # re-arm the episode
                continue
            if ph in self._active:
                continue                     # one-shot per episode
            self._active.add(ph)
            self.flagged_total += 1
            self.anomalies_total[ph] = \
                self.anomalies_total.get(ph, 0) + 1
            w_share, w_rid = worst.get(ph, (share, None))
            finding = {
                "phase": ph,
                "share": round(share, 6),
                "baseline_ewma": round(ewma, 6),
                "band_hi": round(band_hi, 6),
                "score": round(share - ewma, 6),
                "window": self.windows_closed,
                "window_requests": self.window,
                "worst_share": round(w_share, 6),
                "t": round(time.time(), 3),
                **({"exemplars": [w_rid]} if w_rid else {}),
            }
            path = self._write_bundle(finding)
            if path:
                finding["bundle"] = path
            findings.append(finding)
            self._findings.append(finding)
        findings.sort(key=lambda f: -f["score"])
        return findings

    # -- the bundle -----------------------------------------------------

    def _write_bundle(self, finding: Dict[str, Any]
                      ) -> Optional[str]:
        if self.out_dir is None:
            return None
        bundle: Dict[str, Any] = {"anomaly": finding}
        if self.snapshot_fn is not None:
            try:
                bundle["state"] = self.snapshot_fn()
            except Exception as e:
                bundle["state"] = {
                    "error": f"{type(e).__name__}: {e}"}
        if self.record_fn is not None:
            recs = {}
            for rid in finding.get("exemplars", []):
                try:
                    recs[rid] = self.record_fn(rid)
                except Exception as e:
                    recs[rid] = {
                        "error": f"{type(e).__name__}: {e}"}
            if recs:
                bundle["exemplar_records"] = recs
        if self.trace_tail_fn is not None:
            try:
                bundle["trace_tail"] = self.trace_tail_fn()
            except Exception:
                bundle["trace_tail"] = []
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            path = os.path.join(
                self.out_dir,
                f"anomaly_{self.flagged_total}_{os.getpid()}.json")
            with open(path, "w") as f:
                json.dump(bundle, f, indent=1, default=str)
            self.bundles_written += 1
            return path
        except Exception:
            # A read-only disk must not kill detection — the
            # finding and the counter still surface the episode.
            import logging

            logging.getLogger(__name__).warning(
                "anomaly bundle write failed (finding kept)",
                exc_info=True)
            return None

    # -- introspection --------------------------------------------------

    def findings(self) -> List[Dict[str, Any]]:
        """Retained findings, highest score first."""
        with self._lock:
            return sorted((dict(f) for f in self._findings),
                          key=lambda f: -f.get("score", 0.0))

    def baseline(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "windows_closed": self.windows_closed,
                "window_requests": self.window,
                "armed": self.windows_closed
                >= self.baseline_windows,
                "ewma_share": {ph: round(self._ewma[ph], 6)
                               for ph in PHASES
                               if ph in self._ewma},
                "active_episodes": sorted(self._active),
            }

    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "window_requests": self.window,
                "baseline_windows": self.baseline_windows,
                "ratio": self.ratio,
                "margin": self.margin,
                "min_share": self.min_share,
                "windows_closed": self.windows_closed,
                "anomalies_total": dict(self.anomalies_total),
                "flagged_total": self.flagged_total,
                "bundles_written": self.bundles_written,
                **({"dir": self.out_dir}
                   if self.out_dir is not None else {}),
            }


class ForensicsCore:
    """One replica's (or the router's) forensics state: the phase
    accumulator + the anomaly sentry, behind a single ``note``.
    ``ModelServer`` and ``Router`` each own one; a ``None`` core is
    the whole layer's off switch (one attribute check per request —
    the same contract as the trace ring and the history ring)."""

    def __init__(self, **sentry_kwargs):
        self.accumulator = PhaseAccumulator()
        self.sentry = AnomalySentry(**sentry_kwargs)

    def note(self, ledger: Dict[str, Any],
             rid: Optional[str] = None) -> List[Dict[str, Any]]:
        self.accumulator.add(ledger)
        return self.sentry.note(ledger, rid)

    def metrics_lines(self, prefix: str) -> List[str]:
        """The per-phase /metrics families: cumulative seconds
        (counter), wall share (gauge), anomaly episodes (counter).
        TYPE lines render unconditionally — the labeled-family
        idiom, so a scraper sees the family before first traffic."""
        lines = [f"# TYPE {prefix}_phase_seconds_total counter"]
        for ph, v in self.accumulator.totals().items():
            lines.append(
                f'{prefix}_phase_seconds_total{{phase="{ph}"}} {v}')
        lines.append(f"# TYPE {prefix}_phase_share gauge")
        for ph, v in self.accumulator.shares().items():
            lines.append(
                f'{prefix}_phase_share{{phase="{ph}"}} {v}')
        lines.append(f"# TYPE {prefix}_anomalies_total counter")
        with self.sentry._lock:
            totals = dict(self.sentry.anomalies_total)
        for ph in PHASES:
            if ph in totals:
                lines.append(
                    f'{prefix}_anomalies_total{{phase="{ph}"}} '
                    f"{totals[ph]}")
        return lines

    def report(self) -> Dict[str, Any]:
        """The ``GET /anomalies`` body."""
        return {
            "findings": self.sentry.findings(),
            "baseline": self.sentry.baseline(),
            "sentry": self.sentry.status(),
            "phase_share": self.accumulator.shares(),
            "phase_seconds_total": self.accumulator.totals(),
            "requests_total": self.accumulator.requests_total,
        }
