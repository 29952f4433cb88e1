"""Serving telemetry core: trace spans, the engine step timeline,
and latency histograms.

The serving path's counters answer "how much?"; this module answers
"why was THIS request slow?" and "where does the engine spend its
wall-clock?" — the per-step timeline / utilization discipline
TPU-scale systems lean on (arxiv 2011.03641) with measurement kept
OFF the execution path (arxiv 2507.19017):

- :class:`Histogram` — the ONE bucketed-latency structure behind
  every ``/metrics`` histogram (queue-wait, prefill, decode-per-
  token, TTFT, total latency, spec acceptance).  Rendering lives in
  :func:`render_histogram`, so Prometheus ``_bucket{le=...}`` /
  ``_sum`` / ``_count`` exposition can never drift between metrics.
- :class:`Telemetry` — a bounded ring of Chrome trace events shared
  by ``ModelServer`` and ``DecodeEngine``.  Request streams emit
  lifecycle spans (queue -> prefill chunks -> admit -> decode ->
  complete/fail) on the REQUESTS track; engine ticks emit per-step
  records (kind, fused window, occupancy, tokens) on the ENGINE
  track.  ``GET /trace`` exports the ring as Chrome trace-event JSON
  loadable in Perfetto / chrome://tracing.

Overhead contract: recording a span is one clock read plus one
bounded-deque append under a lock (no allocation beyond the event
dict, no IO, no device sync); ``Telemetry(buffer=0)`` turns every
record call into a single attribute check, and the serving load
bench pins the tracing-on tax under ~3% aggregate tok/s
(benchmarks/bench_serving_load.py, ``telemetry_overhead``).

The port's own copy of
``polyaxon_tpu/serving/telemetry.py`` (host-only code, kept here so
the port imports nothing of the JAX package).
``ProfileSession`` (``POST /profile/*``) and the ``--trace-file`` dump
wait for the profiling slice of the port.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["Histogram", "Telemetry",
           "render_histogram", "render_compile_cache", "strip_exemplar",
           "parse_prometheus_text", "parse_prometheus_families",
           "LATENCY_BUCKETS", "PER_TOKEN_BUCKETS",
           "REQUESTS_PID", "ENGINE_PID"]

# Chrome trace "process" ids: one track group for request streams
# (one tid per stream), one for the engine step timeline.
REQUESTS_PID = 1
ENGINE_PID = 2

# Default bucket ladders (seconds).  str(bucket) must never render in
# exponent notation — the le label is compared textually by scrape
# stacks and pinned by tests — so the smallest bound is 1e-4 spelled
# as 0.0001.
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
PER_TOKEN_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                     0.01, 0.025, 0.05, 0.1, 0.25, 1.0)


class Histogram:
    """Fixed-bucket histogram: ``buckets`` are ascending upper bounds
    (``le``); observations above the last bound land in the implicit
    +Inf bucket.  ``observe`` is thread-safe and O(len(buckets)) —
    deliberately a linear scan, the ladders are short and a bisect
    would pay more in constant factor than it saves.

    ``exemplar_k > 0`` arms EXEMPLAR retention: each bucket keeps the
    last K ``(exemplar_id, value)`` pairs that landed in it (a
    bounded deque — eviction is oldest-first), so a p99 bucket
    resolves to concrete request IDs instead of an aggregate.  The
    tax when disarmed is one attribute check; armed, one deque
    append."""

    __slots__ = ("buckets", "_counts", "_sum", "_count", "_lock",
                 "exemplar_k", "_exemplars")

    def __init__(self, buckets: Sequence[float],
                 exemplar_k: int = 0):
        b = tuple(float(x) for x in buckets)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(
                f"buckets must be non-empty and strictly ascending; "
                f"got {buckets!r}")
        self.buckets = b
        self._counts = [0] * (len(b) + 1)   # [+Inf overflow last]
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()
        self.exemplar_k = int(exemplar_k)
        self._exemplars: Optional[List["deque"]] = (
            [deque(maxlen=self.exemplar_k)
             for _ in range(len(b) + 1)]
            if self.exemplar_k > 0 else None)

    def observe(self, value: float,
                exemplar: Optional[str] = None) -> None:
        v = float(value)
        i = 0
        for le in self.buckets:
            if v <= le:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if self._exemplars is not None and exemplar is not None:
                self._exemplars[i].append((exemplar, v))

    def snapshot(self) -> Tuple[List[int], float, int]:
        """(per-bucket counts incl. the +Inf overflow slot, sum,
        count) — a consistent copy."""
        with self._lock:
            return list(self._counts), self._sum, self._count

    def exemplars(self) -> List[List[Tuple[str, float]]]:
        """Per-bucket retained ``(exemplar_id, value)`` pairs,
        oldest first, +Inf last; empty lists when disarmed."""
        with self._lock:
            if self._exemplars is None:
                return [[] for _ in range(len(self.buckets) + 1)]
            return [list(d) for d in self._exemplars]


def render_histogram(name: str, buckets: Sequence[float],
                     counts: Sequence[int], total_sum,
                     count: int,
                     exemplars: Optional[Sequence[
                         Sequence[Tuple[str, float]]]] = None
                     ) -> List[str]:
    """Prometheus text exposition for one histogram: ``# TYPE``,
    CUMULATIVE ``_bucket{le=...}`` lines (ascending le, ending at
    +Inf == ``_count``), then ``_sum``/``_count``.  ``counts`` is
    per-bucket (non-cumulative) with the +Inf overflow last — the
    shape :meth:`Histogram.snapshot` returns and ``engine.stats()``
    reports, so /metrics and /info render from ONE structure.

    ``exemplars`` (optional, :meth:`Histogram.exemplars` shape)
    appends an OpenMetrics exemplar — `` # {trace_id="<id>"} <v>`` —
    to each bucket line that retained one (the most recent lands on
    the wire; the /debug/exemplars surface serves the full K).
    Omitted, the output is byte-identical to the pre-exemplar
    exposition."""
    def _ex(i: int) -> str:
        if exemplars is None or i >= len(exemplars) \
                or not exemplars[i]:
            return ""
        rid, v = exemplars[i][-1]
        return f' # {{trace_id="{rid}"}} {round(float(v), 6)}'

    lines = [f"# TYPE {name} histogram"]
    cum = 0
    for i, (le, n) in enumerate(zip(buckets, counts)):
        cum += n
        lines.append(f'{name}_bucket{{le="{le}"}} {cum}{_ex(i)}')
    if len(counts) > len(buckets):
        cum += counts[len(buckets)]
    lines.append(f'{name}_bucket{{le="+Inf"}} {cum}'
                 f"{_ex(len(buckets))}")
    lines.append(f"{name}_sum {total_sum}")
    lines.append(f"{name}_count {count}")
    return lines


def render_compile_cache(snapshot: Dict[str, Any]) -> List[str]:
    """Prometheus exposition for the recompile sentinel's counters
    (``analysis.recompile.RecompileSentinel.snapshot()``) — lives
    here so every /metrics family (histograms above, compile-cache
    counters) renders through ONE module and can never drift from
    what /info reports.  Steady-state traffic is supposed to hold
    ``misses`` flat; alert on the rate, not the level."""
    return [
        "# TYPE ptpu_serving_compile_cache_misses_total counter",
        f"ptpu_serving_compile_cache_misses_total "
        f"{snapshot['compile_cache_misses']}",
        "# TYPE ptpu_serving_compile_cache_hits_total counter",
        f"ptpu_serving_compile_cache_hits_total "
        f"{snapshot['compile_cache_hits']}",
        "# TYPE ptpu_serving_compile_cache_evictions_total counter",
        f"ptpu_serving_compile_cache_evictions_total "
        f"{snapshot['compile_cache_evictions']}",
    ]


# (telemetry key, prometheus metric name, bucket ladder) for the
# serving latency histograms — ordered, so /metrics output is stable.
HIST_SPECS = (
    # Histogram KEY namespace, not a ledger phase reference: the key
    # predates the phase enum and pins the exported metric name.
    ("queue_wait",  # ptpu: ignore[PHASE-ENUM]
     "ptpu_serving_queue_wait_seconds",
     LATENCY_BUCKETS),
    ("prefill", "ptpu_serving_prefill_phase_seconds",
     LATENCY_BUCKETS),
    ("decode_per_token", "ptpu_serving_decode_per_token_seconds",
     PER_TOKEN_BUCKETS),
    ("ttft", "ptpu_serving_ttft_seconds", LATENCY_BUCKETS),
    # Per-PRIORITY-CLASS admission-anchored TTFT (observed by the
    # engine at first admission): the interactive one is the
    # preempt-or-defer control signal (SchedulerPolicy.slo_ttft_s),
    # the batch one shows what deferral/preemption costs that class.
    ("ttft_interactive", "ptpu_serving_ttft_interactive_seconds",
     LATENCY_BUCKETS),
    ("ttft_batch", "ptpu_serving_ttft_batch_seconds",
     LATENCY_BUCKETS),
    ("total", "ptpu_serving_request_latency_seconds",
     LATENCY_BUCKETS),
)


class Telemetry:
    """Bounded, thread-safe trace ring + the latency histograms —
    ONE instance shared by the server front-end and the engine loop.

    Spans are Chrome trace events (``ph: "X"`` complete events with
    microsecond ``ts``/``dur`` relative to this instance's epoch;
    ``ph: "i"`` instants for admissions/completions).  ``buffer`` is
    the ring capacity in EVENTS (a request emits ~4 + one per prefill
    chunk); 0 disables span recording entirely — every record call
    becomes one attribute check — while the histograms stay live
    (they are the /metrics surface, and cost one lock + add each).
    """

    def __init__(self, buffer: int = 4096, exemplar_k: int = 0):
        buffer = int(buffer)
        self.enabled = buffer > 0
        self.buffer = buffer
        self.epoch = time.perf_counter()
        self._ring: "deque[Dict[str, Any]]" = deque(
            maxlen=max(1, buffer))
        self._lock = threading.Lock()
        self._tids = itertools.count(1)
        self.dropped = 0           # events pushed out of a full ring
        # exemplar_k > 0 arms per-bucket request-ID exemplars on
        # every latency histogram (the forensics layer's knob).
        self.exemplar_k = int(exemplar_k)
        self.hist: Dict[str, Histogram] = {
            key: Histogram(buckets, exemplar_k=self.exemplar_k)
            for key, _, buckets in HIST_SPECS}

    # -- ids / clock ----------------------------------------------------

    def new_tid(self) -> int:
        """Fresh trace-track id (one per request stream)."""
        return next(self._tids)

    def _us(self, t: float) -> float:
        return round((t - self.epoch) * 1e6, 1)

    # -- recording ------------------------------------------------------

    def _push(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(ev)

    def span(self, tid: int, name: str, t0: float, t1: float,
             pid: int = REQUESTS_PID, **args) -> None:
        """Complete event: phase ``name`` ran [t0, t1] (perf_counter
        seconds) on track ``tid``."""
        if not self.enabled:
            return
        self._push({"name": name, "ph": "X", "ts": self._us(t0),
                    "dur": round(max(0.0, t1 - t0) * 1e6, 1),
                    "pid": pid, "tid": tid,
                    **({"args": args} if args else {})})

    def instant(self, tid: int, name: str, t: float,
                pid: int = REQUESTS_PID, **args) -> None:
        if not self.enabled:
            return
        self._push({"name": name, "ph": "i", "s": "t",
                    "ts": self._us(t), "pid": pid, "tid": tid,
                    **({"args": args} if args else {})})

    def step(self, name: str, t0: float, t1: float, **args) -> None:
        """Engine-track step record (one per decode dispatch)."""
        self.span(0, name, t0, t1, pid=ENGINE_PID, **args)

    def observe(self, key: str, value: float,
                exemplar: Optional[str] = None) -> None:
        self.hist[key].observe(value, exemplar=exemplar)

    # -- export ---------------------------------------------------------

    def events(self) -> List[Dict[str, Any]]:
        """Snapshot of the ring, oldest first (raw event dicts — the
        --trace-file JSONL dump source)."""
        with self._lock:
            return list(self._ring)

    def chrome_trace(self) -> Dict[str, Any]:
        """The ring as a Chrome trace-event JSON object — load the
        response body directly in Perfetto or chrome://tracing."""
        meta = [
            {"name": "process_name", "ph": "M", "pid": REQUESTS_PID,
             "tid": 0, "args": {"name": "requests"}},
            {"name": "process_name", "ph": "M", "pid": ENGINE_PID,
             "tid": 0, "args": {"name": "engine"}},
        ]
        return {"traceEvents": meta + self.events(),
                "displayTimeUnit": "ms",
                **({"droppedEvents": self.dropped}
                   if self.dropped else {})}

    def metrics_lines(self) -> List[str]:
        """Prometheus exposition for every latency histogram (with
        OpenMetrics exemplar suffixes when exemplars are armed)."""
        out: List[str] = []
        for key, prom_name, _ in HIST_SPECS:
            h = self.hist[key]
            counts, s, n = h.snapshot()
            out += render_histogram(
                prom_name, h.buckets, counts, round(s, 6), n,
                exemplars=(h.exemplars() if self.exemplar_k > 0
                           else None))
        return out

    def exemplars_report(self) -> Dict[str, Any]:
        """The ``GET /debug/exemplars`` body: every histogram's
        retained per-bucket ``(request id, value)`` pairs — the full
        K per bucket, where the /metrics exposition carries only the
        most recent."""
        hists: Dict[str, Any] = {}
        for key, prom_name, _ in HIST_SPECS:
            h = self.hist[key]
            les = [str(le) for le in h.buckets] + ["+Inf"]
            buckets = []
            for le, ex in zip(les, h.exemplars()):
                if not ex:
                    continue
                buckets.append({
                    "le": le,
                    "exemplars": [
                        {"request_id": rid,
                         "value": round(float(v), 6)}
                        for rid, v in ex]})
            hists[prom_name] = {"key": key, "buckets": buckets}
        return {"exemplar_k": self.exemplar_k,
                "histograms": hists}


def strip_exemplar(line: str) -> str:
    """Drop an OpenMetrics exemplar suffix (`` # {...} <value>``)
    from a sample line, if present — both parsers below consume the
    sample itself; the exemplar surface is ``/debug/exemplars``."""
    i = line.find(" # {")
    return line[:i] if i >= 0 else line


def parse_prometheus_text(body: str) -> Dict[str, float]:
    """Tiny Prometheus text-format parser: ``{'name{labels}': value}``.
    Validates the line grammar strictly enough for tests (and for the
    trace_report tooling) — every non-comment line must be
    ``name[{labels}] value`` with a float value (an OpenMetrics
    exemplar suffix is stripped first)."""
    out: Dict[str, float] = {}
    for lineno, line in enumerate(body.splitlines(), 1):
        if not line or line.startswith("#"):
            continue
        name, _, value = strip_exemplar(line).rpartition(" ")
        if not name or any(c.isspace() for c in name):
            raise ValueError(f"line {lineno}: malformed metric line "
                             f"{line!r}")
        out[name] = float(value)   # raises on a non-numeric value
    return out


def parse_prometheus_families(body: str
                              ) -> Tuple[Dict[str, str],
                                         List[Tuple[str, str, str]]]:
    """Prometheus text split for RE-exposition (the router tier's
    ``GET /fleet/metrics`` federation): ``(types, samples)`` where
    ``types`` maps each declared family name to its ``# TYPE``, and
    ``samples`` is the ordered list of ``(name, labels, raw_value)``
    — ``labels`` is the inner label string (``''`` when unlabeled)
    and the value is kept RAW, so a federator relaying a number never
    reformats it.  Strict like :func:`parse_prometheus_text`: a
    malformed sample line or non-numeric value raises."""
    types: Dict[str, str] = {}
    samples: List[Tuple[str, str, str]] = []
    for lineno, line in enumerate(body.splitlines(), 1):
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        line = strip_exemplar(line)
        labels = ""
        if "{" in line:
            # Label VALUES may legally contain spaces — split at the
            # closing brace, not the last space (a federated replica
            # exporting reason="engine down" must not cost its whole
            # scrape).
            end = line.rfind("} ")
            i = line.find("{")
            if end < 0 or i < 0 or i > end:
                raise ValueError(f"line {lineno}: unbalanced labels "
                                 f"in {line!r}")
            name = line[:i]
            labels = line[i + 1:end]
            value = line[end + 2:].strip()
        else:
            name, _, value = line.rpartition(" ")
        if not name or any(c.isspace() for c in name):
            raise ValueError(f"line {lineno}: malformed metric line "
                             f"{line!r}")
        float(value)          # raises on a non-numeric value
        samples.append((name, labels, value))
    return types, samples


def load_trace_events(path: str) -> List[Dict[str, Any]]:
    """Read trace events from either a saved ``GET /trace`` response
    (``{"traceEvents": [...]}``) or a ``--trace-file`` JSONL dump —
    the two on-disk shapes benchmarks/trace_report.py consumes.
    Both start with ``{``, so sniff by parsing: a multi-line JSONL
    file fails the whole-document parse and falls through to
    line-by-line."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except ValueError:
        return [json.loads(line) for line in text.splitlines()
                if line.strip()]
    if isinstance(doc, dict) and isinstance(doc.get("traceEvents"),
                                            list):
        return doc["traceEvents"]
    if isinstance(doc, dict):
        return [doc]       # a one-event JSONL dump
    raise ValueError(f"{path}: neither a trace document nor JSONL")
