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

- :class:`ProfileSession` — a guarded, single-flight wrapper around
  ``torch.profiler`` (kineto) behind ``POST /profile/start|stop`` and
  the flight recorder's windows (serving/profiling.py).
- :func:`dump_spans_jsonl` — the ``serve --trace-file`` shutdown dump.

The port's own copy of
``polyaxon_tpu/serving/telemetry.py`` (host-only code, kept here so
the port imports nothing of the JAX package); ``ProfileSession`` runs
``torch.profiler`` where the reference runs ``jax.profiler``.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["Histogram", "Telemetry", "ProfileSession",
           "render_histogram", "render_compile_cache",
           "dump_spans_jsonl", "strip_exemplar",
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


# torch.profiler (kineto) holds ONE profiler per process.  Every
# ProfileSession of the process (a LocalReplica fleet runs several
# servers in one) takes this slot before it starts one.
_PROCESS_SLOT = threading.Lock()
_process_holder: Optional["ProfileSession"] = None


def _profiler_activities():
    import torch
    from torch._C._profiler import ProfilerActivity

    acts = {ProfilerActivity.CPU}
    if torch.cuda.is_available():
        acts.add(ProfilerActivity.CUDA)
    return acts


def _profiler_config(with_stack: bool):
    from torch._C._profiler import (ProfilerConfig, ProfilerState,
                                    _ExperimentalConfig)

    return ProfilerConfig(ProfilerState.KINETO, False, False,
                          bool(with_stack), False, False,
                          _ExperimentalConfig(), "")


def _torch_profiler_start(with_stack: bool) -> None:
    from torch.autograd.profiler import (_enable_profiler,
                                         _prepare_profiler)

    acts = _profiler_activities()
    _prepare_profiler(_profiler_config(with_stack), acts)
    _enable_profiler(_profiler_config(with_stack), acts)


def _torch_profiler_stop():
    from torch.autograd.profiler import _disable_profiler

    return _disable_profiler()


class _OwnThread:
    """A runner that executes every call on ONE long-lived daemon
    thread: torch's profiler must be stopped on the thread that
    started it."""

    def __init__(self):
        import queue

        self._q: "queue.Queue" = queue.Queue()
        self._t = threading.Thread(target=self._loop,
                                   name="profile-session", daemon=True)
        self._t.start()

    def _loop(self) -> None:
        while True:
            fn, box, done = self._q.get()
            try:
                box["result"] = fn()
            except BaseException as e:
                box["error"] = e
            done.set()

    def __call__(self, fn):
        box: Dict[str, Any] = {}
        done = threading.Event()
        self._q.put((fn, box, done))
        done.wait()
        if "error" in box:
            raise box["error"]
        return box.get("result")


class ProfileSession:
    """Single-flight ``torch.profiler`` wrapper: ``start`` begins a
    trace (CPU ops and, on the card, CUDA kernels, memcpys and
    memsets) that ``stop`` writes into a timestamped subdirectory of
    ``log_dir`` as ``*.pt.trace.json``; a second start while one is
    running raises (torch allows one profiler per process, so the
    guard is process-wide: another server's session holding it raises
    too).

    ``owner`` tags who holds the in-flight trace — ``"manual"`` for
    the ``POST /profile/start|stop`` endpoints, ``"recorder"`` for
    the flight recorder's periodic windows (serving/profiling.py) —
    so the two consumers share ONE session without racing: a start
    while the other side owns it raises (the HTTP surface maps that
    to 409; the recorder defers its window), and ``stop`` refuses an
    owner mismatch rather than silently ending someone else's
    trace.

    torch's profiler records the CPU ops of the thread that enables
    it.  ``runner(fn)`` runs a profiler transition where the trace
    must look — the server passes its engine's ``run_on_loop``, so a
    manual window started from an HTTP handler thread still sees the
    engine thread's ``ptpu_step`` markers; start and stop both run
    there, under the device lock.  Without a runner (engine-less
    servers) they run on a thread the session owns: the trace then
    holds the card's activity but not the request threads' CPU ops.
    Only the profiler's disable runs there at stop: the export
    (``save``) runs on the thread that called :meth:`stop`."""

    def __init__(self, log_dir: str, runner=None):
        self.log_dir = log_dir
        self.runner = runner if runner is not None else _OwnThread()
        self._lock = threading.Lock()
        self._active_dir: Optional[str] = None
        self._owner: Optional[str] = None
        self._stopping = False
        # Seconds of the last transition (chip_smoke.py reports them):
        # start, stop (the profiler's disable, on the runner's
        # thread) and export (writing the trace file).
        self.timings: Dict[str, float] = {}

    @property
    def active(self) -> bool:
        return self._active_dir is not None

    @property
    def owner(self) -> Optional[str]:
        return self._owner

    def start(self, owner: str = "manual",
              python_tracer: bool = True) -> str:
        """``python_tracer=False`` records no Python stacks
        (``with_stack``): the ops, the ``ptpu_step`` markers and the
        device activity still land in the trace, at a fraction of the
        cost — the flight recorder always passes False; the manual
        endpoints keep the full trace for interactive debugging."""
        import os

        global _process_holder
        with self._lock:
            if self._active_dir is not None:
                who = "the flight recorder" \
                    if self._owner == "recorder" else self._owner
                raise RuntimeError(
                    f"a profile is already running (owned by {who}, "
                    f"writing to {self._active_dir}); POST "
                    f"/profile/stop first")
            with _PROCESS_SLOT:
                holder = _process_holder
                if holder is not None:
                    raise RuntimeError(
                        f"a profile is already running in this process "
                        f"(another server's, writing to "
                        f"{holder._active_dir}); torch allows one "
                        f"profiler per process")
                _process_holder = self
            # Uniquify past second-granularity strftime: two
            # start/stop cycles inside one second must not share a
            # directory.
            base = os.path.join(
                self.log_dir, time.strftime("profile_%Y%m%d_%H%M%S"))
            d, n = base, 0
            while os.path.exists(d):
                n += 1
                d = f"{base}_{n}"
            # Marked active BEFORE the transition runs (outside
            # _lock: the runner may wait for the engine thread, which
            # itself starts recorder windows through this session).
            self._active_dir = d
            self._owner = owner
        try:
            os.makedirs(d)
            t0 = time.perf_counter()
            self.runner(lambda: _torch_profiler_start(python_tracer))
            self.timings["start_s"] = time.perf_counter() - t0
        except BaseException:
            with self._lock:
                self._active_dir = None
                self._owner = None
                self._release_process()
            raise
        return d

    def _release_process(self) -> None:
        global _process_holder
        with _PROCESS_SLOT:
            if _process_holder is self:
                _process_holder = None

    def stop(self, owner: str = "manual") -> str:
        import os

        with self._lock:
            if self._active_dir is None or self._stopping:
                raise RuntimeError(
                    "no profile is running; POST /profile/start "
                    "first")
            if self._owner != owner:
                who = "the flight recorder" \
                    if self._owner == "recorder" else self._owner
                raise RuntimeError(
                    f"the running profile is owned by {who}; it will "
                    f"end at its own window boundary")
            self._stopping = True
            d = self._active_dir
        # The active marker clears only AFTER the profiler stopped: a
        # failed stop leaves it owned (stop can be retried) rather
        # than wedging the process-wide profiler behind a free slot.
        try:
            t0 = time.perf_counter()
            result = self.runner(_torch_profiler_stop)
            t1 = time.perf_counter()
        except BaseException:
            with self._lock:
                self._stopping = False
            raise
        with self._lock:
            self._active_dir = None
            self._owner = None
            self._stopping = False
            self._release_process()
        result.save(os.path.join(d, f"ptpu_{os.getpid()}.pt.trace.json"))
        self.timings.update(stop_s=t1 - t0,
                            export_s=time.perf_counter() - t1)
        return d

    def close(self) -> None:
        """Best-effort end-of-life stop (server shutdown mid-trace),
        whoever owns the in-flight trace."""
        try:
            if self.active:
                self.stop(owner=self._owner or "manual")
        except Exception:
            pass


def dump_spans_jsonl(telemetry: Telemetry, path: str,
                     timeout: float = 10.0) -> int:
    """Write the telemetry ring to ``path`` as JSONL, one event per
    line, through the tracking stack's :class:`AsyncEventWriter` (the
    ``serve --trace-file`` shutdown dump).  Returns the number of
    events written."""
    from ..tracking.writer import AsyncEventWriter, JsonlFileClient

    events = telemetry.events()
    # Truncate first: JsonlFileClient appends, and a restart reusing
    # the same --trace-file would otherwise mix two Telemetry epochs
    # into one dump.
    open(path, "w").close()
    writer = AsyncEventWriter(JsonlFileClient(path))
    writer.start()
    for ev in events:
        writer.add("trace", "serving", ev)
    writer.flush(timeout=timeout)
    writer.close(timeout=timeout)
    return len(events)


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
