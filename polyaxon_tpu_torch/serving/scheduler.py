"""Scheduler policy for the continuous-batching engine.

The engine (engine.py) decouples the LOGICAL workload (a stream of
requests with arbitrary prompt lengths and token budgets) from the
PHYSICAL batch (a fixed pool of decode slots): requests wait in a
bounded admission queue, are prefilled chunk-by-chunk between decode
steps, and enter a slot at a decode-step boundary.  This module owns
the passive pieces of that design:

- :class:`RequestGroup` / :class:`Stream` — one /generate request and
  its per-row decode streams (a B-row request is B independent
  streams: decode rows never interact, so rows of one request need not
  occupy adjacent slots or even be resident together).
- :class:`SamplingSpec` — the per-request (seed, temperature, top_k,
  top_p) every stream carries into its slot; temperature 0 is greedy,
  and sampled streams draw under the position-keyed RNG contract
  (models/generate), so tokens never depend on the schedule.
- :class:`AdmissionQueue` — the bounded, PER-PRIORITY-CLASS FIFO
  between the HTTP front-end and the engine.  Submission is
  all-or-nothing per request; a full class queue raises
  :class:`QueueFullError`, which the front-end maps to 429 +
  Retry-After (explicit backpressure instead of an unbounded thread
  pile-up).  The engine pops class-aware: ``interactive`` ahead of
  ``batch`` — the "defer" half of preempt-or-defer.
- :class:`SchedulerPolicy` — the knobs: slot count, per-class queue
  depths and queue deadlines, the default prefill chunk, how much
  prefill work may run per decode boundary (1 chunk while decodes are
  active — prefill must never starve the running batch — bursting
  only when the batch is idle), and the interactive-TTFT SLO target
  that arms batch preemption.

REQUEST LIFECYCLE (the robustness layer): every request is a
first-class cancellable, deadline-bearing, prioritized object.  A
group carries an optional absolute ``deadline`` and a cancel request
(:meth:`RequestGroup.request_cancel`, set from any thread); the
engine DELIVERS both at step boundaries only — lifecycle control is
host-side scheduling, never part of a compiled step program (the
Podracer decoupled-dataflow split, arXiv:2104.06272; machine-checked
by the JIT-DEADLINE rule in analysis/rules.py).  Terminal statuses:

    queued -> prefill -> decoding -> complete
                 |           |-----> cancelled   (client went away)
                 |           |-----> expired     (deadline passed)
                 |           `-----> preempted -> requeued (resumes
                 |                   with its generated-so-far prefix)
                 `---------> shed    (cannot start before its class
                                      queue deadline, or draining)

The port's own copy of
``polyaxon_tpu/serving/scheduler.py`` (host-only code, kept here so
the port imports nothing of the JAX package).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np


class SamplingSpec:
    """Per-request sampling parameters carried by every engine stream.

    ``temperature == 0`` is greedy (the default — top_k/top_p are
    inert then, matching solo ``generate``); ``top_k=0`` / ``top_p=0``
    encode "disabled" so the whole spec vmaps into the slot step
    program as plain numbers.  ``seed`` anchors the position-keyed
    RNG contract (models/generate.sample_stream_keys): row ``r``'s
    i-th generated token is drawn with
    ``fold_in(fold_in(PRNGKey(seed), r), i)`` — a function of (seed,
    row, token index) only, never of slot id, engine step count, or
    co-tenancy — which is what makes engine output independent of the
    admission schedule.

    ``spec_k > 0`` marks the request SPECULATIVE: its slots draft
    ``spec_k`` tokens per round from the engine's draft model and
    commit a variable accepted prefix (budget accounting stays in
    COMMITTED tokens — a stream is done when ``len(out)`` reaches its
    budget, however many rounds that took).  Speculative randomness
    is position-keyed too (per-(token index, lane) keys, see
    models/generate._spec_verify_row), so co-tenancy never changes a
    speculative response either.
    """

    __slots__ = ("seed", "temperature", "top_k", "top_p", "spec_k")

    def __init__(self, seed: int = 0, temperature: float = 0.0,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 spec_k: int = 0):
        self.seed = int(seed)
        self.temperature = float(temperature)
        self.top_k = int(top_k) if top_k else 0
        self.top_p = float(top_p) if top_p else 0.0
        self.spec_k = int(spec_k) if spec_k else 0

    @property
    def sampled(self) -> bool:
        return self.temperature > 0.0

    @property
    def speculative(self) -> bool:
        return self.spec_k > 0

    def __repr__(self) -> str:  # debuggability in engine dumps
        return (f"SamplingSpec(seed={self.seed}, "
                f"temperature={self.temperature}, top_k={self.top_k}, "
                f"top_p={self.top_p}, spec_k={self.spec_k})")


GREEDY = SamplingSpec()

# Priority classes, highest first: the admission queue pops
# ``interactive`` ahead of ``batch``, and only ``batch`` residents are
# preemptible when the interactive TTFT SLO degrades.
PRIORITIES = ("interactive", "batch")


class QueueFullError(RuntimeError):
    """Admission queue at capacity: the front-end returns 429 with
    ``Retry-After: retry_after`` (seconds).  Deliberately NOT a
    ValueError — a full queue is backpressure, not a client error."""

    def __init__(self, msg: str, retry_after: int = 1):
        super().__init__(msg)
        self.retry_after = int(retry_after)


class RequestCancelled(RuntimeError):
    """Terminal status ``cancelled``: the client went away (or an
    in-process caller cancelled the group).  The engine evicts the
    request's slots at the next step boundary; the front-end maps
    this to 499 (client closed request — nobody is listening)."""


class DeadlineExceeded(RuntimeError):
    """Terminal status ``expired``: the request's deadline passed
    before it completed.  Delivered at a step boundary like a cancel
    (partial work is discarded, the slot frees); the front-end maps
    this to 504."""


class ShedError(RuntimeError):
    """Terminal status ``shed``: graceful overload — the request was
    refused or dropped WITHOUT being started (its class queue
    deadline passed before any engine attention, the server is
    draining, or a bounded front-end wait gave up on a wedged
    engine).  Maps to 503 with a structured machine-readable
    ``reason`` so clients and load balancers can tell shed classes
    apart."""

    def __init__(self, msg: str, reason: str = "overload",
                 retry_after: Optional[int] = None):
        super().__init__(msg)
        self.reason = str(reason)
        self.retry_after = retry_after


class PoisonedRequest(RuntimeError):
    """Terminal status ``poisoned``: the fault-containment layer
    isolated THIS request as the one whose computation keeps failing
    the shared decode step (quarantine bisection,
    engine._quarantine_step) and failed it alone — its co-tenants
    were requeued and resumed token-identically.  Maps to 500 with
    the machine-readable ``reason: poisoned_request`` so clients can
    tell "my request breaks the model" apart from "the server is
    broken" (which sheds 503 ``engine_down`` instead)."""

    reason = "poisoned_request"


def terminal_status(err: Optional[BaseException]) -> str:
    """Map a terminal error to the request's lifecycle status name
    (the ``status`` field on RequestGroup, span names, counters)."""
    if err is None:
        return "complete"
    if isinstance(err, ShedError):
        return "shed"
    if isinstance(err, DeadlineExceeded):
        return "expired"
    if isinstance(err, RequestCancelled):
        return "cancelled"
    if isinstance(err, PoisonedRequest):
        return "poisoned"
    return "failed"


class SchedulerPolicy:
    """Continuous-batching knobs (docs/SERVING.md).

    ``n_slots``: decode-slot pool size — the physical batch width of
    every decode step and the KV memory bound (n_slots x one full
    per-request cache).  ``queue_depth``: max ROWS waiting for a slot
    before the front-end sheds load.  ``prefill_chunk``: default
    prompt-chunk length for interleaved prefill (None = whole prompt
    in one piece; per-request ``prefill_chunk`` overrides).
    ``idle_prefill_burst``: prefill chunks per tick while NO decode is
    running (when decodes are active, exactly one chunk per step
    boundary).  ``decode_window``: max decode steps fused into one
    device dispatch when no admission could happen sooner anyway
    (engine._pick_window drops to single steps whenever a queued
    request or a possible eos eviction is in play, and never fuses
    past the earliest budget eviction — the window saves dispatch
    overhead, never scheduling granularity).  ``retry_after_s``: the
    Retry-After hint on 429s.
    """

    def __init__(self, *, n_slots: int = 8, queue_depth: int = 64,
                 prefill_chunk: Optional[int] = None,
                 idle_prefill_burst: int = 4, decode_window: int = 8,
                 retry_after_s: int = 1,
                 default_priority: str = "interactive",
                 batch_queue_depth: Optional[int] = None,
                 queue_deadline_s: Optional[float] = None,
                 batch_queue_deadline_s: Optional[float] = None,
                 slo_ttft_s: Optional[float] = None,
                 kv_paged: bool = False, kv_page_tokens: int = 64,
                 kv_pages: Optional[int] = None,
                 kv_lazy: bool = False,
                 spec_k_cap: int = 4):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1; got {n_slots}")
        if queue_depth < 1:
            raise ValueError(
                f"queue_depth must be >= 1; got {queue_depth}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1; got {prefill_chunk}")
        if decode_window < 1:
            raise ValueError(
                f"decode_window must be >= 1; got {decode_window}")
        if default_priority not in PRIORITIES:
            raise ValueError(
                f"default_priority must be one of {PRIORITIES}; "
                f"got {default_priority!r}")
        if batch_queue_depth is not None and batch_queue_depth < 1:
            raise ValueError(f"batch_queue_depth must be >= 1; got "
                             f"{batch_queue_depth}")
        for name, v in (("queue_deadline_s", queue_deadline_s),
                        ("batch_queue_deadline_s",
                         batch_queue_deadline_s),
                        ("slo_ttft_s", slo_ttft_s)):
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be > 0; got {v}")
        self.n_slots = int(n_slots)
        self.queue_depth = int(queue_depth)
        self.prefill_chunk = prefill_chunk
        self.idle_prefill_burst = max(1, int(idle_prefill_burst))
        self.decode_window = int(decode_window)
        self.retry_after_s = int(retry_after_s)
        # Lifecycle knobs: the default priority class for requests
        # that don't declare one; per-class queue depth (batch
        # defaults to the interactive depth) and queue DEADLINES (a
        # queued request with zero engine attention past its class
        # deadline is shed with 503 instead of rotting); and the
        # interactive-TTFT SLO target arming batch preemption
        # (engine._maybe_preempt — None disables preemption).
        self.default_priority = default_priority
        self.batch_queue_depth = int(batch_queue_depth) \
            if batch_queue_depth is not None else self.queue_depth
        self.queue_deadline_s = queue_deadline_s
        self.batch_queue_deadline_s = batch_queue_deadline_s
        self.slo_ttft_s = slo_ttft_s
        # Paged-KV knobs (serving/paged.py): ``kv_paged`` swaps the
        # fixed-lane slot cache for the block-table page pool;
        # ``kv_page_tokens`` is the page size in positions;
        # ``kv_pages`` the pool size in pages (None = the fixed-lane
        # footprint, n_slots x ceil(max_position / page_tokens) — the
        # equal-memory default the bench A/Bs against).
        # ``spec_k_cap`` bounds the pool's speculative draft width —
        # a spec-capable pool's verify chunks write cap+1 wide for
        # EVERY resident, so paged admission reserves that slack per
        # slot (the server passes its --spec-k here).
        if kv_page_tokens < 8:
            raise ValueError(
                f"kv_page_tokens must be >= 8; got {kv_page_tokens}")
        if kv_pages is not None and kv_pages < 1:
            raise ValueError(f"kv_pages must be >= 1; got {kv_pages}")
        if spec_k_cap < 1:
            raise ValueError(
                f"spec_k_cap must be >= 1; got {spec_k_cap}")
        # ``kv_lazy`` (the --kv-lazy knob): LAZY page reservation —
        # admission reserves prompt + one dispatch span instead of
        # the full budget, tables grow at step boundaries, and pool
        # exhaustion preempts the resident with the most remaining
        # budget (token-identical resume; serving/paged.py
        # "RESERVATION DISCIPLINE").
        if kv_lazy and not kv_paged:
            raise ValueError(
                "kv_lazy requires kv_paged (lazy growth is a page-"
                "reservation policy; fixed lanes have no pages)")
        self.kv_paged = bool(kv_paged)
        self.kv_page_tokens = int(kv_page_tokens)
        self.kv_pages = int(kv_pages) if kv_pages is not None else None
        self.kv_lazy = bool(kv_lazy)
        self.spec_k_cap = int(spec_k_cap)

    def class_queue_depth(self, priority: str) -> int:
        return self.batch_queue_depth if priority == "batch" \
            else self.queue_depth

    def class_queue_deadline(self, priority: str) -> Optional[float]:
        return self.batch_queue_deadline_s if priority == "batch" \
            else self.queue_deadline_s

    def prefill_budget(self, decodes_active: bool,
                       free_slots: int = 1) -> int:
        """Prefill chunks allowed at this step boundary.  While
        decodes run, at least one chunk per boundary (interleaved
        prefill must make progress) and up to one per FREE slot — an
        empty slot burns a full-width decode step on garbage every
        boundary it stays empty, which costs more than the prefill
        chunks that would fill it.  Idle batch: burst."""
        if not decodes_active:
            return max(self.idle_prefill_burst, free_slots)
        return max(1, free_slots)

    @staticmethod
    def pow2_pieces(n: int) -> List[int]:
        """Split ``n`` prefill tokens into DESCENDING power-of-two
        pieces (binary decomposition: 39 -> [32, 4, 2, 1]).  Used for
        preemption-resume re-prefill, whose total length varies with
        the (data-dependent) preemption point: naive one-piece
        prefill would compile a fresh program per preempted request
        forever, where pow2 pieces bound the shape set to
        ~log2(max_position) programs that go warm after the first few
        preemptions — the zero-steady-state-recompile contract held
        on the resume path (pinned in tests/test_lifecycle.py).
        Chunked prefill is position-keyed cache extension, so the
        split changes compile keys, never tokens."""
        pieces: List[int] = []
        if n <= 0:
            return pieces
        b = 1 << (n.bit_length() - 1)
        while n:
            if n >= b:
                pieces.append(b)
                n -= b
            b >>= 1
        return pieces

    def chunk_plan(self, p_len: int, req_chunk: Optional[int]
                   ) -> List[int]:
        """Split a ``p_len`` prompt into per-boundary prefill pieces.
        Chunking is position-keyed cache mechanics (models/generate
        ``_prefill``): it changes scheduling and memory, never logits.
        """
        chunk = req_chunk if req_chunk is not None else self.prefill_chunk
        if chunk is None or chunk >= p_len:
            return [p_len]
        n_full, rem = divmod(p_len, chunk)
        return [chunk] * n_full + ([rem] if rem else [])


class Stream:
    """One prompt ROW moving through the engine: queued -> prefilling
    (chunk by chunk) -> resident in a decode slot -> done."""

    __slots__ = ("group", "row", "toks", "new", "eos_id", "sampling",
                 "base_key", "pieces", "filled", "cache", "logits",
                 "out", "slot", "pf_done", "t_prefill_start",
                 "t_admit", "t_done", "d_cache", "spec_rounds",
                 "spec_drafted", "spec_accepted", "sid", "events",
                 "pf_toks", "resume", "kv_shared", "kv_epoch",
                 "last_slot", "preempts", "resumes", "blocked_t",
                 "evicted_for")

    def __init__(self, group: "RequestGroup", row: int,
                 toks: np.ndarray, new: int, eos_id: Optional[int],
                 pieces: List[int],
                 sampling: Optional[SamplingSpec] = None):
        self.group = group
        self.row = row
        self.toks = toks          # [1, p_len] int32
        # What prefill actually consumes: the prompt, or — after a
        # preemption — prompt ++ committed-tokens[:-1] (prepare_resume
        # below).  ``toks`` stays the prompt: results and prefix-cache
        # keys never see resume state.
        self.pf_toks = toks
        self.resume = False       # re-prefilling after a preemption
        self.new = new
        self.eos_id = eos_id
        self.sampling = sampling or GREEDY
        # fold_in(PRNGKey(seed), row) — materialized lazily (engine
        # _admit) so greedy streams never touch the PRNG at all
        self.base_key = None
        self.pieces = pieces      # remaining prefill piece lengths
        self.filled = 0           # prompt tokens already prefilled
        self.cache = None         # partial B=1 cache during prefill
        self.d_cache = None       # draft-model cache (spec streams)
        self.logits = None        # last-position logits once filled
        self.out: List[int] = []  # committed new tokens
        self.slot: Optional[int] = None
        self.pf_done = False      # prompt fully consumed (may still
        #                           be queued, waiting for a slot)
        self.t_prefill_start: Optional[float] = None
        self.t_admit: Optional[float] = None
        self.t_done: Optional[float] = None
        # Telemetry: trace-track id (engine assigns one per stream at
        # submit) and, when the request asked for a ``timings`` block,
        # the (name, t0, t1, args) phase tuples the response renders.
        self.sid: Optional[int] = None
        self.events: Optional[List[tuple]] = None
        # Speculative accounting (rounds consumed before the stream
        # finished; drafted/accepted feed the acceptance-rate
        # histogram at completion).
        self.spec_rounds = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        # Paged-KV: PINNED shared prefix page ids this stream will
        # map at admission (server prefix hits set it via
        # engine.submit).  The engine owns the pins from submit on —
        # insert transfers them into the slot's table, every
        # pre-admission terminal path unpins them
        # (engine._release_stream_kv).
        self.kv_shared: Optional[tuple] = None
        # Pool epoch the shared pins were taken under (paged prefix
        # hits; engine._validate_shared_epoch drops pins from a pool
        # generation that crash recovery has since rebuilt).
        self.kv_epoch: Optional[int] = None
        # Debuggability (serving/debug.py): the last slot this stream
        # occupied (``slot`` clears at eviction; the access log and
        # the history record want the id after the fact), preempt/
        # resume counts (a resumed request must be distinguishable
        # from a straight-through one in the log), and the moment the
        # stream became BLOCKED at the admission gate — on a slot, or
        # (paged) on free pages (None when not blocked; the wait span
        # in its causal timeline, closed with what unblocked it).
        self.last_slot: Optional[int] = None
        self.preempts = 0
        self.resumes = 0
        self.blocked_t: Optional[float] = None
        # Lazy-KV livelock guard (engine._ensure_lazy_growth): the
        # stream this one was exhaustion-evicted FOR.  While set, the
        # admission gate skips this stream — the freed pages must
        # reach the growth-blocked beneficiary before its own evictee
        # can take them back — and the engine clears it the moment a
        # growth pass completes (or the beneficiary goes terminal).
        self.evicted_for: Optional["Stream"] = None

    @property
    def p_len(self) -> int:
        return self.toks.shape[1]

    # ptpu: lockfree[single owner: a preempted stream is operated on by exactly one thread, ownership moves through locked queues]
    def prepare_resume(self, pieces: List[int]) -> None:
        """Reset this PREEMPTED stream for re-prefill + re-admission
        with its generated-so-far prefix, so no token is resampled.

        The cache is rebuilt by prefilling ``prompt ++ out[:-1]`` (the
        chunked-prefill exactness contract: prefill of the true
        committed prefix equals having decoded it incrementally, per
        model — the draft cache included for speculative streams);
        re-admission then feeds ``out[-1]`` at its original position
        with ``next_index == len(out)``, so token ``len(out)`` is
        drawn with exactly the position key the uninterrupted run
        would have used.  Token-identical resumption is what makes
        preemption safe under the RNG determinism contract (pinned in
        tests/test_lifecycle.py across plain/sampled/spec)."""
        assert self.out, "preempted stream with no committed tokens"
        self.resume = True
        if len(self.out) > 1:
            self.pf_toks = np.concatenate(
                [self.toks,
                 np.asarray([self.out[:-1]], np.int32)], axis=1)
        else:
            self.pf_toks = self.toks
        self.pieces = pieces
        self.filled = 0
        self.pf_done = False
        self.cache = None
        self.d_cache = None
        self.logits = None
        self.slot = None

    def done(self) -> bool:
        if len(self.out) >= self.new:
            return True
        return self.eos_id is not None and bool(self.out) \
            and self.out[-1] == self.eos_id

    def result_row(self) -> np.ndarray:
        """prompt ++ new tokens, eos-padded to the requested budget —
        exactly solo ``generate``'s eos-freeze semantics (finished rows
        keep emitting eos), so engine responses are comparable
        token-for-token with solo ones."""
        toks = list(self.out)
        if len(toks) < self.new:
            toks += [self.eos_id] * (self.new - len(toks))
        return np.concatenate(
            [self.toks[0], np.asarray(toks, np.int32)])


class RequestGroup:
    """One /generate request: B streams plus completion/timing state."""

    def __init__(self, rows: np.ndarray, new: int,
                 eos_id: Optional[int], pieces_per_row: List[int],
                 sampling: Optional[SamplingSpec] = None, *,
                 priority: str = "interactive"):
        # Request ID — the correlation key across the response header,
        # access log, trace spans, and the request-history record.
        # Set by engine.submit (inbound X-Request-Id, or generated)
        # so every group has one however it was constructed.
        self.rid: Optional[str] = None
        self.rows = rows
        self.new = new
        self.sampling = sampling or GREEDY
        if priority not in PRIORITIES:
            raise ValueError(f"priority must be one of {PRIORITIES}; "
                             f"got {priority!r}")
        self.priority = priority
        # Absolute perf_counter deadline (None = immortal), armed by
        # engine.submit RELATIVE to t_submit (there is deliberately
        # no constructor path: every deadline shares that one
        # convention).  Checked at step boundaries by the engine
        # sweep and by the front-end wait loop — never inside a
        # compiled step program.
        self.deadline: Optional[float] = None
        self.event = threading.Event()
        self.error: Optional[BaseException] = None
        # Lifecycle: a cancel/deadline/shed request lands here from
        # ANY thread (request_cancel); the engine delivers it — evict
        # slots, drop queue entries, fail the group — at its next
        # step boundary.  ``status`` is the terminal state name.
        self.cancel_error: Optional[BaseException] = None
        self.status = "active"
        # Called (with the stream) on the engine thread the moment a
        # stream's prompt is fully prefilled, before slot admission —
        # the prefix cache's store-back hook (server._store_stream_
        # prefix), so sessions grow warm without a solo detour.
        self.on_prefilled = None
        # Prefix-cache hit provenance (server prefix hits): a small
        # dict — cached token count, shared-page count — carried into
        # the request-history record so a hit's cheap TTFT is
        # attributable after the fact.
        self.prefix_info: Optional[Dict] = None
        self.results: List[Optional[np.ndarray]] = [None] * rows.shape[0]
        self._pending = rows.shape[0]
        # record_timings: the request asked for a per-phase ``timings``
        # block — streams collect their span tuples (Stream.events) as
        # the engine emits them, so the response can render the same
        # lifecycle /trace records without scanning the shared ring.
        self.record_timings = False
        self.t_submit = time.perf_counter()
        self.t_first_prefill: Optional[float] = None
        self.t_first_admit: Optional[float] = None
        self.t_last_admit: Optional[float] = None
        self.t_done: Optional[float] = None
        self.streams = [
            Stream(self, i, rows[i:i + 1], new, eos_id,
                   list(pieces_per_row), self.sampling)
            for i in range(rows.shape[0])]

    def complete_row(self, stream: Stream) -> None:
        self.results[stream.row] = stream.result_row()
        self._pending -= 1
        if self._pending == 0:
            self.t_done = time.perf_counter()
            self.status = "complete"
            self.event.set()

    def fail(self, err: BaseException) -> None:
        if not self.event.is_set():
            self.error = err
            self.t_done = time.perf_counter()
            self.status = terminal_status(err)
            self.event.set()

    def request_cancel(self, err: BaseException) -> None:
        """Ask for this group's eviction at the next step boundary
        (idempotent; the first reason wins).  Safe from any thread —
        a single reference store the engine thread reads.  Callers
        outside the engine go through :meth:`DecodeEngine.cancel`,
        which also arms the sweep's fast-path flag — a bare
        request_cancel is only guaranteed delivery when something
        else (a deadline, a queue deadline) keeps the sweep on."""
        if self.cancel_error is None and not self.event.is_set():
            # ptpu: lockfree[single reference store read by the engine sweep; first-wins race is acceptable by contract]
            self.cancel_error = err

    def status_phase(self) -> str:
        """Where this request is in its lifecycle right now — for
        error messages and the cancelled/expired span args."""
        if self.t_first_admit is not None:
            return "decoding"
        if self.t_first_prefill is not None:
            return "prefilling"
        return "queued"

    def result(self) -> np.ndarray:
        return np.stack(self.results, axis=0)

    def breakdown(self):
        """(queue_s, prefill_s, decode_s) wall-clock phase split."""
        t0 = self.t_submit
        tp = self.t_first_prefill if self.t_first_prefill is not None \
            else (self.t_done or t0)
        ta = self.t_last_admit if self.t_last_admit is not None \
            else (self.t_done or tp)
        td = self.t_done if self.t_done is not None else ta
        return max(0.0, tp - t0), max(0.0, ta - tp), max(0.0, td - ta)


class AdmissionQueue:
    """Bounded PER-CLASS FIFO of streams awaiting prefill + a slot.

    ``submit`` is atomic per request (all B streams or none) so a
    multi-row request can never deadlock half-admitted against the
    depth bound, and lands in its group's PRIORITY class queue with
    that class's own depth bound.  ``head``/``pop_head`` are
    class-aware — ``interactive`` drains before ``batch`` (the
    "defer" half of preempt-or-defer; within one class, FIFO).
    ``requeue_front`` puts a PREEMPTED stream back at the head of its
    class, bypassing the depth bound (it was already admitted once —
    requeueing must never shed it).
    """

    def __init__(self, policy: SchedulerPolicy):
        self.policy = policy
        self._q: Dict[str, "deque[Stream]"] = {
            p: deque() for p in PRIORITIES}
        self._lock = threading.Lock()
        self.rejected = 0

    def __len__(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._q.values())

    def class_len(self, priority: str) -> int:
        with self._lock:
            return len(self._q[priority])

    def submit(self, group: RequestGroup) -> None:
        n = len(group.streams)
        cls = group.priority
        depth = self.policy.class_queue_depth(cls)
        if n > depth:
            # Usage error, not backpressure: a request wider than its
            # whole class queue can never be admitted even when idle,
            # so a retryable 429 would have a well-behaved client
            # retry forever.  ValueError maps to 400 at the HTTP
            # layer.
            raise ValueError(
                f"request has {n} rows but the {cls} admission queue "
                f"holds {depth}; raise --queue-depth or split the "
                f"batch")
        with self._lock:
            if len(self._q[cls]) + n > depth:
                self.rejected += 1
                raise QueueFullError(
                    f"{cls} admission queue full ({len(self._q[cls])}"
                    f"/{depth} rows waiting); retry after "
                    f"{self.policy.retry_after_s}s",
                    retry_after=self.policy.retry_after_s)
            self._q[cls].extend(group.streams)

    def head(self) -> Optional[Stream]:
        with self._lock:
            for p in PRIORITIES:
                if self._q[p]:
                    return self._q[p][0]
            return None

    def pop_head(self) -> Optional[Stream]:
        with self._lock:
            for p in PRIORITIES:
                if self._q[p]:
                    return self._q[p].popleft()
            return None

    def pop_stream(self, stream: Stream) -> bool:
        """Remove EXACTLY ``stream`` (admission pops the stream it
        prefilled, not "whatever is head now").  With one FIFO the
        two were interchangeable; with class-aware popping, an
        interactive submit landing between the engine's ``head()``
        and its pop would CHANGE the head — popping blind would drop
        the newcomer on the floor and leave the admitted stream
        queued for a second, state-corrupting admission."""
        with self._lock:
            q = self._q[stream.group.priority]
            if q and q[0] is stream:
                q.popleft()
                return True
            try:
                q.remove(stream)
                return True
            except ValueError:
                return False

    def requeue_front(self, stream: Stream) -> None:
        with self._lock:
            self._q[stream.group.priority].appendleft(stream)

    def requeue_back(self, stream: Stream) -> None:
        """Requeue an EXHAUSTION-evicted stream at the BACK of its
        class (bypassing the depth bound, like requeue_front — it
        was already admitted once, requeueing must never shed it).
        Back, not front: the eviction freed pages for someone else
        — everyone already waiting in the class, the growth-blocked
        beneficiary included, goes first (the structural half of the
        lazy-KV livelock guard; ``Stream.evicted_for`` is the
        cross-class half)."""
        with self._lock:
            self._q[stream.group.priority].append(stream)

    def snapshot(self) -> List[Stream]:
        """Every queued stream, pop order — the lifecycle sweep's
        read-only view (cancel/deadline/shed checks)."""
        with self._lock:
            return [s for p in PRIORITIES for s in self._q[p]]

    def drop_group(self, group: RequestGroup) -> None:
        """Remove a failed group's still-queued streams."""
        with self._lock:
            q = self._q[group.priority]
            self._q[group.priority] = deque(
                s for s in q if s.group is not group)
