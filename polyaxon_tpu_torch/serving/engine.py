"""Continuous-batching decode engine.

Port of ``polyaxon_tpu/serving/engine.py``: greedy and sampled streams
over the fixed-lane pool (slots.py) or the paged pool (paged.py, eager
or lazy page reservation).  STEP-LEVEL scheduling over a fixed pool of
decode slots, with the reference's gap reclamation at step
boundaries —

- a request hitting EOS (or its budget) frees its slot the same step;
- a queued request is admitted into a free slot between two decode
  steps, never after the whole running batch drains;
- long prompts prefill in bounded chunks INTERLEAVED between decode
  steps (one chunk per boundary while decodes run), and a queued prompt
  prefills ahead while every slot is busy;
- with no admission possible sooner, up to ``decode_window`` decode
  steps fuse into one device dispatch (one CUDA-graph replay).

Rows never interact and eos-evicted rows pad to budget, so a greedy
response equals solo ``generate`` on the same prompt, and a sampled
one (position-keyed: token i of row r draws with
``fold_in(fold_in(PRNGKey(seed), r), i)``) equals solo
``generate_positional``, under any admission schedule.  One sampled
resident selects the pool's sampled program; greedy co-tenants ride
its argmax lane.  Request lifecycle (priority classes, cancellation,
deadlines, per-class queue deadlines, drain) is the reference's.

PAGED pools gate admission on free pages as well as slots: a request
that can NEVER fit the pool is shed at submit (``reason: kv_pages``),
one that does not fit now waits admit-ready.  LAZY pools grow page
tables at step boundaries and, on exhaustion, preempt the resident
with the most remaining budget through the token-identical resume
path (``_evict_requeue``), with the reference's livelock bar.

PREFIX SEEDING: ``submit(prefix=(p_cached, logits, cache))`` starts a
single-row stream ``p_cached`` tokens in (a prefix-cache hit): it
prefills only its suffix, from absolute position ``p_cached`` (a RoPE
model rotates the suffix from there), or none at all.  Paged hits also
hand over PINNED full pages of the stored prefix (``shared_pages``),
which admission maps read-only into the slot's table.

FAULT CONTAINMENT (``faults``: a ``FaultPlan``, disarmed by default):
a failing decode dispatch retries in place when transient (host
positions and tokens are committed only after a dispatch succeeds, so
a retry re-arms from them), is bisected down to the one resident whose
presence keeps failing it (quarantine: that request alone fails with
``PoisonedRequest``, everyone else resumes token-identically), and
escalates to the loop's catch-all when it tracks the engine instead.
There an attached ``EngineSupervisor`` requeues everything and restarts
the loop over the SAME pools (``recover_from_crash``: host state only,
so the captured graphs stay valid); a sticky CUDA error (the context
itself is gone) instead latches the engine down — nothing can replay
on that context.  ``policy.slo_ttft_s`` arms SLO preemption of batch
residents for an admit-ready interactive head.

Threading: ``submit`` may be called from any handler thread; all slot
and queue mutation happens on the engine loop thread (or, in tests, via
manual ``tick()`` calls with the loop not started — never both).
Every CUDA call of the engine (prefill pieces, the insert copy, decode
steps) runs on that thread under ``device_lock``; the server's prefix
paths take the same lock on handler threads.

SPECULATIVE streams (``sampling.spec_k > 0``, with a ``draft_model``):
their prompt prefills through both models, and whenever one is
resident the pool steps with the speculative program (slots.py; window
K = the largest resident ``spec_k``): each spec slot commits its own
accepted prefix a round, greedy and sampled co-tenants one token, and
every draw is position-keyed per (token index, lane), so a speculative
response equals ``generate_speculative``'s seed mode (greedy: greedy
``generate``) under any co-tenancy.  A spec-capable pool leaves
``spec_k_cap`` positions of slack at every request's cache end (its
paged reservations carry it too).  Quarantine, SLO preemption and crash
recovery cover spec slots like plain ones: a resumed spec stream
re-prefills both caches.

SERVING MESH (``mesh=``: a ``ServingMesh``, a spec string such as
``"tp=2"``, or a MeshSpec; ``serving/meshed.py``): the model and the
draft are validated and PLACED over the mesh's devices before the
pools exist, and the engine runs the placed models, whose every
forward publishes its exact mesh group — so prefill pieces, steps and
spec rounds all run the reduction-free layout (meshed tokens equal
unmeshed ones bitwise on the CPU; on CUDA see ``meshed.py``).  Both slot pools split their KV by heads over
``tp`` (the fixed-lane pool's slots over ``dp`` too).  The mesh rides
the step trace args, the debug snapshot and :meth:`stats`.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.generate import _is_ring
from .debug import SnapshotBoard, events_to_dicts, new_request_id
from .faults import is_poisoned, is_transient
from .forensics import compute_ledger
from .paged import PageExhausted, PagedSlotKVManager
from .recovery import DeviceLost, RetryPolicy, is_device_lost
from .scheduler import (AdmissionQueue, DeadlineExceeded, PRIORITIES,
                        PoisonedRequest, QueueFullError, RequestCancelled,
                        RequestGroup, SamplingSpec, SchedulerPolicy,
                        ShedError, Stream, terminal_status)
from .slots import SlotKVManager, host_copy, sync_device
from .telemetry import ENGINE_PID, Histogram, Telemetry

__all__ = ["DecodeEngine", "QueueFullError", "SPEC_ACCEPT_BUCKETS"]

# Acceptance-rate histogram bucket upper bounds (le) for completed
# speculative requests; the last implicit bucket is +Inf.
SPEC_ACCEPT_BUCKETS = (0.1, 0.25, 0.5, 0.75, 0.9, 1.0)


def _host_base_key(seed: int, row: int) -> np.ndarray:
    """A stream's base key ``fold_in(PRNGKey(seed), row)``, built on
    the host: threefry gives the card's bits on the CPU, so the key the
    stream keeps costs no device sync."""
    from .. import prng

    key = prng.fold_in(prng.PRNGKey(seed), row)
    # A CPU tensor: no device to wait for.  # ptpu: ignore[HOST-SYNC]
    return key.numpy()


def _pow2_floor(n: int) -> int:
    w = 1
    while w * 2 <= n:
        w *= 2
    return w


def _kind_of(sampling: SamplingSpec) -> str:
    if sampling.speculative:
        return "speculative"
    return "sampled" if sampling.sampled else "greedy"


class DecodeEngine:
    def __init__(self, model, *,
                 policy: Optional[SchedulerPolicy] = None,
                 device_lock=None,
                 autostart: bool = True,
                 telemetry: Optional[Telemetry] = None,
                 sentinel=None, mesh=None, draft_model=None,
                 faults=None,
                 retry_policy: Optional[RetryPolicy] = None):
        if draft_model is not None \
                and draft_model.cfg.vocab_size != model.cfg.vocab_size:
            raise ValueError(
                f"draft model vocab ({draft_model.cfg.vocab_size}) must "
                f"equal the target's ({model.cfg.vocab_size})")
        self.policy = policy or SchedulerPolicy()
        # Serving mesh (module docstring): validated and placed here,
        # before the pools, so every program runs the placed weights.
        if mesh is not None:
            from .meshed import MeshedModel, ServingMesh

            if not isinstance(mesh, ServingMesh):
                mesh = ServingMesh(mesh, device_type=model.device.type)
            def placed(m, label, n_slots=None):
                """``m`` validated and placed (a server places first)."""
                if isinstance(m, MeshedModel):
                    mesh.validate_model(m.replicas[0], label,
                                        n_slots=n_slots)
                    return m
                mesh.validate_model(m, label, n_slots=n_slots)
                return mesh.place_params(m)

            model = placed(model, "model", self.policy.n_slots)
            if draft_model is not None:
                draft_model = placed(draft_model, "draft model")
        self.mesh = mesh
        self.model = model
        # Draft model: enables SPECULATIVE streams (spec_k > 0); the
        # pool holds a second cache for it.
        self.draft_model = draft_model
        # Telemetry ring shared with the owning server (request spans
        # and engine step records in ONE /trace timeline); standalone
        # engines get a disabled core.
        self.tel = telemetry if telemetry is not None \
            else Telemetry(buffer=0)
        self.device_lock = device_lock or threading.Lock()
        # Recompile sentinel: a window's CUDA-graph capture is a miss,
        # a replay a hit — the zero-steady-state-capture contract.
        if sentinel is None:
            from ..analysis.recompile import RecompileSentinel

            sentinel = RecompileSentinel(telemetry=self.tel)
        self.sentinel = sentinel
        # autostart=False: no loop thread — the owner drives tick()
        # manually (deterministic tests, offline batch use).
        self.autostart = bool(autostart)
        # KV storage: the fixed-lane stacked pool, or (kv_paged) the
        # block-table page pool.
        self.paged = bool(self.policy.kv_paged)
        max_window = _pow2_floor(self.policy.decode_window)
        # A ring model (kv_cache_ring) streams past max_position: no
        # budget check holds it there, and its lane is O(window).
        self.ring = _is_ring(model)
        if self.paged and self.ring:
            raise ValueError(
                "kv_paged needs a decoder-only model with a "
                "plain/int8 max_position cache (ring caches keep "
                "the fixed-lane manager)")
        if self.ring and draft_model is not None:
            # Every resident of a spec pool writes a verify chunk of
            # spec_k_cap + 1 positions a round and keeps one: on a ring
            # the K/V ``cap`` positions back is overwritten, which only
            # spec_k_cap - 1 spare slots keep out of the window.
            need = self.policy.spec_k_cap - 1
            for label, m in (("model", model), ("draft model",
                                                draft_model)):
                slack = getattr(m.cfg, "kv_cache_ring_slack", 0)
                if _is_ring(m) and slack < need:
                    raise ValueError(
                        f"a speculative pool over a ring cache needs "
                        f"the {label}'s kv_cache_ring_slack >= "
                        f"spec_k_cap-1 ({need}); got {slack}")
        if self.paged:
            self.slots = PagedSlotKVManager(
                model, self.policy.n_slots,
                page_tokens=self.policy.kv_page_tokens,
                n_pages=self.policy.kv_pages,
                max_position=model.cfg.max_position,
                decode_window=self.policy.decode_window,
                lazy=self.policy.kv_lazy, sentinel=sentinel,
                max_window=max_window, draft_model=draft_model,
                spec_k_cap=self.policy.spec_k_cap, mesh=mesh)
        else:
            self.slots = SlotKVManager(
                model, self.policy.n_slots, sentinel=sentinel,
                max_window=max_window, draft_model=draft_model,
                spec_k_cap=self.policy.spec_k_cap, mesh=mesh)
        # Paged page-pressure relief hook: called with a page count
        # when an admit-ready stream (or a lazy growth) is blocked on
        # free pages; the server wires it to prefix-cache LRU eviction
        # so stored-but-idle prefixes yield to live traffic.
        self.page_reclaim = None
        self.queue = AdmissionQueue(self.policy)
        # streams resident in a slot: slot index -> Stream
        self._resident: Dict[int, Stream] = {}
        self._thread: Optional[threading.Thread] = None
        self._thread_lock = threading.Lock()
        self._wake = threading.Condition()
        self._stop = False
        # counters (read unlocked by metrics — monotonic ints); admitted
        # and completed split by mode, so pool use under a mixed
        # greedy/sampled load is observable
        self.admitted_total = 0
        self.admitted_greedy_total = 0
        self.admitted_sampled_total = 0
        self.admitted_spec_total = 0
        self.evicted_total = 0
        self.decode_steps_total = 0
        self.decode_dispatches_total = 0
        self.prefill_chunks_total = 0
        self.completed_total = 0
        self.completed_greedy_total = 0
        self.completed_sampled_total = 0
        self.completed_spec_total = 0
        # Speculative rounds, drafted and accepted tokens, and the
        # per-request acceptance-rate histogram (accepted / drafted; one
        # completed request is one observation).
        self.spec_rounds_total = 0
        self.spec_drafted_total = 0
        self.spec_accepted_total = 0
        self.spec_accept = Histogram(SPEC_ACCEPT_BUCKETS)
        # Paged pools: submit-time can-never-fit sheds, lazy-growth
        # exhaustion preemptions, and the token-identical resumes they
        # cause.
        self.shed_kv_pages_total = 0
        self.kv_preempt_exhaustion_total = 0
        self.preempted_total = 0
        self.requests_requeued_total = 0
        self.resumed_total = 0
        # Exhaustion evictees still barred from re-admission.
        self._exhaust_bars: list = []
        # Request-lifecycle counters; the shed counters are also bumped
        # from submitter threads (the draining gate), under _shed_lock.
        self._shed_lock = threading.Lock()
        self.cancelled_total = 0
        self.expired_total = 0
        self.shed_total = 0
        self.shed_by_class = {p: 0 for p in PRIORITIES}
        self.admitted_by_class = {p: 0 for p in PRIORITIES}
        # SLO preemption's control signal: a SLIDING window of recent
        # interactive admission-anchored TTFTs (a cumulative histogram
        # would latch preemption after one bad period).
        self._ttft_recent: "deque[float]" = deque(maxlen=64)
        # Sweep fast path: skip the boundary sweep unless a cancel is
        # pending or deadlines are in play (sticky once armed).
        self._cancel_pending = False
        self._deadline_armed = False
        # Draining: shed new submits (503), finish everything accepted.
        self.draining = False
        self.step_device_s_total = 0.0
        self.step_wall_s_total = 0.0
        self.telemetry_errors_total = 0
        # Flight recorder (serving/profiling.py): set by the owning
        # server when --profile-every is armed.  None (the default)
        # keeps the decode loop's cost at one attribute check per
        # dispatch.
        self.recorder = None
        # Calls other threads hand to the loop thread (run_on_loop):
        # torch.profiler records the ops of the thread that starts it.
        self._loop_calls: "deque" = deque()
        # Request-scoped debuggability (serving/debug.py): the history
        # ring (wired by the server), the forensics core, and the
        # published step-boundary snapshot behind GET /debug/state.
        self.history = None
        self.forensics = None
        self.debug_board = SnapshotBoard()
        self.last_boundary_t = time.perf_counter()
        self._last_freed: Optional[Tuple] = None
        self.board_interval_s = 0.1
        self._board_t = 0.0
        # Fault tolerance: the armed FaultPlan (None: every probe site
        # is one attribute check), the bounded step-retry schedule,
        # the supervisor (set by recovery.EngineSupervisor), the
        # breaker-open latch, the quarantine suspects, and the
        # conviction streak (two convictions with no working dispatch
        # between them escalate: the fault tracks the engine).
        self.faults = faults
        self.retry_policy = retry_policy if retry_policy is not None \
            else RetryPolicy()
        self.supervisor = None
        self.down = False
        self._suspects: set = set()
        self._convictions_without_success = 0
        self.step_retries_total = 0
        self.poisoned_total = 0
        self.debug_board.publish(self.build_debug_snapshot())

    # -- submission (any thread) ----------------------------------------

    def submit(self, rows: np.ndarray, new: int,
               eos_id: Optional[int], prefill_chunk: Optional[int],
               *, sampling: Optional[SamplingSpec] = None,
               prefix=None, on_prefilled=None,
               record_timings: bool = False,
               priority: Optional[str] = None,
               deadline_s: Optional[float] = None,
               shared_pages=None,
               rid: Optional[str] = None,
               prefix_info=None,
               pre_events=None,
               resume_tokens: int = 0) -> RequestGroup:
        """Enqueue a request (may raise QueueFullError) and make sure
        the loop is running.  Returns the group; callers block on
        ``group.event``.  ``sampling`` carries the per-request (seed,
        temperature, top_k, top_p): None (or temperature 0) is greedy;
        sampled streams draw under the position-keyed contract, so
        their tokens are independent of co-tenancy.  ``priority`` picks
        the class queue (``interactive`` drains ahead of ``batch``,
        and batch residents are preemptible under the TTFT SLO);
        ``deadline_s`` (relative seconds) evicts the request at the
        next step boundary once it passes.  A DRAINING engine sheds
        every submit (503), and so does one whose crash breaker is
        open (503 ``engine_down``).

        ``prefix=(p_cached, logits, cache)`` seeds a SINGLE-ROW request
        with a stored prefill (the prefix-cache hit path): ``cache`` is
        a private contiguous B=1 cache at index ``p_cached`` (the
        stream extends it in place), so the stream prefills only its
        suffix, or nothing on a full-length hit.  ``on_prefilled``
        fires on the engine thread once the prompt is fully consumed
        (the store-back hook).  ``shared_pages`` (paged prefix hits)
        are PINNED full-page ids of the stored prefix, tagged with the
        pool epoch they were pinned under: the engine owns the pins
        from here on, maps them read-only at admission and releases
        them on any terminal path before that.  ``prefix_info`` rides
        the history record as the hit's provenance.  ``pre_events`` are
        span tuples the caller paid before submit (a fleet wire fetch),
        prepended to the stream's timeline.

        ``resume_tokens=N`` (single-row) declares the trailing N prompt
        tokens a PRIOR attempt's committed output — the cross-replica
        resume contract: the stream re-enters through the preempt-resume
        machinery (re-prefill of the original prompt plus all but the
        last committed token, re-admission feeding the last one with
        ``next_index == N``), so sampled draws continue at position key
        N, as the uninterrupted run draws them, on any replica.  ``new``
        stays the ORIGINAL budget; the group's result is the original
        prompt plus all ``new`` tokens.

        A budget past the model's ``max_position`` (prompt + new
        tokens) is refused with ValueError: no slot has positions for
        it (a ring model's session streams past it).  PAGED engines
        also shed (503 ``reason: kv_pages``) a request whose KV budget
        can NEVER fit the page pool, while one that only does not fit
        now queues until evictions free pages."""
        if priority is None:
            priority = self.policy.default_priority
        if priority not in PRIORITIES:
            raise ValueError(f"priority must be one of {PRIORITIES};"
                             f" got {priority!r}")
        if self.draining:
            with self._shed_lock:
                self.shed_total += 1
                self.shed_by_class[priority] += 1
            raise ShedError(
                "engine is draining: finishing in-flight requests, "
                "admitting none", reason="draining")
        if self.down:
            # Breaker open (recovery.py): shed fast instead of queueing
            # work a dead engine will not drain.
            with self._shed_lock:
                self.shed_total += 1
                self.shed_by_class[priority] += 1
            raise ShedError(
                "decode engine is down (crash-restart circuit breaker "
                "open); retry after the cooldown", reason="engine_down",
                retry_after=self.policy.retry_after_s)
        rows = np.asarray(rows)
        rt = int(resume_tokens or 0)
        # A resume replay carries prior output inside the prompt; the
        # slot only ever holds the original prompt plus the budget.
        p_len = rows.shape[1] - rt
        max_pos = self.model.cfg.max_position
        if not self.ring and p_len + new > max_pos:
            # Past the cache width the decode step would write and
            # embed positions no slot has (a device-side assert on the
            # card, fatal to every co-resident).
            raise ValueError(
                f"prompt ({p_len}) + max_new_tokens ({new}) exceeds "
                f"the model's max_position ({max_pos})")
        if self.draft_model is not None:
            # A spec-capable pool verifies up to spec_k_cap positions
            # past every resident's last committed token (and drafts
            # there): each request leaves that slack in both models.
            slack = self.policy.spec_k_cap - 1
            for label, m in (("model", self.model),
                             ("draft model", self.draft_model)):
                cap = m.cfg.max_position
                if _is_ring(m):
                    continue        # position-keyed (slack checked above)
                if p_len + new + slack > cap:
                    raise ValueError(
                        f"prompt ({p_len}) + max_new_tokens ({new}) + "
                        f"spec_k_cap-1 ({slack}) exceeds the {label}'s "
                        f"max_position ({cap}) (a speculative pool's "
                        f"verify chunks are {slack + 2} wide)")
        if sampling is not None and sampling.speculative:
            if self.draft_model is None:
                raise ValueError(
                    "speculative request on an engine without a "
                    "draft model")
            if sampling.spec_k > self.policy.spec_k_cap:
                # Co-tenants reserved slack for at most spec_k_cap-wide
                # verify chunks.
                raise ValueError(
                    f"spec_k {sampling.spec_k} exceeds the engine's "
                    f"spec_k_cap {self.policy.spec_k_cap}")
            if prefix is not None:
                # The stored prefix holds the TARGET's prefill only.
                raise ValueError(
                    "speculative requests cannot seed from a prefix "
                    "cache entry (the draft cache has no stored "
                    "prefill)")
        if self.paged:
            need = self._kv_tokens_needed(p_len, new)
            if need > self.slots.capacity_tokens:
                # Can NEVER fit: waiting for evictions would hang it.
                with self._shed_lock:
                    self.shed_total += 1
                    self.shed_by_class[priority] += 1
                    self.shed_kv_pages_total += 1
                raise ShedError(
                    f"request KV budget ({need} tokens/row) exceeds "
                    f"the page pool ({self.slots.capacity_tokens} "
                    f"tokens = {self.slots.n_pages} x "
                    f"{self.slots.page_tokens}-token pages); shrink "
                    f"the prompt/budget or raise --kv-pages",
                    reason="kv_pages")
        if rt:
            if prefix is not None:
                raise ValueError(
                    "resume_tokens cannot combine with a prefix-cache "
                    "seed (the replayed prefix IS the state)")
            if rows.shape[0] != 1:
                raise ValueError(
                    f"resume_tokens takes a single-row request (got "
                    f"batch {rows.shape[0]}; multi-row failover replays "
                    f"the whole request instead)")
            if p_len < 1:
                raise ValueError(
                    f"resume_tokens ({rt}) must leave at least one "
                    f"original prompt token (prompt length "
                    f"{rows.shape[1]})")
            if rt >= new:
                raise ValueError(
                    f"resume_tokens ({rt}) >= max_new_tokens ({new}): "
                    f"nothing left to generate")
            out_prev = [int(t) for t in rows[0, p_len:]]
            if eos_id is not None and eos_id in out_prev:
                raise ValueError(
                    "resume_tokens output already contains eos_id; the "
                    "request is complete — nothing to resume")
            orig = np.ascontiguousarray(rows[:, :p_len])
            group = RequestGroup(orig, new, eos_id, [], sampling,
                                 priority=priority)
            stream = group.streams[0]
            stream.out = out_prev
            stream.prepare_resume(SchedulerPolicy.pow2_pieces(
                p_len + rt - 1))
        elif prefix is None:
            pieces = self.policy.chunk_plan(p_len, prefill_chunk)
            group = RequestGroup(rows, new, eos_id, pieces, sampling,
                                 priority=priority)
        else:
            if rows.shape[0] != 1:
                raise ValueError(
                    "prefix-seeded submit takes a single-row request "
                    f"(got batch {rows.shape[0]})")
            p_cached, logits, cache = prefix
            suffix = p_len - p_cached
            pieces = self.policy.chunk_plan(suffix, prefill_chunk) \
                if suffix > 0 else []
            group = RequestGroup(rows, new, eos_id, pieces, sampling,
                                 priority=priority)
            stream = group.streams[0]
            stream.filled = p_cached
            stream.logits = logits
            stream.cache = cache
        if shared_pages:
            # The pins ride the stream until admission maps them; the
            # pool epoch rides along, so a crash-recovery rebuild in
            # between drops them by reference (_validate_shared_epoch).
            group.streams[0].kv_shared = tuple(shared_pages)
            group.streams[0].kv_epoch = getattr(shared_pages, "epoch",
                                                None)
        if deadline_s is not None:
            group.deadline = group.t_submit + float(deadline_s)
            self._deadline_armed = True
        group.rid = rid if rid is not None else new_request_id()
        if self.faults is not None:
            # request_index-keyed poisoned specs resolve to this id.
            self.faults.on_submit(group.rid)
        group.prefix_info = prefix_info
        group.on_prefilled = on_prefilled
        group.record_timings = bool(record_timings)
        # Streams collect their span tuples when a ``timings`` block,
        # the history ring or the forensics core wants them.
        keep_events = group.record_timings or (
            self.history is not None and self.history.enabled) \
            or self.forensics is not None
        for stream in group.streams:
            stream.sid = self.tel.new_tid()
            if keep_events:
                stream.events = []
        if pre_events and keep_events and group.streams:
            # Caller-paid spans (a wire fetch) lead the timeline.
            s0 = group.streams[0]
            s0.events = list(pre_events) + (s0.events or [])
        if not self._resident and len(self.queue) == 0:
            # Idle -> busy: re-stamp the progress signal.
            # ptpu: lockfree[monotonic staleness stamp: torn/lost stamps only shift stall detection by one tick]
            self.last_boundary_t = time.perf_counter()
        for stream in group.streams:
            self._emit_instant(stream, "queued", group.t_submit,
                               row=stream.row, priority=priority)
        try:
            self.queue.submit(group)      # raises when full
        except QueueFullError:
            for stream in group.streams:
                self._emit_instant(stream, "shed",
                                   time.perf_counter(),
                                   row=stream.row,
                                   reason="queue_full")
            raise
        if self.autostart:
            self._ensure_thread()
            with self._wake:
                self._wake.notify()
        return group

    def cancel(self, group: RequestGroup,
               err: Optional[BaseException] = None) -> None:
        """Request ``group``'s eviction (client disconnect, deadline,
        front-end give-up); delivered at the next step boundary."""
        group.request_cancel(err if err is not None
                             else RequestCancelled(
                                 "request cancelled"))
        # ptpu: lockfree[handoff flag: writers only store True, the engine sweep clears; next boundary re-reads]
        self._cancel_pending = True
        with self._wake:
            self._wake.notify()

    def drain(self) -> None:
        """Stop admission (new submits shed with 503 ``draining``)
        while every already-accepted request runs to completion."""
        self.draining = True

    # -- engine loop ----------------------------------------------------

    def _ensure_thread(self) -> None:
        with self._thread_lock:
            t = self._thread
            if t is not None and t.is_alive():
                if not self._stop:
                    return
                t.join(timeout=30)
                if t.is_alive():
                    raise RuntimeError(
                        "decode engine loop thread did not exit "
                        "within 30s of close(); refusing to start a "
                        "second loop over the same slot pool")
            self._stop = False
            self._thread = threading.Thread(
                target=self._loop, name="decode-engine",
                daemon=True)
            self._thread.start()

    def close(self) -> None:
        with self._thread_lock:
            self._stop = True
            with self._wake:
                self._wake.notify_all()
            t = self._thread
            if t is not None and t.is_alive():
                t.join(timeout=5)
            if t is None or not t.is_alive():
                self._fail_all(RuntimeError("decode engine closed"))

    def _fail_all(self, err: BaseException) -> None:
        """Fail every in-flight group (resident and queued) and free
        their slots — shutdown, or cleanup after a crashed tick."""
        for slot, stream in list(self._resident.items()):
            stream.group.fail(err)
            self._record_history(stream.group)
            try:
                self.slots.release(slot)
            except ValueError:
                pass
        self._resident.clear()
        while True:
            stream = self.queue.pop_head()
            if stream is None:
                break
            self._release_stream_kv(stream)
            stream.group.fail(err)
            self._record_history(stream.group)

    def run_on_loop(self, fn, timeout: float = 30.0):
        """Run ``fn`` on the engine's loop thread, under the device
        lock, and return its result (raise its exception): the loop
        takes it at the top of its next iteration, idle or not.  On
        the loop thread itself, or with no live loop thread (a
        tick()-driven engine, a closed one), it runs here; an
        autostarting engine starts its loop first.  A call the
        loop has not picked up within ``timeout`` is withdrawn and
        raises ``TimeoutError``."""
        if self.autostart and not self._stop:
            self._ensure_thread()
        t = self._thread
        if t is None or not t.is_alive() or self._stop \
                or threading.current_thread() is t:
            with self.device_lock:
                return fn()
        item = {"fn": fn, "done": threading.Event(), "state": "queued"}
        with self._wake:
            self._loop_calls.append(item)
            self._wake.notify()
        if not item["done"].wait(timeout):
            with self._wake:
                if item["state"] == "queued":
                    item["state"] = "withdrawn"
                    raise TimeoutError(
                        f"the engine loop did not take the call within "
                        f"{timeout}s")
            item["done"].wait()
        if "error" in item:
            raise item["error"]
        return item.get("result")

    def _run_loop_calls(self) -> None:
        """Run every call handed over by ``run_on_loop`` (loop thread)."""
        while self._loop_calls:
            with self._wake:
                if not self._loop_calls:
                    return
                item = self._loop_calls.popleft()
                if item["state"] != "queued":
                    continue
                item["state"] = "running"
            try:
                with self.device_lock:
                    item["result"] = item["fn"]()
            except BaseException as e:
                item["error"] = e
            item["done"].set()

    def _loop(self) -> None:
        while not self._stop:
            self._run_loop_calls()
            try:
                if self.faults is not None:
                    # Injected whole-engine death: raised HERE, past
                    # tick's containment — the supervised-restart path
                    # a real scheduling-layer crash takes.
                    self.faults.check("engine_death")
                worked = self.tick()
            except BaseException as e:
                # Device errors inside prefill/admit already failed
                # their own group; anything here is a whole-engine
                # crash.  A supervised engine recovers (requeue
                # everything, restart the loop; this thread exits); an
                # unsupervised one fails everything in flight.
                if self.supervisor is not None \
                        and self.supervisor.handle_crash(e):
                    return
                traceback.print_exc(file=sys.stderr)
                self._fail_all(
                    RuntimeError(f"decode engine error: "
                                 f"{type(e).__name__}: {e}"))
                worked = False
            if worked and self.supervisor is not None:
                self.supervisor.note_progress()
            if not worked:
                with self._wake:
                    if self._stop:
                        break
                    if not self._loop_calls:
                        self._wake.wait(timeout=0.05)
        self._run_loop_calls()
        self._fail_all(RuntimeError("decode engine closed"))

    def _restart_loop(self) -> bool:
        """Start a REPLACEMENT loop thread after supervised crash
        recovery (called on the dying loop thread, which exits right
        after).  False when the engine was closed mid-recovery."""
        with self._thread_lock:
            if self._stop:
                return False
            self._thread = threading.Thread(
                target=self._loop, name="decode-engine", daemon=True)
            self._thread.start()
            return True

    # -- one scheduling round -------------------------------------------

    def tick(self) -> bool:
        """One step boundary: deliver pending lifecycle events, preempt
        a batch resident if the interactive TTFT SLO demands it,
        admit/prefill within the policy budget, then one decode window
        over the resident batch.  Returns whether any work was done."""
        worked = self._sweep_lifecycle()
        if self._maybe_preempt():
            worked = True
        budget = self.policy.prefill_budget(bool(self._resident),
                                            self.slots.free_slots)
        while budget > 0:
            stream = self._queue_head()
            if stream is None:
                break
            if stream.group.error is not None:
                self.queue.drop_group(stream.group)
                continue
            if stream.pf_done and not self._can_admit_stream(stream):
                # Prefilled, waiting on a slot or pages.
                self._note_blocked(stream)
                break
            self._advance_prefill(stream)
            worked = True
            budget -= 1
        if self._resident:
            self._decode_step()
            worked = True
        now = time.perf_counter()
        if worked:
            self.last_boundary_t = now
        if now - self._board_t >= self.board_interval_s:
            self._board_t = now
            self.debug_board.publish(self.build_debug_snapshot())
        return worked

    # -- admission gates -------------------------------------------------

    def _kv_tokens_needed(self, p_len: int, new: int) -> int:
        """A stream's FULL KV reservation: prompt + budget, plus the
        speculative write slack every co-tenant of a spec-capable pool
        leaves (a round's verify chunk writes up to spec_k_cap
        positions past the last committed token, for every
        resident)."""
        slack = self.policy.spec_k_cap \
            if self.draft_model is not None else 0
        return p_len + new + slack

    def _kv_admit_tokens(self, stream: Stream) -> int:
        """The token span admission must have pages for: the full
        budget, or (lazy) the stream's current committed length plus
        one dispatch span (``PagedSlotKVManager.admit_tokens``)."""
        need = self._kv_tokens_needed(stream.p_len, stream.new)
        if self.paged and self.slots.lazy:
            return self.slots.admit_tokens(
                stream.p_len + max(1, len(stream.out)), need)
        return need

    def _stream_barred(self, stream: Stream) -> bool:
        """Lazy-KV livelock guard: an exhaustion evictee is not
        admissible while the stream it was evicted for still waits for
        the freed pages.  The bar is cleared by the next growth pass
        that needs no eviction, when the beneficiary goes terminal, or
        when no resident is left (nothing can be growing)."""
        b = stream.evicted_for
        if b is None:
            return False
        if b.group.event.is_set() or not self._resident:
            stream.evicted_for = None
            return False
        return True

    def _queue_head(self) -> Optional[Stream]:
        """The class-aware queue head, SKIPPING barred streams: a
        barred evictee never blocks the stream it was evicted for."""
        head = self.queue.head()
        if head is None or not self._stream_barred(head):
            return head
        for s in self.queue.snapshot():
            if not self._stream_barred(s):
                return s
        return None

    def _validate_shared_epoch(self, stream: Stream) -> None:
        """Drop shared prefix pins taken under a page-pool generation
        that crash recovery has since rebuilt: the ids mean nothing in
        the fresh accounting (never unpin them into it), and the
        stream's own materialized prefill makes admission without the
        sharing token-identical.  Engine thread only."""
        if stream.kv_shared and stream.kv_epoch is not None \
                and stream.kv_epoch != getattr(self.slots, "epoch",
                                               None):
            stream.kv_shared = None
            stream.kv_epoch = None

    def _admissible_now(self, stream: Stream) -> bool:
        """Pure check (``_pick_window`` calls it every boundary): a
        free slot AND, paged, enough free pages for the stream's
        reservation net of its shared prefix pages (and, lazy, no
        exhaustion bar)."""
        self._validate_shared_epoch(stream)
        if self._stream_barred(stream):
            return False
        if self.slots.free_slots == 0:
            return False
        if not self.paged:
            return True
        return self.slots.can_admit(self._kv_admit_tokens(stream),
                                    len(stream.kv_shared or ()))

    def _can_admit_stream(self, stream: Stream) -> bool:
        """The admission gate: ``_admissible_now``, and when pages are
        the blocker, ask the owner's reclaim hook (prefix-cache LRU
        eviction) to free the stream's whole page need first —
        stored-but-idle prefixes must never starve live traffic."""
        if self._admissible_now(stream):
            return True
        if self._stream_barred(stream) or self.slots.free_slots == 0 \
                or not self.paged or self.page_reclaim is None:
            return False
        need = self._kv_admit_tokens(stream)
        n_shared = len(stream.kv_shared or ())
        try:
            self.page_reclaim(self.slots.pages_needed(need) - n_shared)
        except Exception:
            import logging

            logging.getLogger(__name__).debug(
                "page_reclaim hook failed", exc_info=True)
        ok = self.slots.can_admit(need, n_shared)
        if ok:
            self._last_freed = (None, "prefix_reclaim")
        return ok

    def _release_stream_kv(self, stream: Stream) -> None:
        """Release a stream's still-PINNED shared prefix pages (set at
        submit, consumed at admission) on every terminal path that can
        fire before the pins move into a slot table.  Epoch-guarded:
        pins of a rebuilt pool generation drop by reference."""
        ids = stream.kv_shared
        if ids:
            stream.kv_shared = None
            try:
                self.slots.unpin(ids, epoch=stream.kv_epoch)
            except Exception:
                import logging

                logging.getLogger(__name__).debug(
                    "shared-page release failed", exc_info=True)

    def _note_blocked(self, stream: Stream) -> None:
        """First boundary a fully-prefilled head could not admit: open
        its wait in the causal timeline (one instant per episode)."""
        if stream.blocked_t is not None:
            return
        now = time.perf_counter()
        stream.blocked_t = now
        self._emit_instant(stream, "admit_blocked", now,
                           row=stream.row, on="slot")

    def _note_freed(self, stream: Stream, why: str) -> None:
        self._last_freed = (stream.group.rid, why)

    # -- lifecycle: cancel / deadline / shed -----------------------------

    def _sweep_lifecycle(self) -> bool:
        """Deliver every pending cancel and expired deadline (resident
        and queued streams), and shed queued requests past their class
        queue deadline with no engine attention yet."""
        if not (self._cancel_pending or self._deadline_armed
                or self.policy.queue_deadline_s is not None
                or self.policy.batch_queue_deadline_s is not None):
            return False
        self._cancel_pending = False
        now = time.perf_counter()
        handled = set()
        worked = False
        for stream in ([s for s in self._resident.values()]
                       + self.queue.snapshot()):
            group = stream.group
            if id(group) in handled or group.error is not None:
                continue
            err = group.cancel_error
            if err is None and group.deadline is not None \
                    and now > group.deadline:
                err = DeadlineExceeded(
                    f"deadline exceeded after "
                    f"{now - group.t_submit:.3f}s "
                    f"({group.status_phase()})")
                group.request_cancel(err)
            if err is None and group.t_first_prefill is None \
                    and stream.slot is None:
                qd = self.policy.class_queue_deadline(group.priority)
                if qd is not None and now - group.t_submit > qd:
                    err = ShedError(
                        f"{group.priority} request queued "
                        f"{now - group.t_submit:.3f}s without "
                        f"starting (class queue deadline {qd}s); "
                        f"shed unstarted", reason="queue_deadline",
                        retry_after=self.policy.retry_after_s)
                    group.request_cancel(err)
            if err is not None:
                handled.add(id(group))
                self._cancel_group(group, err, now)
                worked = True
        return worked

    def _cancel_group(self, group: RequestGroup, err: BaseException,
                      now: float) -> None:
        """Terminate ``group`` with lifecycle error ``err``: drop its
        queued streams, evict its residents (slots free THIS
        boundary), bump the right counter, wake the waiter."""
        status = terminal_status(err)
        self.queue.drop_group(group)
        for slot, stream in list(self._resident.items()):
            if stream.group is not group:
                continue
            del self._resident[slot]
            self.slots.release(slot)
            self.evicted_total += 1
            self._note_freed(stream, status)
            self._emit(stream, "decode", stream.t_admit, now,
                       row=stream.row, slot=slot,
                       tokens=len(stream.out), terminal=status)
            stream.slot = None
        for stream in group.streams:
            self._release_stream_kv(stream)
            self._emit_instant(stream, status, now, row=stream.row,
                               tokens=len(stream.out))
        if isinstance(err, ShedError):
            with self._shed_lock:
                self.shed_total += 1
                self.shed_by_class[group.priority] += 1
        elif isinstance(err, DeadlineExceeded):
            self.expired_total += 1
        else:
            self.cancelled_total += 1
        group.fail(err)
        self._record_history(group)

    def _recent_ttft_p99(self) -> Optional[float]:
        """p99 of the sliding interactive-TTFT window (None until there
        are observations)."""
        if not self._ttft_recent:
            return None
        xs = sorted(self._ttft_recent)
        return xs[min(len(xs) - 1, int(0.99 * len(xs)))]

    def _maybe_preempt(self) -> bool:
        """Preempt ONE batch resident when the interactive class needs
        its slot: the interactive head is admit-ready (fully
        prefilled) with no free slot, and either its own wait passed
        half the ``slo_ttft_s`` target (a controller acts with margin)
        or the recent interactive TTFT p99 is past the target.  The
        victim — the batch resident with the most remaining budget —
        requeues at the front of its class through the token-identical
        resume path; interactive residents are never preempted."""
        slo = self.policy.slo_ttft_s
        if slo is None or self.slots.free_slots > 0:
            return False
        head = self._queue_head()
        if head is None or head.group.priority != "interactive" \
                or not head.pf_done:
            return False
        now = time.perf_counter()
        waited = now - head.group.t_submit
        reason = "head_wait_over_half_slo"
        if waited <= slo / 2:
            p99 = self._recent_ttft_p99()
            if p99 is None or p99 <= slo:
                return False
            reason = "ttft_p99_degraded"
        victim = None
        for slot, stream in self._resident.items():
            if stream.group.priority != "batch":
                continue
            rem = stream.new - len(stream.out)
            if victim is None or rem > victim[2]:
                victim = (slot, stream, rem)
        if victim is None:
            return False        # all residents interactive: defer only
        slot, stream, _ = victim
        self.preempted_total += 1
        stream.preempts += 1
        self._evict_requeue(slot, stream, "preempted", now,
                            by=head.group.rid, reason=reason,
                            head_waited_ms=round(1e3 * waited, 3))
        return True

    def mean_resident_position(self) -> float:
        """Mean absolute decode position over resident slots (0.0 when
        the pool is empty) — the flight recorder's context-length input
        to the per-token attention-flop term.  Engine thread only (it
        reads the host positions the tick mutates)."""
        if not self._resident:
            return 0.0
        return float(np.mean([self.slots.positions[s]
                              for s in self._resident]))

    def run_until_idle(self, max_ticks: int = 100000) -> None:
        """Drain queue + slots synchronously (tests/offline use)."""
        for _ in range(max_ticks):
            if not self.tick():
                return
        raise RuntimeError("engine did not go idle within max_ticks")

    # -- crash recovery (recovery.EngineSupervisor) ----------------------

    def recover_from_crash(self) -> int:
        """The engine half of supervised crash recovery, "requeue
        everything and replay", called with NO loop thread running.
        Returns the number of resident streams requeued.

        - every RESIDENT stream requeues through the preempt-resume
          path (its committed tokens are host state, so resumption is
          token-identical however the engine died);
        - every partial prefill and prefix seed restarts from its
          tokens in pow2 pieces (the partial cache came from a device
          state the crash made untrustworthy);
        - the pools reset IN PLACE (``slots.reset``: host state only,
          the device buffers the captured graphs replay against keep
          their addresses, so recovery captures nothing new);
        - stale shared-page pins are dropped by reference (never
          unpinned into the fresh accounting); the owner's recovery
          hook flushes the prefix store those pins protected."""
        now = time.perf_counter()
        # Quarantine suspicion dies with the loop that formed it; the
        # conviction streak survives (a fault recurring after the
        # restart escalates at once).
        self._suspects.clear()
        self._exhaust_bars.clear()
        n = 0
        for slot, stream in sorted(list(self._resident.items())):
            self._evict_requeue(slot, stream, "crash_requeued", now,
                                release=False)
            n += 1
        for stream in self.queue.snapshot():
            stream.kv_shared = None
            stream.evicted_for = None
            if stream.filled or stream.cache is not None \
                    or stream.pf_done:
                stream.pieces = SchedulerPolicy.pow2_pieces(
                    stream.pf_toks.shape[1])
                stream.filled = 0
                stream.cache = None
                stream.d_cache = None
                stream.logits = None
                stream.pf_done = False
                stream.blocked_t = None
        with self.device_lock:
            # Under the device lock: handler threads scatter/gather
            # prefix pages under it, and their epoch checks are only
            # airtight if the reset (which bumps the epoch) cannot
            # interleave.  Host work only.
            self.slots.reset()
        self._last_freed = None
        self.last_boundary_t = time.perf_counter()
        return n

    # -- telemetry ------------------------------------------------------

    def _emit(self, stream: Stream, name: str, t0: float, t1: float,
              **args) -> None:
        """One lifecycle span for ``stream``: into the shared trace
        ring and onto the stream's own event list.  A telemetry
        failure is counted and dropped, never propagated."""
        if stream.group.rid is not None:
            args.setdefault("rid", stream.group.rid)
        try:
            if self.faults is not None:
                self.faults.check("telemetry")
            self.tel.span(stream.sid or 0, name, t0, t1, **args)
        except Exception:
            # ptpu: lockfree[best-effort drop counter: a lost increment under-counts a diagnostic, nothing else]
            self.telemetry_errors_total += 1
        if stream.events is not None:
            stream.events.append((name, t0, t1, args))

    def _emit_instant(self, stream: Stream, name: str, t: float,
                      **args) -> None:
        if stream.group.rid is not None:
            args.setdefault("rid", stream.group.rid)
        try:
            if self.faults is not None:
                self.faults.check("telemetry")
            self.tel.instant(stream.sid or 0, name, t, **args)
        except Exception:
            self.telemetry_errors_total += 1
        if stream.events is not None:
            stream.events.append((name, t, t, args))

    # -- prefill + admission --------------------------------------------

    def _sync(self) -> None:
        sync_device(self.model.device)

    def _advance_prefill(self, stream: Stream) -> None:
        """Run ONE prefill piece for the head-of-queue stream; admit it
        into a slot when the prompt is fully consumed AND a slot is
        free (prefill works ahead while all slots are busy).  Each
        piece is an eager call of the port's ``prefill``, extending the
        stream's B=1 cache at its position: piecewise equals one-shot,
        so interleaving changes latency, never tokens.  A prefix-seeded
        stream starts at ``filled = p_cached`` (full-length hits have
        no piece at all).  A sticky CUDA error is not the request's:
        it escapes to the loop as ``DeviceLost``."""
        from ..models import generate as G

        group = stream.group
        if stream.t_prefill_start is None:
            stream.t_prefill_start = time.perf_counter()
            if group.t_first_prefill is None:
                group.t_first_prefill = stream.t_prefill_start
            self._emit(stream, "queue", group.t_submit,
                       stream.t_prefill_start, row=stream.row)
        if stream.pieces:
            piece = stream.pieces[0]
            toks = stream.pf_toks[:, stream.filled:stream.filled + piece]
            t_piece = time.perf_counter()
            try:
                with self.device_lock:
                    logits, cache = G.prefill(
                        self.model, toks, cache=stream.cache,
                        position=stream.filled)
                    if stream.sampling.speculative:
                        # The DRAFT prefills the same pieces (chunked
                        # prefill is exact per model).
                        _, stream.d_cache = G.prefill(
                            self.draft_model, toks, cache=stream.d_cache,
                            position=stream.filled)
                    self._sync()
            except Exception as e:
                if is_device_lost(e):
                    raise DeviceLost(f"prefill: {e}") from e
                self._fail_group(group, e)
                return
            stream.cache = cache
            stream.logits = logits
            stream.filled += piece
            stream.pieces.pop(0)
            self.prefill_chunks_total += 1
            self._emit(stream, "prefill", t_piece,
                       time.perf_counter(), row=stream.row,
                       piece=piece, filled=stream.filled)
            if stream.pieces:
                return                  # more prompt to consume
        if not stream.pf_done:
            stream.pf_done = True
            # Never on a resumed stream: its pf_toks mix generated
            # tokens in, which must not be stored back as a prompt.
            if group.on_prefilled is not None and not stream.resume:
                try:
                    group.on_prefilled(stream)
                except Exception:
                    import logging

                    logging.getLogger(__name__).debug(
                        "on_prefilled hook failed", exc_info=True)
        if not self._can_admit_stream(stream):
            return          # wait, fully prefilled, for a slot/pages
        self.queue.pop_stream(stream)
        self._admit(stream)

    def _first_token(self, stream: Stream) -> int:
        """Token 0 from the prefill logits.  Greedy: the first maximum.
        Sampled: the slot step's position-keyed sampler at token index
        0, with the stream's base key ``fold_in(PRNGKey(seed), row)``
        (kept on the stream, armed into the slot at insert)."""
        from ..models.generate import _sample_positional_row

        spec = stream.sampling
        logits = stream.logits[0]
        if not spec.sampled:
            return int(host_copy(torch.argmax(logits)))
        stream.base_key = _host_base_key(spec.seed, stream.row)
        key = torch.from_numpy(stream.base_key).to(logits.device)
        return int(host_copy(_sample_positional_row(
            logits, key, 0, spec.temperature, spec.top_k, spec.top_p)))

    def _admit(self, stream: Stream) -> None:
        """Step-boundary admission: token 0 from the prefill logits
        (argmax, or the position-keyed sampler), the B=1 cache into a
        free slot (paged: into freshly reserved pages, with a prefix
        hit's shared pages mapped read-only).  A device failure
        releases the slot and fails the group: a waiter never hangs on
        a dead admission.

        A RESUMED stream (preempted, quarantined or crash-requeued)
        samples nothing: its committed tokens exist, so it re-enters
        feeding ``out[-1]`` at its original position with
        ``next_index == len(out)``, the key the uninterrupted run
        would have drawn with."""
        slot = self.slots.acquire()
        assert slot is not None, "admission without a free slot"
        stream.last_slot = slot
        stream.evicted_for = None     # an admitted stream carries no bar
        spec = stream.sampling
        resumed = stream.resume
        if not resumed:
            try:
                with self.device_lock:
                    first = self._first_token(stream)
            except Exception as e:
                self.slots.release(slot)
                if is_device_lost(e):
                    raise DeviceLost(f"admission: {e}") from e
                self._fail_group(stream.group, e)
                return
            stream.out.append(first)
        stream.t_admit = time.perf_counter()
        stream.group.t_last_admit = stream.t_admit
        if stream.group.t_first_admit is None:
            # The first token of the request exists NOW: the TTFT
            # anchor, observed into the request's class histogram (and
            # the SLO controller's sliding window).
            stream.group.t_first_admit = stream.t_admit
            ttft = stream.t_admit - stream.group.t_submit
            self.tel.observe("ttft_" + stream.group.priority, ttft,
                             exemplar=stream.group.rid)
            if stream.group.priority == "interactive":
                self._ttft_recent.append(ttft)
        self._emit_instant(stream, "admit", stream.t_admit,
                           row=stream.row, slot=slot,
                           **({"resumed": True} if resumed else {}))
        if stream.blocked_t is not None:
            unb = self._last_freed
            self._emit_instant(
                stream, "admit_unblocked", stream.t_admit,
                row=stream.row, slot=slot,
                wait_ms=round(
                    1e3 * (stream.t_admit - stream.blocked_t), 3),
                **({"unblocked_by": unb[0], "freed_via": unb[1]}
                   if unb is not None else {}))
            stream.blocked_t = None
        stream.logits = None
        if not resumed and stream.done():   # new == 1, or an instant eos
            stream.cache = None
            stream.d_cache = None
            self._release_stream_kv(stream)  # never mapped a table
            self.slots.release(slot)
            stream.slot = slot          # zero-length decode span
            self._complete(stream)      # still keys the slot id
            stream.slot = None
            self._count_admitted(spec, stream.group.priority)
            self.evicted_total += 1
            return
        if (spec.speculative or (resumed and spec.sampled)) \
                and stream.base_key is None:
            # A greedy spec stream drew token 0 without the PRNG, but
            # its slot still carries the base key (the sampled lanes
            # are dead at temperature 0): every spec slot's key is
            # fold_in(PRNGKey(seed), row).  A CROSS-REPLICA resumed
            # sampled stream (submit resume_tokens=) skipped
            # _first_token on this engine — the prior attempt drew its
            # token 0 — so its key is armed here: the same fold_in.
            stream.base_key = _host_base_key(spec.seed, stream.row)
        kw = {}
        if self.paged:
            # Ownership of the pinned shared pages passes to insert (it
            # unpins on its own failure paths): clear the stream's
            # reference FIRST, so no later path releases them twice.
            shared = stream.kv_shared or ()
            stream.kv_shared = None
            kw = dict(total_tokens=self._kv_tokens_needed(
                stream.p_len, stream.new), shared_pages=shared)
        try:
            if self.faults is not None:
                # Injected page-pool exhaustion: a PageExhausted
                # subclass, so it takes the transient-shortage requeue
                # below like a real gate/insert race.
                self.faults.check("page_alloc")
            with self.device_lock:
                # Feed the last committed token at its absolute
                # position (fresh: token 0 at p_len) and draw token
                # ``len(out)`` next.
                self.slots.insert(
                    slot, stream.cache, stream.out[-1],
                    stream.p_len + len(stream.out) - 1,
                    base_key=stream.base_key,
                    next_index=len(stream.out),
                    temperature=spec.temperature, top_k=spec.top_k,
                    top_p=spec.top_p, draft_cache=stream.d_cache,
                    spec_k=spec.spec_k, **kw)
        except PageExhausted as pe:
            # Pages went between the gate and the insert: a transient
            # shortage, not a failure — back to the front of its class
            # through the resume path, to admit when pages free.
            self.slots.release(slot)
            if kw.get("shared_pages") and getattr(pe, "injected", False):
                # An injected exhaustion fires BEFORE insert (the pin
                # owner on real failures) ran: release the pins here.
                self.slots.unpin(kw["shared_pages"],
                                 epoch=stream.kv_epoch)
                stream.kv_epoch = None
            self._emit_instant(stream, "page_requeued",
                               time.perf_counter(), row=stream.row,
                               tokens=len(stream.out))
            stream.prepare_resume(SchedulerPolicy.pow2_pieces(
                stream.p_len + len(stream.out) - 1))
            self.queue.requeue_front(stream)
            self.requests_requeued_total += 1
            return
        except Exception as e:
            self.slots.release(slot)
            if is_device_lost(e):
                raise DeviceLost(f"admission: {e}") from e
            self._fail_group(stream.group, e)
            return
        stream.cache = None             # the pool owns the KV now
        stream.d_cache = None
        stream.slot = slot
        self._resident[slot] = stream
        if resumed:
            stream.resume = False
            stream.resumes += 1
            self.resumed_total += 1
        else:
            self._count_admitted(spec, stream.group.priority)

    def _count_admitted(self, spec: SamplingSpec, priority: str) -> None:
        self.admitted_total += 1
        self.admitted_by_class[priority] += 1
        if spec.speculative:
            self.admitted_spec_total += 1
        elif spec.sampled:
            self.admitted_sampled_total += 1
        else:
            self.admitted_greedy_total += 1

    # -- decode ---------------------------------------------------------

    def _pick_window(self) -> int:
        """Decode steps to fuse into the next device dispatch.

        Window = 1 whenever a smaller granularity could make progress
        sooner: a queued request with a free slot is admissible at the
        very next boundary, an eos-capable resident might free one at
        any step, and a queued prompt still mid-prefill earns one chunk
        per BOUNDARY.  Otherwise the only capacity event is a BUDGET
        eviction, and ``min(remaining)`` lands the window end on the
        earliest one — fusing up to ``decode_window`` steps (rounded
        down to a power of two: one graph per window) saves dispatch
        and host-sync overhead without delaying any admission."""
        cap = self.slots.max_window
        if cap <= 1:
            return 1
        waiters = getattr(self.device_lock, "waiters", None)
        if waiters is not None and waiters():
            # Another thread waits on the device lock: bound its wait
            # to one step.
            return 1
        head = self.queue.head()
        if head is not None and (
                not head.pf_done
                or self._admissible_now(head)
                or any(s.eos_id is not None
                       for s in self._resident.values())
                # An armed TTFT SLO makes every boundary a potential
                # preemption point while an interactive request waits.
                or (self.policy.slo_ttft_s is not None
                    and head.group.priority == "interactive")):
            return 1
        if any(s.group.deadline is not None
               for s in self._resident.values()):
            # Deadlines are delivered at boundaries only.
            return 1
        # Budget horizon in ROUNDS: a spec slot commits up to spec_k
        # tokens a round, so ``rem // spec_k`` rounds never take a slot
        # past its budget (nor its verify chunk past the validated
        # capacity).
        rem = min((s.new - len(s.out))
                  // (s.sampling.spec_k if s.sampling.speculative else 1)
                  for s in self._resident.values())
        return _pow2_floor(min(cap, max(1, rem)))

    def _evict_requeue(self, slot: int, stream: Stream, why: str,
                       now: float, *, release: bool = True,
                       front: bool = True, **instant_args) -> None:
        """Evict a RESIDENT stream and requeue it for token-identical
        resume — the one path SLO preemption, quarantine bisection,
        crash recovery and lazy-KV exhaustion share: it re-prefills
        ``prompt ++ out[:-1]`` in pow2 pieces (a bounded set of prefill
        shapes) and re-enters feeding ``out[-1]`` with ``next_index ==
        len(out)``, so no token is ever resampled
        (``Stream.prepare_resume``).  Exhaustion evictions requeue at
        the BACK of their class (``front=False``): the freed pages
        belong to those already waiting.  ``release=False`` (crash
        recovery) skips the slot release: the wholesale pool reset
        follows."""
        del self._resident[slot]
        if release:
            self.slots.release(slot)
        self.evicted_total += 1
        self._note_freed(stream, why)
        self._emit(stream, "decode", stream.t_admit, now,
                   row=stream.row, slot=slot, tokens=len(stream.out),
                   terminal=why)
        self._emit_instant(stream, why, now, row=stream.row,
                           slot=slot, tokens=len(stream.out),
                           **instant_args)
        stream.slot = None
        stream.prepare_resume(SchedulerPolicy.pow2_pieces(
            stream.p_len + len(stream.out) - 1))
        if front:
            self.queue.requeue_front(stream)
        else:
            self.queue.requeue_back(stream)
        self.requests_requeued_total += 1

    def _engine_instant(self, name: str, t: float, **args) -> None:
        """One instant on the ENGINE trace track (the lazy pool's
        growth and preemption markers), isolated like ``_emit``: a
        broken ring is counted, never raised."""
        try:
            self.tel.instant(0, name, t, pid=ENGINE_PID, **args)
        except Exception:
            self.telemetry_errors_total += 1

    def _ensure_lazy_growth(self, span: int) -> bool:
        """LAZY-KV step-boundary growth: before a dispatch that writes
        ``span`` positions per slot, grow every resident's table to
        cover them (capped at its budget).  On POOL EXHAUSTION, preempt
        the resident with the most remaining budget through
        ``_evict_requeue`` and retry until every survivor can grow.
        Returns False when the boundary was consumed by evictions (the
        next tick re-plans).

        Livelock-free: evictees requeue at the BACK of their class, and
        each carries ``evicted_for`` (the growth-blocked stream it made
        room for) so the next boundary's admission, which runs before
        the next growth, cannot hand the pages straight back.  Each
        failed round evicts one resident, and the submit-time shed
        guarantees a sole resident can always grow."""
        evicted_any = False
        while True:
            blocked = None
            for slot, stream in sorted(self._resident.items()):
                budget = self._kv_tokens_needed(stream.p_len,
                                                stream.new)
                need = min(budget,
                           int(self.slots.positions[slot]) + span)
                grown = self.slots.grow_slot(slot, need)
                if grown is None and self.page_reclaim is not None:
                    # Stored-but-idle prefix pages yield before any
                    # live resident does.
                    try:
                        self.page_reclaim(
                            self.slots.grow_need(slot, need))
                    except Exception:
                        import logging

                        logging.getLogger(__name__).debug(
                            "page_reclaim hook failed during lazy "
                            "growth", exc_info=True)
                    grown = self.slots.grow_slot(slot, need)
                if grown is None:
                    blocked = (slot, stream)
                    break
                if grown:
                    self._engine_instant(
                        "kv_grow", time.perf_counter(), slot=slot,
                        pages=grown, rid=stream.group.rid)
            if blocked is None:
                # Bars clear only on a pass that needed no eviction.
                if not evicted_any and self._exhaust_bars:
                    for v in self._exhaust_bars:
                        v.evicted_for = None
                    self._exhaust_bars.clear()
                return not evicted_any
            now = time.perf_counter()
            _bslot, bstream = blocked
            victim = None
            for slot, stream in self._resident.items():
                rem = stream.new - len(stream.out)
                if victim is None or rem > victim[2]:
                    victim = (slot, stream, rem)
            slot, stream, _rem = victim
            self.kv_preempt_exhaustion_total += 1
            self.preempted_total += 1
            stream.preempts += 1
            self._engine_instant("kv_preempt", now, slot=slot,
                                 rid=stream.group.rid,
                                 blocked_rid=bstream.group.rid)
            self._evict_requeue(slot, stream, "preempted", now,
                                front=False,
                                reason="kv_pages_exhausted",
                                blocked_rid=bstream.group.rid)
            if stream is not bstream:
                stream.evicted_for = bstream
                self._exhaust_bars.append(stream)
            evicted_any = True
            if not self._resident:
                return False

    def _decode_step(self) -> None:
        """Advance every resident stream by one fused window of decode
        steps; evict finished streams so their slots are admissible the
        SAME boundary.  Within a window a stream stops consuming at its
        own eos/budget (later window tokens are discardable garbage).
        One sampled resident selects the sampled program (greedy
        co-tenants ride its argmax lane); an all-greedy pool keeps the
        argmax-only program."""
        window = self._pick_window()
        sampled = any(s.sampling.sampled
                      for s in self._resident.values())
        # Any speculative resident switches the pool to the spec
        # program (plain co-tenants ride its one-token lane).
        spec_ks = [s.sampling.spec_k for s in self._resident.values()
                   if s.sampling.speculative]
        if spec_ks:
            self._decode_step_spec(window, max(spec_ks), sampled)
            return
        if self.paged and self.slots.lazy \
                and not self._ensure_lazy_growth(window):
            # Exhaustion preemptions consumed this boundary.
            return
        occupancy = len(self._resident)
        if self.recorder is not None:
            self.recorder.on_step_start()
        t0 = time.perf_counter()

        def dispatch():
            with self.device_lock:
                return self.slots.step(window, sampled)   # [W, S]

        toks_w = self._dispatch_step(dispatch)
        if toks_w is None:
            # Containment resolved the boundary by changing the
            # resident set instead of producing tokens: re-plan.
            if self.recorder is not None:
                self.recorder.on_step_end(0)
            return
        t1 = time.perf_counter()
        self.decode_steps_total += window
        self.decode_dispatches_total += 1
        emitted = 0
        for slot, stream in list(self._resident.items()):
            for w in range(window):
                stream.out.append(int(toks_w[w, slot]))
                emitted += 1
                if stream.done():
                    break
            if stream.done():
                del self._resident[slot]
                self.slots.release(slot)
                self.evicted_total += 1
                self._note_freed(stream, "complete")
                self._complete(stream)
                stream.slot = None
        self.step_device_s_total += self.slots.last_step_device_s
        self.step_wall_s_total += t1 - t0
        if self.recorder is not None:
            self.recorder.on_step_end(emitted)
        self.tel.step("step", t0, t1,
                      kind="sampled" if sampled else "plain",
                      window=window, occupancy=occupancy,
                      batch=self.slots.n_slots, tokens=emitted,
                      device_s=round(self.slots.last_step_device_s, 6),
                      **({"pages_free": self.slots.free_page_count(),
                          "pages_total": self.slots.n_pages}
                         if self.paged else {}),
                      **({"mesh": self.mesh.axes_str()}
                         if self.mesh is not None else {}))

    def _decode_step_spec(self, window: int, K: int,
                          sampled: bool) -> None:
        """Advance the pool by ``window`` fused SPECULATIVE rounds of
        draft width ``K``: each spec slot commits its own accepted
        prefix a round, plain co-tenants exactly one token; budgets
        count committed tokens, and a stream stops consuming at its own
        eos/budget (later tokens are discardable, as in the plain
        window)."""
        if self.paged and self.slots.lazy \
                and not self._ensure_lazy_growth(window * K + 1):
            # A spec window writes up to window*K+1 positions past the
            # last committed token: grow (or preempt) for all of it.
            return
        occupancy = len(self._resident)
        if self.recorder is not None:
            self.recorder.on_step_start()
        t0 = time.perf_counter()

        def dispatch():
            with self.device_lock:
                return self.slots.step_spec(window, K, sampled)

        out = self._dispatch_step(dispatch)
        if out is None:
            if self.recorder is not None:
                self.recorder.on_step_end(0)
            return
        toks, commits, accepts = out
        t1 = time.perf_counter()
        self.decode_steps_total += window
        self.decode_dispatches_total += 1
        self.spec_rounds_total += window
        emitted = accepted = 0
        for slot, stream in list(self._resident.items()):
            spec = stream.sampling.speculative
            for w in range(window):
                if spec:
                    a = int(accepts[w, slot])
                    stream.spec_rounds += 1
                    stream.spec_drafted += stream.sampling.spec_k
                    stream.spec_accepted += a
                    self.spec_drafted_total += stream.sampling.spec_k
                    self.spec_accepted_total += a
                    accepted += a
                for j in range(int(commits[w, slot])):
                    stream.out.append(int(toks[w, slot, j]))
                    emitted += 1
                    if stream.done():
                        break
                if stream.done():
                    break
            if stream.done():
                del self._resident[slot]
                self.slots.release(slot)
                self.evicted_total += 1
                self._note_freed(stream, "complete")
                self._complete(stream)
                stream.slot = None
        self.step_device_s_total += self.slots.last_step_device_s
        self.step_wall_s_total += t1 - t0
        if self.recorder is not None:
            self.recorder.on_step_end(emitted)
        self.tel.step("step", t0, t1, kind="spec", window=window, k=K,
                      occupancy=occupancy, batch=self.slots.n_slots,
                      tokens=emitted, accepted=accepted,
                      device_s=round(self.slots.last_step_device_s, 6),
                      **({"pages_free": self.slots.free_page_count(),
                          "pages_total": self.slots.n_pages}
                         if self.paged else {}),
                      **({"mesh": self.mesh.axes_str()}
                         if self.mesh is not None else {}))

    # -- step-boundary fault containment ---------------------------------

    def _dispatch_step(self, dispatch):
        """Contained step dispatch.  Returns the dispatch's tokens, or
        None when containment resolved the failure by changing the
        resident set (quarantine evictions, a conviction).

        - TRANSIENT failures (``faults.is_transient``) retry in place
          under ``retry_policy``: the step commits host positions and
          tokens only after a dispatch succeeds, so a retry re-arms
          the graph from the same committed state and rewrites any
          partly written KV with identical values.
        - POISONED failures, exhausted retries, or any other error
          with residents to protect go to ``_quarantine_step``.
        - A sticky CUDA error escapes at once (``DeviceLost``): no
          dispatch can succeed on that context.

        A round that cannot converge escalates by raising into the
        loop's catch-all (supervised restart, or fail-everything) —
        bounded, never a hang."""
        attempt = 0
        rounds = 0
        while True:
            rounds += 1
            if rounds > 4 * self.slots.n_slots + 8:
                raise RuntimeError(
                    "step-fault containment did not converge "
                    "(failures outlasted per-request quarantine); "
                    "escalating to engine recovery")
            try:
                if self.faults is not None:
                    # slow_step sleeps OUTSIDE the device lock: an
                    # injected stall wedges the loop, not the lock.
                    self.faults.check("slow_step")
                    self.faults.check("step", rids=[
                        s.group.rid for s in self._resident.values()])
                out = dispatch()
            except BaseException as e:
                if is_device_lost(e):
                    raise DeviceLost(f"decode step: {e}") from e
                if not self._resident:
                    raise       # nothing to contain: scheduling bug
                if is_transient(e) and not is_poisoned(e) \
                        and attempt < self.retry_policy.max_attempts:
                    delay = self.retry_policy.delay_s(attempt)
                    attempt += 1
                    self.step_retries_total += 1
                    try:
                        self.tel.instant(
                            0, "step_retry", time.perf_counter(),
                            pid=ENGINE_PID, error=type(e).__name__,
                            attempt=attempt,
                            backoff_ms=round(1e3 * delay, 3))
                    except Exception:
                        self.telemetry_errors_total += 1
                    time.sleep(delay)
                    continue
                self._quarantine_step(e)
                if not self._resident:
                    return None
                continue
            self._convictions_without_success = 0
            if self._suspects:
                # A working dispatch exonerates every resident suspect.
                for s in self._resident.values():
                    self._suspects.discard(s.group)
            return out

    def _quarantine_step(self, err: BaseException) -> None:
        """One quarantine-bisection round: isolate WHICH resident keeps
        failing the shared dispatch, fail only it, resume everyone
        else token-identically.  A poisoned failure fires exactly when
        its culprit is resident, so —

        - no resident suspects yet (or one stale suspect among fresh
          co-tenants): every resident is marked;
        - ONE suspect that is the SOLE resident: convicted
          (``PoisonedRequest``, 500 ``poisoned_request``), every other
          suspect exonerated;
        - several: evict half to the requeue path and re-dispatch.

        Two convictions with no working dispatch between them mean the
        fault tracks the engine: escalate by raising."""
        now = time.perf_counter()
        for g in [g for g in self._suspects if g.event.is_set()]:
            self._suspects.discard(g)
        suspects = [(slot, s)
                    for slot, s in sorted(self._resident.items())
                    if s.group in self._suspects]
        if not suspects or (len(suspects) == 1
                            and len(self._resident) > 1):
            for s in self._resident.values():
                self._suspects.add(s.group)
            suspects = sorted(self._resident.items())
        if len(suspects) == 1:
            if self._convictions_without_success >= 2:
                raise RuntimeError(
                    "step failures persist across quarantine "
                    "convictions (no successful dispatch between "
                    "episodes) — the fault tracks the engine, not a "
                    "request; escalating to engine recovery") from err
            slot, stream = suspects[0]
            self._convict(slot, stream, err, now)
            self._suspects.clear()
            return
        for slot, stream in suspects[: len(suspects) // 2]:
            self._evict_requeue(slot, stream, "quarantined", now,
                                error=type(err).__name__)

    def _convict(self, slot: int, stream: Stream, err: BaseException,
                 now: float) -> None:
        """Fail the isolated culprit — and ONLY it — with the typed
        ``PoisonedRequest``; its co-tenants keep decoding."""
        group = stream.group
        self.poisoned_total += 1
        self._convictions_without_success += 1
        self._note_freed(stream, "poisoned")
        self._emit(stream, "decode", stream.t_admit, now,
                   row=stream.row, slot=slot, tokens=len(stream.out),
                   terminal="poisoned")
        self._emit_instant(stream, "poisoned", now, row=stream.row,
                           slot=slot, error=type(err).__name__)
        self._fail_group(group, PoisonedRequest(
            f"request {group.rid} poisoned the shared decode step and "
            f"was quarantined (co-tenants resumed unaffected): "
            f"{type(err).__name__}: {err}"))

    # -- completion -----------------------------------------------------

    def _complete(self, stream: Stream) -> None:
        group = stream.group
        stream.t_done = time.perf_counter()
        if stream.sampling.speculative and stream.spec_drafted:
            # One acceptance-rate observation per completed stream.
            self.spec_accept.observe(
                stream.spec_accepted / stream.spec_drafted)
        if stream.t_admit is not None:
            args = {"row": stream.row, "slot": stream.slot,
                    "tokens": len(stream.out)}
            if stream.preempts or stream.resumes:
                args.update(preempts=stream.preempts,
                            resumes=stream.resumes)
            if stream.sampling.speculative:
                args.update(spec_rounds=stream.spec_rounds,
                            spec_drafted=stream.spec_drafted,
                            spec_accepted=stream.spec_accepted)
            self._emit(stream, "decode", stream.t_admit, stream.t_done,
                       **args)
        self._emit_instant(stream, "complete", stream.t_done,
                           row=stream.row, tokens=len(stream.out))
        group.complete_row(stream)
        if group.event.is_set() and group.error is None:
            self.completed_total += 1
            if group.sampling.speculative:
                self.completed_spec_total += 1
            elif group.sampling.sampled:
                self.completed_sampled_total += 1
            else:
                self.completed_greedy_total += 1
            self._record_history(group)

    def _fail_group(self, group: RequestGroup,
                    err: BaseException) -> None:
        """Deliver ``err`` to every thread waiting on ``group`` and
        reclaim its slots; OTHER groups' streams keep running."""
        self.queue.drop_group(group)
        for slot, stream in list(self._resident.items()):
            if stream.group is group:
                del self._resident[slot]
                self.slots.release(slot)
                self.evicted_total += 1
        for stream in group.streams:
            self._release_stream_kv(stream)
        if not group.event.is_set():
            t = time.perf_counter()
            for stream in group.streams:
                self._emit_instant(stream, "fail", t, row=stream.row,
                                   error=type(err).__name__)
        # The group keeps the error, not its traceback: the traceback's
        # frames hold this engine and the group (a cycle).
        err.__traceback__ = None
        group.fail(err)
        self._record_history(group)

    # -- introspection --------------------------------------------------

    def _record_history(self, group: RequestGroup) -> None:
        """One terminal record per request into the retention ring (the
        causal story ``GET /requests/<id>`` serves), and its phase
        ledger into the forensics core."""
        # Terminal: drop what the group still holds (the owner's
        # store-back hook, a partial prefill's cache).  A group and its
        # streams form a cycle that only the collector frees.
        group.on_prefilled = None
        for s in group.streams:
            s.cache = s.d_cache = s.logits = None
        h = self.history
        if group.rid is None:
            return
        t_done = group.t_done if group.t_done is not None \
            else time.perf_counter()
        ledger = None
        if self.forensics is not None or (h is not None
                                          and h.enabled):
            all_events: list = []
            for s in group.streams:
                if s.events:
                    all_events.extend(s.events)
            ledger = compute_ledger(all_events, group.t_submit, t_done)
            if self.forensics is not None:
                self.forensics.note(ledger, group.rid)
        if h is None or not h.enabled:
            return
        queue_s, prefill_s, decode_s = group.breakdown()
        rec: Dict[str, Any] = {
            "request_id": group.rid,
            "t": round(time.time(), 3),
            "status": group.status,
            "kind": _kind_of(group.sampling),
            "priority": group.priority,
            "rows": len(group.streams),
            "prompt_tokens": int(group.rows.shape[1]),
            "max_new_tokens": int(group.new),
            "wall_s": round(max(0.0, t_done - group.t_submit), 6),
            "queue_wait_s": round(queue_s, 6),
            "prefill_s": round(prefill_s, 6),
            "decode_s": round(decode_s, 6),
            "preempts": sum(s.preempts for s in group.streams),
            "resumes": sum(s.resumes for s in group.streams),
        }
        if group.t_first_admit is not None:
            rec["ttft_s"] = round(group.t_first_admit - group.t_submit, 6)
        if group.error is not None:
            rec["error"] = (f"{type(group.error).__name__}: "
                            f"{group.error}")[:300]
        if group.prefix_info:
            rec["prefix"] = dict(group.prefix_info)
        if group.sampling.speculative:
            rec["spec"] = {
                "rounds": sum(s.spec_rounds for s in group.streams),
                "drafted": sum(s.spec_drafted for s in group.streams),
                "accepted": sum(s.spec_accepted for s in group.streams)}
        if ledger is not None:
            rec["phases"] = ledger
        rec["streams"] = [
            {"row": s.row,
             "tokens_out": len(s.out),
             **({"slot": s.last_slot}
                if s.last_slot is not None else {}),
             "timeline": events_to_dicts(s.events or [],
                                         group.t_submit)}
            for s in group.streams]
        h.record(rec)

    def build_debug_snapshot(self, forced: bool = False
                             ) -> Dict[str, Any]:
        """The ``/debug/state`` snapshot: slot table and per-class
        queues with entry ages — host-side dicts, never the device
        lock.  Built on the engine thread at a step boundary."""
        now = time.perf_counter()
        slots = []
        for slot, s in sorted(list(self._resident.items())):
            slots.append({
                "slot": slot,
                "request_id": s.group.rid,
                "row": s.row,
                "kind": _kind_of(s.sampling),
                "priority": s.group.priority,
                "position": s.p_len + len(s.out) - 1,
                "tokens_out": len(s.out),
                "remaining": s.new - len(s.out),
                "preempts": s.preempts,
                "resumes": s.resumes,
                "age_s": round(now - s.group.t_submit, 3),
                **({"deadline_in_s": round(s.group.deadline - now, 3)}
                   if s.group.deadline is not None else {}),
            })
        queues: Dict[str, list] = {p: [] for p in PRIORITIES}
        for s in self.queue.snapshot():
            queues[s.group.priority].append({
                "request_id": s.group.rid,
                "row": s.row,
                "age_s": round(now - s.group.t_submit, 3),
                "prefilled": s.filled,
                "prompt_tokens": s.p_len,
                "pf_done": s.pf_done,
                **({"blocked_s": round(now - s.blocked_t, 3)}
                   if s.blocked_t is not None else {}),
            })
        snap: Dict[str, Any] = {
            "t": now,
            "forced": bool(forced),
            "draining": self.draining,
            "n_slots": self.slots.n_slots,
            "free_slots": self.slots.free_slots,
            "slots": slots,
            "queues": queues,
            "queue_len": sum(len(q) for q in queues.values()),
            "last_step_age_s": round(
                max(0.0, now - self.last_boundary_t), 3),
            "decode_steps_total": self.decode_steps_total,
        }
        if self.paged:
            snap["pages"] = {**self.slots.page_stats(),
                             "slot_table_pages":
                                 self.slots.slot_page_counts()}
        if self.mesh is not None:
            snap["mesh"] = self.mesh.axes_str()
        # Fault tolerance: the supervisor block, the armed plan's
        # counters and the quarantine suspects ride every snapshot.
        snap["engine_down"] = self.down
        if self.supervisor is not None:
            snap["supervisor"] = self.supervisor.status()
        if self.faults is not None:
            snap["faults"] = self.faults.stats()
        if self._suspects:
            snap["quarantine_suspects"] = sorted(
                g.rid for g in self._suspects if g.rid)
        return snap

    def stats(self) -> Dict[str, Any]:
        fstats = self.faults.stats() if self.faults is not None \
            else None
        sup = self.supervisor
        return {
            "slots": self.slots.n_slots,
            "slots_active": self.slots.active_slots,
            "slot_occupancy": round(
                self.slots.active_slots / self.slots.n_slots, 4),
            "queue_len": len(self.queue),
            "queue_depth": self.policy.queue_depth,
            "admitted_total": self.admitted_total,
            "admitted_greedy_total": self.admitted_greedy_total,
            "admitted_sampled_total": self.admitted_sampled_total,
            "admitted_spec_total": self.admitted_spec_total,
            "evicted_total": self.evicted_total,
            "decode_steps_total": self.decode_steps_total,
            "decode_dispatches_total": self.decode_dispatches_total,
            "prefill_chunks_total": self.prefill_chunks_total,
            "completed_total": self.completed_total,
            "completed_greedy_total": self.completed_greedy_total,
            "completed_sampled_total": self.completed_sampled_total,
            "completed_spec_total": self.completed_spec_total,
            "spec_rounds_total": self.spec_rounds_total,
            "spec_drafted_total": self.spec_drafted_total,
            "spec_accepted_total": self.spec_accepted_total,
            **self._spec_accept_stats(),
            "rejected_total": self.queue.rejected,
            "cancelled_total": self.cancelled_total,
            "expired_total": self.expired_total,
            "shed_total": self.shed_total,
            "shed_interactive_total":
                self.shed_by_class["interactive"],
            "shed_batch_total": self.shed_by_class["batch"],
            "admitted_interactive_total":
                self.admitted_by_class["interactive"],
            "admitted_batch_total": self.admitted_by_class["batch"],
            "queue_len_interactive":
                self.queue.class_len("interactive"),
            "queue_len_batch": self.queue.class_len("batch"),
            "draining": self.draining,
            "telemetry_errors_total": self.telemetry_errors_total,
            "step_device_seconds_total":
                round(self.step_device_s_total, 6),
            "step_wall_seconds_total": round(self.step_wall_s_total, 6),
            "shed_kv_pages_total": self.shed_kv_pages_total,
            "kv_preempt_exhaustion_total":
                self.kv_preempt_exhaustion_total,
            "preempted_total": self.preempted_total,
            "requests_requeued_total": self.requests_requeued_total,
            "resumed_total": self.resumed_total,
            # Fault tolerance (faults.py + recovery.py): one dict
            # behind /metrics AND /info.
            "engine_down": self.down,
            "step_retries_total": self.step_retries_total,
            "poisoned_total": self.poisoned_total,
            "engine_crashes_total":
                sup.crashes_total if sup is not None else 0,
            "engine_restarts_total":
                sup.restarts_total if sup is not None else 0,
            "breaker_state":
                sup.breaker.state if sup is not None else "unsupervised",
            "faults_injected_total":
                fstats["faults_injected_total"]
                if fstats is not None else 0,
            "faults_injected":
                fstats["faults_injected"] if fstats is not None else {},
            **(self.slots.page_stats() if self.paged else {}),
            # Mesh topology (absent unmeshed): axis names and sizes and
            # the device count, for /info and the /metrics gauges.
            **(self._mesh_stats() if self.mesh is not None else {}),
            # Recompile sentinel: a miss is a CUDA-graph capture (a
            # window's first eager run on the CPU), a hit a replay;
            # after warm-up the misses must stay put.
            **self.sentinel.snapshot(),
        }

    def _mesh_stats(self) -> Dict[str, Any]:
        return {"mesh": self.mesh.describe(),
                "mesh_devices": self.mesh.n_devices}

    def _spec_accept_stats(self) -> Dict[str, Any]:
        counts, total, n = self.spec_accept.snapshot()
        return {
            "spec_accept_buckets": list(self.spec_accept.buckets),
            "spec_accept_hist": counts,
            "spec_accept_sum": round(total, 6),
            "spec_accept_count": n,
        }
