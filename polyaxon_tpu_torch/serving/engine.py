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

Threading: ``submit`` may be called from any handler thread; all slot
and queue mutation happens on the engine loop thread (or, in tests, via
manual ``tick()`` calls with the loop not started — never both).
Every CUDA call (prefill pieces, the insert copy, decode steps) runs on
that thread under ``device_lock``; handler threads do no device work.

Not ported yet, and refused by name: speculative streams, meshes, SLO
preemption, fault injection and supervised crash recovery (ROADMAP
Queue 1).
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .debug import SnapshotBoard, events_to_dicts, new_request_id
from .forensics import compute_ledger
from .paged import PageExhausted, PagedSlotKVManager
from .scheduler import (AdmissionQueue, DeadlineExceeded, PRIORITIES,
                        QueueFullError, RequestCancelled, RequestGroup,
                        SamplingSpec, SchedulerPolicy, ShedError, Stream,
                        terminal_status)
from .slots import SlotKVManager
from .telemetry import Telemetry

__all__ = ["DecodeEngine", "QueueFullError"]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch backend yet (ROADMAP "
        f"Queue 1: {item})")


def _pow2_floor(n: int) -> int:
    w = 1
    while w * 2 <= n:
        w *= 2
    return w


def _kind_of(sampling: SamplingSpec) -> str:
    return "sampled" if sampling.sampled else "greedy"


class DecodeEngine:
    def __init__(self, model, *,
                 policy: Optional[SchedulerPolicy] = None,
                 device_lock=None,
                 autostart: bool = True,
                 telemetry: Optional[Telemetry] = None,
                 sentinel=None, mesh=None, draft_model=None,
                 faults=None):
        if mesh is not None:
            raise _not_ported("a serving mesh", "meshes")
        if draft_model is not None:
            raise _not_ported("a draft model (speculative streams)",
                              "beam and speculative decoding")
        if faults is not None:
            raise _not_ported("fault injection", "--fault-plan wiring")
        self.model = model
        self.policy = policy or SchedulerPolicy()
        if self.policy.slo_ttft_s is not None:
            raise _not_ported("SLO preemption (slo_ttft_s)",
                              "SLO preemption")
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
        if self.paged:
            self.slots = PagedSlotKVManager(
                model, self.policy.n_slots,
                page_tokens=self.policy.kv_page_tokens,
                n_pages=self.policy.kv_pages,
                max_position=model.cfg.max_position,
                decode_window=self.policy.decode_window,
                lazy=self.policy.kv_lazy, sentinel=sentinel,
                max_window=max_window)
        else:
            self.slots = SlotKVManager(
                model, self.policy.n_slots, sentinel=sentinel,
                max_window=max_window)
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
        self.evicted_total = 0
        self.decode_steps_total = 0
        self.decode_dispatches_total = 0
        self.prefill_chunks_total = 0
        self.completed_total = 0
        self.completed_greedy_total = 0
        self.completed_sampled_total = 0
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
        # Sweep fast path: skip the boundary sweep unless a cancel is
        # pending or deadlines are in play (sticky once armed).
        self._cancel_pending = False
        self._deadline_armed = False
        # Draining: shed new submits (503), finish everything accepted.
        self.draining = False
        self.step_device_s_total = 0.0
        self.step_wall_s_total = 0.0
        self.telemetry_errors_total = 0
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
        self.debug_board.publish(self.build_debug_snapshot())

    # -- submission (any thread) ----------------------------------------

    def submit(self, rows: np.ndarray, new: int,
               eos_id: Optional[int], prefill_chunk: Optional[int],
               *, sampling: Optional[SamplingSpec] = None,
               record_timings: bool = False,
               priority: Optional[str] = None,
               deadline_s: Optional[float] = None,
               rid: Optional[str] = None) -> RequestGroup:
        """Enqueue a request (may raise QueueFullError) and make sure
        the loop is running.  Returns the group; callers block on
        ``group.event``.  ``sampling`` carries the per-request (seed,
        temperature, top_k, top_p): None (or temperature 0) is greedy;
        sampled streams draw under the position-keyed contract, so
        their tokens are independent of co-tenancy.  ``priority`` picks
        the class queue (``interactive`` drains ahead of ``batch``);
        ``deadline_s`` (relative seconds) evicts the request at the
        next step boundary once it passes.  A DRAINING engine sheds
        every submit (503).

        A budget past the model's ``max_position`` (prompt + new
        tokens) is refused with ValueError: no slot has positions for
        it.  PAGED engines also shed (503 ``reason: kv_pages``) a
        request whose KV budget can NEVER fit the page pool, while one
        that only does not fit now queues until evictions free
        pages."""
        if sampling is not None and sampling.speculative:
            raise _not_ported("speculative decoding",
                              "beam and speculative decoding")
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
        rows = np.asarray(rows)
        p_len = rows.shape[1]
        max_pos = self.model.cfg.max_position
        if p_len + new > max_pos:
            # Past the cache width the decode step would write and
            # embed positions no slot has (a device-side assert on the
            # card, fatal to every co-resident).
            raise ValueError(
                f"prompt ({p_len}) + max_new_tokens ({new}) exceeds "
                f"the model's max_position ({max_pos})")
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
        pieces = self.policy.chunk_plan(p_len, prefill_chunk)
        group = RequestGroup(rows, new, eos_id, pieces, sampling,
                             priority=priority)
        if deadline_s is not None:
            group.deadline = group.t_submit + float(deadline_s)
            self._deadline_armed = True
        group.rid = rid if rid is not None else new_request_id()
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
        if not self._resident and len(self.queue) == 0:
            # Idle -> busy: re-stamp the progress signal.
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
            stream.group.fail(err)
            self._record_history(stream.group)

    def _loop(self) -> None:
        while not self._stop:
            try:
                worked = self.tick()
            except Exception as e:
                # Device errors inside prefill/admit already failed
                # their own group; anything here is a whole-engine
                # crash: surface it and fail everything in flight
                # (supervised restart comes with the fault-tolerance
                # slice).
                traceback.print_exc(file=sys.stderr)
                self._fail_all(
                    RuntimeError(f"decode engine error: "
                                 f"{type(e).__name__}: {e}"))
                worked = False
            if not worked:
                with self._wake:
                    if self._stop:
                        break
                    self._wake.wait(timeout=0.05)
        self._fail_all(RuntimeError("decode engine closed"))

    # -- one scheduling round -------------------------------------------

    def tick(self) -> bool:
        """One step boundary: deliver pending lifecycle events, admit/
        prefill within the policy budget, then one decode window over
        the resident batch.  Returns whether any work was done."""
        worked = self._sweep_lifecycle()
        budget = self.policy.prefill_budget(bool(self._resident),
                                            self.slots.free_slots)
        while budget > 0:
            stream = self._queue_head()
            if stream is None:
                break
            if stream.group.error is not None:
                self.queue.drop_group(stream.group)
                continue
            if stream.pf_done and not self._admissible_now(stream):
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
        """A stream's FULL KV reservation: prompt + budget (the port
        has no speculative write slack yet)."""
        return p_len + new

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

    def _admissible_now(self, stream: Stream) -> bool:
        """A free slot AND, paged, enough free pages for the stream's
        reservation (and, lazy, no exhaustion bar)."""
        if self._stream_barred(stream):
            return False
        if self.slots.free_slots == 0:
            return False
        if not self.paged:
            return True
        return self.slots.can_admit(self._kv_admit_tokens(stream))

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

    def run_until_idle(self, max_ticks: int = 100000) -> None:
        """Drain queue + slots synchronously (tests/offline use)."""
        for _ in range(max_ticks):
            if not self.tick():
                return
        raise RuntimeError("engine did not go idle within max_ticks")

    # -- telemetry ------------------------------------------------------

    def _emit(self, stream: Stream, name: str, t0: float, t1: float,
              **args) -> None:
        """One lifecycle span for ``stream``: into the shared trace
        ring and onto the stream's own event list.  A telemetry
        failure is counted and dropped, never propagated."""
        if stream.group.rid is not None:
            args.setdefault("rid", stream.group.rid)
        try:
            self.tel.span(stream.sid or 0, name, t0, t1, **args)
        except Exception:
            self.telemetry_errors_total += 1
        if stream.events is not None:
            stream.events.append((name, t0, t1, args))

    def _emit_instant(self, stream: Stream, name: str, t: float,
                      **args) -> None:
        if stream.group.rid is not None:
            args.setdefault("rid", stream.group.rid)
        try:
            self.tel.instant(stream.sid or 0, name, t, **args)
        except Exception:
            self.telemetry_errors_total += 1
        if stream.events is not None:
            stream.events.append((name, t, t, args))

    # -- prefill + admission --------------------------------------------

    def _sync(self) -> None:
        dev = self.model.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _advance_prefill(self, stream: Stream) -> None:
        """Run ONE prefill piece for the head-of-queue stream; admit it
        into a slot when the prompt is fully consumed AND a slot is
        free (prefill works ahead while all slots are busy).  Each
        piece is an eager call of the port's ``prefill``, extending the
        stream's B=1 cache at its position: piecewise equals one-shot,
        so interleaving changes latency, never tokens."""
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
                    self._sync()
            except Exception as e:
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
        stream.pf_done = True
        if not self._admissible_now(stream):
            return          # wait, fully prefilled, for a slot
        self.queue.pop_stream(stream)
        self._admit(stream)

    def _first_token(self, stream: Stream) -> int:
        """Token 0 from the prefill logits.  Greedy: the first maximum.
        Sampled: the slot step's position-keyed sampler at token index
        0, with the stream's base key ``fold_in(PRNGKey(seed), row)``
        (kept on the stream, armed into the slot at insert)."""
        from .. import prng
        from ..models.generate import _sample_positional_row

        spec = stream.sampling
        logits = stream.logits[0]
        if not spec.sampled:
            return int(torch.argmax(logits))
        key = prng.fold_in(prng.PRNGKey(spec.seed, device=logits.device),
                           stream.row)
        stream.base_key = key.cpu().numpy()
        return int(_sample_positional_row(
            logits, key, 0, spec.temperature, spec.top_k, spec.top_p))

    def _admit(self, stream: Stream) -> None:
        """Step-boundary admission: token 0 from the prefill logits
        (argmax, or the position-keyed sampler), the B=1 cache into a
        free slot (paged: into freshly reserved pages).  A device
        failure releases the slot and fails the group: a waiter never
        hangs on a dead admission.

        A RESUMED stream (evicted for pool exhaustion) samples nothing:
        its committed tokens exist, so it re-enters feeding ``out[-1]``
        at its original position with ``next_index == len(out)``, the
        key the uninterrupted run would have drawn with."""
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
                self._fail_group(stream.group, e)
                return
            stream.out.append(first)
        stream.t_admit = time.perf_counter()
        stream.group.t_last_admit = stream.t_admit
        if stream.group.t_first_admit is None:
            # The first token of the request exists NOW: the TTFT
            # anchor, observed into the request's class histogram.
            stream.group.t_first_admit = stream.t_admit
            ttft = stream.t_admit - stream.group.t_submit
            self.tel.observe("ttft_" + stream.group.priority, ttft,
                             exemplar=stream.group.rid)
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
            self.slots.release(slot)
            stream.slot = slot          # zero-length decode span
            self._complete(stream)      # still keys the slot id
            stream.slot = None
            self._count_admitted(spec, stream.group.priority)
            self.evicted_total += 1
            return
        kw = {}
        if self.paged:
            kw["total_tokens"] = self._kv_tokens_needed(stream.p_len,
                                                        stream.new)
        try:
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
                    top_p=spec.top_p, **kw)
        except PageExhausted:
            # Pages went between the gate and the insert: a transient
            # shortage, not a failure — back to the front of its class
            # through the resume path, to admit when pages free.
            self.slots.release(slot)
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
            self._fail_group(stream.group, e)
            return
        stream.cache = None             # the pool owns the KV now
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
        if spec.sampled:
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
                       for s in self._resident.values())):
            return 1
        if any(s.group.deadline is not None
               for s in self._resident.values()):
            # Deadlines are delivered at boundaries only.
            return 1
        rem = min(s.new - len(s.out) for s in self._resident.values())
        return _pow2_floor(min(cap, max(1, rem)))

    def _evict_requeue(self, slot: int, stream: Stream, why: str,
                       now: float, *, front: bool = True,
                       **instant_args) -> None:
        """Evict a RESIDENT stream and requeue it for token-identical
        resume: it re-prefills ``prompt ++ out[:-1]`` in pow2 pieces
        (a bounded set of prefill shapes) and re-enters feeding
        ``out[-1]`` with ``next_index == len(out)``, so no token is
        ever resampled (``Stream.prepare_resume``).  Exhaustion
        evictions requeue at the BACK of their class (``front=False``):
        the freed pages belong to those already waiting."""
        del self._resident[slot]
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
                if self.slots.grow_slot(slot, need) is None:
                    blocked = (slot, stream)
                    break
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
        if self.paged and self.slots.lazy \
                and not self._ensure_lazy_growth(window):
            # Exhaustion preemptions consumed this boundary.
            return
        sampled = any(s.sampling.sampled
                      for s in self._resident.values())
        occupancy = len(self._resident)
        t0 = time.perf_counter()
        with self.device_lock:
            toks_w = self.slots.step(window, sampled)   # [W, S]
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
        self.tel.step("step", t0, t1,
                      kind="sampled" if sampled else "plain",
                      window=window, occupancy=occupancy,
                      batch=self.slots.n_slots, tokens=emitted,
                      device_s=round(self.slots.last_step_device_s, 6),
                      **({"pages_free": self.slots.free_page_count(),
                          "pages_total": self.slots.n_pages}
                         if self.paged else {}))

    # -- completion -----------------------------------------------------

    def _complete(self, stream: Stream) -> None:
        group = stream.group
        stream.t_done = time.perf_counter()
        if stream.t_admit is not None:
            args = {"row": stream.row, "slot": stream.slot,
                    "tokens": len(stream.out)}
            if stream.preempts or stream.resumes:
                args.update(preempts=stream.preempts,
                            resumes=stream.resumes)
            self._emit(stream, "decode", stream.t_admit, stream.t_done,
                       **args)
        self._emit_instant(stream, "complete", stream.t_done,
                           row=stream.row, tokens=len(stream.out))
        group.complete_row(stream)
        if group.event.is_set() and group.error is None:
            self.completed_total += 1
            if group.sampling.sampled:
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
        if not group.event.is_set():
            t = time.perf_counter()
            for stream in group.streams:
                self._emit_instant(stream, "fail", t, row=stream.row,
                                   error=type(err).__name__)
        group.fail(err)
        self._record_history(group)

    # -- introspection --------------------------------------------------

    def _record_history(self, group: RequestGroup) -> None:
        """One terminal record per request into the retention ring (the
        causal story ``GET /requests/<id>`` serves), and its phase
        ledger into the forensics core."""
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
        }
        if group.t_first_admit is not None:
            rec["ttft_s"] = round(group.t_first_admit - group.t_submit, 6)
        if group.error is not None:
            rec["error"] = (f"{type(group.error).__name__}: "
                            f"{group.error}")[:300]
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
        return snap

    def stats(self) -> Dict[str, Any]:
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
            "evicted_total": self.evicted_total,
            "decode_steps_total": self.decode_steps_total,
            "decode_dispatches_total": self.decode_dispatches_total,
            "prefill_chunks_total": self.prefill_chunks_total,
            "completed_total": self.completed_total,
            "completed_greedy_total": self.completed_greedy_total,
            "completed_sampled_total": self.completed_sampled_total,
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
            **(self.slots.page_stats() if self.paged else {}),
            # Recompile sentinel: a miss is a CUDA-graph capture (a
            # window's first eager run on the CPU), a hit a replay;
            # after warm-up the misses must stay put.
            **self.sentinel.snapshot(),
        }
