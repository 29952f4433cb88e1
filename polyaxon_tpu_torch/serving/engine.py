"""Continuous-batching decode engine.

Port of ``polyaxon_tpu/serving/engine.py`` as far as the fixed-lane
greedy engine goes.  STEP-LEVEL scheduling over a fixed pool of decode
slots (slots.py), with the reference's gap reclamation at step
boundaries —

- a request hitting EOS (or its budget) frees its slot the same step;
- a queued request is admitted into a free slot between two decode
  steps, never after the whole running batch drains;
- long prompts prefill in bounded chunks INTERLEAVED between decode
  steps (one chunk per boundary while decodes run), and a queued prompt
  prefills ahead while every slot is busy;
- with no admission possible sooner, up to ``decode_window`` decode
  steps fuse into one device dispatch (one CUDA-graph replay).

Greedy rows never interact and eos-evicted rows pad to budget, so a
response equals solo ``generate`` on the same prompt.  Request
lifecycle (priority classes, cancellation, deadlines, per-class queue
deadlines, drain) is the reference's.

Threading: ``submit`` may be called from any handler thread; all slot
and queue mutation happens on the engine loop thread (or, in tests, via
manual ``tick()`` calls with the loop not started — never both).
Every CUDA call (prefill pieces, the insert copy, decode steps) runs on
that thread under ``device_lock``; handler threads do no device work.

Not ported yet, and refused by name: sampled and speculative streams,
the paged pool (``kv_paged``), meshes, SLO preemption, fault injection
and supervised crash recovery (ROADMAP Queue 1).
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
        if self.policy.kv_paged:
            raise _not_ported("the paged KV pool (kv_paged)",
                              "the paged pool")
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
        self.slots = SlotKVManager(
            model, self.policy.n_slots, sentinel=sentinel,
            max_window=_pow2_floor(self.policy.decode_window))
        self.queue = AdmissionQueue(self.policy)
        # streams resident in a slot: slot index -> Stream
        self._resident: Dict[int, Stream] = {}
        self._thread: Optional[threading.Thread] = None
        self._thread_lock = threading.Lock()
        self._wake = threading.Condition()
        self._stop = False
        # counters (read unlocked by metrics — monotonic ints)
        self.admitted_total = 0
        self.evicted_total = 0
        self.decode_steps_total = 0
        self.decode_dispatches_total = 0
        self.prefill_chunks_total = 0
        self.completed_total = 0
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
        ``group.event``.  ``priority`` picks the class queue
        (``interactive`` drains ahead of ``batch``); ``deadline_s``
        (relative seconds) evicts the request at the next step boundary
        once it passes.  A DRAINING engine sheds every submit (503)."""
        if sampling is not None and sampling.speculative:
            raise _not_ported("speculative decoding",
                              "beam and speculative decoding")
        if sampling is not None and sampling.sampled:
            raise _not_ported("sampled decoding (temperature > 0)",
                              "sampled decoding")
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
        pieces = self.policy.chunk_plan(rows.shape[1], prefill_chunk)
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
            stream = self.queue.head()
            if stream is None:
                break
            if stream.group.error is not None:
                self.queue.drop_group(stream.group)
                continue
            if stream.pf_done and not self._admissible_now(stream):
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

    def _admissible_now(self, stream: Stream) -> bool:
        return self.slots.free_slots > 0

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

    def _admit(self, stream: Stream) -> None:
        """Step-boundary admission: token 0 is the argmax of the prefill
        logits (first maximum, as solo generate), the B=1 cache goes
        into a free slot.  A device failure releases the slot and fails
        the group: a waiter never hangs on a dead admission."""
        slot = self.slots.acquire()
        assert slot is not None, "admission without a free slot"
        stream.last_slot = slot
        try:
            with self.device_lock:
                first = int(torch.argmax(stream.logits[0]))
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
                           row=stream.row, slot=slot)
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
        if stream.done():   # new == 1, or an instant eos
            stream.cache = None
            self.slots.release(slot)
            stream.slot = slot          # zero-length decode span
            self._complete(stream)      # still keys the slot id
            stream.slot = None
            self._count_admitted(stream.group.priority)
            self.evicted_total += 1
            return
        try:
            with self.device_lock:
                # Feed the last committed token at its absolute
                # position (token 0 at p_len).
                self.slots.insert(slot, stream.cache, stream.out[-1],
                                  stream.p_len + len(stream.out) - 1)
        except Exception as e:
            self.slots.release(slot)
            self._fail_group(stream.group, e)
            return
        stream.cache = None             # the pool owns the KV now
        stream.slot = slot
        self._resident[slot] = stream
        self._count_admitted(stream.group.priority)

    def _count_admitted(self, priority: str) -> None:
        self.admitted_total += 1
        self.admitted_by_class[priority] += 1

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

    def _decode_step(self) -> None:
        """Advance every resident stream by one fused window of decode
        steps; evict finished streams so their slots are admissible the
        SAME boundary.  Within a window a stream stops consuming at its
        own eos/budget (later window tokens are discardable garbage)."""
        window = self._pick_window()
        occupancy = len(self._resident)
        t0 = time.perf_counter()
        with self.device_lock:
            toks_w = self.slots.step(window)            # [W, S]
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
        self.tel.step("step", t0, t1, kind="plain", window=window,
                      occupancy=occupancy, batch=self.slots.n_slots,
                      tokens=emitted,
                      device_s=round(self.slots.last_step_device_s, 6))

    # -- completion -----------------------------------------------------

    def _complete(self, stream: Stream) -> None:
        group = stream.group
        stream.t_done = time.perf_counter()
        if stream.t_admit is not None:
            self._emit(stream, "decode", stream.t_admit, stream.t_done,
                       row=stream.row, slot=stream.slot,
                       tokens=len(stream.out))
        self._emit_instant(stream, "complete", stream.t_done,
                           row=stream.row, tokens=len(stream.out))
        group.complete_row(stream)
        if group.event.is_set() and group.error is None:
            self.completed_total += 1
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
            "kind": "greedy",
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
                "kind": "greedy",
                "priority": s.group.priority,
                "position": s.p_len + len(s.out) - 1,
                "tokens_out": len(s.out),
                "remaining": s.new - len(s.out),
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
        return {
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

    def stats(self) -> Dict[str, Any]:
        return {
            "slots": self.slots.n_slots,
            "slots_active": self.slots.active_slots,
            "slot_occupancy": round(
                self.slots.active_slots / self.slots.n_slots, 4),
            "queue_len": len(self.queue),
            "queue_depth": self.policy.queue_depth,
            "admitted_total": self.admitted_total,
            "evicted_total": self.evicted_total,
            "decode_steps_total": self.decode_steps_total,
            "decode_dispatches_total": self.decode_dispatches_total,
            "prefill_chunks_total": self.prefill_chunks_total,
            "completed_total": self.completed_total,
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
            # Recompile sentinel: a miss is a CUDA-graph capture (a
            # window's first eager run on the CPU), a hit a replay;
            # after warm-up the misses must stay put.
            **self.sentinel.snapshot(),
        }
