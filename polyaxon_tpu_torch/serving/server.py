"""Model server: the port's decode stack behind HTTP.

Port of ``polyaxon_tpu/serving/server.py`` with ``batching=
"continuous"``: every request, greedy or sampled, becomes per-row
decode streams through the continuous-batching engine (engine.py) over
the fixed-lane slot pool (slots.py) or, with ``kv_paged``, the paged
pool (paged.py), and the front-end sheds load with 429 + Retry-After
once the bounded admission queue fills.  One process, stdlib HTTP.

Endpoints:

- ``GET  /healthz``  -> ``{"status": "ok", ...}`` (readiness; 503
  ``{"status": "unavailable", "reason": "draining"}`` after /drain)
- ``GET  /info``     -> model name, config summary, engine counters
- ``GET  /metrics``  -> Prometheus text: counters, phase summaries,
  latency histograms (telemetry.py), engine gauges
- ``GET  /trace``    -> Chrome trace-event JSON of the telemetry ring
- ``GET  /requests[?status=&limit=]``, ``GET /requests/<id>`` -> the
  terminal-record retention ring (debug.py)
- ``GET  /debug/state`` -> the engine's latest step-boundary snapshot
- ``POST /generate`` -> ``{"prompt": [ids] | [[ids], ...],
  "max_new_tokens": N, "temperature": t, "top_k": k, "top_p": p,
  "seed": s, "eos_id": e, "prefill_chunk": C, "priority": p,
  "deadline_ms": d, "timings": bool}`` -> tokens + timing
- ``POST /drain``    -> stop admission, finish in-flight work

``temperature > 0`` samples under the position-keyed contract (row r's
i-th token draws with ``fold_in(fold_in(PRNGKey(seed), r), i)``), so a
response equals solo ``generate_positional`` with the same seed.  A
request for what the port does not serve yet — ``num_beams > 1``,
``speculative``/``spec_k``, ``resume_tokens``, ``POST /prefill`` and
``/prefix/*`` (the prefix cache), ``POST /profile/*`` — gets a 501
naming the missing feature, never another route's answer.  Validation
errors are the reference's 400s.

Device discipline: handler threads do no tensor work; the engine
thread owns every CUDA call, under ``device_lock`` (a FairLock).
"""

from __future__ import annotations

import json
import select
import socket
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from .debug import (RequestHistory, events_to_dicts, new_request_id,
                    sanitize_request_id)
from .engine import DecodeEngine
from .forensics import ForensicsCore, compute_ledger
from .scheduler import (DeadlineExceeded, PRIORITIES, QueueFullError,
                        RequestCancelled, SamplingSpec, SchedulerPolicy,
                        ShedError)
from .telemetry import Telemetry, render_compile_cache

_span_dicts = events_to_dicts


def _int_param(v):
    """int() that refuses booleans: int(True) == 1 would silently
    accept {"num_beams": true} / {"prefill_chunk": true}."""
    if isinstance(v, bool):
        raise ValueError("expected an integer, got a boolean")
    return int(v)


def _parse_prompt_rows(req, max_batch: int):
    """/generate prompt validation: returns the row-wrapped token lists
    (one shared length, ints-not-bools, batch-capped)."""
    if not isinstance(req, dict):
        raise ValueError("request body must be a JSON object")
    rows = req.get("prompt")
    if rows is None:
        raise ValueError("missing 'prompt'")
    if not isinstance(rows, list):
        raise ValueError("'prompt' must be a list of token ids "
                         "or a list of rows")
    if rows and not isinstance(rows[0], list):
        rows = [rows]
    if not rows or not rows[0]:
        raise ValueError("prompt must contain at least one token")
    if len(rows) > max_batch:
        raise ValueError(f"batch {len(rows)} exceeds max_batch "
                         f"{max_batch}")
    if len({len(r) for r in rows}) != 1:
        # No silent padding: the decode path has no attention
        # mask, so padded positions would be attended to.
        raise ValueError(
            "all prompt rows must share one length (the decode "
            "path has no pad mask; bucket lengths client-side)")
    if any(not all(isinstance(t, int) and not isinstance(t, bool)
                   for t in r) for r in rows):
        # bool is an int subclass: [true, false] must not silently
        # decode as tokens [1, 0].
        raise ValueError("prompt rows must be integer token ids")
    return rows


class FairLock:
    """``threading.Lock`` with FIFO-ish handoff — a turnstile guards
    entry, so a releasing thread that immediately re-acquires (the
    engine's step loop does exactly this, every boundary) queues BEHIND
    threads already waiting instead of barging past them: acquire the
    door, then the inner lock, release the door once inside."""

    def __init__(self):
        self._door = threading.Lock()
        self._inner = threading.Lock()
        self._waiting = 0

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        if not blocking:
            if not self._door.acquire(False):
                return False
            try:
                return self._inner.acquire(False)
            finally:
                self._door.release()
        # Advisory waiter count (GIL-coarse, no extra lock): the
        # engine's window-fuse decision polls it to drop to
        # single-step granularity while external device work waits.
        self._waiting += 1
        try:
            if timeout is None or timeout < 0:
                with self._door:
                    return self._inner.acquire()
            deadline = time.monotonic() + timeout
            if not self._door.acquire(True, timeout):
                return False
            try:
                rem = max(0.0, deadline - time.monotonic())
                return self._inner.acquire(True, rem)
            finally:
                self._door.release()
        finally:
            self._waiting -= 1

    def waiters(self) -> int:
        """Threads currently blocked in :meth:`acquire`."""
        return self._waiting

    def release(self) -> None:
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


class ModelServer:
    """Wraps one model; owns the device lock, the continuous-batching
    engine, telemetry and the request-history ring."""

    def __init__(self, model, *, model_name: str = "model",
                 max_batch: int = 8,
                 n_slots: int = 8, queue_depth: int = 64,
                 prefill_chunk: Optional[int] = None,
                 decode_window: int = 8,
                 request_timeout_s: Optional[float] = 600.0,
                 access_log: bool = False,
                 request_history: int = 256,
                 kv_paged: bool = False, kv_page_tokens: int = 64,
                 kv_pages: Optional[int] = None,
                 kv_lazy: bool = False):
        if kv_lazy and not kv_paged:
            raise ValueError(
                "kv_lazy requires kv_paged (lazy growth is a page-"
                "reservation policy; fixed lanes have no pages)")
        self.kv_paged = bool(kv_paged)
        self.kv_lazy = bool(kv_lazy)
        self.model = model
        self.batching = "continuous"
        self.model_name = model_name
        self.max_batch = int(max_batch)
        self.telemetry = Telemetry(exemplar_k=4)
        from ..analysis.recompile import RecompileSentinel

        self.recompile = RecompileSentinel(telemetry=self.telemetry)
        self.access_log = bool(access_log)
        self._access_log_file = sys.stderr
        self.default_priority = "interactive"
        if request_timeout_s is not None and request_timeout_s <= 0:
            raise ValueError(f"request_timeout_s must be > 0; got "
                             f"{request_timeout_s}")
        self.request_timeout_s = request_timeout_s
        self.draining = False
        self.drain_rejected = 0
        self._lock = FairLock()
        self.requests = 0
        self.engine = DecodeEngine(
            model,
            policy=SchedulerPolicy(
                n_slots=n_slots, queue_depth=queue_depth,
                prefill_chunk=prefill_chunk,
                decode_window=decode_window, kv_paged=kv_paged,
                kv_page_tokens=kv_page_tokens, kv_pages=kv_pages,
                kv_lazy=kv_lazy),
            device_lock=self._lock,
            telemetry=self.telemetry,
            sentinel=self.recompile)
        # /metrics counters under _stats_lock — never the device lock.
        self._stats_lock = threading.Lock()
        self.errors = 0
        self._lat_sum = 0.0
        self._lat_count = 0
        self._tokens_out = 0
        self._queue_s_sum = 0.0
        self._prefill_s_sum = 0.0
        self._decode_s_sum = 0.0
        self._breakdown_count = 0
        self.history = RequestHistory(request_history)
        self.engine.history = self.history
        # Per-request phase ledgers behind the per-phase /metrics
        # families (serving/forensics.py).
        self.forensics = ForensicsCore(
            snapshot_fn=lambda: self.engine.build_debug_snapshot(
                forced=True),
            trace_tail_fn=lambda: self.telemetry.events()[-256:],
            record_fn=self.history.get)
        self.engine.forensics = self.forensics

    def close(self) -> None:
        """Stop the engine loop thread (idempotent)."""
        self.engine.close()

    # -- request lifecycle ----------------------------------------------

    def drain(self) -> Dict[str, Any]:
        """POST /drain: stop admitting (new requests shed with 503
        ``draining``), let in-flight work finish, and turn /healthz
        readiness off.  Idempotent; returns the in-flight snapshot."""
        self.draining = True
        self.engine.drain()
        return self.drain_status()

    def drain_status(self) -> Dict[str, Any]:
        es = self.engine.stats()
        return {"draining": self.draining,
                "drain_rejected": self.drain_rejected,
                "slots_active": es["slots_active"],
                "queue_len": es["queue_len"]}

    def debug_state(self) -> Dict[str, Any]:
        """``GET /debug/state``: the snapshot the engine published at
        its most recent step boundary (never the device lock)."""
        now = time.perf_counter()
        out: Dict[str, Any] = {
            "model": self.model_name,
            "batching": self.batching,
            "draining": self.draining,
            "history": self.history.stats(),
        }
        snap = self.engine.debug_board.latest()
        if snap is not None:
            snap["age_s"] = round(max(0.0, now - snap["t"]), 3)
            del snap["t"]
        out["engine"] = snap
        return out

    def record_front(self, rid: Optional[str], path: str,
                     status: int, req, resp) -> None:
        """Minimal front-end history record for a request the ENGINE
        never recorded (validation 400s, sheds, 501s)."""
        if rid is None or not self.history.enabled:
            return
        front_status = {200: "complete", 429: "shed", 503: "shed",
                        504: "expired", 499: "cancelled"}.get(
                            int(status), "failed")
        rec: Dict[str, Any] = {
            "request_id": rid, "t": round(time.time(), 3),
            "path": path, "http_status": int(status),
            "status": front_status}
        if isinstance(req, dict):
            rec["kind"] = self._request_kind(req)
        if isinstance(resp, dict):
            if resp.get("error"):
                rec["error"] = str(resp["error"])[:300]
            if resp.get("reason"):
                rec["reason"] = resp["reason"]
            if "wall_s" in resp:
                rec["wall_s"] = resp["wall_s"]
        self.history.record_front(rec)

    def _check_not_draining(self) -> None:
        if self.draining:
            with self._stats_lock:
                self.drain_rejected += 1
            raise ShedError(
                "server is draining: finishing in-flight requests, "
                "admitting none", reason="draining")

    def _wait_group(self, group, cancel_check=None) -> None:
        """Bounded wait for an engine group: a client disconnect
        (499), the request's deadline (504) or ``request_timeout_s``
        (503 ``request_timeout``) cancel it at the engine's next
        boundary and raise here."""
        cap = None
        if self.request_timeout_s is not None:
            cap = group.t_submit + self.request_timeout_s
        while not group.event.wait(0.1):
            now = time.perf_counter()
            if cancel_check is not None and cancel_check():
                err = RequestCancelled(
                    "client disconnected; request cancelled")
                self.engine.cancel(group, err)
                raise err
            if group.deadline is not None and now > group.deadline:
                err = DeadlineExceeded(
                    f"deadline exceeded after "
                    f"{now - group.t_submit:.3f}s "
                    f"({group.status_phase()})")
                self.engine.cancel(group, err)
                raise err
            if cap is not None and now > cap:
                err = ShedError(
                    f"request exceeded the server request timeout "
                    f"({self.request_timeout_s}s) without reaching a "
                    f"terminal state; shedding the waiter",
                    reason="request_timeout")
                self.engine.cancel(group, err)
                raise err
        if group.error is not None:
            raise group.error

    def log_access(self, method: str, path: str, status: int,
                   req, resp, dt: float,
                   rid: Optional[str] = None) -> None:
        """One structured JSON line per request on stderr (--access-
        log)."""
        if not self.access_log:
            return
        rec: Dict[str, Any] = {
            "t": round(time.time(), 3), "method": method,
            "path": path, "status": int(status),
            "ms": round(1e3 * dt, 3)}
        if rid is not None:
            rec["request_id"] = rid
        if isinstance(resp, dict) and "slot" in resp:
            rec["slot"] = resp["slot"]
        if isinstance(req, dict):
            rec["kind"] = self._request_kind(req)
            rows = req.get("prompt")
            if isinstance(rows, list) and rows:
                rec["rows"] = len(rows) \
                    if isinstance(rows[0], list) else 1
        if isinstance(resp, dict):
            if status == 200 and "new_tokens" in resp:
                rec["new_tokens"] = sum(
                    len(r) for r in resp["new_tokens"]
                    if isinstance(r, list))
            err = resp.get("error")
            if err:
                rec["error"] = str(err)[:200]
        try:
            print(json.dumps(rec), file=self._access_log_file,
                  flush=True)
        except Exception:
            pass  # logging must never fail a request

    @staticmethod
    def _request_kind(req: Dict[str, Any]) -> str:
        if req.get("speculative") is True:
            return "speculative"
        beams = req.get("num_beams")
        if isinstance(beams, int) and not isinstance(beams, bool) \
                and beams > 1:
            return "beam"
        temp = req.get("temperature", 0)
        if isinstance(temp, (int, float)) \
                and not isinstance(temp, bool) and temp > 0:
            return "sampled"
        return "greedy"

    def _note_breakdown(self, queue_s: float, prefill_s: float,
                        decode_s: float) -> None:
        with self._stats_lock:
            self._queue_s_sum += queue_s
            self._prefill_s_sum += prefill_s
            self._decode_s_sum += decode_s
            self._breakdown_count += 1

    # -- /generate -------------------------------------------------------

    def generate(self, req: Dict[str, Any],
                 cancel_check=None,
                 rid: Optional[str] = None) -> Dict[str, Any]:
        if rid is None:
            rid = new_request_id()
        self._check_not_draining()
        rows = _parse_prompt_rows(req, self.max_batch)
        _int = _int_param

        def _float(v):
            # float(True) == 1.0: {"temperature": true} must not
            # silently switch greedy to temp-1.0 sampling.
            if isinstance(v, bool):
                raise ValueError("expected a number, got a boolean")
            return float(v)

        try:
            new = _int(req.get("max_new_tokens", 32))
            temp = _float(req.get("temperature", 0.0))
            top_k = req.get("top_k")
            top_k = None if top_k is None else _int(top_k)
            top_p = req.get("top_p")
            top_p = None if top_p is None else _float(top_p)
            eos = req.get("eos_id")
            eos = None if eos is None else _int(eos)
            beams = _int(req.get("num_beams", 1))
            seed = _int(req.get("seed", 0))
        except (TypeError, ValueError):
            raise ValueError(
                "sampling params must be scalars (temperature/top_p "
                "float, max_new_tokens/top_k/eos_id/num_beams/seed "
                "int, not booleans)")
        if new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        from ..models.generate import (_check_temperature, _check_top_k,
                                       _check_top_p)

        _check_top_k(top_k, getattr(getattr(self.model, "cfg", None),
                                    "vocab_size", None))
        _check_top_p(top_p)
        _check_temperature(temp)
        if beams > 1 and (temp != 0.0 or top_k is not None
                          or top_p is not None):
            raise ValueError(
                "beam search is deterministic; temperature/top_k/"
                "top_p cannot be combined with num_beams > 1")
        speculative = req.get("speculative", False)
        if not isinstance(speculative, bool):
            raise ValueError("'speculative' must be a JSON boolean")
        want_timings = req.get("timings", False)
        if not isinstance(want_timings, bool):
            raise ValueError("'timings' must be a JSON boolean")
        priority = req.get("priority", self.default_priority)
        if priority not in PRIORITIES:
            raise ValueError(
                f"priority must be one of {list(PRIORITIES)}; got "
                f"{priority!r}")
        deadline_ms = req.get("deadline_ms")
        if deadline_ms is not None:
            try:
                deadline_ms = _int(deadline_ms)
            except (TypeError, ValueError):
                raise ValueError("deadline_ms must be an int")
            if deadline_ms < 1:
                raise ValueError("deadline_ms must be >= 1")
        deadline_s = None if deadline_ms is None else deadline_ms / 1e3
        chunk = req.get("prefill_chunk")
        try:
            chunk = None if chunk is None else _int(chunk)
        except (TypeError, ValueError):
            raise ValueError("prefill_chunk must be an int")
        if chunk is not None and chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        p_len = len(rows[0])
        if chunk is not None and chunk >= p_len:
            chunk = None
        max_pos = getattr(getattr(self.model, "cfg", None),
                          "max_position", None)
        if max_pos is not None and p_len + new > max_pos:
            raise ValueError(
                f"prompt ({p_len}) + max_new_tokens ({new}) exceeds "
                f"the model's max_position ({max_pos})")
        # What this slice does not serve yet: named, never rerouted.
        if speculative or "spec_k" in req:
            raise NotImplementedError(
                "speculative decoding (speculative / spec_k) is not "
                "ported to the PyTorch backend yet (ROADMAP Queue 1: "
                "beam and speculative decoding)")
        if beams > 1:
            raise NotImplementedError(
                "beam search (num_beams > 1) is not ported to the "
                "PyTorch backend yet (ROADMAP Queue 1: beam and "
                "speculative decoding)")
        if req.get("resume_tokens"):
            raise NotImplementedError(
                "resume_tokens (cross-replica resume) is not ported "
                "yet (ROADMAP Queue 1: the router)")
        toks = np.asarray(rows, np.int64)
        # temperature 0 is greedy (top_k/top_p inert, as in solo
        # generate); temperature > 0 samples per slot, position-keyed.
        sampling = SamplingSpec(seed, temp, top_k, top_p) \
            if temp != 0.0 else None
        t0 = time.perf_counter()
        # CONTINUOUS BATCHING: per-row decode streams through the slot
        # pool.  May raise QueueFullError -> 429, ShedError -> 503.
        group = self.engine.submit(toks, new, eos, chunk,
                                   sampling=sampling,
                                   record_timings=want_timings,
                                   priority=priority,
                                   deadline_s=deadline_s, rid=rid)
        self._wait_group(group, cancel_check)
        out = group.result()
        breakdown = group.breakdown()
        with self._stats_lock:
            self.requests += 1
        dt = time.perf_counter() - t0
        self._note_breakdown(*breakdown)
        tokens_done = sum(len(s.out) for s in group.streams)
        self.telemetry.observe("queue_wait", breakdown[0], exemplar=rid)
        self.telemetry.observe("prefill", breakdown[1], exemplar=rid)
        self.telemetry.observe(
            "decode_per_token", breakdown[2] / max(1, tokens_done),
            exemplar=rid)
        ttft = dt
        if group.t_first_admit is not None:
            ttft = group.t_first_admit - group.t_submit
        self.telemetry.observe("ttft", ttft, exemplar=rid)
        self.telemetry.observe("total", dt, exemplar=rid)
        timings = None
        if want_timings:
            all_events: List = []
            for s in group.streams:
                if s.events:
                    all_events.extend(s.events)
            t_done = group.t_done if group.t_done is not None \
                else t0 + dt
            timings = {
                "ttft_ms": round(1e3 * ttft, 3),
                "streams": [{"row": s.row,
                             "spans": _span_dicts(s.events or [],
                                                  group.t_submit)}
                            for s in group.streams],
                "phases": compute_ledger(all_events, group.t_submit,
                                         t_done)}
        with self._stats_lock:
            self._lat_sum += dt
            self._lat_count += 1
            self._tokens_out += len(rows) * new
        slots_used = [s.last_slot for s in group.streams
                      if s.last_slot is not None]
        return {
            "model": self.model_name,
            "request_id": rid,
            "new_tokens": out[:, p_len:].tolist(),
            "tokens": out.tolist(),
            "wall_s": round(dt, 4),
            "tok_per_sec": round(len(rows) * new / dt, 1),
            **({"slot": slots_used[0] if len(slots_used) == 1
                else slots_used} if slots_used else {}),
            "ttft_ms": round(1e3 * ttft, 3),
            "queue_ms": round(1e3 * breakdown[0], 3),
            "prefill_ms": round(1e3 * breakdown[1], 3),
            "decode_ms": round(1e3 * breakdown[2], 3),
            **({"timings": timings} if timings is not None else {}),
        }

    # -- introspection --------------------------------------------------

    def info(self) -> Dict[str, Any]:
        cfg = getattr(self.model, "cfg", None)
        summary = {}
        if cfg is not None:
            for f in ("vocab_size", "hidden_size", "num_layers",
                      "num_heads", "max_position"):
                v = getattr(cfg, f, None)
                if v is not None:
                    summary[f] = v
            summary["dtype"] = str(cfg.dtype).removeprefix("torch.")
        engine = self.engine.stats()
        compile_cache = self.recompile.snapshot()
        return {"model": self.model_name, "config": summary,
                "backend": self.model.device.type,
                "max_batch": self.max_batch,
                "batching": self.batching,
                "default_priority": self.default_priority,
                "draining": self.draining,
                "drain_rejected_total": self.drain_rejected,
                "routing": {"greedy": "engine",
                            "sampled": "engine",
                            "speculative": "not ported",
                            "beam": "not ported"},
                "kv_paged": self.kv_paged,
                "kv_lazy": self.kv_lazy,
                # A compile-cache miss is a CUDA-graph capture (the
                # first eager run of a window on the CPU).
                "compile_cache_misses":
                    compile_cache["compile_cache_misses"],
                "compile_cache": compile_cache,
                "debug": self.history.stats(),
                "requests": self.requests,
                **{k: v for k, v in engine.items()
                   if not k.startswith("compile_cache")}}

    def metrics_text(self) -> str:
        """Prometheus text exposition of the serving counters, the
        per-request queue/prefill/decode phase summaries, the latency
        histograms and the engine gauges."""
        es = self.engine.stats()
        with self._stats_lock:
            lat_sum, lat_count = self._lat_sum, self._lat_count
            toks, errs = self._tokens_out, self.errors
            q_sum, p_sum, d_sum, bd_count = (
                self._queue_s_sum, self._prefill_s_sum,
                self._decode_s_sum, self._breakdown_count)
        lines = [
            "# TYPE ptpu_serving_requests_total counter",
            f"ptpu_serving_requests_total {self.requests}",
            "# TYPE ptpu_serving_errors_total counter",
            f"ptpu_serving_errors_total {errs}",
            "# TYPE ptpu_serving_rejected_total counter",
            f"ptpu_serving_rejected_total {es['rejected_total']}",
            "# TYPE ptpu_serving_tokens_generated_total counter",
            f"ptpu_serving_tokens_generated_total {toks}",
            "# TYPE ptpu_serving_request_seconds summary",
            f"ptpu_serving_request_seconds_sum {lat_sum:.6f}",
            f"ptpu_serving_request_seconds_count {lat_count}",
            "# TYPE ptpu_serving_queue_seconds summary",
            f"ptpu_serving_queue_seconds_sum {q_sum:.6f}",
            f"ptpu_serving_queue_seconds_count {bd_count}",
            "# TYPE ptpu_serving_prefill_seconds summary",
            f"ptpu_serving_prefill_seconds_sum {p_sum:.6f}",
            f"ptpu_serving_prefill_seconds_count {bd_count}",
            "# TYPE ptpu_serving_decode_seconds summary",
            f"ptpu_serving_decode_seconds_sum {d_sum:.6f}",
            f"ptpu_serving_decode_seconds_count {bd_count}",
            "# TYPE ptpu_serving_drain_rejected_total counter",
            f"ptpu_serving_drain_rejected_total {self.drain_rejected}",
            "# TYPE ptpu_serving_request_records gauge",
            f"ptpu_serving_request_records {len(self.history)}",
            "# TYPE ptpu_serving_request_records_evicted_total "
            "counter",
            f"ptpu_serving_request_records_evicted_total "
            f"{self.history.evicted_total}",
        ]
        lines += render_compile_cache(self.recompile.snapshot())
        lines += self.telemetry.metrics_lines()
        lines += self.forensics.metrics_lines("ptpu_serving")
        gauges = ("slots", "slots_active", "slot_occupancy",
                  "queue_len", "queue_depth", "queue_len_interactive",
                  "queue_len_batch")
        counters = ("admitted_total", "admitted_interactive_total",
                    "admitted_batch_total", "admitted_greedy_total",
                    "admitted_sampled_total", "completed_total",
                    "completed_greedy_total", "completed_sampled_total",
                    "evicted_total", "cancelled_total", "shed_total",
                    "shed_interactive_total", "shed_batch_total",
                    "decode_steps_total", "decode_dispatches_total",
                    "prefill_chunks_total", "telemetry_errors_total",
                    "step_device_seconds_total",
                    "step_wall_seconds_total", "shed_kv_pages_total",
                    "kv_preempt_exhaustion_total", "preempted_total",
                    "requests_requeued_total", "resumed_total")
        for key in gauges:
            lines += [f"# TYPE ptpu_serving_{key} gauge",
                      f"ptpu_serving_{key} {es[key]}"]
        for key in counters:
            lines += [f"# TYPE ptpu_serving_{key} counter",
                      f"ptpu_serving_{key} {es[key]}"]
        if "kv_pages" in es:
            # The page pool's occupancy (kv_paged engines only).
            for key in ("kv_pages", "kv_page_tokens", "kv_pages_free",
                        "kv_pages_resident", "kv_pages_shared"):
                lines += [f"# TYPE ptpu_serving_{key} gauge",
                          f"ptpu_serving_{key} {es[key]}"]
            lines += ["# TYPE ptpu_serving_kv_lazy gauge",
                      f"ptpu_serving_kv_lazy {1 if es['kv_lazy'] else 0}"]
            for key in ("kv_pages_lazy_growths_total",
                        "kv_pages_lazy_grown_total"):
                lines += [f"# TYPE ptpu_serving_{key} counter",
                          f"ptpu_serving_{key} {es[key]}"]
        lines += [
            "# TYPE ptpu_serving_deadline_expired_total counter",
            f"ptpu_serving_deadline_expired_total "
            f"{es['expired_total']}",
            "# TYPE ptpu_serving_draining gauge",
            f"ptpu_serving_draining {1 if es['draining'] else 0}",
        ]
        return "\n".join(lines) + "\n"


def _disconnect_probe(conn):
    """A zero-cost poll for "is the client still there?" while a
    handler waits on an engine group: after the request body a
    well-behaved client sends nothing until the response, so a
    readable socket whose peek returns b"" means the peer closed."""
    def check() -> bool:
        try:
            p = select.poll()
            p.register(conn.fileno(), select.POLLIN)
            if not p.poll(0):
                return False
            return conn.recv(1, socket.MSG_PEEK) == b""
        except (OSError, ValueError):
            return True     # probe failed: the socket is gone
    return check


class _ServingHTTPServer(ThreadingHTTPServer):
    # The admission queue, not the listen backlog, is the intended
    # backpressure surface (the stdlib default backlog is 5).
    request_queue_size = 128
    daemon_threads = True


def make_server(host: str, port: int, ms: ModelServer
                ) -> ThreadingHTTPServer:
    return _ServingHTTPServer((host, port), make_handler(ms))


# POST routes of the reference that this slice answers with a 501.
_NOT_PORTED_POST = {
    "/prefill": "the prefix cache (POST /prefill) is not ported yet "
                "(ROADMAP Queue 1: the radix prefix cache)",
    "/profile/start": "profiling (POST /profile/*) is not ported yet "
                      "(ROADMAP Queue 1: ProfileSession on "
                      "torch.profiler)",
    "/profile/stop": "profiling (POST /profile/*) is not ported yet "
                     "(ROADMAP Queue 1: ProfileSession on "
                     "torch.profiler)",
}


def _not_ported_post(path: str) -> Optional[str]:
    if path in _NOT_PORTED_POST:
        return _NOT_PORTED_POST[path]
    if path.startswith("/prefix/"):
        return ("the fleet prefix cache (POST /prefix/*) is not ported "
                "yet (ROADMAP Queue 1: the spill tier and its wire "
                "format)")
    return None


def make_handler(ms: ModelServer):
    """The request-handler CLASS for ``ms`` (what ``make_server``
    binds)."""
    class Handler(BaseHTTPRequestHandler):
        def _req_id(self) -> str:
            rid = sanitize_request_id(
                self.headers.get("X-Request-Id"))
            self._rid = rid or new_request_id()
            return self._rid

        def _send_raw(self, code: int, body: bytes, ctype: str,
                      extra=None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            rid = getattr(self, "_rid", None)
            if rid is None:
                rid = self._rid = new_request_id()
            self.send_header("X-Request-Id", rid)
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send(self, code: int, obj: Dict[str, Any],
                  extra=None) -> None:
            self._send_raw(code, json.dumps(obj).encode(),
                           "application/json", extra)

        def log_message(self, fmt, *args):
            pass  # the structured access log (--access-log) replaces it

        def do_GET(self):
            self._req_id()
            path = urlparse(self.path).path
            if path == "/requests" or path.startswith("/requests/") \
                    or path == "/debug/state":
                self._do_debug_get(path)
            elif path == "/healthz":
                if ms.draining:
                    self._send(503, {"status": "unavailable",
                                     "reason": "draining",
                                     "model": ms.model_name,
                                     **ms.drain_status()})
                else:
                    self._send(200, {"status": "ok",
                                     "model": ms.model_name,
                                     "t": time.time()})
            elif path == "/info":
                self._send(200, ms.info())
            elif path == "/metrics":
                self._send_raw(200, ms.metrics_text().encode(),
                               "text/plain; version=0.0.4")
            elif path == "/trace":
                self._send(200, ms.telemetry.chrome_trace())
            elif path in ("/profile/report", "/prefix/index"):
                self._send(501, {
                    "error": f"GET {path} is not ported to the PyTorch "
                             f"backend yet (ROADMAP Queue 1)",
                    "reason": "not_ported"})
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def _do_debug_get(self, path: str):
            if path == "/debug/state":
                self._send(200, ms.debug_state())
                return
            if not ms.history.enabled:
                self._send(400, {
                    "error": "request history disabled (start the "
                             "server with --request-history N)"})
                return
            if path in ("/requests", "/requests/"):
                q = parse_qs(urlparse(self.path).query)
                status = (q.get("status") or [None])[0]
                try:
                    limit = int((q.get("limit") or ["100"])[0])
                except ValueError:
                    self._send(400,
                               {"error": "limit must be an int"})
                    return
                self._send(200, {
                    "requests": ms.history.list(status=status,
                                                limit=limit),
                    **ms.history.stats()})
                return
            want = path[len("/requests/"):]
            rec = ms.history.get(want)
            if rec is None:
                self._send(404, {
                    "error": f"no record for request {want!r} "
                             f"(never seen, or rolled off the "
                             f"{ms.history.capacity}-record "
                             f"retention ring)"})
            else:
                self._send(200, rec)

        def do_POST(self):
            rid = self._req_id()
            t0 = time.perf_counter()
            if self.path == "/drain":
                resp = ms.drain()
                try:
                    self._send(200, resp)
                except OSError:
                    pass
                ms.log_access("POST", self.path, 200, None, resp,
                              time.perf_counter() - t0, rid=rid)
                return
            missing = _not_ported_post(self.path)
            if missing is not None:
                resp = {"error": missing, "reason": "not_ported",
                        "request_id": rid}
                self._send(501, resp)
                ms.log_access("POST", self.path, 501, None, resp,
                              time.perf_counter() - t0, rid=rid)
                return
            if self.path != "/generate":
                self._send(404, {"error": f"no route {self.path}"})
                return
            # Generate FIRST, send after: a client hanging up while a
            # successful response streams out is not a serving error.
            extra = None
            req = None
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                code, resp = 200, ms.generate(
                    req, cancel_check=_disconnect_probe(
                        self.connection), rid=rid)
            except ShedError as e:
                code = 503
                resp = {"error": str(e), "reason": e.reason}
                if e.retry_after:
                    extra = {"Retry-After": str(e.retry_after)}
            except DeadlineExceeded as e:
                code, resp = 504, {"error": str(e),
                                   "reason": "deadline"}
            except RequestCancelled as e:
                code, resp = 499, {"error": str(e),
                                   "reason": "cancelled"}
            except QueueFullError as e:
                # Explicit backpressure: the bounded admission queue
                # is full (counted by AdmissionQueue.submit).
                code = 429
                resp = {"error": str(e),
                        "retry_after": e.retry_after}
                extra = {"Retry-After": str(e.retry_after)}
            except NotImplementedError as e:
                code, resp = 501, {"error": str(e),
                                   "reason": "not_ported"}
            except ValueError as e:
                with ms._stats_lock:
                    ms.errors += 1
                code, resp = 400, {"error": str(e)}
            except Exception as e:  # never kill the server thread
                with ms._stats_lock:
                    ms.errors += 1
                code, resp = 500, {"error": f"{type(e).__name__}: {e}"}
            if isinstance(resp, dict):
                resp.setdefault("request_id", rid)
            try:
                self._send(code, resp, extra)
            except OSError:
                pass  # client went away mid-write
            ms.log_access("POST", self.path, code, req, resp,
                          time.perf_counter() - t0, rid=rid)
            ms.record_front(rid, self.path, code, req, resp)

    return Handler
