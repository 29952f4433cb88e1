"""Flight recorder: periodic profiler windows with device-truth
attribution, published live.

The host-side step timings everywhere else
(``SlotKVManager.last_step_device_s``, ``step_device_share``) are
perf_counter deltas around a blocking sync — ESTIMATES that conflate
dispatch overhead, host gaps and real device work.  This module closes
the loop:

- :class:`FlightRecorder` (armed by ``serve --profile-every N
  --profile-steps K``, OFF by default) wraps K decode-step boundaries
  in a single-flight ``torch.profiler`` window every N dispatches,
  analyzes the trace on a background thread through the trace parser
  (analysis/xprof.py: the card's kernels, memcpys and memsets), and
  publishes the latest attribution record — collective share,
  transfer share, host-gap (bubble) share, device-busy fraction, and
  serving MFU — as ``/metrics`` gauges, an ``/info`` ``profiling``
  block, and the ``GET /profile/report`` JSON.  ONE reduction feeds
  all three surfaces (the published record is the report), so they
  can never drift.
- :func:`decode_flops_per_token` is the per-model forward-only flop
  estimate behind the MFU number: the analytic closed forms at 2N (no
  backward pass) plus the position-dependent attention term.  Serving
  MFU = tokens committed in the window x flops/token / (window wall x
  peak flops x devices); the caveats — analytic dense count,
  mean-position attention, nominal peak on unknown hardware — ride
  the record as ``peak_flops_source`` so nobody mistakes the number
  for a measured hardware counter.

Engine-thread cost when disabled: ``engine.recorder is None`` — one
attribute check per dispatch.  When armed, the off-window cost is one
integer bump per dispatch; a window costs the profiler's start and
its disable on the engine thread, which stalls decoding for the
disable (seconds for a GPT-2 medium window on an H100: see
``FlightRecorder._close``); the export and the parse run on the
analyzer thread.  The first profiler start of a process pays the
profiler library's init, so the recorder PRIMES the profiler at
construction — at server startup, never at a traffic-carrying
boundary.

The port's own copy of ``polyaxon_tpu/serving/profiling.py``:
``FlightRecorder`` and ``decode_flops_per_token`` are the reference's;
``detect_peak_flops`` reads the card's name, and a failed prime
raises.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from .telemetry import ENGINE_PID

__all__ = ["FlightRecorder", "decode_flops_per_token",
           "detect_peak_flops", "NOMINAL_PEAK_FLOPS", "H100_PEAK_FLOPS"]

# Dense bf16 tensor-core peak of the H100 SXM part (the HBM3 card
# chip_smoke.py runs on), the figure its training MFU uses.
H100_PEAK_FLOPS = 989e12

# Unknown hardware (the CPU, any other card): a NOMINAL 1 TF/s peak so
# the MFU gauge stays finite and comparable run-to-run on one machine.
# The record labels it ``peak_flops_source: "nominal"`` — a
# utilization TREND there, never a hardware claim.
NOMINAL_PEAK_FLOPS = 1e12


def detect_peak_flops(device=None) -> Dict[str, Any]:
    """``{"peak_flops": per-device peak, "peak_flops_source":
    "device"|"nominal"}`` for ``device`` (default: CUDA device 0 when
    there is one): the H100 SXM (``torch.cuda.get_device_name`` names
    it ``... H100 ... HBM3``) is the one card with a known peak."""
    import torch

    kind = ""
    if (device is None or torch.device(device).type == "cuda") \
            and torch.cuda.is_available():
        dev = torch.device(device) if device is not None \
            else torch.device("cuda", 0)
        kind = torch.cuda.get_device_name(dev).upper()
    if "H100" in kind and ("HBM3" in kind or "SXM" in kind):
        return {"peak_flops": H100_PEAK_FLOPS,
                "peak_flops_source": "device"}
    return {"peak_flops": NOMINAL_PEAK_FLOPS,
            "peak_flops_source": "nominal"}


def decode_flops_per_token(cfg, position: float) -> Optional[float]:
    """Analytic FORWARD flops to decode ONE token at context length
    ``position`` for a decoder-only transformer config, mirroring the
    registry's train-flop conventions at fwd-only cost (2N dense, not
    6N; attention 4*L*position*h fwd, no causal halving — a decode
    step attends to exactly its prefix):

    - dense: 2 * N_matmul (qkv/o/mlp kernels + lm head; embedding
      lookups are gathers and excluded);
    - llama-style (head_dim + num_kv_heads + intermediate_size):
      GQA-shrunk k/v projections and the 3-matmul SwiGLU, exactly as
      ``_llama_train_flops``;
    - MoE (num_experts): one expert MLP per token + the router, as
      ``_moe_train_flops``.

    Returns None for configs the estimate doesn't speak (encoders,
    seq2seq) — MFU is then omitted rather than invented."""
    h = getattr(cfg, "hidden_size", None)
    layers = getattr(cfg, "num_layers", None)
    vocab = getattr(cfg, "vocab_size", None)
    if not h or not layers or not vocab \
            or hasattr(cfg, "d_model") or hasattr(cfg, "num_classes"):
        return None
    head_dim = getattr(cfg, "head_dim", None)
    kv_heads = getattr(cfg, "num_kv_heads", None)
    inter = getattr(cfg, "intermediate_size", None)
    if head_dim and kv_heads and inter:
        per_layer = (2 * h * h + 2 * h * kv_heads * head_dim
                     + 3 * h * inter)
    else:
        per_layer = 4 * h * h + 2 * h * (inter or 4 * h)
    n_experts = getattr(cfg, "num_experts", 0) or 0
    n_matmul = layers * (per_layer + h * n_experts) + h * vocab
    attn = 4.0 * layers * max(0.0, float(position)) * h
    return 2.0 * n_matmul + attn


class FlightRecorder:
    """Periodic single-flight profiler windows over the decode loop.

    The ENGINE THREAD drives :meth:`on_step_start` /
    :meth:`on_step_end` around every decode dispatch (engine.py);
    window analysis runs on a background thread; readers
    (``/metrics``, ``/info``, ``GET /profile/report``) take the
    published record under ``_lock``.  Windows share the server's
    :class:`~.telemetry.ProfileSession`, so a manual
    ``POST /profile/start`` and a recorder window can never race
    ``torch.profiler``'s process-global state: whoever starts first
    owns the session (the other side gets a 409 / skips-and-retries
    at the next boundary)."""

    def __init__(self, session, *, every: int, steps: int = 8,
                 telemetry=None,
                 flops_fn: Optional[Callable[[float],
                                             Optional[float]]] = None,
                 peak_flops: Optional[float] = None,
                 peak_flops_source: str = "device",
                 n_devices: int = 1,
                 position_probe: Optional[Callable[[], float]] = None,
                 history: int = 16, prime: bool = True,
                 max_window_s: float = 10.0):
        if every < 1:
            raise ValueError(f"profile_every must be >= 1; got "
                             f"{every}")
        if steps < 1:
            raise ValueError(f"profile_steps must be >= 1; got "
                             f"{steps}")
        if max_window_s <= 0:
            raise ValueError(f"max_window_s must be > 0; got "
                             f"{max_window_s}")
        self.session = session
        self.every = int(every)
        self.steps = int(steps)
        self.tel = telemetry
        self.flops_fn = flops_fn
        if peak_flops is None:
            d = detect_peak_flops()
            peak_flops = d["peak_flops"]
            peak_flops_source = d["peak_flops_source"]
        self.peak_flops = float(peak_flops)
        self.peak_flops_source = peak_flops_source
        self.n_devices = max(1, int(n_devices))
        self.position_probe = position_probe
        self.max_window_s = float(max_window_s)
        self._lock = threading.Lock()
        # Window open/close transitions: normally engine-thread-only
        # (on_step_start/on_step_end), but the per-window watchdog
        # timer and close() also end windows, so every transition
        # goes under this lock (uncontended next to a multi-ms
        # dispatch).
        self._window_lock = threading.Lock()
        self._latest: Optional[Dict[str, Any]] = None
        self._windows: "deque[Dict[str, Any]]" = deque(
            maxlen=max(1, history))
        self._window: Optional[Dict[str, Any]] = None
        self._since = 0
        self.windows_total = 0      # windows OPENED (engine thread)
        self.windows_analyzed = 0   # records published
        self.windows_skipped = 0    # boundary hit while a MANUAL
        #                             profile owned the session
        self.windows_deferred = 0   # boundary hit while our own
        #                             previous window's async stop
        #                             was still in flight (retried
        #                             at the very next boundary)
        self.last_error: Optional[str] = None
        # Seconds the last window's parse took (off the engine thread).
        self.last_analyze_s: Optional[float] = None
        self._failed_dump: Optional[str] = None
        self._analyzer: Optional[threading.Thread] = None
        if prime:
            self._prime()

    def _prime(self) -> None:
        """Pay the profiler library's first-start init (CUPTI's, on
        the card) HERE, at construction on the slow startup path —
        never at a traffic-carrying step boundary.  A profiler that
        cannot start raises here: the server does not come up with a
        recorder that would never record."""
        self.session.start(owner="recorder-prime", python_tracer=False)
        d = self.session.stop(owner="recorder-prime")
        # The prime's dump carries no traffic — same disk discipline
        # as analyzed windows.
        if d:
            self._discard_dump(d)

    # -- engine-thread hooks --------------------------------------------

    def on_step_start(self) -> None:
        """Called immediately BEFORE a decode dispatch.  Opens a
        window when the cadence is due and the profiler session is
        free (a manual profile in flight defers the window to a later
        boundary instead of erroring); on in-window boundaries it
        samples the pool's mean decode position — BEFORE the
        dispatch, while the streams it measures are still resident —
        for the MFU attention term."""
        with self._window_lock:
            if self._window is not None:
                self._probe_position(self._window)
                return
            self._since += 1
            if self._since < self.every:
                return
            try:
                # python_tracer=False: no Python stacks — the device
                # events and the ptpu_step markers are the attribution
                # inputs (see ProfileSession.start).
                d = self.session.start(owner="recorder",
                                       python_tracer=False)
            except RuntimeError:
                if getattr(self.session, "owner", None) \
                        == "recorder":
                    # Our OWN previous window's async stop is still
                    # in flight — not a manual profile.  Retry at
                    # the very next boundary (the stop completes in
                    # ms) instead of paying a full cadence and
                    # mislabeling the miss as operator activity.
                    self.windows_deferred += 1
                    self._since = self.every
                else:
                    self.windows_skipped += 1
                    self._since = 0  # full cadence before retrying
                return
            except Exception as e:
                # A filesystem/profiler failure opening the window
                # (--profile-dir volume gone read-only, ...) must
                # never escape into the engine tick — it would fail
                # every in-flight request, every N dispatches.
                # Record it and retry at the next cadence (the
                # volume may come back).  last_error is elsewhere
                # written (and always read) under _lock by the
                # analyzer thread — this engine-thread write must
                # agree on the lock or it can vanish under a
                # concurrent _analyze success-clear.
                with self._lock:
                    self.last_error = \
                        f"start: {type(e).__name__}: {e}"
                self.windows_skipped += 1
                self._since = 0
                return
            self._since = 0
            self.windows_total += 1
            w = {"window": self.windows_total, "trace_dir": d,
                 "t0": time.perf_counter(), "steps": 0,
                 "tokens": 0, "pos_sum": 0.0, "pos_n": 0}
            # Watchdog: the engine only reaches on_step_end while
            # traffic flows — if the queue drains mid-window, NO
            # boundary ever closes it, the trace collects forever,
            # and every manual /profile/start 409s against a window
            # that will never end.  The timer force-closes an
            # overdue window (record honestly marked
            # deadline_closed, attribution still anchored to the
            # steps that actually ran).
            t = threading.Timer(self.max_window_s,
                                self._deadline_close,
                                args=(self.windows_total,))
            t.daemon = True
            w["_timer"] = t
            self._window = w
            self._probe_position(w)
            t.start()
        if self.tel is not None:
            self.tel.instant(0, "profile_window_start",
                             time.perf_counter(),
                             pid=ENGINE_PID, id=w["window"])

    def _probe_position(self, w: Dict[str, Any]) -> None:
        if self.position_probe is None:
            return
        try:
            w["pos_sum"] += float(self.position_probe())
            w["pos_n"] += 1
        except Exception:
            # The probe is advisory (it only feeds the MFU attention
            # term); a failure must never break a step boundary.
            import logging

            logging.getLogger(__name__).debug(
                "position probe failed", exc_info=True)

    def on_step_end(self, tokens: int) -> None:
        """Called after a decode dispatch commits; ``tokens`` is the
        number of tokens the dispatch emitted across the pool."""
        with self._window_lock:
            w = self._window
            if w is None:
                return
            w["steps"] += 1
            w["tokens"] += int(tokens)
            if w["steps"] >= self.steps:
                self._close(w)

    def _deadline_close(self, window_id: int) -> None:
        """Watchdog fire: close the window if it is STILL the open
        one (a normal boundary close cancels the timer, but a fire
        racing the cancel must not close the next window)."""
        with self._window_lock:
            w = self._window
            if w is None or w["window"] != window_id:
                return
            w["deadline_closed"] = True
            self._close(w)

    def _close(self, w: Dict[str, Any]) -> None:
        """Window boundary reached (``_window_lock`` held): hand the
        WHOLE close — profiler stop, dump export, parse — to a
        background thread.  The stop itself comes back to the engine
        thread: ``ProfileSession`` runs the profiler's disable on the
        engine's loop thread under the device lock (torch's profiler
        records the thread that starts it), so the engine stalls for
        the whole disable — 1.2-5.5 s a window of 8 GPT-2 medium
        decode dispatches (about 80,000 kernels) on an H100 80GB HBM3
        at 700 W, chip_smoke.py's ``phase_profiling`` — at its next
        loop iteration.  The trace keeps collecting until then, which
        is harmless because the parser anchors attribution to the
        window's own ``ptpu_step`` markers (first ``steps`` of them
        — a dispatch racing the async stop can land an EXTRA marker
        in the dump) — the window is exact however late the stop
        lands.  The profiler session stays owned ("recorder") until
        that stop completes, so a racing manual /profile/start still
        sees single-flight truth."""
        self._seal(w)
        self._spawn(self._finish, w)

    def _seal(self, w: Dict[str, Any]) -> None:
        """End the open window's bookkeeping (``_window_lock`` held):
        the watchdog, the host wall, the mean position, the trace
        instant."""
        self._window = None
        t = w.pop("_timer", None)
        if t is not None:
            t.cancel()
        w["host_wall_s"] = round(time.perf_counter() - w["t0"], 6)
        del w["t0"]
        w["mean_position"] = round(w.pop("pos_sum")
                                   / max(1, w.pop("pos_n")), 1)
        if self.tel is not None:
            self.tel.instant(0, "profile_window_stop",
                             time.perf_counter(),
                             pid=ENGINE_PID, id=w["window"],
                             steps=w["steps"], tokens=w["tokens"])

    def _spawn(self, fn, w: Dict[str, Any]) -> None:
        t = threading.Thread(target=fn, args=(w,),
                             name="flight-recorder", daemon=True)
        self._analyzer = t
        t.start()

    def on_engine_restart(self) -> None:
        """Supervisor recovery hook, on the DYING engine loop thread,
        before the replacement loop starts.  That thread started the
        open window's trace, and torch's profiler is stopped on the
        thread that started it, so the window ends HERE, at the
        steps it saw, and is analyzed like any other; later windows
        and a manual ``/profile/start`` then find the session free,
        as the reference's recorder goes on recording after a
        restart."""
        with self._window_lock:
            w = self._window
            if w is None:
                return
            self._seal(w)
        try:
            self.session.stop(owner="recorder")
        except Exception as e:
            with self._lock:
                self.last_error = f"stop window {w['window']} at the " \
                                  f"engine restart: " \
                                  f"{type(e).__name__}: {e}"
            self._retain_failed_dump(w["trace_dir"])
            return
        self._spawn(self._analyze, w)

    # -- background stop + analysis -------------------------------------

    def _finish(self, w: Dict[str, Any]) -> None:
        while True:
            try:
                self.session.stop(owner="recorder")
                break
            except TimeoutError as e:
                # The engine loop did not take the stop within the
                # runner's timeout (a solo request held the device
                # lock): the call was withdrawn, the trace still runs
                # and this recorder still owns it, and nothing else
                # would ever end it.  Hand the stop over again.
                with self._lock:
                    self.last_error = f"stop window {w['window']}: " \
                                      f"TimeoutError: {e} (retrying)"
                if getattr(self.session, "owner", None) != "recorder":
                    return   # closed meanwhile (ProfileSession.close)
            except Exception as e:
                # ANY other stop failure (owner race, but also OSError
                # from the dump export on a full disk) must be
                # recorded, never allowed to kill the analyzer thread
                # silently.
                with self._lock:
                    self.last_error = f"stop window {w['window']}: " \
                                      f"{type(e).__name__}: {e}"
                self._retain_failed_dump(w["trace_dir"])
                return
        self._analyze(w)

    def _analyze(self, w: Dict[str, Any]) -> None:
        try:
            from ..analysis.xprof import attribute_dump

            # max_steps: anchor to the window's OWN markers — the
            # async stop can let the next dispatch land one more
            # ptpu_step in the dump, which would stretch wall_s over
            # steps the tokens/steps counters never saw.
            t0 = time.perf_counter()
            att = attribute_dump(w["trace_dir"],
                                 max_steps=w["steps"] or None)
            self.last_analyze_s = time.perf_counter() - t0
            rec = self._build_record(w, att)
        except Exception as e:
            with self._lock:
                self.last_error = \
                    f"analyze window {w['window']}: " \
                    f"{type(e).__name__}: {e}"
            self._retain_failed_dump(w["trace_dir"])
            return
        self._discard_dump(w["trace_dir"])
        with self._lock:
            self._latest = rec
            self._windows.append(rec)
            self.windows_analyzed += 1
            self.last_error = None

    @staticmethod
    def _discard_dump(path: str) -> None:
        """Recorder dumps are read ONCE by the parser, then deleted:
        a production recorder opens a window every few seconds of
        traffic and each trace is MBs, so without retention
        ``--profile-dir`` grows without bound.  Manual
        ``/profile/start`` dumps live in their own session dirs and
        are never touched."""
        import shutil

        shutil.rmtree(path, ignore_errors=True)

    def _retain_failed_dump(self, path: str) -> None:
        """Keep exactly ONE failed dump (the newest) for debugging a
        parse error — a PERSISTENT failure must not re-grow the
        disk either."""
        with self._lock:
            prev, self._failed_dump = self._failed_dump, path
        if prev is not None and prev != path:
            self._discard_dump(prev)

    def _build_record(self, w: Dict[str, Any],
                      att: Dict[str, Any]) -> Dict[str, Any]:
        """One attribution record = the /profile/report body = the
        /metrics gauge source.  The parser's trace-internal wall is
        the denominator everywhere (host_wall_s rides along for
        comparison)."""
        rec = {**w, **att, "completed_at": time.time(),
               "collective_share": att["shares"]["collective"],
               "transfer_share": att["shares"]["transfer"],
               "compute_share": att["shares"]["compute"]}
        mfu = None
        fpt = None
        if self.flops_fn is not None and w["tokens"] > 0 \
                and att["wall_s"] > 0:
            fpt = self.flops_fn(w.get("mean_position") or 0.0)
            if fpt:
                mfu = (w["tokens"] * fpt
                       / (att["wall_s"] * self.peak_flops
                          * self.n_devices))
        rec["flops_per_token"] = round(fpt, 1) if fpt else None
        rec["mfu"] = round(mfu, 6) if mfu is not None else None
        rec["peak_flops"] = self.peak_flops
        rec["peak_flops_source"] = self.peak_flops_source
        rec["n_devices"] = self.n_devices
        return rec

    # -- read side ------------------------------------------------------

    def latest(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._latest

    def report(self) -> Dict[str, Any]:
        """The ``GET /profile/report`` body: the latest record plus
        the bounded window history (oldest first) — trace_report.py
        renders its host-gap strip from ``windows``."""
        with self._lock:
            return {"every": self.every, "steps": self.steps,
                    "windows_total": self.windows_total,
                    "windows_analyzed": self.windows_analyzed,
                    "windows_skipped": self.windows_skipped,
                    "windows_deferred": self.windows_deferred,
                    "last_error": self.last_error,
                    "latest": self._latest,
                    "windows": list(self._windows)}

    def info_block(self) -> Dict[str, Any]:
        """The ``/info`` ``profiling`` block — the same published
        record, summarized."""
        with self._lock:
            latest, err = self._latest, self.last_error
            block: Dict[str, Any] = {
                "enabled": True, "every": self.every,
                "steps": self.steps,
                "windows_total": self.windows_total,
                "windows_analyzed": self.windows_analyzed,
                "windows_skipped": self.windows_skipped,
                "windows_deferred": self.windows_deferred,
            }
        if err:
            block["last_error"] = err
        if latest is not None:
            block.update(
                last_window=latest["window"],
                last_window_age_s=round(
                    time.time() - latest["completed_at"], 1),
                category_seconds={**latest["category_s"],
                                  "host_gap": latest["host_gap_s"]},
                collective_share=latest["collective_share"],
                host_gap_share=latest["host_gap_share"],
                device_busy_share=latest["device_busy_share"],
                mfu=latest["mfu"],
                host_fallback=latest["host_fallback"])
        return block

    def metrics_lines(self) -> List[str]:
        """Prometheus exposition for the attribution gauges —
        rendered from the SAME record /profile/report returns (one
        reduction, no drift).  The share gauges appear once the first
        window has been analyzed; the window counters are always
        present."""
        with self._lock:
            latest = self._latest
            lines = [
                # Same semantics as /info + /profile/report under
                # the same names: _total counts windows OPENED,
                # _analyzed_total records PUBLISHED (an analysis
                # failure moves one, not the other).
                "# TYPE ptpu_serving_profile_windows_total counter",
                f"ptpu_serving_profile_windows_total "
                f"{self.windows_total}",
                "# TYPE ptpu_serving_profile_windows_analyzed_total "
                "counter",
                f"ptpu_serving_profile_windows_analyzed_total "
                f"{self.windows_analyzed}",
                "# TYPE ptpu_serving_profile_windows_skipped_total "
                "counter",
                f"ptpu_serving_profile_windows_skipped_total "
                f"{self.windows_skipped}",
                "# TYPE ptpu_serving_profile_windows_deferred_total "
                "counter",
                f"ptpu_serving_profile_windows_deferred_total "
                f"{self.windows_deferred}",
            ]
        if latest is not None:
            lines += [
                "# TYPE ptpu_serving_collective_share gauge",
                f"ptpu_serving_collective_share "
                f"{latest['collective_share']}",
                "# TYPE ptpu_serving_host_gap_share gauge",
                f"ptpu_serving_host_gap_share "
                f"{latest['host_gap_share']}",
                "# TYPE ptpu_serving_device_busy_share gauge",
                f"ptpu_serving_device_busy_share "
                f"{latest['device_busy_share']}",
            ]
            if latest["mfu"] is not None:
                lines += [
                    "# TYPE ptpu_serving_mfu gauge",
                    f"ptpu_serving_mfu {latest['mfu']}",
                ]
        return lines

    def close(self, timeout: float = 10.0) -> None:
        """End-of-life: abandon an open window (the owning
        ProfileSession.close stops the trace) and wait briefly for a
        running analyzer so test teardown never leaks threads."""
        with self._window_lock:
            w, self._window = self._window, None
            if w is not None:
                t = w.pop("_timer", None)
                if t is not None:
                    t.cancel()
        if w is not None:
            try:
                self.session.stop(owner="recorder")
            except Exception:
                # Best-effort teardown: the owning ProfileSession's
                # close() also force-stops whatever is left.
                import logging

                logging.getLogger(__name__).debug(
                    "recorder window stop at close failed",
                    exc_info=True)
        t = self._analyzer
        if t is not None and t.is_alive():
            t.join(timeout=timeout)
