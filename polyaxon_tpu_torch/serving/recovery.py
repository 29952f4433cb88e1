"""Supervised engine recovery: crash-only serving's restart half.

The engine's step-boundary containment (engine._dispatch_step)
absorbs request-scoped failures — transient step errors retry,
poisoned requests quarantine out.  What it cannot absorb is the
engine ITSELF dying: an exception escaping the scheduling layer, an
injected ``engine_death`` fault, or a containment ladder that did
not converge.  Before this module, that path failed every in-flight
request and left the process limping; at crash-only scale the right
answer is VirtualFlow's (arXiv:2009.09523): request state is already
decoupled from the device that happens to hold it — the engine's
preempt-requeue machinery proves any resident can be evicted and
resumed token-identically — so whole-engine recovery is "requeue
everything and replay":

- :class:`RetryPolicy` — the ONE bounded, jittered-backoff schedule
  shared by step-level retries (engine.retry_policy) and the
  supervisor's restart delays.  Deterministically seeded: delays
  never influence tokens, but a chaos run should still be
  reproducible end to end.
- :class:`CircuitBreaker` — N crashes inside a sliding window trip
  the breaker OPEN: in-flight work fails fast with the structured
  503 ``reason: engine_down`` (never a hang), /healthz answers 503
  so the router tier stops sending traffic, and new submissions shed
  at the gate.  After ``cooldown_s`` the breaker goes HALF-OPEN and
  the supervisor probes ONE restart — a healthy engine closes the
  breaker on its first worked tick, so the breaker can never wedge
  an engine that has actually recovered.
- :class:`EngineSupervisor` — owns the crash -> backoff -> recover ->
  restart cycle.  ``handle_crash`` runs ON the dying loop thread
  (there is exactly one loop thread, so recovery can touch engine
  internals without racing a tick): it requeues every resident
  through the preempt-resume path, resets partial prefills, rebuilds
  the slot/page pools IN PLACE (compiled step/insert programs are
  retained — recovery adds zero steady-state recompiles, pinned in
  tests/test_faults.py), runs the owner's recovery hooks (the server
  flushes its paged prefix store — its page payloads died with the
  pool), and starts a fresh loop thread.

The port's own copy of
``polyaxon_tpu/serving/recovery.py`` (host-only code, kept here so
the port imports nothing of the JAX package), plus what a CUDA card
adds: a STICKY device error (an illegal address, a device-side
assert) leaves the CUDA context unusable for the life of the process,
so no restart can replay on it.  :func:`is_device_lost` recognizes
one, the engine raises it as :class:`DeviceLost`, and the supervisor
LATCHES the breaker open instead of restarting: every request fails
visibly (503 ``engine_down``, /healthz 503) until the process is
replaced.
"""

from __future__ import annotations

import random
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from .scheduler import ShedError

__all__ = ["RetryPolicy", "CircuitBreaker", "EngineSupervisor",
           "DeviceLost", "is_device_lost"]

# Messages of CUDA errors that poison the context for good (cudaError
# descriptions as PyTorch raises them).
_STICKY_CUDA = ("illegal memory access", "device-side assert",
                "unspecified launch failure", "illegal instruction",
                "misaligned address", "uncorrectable ECC",
                "hardware stack error", "invalid program counter")


class DeviceLost(RuntimeError):
    """The CUDA context is gone (a sticky device error): the engine
    cannot run another device call in this process."""


def is_device_lost(err: BaseException) -> bool:
    """Whether ``err`` is a sticky CUDA error (or already wraps one)."""
    if isinstance(err, DeviceLost):
        return True
    msg = str(err)
    return isinstance(err, RuntimeError) and "CUDA" in msg \
        and any(s in msg for s in _STICKY_CUDA)


class RetryPolicy:
    """Bounded, jittered exponential backoff.

    ``delay_s(attempt)`` is ``base * 2^attempt`` capped at ``max``,
    stretched by up to ``jitter`` x itself from a SEEDED stream (two
    identically-configured policies produce identical delay
    sequences).  ``max_attempts`` bounds retry LOOPS (the engine's
    step retry); callers using the policy for open-ended restart
    backoff (the supervisor) index ``delay_s`` directly with a
    clamped attempt count.
    """

    def __init__(self, *, max_attempts: int = 3,
                 base_delay_s: float = 0.02,
                 max_delay_s: float = 2.0,
                 jitter: float = 0.5, seed: int = 0):
        if max_attempts < 0:
            raise ValueError(
                f"max_attempts must be >= 0; got {max_attempts}")
        if base_delay_s < 0 or max_delay_s < base_delay_s:
            raise ValueError(
                f"need 0 <= base_delay_s <= max_delay_s; got "
                f"{base_delay_s}, {max_delay_s}")
        if jitter < 0:
            raise ValueError(f"jitter must be >= 0; got {jitter}")
        self.max_attempts = int(max_attempts)
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)

    def delay_s(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (0-based)."""
        d = min(self.max_delay_s,
                self.base_delay_s * (2.0 ** max(0, int(attempt))))
        return d * (1.0 + self.jitter * self._rng.random())

    def describe(self) -> Dict[str, Any]:
        return {"max_attempts": self.max_attempts,
                "base_delay_s": self.base_delay_s,
                "max_delay_s": self.max_delay_s,
                "jitter": self.jitter}


class CircuitBreaker:
    """Crash-rate circuit breaker: CLOSED -> (N crashes in
    ``window_s``) -> OPEN -> (cooldown) -> HALF_OPEN -> (success)
    -> CLOSED, with a crash during HALF_OPEN re-tripping straight
    back to OPEN."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, *, threshold: int = 5, window_s: float = 60.0,
                 cooldown_s: float = 5.0):
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1; got "
                             f"{threshold}")
        if window_s <= 0 or cooldown_s < 0:
            raise ValueError(
                f"need window_s > 0 and cooldown_s >= 0; got "
                f"{window_s}, {cooldown_s}")
        self.threshold = int(threshold)
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self.state = self.CLOSED
        self.trips_total = 0
        self._crashes: "deque[float]" = deque()
        self._half_open_t: Optional[float] = None
        self._probe_claimed = False
        self._lock = threading.Lock()

    def record_crash(self, now: Optional[float] = None) -> str:
        """Record one engine crash; returns the post-crash state."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._crashes.append(now)
            while self._crashes and \
                    now - self._crashes[0] > self.window_s:
                self._crashes.popleft()
            if self.state == self.HALF_OPEN:
                # A recovered-but-IDLE engine can sit HALF_OPEN for
                # hours (only a worked tick closes the breaker); the
                # probe's verdict must not outlive the same sliding
                # window the threshold uses, or one isolated crash
                # much later re-trips on stale suspicion.
                if self._half_open_t is not None \
                        and now - self._half_open_t > self.window_s:
                    self.state = self.CLOSED
                else:
                    # The probe restart crashed too: straight back
                    # open.
                    self.state = self.OPEN
                    self.trips_total += 1
                    return self.state
            if self.state == self.CLOSED \
                    and len(self._crashes) >= self.threshold:
                self.state = self.OPEN
                self.trips_total += 1
            return self.state

    def half_open(self) -> None:
        """Cooldown elapsed: allow ONE probe restart."""
        with self._lock:
            if self.state == self.OPEN:
                self.state = self.HALF_OPEN
                self._half_open_t = time.monotonic()
                self._probe_claimed = False

    def try_probe(self) -> bool:
        """Claim the HALF_OPEN state's single probe slot.

        Exactly ONE caller gets True per half-open transition — the
        half-open contract is "one trial, then judge", and concurrent
        submitters racing a recovering replica must not all pile onto
        it at once (that is the retry-storm shape a half-open state
        exists to prevent).  The claim re-arms when a crash re-opens
        the breaker and the next cooldown half-opens it again; a
        ``record_success`` closes the breaker, after which callers
        should route normally instead of probing.  Returns False in
        every non-HALF_OPEN state."""
        with self._lock:
            if self.state != self.HALF_OPEN or self._probe_claimed:
                return False
            self._probe_claimed = True
            return True

    def latch(self) -> None:
        """Open for good: the device is lost, no cooldown can fix it
        (no probe restart follows; ``half_open`` is never called)."""
        with self._lock:
            if self.state != self.OPEN:
                self.trips_total += 1
            self.state = self.OPEN

    def record_success(self) -> None:
        """A worked tick after recovery: a HALF_OPEN (or, defensively,
        OPEN) breaker closes and the crash history clears — the
        breaker must never wedge an engine that actually recovered."""
        with self._lock:
            self.state = self.CLOSED
            self._crashes.clear()

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {"state": self.state,
                    "crashes_in_window": len(self._crashes),
                    "threshold": self.threshold,
                    "window_s": self.window_s,
                    "cooldown_s": self.cooldown_s,
                    "trips_total": self.trips_total}


class EngineSupervisor:
    """Restart a crashed decode engine with backoff; trip the
    breaker when crashes storm.

    Attaching a supervisor (``EngineSupervisor(engine)``) flips the
    engine's crash behavior from fail-everything (the library
    default) to requeue-and-resume: the server attaches one per
    engine unless ``ModelServer(supervise=False)``.

    All state transitions run on the engine's (dying) loop thread —
    ``handle_crash`` is called from the loop's catch-all, performs
    the whole backoff/recover cycle inline, starts the replacement
    loop thread, and lets the old thread exit.  Counters are
    lock-guarded only because /metrics threads read them.
    """

    def __init__(self, engine, *, backoff: Optional[RetryPolicy] = None,
                 breaker: Optional[CircuitBreaker] = None):
        self.engine = engine
        # Restart backoff: unbounded attempts by design (the BREAKER
        # is the brake, and it always re-probes after cooldown — a
        # max_attempts cap here would wedge a healthy engine).
        self.backoff = backoff if backoff is not None else RetryPolicy(
            max_attempts=0, base_delay_s=0.05, max_delay_s=5.0)
        self.breaker = breaker if breaker is not None \
            else CircuitBreaker()
        self.crashes_total = 0
        self.restarts_total = 0
        self.last_crash: Optional[str] = None
        self.last_crash_t: Optional[float] = None
        self.last_recovery_s: Optional[float] = None
        self._consecutive = 0
        self._lock = threading.Lock()
        # Owner hooks run after the pool rebuild, before the restart
        # (the server flushes its paged prefix store here — stored
        # page payloads died with the old pool; HOST-TIER spilled
        # entries reference no device state and survive the flush,
        # docs/DESIGN.md epoch contract extension).
        self._recovery_hooks: List[Callable[[], None]] = []
        engine.supervisor = self

    def add_recovery_hook(self, fn: Callable[[], None]) -> None:
        self._recovery_hooks.append(fn)

    # -- the crash path (dying loop thread) ------------------------------

    def handle_crash(self, err: BaseException) -> bool:
        """Called from the engine loop's catch-all with the escaping
        exception.  Returns True when supervision owned the crash
        (the caller — the old loop thread — just returns); False
        hands the crash back to the legacy fail-everything path
        (only during shutdown)."""
        eng = self.engine
        if eng is None or eng._stop:
            return False        # closing: let close() drain normally
        with self._lock:
            self.crashes_total += 1
            self._consecutive += 1
            attempt = self._consecutive - 1
            self.last_crash = (f"{type(err).__name__}: "
                               f"{err}")[:300]
            self.last_crash_t = time.time()
        traceback.print_exc(file=sys.stderr)
        if is_device_lost(err):
            # The context is unusable: latch the breaker open and fail
            # everything visibly instead of restarting onto it.
            self.breaker.latch()
            eng.down = True
            print("# serving: CUDA device lost (sticky error) — engine "
                  "latched down; replace the process", file=sys.stderr)
            eng._fail_all(ShedError(
                f"CUDA device lost ({err}); the engine cannot recover "
                f"in this process", reason="engine_down"))
            return True
        state = self.breaker.record_crash()
        print(f"# serving: engine CRASH #{self.crashes_total} "
              f"({type(err).__name__}); breaker {state} — "
              f"supervised recovery starting", file=sys.stderr)
        if state == CircuitBreaker.OPEN:
            # Fail fast, never hang: everything in flight sheds with
            # the machine-readable reason, readiness flips off
            # (/healthz 503 engine_down), and new submits shed at the
            # engine gate until the cooldown's probe restart.
            eng.down = True
            eng._fail_all(ShedError(
                "decode engine crashed repeatedly; circuit breaker "
                "open — shedding in-flight work instead of hanging "
                "it", reason="engine_down"))
            if not self._sleep_unless_stopped(self.breaker.cooldown_s):
                return True     # closed during cooldown; queue empty
            self.breaker.half_open()
        else:
            if not self._sleep_unless_stopped(
                    self.backoff.delay_s(min(attempt, 8))):
                eng._fail_all(RuntimeError("decode engine closed"))
                return True
        t0 = time.perf_counter()
        try:
            requeued = eng.recover_from_crash()
            for hook in self._recovery_hooks:
                try:
                    hook()
                except Exception:
                    import logging

                    logging.getLogger(__name__).warning(
                        "engine recovery hook failed", exc_info=True)
        except BaseException as e2:
            # Recovery itself failed: the state is unknown — fail
            # everything (bounded, visible) rather than restart a
            # loop over corrupt structures.
            traceback.print_exc(file=sys.stderr)
            eng.down = True
            eng._fail_all(RuntimeError(
                f"engine recovery failed: {type(e2).__name__}: "
                f"{e2}"))
            return True
        with self._lock:
            self.restarts_total += 1
            self.last_recovery_s = round(
                time.perf_counter() - t0, 6)
        eng.down = False
        if eng._restart_loop():
            print(f"# serving: engine RESTARTED "
                  f"(#{self.restarts_total}; {requeued} stream(s) "
                  f"requeued for token-identical resume; recovery "
                  f"{self.last_recovery_s}s)", file=sys.stderr)
        else:
            eng._fail_all(RuntimeError("decode engine closed"))
        return True

    def _sleep_unless_stopped(self, delay: float) -> bool:
        """Backoff sleep in small slices so engine.close() never
        waits a full cooldown; returns False when the engine stopped
        mid-sleep."""
        deadline = time.monotonic() + max(0.0, delay)
        while time.monotonic() < deadline:
            if self.engine._stop:
                return False
            time.sleep(min(0.05, max(0.001,
                                     deadline - time.monotonic())))
        return not self.engine._stop

    # -- the healthy path ------------------------------------------------

    def note_progress(self) -> None:
        """Called by the engine loop after a WORKED tick: a recovered
        engine closes the breaker and resets the consecutive-crash
        backoff.  Cheap guard so the steady-state cost is two
        attribute reads."""
        if self._consecutive == 0 \
                and self.breaker.state == CircuitBreaker.CLOSED:
            return
        self._consecutive = 0
        self.breaker.record_success()

    # -- introspection ---------------------------------------------------

    def status(self) -> Dict[str, Any]:
        """The supervisor block /debug/state, stall bundles, and
        /info carry: restart/crash counts, breaker state, and the
        last crash/recovery evidence."""
        with self._lock:
            return {
                "restarts_total": self.restarts_total,
                "crashes_total": self.crashes_total,
                "consecutive_crashes": self._consecutive,
                "breaker": self.breaker.snapshot(),
                **({"last_crash": self.last_crash}
                   if self.last_crash is not None else {}),
                **({"last_crash_t": round(self.last_crash_t, 3)}
                   if self.last_crash_t is not None else {}),
                **({"last_recovery_s": self.last_recovery_s}
                   if self.last_recovery_s is not None else {}),
            }
