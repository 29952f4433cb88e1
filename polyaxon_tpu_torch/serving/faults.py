"""Deterministic, seeded fault injection for the serving stack.

Crash-only serving needs a way to PROVE its recovery machinery: a
production engine meets step-program exceptions, page-pool
exhaustion, wedged devices, dead engine threads, broken prefix
stores, and clients whose sockets reset mid-response — but none of
those arrive on demand in a test, and a flaky reproduction is worse
than none.  This module is the demand side: a :class:`FaultPlan` is
a SEEDED, site-keyed schedule of injected faults (armed via ``ptpu
serve --fault-plan f.json`` / ``ModelServer(fault_plan=...)``) whose
firing pattern is a pure function of the plan — two runs of the same
plan against the same traffic inject the same faults at the same
probes, which is what lets tests/test_faults.py pin the hard
property: under an active fault plan, every SURVIVING request's
tokens are bitwise identical to the fault-free run.

Probe sites (each one ``if self.faults is not None:`` — one
attribute check — when disarmed):

=================  ========================================================
site               where it fires / what it simulates
=================  ========================================================
``step``           the engine's decode-step dispatch.  ``kind``
                   selects the failure class: ``transient`` (raises
                   :class:`TransientFault` — the bounded-retry path)
                   or ``poisoned`` (raises
                   :class:`PoisonedComputation` whenever the target
                   request — ``request_index``/``rid`` — is resident:
                   the quarantine-bisection path)
``page_alloc``     paged-KV admission (raises a
                   :class:`PageExhausted` subclass — the existing
                   requeue-and-resume path)
``slow_step``      sleeps ``delay_s`` before the dispatch (stall /
                   hung-step simulation; long delays exercise the
                   stall watchdog)
``engine_death``   the engine loop itself (raises
                   :class:`EngineDeath` OUTSIDE tick containment —
                   the supervised-restart path, serving/recovery.py)
``prefix_store``   prefix-cache lookup/store (raises
                   :class:`FaultInjected` — the degradation-ladder
                   path: the store disables itself with a counter)
``socket_reset``   the HTTP handler's response write (raises
                   :class:`SocketReset` — the connection drops
                   without a response)
``telemetry``      the engine's span/instant emission (raises
                   :class:`FaultInjected` — must stay ISOLATED:
                   counted, never request-fatal)
``replica_kill``   FLEET site (polled by the router tier,
                   serving/router.py): hard-kill replica ``replica``
                   — listener closed, in-flight connections reset —
                   the failover-and-resume path
``replica_hang``   FLEET site: replica ``replica`` stops answering
                   (connections accepted, never served) — the probe-
                   timeout / hedged-request path
``replica_slow``   FLEET site: replica ``replica`` slow-walks every
                   request by ``delay_s`` — the tail-amplification
                   pathology (arXiv:2011.03641) hedging absorbs
=================  ========================================================

Fleet sites are POLLED (:meth:`FaultPlan.poll`), not raised: the
router consumes the fired spec and applies the fault to the target
replica, so a seeded fleet chaos plan stays a pure function of the
plan + the routed-request probe order.

Plan schema (JSON)::

    {"seed": 7,
     "faults": [
       {"site": "step", "kind": "transient", "times": 2},
       {"site": "step", "kind": "poisoned", "request_index": 3},
       {"site": "page_alloc", "p": 0.1, "times": 4},
       {"site": "slow_step", "delay_s": 0.5, "after": 10, "times": 1},
       {"site": "engine_death", "after": 20, "times": 1}
     ]}

Per-spec gates, applied in order at each probe: ``after`` (skip the
first N eligible probes), ``every`` (fire on every Nth eligible probe
past ``after``), ``p`` (probability, drawn from the spec's own
seeded ``random.Random`` — deterministic in probe order), ``times``
(max fires; ``null``/absent = unbounded).  ``poisoned`` specs are
additionally gated on their target request being RESIDENT in the
failing dispatch (``request_index`` counts engine submissions,
0-based; ``rid`` matches an explicit request ID) — which is exactly
the property quarantine bisection isolates.

Injection is a TESTING tool: the plan object also carries the
``faults_injected`` counters every surface reports
(``ptpu_serving_faults_injected_total{site=...}``), so a chaos run's
evidence — what fired, where, how often — rides the same
/metrics - /info - /debug/state no-drift contract as everything else.

The port's own copy of
``polyaxon_tpu/serving/faults.py`` (host-only code, kept here so
the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import random
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from .paged import PageExhausted

__all__ = ["FaultPlan", "FaultSpec", "FaultInjected", "TransientFault",
           "PoisonedComputation", "EngineDeath", "SocketReset",
           "InjectedPageExhausted", "SITES", "FLEET_SITES",
           "is_transient", "is_poisoned"]

SITES = ("step", "page_alloc", "slow_step", "engine_death",
         "prefix_store", "socket_reset", "telemetry",
         "replica_kill", "replica_hang", "replica_slow")

# Sites consumed by POLLING (the router tier applies the fault to a
# replica) instead of by raising at the probe.
FLEET_SITES = ("replica_kill", "replica_hang", "replica_slow")


class FaultInjected(RuntimeError):
    """Base class for every injected fault (``injected`` marks the
    exception as harness-made, so containment code can assert it
    never leaks to a client as-is)."""

    injected = True


class TransientFault(FaultInjected):
    """An injected step failure that a bounded retry should absorb
    (the real-world analogues: a transient runtime error, a
    preempted device, a hiccuping interconnect)."""

    ptpu_transient = True


class PoisonedComputation(FaultInjected):
    """An injected step failure tied to ONE resident request — the
    co-tenancy pathology (arXiv:2011.03641) where a single poisoned
    input must not take down its batch neighbors.  Carries the
    target ``rid``."""

    ptpu_poisoned = True

    def __init__(self, msg: str, rid: Optional[str] = None):
        super().__init__(msg)
        self.rid = rid


class EngineDeath(FaultInjected):
    """Raised at the ``engine_death`` site, in the engine loop
    OUTSIDE tick's containment — the whole-engine crash the
    supervisor (serving/recovery.py) exists to survive."""


class SocketReset(FaultInjected):
    """Raised at the handler's response write: the connection is
    closed without a response, simulating a client/socket death at
    the worst moment."""


class InjectedPageExhausted(PageExhausted, FaultInjected):
    """Injected page-pool allocation failure.  Subclasses
    :class:`PageExhausted` so it rides the engine's existing
    transient-shortage path: the admission requeues and resumes
    token-identically instead of failing."""


def is_transient(err: BaseException) -> bool:
    """Classify a step failure as TRANSIENT (bounded-retry-worthy):
    the injected marker, or anything that opted in via a
    ``ptpu_transient`` attribute."""
    return bool(getattr(err, "ptpu_transient", False))


def is_poisoned(err: BaseException) -> bool:
    """Classify a step failure as POISONED (request-tied): the
    injected marker, or a ``ptpu_poisoned`` attribute."""
    return bool(getattr(err, "ptpu_poisoned", False))


class FaultSpec:
    """One parsed plan entry.  Validation is eager (a typo'd site
    must fail at plan load, not silently never fire)."""

    __slots__ = ("site", "kind", "p", "after", "every", "times",
                 "request_index", "rid", "delay_s", "replica",
                 "probes", "fired", "target_rid", "_rng")

    def __init__(self, entry: Dict[str, Any], seed: int, index: int):
        if not isinstance(entry, dict):
            raise ValueError(f"fault spec must be an object; got "
                             f"{type(entry).__name__}")
        unknown = set(entry) - {"site", "kind", "p", "after", "every",
                                "times", "request_index", "rid",
                                "delay_s", "replica"}
        if unknown:
            raise ValueError(
                f"unknown fault-spec field(s) {sorted(unknown)} "
                f"(known: site/kind/p/after/every/times/"
                f"request_index/rid/delay_s/replica)")
        site = entry.get("site")
        if site not in SITES:
            raise ValueError(
                f"fault site must be one of {SITES}; got {site!r}")
        self.site = site
        kind = entry.get("kind")
        if site == "step":
            kind = kind if kind is not None else "transient"
            if kind not in ("transient", "poisoned"):
                raise ValueError(
                    f"step fault kind must be 'transient' or "
                    f"'poisoned'; got {kind!r}")
        elif kind is not None:
            raise ValueError(
                f"'kind' only applies to site 'step' (got kind="
                f"{kind!r} on site {site!r})")
        self.kind = kind
        self.p = float(entry.get("p", 1.0))
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"fault p must be in [0, 1]; got "
                             f"{self.p}")
        self.after = int(entry.get("after", 0))
        self.every = int(entry.get("every", 1))
        if self.after < 0 or self.every < 1:
            raise ValueError(
                f"fault after must be >= 0 and every >= 1; got "
                f"after={self.after}, every={self.every}")
        times = entry.get("times")
        self.times = int(times) if times is not None else None
        if self.times is not None and self.times < 1:
            raise ValueError(f"fault times must be >= 1; got "
                             f"{self.times}")
        ri = entry.get("request_index")
        self.request_index = int(ri) if ri is not None else None
        self.rid = entry.get("rid")
        if self.kind == "poisoned" and self.request_index is None \
                and self.rid is None:
            raise ValueError(
                "a poisoned step fault needs its target: "
                "request_index (Nth engine submission, 0-based) or "
                "rid (explicit request ID)")
        self.delay_s = float(entry.get("delay_s", 0.05))
        if site in ("slow_step", "replica_slow") and self.delay_s <= 0:
            raise ValueError(
                f"{site} delay_s must be > 0; got {self.delay_s}")
        # FLEET sites target a replica by index (the router resolves
        # it modulo its fleet size, so one plan runs on any fleet).
        rep = entry.get("replica")
        if rep is not None and site not in FLEET_SITES:
            raise ValueError(
                f"'replica' only applies to fleet sites "
                f"{FLEET_SITES} (got replica={rep!r} on site "
                f"{site!r})")
        if site in FLEET_SITES and rep is None:
            raise ValueError(
                f"fleet fault site {site!r} needs its target: "
                f"'replica' (fleet index, 0-based)")
        self.replica = int(rep) if rep is not None else None
        if self.replica is not None and self.replica < 0:
            raise ValueError(f"fault replica must be >= 0; got "
                             f"{self.replica}")
        # Live state: eligible-probe count, fire count, and the
        # resolved target rid for request_index-keyed poisoned specs.
        self.probes = 0
        self.fired = 0
        self.target_rid: Optional[str] = self.rid
        # Per-spec seeded stream: probability draws are a pure
        # function of (plan seed, spec index, probe ordinal) — the
        # determinism the whole harness is for.
        self._rng = random.Random((int(seed) * 1000003) ^ index)

    def describe(self) -> Dict[str, Any]:
        return {"site": self.site,
                **({"kind": self.kind} if self.kind else {}),
                **({"p": self.p} if self.p < 1.0 else {}),
                **({"after": self.after} if self.after else {}),
                **({"every": self.every} if self.every > 1 else {}),
                **({"times": self.times}
                   if self.times is not None else {}),
                **({"request_index": self.request_index}
                   if self.request_index is not None else {}),
                **({"rid": self.rid} if self.rid else {}),
                **({"replica": self.replica}
                   if self.replica is not None else {}),
                "fired": self.fired}


class FaultPlan:
    """The armed fault schedule + its injection counters.

    Thread-safe: probes arrive from the engine thread AND handler
    threads (socket/prefix sites).  The ``slow_step`` sleep happens
    OUTSIDE ``_plan_lock`` so a long injected stall can never block a
    concurrent probe (or a /metrics read of the counters).
    """

    def __init__(self, plan: Dict[str, Any]):
        if not isinstance(plan, dict):
            raise ValueError(
                f"fault plan must be an object with 'faults'; got "
                f"{type(plan).__name__}")
        unknown = set(plan) - {"seed", "faults"}
        if unknown:
            raise ValueError(
                f"unknown fault-plan field(s) {sorted(unknown)} "
                f"(known: seed, faults)")
        self.seed = int(plan.get("seed", 0))
        entries = plan.get("faults")
        if not isinstance(entries, list) or not entries:
            raise ValueError(
                "fault plan needs a non-empty 'faults' list")
        self.specs: List[FaultSpec] = [
            FaultSpec(e, self.seed, i) for i, e in enumerate(entries)]
        self._plan_lock = threading.Lock()
        self.injected: Dict[str, int] = {}
        self.injected_total = 0
        self.last_site: Optional[str] = None
        self.last_fault_t: Optional[float] = None
        self._submit_ordinal = 0

    @classmethod
    def load(cls, source) -> "FaultPlan":
        """A plan from a dict, a JSON file path, or a FaultPlan
        (pass-through) — the one constructor every arming surface
        (--fault-plan, ModelServer(fault_plan=...)) goes through."""
        if isinstance(source, cls):
            return source
        if isinstance(source, dict):
            return cls(source)
        with open(source) as f:
            return cls(json.load(f))

    # -- wiring ----------------------------------------------------------

    def on_submit(self, rid: Optional[str]) -> None:
        """Called by ``engine.submit`` for every accepted request:
        resolves ``request_index``-keyed poisoned specs to the
        concrete request ID they will fire on."""
        with self._plan_lock:
            ordinal = self._submit_ordinal
            self._submit_ordinal += 1
            for spec in self.specs:
                if spec.kind == "poisoned" \
                        and spec.request_index == ordinal \
                        and spec.target_rid is None:
                    spec.target_rid = rid

    # -- the probe -------------------------------------------------------

    def _gates_pass(self, spec: FaultSpec) -> bool:
        """after/every/p gating for one eligible probe (mutates the
        spec's probe counter and draws from its seeded stream; the
        caller holds ``_plan_lock``)."""
        spec.probes += 1
        if spec.probes <= spec.after:
            return False
        if spec.every > 1 and \
                (spec.probes - spec.after - 1) % spec.every != 0:
            return False
        if spec.p < 1.0 and spec._rng.random() >= spec.p:
            return False
        return True

    def _note_fired(self, spec: FaultSpec) -> None:
        """Injection bookkeeping (caller holds ``_plan_lock``)."""
        spec.fired += 1
        self.injected[spec.site] = self.injected.get(spec.site, 0) + 1
        self.injected_total += 1
        self.last_site = spec.site
        self.last_fault_t = time.time()

    def check(self, site: str,
              rids: Optional[Sequence[Optional[str]]] = None) -> None:
        """One probe at ``site``: raise the site's injected fault
        when a spec's gates line up (or sleep, for ``slow_step``).
        ``rids`` (step site) is the resident request-ID set the
        poisoned gate matches against."""
        to_fire: Optional[FaultSpec] = None
        delay = 0.0
        with self._plan_lock:
            for spec in self.specs:
                if spec.site != site:
                    continue
                if spec.times is not None \
                        and spec.fired >= spec.times:
                    continue
                if spec.kind == "poisoned":
                    tgt = spec.target_rid
                    if tgt is None or rids is None or tgt not in rids:
                        continue
                if not self._gates_pass(spec):
                    continue
                self._note_fired(spec)
                if site == "slow_step":
                    delay = max(delay, spec.delay_s)
                    continue        # a sleep composes with a raise
                to_fire = spec
                break
        if delay > 0.0:
            # Outside the plan lock (and the caller keeps it outside
            # the device lock): an injected stall must stall the
            # ENGINE LOOP, not every thread that touches the plan.
            time.sleep(delay)
        if to_fire is not None:
            raise self._exception_for(to_fire)

    def poll(self, site: str) -> Optional[Dict[str, Any]]:
        """One probe at a FLEET site: return the fired fault as a
        dict (``{"site", "replica", "delay_s"}``) for the caller —
        the router tier — to APPLY to the target replica, or None.
        Polling, not raising: a replica fault is an action against
        fleet state, not an exception on the probing thread.  Same
        gates and counters as :meth:`check`, so a fleet plan's fire
        pattern stays a pure function of (plan, probe order)."""
        if site not in FLEET_SITES:
            raise ValueError(
                f"poll() takes a fleet site {FLEET_SITES}; got "
                f"{site!r} (exception sites go through check())")
        with self._plan_lock:
            for spec in self.specs:
                if spec.site != site:
                    continue
                if spec.times is not None \
                        and spec.fired >= spec.times:
                    continue
                if not self._gates_pass(spec):
                    continue
                self._note_fired(spec)
                return {"site": site, "replica": spec.replica,
                        "delay_s": spec.delay_s}
        return None

    @staticmethod
    def _exception_for(spec: FaultSpec) -> BaseException:
        if spec.site == "step":
            if spec.kind == "poisoned":
                return PoisonedComputation(
                    f"injected poisoned computation (target request "
                    f"{spec.target_rid})", rid=spec.target_rid)
            return TransientFault(
                "injected transient step fault")
        if spec.site == "page_alloc":
            return InjectedPageExhausted(
                "injected page-pool allocation failure")
        if spec.site == "engine_death":
            return EngineDeath("injected engine-thread death")
        if spec.site == "socket_reset":
            return SocketReset("injected handler socket reset")
        if spec.site == "prefix_store":
            return FaultInjected("injected prefix-store error")
        return FaultInjected(f"injected {spec.site} fault")

    # -- introspection ---------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """The counters every surface reports (engine.stats() embeds
        this; /metrics renders the per-site split as
        ``ptpu_serving_faults_injected_total{site=...}``)."""
        with self._plan_lock:
            return {
                "fault_seed": self.seed,
                "fault_specs": len(self.specs),
                "faults_injected_total": self.injected_total,
                "faults_injected": dict(self.injected),
                **({"last_fault_site": self.last_site}
                   if self.last_site is not None else {}),
                **({"last_fault_t": round(self.last_fault_t, 3)}
                   if self.last_fault_t is not None else {}),
            }

    def describe(self) -> List[Dict[str, Any]]:
        with self._plan_lock:
            return [s.describe() for s in self.specs]
