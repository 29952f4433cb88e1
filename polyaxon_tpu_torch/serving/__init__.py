"""Serving package of the port: the decode stack behind HTTP.

Port of ``polyaxon_tpu/serving`` (greedy, sampled, speculative and
beam requests, both KV pools with plain, int8 or ring caches, on one
device or a serving mesh, the prefix cache with its host spill tier and wire lanes,
fault containment, the replica router with disaggregated
prefill/decode roles, the flight recorder, and the legacy coalescing
baselines):

- ``server.py``    — ModelServer (validation, metrics, drain, the prefix
  store behind ``POST /prefill``) + the stdlib HTTP front-end with
  bounded admission and 429 backpressure.
- ``engine.py``    — the continuous-batching decode engine: step-level
  scheduling over a slot pool, prefix seeding, step-fault containment,
  supervised crash recovery and SLO preemption.
- ``slots.py``     — slot-indexed KV memory: the [S]-row stacked cache
  and the decode window, one CUDA graph per window on the card.
- ``paged.py``     — the paged pool: page tables, eager or lazy
  reservation, copy-on-write shared prefix pages, the host spill tier
  (``spill_pages`` / ``rematerialize``) and its checksummed wire format
  (``pack_spilled`` / ``unpack_spilled``).
- ``radix.py``     — the prefix cache's radix index (a copy).
- ``scheduler.py`` — admission queue, scheduler policy knobs, request
  and stream state (a copy of the reference's).
- ``legacy.py``    — the seed request-coalescing path, kept as the
  measured A/B baseline (``batching="coalesce"``; ``"off"``
  serializes).
- ``profiling.py`` — the FLIGHT RECORDER (``--profile-every``):
  periodic single-flight ``torch.profiler`` windows over decode-step
  boundaries, attributed (analysis/xprof.py) into collective /
  transfer / host-gap / device-busy shares + a serving-MFU estimate,
  published as /metrics gauges and ``GET /profile/report``.
- ``telemetry.py`` — trace-span ring (+ ``GET /trace``), latency
  histograms, and the single-flight ``torch.profiler`` wrapper behind
  ``POST /profile/start|stop``.
- ``debug.py``     — request IDs, the request-history ring, the
  ``/debug/state`` snapshot board, the stall watchdog.
- ``forensics.py`` — per-request phase ledgers and the anomaly sentry.
- ``faults.py``, ``recovery.py`` — seeded fault injection, the retry
  policy, the circuit breaker and the engine supervisor.
- ``router.py``    — the replica ROUTER tier (a copy of the
  reference's): health-probed rotation, least-outstanding and prefix-
  affinity routing, failover within a retry budget, hedging, rolling
  restarts with the drain handoff, the two-stage disaggregated
  prefill/decode schedule and the ``/fleet/*`` views.
- ``meshed.py``    — the serving mesh (``--mesh tp=4``): weights and
  the slot KV pools split over local devices in the exact
  (reduction-free) layout: meshed output equals unmeshed serving
  bitwise on the CPU, and on CUDA as ``meshed.py`` states.
"""

from .debug import RequestHistory, StallWatchdog, new_request_id
from .engine import DecodeEngine
from .faults import FaultPlan
from .legacy import RequestCoalescer
from .meshed import MeshError, ServingMesh, parse_mesh
from .paged import PagedSlotKVManager
from .radix import RadixPrefixIndex
from .recovery import CircuitBreaker, EngineSupervisor, RetryPolicy
from .router import (LocalReplica, Replica, ReplicaRouter, RetryBudget,
                     SLOTracker, make_router_server)
from .scheduler import (DeadlineExceeded, PRIORITIES, PoisonedRequest,
                        QueueFullError, RequestCancelled, SamplingSpec,
                        SchedulerPolicy, ShedError)
from .profiling import FlightRecorder
from .server import (BATCHING_MODES, FairLock, ModelServer,
                     PrefixFetchPolicy, make_server)
from .slots import STEP_MARKER, SlotKVManager
from .telemetry import (Histogram, ProfileSession, Telemetry,
                        render_histogram)

__all__ = ["ModelServer", "PrefixFetchPolicy", "make_server",
           "FairLock", "DecodeEngine",
           "SchedulerPolicy", "SamplingSpec", "SlotKVManager",
           "PagedSlotKVManager",
           "STEP_MARKER", "QueueFullError", "RequestCancelled",
           "DeadlineExceeded", "ShedError", "PRIORITIES",
           "RetryPolicy", "CircuitBreaker", "EngineSupervisor",
           "FaultPlan", "PoisonedRequest", "RadixPrefixIndex",
           "ReplicaRouter", "Replica", "LocalReplica",
           "RetryBudget", "SLOTracker", "make_router_server",
           "Telemetry", "Histogram", "ProfileSession",
           "render_histogram", "FlightRecorder", "RequestCoalescer",
           "BATCHING_MODES", "ServingMesh", "parse_mesh", "MeshError",
           "RequestHistory", "StallWatchdog", "new_request_id"]
