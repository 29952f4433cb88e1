"""Serving package of the port: the decode stack behind HTTP.

Port of ``polyaxon_tpu/serving`` as far as the continuous-batching
server and its fleet go (greedy, sampled, speculative and beam
requests, both KV pools with plain, int8 or ring caches, the prefix
cache with its host spill tier and wire lanes, fault containment, the
replica router with disaggregated prefill/decode roles):

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
- ``telemetry.py`` — trace-span ring, ``GET /trace``, latency
  histograms.
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

The profiler and flight recorder, legacy coalescing and meshes are
later slices (ROADMAP Queue 1).
"""

from .debug import RequestHistory, StallWatchdog, new_request_id
from .engine import DecodeEngine
from .faults import FaultPlan
from .paged import PagedSlotKVManager
from .radix import RadixPrefixIndex
from .recovery import CircuitBreaker, EngineSupervisor, RetryPolicy
from .router import (LocalReplica, Replica, ReplicaRouter, RetryBudget,
                     SLOTracker, make_router_server)
from .scheduler import (DeadlineExceeded, PRIORITIES, PoisonedRequest,
                        QueueFullError, RequestCancelled, SamplingSpec,
                        SchedulerPolicy, ShedError)
from .server import (FairLock, ModelServer, PrefixFetchPolicy,
                     make_server)
from .slots import STEP_MARKER, SlotKVManager
from .telemetry import Histogram, Telemetry, render_histogram

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
           "Telemetry", "Histogram", "render_histogram",
           "RequestHistory", "StallWatchdog", "new_request_id"]
