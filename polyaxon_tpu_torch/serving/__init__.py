"""Serving package of the port: the decode stack behind HTTP.

Port of ``polyaxon_tpu/serving`` as far as the continuous-batching
server goes (greedy, sampled, speculative and beam requests, both KV
pools with plain, int8 or ring caches, the prefix cache, fault
containment):

- ``server.py``    — ModelServer (validation, metrics, drain, the prefix
  store behind ``POST /prefill``) + the stdlib HTTP front-end with
  bounded admission and 429 backpressure.
- ``engine.py``    — the continuous-batching decode engine: step-level
  scheduling over a slot pool, prefix seeding, step-fault containment,
  supervised crash recovery and SLO preemption.
- ``slots.py``     — slot-indexed KV memory: the [S]-row stacked cache
  and the decode window, one CUDA graph per window on the card.
- ``paged.py``     — the paged pool: page tables, eager or lazy
  reservation, copy-on-write shared prefix pages.
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

The host spill tier and its wire format, the profiler and flight
recorder, legacy coalescing, meshes and the router are later slices
(ROADMAP Queue 1).
"""

from .debug import RequestHistory, StallWatchdog, new_request_id
from .engine import DecodeEngine
from .faults import FaultPlan
from .paged import PagedSlotKVManager
from .radix import RadixPrefixIndex
from .recovery import CircuitBreaker, EngineSupervisor, RetryPolicy
from .scheduler import (DeadlineExceeded, PRIORITIES, PoisonedRequest,
                        QueueFullError, RequestCancelled, SamplingSpec,
                        SchedulerPolicy, ShedError)
from .server import FairLock, ModelServer, make_server
from .slots import STEP_MARKER, SlotKVManager
from .telemetry import Histogram, Telemetry, render_histogram

__all__ = ["ModelServer", "make_server", "FairLock", "DecodeEngine",
           "SchedulerPolicy", "SamplingSpec", "SlotKVManager",
           "PagedSlotKVManager",
           "STEP_MARKER", "QueueFullError", "RequestCancelled",
           "DeadlineExceeded", "ShedError", "PRIORITIES",
           "RetryPolicy", "CircuitBreaker", "EngineSupervisor",
           "FaultPlan", "PoisonedRequest", "RadixPrefixIndex",
           "Telemetry", "Histogram", "render_histogram",
           "RequestHistory", "StallWatchdog", "new_request_id"]
