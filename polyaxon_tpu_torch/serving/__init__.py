"""Serving package of the port: the decode stack behind HTTP.

Port of ``polyaxon_tpu/serving`` as far as the continuous-batching
server goes (greedy requests over the fixed-lane slot pool):

- ``server.py``    — ModelServer (validation, metrics, drain) + the
  stdlib HTTP front-end with bounded admission and 429 backpressure.
- ``engine.py``    — the continuous-batching decode engine: step-level
  scheduling over a fixed slot pool.
- ``slots.py``     — slot-indexed KV memory: the [S]-row stacked cache
  and the decode window, one CUDA graph per window on the card.
- ``scheduler.py`` — admission queue, scheduler policy knobs, request
  and stream state (a copy of the reference's).
- ``telemetry.py`` — trace-span ring, ``GET /trace``, latency
  histograms.
- ``debug.py``     — request IDs, the request-history ring, the
  ``/debug/state`` snapshot board.
- ``forensics.py`` — per-request phase ledgers and the anomaly sentry.
- ``faults.py``, ``recovery.py`` — fault injection and crash-only
  recovery (copies; the engine does not wire them yet).
- ``paged.py``     — the paged pool's error types (the pool itself
  comes with its own slice).

The paged pool, the prefix cache, sampling, beam and speculative
decoding, meshes and the router are later slices (ROADMAP Queue 1).
"""

from .debug import RequestHistory, new_request_id
from .engine import DecodeEngine
from .recovery import CircuitBreaker, EngineSupervisor, RetryPolicy
from .scheduler import (DeadlineExceeded, PRIORITIES, QueueFullError,
                        RequestCancelled, SamplingSpec,
                        SchedulerPolicy, ShedError)
from .server import FairLock, ModelServer, make_server
from .slots import STEP_MARKER, SlotKVManager
from .telemetry import Histogram, Telemetry, render_histogram

__all__ = ["ModelServer", "make_server", "FairLock", "DecodeEngine",
           "SchedulerPolicy", "SamplingSpec", "SlotKVManager",
           "STEP_MARKER", "QueueFullError", "RequestCancelled",
           "DeadlineExceeded", "ShedError", "PRIORITIES",
           "RetryPolicy", "CircuitBreaker", "EngineSupervisor",
           "Telemetry", "Histogram", "render_histogram",
           "RequestHistory", "new_request_id"]
