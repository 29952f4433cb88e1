"""Run lifecycle: statuses, transitions, conditions.

Parity with the reference's status plane (SURVEY.md 5.5(c)): statuses flow
operator -> agent -> API; here they are the single source of truth the
store persists and the scheduler/agent act on.

The port's own copy of ``polyaxon_tpu/lifecycle.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional


class V1Statuses:
    CREATED = "created"
    RESUMING = "resuming"
    ON_SCHEDULE = "on_schedule"
    COMPILED = "compiled"
    QUEUED = "queued"
    SCHEDULED = "scheduled"
    STARTING = "starting"
    RUNNING = "running"
    PROCESSING = "processing"
    STOPPING = "stopping"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    UPSTREAM_FAILED = "upstream_failed"
    STOPPED = "stopped"
    SKIPPED = "skipped"
    WARNING = "warning"
    UNSCHEDULABLE = "unschedulable"
    RETRYING = "retrying"

    DONE = {SUCCEEDED, FAILED, UPSTREAM_FAILED, STOPPED, SKIPPED}
    PENDING = {CREATED, RESUMING, ON_SCHEDULE, COMPILED, QUEUED, SCHEDULED}
    ACTIVE = {STARTING, RUNNING, PROCESSING, STOPPING, RETRYING}


def is_done(status: Optional[str]) -> bool:
    return status in V1Statuses.DONE


def is_failed(status: Optional[str]) -> bool:
    return status in (V1Statuses.FAILED, V1Statuses.UPSTREAM_FAILED)


# Legal transitions; anything -> stopping/stopped is allowed for kills.
_TRANSITIONS: Dict[str, set] = {
    # starting/running directly from created covers standalone tracking
    # runs that never pass through the scheduler queue.
    V1Statuses.CREATED: {V1Statuses.COMPILED, V1Statuses.ON_SCHEDULE,
                         V1Statuses.QUEUED, V1Statuses.RESUMING,
                         V1Statuses.STARTING, V1Statuses.RUNNING,
                         V1Statuses.SKIPPED, V1Statuses.FAILED},
    V1Statuses.RESUMING: {V1Statuses.COMPILED, V1Statuses.QUEUED,
                          V1Statuses.FAILED},
    V1Statuses.ON_SCHEDULE: {V1Statuses.QUEUED, V1Statuses.COMPILED,
                             V1Statuses.FAILED},
    V1Statuses.COMPILED: {V1Statuses.QUEUED, V1Statuses.SCHEDULED,
                          V1Statuses.STARTING, V1Statuses.RUNNING,
                          V1Statuses.FAILED, V1Statuses.SKIPPED,
                          V1Statuses.UPSTREAM_FAILED},
    V1Statuses.QUEUED: {V1Statuses.SCHEDULED, V1Statuses.STARTING,
                        V1Statuses.RUNNING,
                        V1Statuses.FAILED, V1Statuses.UNSCHEDULABLE,
                        V1Statuses.SKIPPED, V1Statuses.UPSTREAM_FAILED},
    V1Statuses.SCHEDULED: {V1Statuses.STARTING, V1Statuses.RUNNING,
                           V1Statuses.FAILED, V1Statuses.UNSCHEDULABLE},
    V1Statuses.STARTING: {V1Statuses.RUNNING, V1Statuses.FAILED,
                          V1Statuses.WARNING},
    V1Statuses.RUNNING: {V1Statuses.PROCESSING, V1Statuses.SUCCEEDED,
                         V1Statuses.FAILED, V1Statuses.WARNING,
                         V1Statuses.RETRYING},
    V1Statuses.PROCESSING: {V1Statuses.RUNNING, V1Statuses.SUCCEEDED,
                            V1Statuses.FAILED},
    V1Statuses.WARNING: {V1Statuses.RUNNING, V1Statuses.SUCCEEDED,
                         V1Statuses.FAILED, V1Statuses.RETRYING},
    V1Statuses.RETRYING: {V1Statuses.QUEUED, V1Statuses.STARTING,
                          V1Statuses.RUNNING, V1Statuses.FAILED},
    V1Statuses.UNSCHEDULABLE: {V1Statuses.QUEUED, V1Statuses.FAILED},
    V1Statuses.STOPPING: {V1Statuses.STOPPED, V1Statuses.FAILED},
}


def can_transition(from_status: Optional[str], to_status: str) -> bool:
    if from_status == to_status:
        return False
    if to_status in (V1Statuses.STOPPING, V1Statuses.STOPPED):
        return from_status not in V1Statuses.DONE
    if from_status is None:
        return to_status == V1Statuses.CREATED
    if from_status in V1Statuses.DONE:
        return False
    return to_status in _TRANSITIONS.get(from_status, set())


@dataclass
class V1StatusCondition:
    type: str
    status: bool = True
    reason: Optional[str] = None
    message: Optional[str] = None
    last_transition_time: float = field(default_factory=time.time)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "V1StatusCondition":
        return cls(**{k: d.get(k) for k in
                      ("type", "status", "reason", "message",
                       "last_transition_time")})
