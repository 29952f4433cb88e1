"""Schedule materialization: cron / interval / datetime kinds.

Parity: reference ``V1Schedule*`` semantics (SURVEY.md 2.4) — an
operation carrying ``schedule:`` becomes a *controller* run in status
``on_schedule``; at each fire time the service creates a child run
(queued, schedule stripped) until ``maxRuns``/``endAt`` exhausts the
schedule.  Pure-stdlib cron matcher; no external deps.

The port's own copy of ``polyaxon_tpu/scheduler/crond.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import datetime as dt
import logging
import threading
import time
from typing import Any, Dict, List, Optional

from ..client.store import FileRunStore
from ..lifecycle import V1Statuses

logger = logging.getLogger(__name__)

_FIELD_RANGES = [(0, 59), (0, 23), (1, 31), (1, 12), (0, 6)]


class ScheduleError(ValueError):
    pass


def _parse_field(spec: str, lo: int, hi: int) -> set:
    values = set()
    for part in spec.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
        if part in ("*", ""):
            rng = range(lo, hi + 1)
        elif "-" in part:
            a, b = part.split("-", 1)
            rng = range(int(a), int(b) + 1)
        else:
            rng = range(int(part), int(part) + 1)
        for v in rng:
            if not lo <= v <= hi:
                raise ScheduleError(
                    f"cron field value {v} out of range [{lo},{hi}]")
            if (v - rng.start) % step == 0:
                values.add(v)
    return values


class Cron:
    """5-field cron expression (minute hour day-of-month month weekday)."""

    def __init__(self, expr: str):
        fields = expr.split()
        if len(fields) != 5:
            raise ScheduleError(
                f"cron expression needs 5 fields, got {expr!r}")
        self.minute, self.hour, self.dom, self.month, self.dow = (
            _parse_field(f, lo, hi)
            for f, (lo, hi) in zip(fields, _FIELD_RANGES))

    def matches(self, t: dt.datetime) -> bool:
        # cron weekday convention: Sunday=0; Python weekday(): Monday=0.
        cron_dow = (t.weekday() + 1) % 7
        return (t.minute in self.minute and t.hour in self.hour
                and t.day in self.dom and t.month in self.month
                and cron_dow in self.dow)

    def next_after(self, t: dt.datetime) -> dt.datetime:
        """First matching minute strictly after ``t`` (bounded scan)."""
        t = t.replace(second=0, microsecond=0) + dt.timedelta(minutes=1)
        for _ in range(366 * 24 * 60):
            if self.matches(t):
                return t
            t += dt.timedelta(minutes=1)
        raise ScheduleError("cron expression never fires within a year")


def _parse_when(value: Any) -> Optional[float]:
    if value is None:
        return None
    if isinstance(value, (int, float)):
        return float(value)
    return dt.datetime.fromisoformat(str(value)).timestamp()


def next_fire_time(schedule: Dict[str, Any], after: float,
                   iteration: int) -> Optional[float]:
    """Epoch seconds of the next firing after ``after``; None = exhausted."""
    kind = schedule.get("kind")
    max_runs = schedule.get("maxRuns") or schedule.get("max_runs")
    if max_runs is not None and iteration >= int(max_runs):
        return None
    start_at = _parse_when(schedule.get("startAt")
                           or schedule.get("start_at"))
    end_at = _parse_when(schedule.get("endAt") or schedule.get("end_at"))

    if kind == "datetime":
        fire = _parse_when(schedule.get("startAt")
                           or schedule.get("start_at"))
        if fire is None:
            raise ScheduleError("datetime schedule needs startAt")
        return None if iteration >= 1 else fire

    if kind == "interval":
        freq = float(schedule.get("frequency"))
        base = start_at if start_at is not None else after
        fire = max(base, after) if iteration == 0 else after + freq
    elif kind == "cron":
        local = dt.datetime.fromtimestamp(max(after, start_at or 0))
        fire = Cron(schedule["cron"]).next_after(local).timestamp()
    else:
        raise ScheduleError(f"Unknown schedule kind {kind!r}")

    if end_at is not None and fire > end_at:
        return None
    return fire


class ScheduleService:
    """Background loop materializing scheduled operations into child runs
    and sweeping zombie runs (stale tracking heartbeats — SURVEY.md 5.3).

    ``zombie_threshold_s``: seconds without a heartbeat before a RUNNING
    run is failed (``POLYAXON_TPU_ZOMBIE_THRESHOLD`` env overrides;
    0 disables the sweep).
    """

    def __init__(self, store: FileRunStore, poll_interval: float = 1.0,
                 zombie_threshold_s: Optional[float] = None):
        import os

        self.store = store
        self.poll_interval = poll_interval
        if zombie_threshold_s is None:
            zombie_threshold_s = float(
                os.environ.get("POLYAXON_TPU_ZOMBIE_THRESHOLD", "300"))
        self.zombie_threshold_s = zombie_threshold_s
        # The sweep scans every run record; at a 1s poll interval that
        # would double the store scan each tick for a 300s-granularity
        # check.  Throttle it to a fraction of the threshold.
        self._sweep_interval = max(10.0, zombie_threshold_s / 10.0)
        self._last_sweep = 0.0
        self._plane = None
        self._stop = threading.Event()

    def stop(self):
        self._stop.set()

    def run_forever(self):
        while not self._stop.is_set():
            self.tick()
            self._stop.wait(self.poll_interval)

    def tick(self, now: Optional[float] = None) -> List[str]:
        """Fire due schedules; returns uuids of created child runs."""
        now = now if now is not None else time.time()
        if self.zombie_threshold_s > 0 and \
                now - self._last_sweep >= self._sweep_interval:
            self._last_sweep = now
            if self._plane is None:
                from .api import ControlPlane

                self._plane = ControlPlane(self.store)
            try:
                self._plane.sweep_zombies(self.zombie_threshold_s,
                                          now=now)
            except Exception:  # the daemon must outlive a bad sweep
                logger.exception("zombie sweep failed")
        created: List[str] = []
        controllers = self.store.list_runs(
            query=f"status:{V1Statuses.ON_SCHEDULE}")
        for record in controllers:
            content = record.get("content") or {}
            schedule = content.get("schedule")
            if not schedule:
                continue
            meta = record.get("meta_info") or {}
            iteration = int(meta.get("schedule_iteration") or 0)
            next_at = meta.get("schedule_next_at")
            if next_at is None:
                next_at = next_fire_time(schedule, now, iteration)
                if next_at is None:
                    self.store.set_status(record["uuid"],
                                          V1Statuses.SUCCEEDED,
                                          reason="ScheduleExhausted",
                                          force=True)
                    continue
                self.store.update_run(record["uuid"], meta_info={
                    **meta, "schedule_next_at": next_at})
                continue
            if float(next_at) > now:
                continue
            # Fire: child op = controller content minus the schedule.
            child_content = dict(content)
            child_content.pop("schedule", None)
            child = self.store.create_run(
                name=f"{record.get('name')}-{iteration}",
                project=record.get("project") or "default",
                content=child_content,
                kind=record.get("kind"),
                pipeline=record["uuid"],
                meta_info={"schedule_iteration": iteration},
                # inherit queue routing/priority from the controller
                queue=record.get("queue"),
                priority=record.get("priority") or 0,
            )
            self.store.set_status(child["uuid"], V1Statuses.QUEUED,
                                  reason="ScheduleFire")
            created.append(child["uuid"])
            iteration += 1
            upcoming = next_fire_time(schedule, float(next_at), iteration)
            new_meta = {**meta, "schedule_iteration": iteration,
                        "schedule_next_at": upcoming}
            self.store.update_run(record["uuid"], meta_info=new_meta)
            if upcoming is None:
                self.store.set_status(record["uuid"], V1Statuses.SUCCEEDED,
                                      reason="ScheduleExhausted", force=True)
        return created
