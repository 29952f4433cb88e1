"""Control plane: API service, scheduling queue, schedules, streams.

The reference's L4 (``haupt``: API + DB + orchestration + streams —
SURVEY.md 2.8) collapsed into one stdlib-HTTP process over the file
store, plus a schedule-materializer thread.  Agents (``runner.agent``)
poll ``/agent/claim``; clients speak ``client.ApiRunStore``.

The port's own copy of ``polyaxon_tpu/scheduler/__init__.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from .api import ApiError, ControlPlane, make_server, serve_forever
from .crond import Cron, ScheduleError, ScheduleService, next_fire_time

__all__ = [
    "ApiError",
    "ControlPlane",
    "Cron",
    "ScheduleError",
    "ScheduleService",
    "make_server",
    "next_fire_time",
    "serve_forever",
]
