"""Module-level tracking API: ``tracking.init()`` + ``log_*`` passthroughs.

Usage inside a training container (parity with SURVEY.md 3.2):

    from polyaxon_tpu_torch import tracking

    tracking.init()                       # attaches via injected env
    tracking.log_metrics(step=i, loss=l, accuracy=a)
    tracking.log_model(ckpt_dir, framework="torch")
    tracking.end()

Port of ``polyaxon_tpu/tracking/__init__.py``.  ``init()`` also starts
the process group from the PTPU_* topology block the agent/converter (or
the local runner) injects, before the run is created: the chief creates
the run and an unmanaged gang shares its uuid (``tracking/run.py``).
"""

from __future__ import annotations

import os
from typing import Any, Optional

from .events import EventKind
from .processors import SystemMetricsMonitor, gpu_metrics, host_metrics
from .run import Run

TRACKING_RUN: Optional[Run] = None


def init(
    run_uuid: Optional[str] = None,
    project: Optional[str] = None,
    name: Optional[str] = None,
    distributed_init: bool = True,
    **kwargs: Any,
) -> Run:
    """Initialize global tracking (and, if topology env is present and
    ``distributed_init``, the process group: on this rank's card, or on
    the CPU when no card is present)."""
    global TRACKING_RUN
    if distributed_init and os.environ.get("PTPU_COORDINATOR_ADDRESS"):
        import torch

        from ..parallel.bootstrap import initialize_from_env

        initialize_from_env(
            device=None if torch.cuda.is_available() else "cpu")
    TRACKING_RUN = Run(run_uuid=run_uuid, project=project, name=name, **kwargs)
    return TRACKING_RUN


def get_or_create_run() -> Run:
    global TRACKING_RUN
    if TRACKING_RUN is None:
        TRACKING_RUN = init()
    return TRACKING_RUN


def _passthrough(method: str):
    def fn(*args, **kwargs):
        return getattr(get_or_create_run(), method)(*args, **kwargs)

    fn.__name__ = method
    fn.__doc__ = getattr(Run, method).__doc__
    return fn


log_metric = _passthrough("log_metric")
log_metrics = _passthrough("log_metrics")
log_inputs = _passthrough("log_inputs")
log_outputs = _passthrough("log_outputs")
log_tags = _passthrough("log_tags")
log_artifact = _passthrough("log_artifact")
log_model = _passthrough("log_model")
log_image = _passthrough("log_image")
log_audio = _passthrough("log_audio")
log_video = _passthrough("log_video")
log_html = _passthrough("log_html")
log_text = _passthrough("log_text")
log_curve = _passthrough("log_curve")
log_confusion_matrix = _passthrough("log_confusion_matrix")
log_histogram = _passthrough("log_histogram")
log_dataframe = _passthrough("log_dataframe")
get_artifacts_path = _passthrough("get_artifacts_path")
get_outputs_path = _passthrough("get_outputs_path")
flush = _passthrough("flush")


def end(status: str = "succeeded", message: Optional[str] = None) -> None:
    global TRACKING_RUN
    if TRACKING_RUN is not None:
        TRACKING_RUN.end(status=status, message=message)
        TRACKING_RUN = None
