"""Module-level tracking API: ``tracking.init()`` + ``log_*`` passthroughs.

Usage inside a training container (parity with SURVEY.md 3.2):

    from polyaxon_tpu_torch import tracking

    tracking.init()                       # attaches via injected env
    tracking.log_metrics(step=i, loss=l, accuracy=a)
    tracking.log_model(ckpt_dir, framework="torch")
    tracking.end()

Port of ``polyaxon_tpu/tracking/__init__.py``.  There ``init()`` also
bootstraps the JAX distributed runtime from the PTPU_* topology block the
agent/converter injects.  The port has no multi-process bootstrap yet:
``init()`` refuses a topology of more than one process, naming the ROADMAP
item that brings it.
"""

from __future__ import annotations

import os
from typing import Any, Optional

from .events import EventKind
from .processors import SystemMetricsMonitor, gpu_metrics, host_metrics
from .run import Run

TRACKING_RUN: Optional[Run] = None


def refuse_distributed() -> None:
    """Raise when the PTPU_* block describes more than one process (the
    ``tpujob``/``pytorchjob``/``mpijob``/``tfjob`` kinds)."""
    n = int(os.environ.get("PTPU_NUM_PROCESSES", "1"))
    if n > 1:
        raise RuntimeError(
            f"PTPU_NUM_PROCESSES={n}: distributed runs (tpujob, "
            f"pytorchjob, mpijob, tfjob) are not yet ported to the PyTorch "
            f"backend (ROADMAP Queue 1: Parallelism and meshes)")


def init(
    run_uuid: Optional[str] = None,
    project: Optional[str] = None,
    name: Optional[str] = None,
    distributed_init: bool = True,
    **kwargs: Any,
) -> Run:
    """Initialize global tracking (refusing, when ``distributed_init``, a
    topology env of more than one process)."""
    global TRACKING_RUN
    if distributed_init:
        refuse_distributed()
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
