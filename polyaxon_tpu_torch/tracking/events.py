"""Event schemas for tracked data.

Parity: reference traceml ``V1Event*`` vocabulary (SURVEY.md 2.12).  An
event is one timestamped (optionally stepped) datum of a given kind; series
are append-only JSONL files keyed by (kind, name) in the run store.

The port's own copy of ``polyaxon_tpu/tracking/events.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional


class EventKind:
    METRIC = "metric"
    IMAGE = "image"
    AUDIO = "audio"
    VIDEO = "video"
    HTML = "html"
    TEXT = "text"
    CHART = "chart"
    CURVE = "curve"
    CONFUSION = "confusion"
    HISTOGRAM = "histogram"
    DATAFRAME = "dataframe"
    ARTIFACT = "artifact"
    MODEL = "model"
    ENV = "env"
    SYSTEM = "system"

    ALL = {METRIC, IMAGE, AUDIO, VIDEO, HTML, TEXT, CHART, CURVE, CONFUSION,
           HISTOGRAM, DATAFRAME, ARTIFACT, MODEL, ENV, SYSTEM}


def make_event(
    kind: str,
    value: Any = None,
    step: Optional[int] = None,
    timestamp: Optional[float] = None,
    **extra: Any,
) -> Dict[str, Any]:
    if kind not in EventKind.ALL:
        raise ValueError(f"Unknown event kind {kind!r}")
    event: Dict[str, Any] = {
        "timestamp": timestamp if timestamp is not None else time.time(),
        "kind": kind,
    }
    if step is not None:
        event["step"] = int(step)
    if value is not None:
        event["value"] = value
    event.update({k: v for k, v in extra.items() if v is not None})
    return event


def metric_event(value: float, step: Optional[int] = None,
                 timestamp: Optional[float] = None) -> Dict[str, Any]:
    value = float(value)
    return make_event(EventKind.METRIC, value=value, step=step,
                      timestamp=timestamp)


def artifact_event(path: str, kind: str = EventKind.ARTIFACT,
                   step: Optional[int] = None, **extra) -> Dict[str, Any]:
    return make_event(kind, step=step, path=path, **extra)
