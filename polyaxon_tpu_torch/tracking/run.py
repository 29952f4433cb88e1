"""The tracking ``Run``: in-process experiment tracking.

Parity: reference traceml ``Run``/``tracking`` API (SURVEY.md 2.12, call
stack 3.2): ``init()`` attaches to the managed run via agent-injected env
(or creates a standalone one), ``log_metric(s)`` append stepped series
through the async writer, ``log_artifact``/``log_model``/rich-media loggers
copy files into the run's artifact tree and record lineage, and a system-
metrics monitor samples host/GPU stats.

In distributed runs only process 0 tracks by default (``all_processes=True``
opts replicas in; their series get a ``/p{id}`` suffix).

Port of ``polyaxon_tpu/tracking/run.py``: the run uuid is broadcast over
``torch.distributed``, the env record names torch, CUDA and the card, and
the profiler capture is ``torch.profiler``'s Chrome trace.  A run uuid
the env names but the store does not hold (a hand-set
``POLYAXON_TPU_RUN_UUID``) is registered under that uuid.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Union

from ..client import RunClient, StoreError
from ..lifecycle import V1Statuses
from .events import EventKind, artifact_event, make_event, metric_event
from .processors import SystemMetricsMonitor, gpu_devices
from .writer import AsyncEventWriter

logger = logging.getLogger(__name__)


class Run:
    def __init__(
        self,
        run_uuid: Optional[str] = None,
        project: Optional[str] = None,
        client: Optional[RunClient] = None,
        track_code: bool = True,
        track_env: bool = True,
        collect_system_metrics: Optional[bool] = None,
        system_metrics_interval: float = 30.0,
        auto_create: bool = True,
        name: Optional[str] = None,
        is_new: Optional[bool] = None,
        all_processes: bool = False,
    ):
        self.client = client or RunClient(run_uuid=run_uuid, project=project)
        self._process_id = int(os.environ.get("PTPU_PROCESS_ID", "0"))
        self._is_chief = self._process_id == 0
        self._tracks = self._is_chief or all_processes
        self._suffix = "" if self._is_chief else f"/p{self._process_id}"

        created = False
        if not self.client.run_uuid:
            if not auto_create:
                raise RuntimeError(
                    "tracking.init: no run to attach to (env not injected) "
                    "and auto_create disabled"
                )
            create_error: Optional[BaseException] = None
            if self._is_chief:
                try:
                    self.client.create(name=name, kind="job",
                                       managed_by="tracking")
                    created = True
                except Exception as e:  # noqa: BLE001 - must still join
                    # the broadcast below: bailing out here while the
                    # other processes wait in the collective would wedge
                    # the whole gang.
                    create_error = e
            # UNMANAGED distributed runs (no env-injected identity, e.g.
            # a trainer launched by hand on N hosts): every process
            # must share ONE run — separate runs per process also mean
            # separate checkpoint directories.  Broadcast the chief's
            # uuid.
            shared = self._broadcast_run_uuid(
                self.client.run_uuid if self._is_chief else None)
            if create_error is not None:
                raise create_error
            if not self._is_chief:
                if shared:
                    self.client = RunClient(
                        run_uuid=shared,
                        project=getattr(self.client, "project", project),
                        store=self.client.store)
                else:
                    # Degraded: broadcast unavailable/timed out — track a
                    # separate run rather than leave this process with no
                    # run at all (every client API would raise).
                    logger.warning(
                        "no shared run uuid received; this process "
                        "tracks its own run")
                    self.client.create(name=name, kind="job",
                                       managed_by="tracking")
                    created = True
        elif self._is_chief and not self._registered():
            self.client.store.create_run(
                run_uuid=self.client.run_uuid, name=name,
                project=self.client.project, kind="job",
                managed_by="tracking")
            created = True
        self._owns_status = created or (is_new or False)

        self._writer = AsyncEventWriter(self.client)
        self._writer.start()
        self._monitor: Optional[SystemMetricsMonitor] = None
        self._closed = False
        if self._owns_status:
            self._install_finalizers()

        if self._tracks:
            if self._owns_status:
                self.client.log_status(V1Statuses.RUNNING, reason="TrackingInit")
            if track_env:
                self._log_env()
            if collect_system_metrics is None:
                # Default on only inside managed runs (env-injected identity).
                from ..client.run_client import ENV_RUN_UUID

                collect_system_metrics = bool(os.environ.get(ENV_RUN_UUID))
            if collect_system_metrics:
                self._monitor = SystemMetricsMonitor(
                    self._log_system_metric, interval=system_metrics_interval)
                self._monitor.start()

    # -- internals --------------------------------------------------------

    def _registered(self) -> bool:
        try:
            self.client.store.get_run(self.client.run_uuid)
        except StoreError:
            return False
        return True

    @staticmethod
    def _broadcast_run_uuid(chief_uuid: Optional[str],
                            timeout_s: float = 60.0) -> Optional[str]:
        """Collective: every process returns the chief's run uuid.

        No-op (returns the input) unless ``torch.distributed`` has a
        process group in this process.  It rides the gang's host-side
        (gloo) group, so no card is touched from the worker thread.

        The collective itself runs under a deadline in a worker thread:
        if any process fails to join (misconfigured gang, chief crashed
        pre-broadcast), the others degrade to separate runs instead of
        hanging for the process group's own timeout."""
        if int(os.environ.get("PTPU_NUM_PROCESSES", "1")) <= 1:
            return chief_uuid
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            return chief_uuid
        from ..parallel.bootstrap import control_group

        group = control_group()

        import threading

        result: dict = {}

        def broadcast():
            try:
                box = [chief_uuid]
                dist.broadcast_object_list(box, src=0, group=group)
                result["uuid"] = box[0] or None
            except Exception:  # noqa: BLE001 - reported by the caller
                logger.exception("run-uuid broadcast failed")

        thread = threading.Thread(target=broadcast, daemon=True,
                                  name="ptpu-uuid-broadcast")
        thread.start()
        thread.join(timeout=timeout_s)
        if thread.is_alive():
            logger.error("run-uuid broadcast timed out after %.0fs; "
                         "processes may track separate runs", timeout_s)
            return chief_uuid
        return result.get("uuid", chief_uuid)

    def _install_finalizers(self) -> None:
        """Ensure the run never ends up stuck in `running` if the script
        exits without calling end(): uncaught exceptions mark it failed,
        clean interpreter exit marks it succeeded."""
        import atexit
        import sys

        prev_hook = sys.excepthook
        state = {"exit_code": 0}

        def hook(exc_type, exc, tb):
            if not self._closed and not issubclass(exc_type, SystemExit):
                self.end(V1Statuses.FAILED, message=f"{exc_type.__name__}: {exc}")
            prev_hook(exc_type, exc, tb)

        sys.excepthook = hook

        # sys.exit(nonzero) bypasses excepthook; wrap it so a deliberate
        # failure exit is not recorded as success.  (os._exit and a raw
        # `raise SystemExit(n)` still bypass this — the managed runner
        # supervises those cases by exit code.)
        prev_exit = sys.exit

        def exit_wrapper(code=0):
            state["exit_code"] = code if isinstance(code, int) else 1
            prev_exit(code)

        sys.exit = exit_wrapper

        def finalize():
            if state["exit_code"] not in (0, None):
                self.end(V1Statuses.FAILED,
                         message=f"exit code {state['exit_code']}")
            else:
                self.end(V1Statuses.SUCCEEDED)

        atexit.register(finalize)

    def _log_env(self) -> None:
        import platform
        import sys

        env = {
            "python_version": sys.version.split()[0],
            "platform": platform.platform(),
            "hostname": platform.node(),
            "pid": os.getpid(),
            "process_id": self._process_id,
        }
        try:
            import torch

            env["torch_version"] = torch.__version__
            env["cuda_version"] = torch.version.cuda
            # The device probe can block (NVML behind a wedged driver,
            # nvidia-smi under load).  init() must never hang on
            # telemetry: probe in a daemon thread with a bounded wait;
            # a probe that finishes late appends a corrected env event
            # rather than discarding its answer.
            import threading

            timeout = float(os.environ.get(
                "POLYAXON_TPU_ENV_PROBE_TIMEOUT", "30"))
            probed: dict = {}
            timed_out = threading.Event()
            # One lock makes store+late-check atomic against the main
            # thread's check+set: without it the probe could store its
            # result after the main thread's `"backend" not in probed`
            # but read timed_out before it's set — neither the main
            # record nor the correction event would carry the probed
            # backend.
            probe_lock = threading.Lock()
            # The correction event shares the main record's key, so a
            # latest-wins consumer needs the correction APPENDED AFTER
            # the main record — the probe waits for this before
            # correcting (the lock alone orders the decision, not the
            # two writer.add calls).
            main_recorded = threading.Event()

            def probe():
                # Guarded: an exception on this daemon thread would
                # escape to threading.excepthook and spam stderr on
                # every init.
                try:
                    found = _probe_device()
                except Exception:
                    return
                with probe_lock:
                    probed.update(found)
                    late = timed_out.is_set()
                if late:
                    # Late but successful: correct the record — after
                    # the stale main record is in the stream.
                    main_recorded.wait(timeout=60)
                    try:
                        self._writer.add(
                            EventKind.ENV, "env" + self._suffix,
                            make_event(EventKind.ENV, value={
                                **env, **found, "late_probe": True}))
                    except Exception:
                        # The correction is opportunistic; the main
                        # env record already shipped "unavailable".
                        logger.debug("late device-probe correction "
                                     "failed", exc_info=True)

            t = threading.Thread(target=probe, daemon=True)
            t.start()
            t.join(timeout=timeout)
            with probe_lock:
                if "backend" not in probed:
                    timed_out.set()
                env.update(probed)
                env.setdefault("backend", "unavailable")
            release_correction = main_recorded.set
        except Exception:
            release_correction = None
        self._writer.add(EventKind.ENV, "env" + self._suffix,
                         make_event(EventKind.ENV, value=env))
        if release_correction is not None:
            release_correction()

    def _log_system_metric(self, name: str, value: float,
                           timestamp: float) -> None:
        self._writer.add(EventKind.SYSTEM, name + self._suffix,
                         metric_event(value, timestamp=timestamp))

    def _copy_to_assets(self, path: str, subdir: str) -> str:
        assets = os.path.join(self.client.get_artifacts_path(), subdir)
        os.makedirs(assets, exist_ok=True)
        dest = os.path.join(assets, os.path.basename(path))
        if os.path.abspath(path) != os.path.abspath(dest):
            if os.path.isdir(path):
                shutil.copytree(path, dest, dirs_exist_ok=True)
            else:
                shutil.copy2(path, dest)
        return dest

    # -- public api -------------------------------------------------------

    @property
    def run_uuid(self) -> Optional[str]:
        return self.client.run_uuid

    def get_artifacts_path(self) -> str:
        return self.client.get_artifacts_path()

    def get_outputs_path(self) -> str:
        return self.client.get_outputs_path()

    def log_metric(self, name: str, value: float, step: Optional[int] = None,
                   timestamp: Optional[float] = None) -> None:
        if not self._tracks:
            return
        self._writer.add(EventKind.METRIC, name + self._suffix,
                         metric_event(value, step=step, timestamp=timestamp))

    def log_metrics(self, step: Optional[int] = None,
                    timestamp: Optional[float] = None,
                    **metrics: float) -> None:
        for name, value in metrics.items():
            self.log_metric(name, value, step=step, timestamp=timestamp)

    def log_inputs(self, **inputs: Any) -> None:
        if self._tracks:
            self.client.log_inputs(**inputs)

    def log_outputs(self, **outputs: Any) -> None:
        if self._tracks:
            self.client.log_outputs(**outputs)

    def log_tags(self, *tags: str) -> None:
        if self._tracks:
            self.client.log_tags(list(tags))

    def log_artifact(self, path: str, name: Optional[str] = None,
                     kind: str = EventKind.ARTIFACT,
                     step: Optional[int] = None) -> str:
        if not self._tracks:
            return path
        dest = self._copy_to_assets(path, "assets")
        name = name or os.path.basename(path)
        self._writer.add(kind, name + self._suffix,
                         artifact_event(dest, kind=kind, step=step))
        self.client.log_artifact_lineage(name, kind, dest)
        return dest

    def log_model(self, path: str, name: Optional[str] = None,
                  framework: Optional[str] = None,
                  step: Optional[int] = None) -> str:
        if not self._tracks:
            return path
        dest = self._copy_to_assets(path, "models")
        name = name or os.path.basename(path)
        self._writer.add(
            EventKind.MODEL, name + self._suffix,
            make_event(EventKind.MODEL, path=dest, framework=framework,
                       step=step))
        self.client.log_artifact_lineage(name, EventKind.MODEL, dest,
                                         summary={"framework": framework})
        return dest

    def log_image(self, path: str, name: Optional[str] = None,
                  step: Optional[int] = None) -> str:
        return self.log_artifact(path, name=name, kind=EventKind.IMAGE,
                                 step=step)

    def log_audio(self, path: str, name: Optional[str] = None,
                  step: Optional[int] = None) -> str:
        return self.log_artifact(path, name=name, kind=EventKind.AUDIO,
                                 step=step)

    def log_video(self, path: str, name: Optional[str] = None,
                  step: Optional[int] = None) -> str:
        return self.log_artifact(path, name=name, kind=EventKind.VIDEO,
                                 step=step)

    def log_html(self, html: str, name: str = "report",
                 step: Optional[int] = None) -> None:
        if not self._tracks:
            return
        self._writer.add(EventKind.HTML, name + self._suffix,
                         make_event(EventKind.HTML, value=html, step=step))

    def log_text(self, text: str, name: str = "text",
                 step: Optional[int] = None) -> None:
        if not self._tracks:
            return
        self._writer.add(EventKind.TEXT, name + self._suffix,
                         make_event(EventKind.TEXT, value=text, step=step))

    def log_curve(self, name: str, x: List[float], y: List[float],
                  annotation: Optional[str] = None,
                  step: Optional[int] = None) -> None:
        if not self._tracks:
            return
        self._writer.add(
            EventKind.CURVE, name + self._suffix,
            make_event(EventKind.CURVE, value={"x": list(x), "y": list(y)},
                       annotation=annotation, step=step))

    def log_confusion_matrix(self, name: str, labels: List[str],
                             matrix: List[List[float]],
                             step: Optional[int] = None) -> None:
        if not self._tracks:
            return
        self._writer.add(
            EventKind.CONFUSION, name + self._suffix,
            make_event(EventKind.CONFUSION,
                       value={"labels": list(labels),
                              "matrix": [list(r) for r in matrix]},
                       step=step))

    def log_histogram(self, name: str, values: List[float], bins: int = 32,
                      step: Optional[int] = None) -> None:
        if not self._tracks:
            return
        import numpy as np

        counts, edges = np.histogram(np.asarray(values), bins=bins)
        self._writer.add(
            EventKind.HISTOGRAM, name + self._suffix,
            make_event(EventKind.HISTOGRAM,
                       value={"counts": counts.tolist(),
                              "edges": edges.tolist()},
                       step=step))

    def log_dataframe(self, df: Any, name: str = "dataframe",
                      step: Optional[int] = None) -> None:
        if not self._tracks:
            return
        assets = os.path.join(self.client.get_artifacts_path(), "dataframes")
        os.makedirs(assets, exist_ok=True)
        dest = os.path.join(assets, f"{name}.csv")
        try:
            df.to_csv(dest, index=False)
        except AttributeError:
            with open(dest, "w") as f:
                json.dump(df, f, default=str)
        self._writer.add(EventKind.DATAFRAME, name + self._suffix,
                         artifact_event(dest, kind=EventKind.DATAFRAME,
                                        step=step))

    # -- profiling (SURVEY.md 5.1: a profiler capture as a tracked
    # artifact; replaces the reference's pynvml-only story) -------------

    def start_profiler_trace(self, trace_dir: Optional[str] = None
                             ) -> Optional[str]:
        """Begin a torch.profiler capture: host activity, plus the card's
        when this process uses CUDA.  ``stop_profiler_trace`` writes it as
        a Chrome trace into ``trace_dir`` (default: the run's
        ``artifacts/traces``); view it in Perfetto or chrome://tracing."""
        if not self._tracks:
            return None
        import torch
        from torch.profiler import ProfilerActivity, profile

        trace_dir = trace_dir or os.path.join(
            self.client.get_artifacts_path(), "traces")
        os.makedirs(trace_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_initialized():
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.__enter__()
        self._trace_dir = trace_dir
        return trace_dir

    def stop_profiler_trace(self, step: Optional[int] = None
                            ) -> Optional[str]:
        """End the capture; returns the Chrome trace's path."""
        if not getattr(self, "_trace_dir", None):
            return None
        import torch

        if torch.cuda.is_initialized():
            torch.cuda.synchronize()  # the window's kernels have finished
        self._profiler.__exit__(None, None, None)
        trace_dir, self._trace_dir = self._trace_dir, None
        path = os.path.join(trace_dir, f"trace_step{step}.json"
                            if step is not None else "trace.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        self._writer.add(EventKind.ARTIFACT, "profiler_trace" + self._suffix,
                         artifact_event(path, kind=EventKind.ARTIFACT,
                                        step=step))
        self.client.log_artifact_lineage("profiler_trace", "trace", path)
        return path

    @contextlib.contextmanager
    def profiler_trace(self, step: Optional[int] = None):
        """Context manager: ``with run.profiler_trace(): step_fn(...)``."""
        self.start_profiler_trace()
        try:
            yield
        finally:
            self.stop_profiler_trace(step=step)

    def get_metrics(self, name: str) -> List[Dict[str, Any]]:
        return self.client.get_metrics(name)

    # -- lifecycle --------------------------------------------------------

    def flush(self, timeout: float = 10.0) -> bool:
        return self._writer.flush(timeout=timeout)

    def end(self, status: str = V1Statuses.SUCCEEDED,
            message: Optional[str] = None) -> None:
        if self._closed:
            return
        self._closed = True
        if self._monitor is not None:
            self._monitor.stop()
        self._writer.flush()
        self._writer.close()
        if self._tracks and self._owns_status:
            self.client.log_status(status, reason="TrackingEnd",
                                   message=message)

    def __enter__(self) -> "Run":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.end(V1Statuses.SUCCEEDED)
        else:
            self.end(V1Statuses.FAILED, message=str(exc))


def _probe_device() -> Dict[str, Any]:
    """``backend``, ``device_name`` and ``device_count`` of this process:
    the CUDA device it uses when it has a CUDA context, else ``cpu`` with
    the cards NVML (or nvidia-smi) sees.  Creates no CUDA context."""
    import torch

    if torch.cuda.is_initialized():
        return {"backend": "cuda",
                "device_name": torch.cuda.get_device_name(
                    torch.cuda.current_device()),
                "device_count": torch.cuda.device_count()}
    names = [d.get("name") for d in gpu_devices()]
    return {"backend": "cpu", "device_name": names[0] if names else None,
            "device_count": len(names)}
