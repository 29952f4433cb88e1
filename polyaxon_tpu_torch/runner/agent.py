"""The agent: claims queued runs from the control plane and executes them.

Parity: reference agent service (SURVEY.md 2.9, L3) — polls the queue,
invokes the converter, applies resources, watches status, reports back,
cleans up.  Backends:

- ``LocalBackend``    — executes on this host via ``LocalExecutor``
  (subprocess per replica with the full PTPU_* env); the single-box
  deployment and the test harness.
- ``ManifestBackend`` — converts to ``Operation`` CRs and writes them to
  a cluster directory; the operator (C++, ``operator/``) reconciles them
  into pods and writes status files back.  The same file protocol an
  apply-to-k8s transport implements with the API server.

DAG / matrix (tuner) kinds are controller runs: the agent executes the
controller in-process, and the controller creates child runs back
through the store — each child is then claimed and executed like any
other run.

The port's own copy of ``polyaxon_tpu/runner/agent.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

from ..client.store import FileRunStore
from ..flow import V1Operation
from ..k8s import (ConverterConfig, cluster_ip_service, convert,
                   headless_service)
from ..lifecycle import V1Statuses, is_done
from .local import LocalExecutor

logger = logging.getLogger(__name__)


@dataclass
class _Active:
    run_uuid: str
    handle: Any
    backend: "Backend"
    ttl: Optional[int] = None
    done_at: Optional[float] = None
    endpoint_recorded: bool = False


class Backend:
    """Execution transport for one claimed run."""

    def submit(self, record: Dict[str, Any],
               operation: V1Operation) -> Any:  # -> handle
        raise NotImplementedError

    def check(self, handle: Any) -> Optional[str]:
        """Current terminal status (succeeded/failed/stopped) or None."""
        raise NotImplementedError

    def stop(self, handle: Any) -> None:
        raise NotImplementedError

    def cleanup(self, handle: Any) -> None:
        pass


class LocalBackend(Backend):
    """Runs the operation on this host in a supervised thread."""

    def __init__(self, store: FileRunStore, project: str = "default"):
        self.store = store
        self.project = project

    def submit(self, record, operation):
        executor = LocalExecutor(store=self.store,
                                 project=record.get("project")
                                 or self.project)
        state = {"status": None}

        def work():
            try:
                final = executor.run_operation(operation,
                                               run_uuid=record["uuid"])
                state["status"] = final.get("status")
            except Exception as e:  # noqa: BLE001 - terminal supervision
                logger.exception("local execution failed")
                state["status"] = V1Statuses.FAILED
                self.store.set_status(record["uuid"], V1Statuses.FAILED,
                                      reason="AgentLocalBackend",
                                      message=str(e), force=True)
            finally:
                self._relay_logs(record["uuid"])

        thread = threading.Thread(target=work, daemon=True)
        thread.start()
        return (thread, state)

    def _relay_logs(self, run_uuid: str) -> None:
        """Remote store: push locally-written replica logs up to the
        control plane so `ops logs` serves them."""
        if not getattr(self.store, "host", None):
            return  # file store: logs are already in place
        try:
            if self.store.read_logs(run_uuid):
                return  # control plane shares the home tree; already there
        except Exception:  # noqa: BLE001 - relay is best-effort
            pass
        logs_dir = os.path.dirname(self.store.logs_path(run_uuid))
        if not os.path.isdir(logs_dir):
            return
        for fname in sorted(os.listdir(logs_dir)):
            if not fname.endswith(".log"):
                continue
            try:
                with open(os.path.join(logs_dir, fname)) as f:
                    text = f.read()
                if text:
                    self.store.append_log(run_uuid, text,
                                          replica=fname[:-4])
            except OSError:
                continue

    def check(self, handle):
        thread, state = handle
        if thread.is_alive():
            return None
        return state["status"] or V1Statuses.FAILED

    def stop(self, handle):
        pass  # cooperative: executor reacts to the run's `stopping` status


def convert_record(record: Dict[str, Any], operation: V1Operation,
                   store, config: ConverterConfig):
    """Resolve + convert one claimed run into (CR, [services]).

    Shared by every cluster transport (file protocol, kube API): the
    manifests are identical; only the apply mechanism differs."""
    from ..compiler import resolve

    from .joins import get_joins, resolve_joins

    join_values = None
    if get_joins(operation) and store is not None:
        join_values = resolve_joins(operation, store,
                                    project=record.get("project"))
    compiled = resolve(operation, run_uuid=record["uuid"],
                       project=record.get("project"),
                       join_values=join_values)
    cr = convert(compiled, record["uuid"], record.get("project"), config)
    services = [svc for svc in (headless_service(cr),
                                cluster_ip_service(cr)) if svc]
    return cr, services


class ManifestBackend(Backend):
    """File-protocol cluster transport.

    Layout under ``cluster_dir``:
        operations/<name>.json   CRs this agent applies
        status/<name>.json       {"phase": ..., "message": ...} from the
                                 operator
        logs/<name>/<pod>.log    what each pod printed (the operator's
                                 local runtime)

    Unlike the reference's, it relays the pods' logs into the run's logs
    (one replica per pod) as it reads the status, so ``ops logs`` over
    the control plane serves them: the operator's local runtime runs no
    sidecar, and writes them nowhere else.
    """

    _PHASES = {
        "Succeeded": V1Statuses.SUCCEEDED,
        "Failed": V1Statuses.FAILED,
        "Stopped": V1Statuses.STOPPED,
    }

    def __init__(self, cluster_dir: str,
                 config: Optional[ConverterConfig] = None,
                 store: Optional[FileRunStore] = None):
        """``store`` enables join resolution at submit time; the Agent
        fills it in when absent."""
        self.cluster_dir = cluster_dir
        self.config = config or ConverterConfig()
        self.store = store
        self._log_offsets: Dict[str, int] = {}  # pod log path -> bytes sent
        os.makedirs(os.path.join(cluster_dir, "operations"), exist_ok=True)
        os.makedirs(os.path.join(cluster_dir, "status"), exist_ok=True)

    def submit(self, record, operation):
        cr, services = convert_record(record, operation, self.store,
                                      self.config)
        name = cr["metadata"]["name"]
        path = os.path.join(self.cluster_dir, "operations", f"{name}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"operation": cr, "services": services}, f, indent=1)
        os.replace(tmp, path)
        return name

    def check(self, handle):
        status = self.read_status(handle)
        if status is None:
            return None
        return self._PHASES.get(status.get("phase"))

    def read_status(self, handle) -> Optional[Dict[str, Any]]:
        path = os.path.join(self.cluster_dir, "status", f"{handle}.json")
        if not os.path.exists(path):
            self._relay_logs(handle, final=False)
            return None
        try:
            with open(path) as f:
                status = json.load(f)
        except ValueError:
            status = None
        # Before the agent records a terminal phase: a client that sees
        # the run done finds all of its logs.
        self._relay_logs(handle, final=bool(
            status and status.get("phase") in self._PHASES))
        return status

    def _relay_logs(self, handle, final: bool) -> None:
        """Append what each pod printed since the last read to the run's
        logs.  Whole lines only until the run is done."""
        if self.store is None:
            return
        logs_dir = os.path.join(self.cluster_dir, "logs", handle)
        if not os.path.isdir(logs_dir):
            return
        run_uuid = handle.removeprefix("ptpu-")
        for fname in sorted(os.listdir(logs_dir)):
            if not fname.endswith(".log"):
                continue
            path = os.path.join(logs_dir, fname)
            offset = self._log_offsets.get(path, 0)
            try:
                with open(path, "rb") as f:
                    f.seek(offset)
                    chunk = f.read()
            except OSError:
                continue
            if not final:
                chunk = chunk[:chunk.rfind(b"\n") + 1]
            if not chunk:
                continue
            # Pod "<uuid>-<role>-<i>" -> replica "<role>-<i>"; a job's
            # one pod is "main", as the local executor names it.
            replica = fname[:-4].removeprefix(f"{run_uuid}-")
            if replica == "main-0":
                replica = "main"
            try:
                self.store.append_log(run_uuid,
                                      chunk.decode(errors="replace"),
                                      replica=replica)
            except Exception:  # noqa: BLE001 - relay is best-effort
                logger.debug("log relay of %s failed", path, exc_info=True)
                continue
            self._log_offsets[path] = offset + len(chunk)

    def stop(self, handle):
        path = os.path.join(self.cluster_dir, "operations",
                            f"{handle}.json")
        try:
            with open(path) as f:
                doc = json.load(f)
            doc["operation"]["spec"]["stopped"] = True
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except (OSError, ValueError):
            pass

    def cleanup(self, handle):
        for sub in ("operations", "status"):
            try:
                os.remove(os.path.join(self.cluster_dir, sub,
                                       f"{handle}.json"))
            except OSError:
                pass
        prefix = os.path.join(self.cluster_dir, "logs", handle) + os.sep
        for path in [p for p in self._log_offsets if p.startswith(prefix)]:
            del self._log_offsets[path]


class KubeBackend(Backend):
    """kube-apiserver transport (VERDICT r1 #7).

    Applies converted Operation CRs + headless Services through the k8s
    REST API (SURVEY.md §3.1 step 8: converter output → k8s API); the
    operator — ours in ``--kube-api`` mode, reconciling the same CRD
    ``deploy.py`` registers — turns them into pods and writes
    ``.status`` back, which ``read_status``/``check`` poll."""

    _PHASES = ManifestBackend._PHASES

    def __init__(self, client=None,
                 config: Optional[ConverterConfig] = None,
                 store: Optional[FileRunStore] = None):
        from ..k8s.kubeclient import KubeClient

        self.client = client or KubeClient()
        # CR metadata.namespace must match the namespace objects are
        # POSTed to — a real apiserver 400s on mismatch (the converter
        # default is only right for the default deployment namespace).
        self.config = config or ConverterConfig(
            namespace=self.client.namespace)
        self.store = store

    def submit(self, record, operation):
        from ..k8s.kubeclient import KubeApiError, OPERATIONS_GROUP

        cr, services = convert_record(record, operation, self.store,
                                      self.config)
        name = cr["metadata"]["name"]
        try:
            self.client.create("operations", cr, group=OPERATIONS_GROUP)
        except KubeApiError as e:
            if e.code != 409:  # already applied (agent restart): adopt
                raise
        for svc in services:
            try:
                self.client.create("services", svc)
            except KubeApiError as e:
                if e.code != 409:
                    raise
        return name

    def read_status(self, handle) -> Optional[Dict[str, Any]]:
        from ..k8s.kubeclient import KubeApiError, OPERATIONS_GROUP

        try:
            obj = self.client.get("operations", handle,
                                  group=OPERATIONS_GROUP)
        except KubeApiError:
            return None
        return obj.get("status") or None

    def check(self, handle):
        status = self.read_status(handle)
        if status is None:
            return None
        return self._PHASES.get(status.get("phase"))

    def stop(self, handle):
        from ..k8s.kubeclient import KubeApiError, OPERATIONS_GROUP

        try:
            self.client.patch("operations", handle,
                              {"spec": {"stopped": True}},
                              group=OPERATIONS_GROUP)
        except KubeApiError:
            pass

    def cleanup(self, handle):
        from ..k8s.kubeclient import KubeApiError, OPERATIONS_GROUP

        for plural, group, name in (("operations", OPERATIONS_GROUP,
                                     handle),
                                    ("services", "", f"{handle}-hs"),
                                    ("services", "", handle)):
            try:
                self.client.delete(plural, name, group=group)
            except KubeApiError:
                pass


class Agent:
    """Queue-polling loop supervising claimed runs to completion."""

    def __init__(
        self,
        plane,  # ControlPlane (in-process) or ApiRunStore (remote agent)
        backend: Optional[Backend] = None,
        name: str = "agent-0",
        poll_interval: float = 0.2,
        max_concurrent: int = 8,
        queues: Optional[list] = None,
    ):
        self.plane = plane
        # Both expose .claim(); ControlPlane wraps the store, ApiRunStore
        # IS the (remote) store.
        self.store = getattr(plane, "store", plane)
        self.backend = backend or LocalBackend(self.store)
        self.name = name
        self.poll_interval = poll_interval
        self.max_concurrent = max_concurrent
        # Restrict this agent to named queues (None = serve everything,
        # including unqueued runs).
        self.queues = list(queues) if queues else None
        # Backends that can resolve joins need store access.
        if getattr(self.backend, "store", True) is None:
            self.backend.store = self.store
        self.active: Dict[str, _Active] = {}
        self._stop = threading.Event()

    # -- lifecycle -------------------------------------------------------

    def stop(self):
        self._stop.set()

    def run_forever(self):
        while not self._stop.is_set():
            progressed = self.tick()
            if not progressed:
                self._stop.wait(self.poll_interval)

    def tick(self) -> bool:
        """One scheduling round; returns True if anything happened."""
        progressed = self._reap()
        # Finished runs merely awaiting TTL cleanup don't hold a slot.
        live = sum(1 for a in self.active.values() if a.done_at is None)
        if live < self.max_concurrent:
            record = self.plane.claim(self.name, queues=self.queues)
            if record:
                self._launch(record)
                progressed = True
        return progressed

    # -- internals -------------------------------------------------------

    def _launch(self, record: Dict[str, Any]) -> None:
        run_uuid = record["uuid"]
        try:
            operation = V1Operation.from_dict(record["content"])
        except Exception as e:  # content written by client; may be bad
            self.store.set_status(run_uuid, V1Statuses.FAILED,
                                  reason="AgentParseError", message=str(e),
                                  force=True)
            return
        try:
            handle = self.backend.submit(record, operation)
        except Exception as e:  # noqa: BLE001 - submission is a boundary
            logger.exception("submit failed for %s", run_uuid)
            self.store.set_status(run_uuid, V1Statuses.FAILED,
                                  reason="AgentSubmitError", message=str(e),
                                  force=True)
            return
        termination = (record.get("content") or {}).get("termination") or {}
        self.active[run_uuid] = _Active(
            run_uuid=run_uuid, handle=handle, backend=self.backend,
            ttl=termination.get("ttl"))
        self.store.set_status(run_uuid, V1Statuses.STARTING,
                              reason="AgentSubmit")

    def _reap(self) -> bool:
        progressed = False
        now = time.time()
        for run_uuid, active in list(self.active.items()):
            if active.done_at is not None:
                # Finished: only TTL cleanup remains (no store polling,
                # no progress claim — the loop must be able to sleep).
                if active.ttl is None or now - active.done_at >= active.ttl:
                    active.backend.cleanup(active.handle)
                    del self.active[run_uuid]
                    progressed = True
                continue
            # user/CLI requested stop?
            try:
                current = self.store.get_run(run_uuid).get("status")
            except Exception:
                current = None
            if current == V1Statuses.STOPPING:
                active.backend.stop(active.handle)
            if hasattr(active.backend, "read_status"):
                # One status read per tick serves both endpoint discovery
                # and the terminal-phase check.
                status_doc = active.backend.read_status(active.handle)
                endpoints = (status_doc or {}).get("endpoints")
                if endpoints and not active.endpoint_recorded:
                    active.endpoint_recorded = True
                    try:
                        self.store.update_run(
                            run_uuid,
                            meta_info={"endpoint": endpoints[0],
                                       "endpoints": endpoints})
                    except Exception:  # noqa: BLE001 - metadata only
                        pass
                terminal = (active.backend._PHASES.get(
                    status_doc.get("phase")) if status_doc else None)
            else:
                terminal = active.backend.check(active.handle)
            if terminal is None:
                continue
            progressed = True
            active.done_at = now
            if not is_done(current):
                self.store.set_status(run_uuid, terminal,
                                      reason="AgentReap", force=True)
            if active.ttl is None:
                active.backend.cleanup(active.handle)
                del self.active[run_uuid]
        return progressed
