"""RunClient / ProjectClient: the capability hub over a store backend.

Env-var wiring parity (SURVEY.md 2.9/3.2): inside a launched container the
agent injects ``POLYAXON_TPU_RUN_UUID``/``POLYAXON_TPU_PROJECT`` (and, for
distributed runs, the PTPU_* topology block), so ``RunClient()`` with no
args attaches to the active run — exactly how the reference's
``tracking.init()`` self-identifies.

The port's own copy of ``polyaxon_tpu/client/run_client.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from ..lifecycle import V1Statuses
from .store import FileRunStore, StoreError

ENV_RUN_UUID = "POLYAXON_TPU_RUN_UUID"
ENV_PROJECT = "POLYAXON_TPU_PROJECT"
ENV_API_HOST = "POLYAXON_TPU_HOST"


def get_client(home: Optional[str] = None) -> "FileRunStore":
    """Backend selection: HTTP transport when an API host is configured and
    reachable, else the local file store."""
    host = os.environ.get(ENV_API_HOST)
    if host:
        from .api_client import ApiRunStore  # lazy; needs no extra deps

        return ApiRunStore(host)
    return FileRunStore(home)


class RunClient:
    """CRUD + streams for one run."""

    def __init__(
        self,
        run_uuid: Optional[str] = None,
        project: Optional[str] = None,
        store: Optional[FileRunStore] = None,
        home: Optional[str] = None,
    ):
        self.store = store or get_client(home)
        self.project = project or os.environ.get(ENV_PROJECT, "default")
        self.run_uuid = run_uuid or os.environ.get(ENV_RUN_UUID)
        self._run_data: Optional[Dict[str, Any]] = None

    # -- lifecycle --------------------------------------------------------

    def create(
        self,
        name: Optional[str] = None,
        description: Optional[str] = None,
        tags: Optional[List[str]] = None,
        content: Optional[Dict[str, Any]] = None,
        kind: Optional[str] = None,
        pipeline: Optional[str] = None,
        meta_info: Optional[Dict[str, Any]] = None,
        managed_by: str = "local",
        queue: Optional[str] = None,
        priority: int = 0,
    ) -> Dict[str, Any]:
        record = self.store.create_run(
            name=name, project=self.project, description=description,
            tags=tags, content=content, kind=kind, pipeline=pipeline,
            meta_info=meta_info, managed_by=managed_by,
            queue=queue, priority=priority,
        )
        self.run_uuid = record["uuid"]
        self._run_data = record
        return record

    def refresh_data(self) -> Dict[str, Any]:
        self._require_run()
        self._run_data = self.store.get_run(self.run_uuid)
        return self._run_data

    @property
    def run_data(self) -> Dict[str, Any]:
        if self._run_data is None:
            self.refresh_data()
        return self._run_data

    def update(self, **fields: Any) -> Dict[str, Any]:
        self._require_run()
        self._run_data = self.store.update_run(self.run_uuid, **fields)
        return self._run_data

    def _require_run(self) -> None:
        if not self.run_uuid:
            raise StoreError(
                "No run is attached: pass run_uuid or set "
                f"{ENV_RUN_UUID} (injected automatically inside managed runs)"
            )

    # -- statuses ---------------------------------------------------------

    def log_status(self, status: str, reason: Optional[str] = None,
                   message: Optional[str] = None, force: bool = False) -> bool:
        self._require_run()
        return self.store.set_status(self.run_uuid, status, reason=reason,
                                     message=message, force=force)

    def get_statuses(self):
        self._require_run()
        return self.store.get_statuses(self.run_uuid)

    def get_status(self) -> Optional[str]:
        return self.refresh_data().get("status")

    def log_succeeded(self, message: Optional[str] = None) -> None:
        self.log_status(V1Statuses.SUCCEEDED, reason="ClientDone",
                        message=message)

    def log_failed(self, reason: Optional[str] = None,
                   message: Optional[str] = None) -> None:
        self.log_status(V1Statuses.FAILED, reason=reason or "ClientFailed",
                        message=message)

    def log_stopped(self, message: Optional[str] = None) -> None:
        self.log_status(V1Statuses.STOPPED, reason="ClientStop",
                        message=message)

    # -- io / meta --------------------------------------------------------

    def log_inputs(self, **inputs: Any) -> None:
        self.update(inputs=inputs)

    def log_outputs(self, **outputs: Any) -> None:
        self.update(outputs=outputs)

    def log_meta(self, **meta: Any) -> None:
        self.update(meta_info=meta)

    def log_tags(self, tags: List[str]) -> None:
        current = set(self.run_data.get("tags") or [])
        self.update(tags=sorted(current | set(tags)))

    # -- events / metrics / logs -----------------------------------------

    def touch_heartbeat(self) -> None:
        self._require_run()
        self.store.touch_heartbeat(self.run_uuid)

    def append_events(self, kind: str, name: str,
                      events: List[Dict[str, Any]]) -> None:
        self._require_run()
        self.store.append_events(self.run_uuid, kind, name, events)

    def get_metrics(self, name: str) -> List[Dict[str, Any]]:
        self._require_run()
        return self.store.read_events(self.run_uuid, "metric", name)

    def get_last_metrics(self) -> Dict[str, float]:
        self._require_run()
        return self.store.last_metrics(self.run_uuid)

    def log_text(self, text: str, replica: str = "main") -> None:
        self._require_run()
        self.store.append_log(self.run_uuid, text, replica=replica)

    def get_logs(self, replica: Optional[str] = None,
                 tail: Optional[int] = None) -> str:
        self._require_run()
        return self.store.read_logs(self.run_uuid, replica=replica, tail=tail)

    # -- artifacts --------------------------------------------------------

    def get_artifacts_path(self) -> str:
        self._require_run()
        return self.store.artifacts_path(self.run_uuid)

    def get_outputs_path(self) -> str:
        self._require_run()
        return self.store.outputs_path(self.run_uuid)

    def log_artifact_lineage(self, name: str, kind: str, path: str,
                             summary: Optional[Dict[str, Any]] = None) -> None:
        self._require_run()
        self.store.add_lineage(self.run_uuid, {
            "name": name, "kind": kind, "path": path,
            "summary": summary or {},
        })

    def get_artifacts_lineage(self) -> List[Dict[str, Any]]:
        self._require_run()
        return self.store.get_lineage(self.run_uuid)


class ProjectClient:
    """List/search runs in a project."""

    def __init__(self, project: Optional[str] = None,
                 store: Optional[FileRunStore] = None,
                 home: Optional[str] = None):
        self.project = project or os.environ.get(ENV_PROJECT, "default")
        self.store = store or get_client(home)

    def list_runs(self, query: Optional[str] = None, sort: Optional[str] = None,
                  limit: Optional[int] = None, offset: int = 0):
        return self.store.list_runs(project=self.project, query=query,
                                    sort=sort, limit=limit, offset=offset)
