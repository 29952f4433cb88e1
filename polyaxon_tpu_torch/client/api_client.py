"""HTTP store backend: same interface as FileRunStore over the control
plane's REST API (SURVEY.md 2.7/2.8).

Implemented with stdlib urllib only.  The server half lives in
``polyaxon_tpu_torch.scheduler.api``; until a host is actually serving,
construction fails fast with a clear message instead of an import error.

The port's own copy of ``polyaxon_tpu/client/api_client.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, List, Optional

from ..lifecycle import V1StatusCondition
from .store import StoreError


class ApiRunStore:
    """FileRunStore-compatible facade speaking to the control plane."""

    def __init__(self, host: str, timeout: float = 30.0,
                 token: Optional[str] = None):
        self.host = host.rstrip("/")
        if not self.host.startswith(("http://", "https://")):
            self.host = "http://" + self.host
        self.timeout = timeout
        if token is None:
            from ..config import ClientConfig

            token = ClientConfig.load().token  # env-over-file layering
        self.token = token

    # -- transport --------------------------------------------------------

    def _request(self, method: str, path: str,
                 body: Optional[Dict[str, Any]] = None,
                 params: Optional[Dict[str, Any]] = None) -> Any:
        url = f"{self.host}/api/v1{path}"
        if params:
            qs = urllib.parse.urlencode(
                {k: v for k, v in params.items() if v is not None})
            if qs:
                url += "?" + qs
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(
            url, data=data, method=method, headers=headers,
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                payload = resp.read()
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")[:500]
            raise StoreError(
                f"API {method} {path} failed: {e.code} {detail}") from e
        except urllib.error.URLError as e:
            raise StoreError(
                f"Control plane at {self.host} unreachable: {e.reason}") from e
        return json.loads(payload) if payload else None

    # -- FileRunStore interface -------------------------------------------

    def create_run(self, **kwargs: Any) -> Dict[str, Any]:
        return self._request("POST", "/runs", body=kwargs)

    def get_run(self, run_uuid: str) -> Dict[str, Any]:
        return self._request("GET", f"/runs/{run_uuid}")

    def update_run(self, run_uuid: str, **fields: Any) -> Dict[str, Any]:
        return self._request("PATCH", f"/runs/{run_uuid}", body=fields)

    def delete_run(self, run_uuid: str) -> None:
        self._request("DELETE", f"/runs/{run_uuid}")

    def list_runs(self, project: Optional[str] = None,
                  pipeline: Optional[str] = None,
                  query: Optional[str] = None, sort: Optional[str] = None,
                  limit: Optional[int] = None,
                  offset: int = 0) -> List[Dict[str, Any]]:
        return self._request("GET", "/runs", params={
            "project": project, "pipeline": pipeline, "query": query,
            "sort": sort, "limit": limit, "offset": offset or None,
        })

    def set_status(self, run_uuid: str, status: str,
                   reason: Optional[str] = None, message: Optional[str] = None,
                   force: bool = False) -> bool:
        out = self._request("POST", f"/runs/{run_uuid}/statuses", body={
            "status": status, "reason": reason, "message": message,
            "force": force,
        })
        return bool(out and out.get("ok"))

    def get_statuses(self, run_uuid: str) -> List[V1StatusCondition]:
        out = self._request("GET", f"/runs/{run_uuid}/statuses") or []
        return [V1StatusCondition.from_dict(c) for c in out]

    def append_events(self, run_uuid: str, kind: str, name: str,
                      events: List[Dict[str, Any]]) -> None:
        self._request("POST", f"/runs/{run_uuid}/events", body={
            "kind": kind, "name": name, "events": events,
        })

    def touch_heartbeat(self, run_uuid: str) -> None:
        self._request("POST", f"/runs/{run_uuid}/heartbeat")

    def heartbeat_at(self, run_uuid: str) -> Optional[float]:
        out = self._request("GET", f"/runs/{run_uuid}/heartbeat") or {}
        return out.get("heartbeat_at")

    def read_events(self, run_uuid: str, kind: str, name: str,
                    offset: int = 0) -> List[Dict[str, Any]]:
        return self._request("GET", f"/runs/{run_uuid}/events", params={
            "kind": kind, "name": name, "offset": offset or None,
        }) or []

    def list_events(self, run_uuid: str,
                    kind: Optional[str] = None) -> Dict[str, List[str]]:
        return self._request("GET", f"/runs/{run_uuid}/events/names",
                             params={"kind": kind}) or {}

    def last_metrics(self, run_uuid: str) -> Dict[str, float]:
        return self._request("GET", f"/runs/{run_uuid}/metrics/last") or {}

    def append_log(self, run_uuid: str, text: str,
                   replica: str = "main") -> None:
        self._request("POST", f"/runs/{run_uuid}/logs", body={
            "text": text, "replica": replica,
        })

    def read_logs(self, run_uuid: str, replica: Optional[str] = None,
                  tail: Optional[int] = None) -> str:
        out = self._request("GET", f"/runs/{run_uuid}/logs", params={
            "replica": replica, "tail": tail,
        })
        return out.get("logs", "") if isinstance(out, dict) else (out or "")

    def claim(self, agent: str,
              queues: Optional[List[str]] = None) -> Optional[Dict[str, Any]]:
        """Agent-side: claim the next queued run (None when queue empty)."""
        out = self._request("POST", "/agent/claim",
                            body={"agent": agent, "queues": queues})
        return out or None

    def read_logs_from(self, run_uuid: str, replica: Optional[str],
                       offset: int) -> Dict[str, Any]:
        """Incremental log read for streaming (offset in, new text out)."""
        return self._request("GET", f"/runs/{run_uuid}/logs", params={
            "replica": replica, "offset": offset,
        }) or {"logs": "", "offset": offset}

    def read_logs_multi(self, run_uuid: str,
                        offsets: Dict[str, int]) -> Dict[str, Any]:
        """Per-replica incremental reads (the `ops logs --follow` path)."""
        return self._request("GET", f"/runs/{run_uuid}/logs", params={
            "offsets": json.dumps(offsets),
        }) or {"replicas": {}}

    def add_lineage(self, run_uuid: str, record: Dict[str, Any]) -> None:
        self._request("POST", f"/runs/{run_uuid}/lineage", body=record)

    def get_lineage(self, run_uuid: str) -> List[Dict[str, Any]]:
        return self._request("GET", f"/runs/{run_uuid}/lineage") or []

    # Local-path helpers: API mode still materializes artifacts/logs
    # locally under the home tree (the sidecar/agent relay them to the
    # control plane); reuse the file layout.

    @property
    def home(self) -> str:
        from .store import default_home

        return default_home()

    def logs_path(self, run_uuid: str, replica: str = "main") -> str:
        import os

        return os.path.join(self.home, "runs", run_uuid, "logs",
                            f"{replica}.log")

    def artifacts_path(self, run_uuid: str) -> str:
        from ..compiler.contexts import run_artifacts_path

        import os

        path = run_artifacts_path(run_uuid)
        os.makedirs(os.path.join(path, "outputs"), exist_ok=True)
        return path

    def outputs_path(self, run_uuid: str) -> str:
        import os

        return os.path.join(self.artifacts_path(run_uuid), "outputs")
