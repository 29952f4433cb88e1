"""File-based run store: the local persistence layer.

Layout (under ``$POLYAXON_TPU_HOME`` or ``~/.polyaxon_tpu``):

    runs/<uuid>/
        metadata.json       run record (name, project, spec, inputs/outputs, status)
        statuses.jsonl      append-only status conditions
        events/<kind>/<name>.jsonl   tracked event series (metrics, images, ...)
        logs/<replica>.log  run logs
        artifacts/          run workspace (outputs/ inside)
        lineage.jsonl       artifact lineage records

The control plane (SURVEY.md 2.8) wraps this same store behind an HTTP API;
local single-process mode uses it directly, which is what makes
``ptpu run`` work with zero services running.

The port's own copy of ``polyaxon_tpu/client/store.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import fcntl
import json
import os
import re
import time
import uuid as uuidlib
from typing import Any, Dict, Iterator, List, Optional

from ..lifecycle import V1StatusCondition, V1Statuses, can_transition

# Identifiers that become path components (run uuids, replica names, event
# kinds).  The store is exposed over the network by the control-plane API,
# so a traversal segment here would be remote file write/delete.
_SAFE_ID = re.compile(r"^[A-Za-z0-9_.-]{1,64}$")


def check_safe_id(value: str, what: str = "run_uuid") -> str:
    if not isinstance(value, str) or not _SAFE_ID.match(value) \
            or value in (".", ".."):
        raise StoreError(f"Invalid {what}: {value!r}")
    return value


def default_home() -> str:
    return os.environ.get(
        "POLYAXON_TPU_HOME",
        os.path.join(os.path.expanduser("~"), ".polyaxon_tpu"),
    )


class StoreError(RuntimeError):
    pass


class _Locked:
    """fcntl-based advisory lock guarding metadata read-modify-write."""

    def __init__(self, path: str):
        self._path = path + ".lock"
        self._fh = None

    def __enter__(self):
        self._fh = open(self._path, "a+")
        fcntl.flock(self._fh.fileno(), fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        fcntl.flock(self._fh.fileno(), fcntl.LOCK_UN)
        self._fh.close()


class FileRunStore:
    """CRUD + append streams for run records on the local filesystem."""

    def __init__(self, home: Optional[str] = None):
        self.home = home or default_home()
        self.runs_root = os.path.join(self.home, "runs")
        os.makedirs(self.runs_root, exist_ok=True)

    # -- paths ------------------------------------------------------------

    def run_path(self, run_uuid: str) -> str:
        return os.path.join(self.runs_root, check_safe_id(run_uuid))

    def artifacts_path(self, run_uuid: str) -> str:
        return os.path.join(self.run_path(run_uuid), "artifacts")

    def outputs_path(self, run_uuid: str) -> str:
        return os.path.join(self.artifacts_path(run_uuid), "outputs")

    def events_path(self, run_uuid: str, kind: str, name: str) -> str:
        safe = name.replace("/", "__").replace("\\", "__").replace("\0", "_")
        check_safe_id(kind, "event kind")
        if safe in (".", ".."):
            safe = safe + "_"
        return os.path.join(self.run_path(run_uuid), "events", kind,
                            f"{safe}.jsonl")

    def logs_path(self, run_uuid: str, replica: str = "main") -> str:
        check_safe_id(replica, "replica")
        return os.path.join(self.run_path(run_uuid), "logs", f"{replica}.log")

    def _meta_path(self, run_uuid: str) -> str:
        return os.path.join(self.run_path(run_uuid), "metadata.json")

    # -- run CRUD ---------------------------------------------------------

    def create_run(
        self,
        name: Optional[str] = None,
        project: str = "default",
        description: Optional[str] = None,
        tags: Optional[List[str]] = None,
        content: Optional[Dict[str, Any]] = None,
        kind: Optional[str] = None,
        pipeline: Optional[str] = None,
        meta_info: Optional[Dict[str, Any]] = None,
        run_uuid: Optional[str] = None,
        managed_by: str = "local",
        queue: Optional[str] = None,
        priority: int = 0,
    ) -> Dict[str, Any]:
        run_uuid = run_uuid or uuidlib.uuid4().hex[:12]
        path = self.run_path(run_uuid)
        if os.path.exists(path):
            raise StoreError(f"Run {run_uuid} already exists")
        for sub in ("events", "logs", "artifacts/outputs"):
            os.makedirs(os.path.join(path, sub), exist_ok=True)
        record = {
            "uuid": run_uuid,
            "name": name or run_uuid,
            "project": project,
            "description": description,
            "tags": tags or [],
            "kind": kind,
            "content": content,
            "pipeline": pipeline,
            "meta_info": meta_info or {},
            "managed_by": managed_by,
            "queue": queue,
            "priority": int(priority or 0),
            "status": V1Statuses.CREATED,
            "created_at": time.time(),
            "updated_at": time.time(),
            "started_at": None,
            "finished_at": None,
            "wait_time": None,
            "duration": None,
            "inputs": {},
            "outputs": {},
        }
        self._write_meta(run_uuid, record)
        self._append_status_line(run_uuid, V1StatusCondition(
            type=V1Statuses.CREATED, reason="StoreCreate"))
        return record

    def _write_meta(self, run_uuid: str, record: Dict[str, Any]) -> None:
        path = self._meta_path(run_uuid)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(record, f, indent=1, default=str)
        os.replace(tmp, path)

    def get_run(self, run_uuid: str) -> Dict[str, Any]:
        path = self._meta_path(run_uuid)
        if not os.path.exists(path):
            raise StoreError(f"Run {run_uuid} not found")
        with open(path) as f:
            return json.load(f)

    def update_run(self, run_uuid: str, **fields: Any) -> Dict[str, Any]:
        with _Locked(self._meta_path(run_uuid)):
            record = self.get_run(run_uuid)
            for key, value in fields.items():
                if key in ("inputs", "outputs", "meta_info") and \
                        isinstance(value, dict):
                    record.setdefault(key, {}).update(value)
                else:
                    record[key] = value
            record["updated_at"] = time.time()
            self._write_meta(run_uuid, record)
        return record

    def delete_run(self, run_uuid: str) -> None:
        import shutil

        path = self.run_path(run_uuid)
        if os.path.exists(path):
            shutil.rmtree(path)

    def list_runs(
        self,
        project: Optional[str] = None,
        pipeline: Optional[str] = None,
        query: Optional[str] = None,
        sort: Optional[str] = None,
        limit: Optional[int] = None,
        offset: int = 0,
    ) -> List[Dict[str, Any]]:
        from ..query import apply_query, apply_sort

        records = []
        for entry in sorted(os.listdir(self.runs_root)):
            meta = self._meta_path(entry)
            if not os.path.exists(meta):
                continue
            try:
                with open(meta) as f:
                    record = json.load(f)
            except (json.JSONDecodeError, OSError):
                continue
            if project and record.get("project") != project:
                continue
            if pipeline and record.get("pipeline") != pipeline:
                continue
            records.append(record)
        if query:
            records = apply_query(records, query,
                                  metrics_reader=self.last_metrics)
            for r in records:
                r.pop("_metrics", None)  # internal query cache
        records = apply_sort(records, sort or "-created_at")
        if offset:
            records = records[offset:]
        if limit is not None:
            records = records[:limit]
        return records

    # -- statuses ---------------------------------------------------------

    def _statuses_path(self, run_uuid: str) -> str:
        return os.path.join(self.run_path(run_uuid), "statuses.jsonl")

    def _append_status_line(self, run_uuid: str,
                            condition: V1StatusCondition) -> None:
        with open(self._statuses_path(run_uuid), "a") as f:
            f.write(json.dumps(condition.to_dict()) + "\n")

    def set_status(
        self,
        run_uuid: str,
        status: str,
        reason: Optional[str] = None,
        message: Optional[str] = None,
        force: bool = False,
    ) -> bool:
        """Transition a run's status; returns False for illegal transitions."""
        with _Locked(self._meta_path(run_uuid)):
            record = self.get_run(run_uuid)
            current = record.get("status")
            if not force and not can_transition(current, status):
                return False
            now = time.time()
            record["status"] = status
            record["updated_at"] = now
            if status == V1Statuses.RUNNING and not record.get("started_at"):
                record["started_at"] = now
                record["wait_time"] = now - record["created_at"]
            if status in V1Statuses.DONE:
                record["finished_at"] = now
                if record.get("started_at"):
                    record["duration"] = now - record["started_at"]
            self._write_meta(run_uuid, record)
        self._append_status_line(
            run_uuid,
            V1StatusCondition(type=status, reason=reason, message=message),
        )
        return True

    def get_statuses(self, run_uuid: str) -> List[V1StatusCondition]:
        path = self._statuses_path(run_uuid)
        if not os.path.exists(path):
            return []
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(V1StatusCondition.from_dict(json.loads(line)))
        return out

    # -- heartbeat (zombie detection, SURVEY.md 5.3) ---------------------

    def touch_heartbeat(self, run_uuid: str) -> None:
        """Record liveness: the tracking writer touches this while the
        training process is alive; the control plane's zombie sweep
        fails RUNNING runs whose heartbeat goes stale."""
        path = os.path.join(self.run_path(run_uuid), "heartbeat")
        try:
            os.utime(path)
        except OSError:
            with open(path, "w") as f:
                f.write("")

    def heartbeat_at(self, run_uuid: str) -> Optional[float]:
        """mtime of the last heartbeat, or None if the run never sent
        one (runs without tracking must never be declared zombies)."""
        try:
            return os.stat(
                os.path.join(self.run_path(run_uuid), "heartbeat")).st_mtime
        except OSError:
            return None

    # -- events (metrics & co) -------------------------------------------

    def append_events(self, run_uuid: str, kind: str, name: str,
                      events: List[Dict[str, Any]]) -> None:
        path = self.events_path(run_uuid, kind, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "a") as f:
            for event in events:
                f.write(json.dumps(event, default=str) + "\n")

    def read_events(self, run_uuid: str, kind: str, name: str,
                    offset: int = 0) -> List[Dict[str, Any]]:
        path = self.events_path(run_uuid, kind, name)
        if not os.path.exists(path):
            return []
        out = []
        with open(path) as f:
            for i, line in enumerate(f):
                if i < offset:
                    continue
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out

    def list_events(self, run_uuid: str, kind: Optional[str] = None) -> Dict[str, List[str]]:
        root = os.path.join(self.run_path(run_uuid), "events")
        out: Dict[str, List[str]] = {}
        if not os.path.isdir(root):
            return out
        kinds = [check_safe_id(kind, "event kind")] if kind \
            else sorted(os.listdir(root))
        for k in kinds:
            kdir = os.path.join(root, k)
            if os.path.isdir(kdir):
                out[k] = sorted(
                    f[:-6] for f in os.listdir(kdir) if f.endswith(".jsonl")
                )
        return out

    def last_metrics(self, run_uuid: str) -> Dict[str, float]:
        """Final value of each tracked metric (used by tuner joins/queries)."""
        out: Dict[str, float] = {}
        for name in self.list_events(run_uuid, "metric").get("metric", []):
            events = self.read_events(run_uuid, "metric", name)
            if events:
                out[name] = events[-1].get("value")
        return out

    # -- logs -------------------------------------------------------------

    def append_log(self, run_uuid: str, text: str, replica: str = "main") -> None:
        path = self.logs_path(run_uuid, replica)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "a") as f:
            f.write(text)

    def read_logs(self, run_uuid: str, replica: Optional[str] = None,
                  tail: Optional[int] = None) -> str:
        root = os.path.join(self.run_path(run_uuid), "logs")
        if not os.path.isdir(root):
            return ""
        if replica is not None:
            check_safe_id(replica, "replica")
        files = sorted(os.listdir(root)) if replica is None else [f"{replica}.log"]
        chunks = []
        for fname in files:
            path = os.path.join(root, fname)
            if os.path.exists(path):
                with open(path) as f:
                    text = f.read()
                if len(files) > 1:
                    chunks.append(f"==> {fname} <==\n{text}")
                else:
                    chunks.append(text)
        text = "\n".join(chunks)
        if tail is not None:
            text = "\n".join(text.splitlines()[-tail:])
        return text

    # -- lineage ----------------------------------------------------------

    def add_lineage(self, run_uuid: str, record: Dict[str, Any]) -> None:
        path = os.path.join(self.run_path(run_uuid), "lineage.jsonl")
        with open(path, "a") as f:
            f.write(json.dumps(record, default=str) + "\n")

    def get_lineage(self, run_uuid: str) -> List[Dict[str, Any]]:
        path = os.path.join(self.run_path(run_uuid), "lineage.jsonl")
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return [json.loads(l) for l in f if l.strip()]
