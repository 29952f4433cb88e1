"""Control-plane API service (SURVEY.md 2.8 / §7 step 8).

The reference splits this across a Django API, DB, orchestration and a
streams service (``haupt``); here it is ONE stdlib-threaded HTTP process
over the ``FileRunStore`` — runs DB, scheduling queue, status plane, and
log/event streaming in ~300 lines.  ``client.ApiRunStore`` is the
matching client; the agent claims queued work via ``/agent/claim``.

Endpoints (all under ``/api/v1``):

    POST   /runs                         create
    GET    /runs?project&query&sort&...  list (query DSL applies)
    GET    /runs/<u>                     fetch
    PATCH  /runs/<u>                     update fields
    DELETE /runs/<u>                     delete
    POST   /runs/<u>/statuses            transition {status, reason, ...}
    GET    /runs/<u>/statuses            condition history
    POST   /runs/<u>/events              append event batch
    GET    /runs/<u>/events?kind&name&offset
    GET    /runs/<u>/events/names?kind
    GET    /runs/<u>/metrics/last
    POST   /runs/<u>/logs                append {text, replica}
    GET    /runs/<u>/logs?replica&tail&offset  (offset -> incremental read)
    POST   /runs/<u>/lineage             add artifact lineage record
    GET    /runs/<u>/lineage
    POST   /agent/claim                  {agent, queues?} -> next queued run
    GET    /healthz
    GET    /metrics                      Prometheus text (runs by
                                         status, queue depth, agents);
                                         also served at the ROOT path
                                         /metrics for scrapers

The port's own copy of ``polyaxon_tpu/scheduler/api.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import re
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from ..client.store import FileRunStore, StoreError
from ..lifecycle import V1Statuses, is_done as _is_done_status


class ApiError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


class ControlPlane:
    """Request-independent core: store + queue semantics.

    Kept separate from the HTTP plumbing so the agent can embed it
    in-process (single-box deployments) and tests can drive it directly.
    """

    def __init__(self, store: Optional[FileRunStore] = None,
                 auth_token: Optional[str] = None):
        self.store = store or FileRunStore()
        self.auth_token = auth_token  # None = open (single-user/local)
        self._claim_lock = threading.Lock()

    # -- observability ---------------------------------------------------

    _METRICS_TTL_S = 10.0

    def metrics_text(self) -> str:
        """Prometheus text exposition of control-plane state: runs by
        status, queue depth per queue, claimed-agent count (SURVEY
        §5.5 — the scrape surface an in-cluster deployment pairs with
        the model server's /metrics).  Served WITHOUT auth (aggregate
        counts only — see the dispatch comment).

        The snapshot is TTL-cached: list_runs() re-reads every run's
        meta file from disk, and a 15s scrape interval against a
        long-lived store would otherwise turn /metrics into recurring
        full-store I/O growing with run history."""
        import time as _time
        from collections import Counter

        cached = getattr(self, "_metrics_cache", None)
        if cached and _time.monotonic() - cached[0] < self._METRICS_TTL_S:
            return cached[1]
        runs = self.store.list_runs()
        by_status = Counter((r.get("status") or "unknown")
                            for r in runs)
        queued_by_queue = Counter(
            (r.get("queue") or "default") for r in runs
            if r.get("status") == V1Statuses.QUEUED)
        agents = {r.get("agent") for r in runs
                  if r.get("agent") and not _is_done_status(
                      r.get("status"))}
        def esc(v: str) -> str:
            # Prometheus label-value escaping: a user-supplied queue
            # name with a quote/newline must not invalidate the WHOLE
            # scrape.
            return (str(v).replace("\\", "\\\\")
                    .replace('"', '\\"').replace("\n", "\\n"))

        lines = ["# TYPE ptpu_runs gauge"]
        for status, n in sorted(by_status.items()):
            lines.append(f'ptpu_runs{{status="{esc(status)}"}} {n}')
        lines.append("# TYPE ptpu_queue_depth gauge")
        for queue, n in sorted(queued_by_queue.items()):
            lines.append(
                f'ptpu_queue_depth{{queue="{esc(queue)}"}} {n}')
        lines += ["# TYPE ptpu_active_agents gauge",
                  f"ptpu_active_agents {len(agents)}"]
        text = "\n".join(lines) + "\n"
        self._metrics_cache = (_time.monotonic(), text)
        return text

    # -- queue ----------------------------------------------------------

    def claim(self, agent: str,
              queues: Optional[List[str]] = None) -> Optional[Dict[str, Any]]:
        """Atomically hand the oldest queued run to an agent."""
        with self._claim_lock:
            queued = self.store.list_runs(query=f"status:{V1Statuses.QUEUED}",
                                          sort="created_at")
            # Priority first (higher wins), FIFO within a priority.
            # Defensive key: a PATCHed non-numeric priority on one record
            # must not poison claiming for every agent.
            def neg_priority(record):
                try:
                    return -int(record.get("priority") or 0)
                except (TypeError, ValueError):
                    return 0

            queued.sort(key=neg_priority)
            for record in queued:
                if queues and record.get("queue") not in queues:
                    continue
                ok = self.store.set_status(
                    record["uuid"], V1Statuses.SCHEDULED,
                    reason="AgentClaim", message=agent)
                if ok:
                    self.store.update_run(record["uuid"], agent=agent)
                    return self.store.get_run(record["uuid"])
        return None

    # -- failure detection (SURVEY.md 5.3) -------------------------------

    def sweep_zombies(self, threshold_s: float = 300.0,
                      now: Optional[float] = None) -> List[str]:
        """Fail RUNNING runs whose tracking heartbeat went stale.

        Second line of defense behind the operator's pod supervision:
        catches trainers that died without the pod failing (network
        partition from the store, wedged accelerator runtime, kill -9 of
        the python process inside a living pod).  Runs that never sent a
        heartbeat (no tracking — services, bare shell jobs) are NEVER
        swept.  Returns the uuids marked failed.
        """
        import time as _time

        now = now if now is not None else _time.time()
        swept: List[str] = []
        running = self.store.list_runs(
            query=f"status:{V1Statuses.RUNNING}")
        for record in running:
            try:
                beat = self.store.heartbeat_at(record["uuid"])
                if beat is None:
                    continue
                age = now - beat
                if age <= threshold_s:
                    continue
                # The heartbeat may belong to a PREVIOUS attempt
                # (restart/resume reuses the uuid): only sweep when this
                # attempt's RUNNING transition is itself older than the
                # threshold and predates no fresher beat.
                running_since = None
                for cond in reversed(self.store.get_statuses(
                        record["uuid"])):
                    if cond.type == V1Statuses.RUNNING:
                        running_since = cond.last_transition_time
                        break
                # 1s slack: file mtimes are coarser than time.time(), so
                # a beat touched right after the transition can stat
                # marginally older than the condition timestamp.
                if running_since is not None and (
                        now - running_since <= threshold_s
                        or beat < running_since - 1.0):
                    continue
                # No force: if the run reached a terminal status between
                # the list and this call, can_transition rejects the
                # overwrite (RUNNING -> FAILED itself is legal).
                ok = self.store.set_status(
                    record["uuid"], V1Statuses.FAILED,
                    reason="ZombieDetection",
                    message=f"no heartbeat for {int(age)}s "
                            f"(threshold {int(threshold_s)}s)")
                if ok:
                    swept.append(record["uuid"])
            except Exception:
                # A deleted/corrupt run must not end the sweep (or
                # the daemon calling it) — but a sweep that skips
                # silently would also hide a broken store forever.
                import logging

                logging.getLogger(__name__).debug(
                    "zombie sweep skipped a run", exc_info=True)
                continue
        return swept

    # -- streams --------------------------------------------------------

    def read_logs_from(self, run_uuid: str, replica: Optional[str],
                       offset: int) -> Dict[str, Any]:
        """Incremental log read: byte offset in, new text + offset out.

        Offsets are stable only within ONE replica file; with several
        replicas and no replica named, the aggregated text shifts as
        earlier files grow, so fall back to full snapshots (offset 0).
        """
        if replica is None:
            import os

            logs_dir = os.path.join(self.store.run_path(run_uuid), "logs")
            files = sorted(os.listdir(logs_dir)) if os.path.isdir(logs_dir) \
                else []
            if len(files) == 1:
                replica = files[0].removesuffix(".log")
            elif len(files) > 1:
                return {"logs": self.store.read_logs(run_uuid),
                        "offset": 0}
        text = self.store.read_logs(run_uuid, replica=replica)
        blob = text.encode()
        chunk = blob[offset:] if 0 <= offset <= len(blob) else blob
        return {"logs": chunk.decode(errors="replace"),
                "offset": len(blob)}

    def read_logs_multi(self, run_uuid: str,
                        offsets: Dict[str, int]) -> Dict[str, Any]:
        """Per-replica incremental reads — the `--follow` protocol.

        ``offsets``: replica -> byte offset already delivered.  Returns
        {"replicas": {replica: {"logs": new_text, "offset": new_off}}}.
        Offsets are per-file, so multi-replica streams never shift.
        """
        import os

        logs_dir = os.path.join(self.store.run_path(run_uuid), "logs")
        out: Dict[str, Any] = {}
        if os.path.isdir(logs_dir):
            for fname in sorted(os.listdir(logs_dir)):
                if not fname.endswith(".log"):
                    continue
                replica = fname[:-4]
                offset = int(offsets.get(replica, 0))
                path = os.path.join(logs_dir, fname)
                try:
                    size = os.path.getsize(path)
                    if offset > size:
                        offset = 0  # truncated/rotated: restart
                    with open(path, "rb") as f:
                        f.seek(offset)
                        chunk = f.read()
                except OSError:
                    continue
                out[replica] = {"logs": chunk.decode(errors="replace"),
                                "offset": offset + len(chunk)}
        return {"replicas": out}


def _json_response(handler: BaseHTTPRequestHandler, code: int,
                   payload: Any) -> None:
    blob = json.dumps(payload, default=str).encode()
    handler.send_response(code)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(blob)))
    handler.end_headers()
    handler.wfile.write(blob)


_ROUTES: List[Tuple[str, re.Pattern, str]] = [
    ("POST", re.compile(r"^/runs$"), "create_run"),
    ("GET", re.compile(r"^/runs$"), "list_runs"),
    ("GET", re.compile(r"^/runs/(?P<u>[^/]+)$"), "get_run"),
    ("PATCH", re.compile(r"^/runs/(?P<u>[^/]+)$"), "update_run"),
    ("DELETE", re.compile(r"^/runs/(?P<u>[^/]+)$"), "delete_run"),
    ("POST", re.compile(r"^/runs/(?P<u>[^/]+)/statuses$"), "set_status"),
    ("GET", re.compile(r"^/runs/(?P<u>[^/]+)/statuses$"), "get_statuses"),
    ("POST", re.compile(r"^/runs/(?P<u>[^/]+)/events$"), "append_events"),
    ("GET", re.compile(r"^/runs/(?P<u>[^/]+)/events$"), "read_events"),
    ("GET", re.compile(r"^/runs/(?P<u>[^/]+)/events/names$"), "list_events"),
    ("GET", re.compile(r"^/runs/(?P<u>[^/]+)/metrics/last$"), "last_metrics"),
    ("POST", re.compile(r"^/runs/(?P<u>[^/]+)/logs$"), "append_log"),
    ("GET", re.compile(r"^/runs/(?P<u>[^/]+)/logs$"), "read_logs"),
    ("POST", re.compile(r"^/runs/(?P<u>[^/]+)/lineage$"), "add_lineage"),
    ("GET", re.compile(r"^/runs/(?P<u>[^/]+)/lineage$"), "get_lineage"),
    ("POST", re.compile(r"^/runs/(?P<u>[^/]+)/heartbeat$"),
     "touch_heartbeat"),
    ("GET", re.compile(r"^/runs/(?P<u>[^/]+)/heartbeat$"),
     "get_heartbeat"),
    ("POST", re.compile(r"^/agent/claim$"), "agent_claim"),
    ("GET", re.compile(r"^/healthz$"), "healthz"),
]


class _Handler(BaseHTTPRequestHandler):
    plane: ControlPlane  # set by make_server

    # -- dispatch -------------------------------------------------------

    def _authorized(self) -> bool:
        """ONE bearer-token check for every protected route (API and
        /metrics) — auth fixes must not diverge between them."""
        if not self.plane.auth_token:
            return True
        import hmac

        supplied = (self.headers.get("Authorization") or "")
        return hmac.compare_digest(supplied.removeprefix("Bearer "),
                                   self.plane.auth_token)

    def _dispatch(self, method: str) -> None:
        parsed = urllib.parse.urlparse(self.path)
        if method == "GET" and parsed.path in ("/", "/ui"):
            # Static, data-free page (its JS supplies the bearer token
            # for the actual API calls) — safe to serve unauthenticated.
            from .dashboard import DASHBOARD_HTML

            blob = DASHBOARD_HTML.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)
            return
        if method == "GET" and parsed.path in ("/metrics",
                                               "/api/v1/metrics"):
            # Unauthenticated like /healthz: annotation-driven
            # Prometheus scrapes send no Authorization header, and the
            # rendered in-cluster deployment ALWAYS sets a token — an
            # auth-gated /metrics would 401 every scrape of the
            # endpoint its own annotations advertise.  Exposes only
            # aggregate gauges (counts), no run content.
            blob = self.plane.metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)
            return
        if not parsed.path.startswith("/api/v1"):
            return _json_response(self, 404, {"error": "not found"})
        path = parsed.path[len("/api/v1"):] or "/"
        if path != "/healthz" and not self._authorized():
            return _json_response(self, 401, {"error": "unauthorized"})
        params = {k: v[0] for k, v in
                  urllib.parse.parse_qs(parsed.query).items()}
        body: Dict[str, Any] = {}
        length = int(self.headers.get("Content-Length") or 0)
        if length:
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
            except ValueError:
                return _json_response(self, 400, {"error": "bad json"})
        for verb, pattern, name in _ROUTES:
            if verb != method:
                continue
            m = pattern.match(path)
            if m:
                try:
                    result = getattr(self, "_h_" + name)(
                        body, params, **m.groupdict())
                except ApiError as e:
                    return _json_response(self, e.code,
                                          {"error": e.message})
                except (StoreError, FileNotFoundError) as e:
                    return _json_response(self, 404, {"error": str(e)})
                except (ValueError, TypeError, KeyError) as e:
                    # Body-driven **kwargs: bad/missing fields surface as
                    # a 400, never a dropped connection.
                    return _json_response(self, 400, {"error": repr(e)})
                return _json_response(self, 200, result)
        return _json_response(self, 404, {"error": f"no route {path}"})

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_PATCH(self):
        self._dispatch("PATCH")

    def do_DELETE(self):
        self._dispatch("DELETE")

    def log_message(self, fmt, *args):  # quiet by default
        pass

    # -- handlers -------------------------------------------------------

    def _h_healthz(self, body, params):
        return {"status": "ok"}

    _CREATE_FIELDS = frozenset({
        "name", "project", "description", "tags", "content", "kind",
        "pipeline", "meta_info", "run_uuid", "managed_by",
        "queue", "priority",
    })

    def _h_create_run(self, body, params):
        # Whitelist kwargs: the store signature is not a network contract,
        # and run_uuid is additionally validated as a safe path id inside
        # the store (ADVICE r1: unauthenticated path traversal).
        unknown = set(body) - self._CREATE_FIELDS
        if unknown:
            raise ApiError(400, f"unknown fields: {sorted(unknown)}")
        return self.plane.store.create_run(**body)

    def _h_list_runs(self, body, params):
        limit = params.get("limit")
        runs = self._list_runs_core(params, limit)
        if params.get("metrics"):
            # Inline last-metrics per run: ONE request for the
            # dashboard instead of an N+1 fetch fan-out.
            for r in runs:
                try:
                    r["last_metrics"] = \
                        self.plane.store.last_metrics(r["uuid"])
                except (StoreError, OSError):
                    r["last_metrics"] = {}
        return runs

    def _list_runs_core(self, params, limit):
        return self.plane.store.list_runs(
            project=params.get("project"),
            pipeline=params.get("pipeline"),
            query=params.get("query"),
            sort=params.get("sort"),
            limit=int(limit) if limit else None,
            offset=int(params.get("offset") or 0),
        )

    def _h_get_run(self, body, params, u):
        return self.plane.store.get_run(u)

    def _h_update_run(self, body, params, u):
        return self.plane.store.update_run(u, **body)

    def _h_delete_run(self, body, params, u):
        self.plane.store.delete_run(u)
        return {"ok": True}

    def _h_set_status(self, body, params, u):
        ok = self.plane.store.set_status(
            u, body.get("status"), reason=body.get("reason"),
            message=body.get("message"), force=bool(body.get("force")))
        return {"ok": ok}

    def _h_get_statuses(self, body, params, u):
        return [c.to_dict() for c in self.plane.store.get_statuses(u)]

    def _h_append_events(self, body, params, u):
        self.plane.store.append_events(u, body["kind"], body["name"],
                                       body.get("events") or [])
        return {"ok": True}

    def _h_read_events(self, body, params, u):
        return self.plane.store.read_events(
            u, params.get("kind"), params.get("name"),
            offset=int(params.get("offset") or 0))

    def _h_list_events(self, body, params, u):
        return self.plane.store.list_events(u, kind=params.get("kind"))

    def _h_last_metrics(self, body, params, u):
        return self.plane.store.last_metrics(u)

    def _h_touch_heartbeat(self, body, params, u):
        self.plane.store.touch_heartbeat(u)
        return {"ok": True}

    def _h_get_heartbeat(self, body, params, u):
        return {"heartbeat_at": self.plane.store.heartbeat_at(u)}

    def _h_append_log(self, body, params, u):
        self.plane.store.append_log(u, body.get("text", ""),
                                    replica=body.get("replica") or "main")
        return {"ok": True}

    def _h_read_logs(self, body, params, u):
        if "offsets" in params:
            offsets = json.loads(params["offsets"]) or {}
            return self.plane.read_logs_multi(u, offsets)
        if "offset" in params:
            return self.plane.read_logs_from(
                u, params.get("replica"), int(params["offset"]))
        tail = params.get("tail")
        return {"logs": self.plane.store.read_logs(
            u, replica=params.get("replica"),
            tail=int(tail) if tail else None)}

    def _h_add_lineage(self, body, params, u):
        self.plane.store.add_lineage(u, body)
        return {"ok": True}

    def _h_get_lineage(self, body, params, u):
        return self.plane.store.get_lineage(u)

    def _h_agent_claim(self, body, params):
        record = self.plane.claim(body.get("agent") or "agent",
                                  queues=body.get("queues"))
        return record or {}


def make_server(host: str = "127.0.0.1", port: int = 8000,
                store: Optional[FileRunStore] = None,
                plane: Optional[ControlPlane] = None) -> ThreadingHTTPServer:
    plane = plane or ControlPlane(store)
    handler = type("Handler", (_Handler,), {"plane": plane})
    server = ThreadingHTTPServer((host, port), handler)
    server.plane = plane  # type: ignore[attr-defined]
    return server


def serve_forever(host: str = "127.0.0.1", port: int = 8000,
                  store: Optional[FileRunStore] = None) -> None:
    server = make_server(host, port, store)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
