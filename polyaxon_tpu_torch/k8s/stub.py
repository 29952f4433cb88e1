"""In-memory kube-apiserver stub (envtest equivalent).

The reference operator is tested against controller-runtime's ``envtest``
— a real API server with no kubelet (SURVEY.md §4 "Operator (Go)").
This module is our equivalent: a stdlib HTTP server speaking enough of
the Kubernetes REST API for the agent's ``KubeBackend`` and the C++
operator's ``--kube-api`` mode to run golden interactions without a
cluster:

- typed REST paths — core ``/api/v1/namespaces/{ns}/{plural}`` and
  group ``/apis/{group}/{version}/namespaces/{ns}/{plural}``;
- verbs: POST (create, 409 on conflict), GET (read/list), PUT (replace),
  PATCH (``application/merge-patch+json``), DELETE, and the ``/status``
  subresource (spec writes bump ``metadata.generation``, status writes
  do not — the operator's change detection relies on this, matching k8s
  semantics);
- ``?watch=true`` list streams ``{"type": ..., "object": ...}`` JSON
  lines (chunked), replaying history after ``resourceVersion``;
- optional bearer-token auth (401 without it) so RBAC wiring is
  testable;
- a **fake kubelet**: created pods go Running immediately and Succeeded
  after ``pod_run_seconds`` — unless annotated:
    ``stub.polyaxon-tpu/fail``: "true"      -> Failed (exit 1)
    ``stub.polyaxon-tpu/run-seconds``: "S"  -> per-pod run time
    ``stub.polyaxon-tpu/hold``: "true"      -> stays Running until
                                               released or deleted
  which is exactly the knob chaos tests need to kill pods mid-gang.

The port's own copy of ``polyaxon_tpu/k8s/stub.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

ANN_FAIL = "stub.polyaxon-tpu/fail"
ANN_RUN_SECONDS = "stub.polyaxon-tpu/run-seconds"
ANN_HOLD = "stub.polyaxon-tpu/hold"

# /api/v1/... (core) or /apis/{group}/{version}/...
_PATH = re.compile(
    r"^/(?:api/v1|apis/(?P<group>[^/]+)/(?P<version>[^/]+))"
    r"/namespaces/(?P<ns>[^/]+)/(?P<plural>[^/]+)"
    r"(?:/(?P<name>[^/]+))?(?:/(?P<sub>status))?$")


def _deep_merge(dst: Any, patch: Any) -> Any:
    """RFC 7386 merge patch: null deletes, dicts recurse, else replace."""
    if not isinstance(patch, dict) or not isinstance(dst, dict):
        return patch
    out = dict(dst)
    for key, value in patch.items():
        if value is None:
            out.pop(key, None)
        else:
            out[key] = _deep_merge(out.get(key), value)
    return out


class _State:
    """Resource store + watch event log, guarded by one lock."""

    def __init__(self):
        self.lock = threading.RLock()
        # (group, ns, plural) -> {name: object}
        self.resources: Dict[Tuple[str, str, str], Dict[str, dict]] = {}
        self.events: List[dict] = []  # {"type", "object", "rv"}
        self.rv = 0
        self.requests: List[Tuple[str, str]] = []  # (method, path) golden log

    def next_rv(self) -> int:
        self.rv += 1
        return self.rv

    def record(self, event_type: str, obj: dict) -> None:
        self.events.append({"type": event_type, "object": obj,
                            "rv": int(obj["metadata"]["resourceVersion"])})


class StubApiServer:
    """Threaded stub apiserver; use as a context manager in tests."""

    def __init__(self, token: Optional[str] = None,
                 pod_run_seconds: float = 0.15,
                 kubelet: bool = True):
        self.state = _State()
        self.token = token
        self.pod_run_seconds = pod_run_seconds
        self._kubelet_on = kubelet
        state, stub = self.state, self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # silence
                pass

            def _deny(self, code: int, reason: str):
                body = json.dumps({"kind": "Status", "code": code,
                                   "message": reason}).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send(self, code: int, obj: dict):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _authed(self) -> bool:
                if stub.token is None:
                    return True
                auth = self.headers.get("Authorization", "")
                return auth == f"Bearer {stub.token}"

            def _body(self) -> dict:
                length = int(self.headers.get("Content-Length") or 0)
                raw = self.rfile.read(length) if length else b"{}"
                return json.loads(raw or b"{}")

            def _route(self):
                path, _, query = self.path.partition("?")
                match = _PATH.match(path)
                params = dict(p.split("=", 1) for p in query.split("&")
                              if "=" in p)
                return match, params

            def _handle(self, method: str):
                with stub.state.lock:
                    stub.state.requests.append((method, self.path))
                if not self._authed():
                    return self._deny(401, "Unauthorized")
                match, params = self._route()
                if not match:
                    return self._deny(404, f"no route: {self.path}")
                group = match.group("group") or ""
                key = (group, match.group("ns"), match.group("plural"))
                name, sub = match.group("name"), match.group("sub")
                try:
                    getattr(self, f"_do_{method.lower()}")(
                        key, name, sub, params)
                except BrokenPipeError:  # watcher went away
                    pass

            def do_GET(self):  # noqa: N802
                self._handle("GET")

            def do_POST(self):  # noqa: N802
                self._handle("POST")

            def do_PUT(self):  # noqa: N802
                self._handle("PUT")

            def do_PATCH(self):  # noqa: N802
                self._handle("PATCH")

            def do_DELETE(self):  # noqa: N802
                self._handle("DELETE")

            # -- verbs ----------------------------------------------------

            def _do_get(self, key, name, sub, params):
                stub._kubelet_tick()
                with state.lock:
                    items = state.resources.get(key, {})
                    if name:
                        obj = items.get(name)
                        if obj is None:
                            return self._deny(404, f"{name} not found")
                        return self._send(200, obj)
                    if params.get("watch") == "true":
                        since = int(params.get("resourceVersion") or 0)
                        snapshot = [e for e in state.events
                                    if e["rv"] > since
                                    and stub._event_key(e) == key]
                    else:
                        kind = key[2].rstrip("s").capitalize() + "List"
                        return self._send(200, {
                            "kind": kind,
                            "metadata": {"resourceVersion": str(state.rv)},
                            "items": list(items.values())})
                # watch: replay history, then poll for new events until
                # the client hangs up (timeoutSeconds caps it).
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                deadline = time.time() + float(
                    params.get("timeoutSeconds") or 5)
                sent = 0
                while time.time() < deadline:
                    for event in snapshot[sent:]:
                        line = json.dumps(
                            {"type": event["type"],
                             "object": event["object"]}).encode() + b"\n"
                        self.wfile.write(
                            hex(len(line))[2:].encode() + b"\r\n" + line
                            + b"\r\n")
                        self.wfile.flush()
                    sent = len(snapshot)
                    time.sleep(0.05)
                    stub._kubelet_tick()
                    with state.lock:
                        since = snapshot[-1]["rv"] if snapshot else since
                        snapshot += [e for e in state.events
                                     if e["rv"] > since
                                     and stub._event_key(e) == key]
                self.wfile.write(b"0\r\n\r\n")

            def _do_post(self, key, name, sub, params):
                obj = self._body()
                with state.lock:
                    items = state.resources.setdefault(key, {})
                    obj_name = obj.get("metadata", {}).get("name")
                    if not obj_name:
                        return self._deny(422, "metadata.name required")
                    if obj_name in items:
                        return self._deny(409, f"{obj_name} exists")
                    meta = obj.setdefault("metadata", {})
                    if meta.get("namespace") and \
                            meta["namespace"] != key[1]:
                        # real apiserver semantics: body namespace must
                        # match the request path
                        return self._deny(
                            400, f"namespace {meta['namespace']!r} does "
                                 f"not match request {key[1]!r}")
                    meta["resourceVersion"] = str(state.next_rv())
                    meta["generation"] = 1
                    meta["namespace"] = key[1]
                    meta["creationTimestamp"] = time.time()
                    if key[2] == "pods":
                        obj.setdefault("status", {})["phase"] = "Pending"
                        meta["_stub_created"] = time.time()
                    items[obj_name] = obj
                    state.record("ADDED", obj)
                self._send(201, obj)

            def _do_put(self, key, name, sub, params):
                if not name:
                    return self._deny(405, "PUT needs a name")
                body = self._body()
                with state.lock:
                    items = state.resources.get(key, {})
                    obj = items.get(name)
                    if obj is None:
                        return self._deny(404, f"{name} not found")
                    self._apply_update(key, obj, body, sub)
                    self._send(200, obj)

            def _do_patch(self, key, name, sub, params):
                if not name:
                    return self._deny(405, "PATCH needs a name")
                patch = self._body()
                with state.lock:
                    items = state.resources.get(key, {})
                    obj = items.get(name)
                    if obj is None:
                        return self._deny(404, f"{name} not found")
                    if sub == "status":
                        merged = dict(obj)
                        merged["status"] = _deep_merge(
                            obj.get("status") or {},
                            patch.get("status") or {})
                    else:
                        merged = _deep_merge(obj, patch)
                        merged["metadata"] = obj["metadata"]  # immutable-ish
                    self._apply_update(key, obj, merged, sub)
                    self._send(200, obj)

            def _apply_update(self, key, obj, new, sub):
                """In-place update honoring generation semantics."""
                meta = obj["metadata"]
                old_spec = json.dumps(obj.get("spec"), sort_keys=True)
                if sub == "status":
                    obj["status"] = new.get("status") or {}
                else:
                    obj["spec"] = new.get("spec", obj.get("spec"))
                    if "status" in new and new is not obj:
                        pass  # spec endpoint never writes status
                meta["resourceVersion"] = str(state.next_rv())
                if json.dumps(obj.get("spec"), sort_keys=True) != old_spec:
                    meta["generation"] = int(meta.get("generation", 1)) + 1
                state.record("MODIFIED", obj)

            def _do_delete(self, key, name, sub, params):
                with state.lock:
                    items = state.resources.get(key, {})
                    obj = items.pop(name, None) if name else None
                    if obj is None:
                        return self._deny(404, f"{name} not found")
                    obj["metadata"]["resourceVersion"] = str(state.next_rv())
                    state.record("DELETED", obj)
                self._send(200, {"kind": "Status", "status": "Success"})

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)

    # -- fake kubelet ------------------------------------------------------

    def _event_key(self, event) -> Tuple[str, str, str]:
        obj = event["object"]
        kind = obj.get("kind", "")
        plural = {"Pod": "pods", "Service": "services"}.get(
            kind, kind.lower() + "s")
        group = ""
        api_version = obj.get("apiVersion", "v1")
        if "/" in api_version:
            group = api_version.split("/", 1)[0]
        return (group, obj["metadata"].get("namespace", "default"), plural)

    def _kubelet_tick(self) -> None:
        """Advance pod phases (Pending -> Running -> Succeeded/Failed)."""
        if not self._kubelet_on:
            return
        now = time.time()
        with self.state.lock:
            for key, items in self.state.resources.items():
                if key[2] != "pods":
                    continue
                for pod in items.values():
                    phase = pod.get("status", {}).get("phase")
                    meta = pod["metadata"]
                    ann = meta.get("annotations") or {}
                    age = now - meta.get("_stub_created", now)
                    run_for = float(ann.get(ANN_RUN_SECONDS,
                                            self.pod_run_seconds))
                    new = None
                    if phase == "Pending":
                        new = "Running"
                    elif phase == "Running" and age >= run_for and \
                            ann.get(ANN_HOLD) != "true":
                        new = ("Failed" if ann.get(ANN_FAIL) == "true"
                               else "Succeeded")
                    if new:
                        pod.setdefault("status", {})["phase"] = new
                        if new == "Failed":
                            pod["status"]["containerStatuses"] = [
                                {"name": "ptpu-main", "state": {
                                    "terminated": {"exitCode": 1}}}]
                        elif new == "Succeeded":
                            pod["status"]["containerStatuses"] = [
                                {"name": "ptpu-main", "state": {
                                    "terminated": {"exitCode": 0}}}]
                        meta["resourceVersion"] = str(self.state.next_rv())
                        self.state.record("MODIFIED", pod)

    # -- test helpers ------------------------------------------------------

    @property
    def url(self) -> str:
        host, port = self._server.server_address
        return f"http://{host}:{port}"

    def objects(self, plural: str, namespace: str = "default",
                group: str = "") -> Dict[str, dict]:
        with self.state.lock:
            return dict(self.state.resources.get(
                (group, namespace, plural), {}))

    def set_pod_phase(self, name: str, phase: str,
                      namespace: str = "default",
                      exit_code: Optional[int] = None) -> None:
        """Chaos knob: force a pod phase (e.g. kill mid-gang)."""
        with self.state.lock:
            pod = self.state.resources.get(
                ("", namespace, "pods"), {}).get(name)
            if pod is None:
                raise KeyError(name)
            pod.setdefault("status", {})["phase"] = phase
            if exit_code is not None:
                pod["status"]["containerStatuses"] = [
                    {"name": "ptpu-main",
                     "state": {"terminated": {"exitCode": exit_code}}}]
            pod["metadata"]["resourceVersion"] = str(self.state.next_rv())
            self.state.record("MODIFIED", pod)

    def requests_log(self) -> List[Tuple[str, str]]:
        with self.state.lock:
            return list(self.state.requests)

    def start(self) -> "StubApiServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self) -> "StubApiServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
