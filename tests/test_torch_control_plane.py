"""The port's control plane, cron and agent against the JAX package's.

- One scripted sequence of HTTP requests goes to the reference's
  ``make_server`` and to the port's, step by step: both must answer with
  the same codes and the same bodies, uuids and timestamps masked
  (create, status transitions, claim order by priority then FIFO,
  queues, events, metrics, logs, lineage, heartbeats, 401 without the
  token, ``/metrics`` and ``/healthz`` open, the dashboard).
- ``next_fire_time`` equals the reference's on 200 seeded schedules, and
  ``ScheduleService.tick`` materialises the same children.
- The reference's cases of ``tests/test_scheduler_agent.py`` run against
  the port.
"""

from __future__ import annotations

import datetime as dt
import json
import random
import re
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from polyaxon_tpu.client.store import FileRunStore as JStore
from polyaxon_tpu.scheduler import ControlPlane as JPlane
from polyaxon_tpu.scheduler import ScheduleService as JScheduleService
from polyaxon_tpu.scheduler import make_server as j_make_server
from polyaxon_tpu.scheduler import next_fire_time as j_next_fire_time
from polyaxon_tpu.scheduler.dashboard import DASHBOARD_HTML as J_PAGE
from polyaxon_tpu_torch.client.api_client import ApiRunStore
from polyaxon_tpu_torch.client.store import FileRunStore, StoreError
from polyaxon_tpu_torch.lifecycle import V1Statuses
from polyaxon_tpu_torch.runner.agent import (Agent, LocalBackend,
                                             ManifestBackend)
from polyaxon_tpu_torch.scheduler import (
    ControlPlane,
    Cron,
    ScheduleService,
    make_server,
    next_fire_time,
)
from polyaxon_tpu_torch.scheduler.dashboard import DASHBOARD_HTML

torch.set_num_threads(2)


def _serve(server):
    # A short poll interval: shutdown() waits for one poll.
    threading.Thread(target=server.serve_forever, kwargs={
        "poll_interval": 0.02}, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}"


def _stop(server):
    server.shutdown()
    server.server_close()


@pytest.fixture
def store(tmp_home):
    return FileRunStore()


@pytest.fixture
def api(store):
    server = make_server("127.0.0.1", 0, store)
    base = _serve(server)
    yield ApiRunStore(base)
    _stop(server)


JOB_CONTENT = {
    "kind": "operation",
    "name": "hello",
    "component": {
        "kind": "component",
        "name": "hello",
        "run": {
            "kind": "job",
            "container": {
                "image": "python",
                "command": ["python", "-c", "print('hi from job')"],
            },
        },
    },
}


# -- the scripted HTTP sequence ----------------------------------------------

_TIME_KEYS = re.compile(r"(_at|_time|^time|timestamp)$")
_UUID = re.compile(r"\b[0-9a-f]{32}\b")


def _mask(obj, uuids):
    if isinstance(obj, dict):
        return {k: ("<time>" if _TIME_KEYS.search(k) and v is not None
                    else _mask(v, uuids)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v, uuids) for v in obj]
    if isinstance(obj, str):
        for u, tag in uuids.items():
            obj = obj.replace(u, tag)
        return _UUID.sub("<uuid>", obj)
    return obj


class _Side:
    """One control plane (reference or port) and the uuids it minted."""

    def __init__(self, base):
        self.base, self.uuids, self.tags = base, {}, {}

    def request(self, method, path, body=None, token="tok", raw=None):
        for tag, u in self.tags.items():
            path = path.replace(tag, u)
        data = raw if raw is not None else (
            json.dumps(body).encode() if body is not None else None)
        headers = {"Content-Type": "application/json"}
        if token:
            headers["Authorization"] = f"Bearer {token}"
        req = urllib.request.Request(self.base + path, data=data,
                                     method=method, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                code, ctype, blob = r.status, r.headers["Content-Type"], \
                    r.read()
        except urllib.error.HTTPError as e:
            code, ctype, blob = e.code, e.headers["Content-Type"], e.read()
        if ctype.startswith("application/json"):
            payload = json.loads(blob)
            if path.endswith("/runs") and method == "POST" and code == 200:
                tag = f"<run{len(self.tags)}>"
                self.tags[tag] = payload["uuid"]
                self.uuids[payload["uuid"]] = tag
            return code, ctype, _mask(payload, self.uuids)
        return code, ctype, blob.decode()


# (method, path, body, token): "<runK>" is the K-th run created.
SCRIPT = [
    ("GET", "/api/v1/healthz", None, None),
    ("GET", "/api/v1/runs", None, None),                    # 401
    ("GET", "/api/v1/runs", None, "wrong"),                 # 401
    ("GET", "/", None, None),                               # dashboard
    ("GET", "/ui", None, None),
    ("GET", "/nowhere", None, "tok"),                       # 404
    ("POST", "/api/v1/runs", {"name": "a", "project": "p",
                              "content": JOB_CONTENT}, "tok"),
    ("POST", "/api/v1/runs", {"name": "b", "project": "p", "priority": 5,
                              "content": JOB_CONTENT}, "tok"),
    ("POST", "/api/v1/runs", {"name": "c", "project": "p",
                              "content": JOB_CONTENT}, "tok"),
    ("POST", "/api/v1/runs", {"name": "d", "project": "q", "queue": "gpu",
                              "content": JOB_CONTENT,
                              "run_uuid": "0123456789abcdef0123456789abcdef"},
     "tok"),
    ("POST", "/api/v1/runs", {"name": "x", "evil": 1}, "tok"),   # 400
    ("GET", "/api/v1/runs?project=p&sort=created_at", None, "tok"),
    ("GET", "/api/v1/runs?query=name:b", None, "tok"),
    ("GET", "/api/v1/runs/<run0>", None, "tok"),
    ("GET", "/api/v1/runs/nope", None, "tok"),                 # 404
    ("PATCH", "/api/v1/runs/<run0>", {"description": "desc",
                                      "tags": ["t1"]}, "tok"),
    ("POST", "/api/v1/runs/<run0>/statuses", {"status": "queued"}, "tok"),
    ("POST", "/api/v1/runs/<run1>/statuses", {"status": "queued"}, "tok"),
    ("POST", "/api/v1/runs/<run2>/statuses", {"status": "queued"}, "tok"),
    ("POST", "/api/v1/runs/<run3>/statuses", {"status": "queued"}, "tok"),
    ("POST", "/api/v1/runs/<run0>/statuses", {"status": "succeeded"},
     "tok"),                                                   # refused
    ("GET", "/api/v1/runs/<run0>/statuses", None, "tok"),
    ("POST", "/api/v1/agent/claim", {"agent": "ag", "queues": ["gpu"]},
     "tok"),                                                   # d
    ("POST", "/api/v1/agent/claim", {"agent": "ag"}, "tok"),   # b
    ("POST", "/api/v1/agent/claim", {"agent": "ag"}, "tok"),   # a
    ("POST", "/api/v1/agent/claim", {"agent": "ag"}, "tok"),   # c
    ("POST", "/api/v1/agent/claim", {"agent": "ag"}, "tok"),   # {}
    ("POST", "/api/v1/runs/<run1>/statuses", {"status": "running",
                                              "reason": "r"}, "tok"),
    ("POST", "/api/v1/runs/<run1>/events",
     {"kind": "metric", "name": "loss",
      "events": [{"step": 0, "value": 1.0}, {"step": 1, "value": 0.5}]},
     "tok"),
    ("POST", "/api/v1/runs/<run1>/events", {"kind": "metric"}, "tok"),
    ("GET", "/api/v1/runs/<run1>/events?kind=metric&name=loss", None,
     "tok"),
    ("GET", "/api/v1/runs/<run1>/events?kind=metric&name=loss&offset=1",
     None, "tok"),
    ("GET", "/api/v1/runs/<run1>/events/names", None, "tok"),
    ("GET", "/api/v1/runs/<run1>/metrics/last", None, "tok"),
    ("GET", "/api/v1/runs?metrics=1&project=p&sort=created_at", None,
     "tok"),
    ("POST", "/api/v1/runs/<run1>/logs", {"text": "w0-a\n",
                                          "replica": "worker-0"}, "tok"),
    ("POST", "/api/v1/runs/<run1>/logs", {"text": "w1-a\n",
                                          "replica": "worker-1"}, "tok"),
    ("GET", "/api/v1/runs/<run1>/logs?offsets=%7B%7D", None, "tok"),
    ("POST", "/api/v1/runs/<run1>/logs", {"text": "w0-b\n",
                                          "replica": "worker-0"}, "tok"),
    ("GET", "/api/v1/runs/<run1>/logs?offsets=%7B%22worker-0%22%3A5%2C"
     "%22worker-1%22%3A5%7D", None, "tok"),
    ("GET", "/api/v1/runs/<run1>/logs?offset=0", None, "tok"),
    ("GET", "/api/v1/runs/<run1>/logs?replica=worker-0&tail=1", None,
     "tok"),
    ("POST", "/api/v1/runs/<run2>/logs", {"text": "aaa\n"}, "tok"),
    ("GET", "/api/v1/runs/<run2>/logs?offset=0", None, "tok"),
    ("GET", "/api/v1/runs/<run2>/logs?offset=4", None, "tok"),
    ("POST", "/api/v1/runs/<run1>/lineage", {"name": "model",
                                             "kind": "model",
                                             "path": "outputs/model"},
     "tok"),
    ("GET", "/api/v1/runs/<run1>/lineage", None, "tok"),
    ("POST", "/api/v1/runs/<run1>/heartbeat", None, "tok"),
    ("GET", "/api/v1/runs/<run1>/heartbeat", None, "tok"),
    ("GET", "/api/v1/runs/<run2>/heartbeat", None, "tok"),
    ("DELETE", "/api/v1/runs/<run2>", None, "tok"),
    ("GET", "/api/v1/runs/<run2>", None, "tok"),               # 404
    ("GET", "/api/v1/runs?project=p&sort=created_at", None, "tok"),
    ("GET", "/metrics", None, None),
    ("GET", "/api/v1/metrics", None, None),
]


def test_request_script_matches_reference(tmp_path):
    sides, servers = [], []
    for make, Plane, Store, sub in (
            (j_make_server, JPlane, JStore, "ref"),
            (make_server, ControlPlane, FileRunStore, "port")):
        plane = Plane(Store(str(tmp_path / sub)), auth_token="tok")
        server = make("127.0.0.1", 0, plane=plane)
        servers.append(server)
        sides.append(_Side(_serve(server)))
    try:
        for method, path, body, token in SCRIPT:
            ref, port = (s.request(method, path, body, token)
                         for s in sides)
            assert port == ref, (method, path)
        # A body that is not JSON is a 400 on both.
        ref, port = (s.request("POST", "/api/v1/runs", raw=b"{nope")
                     for s in sides)
        assert port == ref and port[0] == 400
    finally:
        for server in servers:
            _stop(server)
    # A client-chosen uuid is kept as given.
    assert sides[1].tags["<run3>"] == "0123456789abcdef0123456789abcdef"


def test_script_covers_the_claim_order(tmp_path):
    """The claims of the script, read on the port alone: the gpu queue
    first, then priority 5, then FIFO."""
    plane = ControlPlane(FileRunStore(str(tmp_path)), auth_token="tok")
    server = make_server("127.0.0.1", 0, plane=plane)
    side = _Side(_serve(server))
    try:
        got = [side.request(m, p, b, t) for m, p, b, t in SCRIPT[:27]]
    finally:
        _stop(server)
    claims = [body.get("name") for (code, _, body), step in
              zip(got, SCRIPT) if step[1] == "/api/v1/agent/claim"]
    assert claims == ["d", "b", "a", "c", None]
    assert [g[0] for g in got[:3]] == [200, 401, 401]
    assert got[3][2] == DASHBOARD_HTML


def test_dashboard_equals_reference():
    assert DASHBOARD_HTML == J_PAGE


# -- cron --------------------------------------------------------------------


def _random_schedule(rng: random.Random):
    kind = rng.choice(["cron", "cron", "interval", "interval", "datetime"])
    t0 = 1_780_000_000 + rng.randrange(0, 86400 * 30)
    sched = {"kind": kind}
    if kind == "cron":
        minute = rng.choice(["*", "*/5", "*/15", str(rng.randrange(60)),
                             f"{rng.randrange(30)}-{30 + rng.randrange(30)}",
                             "0,30"])
        hour = rng.choice(["*", str(rng.randrange(24)), "9-17", "*/6"])
        # A day of the month or a weekday, not both: the scan of a
        # sparse pair walks months minute by minute.
        dom = rng.choice(["*", "*", "*", str(1 + rng.randrange(28))])
        dow = "*" if dom != "*" else rng.choice(
            ["*", "*", "1-5", "0", str(rng.randrange(7))])
        sched["cron"] = f"{minute} {hour} {dom} * {dow}"
    elif kind == "interval":
        sched["frequency"] = rng.choice([1, 60, 3600, 0.5, 90])
    else:
        sched["startAt"] = t0 + rng.randrange(-3600, 3600)
    if rng.random() < 0.4:
        sched["maxRuns"] = rng.randrange(1, 4)
    if rng.random() < 0.3 and kind != "datetime":
        sched["startAt"] = dt.datetime.fromtimestamp(
            t0 + rng.randrange(-7200, 7200)).isoformat()
    if rng.random() < 0.3:
        sched["endAt"] = t0 + rng.randrange(0, 86400 * 3)
    return sched, float(t0), rng.randrange(0, 3)


def test_next_fire_time_matches_reference():
    rng = random.Random(0)
    fired = 0
    for _ in range(200):
        sched, after, iteration = _random_schedule(rng)
        want = j_next_fire_time(sched, after, iteration)
        assert next_fire_time(sched, after, iteration) == want, sched
        fired += want is not None
    assert fired > 100   # most schedules fire: the comparison is not vacuous


def _children(store, created):
    out = []
    for u in created:
        rec = store.get_run(u)
        out.append({k: rec.get(k) for k in (
            "name", "project", "status", "kind", "queue", "priority",
            "meta_info")} | {"content": rec.get("content")})
    return out


def test_schedule_service_tick_matches_reference(tmp_path):
    """The same controllers, ticked at the same times, give the same
    children on both services."""
    t0 = 1_780_000_000.0
    results = []
    for Store, Service, sub in ((JStore, JScheduleService, "ref"),
                                (FileRunStore, ScheduleService, "port")):
        store = Store(str(tmp_path / sub))
        for name, sched, queue, prio in (
                ("every", {"kind": "interval", "frequency": 60,
                           "maxRuns": 3}, "gpu", 2),
                ("cron", {"kind": "cron", "cron": "*/30 * * * *",
                          "maxRuns": 2}, None, 0),
                ("once", {"kind": "datetime", "startAt": t0 + 30}, None, 1)):
            rec = store.create_run(name=name, project="s",
                                   content={**JOB_CONTENT,
                                            "schedule": sched},
                                   queue=queue, priority=prio)
            store.set_status(rec["uuid"], V1Statuses.ON_SCHEDULE,
                             force=True)
        service = Service(store, zombie_threshold_s=0)
        log = []
        for step in range(8):
            created = service.tick(now=t0 + 900 * step)
            log.append(sorted((c["name"], json.dumps(c, sort_keys=True))
                              for c in _children(store, created)))
        controllers = sorted(
            (r["name"], r["status"]) for r in store.list_runs()
            if r.get("pipeline") is None)
        results.append((log, controllers))
    assert results[1] == results[0]
    log, controllers = results[1]
    assert sum(len(x) for x in log) == 6   # 3 + 2 + 1 children
    assert all(status == V1Statuses.SUCCEEDED for _, status in controllers)


def test_zombie_sweep_matches_reference(tmp_path):
    swept = []
    for Store, Plane, sub in ((JStore, JPlane, "ref"),
                              (FileRunStore, ControlPlane, "port")):
        store = Store(str(tmp_path / sub))
        names = {}
        for name in ("beat-1", "beat-2", "silent"):
            rec = store.create_run(name=name)
            store.set_status(rec["uuid"], V1Statuses.RUNNING, force=True)
            names[rec["uuid"]] = name
            if name != "silent":
                store.touch_heartbeat(rec["uuid"])
        plane = Plane(store)
        now = time.time()
        assert plane.sweep_zombies(threshold_s=60, now=now) == []
        got = plane.sweep_zombies(threshold_s=60, now=now + 3600)
        swept.append(sorted(names[u] for u in got))
    # A run that never sent a heartbeat is never swept.
    assert swept[1] == swept[0] == ["beat-1", "beat-2"]


# -- the reference's cases, on the port --------------------------------------


class TestApiServer:
    def test_run_crud_roundtrip(self, api):
        record = api.create_run(name="r1", project="proj",
                                content=JOB_CONTENT)
        uuid = record["uuid"]
        assert api.get_run(uuid)["name"] == "r1"
        api.update_run(uuid, description="desc")
        assert api.get_run(uuid)["description"] == "desc"
        assert [r["uuid"] for r in api.list_runs(project="proj")] == [uuid]
        api.delete_run(uuid)
        assert api.list_runs(project="proj") == []

    def test_status_transitions_enforced(self, api):
        uuid = api.create_run(name="r")["uuid"]
        assert api.set_status(uuid, V1Statuses.QUEUED)
        assert not api.set_status(uuid, V1Statuses.SUCCEEDED)
        assert [c.type for c in api.get_statuses(uuid)] == ["created",
                                                            "queued"]

    def test_events_metrics_logs(self, api):
        uuid = api.create_run(name="r")["uuid"]
        api.append_events(uuid, "metric", "loss", [
            {"step": 0, "value": 1.0}, {"step": 1, "value": 0.5}])
        events = api.read_events(uuid, "metric", "loss")
        assert [e["value"] for e in events] == [1.0, 0.5]
        assert api.read_events(uuid, "metric", "loss", offset=1) == \
            [{"step": 1, "value": 0.5}]
        assert api.last_metrics(uuid) == {"loss": 0.5}
        assert api.list_events(uuid) == {"metric": ["loss"]}
        api.append_log(uuid, "line1\n")
        api.append_log(uuid, "line2\n")
        assert api.read_logs(uuid).count("line") == 2

    def test_incremental_log_stream(self, api):
        uuid = api.create_run(name="r")["uuid"]
        api.append_log(uuid, "aaa\n")
        out = api.read_logs_from(uuid, None, 0)
        assert out["logs"].endswith("aaa\n")
        mark = out["offset"]
        api.append_log(uuid, "bbb\n")
        out = api.read_logs_from(uuid, None, mark)
        assert "aaa" not in out["logs"] and "bbb" in out["logs"]

    def test_multi_replica_log_stream(self, api):
        uuid = api.create_run(name="r")["uuid"]
        api.append_log(uuid, "w0-a\n", replica="worker-0")
        api.append_log(uuid, "w1-a\n", replica="worker-1")
        reps = api.read_logs_multi(uuid, {})["replicas"]
        assert reps["worker-0"]["logs"] == "w0-a\n"
        offsets = {r: reps[r]["offset"] for r in reps}
        api.append_log(uuid, "w0-b\n", replica="worker-0")
        reps = api.read_logs_multi(uuid, offsets)["replicas"]
        assert reps["worker-0"]["logs"] == "w0-b\n"
        assert reps["worker-1"]["logs"] == ""

    def test_lineage(self, api):
        uuid = api.create_run(name="r")["uuid"]
        api.add_lineage(uuid, {"name": "model", "kind": "model",
                               "path": "outputs/model"})
        assert api.get_lineage(uuid)[0]["name"] == "model"

    def test_claim_order_and_exhaustion(self, api):
        u1 = api.create_run(name="a")["uuid"]
        u2 = api.create_run(name="b")["uuid"]
        api.set_status(u1, V1Statuses.QUEUED)
        api.set_status(u2, V1Statuses.QUEUED)
        first = api.claim("agent-x")
        assert first["uuid"] == u1
        assert first["status"] == V1Statuses.SCHEDULED
        assert api.claim("agent-x")["uuid"] == u2
        assert api.claim("agent-x") is None


class TestAuth:
    def test_token_required_and_accepted(self, store):
        server = make_server("127.0.0.1", 0, store,
                             plane=ControlPlane(store, auth_token="s3c"))
        base = _serve(server)
        try:
            with urllib.request.urlopen(f"{base}/api/v1/healthz") as r:
                assert r.status == 200
            bad = ApiRunStore(base, token="wrong")
            with pytest.raises(StoreError, match="401"):
                bad.list_runs()
            good = ApiRunStore(base, token="s3c")
            assert good.list_runs() == []
        finally:
            _stop(server)


class TestQueuePriority:
    def test_claim_orders_by_priority_then_fifo(self, store):
        plane = ControlPlane(store)
        uuids = []
        for name, priority in (("low-1", 0), ("high", 5), ("low-2", 0)):
            record = store.create_run(name=name, content=JOB_CONTENT,
                                      priority=priority)
            store.set_status(record["uuid"], V1Statuses.QUEUED)
            uuids.append(record["uuid"])
        claimed = [plane.claim("a")["uuid"] for _ in range(3)]
        assert claimed == [uuids[1], uuids[0], uuids[2]]

    def test_agent_serves_only_its_queues(self, store):
        plane = ControlPlane(store)
        gpu = store.create_run(name="gpu-run", content=JOB_CONTENT,
                               queue="h100")
        other = store.create_run(name="other", content=JOB_CONTENT,
                                 queue="cpu")
        for record in (gpu, other):
            store.set_status(record["uuid"], V1Statuses.QUEUED)
        assert plane.claim("a", queues=["h100"])["uuid"] == gpu["uuid"]
        assert plane.claim("a", queues=["h100"]) is None
        assert store.get_run(other["uuid"])["status"] == V1Statuses.QUEUED

    def test_operation_queue_priority_reach_the_record(self, store):
        from polyaxon_tpu_torch.client.run_client import RunClient
        from polyaxon_tpu_torch.polyaxonfile import get_op_from_files

        op = get_op_from_files([{**JOB_CONTENT, "queue": "h100",
                                 "priority": 7}])
        record = RunClient(store=store).create(
            name=op.name, content=op.to_dict(), queue=op.effective_queue,
            priority=op.effective_priority)
        stored = store.get_run(record["uuid"])
        assert stored["queue"] == "h100"
        assert stored["priority"] == 7

    def test_effective_priority_zero_overrides_component(self):
        from polyaxon_tpu_torch.polyaxonfile import get_op_from_files

        spec = {**JOB_CONTENT, "priority": 0}
        spec["component"] = {**spec["component"], "priority": 5,
                             "queue": "batch"}
        op = get_op_from_files([spec])
        assert op.effective_priority == 0
        assert op.effective_queue == "batch"

    def test_scheduled_children_inherit_queue_priority(self, store):
        content = {**JOB_CONTENT,
                   "schedule": {"kind": "interval", "frequency": 1,
                                "maxRuns": 1}}
        controller = store.create_run(name="sched", content=content,
                                      queue="h100", priority=3)
        store.set_status(controller["uuid"], V1Statuses.ON_SCHEDULE,
                         force=True)
        service = ScheduleService(store, zombie_threshold_s=0)
        now = time.time()
        service.tick(now=now)
        created = service.tick(now=now + 2)
        assert created, "schedule never fired"
        child = store.get_run(created[0])
        assert child["queue"] == "h100"
        assert child["priority"] == 3

    def test_claim_survives_non_numeric_priority(self, store):
        plane = ControlPlane(store)
        record = store.create_run(name="bad", content=JOB_CONTENT)
        store.set_status(record["uuid"], V1Statuses.QUEUED)
        store.update_run(record["uuid"], priority="urgent")
        assert plane.claim("a")["uuid"] == record["uuid"]


def _until_done(agent, store, uuid, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline:
        agent.tick()
        if store.get_run(uuid).get("status") in V1Statuses.DONE:
            break
        time.sleep(0.02)
    return store.get_run(uuid)


class TestAgent:
    def test_agent_executes_queued_job(self, store):
        plane = ControlPlane(store)
        record = store.create_run(name="hello", project="default",
                                  content=JOB_CONTENT)
        store.set_status(record["uuid"], V1Statuses.QUEUED)
        agent = Agent(plane, backend=LocalBackend(store), name="t-agent")
        final = _until_done(agent, store, record["uuid"], 30)
        assert final["status"] == V1Statuses.SUCCEEDED
        assert final["agent"] == "t-agent"
        assert "hi from job" in store.read_logs(record["uuid"])

    def test_agent_marks_bad_content_failed(self, store):
        plane = ControlPlane(store)
        record = store.create_run(name="bad", content={"kind": "operation"})
        store.set_status(record["uuid"], V1Statuses.QUEUED)
        agent = Agent(plane, name="t-agent")
        assert _until_done(agent, store, record["uuid"], 10)["status"] == \
            V1Statuses.FAILED

    def test_manifest_backend_protocol(self, store, tmp_path):
        cluster = tmp_path / "cluster"
        plane = ControlPlane(store)
        content = {
            "kind": "operation",
            "name": "dist",
            "component": {
                "kind": "component",
                "name": "dist",
                "run": {
                    "kind": "tpujob",
                    "slice": {"type": "v5litepod-8"},
                    "worker": {"replicas": 2,
                               "container": {"image": "torch:latest",
                                             "command": ["python", "t.py"]}},
                },
            },
        }
        record = store.create_run(name="dist", content=content)
        store.set_status(record["uuid"], V1Statuses.QUEUED)
        agent = Agent(plane, backend=ManifestBackend(str(cluster)),
                      name="m-agent")
        agent.tick()
        files = list((cluster / "operations").glob("*.json"))
        assert len(files) == 1
        doc = json.loads(files[0].read_text())
        assert doc["operation"]["spec"]["runKind"] == "tpujob"
        main = doc["operation"]["spec"]["replicaSpecs"]["worker"][
            "template"]["spec"]["containers"][0]
        assert main["resources"]["limits"] == {"nvidia.com/gpu": 1}
        assert "google.com/tpu" not in json.dumps(doc)
        assert doc["services"], "headless service expected"
        assert store.get_run(record["uuid"])["status"] == \
            V1Statuses.STARTING
        (cluster / "status" / f"{files[0].stem}.json").write_text(
            json.dumps({"phase": "Succeeded"}))
        assert _until_done(agent, store, record["uuid"], 5)["status"] == \
            V1Statuses.SUCCEEDED
        assert not files[0].exists()


class TestSchedules:
    def test_cron_next(self):
        cron = Cron("*/15 3 * * *")
        nxt = cron.next_after(dt.datetime(2026, 7, 29, 2, 50))
        assert (nxt.hour, nxt.minute) == (3, 0)
        assert cron.next_after(nxt).minute == 15

    def test_cron_weekday_sunday_is_zero(self):
        cron = Cron("0 12 * * 0")
        assert cron.next_after(dt.datetime(2026, 7, 29, 0, 0)) == \
            dt.datetime(2026, 8, 2, 12, 0)
        assert Cron("0 12 * * 1").next_after(
            dt.datetime(2026, 7, 29, 0, 0)) == dt.datetime(2026, 8, 3, 12, 0)

    def test_interval_fire_and_exhaust(self):
        schedule = {"kind": "interval", "frequency": 60, "maxRuns": 2}
        t0 = 1000.0
        f1 = next_fire_time(schedule, t0, 0)
        assert f1 == t0
        f2 = next_fire_time(schedule, f1, 1)
        assert f2 == f1 + 60
        assert next_fire_time(schedule, f2, 2) is None

    def test_schedule_service_materializes_children(self, store):
        content = dict(JOB_CONTENT)
        content["schedule"] = {"kind": "interval", "frequency": 0.01,
                               "maxRuns": 2}
        controller = store.create_run(name="sched", content=content)
        store.set_status(controller["uuid"], V1Statuses.ON_SCHEDULE)
        service = ScheduleService(store)
        service.tick(now=time.time())
        created = service.tick(now=time.time() + 1)
        assert len(created) == 1
        created += service.tick(now=time.time() + 2)
        assert len(created) == 2
        assert store.get_run(controller["uuid"])["status"] == \
            V1Statuses.SUCCEEDED
        for uuid in created:
            child = store.get_run(uuid)
            assert child["status"] == V1Statuses.QUEUED
            assert "schedule" not in child["content"]
            assert child["pipeline"] == controller["uuid"]


def test_dashboard_served_without_auth(tmp_path):
    plane = ControlPlane(FileRunStore(str(tmp_path)), auth_token="sekrit")
    server = make_server(host="127.0.0.1", port=0, plane=plane)
    base = _serve(server)
    try:
        for path in ("/", "/ui"):
            with urllib.request.urlopen(base + path) as r:
                body = r.read().decode()
                assert r.status == 200
                assert "polyaxon-tpu" in body and "<table" in body
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(base + "/api/v1/runs")
        assert err.value.code == 401
    finally:
        _stop(server)


def test_dashboard_escapes_api_strings():
    page = DASHBOARD_HTML
    assert "${esc(r.name)}" in page
    assert "${esc(c.reason)}" in page
    assert "${esc(c.message)}" in page
    assert "${esc(logText)" in page
    assert "${r.name" not in page.replace("${esc(r.name)}", "")
    assert '/^[a-z_]+$/.test' in page
    assert "setInterval" not in page


def test_list_runs_inlines_metrics(tmp_path):
    store = FileRunStore(str(tmp_path))
    r = store.create_run(name="m")
    store.append_events(r["uuid"], "metric", "loss",
                        [{"step": 1, "value": 1.5}])
    server = make_server(host="127.0.0.1", port=0,
                         plane=ControlPlane(store))
    base = _serve(server)
    try:
        runs = json.load(urllib.request.urlopen(
            base + "/api/v1/runs?metrics=1"))
        assert runs[0]["last_metrics"] == {"loss": 1.5}
        runs = json.load(urllib.request.urlopen(base + "/api/v1/runs"))
        assert "last_metrics" not in runs[0]
    finally:
        _stop(server)


class TestControlPlaneMetrics:
    def test_metrics_endpoint(self, store, api):
        r1 = store.create_run(name="m1", project="p",
                              content=JOB_CONTENT, queue="fast")
        store.set_status(r1["uuid"], V1Statuses.QUEUED)
        r2 = store.create_run(name="m2", project="p", content=JOB_CONTENT)
        store.set_status(r2["uuid"], V1Statuses.QUEUED)
        r3 = store.create_run(name="m3", project="p", content=JOB_CONTENT)
        store.set_status(r3["uuid"], V1Statuses.RUNNING)
        store.update_run(r3["uuid"], agent="agent-7")
        with urllib.request.urlopen(api.host + "/metrics", timeout=30) as r:
            assert r.status == 200
            assert "text/plain" in r.headers["Content-Type"]
            body = r.read().decode()
        metrics = {}
        for line in body.splitlines():
            if line and not line.startswith("#"):
                name, _, value = line.rpartition(" ")
                metrics[name] = float(value)
        assert metrics['ptpu_runs{status="queued"}'] == 2
        assert metrics['ptpu_runs{status="running"}'] == 1
        assert metrics['ptpu_queue_depth{queue="fast"}'] == 1
        assert metrics['ptpu_queue_depth{queue="default"}'] == 1
        assert metrics["ptpu_active_agents"] == 1

    def test_metrics_escapes_label_values(self, store, api):
        r = store.create_run(name="mq", project="p",
                             content=JOB_CONTENT, queue='fa"st')
        store.set_status(r["uuid"], V1Statuses.QUEUED)
        with urllib.request.urlopen(api.host + "/metrics",
                                    timeout=30) as resp:
            body = resp.read().decode()
        assert 'ptpu_queue_depth{queue="fa\\"st"} 1' in body

    def test_metrics_open_like_healthz_under_auth(self, store):
        server = make_server("127.0.0.1", 0, store,
                             plane=ControlPlane(store, auth_token="s3c"))
        base = _serve(server)
        try:
            with urllib.request.urlopen(base + "/metrics",
                                        timeout=10) as r:
                assert r.status == 200
                assert "ptpu_runs" in r.read().decode()
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(base + "/api/v1/runs", timeout=10)
            assert err.value.code == 401
        finally:
            _stop(server)
