"""The port's kube transport and its whole deployment stack.

- The port's ``KubeClient`` and ``KubeBackend`` against the port's
  ``StubApiServer`` (CRUD, 409, generation bumps, the watch stream, the
  fake kubelet), and one scripted REST sequence against the reference's
  stub and the port's: the same answers.
- The shared C++ operator (``operator/``) in ``--kube-api`` mode against
  the port's stub: the reference's gang, chaos and adoption cases, and
  the port's own converted CRs (one ``nvidia.com/gpu`` a pod, the
  operator's per-pod ``PTPU_*`` identities).
- One full stack as a user types it: ``ptpu-torch server`` -> ``run``
  with ``POLYAXON_TPU_HOST`` -> ``ptpu-torch agent --backend manifest``
  -> the operator on ``--cluster-dir`` -> the pod -> status and logs
  back through the API.

The reference's cases are ``tests/test_kube_transport.py`` and
``tests/test_e2e_stack.py``.
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import uuid
from pathlib import Path

import pytest
import torch
from click.testing import CliRunner

import click

from polyaxon_tpu.cli.main import cli as j_cli
from polyaxon_tpu.k8s.kubeclient import KubeClient as JKubeClient
from polyaxon_tpu.k8s.stub import StubApiServer as JStubApiServer
from polyaxon_tpu_torch.cli.main import cli
from polyaxon_tpu_torch.client.api_client import ApiRunStore
from polyaxon_tpu_torch.client.store import FileRunStore
from polyaxon_tpu_torch.compiler import resolve
from polyaxon_tpu_torch.flow import V1Operation
from polyaxon_tpu_torch.k8s import ConverterConfig, convert
from polyaxon_tpu_torch.k8s.kubeclient import (KubeApiError, KubeClient,
                                               OPERATIONS_GROUP)
from polyaxon_tpu_torch.k8s.stub import ANN_FAIL, ANN_HOLD, StubApiServer
from polyaxon_tpu_torch.lifecycle import V1Statuses
from polyaxon_tpu_torch.runner.agent import Agent, KubeBackend
from polyaxon_tpu_torch.scheduler.api import ControlPlane

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
OPERATOR_DIR = ROOT / "operator"
BINARY = OPERATOR_DIR / "build" / "ptpu-operator"


@pytest.fixture(scope="module")
def operator_binary():
    proc = subprocess.run(["make", "-C", str(OPERATOR_DIR)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        pytest.fail(f"operator build failed:\n{proc.stderr}")
    return str(BINARY)


def _fast(server):
    """Start a stub whose shutdown waits one short poll."""
    server._thread = threading.Thread(
        target=server._server.serve_forever,
        kwargs={"poll_interval": 0.02}, daemon=True)
    return server


@pytest.fixture
def stub():
    with _fast(StubApiServer(token="stub-token")) as server:
        yield server


@pytest.fixture
def client(stub):
    return KubeClient(host=stub.url, token="stub-token",
                      namespace="default")


def _operator(binary, stub):
    return subprocess.Popen(
        [binary, "--kube-api", stub.url, "--namespace", "default",
         "--token", "stub-token", "--poll-ms", "20"])


def _end(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=5)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


@pytest.fixture
def kube_operator(stub, operator_binary):
    proc = _operator(operator_binary, stub)
    yield stub
    _end(proc)


def operation_cr(name, *, replicas=None, fail=False, hold=False,
                 backoff=0, annotations=None):
    """A distributed (gang) or single-pod Operation CR."""
    pod_ann = dict(annotations or {})
    if fail:
        pod_ann[ANN_FAIL] = "true"
    if hold:
        pod_ann[ANN_HOLD] = "true"
    template = {"metadata": {"annotations": pod_ann},
                "spec": {"containers": [{
                    "name": "ptpu-main",
                    "command": ["python", "train.py"],
                    "env": [{"name": "PTPU_COORDINATOR_ADDRESS",
                             "value": f"{name}-hs.default:8476"}],
                }]}}
    spec = {"runKind": "tpujob" if replicas else "job"}
    if replicas:
        spec["replicaSpecs"] = {"worker": {"replicas": replicas,
                                           "template": template}}
    else:
        spec["template"] = template
    if backoff:
        spec["backoffLimit"] = backoff
    return {
        "apiVersion": "core.polyaxon-tpu.io/v1",
        "kind": "Operation",
        "metadata": {"name": name,
                     "labels": {"polyaxon-tpu/run-uuid": name}},
        "spec": spec,
    }


def wait_for(predicate, timeout=15, interval=0.02, message="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(interval)
    pytest.fail(f"timed out waiting for {message}")


def wait_phase(client, name, phases=("Succeeded", "Failed", "Stopped"),
               timeout=15):
    def check():
        obj = client.get("operations", name, group=OPERATIONS_GROUP)
        status = obj.get("status") or {}
        return status if status.get("phase") in phases else None

    return wait_for(check, timeout=timeout,
                    message=f"{name} to reach {phases}")


def _pods_of(stub, n):
    seen = {}

    def check():
        seen["pods"] = stub.objects("pods")
        return len(seen["pods"]) == n

    wait_for(check, message=f"{n} pods")
    return seen["pods"]


# -- the stub against the reference's ----------------------------------------


def _masked(obj):
    if isinstance(obj, dict):
        return {k: ("<v>" if k in ("resourceVersion", "creationTimestamp",
                                   "uid", "startTime", "startedAt",
                                   "finishedAt") else _masked(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_masked(v) for v in obj]
    return obj


def _rest_script(Client, url):
    c = Client(host=url, token="stub-token", namespace="default")
    out = []

    def call(fn, *a, **k):
        try:
            out.append(("ok", _masked(fn(*a, **k))))
        except Exception as e:  # noqa: BLE001 - the error is the answer
            out.append(("error", getattr(e, "code", type(e).__name__)))

    g = {"group": OPERATIONS_GROUP}
    call(c.create, "operations", operation_cr("s-1", replicas=2), **g)
    call(c.create, "operations", operation_cr("s-1"), **g)       # 409
    call(c.get, "operations", "s-1", **g)
    call(c.get, "operations", "missing", **g)                    # 404
    call(c.patch, "operations", "s-1", {"spec": {"stopped": True}}, **g)
    call(c.patch_status, "operations", "s-1", {"phase": "Running"}, **g)
    call(c.list, "operations", **g)
    call(c.create, "services", {"apiVersion": "v1", "kind": "Service",
                                "metadata": {"name": "s-1-hs"},
                                "spec": {"clusterIP": "None"}})
    call(c.delete, "services", "s-1-hs")
    call(c.delete, "services", "s-1-hs")                         # 404
    call(c.delete, "operations", "s-1", **g)
    call(c.list, "operations", **g)
    call(Client(host=url, token="bad").list, "pods")             # 401
    return out


def test_stub_rest_script_matches_reference():
    answers = []
    for Stub, Client in ((JStubApiServer, JKubeClient),
                         (StubApiServer, KubeClient)):
        with _fast(Stub(token="stub-token", kubelet=False)) as server:
            answers.append(_rest_script(Client, server.url))
    assert answers[1] == answers[0]
    assert [a[1] for a in answers[1] if a[0] == "error"] == [409, 404, 404,
                                                            401]


# -- the reference's stub cases, on the port ---------------------------------


class TestStubApiServer:
    def test_rejects_missing_token(self, stub):
        bare = KubeClient(host=stub.url, token="wrong")
        with pytest.raises(KubeApiError) as err:
            bare.list("pods")
        assert err.value.code == 401

    def test_create_conflict(self, client):
        cr = operation_cr("op-a")
        client.create("operations", cr, group=OPERATIONS_GROUP)
        with pytest.raises(KubeApiError) as err:
            client.create("operations", cr, group=OPERATIONS_GROUP)
        assert err.value.code == 409

    def test_generation_bumps_on_spec_not_status(self, client):
        client.create("operations", operation_cr("op-gen"),
                      group=OPERATIONS_GROUP)
        obj = client.get("operations", "op-gen", group=OPERATIONS_GROUP)
        assert obj["metadata"]["generation"] == 1
        client.patch_status("operations", "op-gen", {"phase": "Running"},
                            group=OPERATIONS_GROUP)
        obj = client.get("operations", "op-gen", group=OPERATIONS_GROUP)
        assert obj["metadata"]["generation"] == 1
        assert obj["status"]["phase"] == "Running"
        client.patch("operations", "op-gen", {"spec": {"stopped": True}},
                     group=OPERATIONS_GROUP)
        obj = client.get("operations", "op-gen", group=OPERATIONS_GROUP)
        assert obj["metadata"]["generation"] == 2
        assert obj["spec"]["stopped"] is True

    def test_watch_streams_events(self, client):
        client.create("operations", operation_cr("op-w1"),
                      group=OPERATIONS_GROUP)
        events = list(client.watch("operations", group=OPERATIONS_GROUP,
                                   timeout_seconds=0.3))
        kinds = [(e["type"], e["object"]["metadata"]["name"])
                 for e in events]
        assert ("ADDED", "op-w1") in kinds

    def test_fake_kubelet_runs_pods(self, client):
        client.create("pods", {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "p1"},
            "spec": {"containers": []}})
        status = wait_for(
            lambda: (client.get("pods", "p1")["status"]
                     if client.get("pods", "p1")["status"].get("phase")
                     == "Succeeded" else None),
            message="pod to succeed")
        assert status["containerStatuses"][0]["state"]["terminated"][
            "exitCode"] == 0


# -- agent KubeBackend -------------------------------------------------------


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
                "command": ["python", "-c", "print('hi')"],
            },
        },
    },
}


class TestKubeBackend:
    def _record(self):
        op = V1Operation.from_dict(JOB_CONTENT)
        return ({"uuid": uuid.uuid4().hex[:12], "project": "default",
                 "content": op.to_dict()}, op)

    def test_submit_creates_cr(self, stub, client):
        backend = KubeBackend(client=client)
        record, op = self._record()
        name = backend.submit(record, op)
        ops = stub.objects("operations", group="core.polyaxon-tpu.io")
        assert name in ops
        assert ops[name]["spec"]["runKind"] == "job"
        assert backend.submit(record, op) == name   # 409 adopted

    def test_status_roundtrip_and_stop(self, stub, client):
        backend = KubeBackend(client=client)
        record, op = self._record()
        name = backend.submit(record, op)
        assert backend.check(name) is None
        client.patch_status("operations", name, {"phase": "Succeeded"},
                            group=OPERATIONS_GROUP)
        assert backend.check(name) == V1Statuses.SUCCEEDED
        backend.stop(name)
        obj = client.get("operations", name, group=OPERATIONS_GROUP)
        assert obj["spec"]["stopped"] is True
        backend.cleanup(name)
        assert name not in stub.objects("operations",
                                        group="core.polyaxon-tpu.io")


# -- the C++ operator in --kube-api mode -------------------------------------


TPUJOB = """
kind: component
name: gang
run:
  kind: tpujob
  slice: {type: v5litepod-16, chipsPerHost: 4}
  worker:
    replicas: 4
    container: {image: torch:latest, command: [python, -m,
                polyaxon_tpu_torch.train]}
"""


class TestOperatorKubeMode:
    def test_job_succeeds(self, kube_operator, client):
        client.create("operations", operation_cr("kj-1"),
                      group=OPERATIONS_GROUP)
        status = wait_phase(client, "kj-1")
        assert status["phase"] == "Succeeded"
        assert status["replicaStatuses"]["kj-1-main-0"]["exitCode"] == 0

    def test_gang_env_injection(self, kube_operator, client):
        client.create("operations", operation_cr("kj-gang", replicas=2,
                                                 hold=True),
                      group=OPERATIONS_GROUP)
        process_ids = set()
        for name, pod in _pods_of(kube_operator, 2).items():
            env = {e["name"]: e.get("value")
                   for e in pod["spec"]["containers"][0]["env"]}
            process_ids.add(env["PTPU_PROCESS_ID"])
            assert env["PTPU_REPLICA_ROLE"] == "worker"
            assert env["PTPU_COORDINATOR_ADDRESS"] == \
                "kj-gang-hs.default:8476"
            assert pod["spec"]["restartPolicy"] == "Never"
            assert pod["metadata"]["labels"]["polyaxon-tpu/run-uuid"] == \
                "kj-gang"
        assert process_ids == {"0", "1"}

    def test_ported_crs_one_card_a_pod(self, kube_operator, client,
                                       tmp_path):
        """The port's converted CR through the operator: four pods, each
        asking one card, each with its own process id beside the
        converter's role-level PTPU_* block."""
        f = tmp_path / "gang.yaml"
        f.write_text(TPUJOB)
        from polyaxon_tpu_torch.polyaxonfile import get_op_from_files

        cr = convert(resolve(get_op_from_files(str(f)), run_uuid="g1"),
                     "g1", "default", ConverterConfig(namespace="default"))
        pod_ann = {ANN_HOLD: "true"}
        cr["spec"]["replicaSpecs"]["worker"]["template"]["metadata"] = {
            "annotations": pod_ann}
        client.create("operations", cr, group=OPERATIONS_GROUP)
        pods = _pods_of(kube_operator, 4)
        ids = set()
        for pod in pods.values():
            main = next(c for c in pod["spec"]["containers"]
                        if c["name"] == "ptpu-main")
            assert main["resources"]["limits"] == {"nvidia.com/gpu": 1}
            assert main["resources"]["requests"] == {"nvidia.com/gpu": 1}
            assert {"key": "nvidia.com/gpu", "operator": "Exists",
                    "effect": "NoSchedule"} in pod["spec"]["tolerations"]
            env = {e["name"]: e.get("value") for e in main["env"]}
            ids.add(env["PTPU_PROCESS_ID"])
            assert env["PTPU_NUM_PROCESSES"] == "4"
            assert env["PTPU_COORDINATOR_ADDRESS"] == \
                "g1-worker-0.ptpu-g1-hs:8476"
            assert env["PTPU_CHIPS_PER_HOST"] == "4"
        assert ids == {"0", "1", "2", "3"}
        assert "google.com/tpu" not in json.dumps(pods)

    def test_gang_failure_backoff_then_failed(self, kube_operator, client):
        client.create("operations",
                      operation_cr("kj-fail", replicas=2, fail=True,
                                   backoff=1),
                      group=OPERATIONS_GROUP)
        status = wait_phase(client, "kj-fail")
        assert status["phase"] == "Failed"
        assert status["attempt"] == 1
        assert "gang" in status["message"]
        for rep in status["replicaStatuses"].values():
            assert rep["restarts"] == 1

    def test_stop_via_spec_patch(self, kube_operator, client):
        client.create("operations",
                      operation_cr("kj-stop", replicas=2, hold=True),
                      group=OPERATIONS_GROUP)
        _pods_of(kube_operator, 2)
        client.patch("operations", "kj-stop", {"spec": {"stopped": True}},
                     group=OPERATIONS_GROUP)
        assert wait_phase(client, "kj-stop")["phase"] == "Stopped"
        _pods_of(kube_operator, 0)

    def test_pod_deleted_externally_restarts_gang(self, kube_operator,
                                                  client):
        client.create("operations",
                      operation_cr("kj-chaos", replicas=2, hold=True,
                                   backoff=1),
                      group=OPERATIONS_GROUP)
        client.delete("pods", sorted(_pods_of(kube_operator, 2))[0])
        wait_for(
            lambda: (client.get("operations", "kj-chaos",
                                group=OPERATIONS_GROUP)
                     .get("status", {}).get("attempt") == 1) or None,
            message="gang restart")
        _pods_of(kube_operator, 2)

    def test_operator_restart_adopts_terminal_ops(self, stub,
                                                  operator_binary, client):
        client.create("operations", operation_cr("kj-adopt"),
                      group=OPERATIONS_GROUP)
        proc = _operator(operator_binary, stub)
        try:
            wait_phase(client, "kj-adopt")
        finally:
            _end(proc)
        pods_before = {name: pod["metadata"]["resourceVersion"]
                       for name, pod in stub.objects("pods").items()}
        rv_before = client.get("operations", "kj-adopt",
                               group=OPERATIONS_GROUP)["metadata"][
                                   "resourceVersion"]
        proc = _operator(operator_binary, stub)
        try:
            time.sleep(1.0)   # several reconcile cycles
            pods_after = {name: pod["metadata"]["resourceVersion"]
                          for name, pod in stub.objects("pods").items()}
            assert pods_after == pods_before
            obj = client.get("operations", "kj-adopt",
                             group=OPERATIONS_GROUP)
            assert obj["status"]["phase"] == "Succeeded"
            assert obj["metadata"]["resourceVersion"] == rv_before
        finally:
            _end(proc)

    def test_operator_restart_adopts_running_gang(self, stub,
                                                  operator_binary, client):
        client.create("operations",
                      operation_cr("kj-live", replicas=2, hold=True),
                      group=OPERATIONS_GROUP)
        proc = _operator(operator_binary, stub)
        try:
            _pods_of(stub, 2)
            wait_for(lambda: (client.get("operations", "kj-live",
                                         group=OPERATIONS_GROUP)
                              .get("status", {}).get("phase") == "Running")
                     or None, message="Running status")
        finally:
            _end(proc)
        pods_before = {name: pod["metadata"]["resourceVersion"]
                       for name, pod in stub.objects("pods").items()}
        proc = _operator(operator_binary, stub)
        try:
            time.sleep(1.0)
            pods_after = {name: pod["metadata"]["resourceVersion"]
                          for name, pod in stub.objects("pods").items()}
            assert pods_after == pods_before
            for name in pods_before:
                stub.set_pod_phase(name, "Succeeded", exit_code=0)
            assert wait_phase(client, "kj-live")["phase"] == "Succeeded"
        finally:
            _end(proc)

    def test_pod_name_conflict_retries_create(self, kube_operator,
                                              client):
        client.create("pods", {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "kj-conflict-main-0",
                         "annotations": {ANN_HOLD: "true"}},
            "spec": {"containers": []}})
        client.create("operations", operation_cr("kj-conflict"),
                      group=OPERATIONS_GROUP)
        assert wait_phase(client, "kj-conflict")["phase"] == "Succeeded"

    def test_cr_deleted_tears_down_pods(self, kube_operator, client):
        client.create("operations",
                      operation_cr("kj-del", replicas=2, hold=True),
                      group=OPERATIONS_GROUP)
        _pods_of(kube_operator, 2)
        client.delete("operations", "kj-del", group=OPERATIONS_GROUP)
        _pods_of(kube_operator, 0)


# -- agent + operator end to end over the API server -------------------------


SERVICE_CONTENT = {
    "kind": "operation",
    "name": "notebook",
    "component": {
        "kind": "component",
        "name": "notebook",
        "run": {
            "kind": "service",
            "ports": [8899],
            "container": {
                "image": "python",
                "command": ["python", "-m", "http.server", "8899"],
            },
        },
    },
}


def _queued(tmp_path, content, name):
    store = FileRunStore(str(tmp_path / "home"))
    record = store.create_run(name=name, project="default", content=content)
    store.set_status(record["uuid"], V1Statuses.QUEUED)
    return store, record["uuid"]


class TestKubeServiceEndpoint:
    def test_service_endpoint_roundtrip(self, kube_operator, client,
                                        tmp_path):
        store, uid = _queued(tmp_path, SERVICE_CONTENT, "nb")
        agent = Agent(ControlPlane(store), backend=KubeBackend(client=client),
                      poll_interval=0.05)
        saw_service = False

        def endpoint_recorded():
            nonlocal saw_service
            agent.tick()
            svcs = kube_operator.objects("services")
            if f"ptpu-{uid}" in svcs:
                ports = svcs[f"ptpu-{uid}"]["spec"]["ports"]
                assert ports and ports[0]["port"] == 8899
                saw_service = True
            return (store.get_run(uid).get("meta_info") or {}
                    ).get("endpoint")

        endpoint = wait_for(endpoint_recorded, timeout=20,
                            message="endpoint in meta_info")
        assert endpoint == f"ptpu-{uid}.default:8899"
        assert saw_service
        assert (store.get_run(uid).get("meta_info") or {}).get(
            "endpoints") == [endpoint]

    def test_port_forward_resolves_kube_endpoint(self, kube_operator,
                                                 client, tmp_path):
        """``ptpu-torch port-forward <uuid>`` targets the endpoint the
        kube path recorded: the relay's connect attempt names it."""
        from polyaxon_tpu_torch.runner.local import _free_port

        store, uid = _queued(tmp_path, SERVICE_CONTENT, "nb")
        agent = Agent(ControlPlane(store), backend=KubeBackend(client=client),
                      poll_interval=0.05)

        def poll_endpoint():
            agent.tick()
            return (store.get_run(uid).get("meta_info") or {}
                    ).get("endpoint")

        wait_for(poll_endpoint, timeout=20, message="endpoint in meta_info")
        local = _free_port()
        env = dict(os.environ, POLYAXON_TPU_HOME=store.home)
        proc = subprocess.Popen(
            [sys.executable, "-m", "polyaxon_tpu_torch.cli",
             "port-forward", uid, "--port", str(local)],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True, start_new_session=True, cwd=str(ROOT))
        try:
            deadline = time.time() + 60
            while time.time() < deadline:
                try:
                    with socket.create_connection(("127.0.0.1", local),
                                                  timeout=2) as s:
                        s.recv(1)  # the relay closes after its failed connect
                    break
                except OSError:
                    time.sleep(0.1)
            else:
                pytest.fail("local forward port never opened")
            want = f"connect ptpu-{uid}.default:8899 failed"
            # The relay logs the failed connect right after closing ours.
            time.sleep(1.0)
        finally:
            proc.terminate()
            _, err = proc.communicate(timeout=10)
        assert want in err


class TestAgentKubeE2E:
    def test_queued_run_executes_via_kube(self, kube_operator, client,
                                          tmp_path):
        store, uid = _queued(tmp_path, JOB_CONTENT, "kube-e2e")
        agent = Agent(ControlPlane(store), backend=KubeBackend(client=client),
                      poll_interval=0.05)

        def done():
            agent.tick()
            return store.get_run(uid).get("status") == V1Statuses.SUCCEEDED

        wait_for(done, timeout=20, message="run succeeded")
        assert kube_operator.objects("operations",
                                     group="core.polyaxon-tpu.io") == {}


# -- the whole stack, as a user types it -------------------------------------


SPEC_YAML = """
kind: component
name: e2e-trainer
inputs:
  - {name: message, type: str, value: stack-e2e, isOptional: true}
run:
  kind: job
  container:
    image: python:3.11
    command: [python, -c, "print('msg={{ message }}')"]
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_full_stack(tmp_path, operator_binary):
    """``server`` and ``agent --backend manifest`` started as the CLI
    starts them, the operator on the cluster directory, ``run`` with
    ``POLYAXON_TPU_HOST``: the run succeeds and its pod's log comes back
    through the API (the port's manifest backend relays it)."""
    home, cluster = tmp_path / "home", tmp_path / "cluster"
    home.mkdir()
    cluster.mkdir()
    port = _free_port()
    host = f"http://127.0.0.1:{port}"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("POLYAXON_TPU_")}
    env.update(POLYAXON_TPU_HOME=str(home), POLYAXON_TPU_AUTH_TOKEN="T")
    ptpu = [sys.executable, "-m", "polyaxon_tpu_torch.cli"]
    procs = [
        subprocess.Popen(ptpu + ["server", "--port", str(port),
                                 "--no-schedules"],
                         env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True),
        subprocess.Popen([operator_binary, "--cluster-dir", str(cluster),
                          "--poll-ms", "20"], cwd=str(tmp_path)),
    ]
    try:
        api = ApiRunStore(host, token="T")

        def up():
            try:
                return api.list_runs() == []
            except Exception:  # noqa: BLE001 - not listening yet
                return False

        wait_for(up, timeout=60, interval=0.1, message="control plane up")
        # The agent exits when its first claim finds no control plane.
        procs.insert(1, subprocess.Popen(
            ptpu + ["agent", "--backend", "manifest", "--cluster-dir",
                    str(cluster), "--host", host, "--name", "e2e-agent"],
            env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
        spec = tmp_path / "e2e.yaml"
        spec.write_text(SPEC_YAML)
        cli_env = {"POLYAXON_TPU_HOST": host, "POLYAXON_TPU_HOME": str(home),
                   "POLYAXON_TPU_AUTH_TOKEN": "T"}
        runner = CliRunner()
        out = runner.invoke(cli, ["run", "-f", str(spec), "-P",
                                  "message=from-the-cli"], env=cli_env)
        assert out.exit_code == 0, out.output
        assert "queued" in out.output
        runs = api.list_runs()
        assert len(runs) == 1
        uid = runs[0]["uuid"]
        final = wait_for(
            lambda: (api.get_run(uid) if api.get_run(uid).get("status")
                     in V1Statuses.DONE else None),
            timeout=60, interval=0.05, message="run done")
        assert final["status"] == V1Statuses.SUCCEEDED
        assert final["agent"] == "e2e-agent"
        # The pod's log: in the cluster directory, and through the API.
        log = (cluster / "logs" / f"ptpu-{uid}" /
               f"{uid}-main-0.log").read_text()
        assert "msg=from-the-cli" in log
        assert "msg=from-the-cli" in api.read_logs(uid)
        out = runner.invoke(cli, ["ops", "logs", uid], env=cli_env)
        assert "msg=from-the-cli" in out.output, out.output
        types = [c.type for c in api.get_statuses(uid)]
        assert types[0] == "created"
        assert "queued" in types and "scheduled" in types
        assert types[-1] == "succeeded"
        out = runner.invoke(cli, ["ops", "statuses", uid], env=cli_env)
        assert out.exit_code == 0 and "succeeded" in out.output
        # The CR the agent applied asks for no card: a plain job.
        assert not list((cluster / "operations").glob("*.json"))
    finally:
        for proc in procs:
            _end(proc)
        for proc in procs[:2]:
            text = proc.stdout.read()
            proc.stdout.close()
            assert "Traceback" not in text, text


# -- the CLI's command set against the reference's ---------------------------


def _commands(group, prefix=()):
    out = {}
    for name, command in group.commands.items():
        out[prefix + (name,)] = command
        if isinstance(command, click.Group):
            out.update(_commands(command, prefix + (name,)))
    return out


J_COMMANDS = _commands(j_cli)
# Options whose defaults differ on purpose: the port deploys its own image.
DIFFERENT_DEFAULTS = {("admin", "deploy"): {"image"}}


@pytest.mark.parametrize("path", sorted(J_COMMANDS),
                         ids=[" ".join(p) for p in sorted(J_COMMANDS)])
def test_cli_command_matches_reference(path):
    """Every command and group of the reference's CLI has a counterpart
    with the same options (each of the reference's flags accepted) and
    the same defaults, but for the listed ones."""
    port = _commands(cli).get(path)
    assert port is not None, f"ptpu-torch lacks {' '.join(path)}"
    assert isinstance(port, click.Group) == \
        isinstance(J_COMMANDS[path], click.Group)
    params = {p.name: p for p in port.params}
    for want in J_COMMANDS[path].params:
        got = params.get(want.name)
        assert got is not None, (path, want.name)
        assert set(want.opts) <= set(got.opts), (path, want.name)
        assert getattr(got, "is_flag", False) == \
            getattr(want, "is_flag", False), (path, want.name)
        if want.name in DIFFERENT_DEFAULTS.get(path, ()):
            assert got.default != want.default
            assert "polyaxon-tpu-torch" in got.default
        else:
            assert got.default == want.default, (path, want.name)


def test_cli_help_lists_the_reference_commands():
    out = CliRunner().invoke(cli, ["--help"])
    assert out.exit_code == 0
    listed = {line.split()[0] for line in
              out.output.split("Commands:")[1].splitlines() if line.strip()}
    assert set(j_cli.commands) <= listed
