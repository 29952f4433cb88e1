"""The port's converter, auxiliaries and deployment manifests against the
JAX package's, on the same polyaxonfiles and the same configs.

The manifests must be equal after ``to_port``, one normalising function
that maps exactly the accelerator vocabulary and the module names:

- the per-pod request ``google.com/tpu: chipsPerHost`` becomes
  ``nvidia.com/gpu: 1`` (one process, one card);
- the toleration key ``google.com/tpu`` becomes ``nvidia.com/gpu``;
- the GKE slice labels (``cloud.google.com/gke-tpu-*``) go: a TPU family
  selects no GPU product;
- ``polyaxon_tpu.*`` module names in commands become
  ``polyaxon_tpu_torch.*``;
- the default images become the port's (``polyaxon-tpu-torch/*``).

Each difference is also asserted on its own.  Then the reference's
converter, auxiliary and deploy cases (``tests/test_k8s_converter.py``,
``test_aux_containers.py``, ``test_deploy.py``) run against the port.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess

import pytest
import torch

from polyaxon_tpu import deploy as J_deploy
from polyaxon_tpu import k8s as J_k8s
from polyaxon_tpu.compiler import resolve as J_resolve
from polyaxon_tpu.connections import ConnectionCatalog as JCatalog
from polyaxon_tpu.connections import V1Connection as JConnection
from polyaxon_tpu.flow.environment import V1Init as JInit
from polyaxon_tpu.k8s import auxiliaries as J_aux
from polyaxon_tpu.polyaxonfile import get_op_from_files as J_get_op
from polyaxon_tpu_torch import deploy as P_deploy
from polyaxon_tpu_torch import k8s as P_k8s
from polyaxon_tpu_torch.compiler import resolve as P_resolve
from polyaxon_tpu_torch.connections import ConnectionCatalog as PCatalog
from polyaxon_tpu_torch.connections import V1Connection as PConnection
from polyaxon_tpu_torch.deploy import DeploymentConfig, render_all
from polyaxon_tpu_torch.flow.environment import V1Init as PInit
from polyaxon_tpu_torch.initializer import (
    InitError,
    init_artifacts,
    init_dockerfile,
    init_file,
    init_git,
)
from polyaxon_tpu_torch.initializer import main as init_main
from polyaxon_tpu_torch.k8s import (
    COORDINATOR_PORT,
    GPU_RESOURCE,
    MAIN_CONTAINER,
    PRODUCT_LABEL,
    ConverterConfig,
    SliceError,
    convert,
    default_topology,
    headless_service,
    product_for,
)
from polyaxon_tpu_torch.k8s import auxiliaries as P_aux
from polyaxon_tpu_torch.polyaxonfile import get_op_from_files
from polyaxon_tpu_torch.sidecar import Sidecar, _sync_tree

torch.set_num_threads(2)

TPU_RESOURCE = "google.com/tpu"
_GKE_LABELS = ("cloud.google.com/gke-tpu-accelerator",
               "cloud.google.com/gke-tpu-topology")
_IMAGES = {"polyaxon-tpu/aux:latest": "polyaxon-tpu-torch/aux:latest",
           "polyaxon-tpu/core:latest": "polyaxon-tpu-torch/core:latest"}
_MODULES = ("polyaxon_tpu.cli", "polyaxon_tpu.initializer",
            "polyaxon_tpu.sidecar")


def to_port(obj):
    """The reference's manifest in the port's vocabulary (see the module
    docstring: exactly the listed differences, nothing else)."""
    if isinstance(obj, list):
        return [to_port(v) for v in obj]
    if isinstance(obj, str):
        if obj in _MODULES:
            return obj.replace("polyaxon_tpu.", "polyaxon_tpu_torch.")
        return _IMAGES.get(obj, obj)
    if not isinstance(obj, dict):
        return obj
    out = {}
    for key, value in obj.items():
        if key in ("limits", "requests") and TPU_RESOURCE in value:
            value = {k: v for k, v in value.items() if k != TPU_RESOURCE}
            value[GPU_RESOURCE] = 1
        elif key == "tolerations":
            value = [dict(t, key=GPU_RESOURCE)
                     if t.get("key") == TPU_RESOURCE else t for t in value]
        elif key == "nodeSelector":
            value = {k: v for k, v in value.items() if k not in _GKE_LABELS}
            if not value:
                continue
        out[key] = to_port(value)
    return out


def _pods(cr):
    spec = cr["spec"]
    if "replicaSpecs" in spec:
        return [r["template"]["spec"] for r in spec["replicaSpecs"].values()]
    return [spec["template"]["spec"]]


def _main(pod):
    return next(c for c in pod["containers"] if c["name"] == MAIN_CONTAINER)


# -- the polyaxonfiles -------------------------------------------------------

JOB_YAML = """
kind: component
name: trainer
run:
  kind: job
  environment:
    nodeSelector: {pool: batch}
    tolerations:
      - {key: dedicated, operator: Equal, value: train, effect: NoSchedule}
    labels: {team: ml}
  init:
    - git: {url: "https://example.com/org/code.git", revision: main}
    - file: {filename: run.sh, content: "echo hi", chmod: "0755"}
  container:
    image: jax:latest
    command: [python, train.py]
    resources:
      requests: {cpu: "4", memory: 8Gi}
"""

TPUJOB_YAML = """
kind: component
name: dist-trainer
run:
  kind: tpujob
  slice: {type: v5litepod-16, numSlices: 1, chipsPerHost: 4}
  worker:
    replicas: 4
    container:
      image: jax:latest
      command: [python, train.py]
  strategy: {dp: -1, tp: 4}
"""

TPUJOB1_YAML = """
kind: component
name: one-host
run:
  kind: tpujob
  slice: {type: v5litepod-8}
  worker:
    replicas: 1
    environment:
      nodeSelector: {pool: gpu}
    container:
      image: torch:latest
      command: [python, -m, polyaxon_tpu_torch.train]
      resources:
        limits: {memory: 64Gi}
"""

TFJOB_YAML = """
kind: component
name: tf-trainer
run:
  kind: tfjob
  slice: {type: v5litepod-8}
  chief:
    replicas: 1
    container: {image: jax:latest}
  worker:
    replicas: 1
    container: {image: jax:latest}
"""

PYTORCHJOB_YAML = """
kind: component
name: pt-trainer
run:
  kind: pytorchjob
  slice: {type: v4-16, chipsPerHost: 4}
  master:
    replicas: 1
    container: {image: torch:latest, command: [python, train.py]}
  worker:
    replicas: 3
    container: {image: torch:latest, command: [python, train.py]}
"""

MPIJOB_YAML = """
kind: component
name: mpi-trainer
plugins: {shm: true}
termination: {maxRetries: 2, ttl: 60}
run:
  kind: mpijob
  slice: {type: v6e-8}
  launcher:
    replicas: 1
    container: {image: torch:latest}
  worker:
    replicas: 2
    container: {image: torch:latest, command: [python, train.py]}
"""

H100_YAML = """
kind: component
name: h100-trainer
run:
  kind: tpujob
  slice: {type: h100-8, chipsPerHost: 8}
  worker:
    replicas: 2
    container: {image: torch:latest, command: [python, train.py]}
"""

SERVICE_YAML = """
kind: component
name: board
run:
  kind: service
  ports: [6006]
  container:
    image: tb:latest
    command: [tensorboard, --logdir=/ptpu-artifacts]
"""

CONN_YAML = """
kind: component
name: train
run:
  kind: job
  connections: [datasets, bucket]
  init:
    - artifacts: {dirs: [train]}
      connection: datasets
    - dockerfile: {image: "torch:latest", run: ["pip install -e ."]}
  container: {image: torch:latest, command: [python, t.py]}
"""

FILES = {
    "job": JOB_YAML,
    "service": SERVICE_YAML,
    "tpujob-1": TPUJOB1_YAML,
    "tpujob-4": TPUJOB_YAML,
    "tfjob": TFJOB_YAML,
    "pytorchjob": PYTORCHJOB_YAML,
    "mpijob": MPIJOB_YAML,
    "connections": CONN_YAML,
}


def _catalogs():
    def make(Conn, Catalog):
        return Catalog([
            Conn(name="datasets", kind="host_path",
                 schema_={"host_path": "/mnt/data"}),
            Conn(name="bucket", kind="gcs", schema_={"bucket": "b"},
                 secret={"name": "gcp-sa", "mount_path": "/secrets/gcp"}),
        ])
    return make(JConnection, JCatalog), make(PConnection, PCatalog)


def both(tmp_path, text, run_uuid="abc123", project="proj", **config):
    """The same polyaxonfile and config through both converters."""
    f = tmp_path / "spec.yaml"
    f.write_text(text)
    j_cat, p_cat = _catalogs()
    j = J_k8s.convert(
        J_resolve(J_get_op(str(f)), run_uuid=run_uuid, project=project),
        run_uuid, project, J_k8s.ConverterConfig(catalog=j_cat, **config))
    p = P_k8s.convert(
        P_resolve(get_op_from_files(str(f)), run_uuid=run_uuid,
                  project=project),
        run_uuid, project, P_k8s.ConverterConfig(catalog=p_cat, **config))
    return j, p


def compile_yaml(tmp_path, text, run_uuid="abc123", project="proj"):
    f = tmp_path / "spec.yaml"
    f.write_text(text)
    op = get_op_from_files(str(f))
    return P_resolve(op, run_uuid=run_uuid, project=project)


# -- parity with the reference -----------------------------------------------


@pytest.mark.parametrize("name", sorted(FILES))
@pytest.mark.parametrize("config", [
    {},
    {"host": "http://cp:8000", "namespace": "ml", "auth_secret": "tok",
     "artifacts_claim": "pvc-a", "labels": {"env": "prod"}},
], ids=["default", "deployment"])
def test_convert_equals_reference(tmp_path, name, config):
    j, p = both(tmp_path, FILES[name], **config)
    assert to_port(j) == p
    assert P_k8s.headless_service(p) == to_port(J_k8s.headless_service(j))
    assert P_k8s.cluster_ip_service(p) == \
        to_port(J_k8s.cluster_ip_service(j))
    # The slice block is the reference's arithmetic, unchanged.
    assert p["spec"].get("slice") == j["spec"].get("slice")
    assert TPU_RESOURCE not in str(p)


@pytest.mark.parametrize("name", ["tpujob-1", "tpujob-4", "tfjob",
                                  "pytorchjob", "mpijob"])
def test_every_distributed_pod_asks_one_card(tmp_path, name):
    j, p = both(tmp_path, FILES[name])
    for j_pod, p_pod in zip(_pods(j), _pods(p)):
        res = _main(p_pod)["resources"]
        assert res["limits"][GPU_RESOURCE] == 1
        assert res["requests"][GPU_RESOURCE] == 1
        # The reference asks for the whole host's chips.
        chips = j["spec"]["slice"]["chipsPerHost"]
        assert _main(j_pod)["resources"]["limits"][TPU_RESOURCE] == chips
        assert {"key": GPU_RESOURCE, "operator": "Exists",
                "effect": "NoSchedule"} in p_pod["tolerations"]
        # A TPU family selects no GPU product.
        assert PRODUCT_LABEL not in (p_pod.get("nodeSelector") or {})
        assert not set(_GKE_LABELS) & set(p_pod.get("nodeSelector") or {})
        # The PTPU_* block is the reference's.
        p_env = {e["name"]: e.get("value") for e in _main(p_pod)["env"]}
        j_env = {e["name"]: e.get("value") for e in _main(j_pod)["env"]}
        assert {k: v for k, v in p_env.items() if k.startswith("PTPU_")} \
            == {k: v for k, v in j_env.items() if k.startswith("PTPU_")}
    assert TPU_RESOURCE not in str(p)
    # A user's own limits survive beside the card (tpujob-1: memory).
    if name == "tpujob-1":
        assert _main(_pods(p)[0])["resources"]["limits"]["memory"] == "64Gi"
        assert _pods(p)[0]["nodeSelector"] == {"pool": "gpu"}


def test_h100_slice_pins_the_product(tmp_path):
    with pytest.raises(J_k8s.SliceError):
        both(tmp_path, H100_YAML)
    f = tmp_path / "h.yaml"
    f.write_text(H100_YAML)
    p = P_k8s.convert(P_resolve(get_op_from_files(str(f)), run_uuid="h1"),
                      "h1")
    # Equal to the reference's conversion of the same file on a TPU
    # family, apart from the slice type and the product label.
    j, _ = both(tmp_path, H100_YAML.replace("h100-8", "v5litepod-8"),
                run_uuid="h1", project=None)
    pod = _pods(p)[0]
    assert pod["nodeSelector"] == {PRODUCT_LABEL: "NVIDIA-H100-80GB-HBM3"}
    assert _main(pod)["resources"] == {"limits": {GPU_RESOURCE: 1},
                                       "requests": {GPU_RESOURCE: 1}}
    # The slice type reaches the CR's slice block and PTPU_SLICE_TYPE.
    expect = json.loads(json.dumps(to_port(j)).replace('"v5litepod-8"',
                                                       '"h100-8"'))
    for r in expect["spec"]["replicaSpecs"].values():
        r["template"]["spec"]["nodeSelector"] = {
            PRODUCT_LABEL: "NVIDIA-H100-80GB-HBM3"}
    assert p == expect
    assert p["spec"]["slice"] == {"type": "h100-8", "topology": "2x4",
                                  "numSlices": 1, "chipsPerHost": 8}


def test_unknown_family_raises(tmp_path):
    for fam in ("a100-8", "trn1-32"):
        j_err = p_err = None
        try:
            both(tmp_path, H100_YAML.replace("h100-8", fam))
        except J_k8s.SliceError as e:
            j_err = e
        with pytest.raises(SliceError) as p_err:
            f = tmp_path / "x.yaml"
            f.write_text(H100_YAML.replace("h100-8", fam))
            P_k8s.convert(P_resolve(get_op_from_files(str(f)),
                                    run_uuid="x"), "x")
        assert j_err is not None and p_err is not None


def test_vocabulary():
    assert P_k8s.gpu_resources(None) == {"nvidia.com/gpu": 1}
    assert product_for("h100-8") == {
        "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"}
    for fam in ("v6e-8", "v5litepod-16", "v5e-4", "v5p-16", "v4-32",
                "v3-8"):
        assert product_for(fam) == {}
        assert J_k8s.accelerator_for(fam)  # a family the reference knows
    with pytest.raises(SliceError):
        product_for("a100-8")
    # default_topology is the reference's arithmetic.
    for t, chips in [("v5litepod-16", 16), ("v4-8", 8), ("v5p-16", 16),
                     ("v6e-4", 4), ("h100-8", 8), ("v3-32", 32)]:
        assert default_topology(t, chips) == \
            J_k8s.default_topology(t, chips)


@pytest.mark.parametrize("transport", ["kube", "manifest"])
@pytest.mark.parametrize("claim", [None, "pvc-a"])
def test_render_all_equals_reference(transport, claim):
    kw = dict(namespace="ns1", transport=transport, artifacts_claim=claim,
              auth_token="fixed", env={"A": "1"})
    j = J_deploy.render_all(J_deploy.DeploymentConfig(**kw))
    p = render_all(DeploymentConfig(**kw))
    assert p == to_port(j)
    text = str(p)
    assert "polyaxon_tpu.cli" not in text
    assert "polyaxon_tpu_torch.cli" in text
    assert "polyaxon-tpu-torch/core:latest" in text
    # The operator is shared: its image stays the reference's.
    assert "polyaxon-tpu/operator:latest" in text


@pytest.mark.parametrize("collect", [(True, True), (True, False),
                                     (False, True)])
def test_auxiliaries_equal_reference(collect):
    inits = [
        {"git": {"url": "https://example.com/r.git", "revision": "main"}},
        {"file": {"filename": "run.sh", "content": "echo", "chmod": "0755"}},
        {"artifacts": {"dirs": ["a"], "files": ["b/c"]},
         "connection": "datasets"},
        {"dockerfile": {"image": "torch:latest", "env": {"A": "1"}}},
        {"tensorboard": {"uuids": ["r1", "r2"]}},
        {"container": {"name": "mine", "image": "busybox",
                       "command": ["true"]}},
    ]
    j = J_aux.get_init_containers([JInit.from_dict(i) for i in inits])
    p = P_aux.get_init_containers([PInit.from_dict(i) for i in inits])
    assert p == to_port(j)
    assert all(c["image"] == "polyaxon-tpu-torch/aux:latest"
               and c["command"] == ["python", "-m",
                                    "polyaxon_tpu_torch.initializer"]
               for c in p if c["name"].startswith("ptpu-init"))
    kw = dict(collect_logs=collect[0], collect_artifacts=collect[1])
    j = J_aux.get_sidecar_container("r1", **kw)
    p = P_aux.get_sidecar_container("r1", **kw)
    assert p == to_port(j)
    assert p["command"] == ["python", "-m", "polyaxon_tpu_torch.sidecar"]
    extra = [{"name": "x", "emptyDir": {}}]
    for kw in ({}, {"shm": True, "artifacts_claim": "pvc"},
               {"artifacts_host_path": "/data", "extra": extra}):
        assert P_aux.get_volumes(**copy.deepcopy(kw)) == \
            to_port(J_aux.get_volumes(**copy.deepcopy(kw)))


# -- the reference's converter cases, on the port ----------------------------


class TestGPUVocabulary:
    def test_accelerators(self):
        assert product_for("h100-8") == {
            PRODUCT_LABEL: "NVIDIA-H100-80GB-HBM3"}
        assert product_for("v5litepod-16") == {}
        with pytest.raises(SliceError):
            product_for("a100-8")

    def test_default_topology_2d(self):
        assert default_topology("v5litepod-16", 16) == "4x4"
        assert default_topology("v5litepod-8", 8) == "2x4"
        assert default_topology("v6e-4", 4) == "2x2"

    def test_default_topology_3d(self):
        assert default_topology("v4-8", 8) == "2x2x2"
        assert default_topology("v5p-16", 16) == "2x2x4"

    def test_non_pow2_requires_explicit(self):
        with pytest.raises(SliceError):
            default_topology("v5litepod-12", 12)


class TestJobConversion:
    def test_job_manifest(self, tmp_path):
        compiled = compile_yaml(tmp_path, JOB_YAML)
        cr = convert(compiled, "abc123", "proj",
                     ConverterConfig(host="http://cp:8000"))
        assert cr["apiVersion"] == "core.polyaxon-tpu.io/v1"
        assert cr["kind"] == "Operation"
        assert cr["metadata"]["name"] == "ptpu-abc123"
        assert cr["metadata"]["labels"]["polyaxon-tpu/run-uuid"] == "abc123"
        assert cr["metadata"]["labels"]["team"] == "ml"
        spec = cr["spec"]
        assert spec["runKind"] == "job"
        pod = spec["template"]["spec"]
        assert pod["nodeSelector"] == {"pool": "batch"}
        assert pod["tolerations"][0]["key"] == "dedicated"
        inits = pod["initContainers"]
        assert len(inits) == 2
        assert inits[0]["args"][0] == "git"
        assert "--url" in inits[0]["args"]
        assert inits[1]["args"][0] == "file"
        main = _main(pod)
        assert main["resources"]["requests"]["cpu"] == "4"
        env = {e["name"]: e.get("value") for e in main["env"]}
        assert env["POLYAXON_TPU_RUN_UUID"] == "abc123"
        assert env["POLYAXON_TPU_PROJECT"] == "proj"
        assert env["POLYAXON_TPU_HOST"] == "http://cp:8000"
        # no card on a plain job
        assert GPU_RESOURCE not in (main["resources"].get("limits") or {})
        assert any(c["name"] == "ptpu-sidecar" for c in pod["containers"])

    def test_user_env_wins_over_injected(self, tmp_path):
        yaml_text = JOB_YAML.replace(
            "    command: [python, train.py]",
            "    command: [python, train.py]\n"
            "    env:\n"
            "      - {name: POLYAXON_TPU_PROJECT, value: custom}",
        )
        compiled = compile_yaml(tmp_path, yaml_text)
        cr = convert(compiled, "abc123", "proj")
        main = _main(cr["spec"]["template"]["spec"])
        values = [e.get("value") for e in main["env"]
                  if e["name"] == "POLYAXON_TPU_PROJECT"]
        assert values == ["custom"]


class TestDistributedConversion:
    def test_tpujob_manifest(self, tmp_path):
        compiled = compile_yaml(tmp_path, TPUJOB_YAML, run_uuid="run42")
        cr = convert(compiled, "run42", "proj")
        spec = cr["spec"]
        assert spec["slice"] == {"type": "v5litepod-16", "topology": "4x4",
                                 "numSlices": 1, "chipsPerHost": 4}
        assert spec["coordinator"]["port"] == COORDINATOR_PORT
        assert spec["coordinator"]["service"].startswith("run42-worker-0")
        workers = spec["replicaSpecs"]["worker"]
        assert workers["replicas"] == 4
        pod = workers["template"]["spec"]
        main = _main(pod)
        # one process, one card
        assert main["resources"]["limits"][GPU_RESOURCE] == 1
        assert main["resources"]["requests"][GPU_RESOURCE] == 1
        assert TPU_RESOURCE not in str(cr)
        assert "nodeSelector" not in pod
        assert pod["tolerations"][0]["key"] == GPU_RESOURCE
        env = {e["name"]: e.get("value") for e in main["env"]}
        assert env["PTPU_COORDINATOR_ADDRESS"] == \
            f"run42-worker-0.ptpu-run42-hs:{COORDINATOR_PORT}"
        assert pod["subdomain"] == "ptpu-run42-hs"
        assert env["PTPU_NUM_PROCESSES"] == "4"
        assert env["PTPU_REPLICA_ROLE"] == "worker"
        assert "PTPU_PROCESS_ID" not in env  # operator stamps per-pod
        assert spec["strategy"] == {"dp": -1, "tp": 4}
        sidecar = next(c for c in pod["containers"]
                       if c["name"] == "ptpu-sidecar")
        assert {"name": "ptpu-home", "mountPath": "/ptpu-home"} in \
            sidecar["volumeMounts"]
        assert {"name": "ptpu-home", "mountPath": "/ptpu-home"} in \
            main["volumeMounts"]
        assert env["POLYAXON_TPU_HOME"] == "/ptpu-home"
        assert "--local-root" in sidecar["args"]

    def test_tfjob_compat_roles(self, tmp_path):
        compiled = compile_yaml(tmp_path, TFJOB_YAML, run_uuid="tf1")
        cr = convert(compiled, "tf1", "proj")
        specs = cr["spec"]["replicaSpecs"]
        assert set(specs) == {"chief", "worker"}
        chief_env = {e["name"]: e.get("value")
                     for e in specs["chief"]["template"]["spec"]
                     ["containers"][0]["env"]}
        assert chief_env["PTPU_COORDINATOR_ADDRESS"] == \
            f"tf1-chief-0.ptpu-tf1-hs:{COORDINATOR_PORT}"
        assert chief_env["PTPU_NUM_PROCESSES"] == "2"

    def test_rayjob_compat_roles(self, tmp_path):
        text = """
kind: component
name: ray-trainer
run:
  kind: rayjob
  slice: {type: v5litepod-8}
  head:
    replicas: 1
    container: {image: torch:latest}
  worker:
    replicas: 2
    container: {image: torch:latest}
"""
        cr = convert(compile_yaml(tmp_path, text, run_uuid="ray1"),
                     "ray1", "proj")
        specs = cr["spec"]["replicaSpecs"]
        assert set(specs) == {"head", "worker"}
        head_env = {e["name"]: e.get("value")
                    for e in specs["head"]["template"]["spec"]
                    ["containers"][0]["env"]}
        assert head_env["PTPU_COORDINATOR_ADDRESS"] == \
            f"ray1-head-0.ptpu-ray1-hs:{COORDINATOR_PORT}"
        assert head_env["PTPU_NUM_PROCESSES"] == "3"

    def test_mxnetjob_compat_roles(self, tmp_path):
        text = """
kind: component
name: mx-trainer
run:
  kind: mxnetjob
  slice: {type: v5litepod-8}
  scheduler:
    replicas: 1
    container: {image: torch:latest}
  worker:
    replicas: 3
    container: {image: torch:latest}
"""
        cr = convert(compile_yaml(tmp_path, text, run_uuid="mx1"),
                     "mx1", "proj")
        specs = cr["spec"]["replicaSpecs"]
        assert set(specs) == {"scheduler", "worker"}
        sched_env = {e["name"]: e.get("value")
                     for e in specs["scheduler"]["template"]["spec"]
                     ["containers"][0]["env"]}
        assert sched_env["PTPU_COORDINATOR_ADDRESS"] == \
            f"mx1-scheduler-0.ptpu-mx1-hs:{COORDINATOR_PORT}"
        assert sched_env["PTPU_NUM_PROCESSES"] == "4"

    def test_headless_service(self, tmp_path):
        compiled = compile_yaml(tmp_path, TPUJOB_YAML, run_uuid="run42")
        svc = headless_service(convert(compiled, "run42", "proj"))
        assert svc["spec"]["clusterIP"] == "None"
        assert svc["spec"]["selector"] == {"polyaxon-tpu/run-uuid": "run42"}
        assert svc["metadata"]["name"] == "ptpu-run42-hs"

    def test_job_has_no_headless_service(self, tmp_path):
        compiled = compile_yaml(tmp_path, JOB_YAML)
        assert headless_service(convert(compiled, "abc123")) is None


class TestServiceConversion:
    def test_service_ports_and_replicas(self, tmp_path):
        cr = convert(compile_yaml(tmp_path, SERVICE_YAML), "svc1", "proj")
        assert cr["spec"]["runKind"] == "service"
        assert cr["spec"]["ports"] == [6006]
        assert cr["spec"]["replicas"] == 1


class TestTermination:
    def test_termination_mapping(self, tmp_path):
        yaml_text = JOB_YAML.replace(
            "run:\n",
            "termination: {maxRetries: 3, ttl: 600, timeout: 3600}\nrun:\n",
        )
        cr = convert(compile_yaml(tmp_path, yaml_text), "abc123")
        assert cr["spec"]["backoffLimit"] == 3
        assert cr["spec"]["ttlSecondsAfterFinished"] == 600
        assert cr["spec"]["activeDeadlineSeconds"] == 3600


class TestPlugins:
    def test_disable_sidecar(self, tmp_path):
        yaml_text = JOB_YAML.replace(
            "run:\n",
            "plugins: {collectLogs: false, collectArtifacts: false}\nrun:\n",
        )
        pod = convert(compile_yaml(tmp_path, yaml_text),
                      "abc123")["spec"]["template"]["spec"]
        assert not any(c["name"] == "ptpu-sidecar"
                       for c in pod["containers"])

    def test_shm_volume(self, tmp_path):
        yaml_text = JOB_YAML.replace(
            "run:\n", "plugins: {shm: true}\nrun:\n")
        pod = convert(compile_yaml(tmp_path, yaml_text),
                      "abc123")["spec"]["template"]["spec"]
        assert any(v["name"] == "ptpu-shm" for v in pod["volumes"])
        assert any(m["mountPath"] == "/dev/shm"
                   for m in _main(pod)["volumeMounts"])


# -- the reference's initializer and sidecar cases, on the port --------------


class TestInitializer:
    def test_file(self, tmp_path):
        path = init_file(str(tmp_path / "ctx"), "run.sh", "echo hi",
                         chmod="0755")
        assert open(path).read() == "echo hi"
        assert os.stat(path).st_mode & 0o777 == 0o755

    def test_file_via_cli(self, tmp_path):
        init_main(["file", "--dest", str(tmp_path), "--filename", "a.txt",
                   "--content", "x"])
        assert (tmp_path / "a.txt").read_text() == "x"

    def test_artifacts_copies_from_store(self, tmp_path):
        store = tmp_path / "store"
        (store / "run1" / "outputs").mkdir(parents=True)
        (store / "run1" / "outputs" / "model.bin").write_bytes(b"W")
        dest = tmp_path / "ctx"
        copied = init_artifacts(str(dest), files=["run1/outputs/model.bin"],
                                dirs=["run1/outputs"],
                                store_root=str(store))
        assert (dest / "model.bin").read_bytes() == b"W"
        assert (dest / "outputs" / "model.bin").exists()
        assert len(copied) == 2

    def test_dockerfile_render(self, tmp_path):
        path = init_dockerfile(str(tmp_path), {
            "image": "torch:latest",
            "env": {"A": "1"},
            "workdir": "/app",
            "run": ["pip install -e ."],
        })
        text = open(path).read()
        assert text.splitlines()[0] == "FROM torch:latest"
        assert "ENV A=1" in text
        assert "WORKDIR /app" in text
        assert "RUN pip install -e ." in text

    def test_git_requires_url(self, tmp_path):
        with pytest.raises(InitError):
            init_git("", str(tmp_path))

    def test_connection_root_resolution(self, tmp_path, monkeypatch):
        data = tmp_path / "datasets"
        data.mkdir()
        (data / "train.csv").write_text("a,b\n")
        monkeypatch.setenv("POLYAXON_TPU_CONNECTION_MY_DATA_ROOT",
                           str(data))
        dest = tmp_path / "ctx"
        init_artifacts(str(dest), [], [], connection="my-data")
        assert (dest / "train.csv").exists()

    def test_unmaterialized_connection_raises(self, tmp_path):
        with pytest.raises(InitError):
            init_artifacts(str(tmp_path / "ctx"), [], [],
                           connection="missing")

    def test_tensorboard_keeps_runs_separate(self, tmp_path, monkeypatch):
        store = tmp_path / "store"
        for uuid in ("runa", "runb"):
            d = store / uuid / "events"
            d.mkdir(parents=True)
            (d / "metrics.jsonl").write_text(uuid)
        monkeypatch.setenv("POLYAXON_TPU_ARTIFACTS_PATH", str(store))
        dest = tmp_path / "tb"
        init_main(["tensorboard", "--dest", str(dest), "--spec",
                   '{"uuids": ["runa", "runb"]}'])
        assert (dest / "runa" / "events" / "metrics.jsonl").read_text() \
            == "runa"
        assert (dest / "runb" / "events" / "metrics.jsonl").read_text() \
            == "runb"

    def test_git_clones_local_repo(self, tmp_path):
        src = tmp_path / "srcrepo"
        src.mkdir()
        subprocess.run(["git", "init", "-q", str(src)], check=True)
        (src / "f.txt").write_text("hello")
        subprocess.run(["git", "-C", str(src), "add", "."], check=True)
        subprocess.run(
            ["git", "-C", str(src), "-c", "user.email=t@t", "-c",
             "user.name=t", "commit", "-qm", "init"], check=True)
        repo_dir = init_git(str(src), str(tmp_path / "ctx"))
        assert os.path.exists(os.path.join(repo_dir, "f.txt"))


class TestSidecar:
    def test_sync_tree_copies_new_and_changed(self, tmp_path):
        src, dst = tmp_path / "src", tmp_path / "dst"
        (src / "sub").mkdir(parents=True)
        (src / "a.txt").write_text("1")
        (src / "sub" / "b.txt").write_text("2")
        assert _sync_tree(str(src), str(dst)) == 2
        assert (dst / "sub" / "b.txt").read_text() == "2"
        assert _sync_tree(str(src), str(dst)) == 0
        (src / "a.txt").write_text("changed")
        assert _sync_tree(str(src), str(dst)) == 1
        assert (dst / "a.txt").read_text() == "changed"

    def test_sidecar_syncs_run_dirs(self, tmp_path):
        local = tmp_path / "local"
        store = tmp_path / "store"
        (local / "outputs").mkdir(parents=True)
        (local / "logs").mkdir()
        (local / "outputs" / "ckpt").write_text("state")
        (local / "logs" / "stdout.log").write_text("line\n")
        sc = Sidecar("run9", str(local), str(store), sync_interval=1)
        sc.sync_once()
        assert (store / "run9" / "outputs" / "ckpt").read_text() == "state"
        assert (store / "run9" / "logs" / "stdout.log").exists()

    def test_sidecar_respects_collect_flags(self, tmp_path):
        local = tmp_path / "local"
        store = tmp_path / "store"
        (local / "logs").mkdir(parents=True)
        (local / "logs" / "x.log").write_text("x")
        Sidecar("r", str(local), str(store), collect_logs=False).sync_once()
        assert not (store / "r" / "logs").exists()


# -- the reference's deploy cases, on the port -------------------------------


def _deployment(manifests, name):
    return next(m for m in manifests if m["kind"] == "Deployment"
                and m["metadata"]["name"] == name)


class TestDeployManifests:
    def test_render_all_components(self):
        manifests = render_all(DeploymentConfig(namespace="ns1"))
        kinds = [m["kind"] for m in manifests]
        assert kinds.count("Deployment") == 2
        assert "CustomResourceDefinition" in kinds
        assert "ServiceAccount" in kinds and "Role" in kinds
        names = {m["metadata"]["name"] for m in manifests
                 if m["kind"] == "Deployment"}
        assert names == {"polyaxon-tpu-api", "polyaxon-tpu-agent"}
        for m in manifests:
            if m["kind"] not in ("Namespace", "CustomResourceDefinition"):
                assert m["metadata"]["namespace"] == "ns1"

    def test_agent_and_operator_share_cluster_volume(self):
        manifests = render_all(DeploymentConfig(transport="manifest"))
        pod = _deployment(manifests,
                          "polyaxon-tpu-agent")["spec"]["template"]["spec"]
        assert [c["name"] for c in pod["containers"]] == ["agent",
                                                          "operator"]
        for c in pod["containers"]:
            assert {"name": "cluster", "mountPath": "/ptpu-cluster"} in \
                c["volumeMounts"]

    def test_kube_transport_agent_pod(self):
        manifests = render_all(DeploymentConfig(namespace="ns3"))
        pod = _deployment(manifests,
                          "polyaxon-tpu-agent")["spec"]["template"]["spec"]
        by_name = {c["name"]: c for c in pod["containers"]}
        assert set(by_name) == {"agent", "operator", "kubectl-proxy"}
        assert by_name["agent"]["command"][:3] == [
            "python", "-m", "polyaxon_tpu_torch.cli"]
        assert "--backend" in by_name["agent"]["command"]
        assert "kube" in by_name["agent"]["command"]
        assert "--kube-api" in by_name["operator"]["command"]
        assert "http://127.0.0.1:8001" in by_name["operator"]["command"]
        assert pod["serviceAccountName"] == "polyaxon-tpu"
        env = {e["name"]: e.get("value")
               for e in by_name["agent"]["env"]}
        assert env["PTPU_K8S_NAMESPACE"] == "ns3"

    def test_artifacts_claim_sets_store_home(self):
        manifests = render_all(DeploymentConfig(artifacts_claim="pvc-a"))
        api = _deployment(manifests, "polyaxon-tpu-api")
        env = {e["name"]: e.get("value") for e in
               api["spec"]["template"]["spec"]["containers"][0]["env"]}
        assert env["POLYAXON_TPU_HOME"] == "/ptpu-artifacts"

    def test_agent_points_at_api_service(self):
        manifests = render_all(DeploymentConfig(namespace="ns2",
                                                api_port=9001))
        agent = _deployment(manifests, "polyaxon-tpu-agent")
        env = {e["name"]: e.get("value") for e in
               agent["spec"]["template"]["spec"]["containers"][0]["env"]}
        assert env["POLYAXON_TPU_HOST"] == \
            "http://polyaxon-tpu-api.ns2:9001"

    def test_artifacts_claim_mounted(self):
        manifests = render_all(DeploymentConfig(artifacts_claim="pvc-a"))
        pod = _deployment(manifests,
                          "polyaxon-tpu-api")["spec"]["template"]["spec"]
        assert pod["volumes"][0]["persistentVolumeClaim"]["claimName"] == \
            "pvc-a"


def test_control_plane_prometheus_annotations():
    cfg = DeploymentConfig(namespace="ml")
    dep = next(m for m in P_deploy.control_plane(cfg)
               if m["kind"] == "Deployment")
    ann = dep["spec"]["template"]["metadata"]["annotations"]
    assert ann["prometheus.io/scrape"] == "true"
    assert ann["prometheus.io/path"] == "/metrics"
    assert ann["prometheus.io/port"] == str(cfg.api_port)
    assert dep["spec"]["template"]["spec"]["containers"][0]["image"] == \
        "polyaxon-tpu-torch/core:latest"
