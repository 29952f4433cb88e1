"""CompiledOperation -> Kubernetes resources.

The reference's converter layer (SURVEY.md 2.10, L2): turns a compiled
operation into the ``Operation`` custom resource our operator reconciles.
Differences from the reference are exactly the north-star's asks:

- resources: one ``nvidia.com/gpu`` a pod (one process drives one card);
- scheduling: the NVIDIA product label for a GPU slice family
  (``k8s/gpu.py``), no product for the reference's TPU families;
- env: run identity for ``tracking.init()`` plus the ``PTPU_*`` process
  topology block that ``parallel/bootstrap.py`` turns into a
  ``torch.distributed`` process group — replacing
  ``TF_CONFIG``/NCCL/MPI bootstrap;
- distributed kinds (tpujob + tfjob/pytorchjob/mpijob compatibility) are
  normalized to one replica topology (``compiler.topology``) instead of
  being delegated to Kubeflow CRs.

Tests assert emitted manifests against golden fixtures — the reference's
"distributed testing without a cluster" trick (SURVEY.md section 4).

The port's own copy of ``polyaxon_tpu/k8s/converter.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..compiler.topology import normalize
from ..flow import V1CompiledOperation
from ..flow.run import (
    RunKind,
    V1Service,
    V1SliceSpec,
)
from . import gpu
from .auxiliaries import (
    ARTIFACTS_MOUNT,
    ARTIFACTS_VOLUME,
    CONTEXT_MOUNT,
    CONTEXT_VOLUME,
    DEFAULT_AUX_IMAGE,
    RUN_HOME_MOUNT,
    RUN_HOME_VOLUME,
    SHM_VOLUME,
    get_init_containers,
    get_sidecar_container,
    get_volumes,
)
from .env_vars import identity_env, topology_env

API_VERSION = "core.polyaxon-tpu.io/v1"
OPERATION_KIND = "Operation"
MAIN_CONTAINER = "ptpu-main"
COORDINATOR_PORT = 8476


class ConverterError(ValueError):
    pass


@dataclass
class ConverterConfig:
    """Deployment-level knobs the agent passes to every conversion."""

    namespace: str = "polyaxon-tpu"
    host: Optional[str] = None
    auth_secret: Optional[str] = None
    aux_image: str = DEFAULT_AUX_IMAGE
    default_image: str = "python:3.11-slim"
    artifacts_claim: Optional[str] = None
    artifacts_host_path: Optional[str] = None
    artifacts_root: str = ARTIFACTS_MOUNT
    labels: Dict[str, str] = field(default_factory=dict)
    catalog: Optional[Any] = None  # connections.ConnectionCatalog

    def get_catalog(self):
        if self.catalog is None:
            from ..connections import ConnectionCatalog

            self.catalog = ConnectionCatalog.load()
        return self.catalog


def _labels(config: ConverterConfig, run_uuid: str,
            project: Optional[str]) -> Dict[str, str]:
    labels = {
        "app.kubernetes.io/managed-by": "polyaxon-tpu",
        "polyaxon-tpu/run-uuid": run_uuid,
    }
    if project:
        labels["polyaxon-tpu/project"] = project
    labels.update(config.labels)
    return labels


def _main_container(
    section: Any,
    config: ConverterConfig,
    env: List[Dict[str, Any]],
    *,
    tpu_slice: Optional[V1SliceSpec] = None,
    extra_mounts: Optional[List[Dict[str, Any]]] = None,
    shm: bool = False,
) -> Dict[str, Any]:
    container = getattr(section, "container", None)
    c: Dict[str, Any] = container.to_dict() if container is not None else {}
    c["name"] = MAIN_CONTAINER
    c.setdefault("image", config.default_image)

    c_env = list(c.get("env") or [])
    seen = {e.get("name") for e in c_env}
    c_env.extend(e for e in env if e.get("name") not in seen)
    if "POLYAXON_TPU_HOME" not in seen:
        # Local store on the shared run-home volume — what tracking
        # writes and the sidecar tails.
        c_env.append({"name": "POLYAXON_TPU_HOME",
                      "value": RUN_HOME_MOUNT})
    c["env"] = c_env

    resources = c.get("resources") or {}
    if tpu_slice is not None:
        cards = gpu.gpu_resources(tpu_slice)
        limits = dict(resources.get("limits") or {})
        requests = dict(resources.get("requests") or {})
        limits.update(cards)
        requests.update(cards)
        resources = {**resources, "limits": limits, "requests": requests}
    if resources:
        c["resources"] = resources

    mounts = list(c.get("volumeMounts") or [])
    mounts.append({"name": CONTEXT_VOLUME, "mountPath": CONTEXT_MOUNT})
    mounts.append({"name": RUN_HOME_VOLUME, "mountPath": RUN_HOME_MOUNT})
    mounts.append({"name": ARTIFACTS_VOLUME, "mountPath": ARTIFACTS_MOUNT})
    if shm:
        mounts.append({"name": SHM_VOLUME, "mountPath": "/dev/shm"})
    mounts.extend(extra_mounts or [])
    c["volumeMounts"] = mounts
    return c


def _pod_spec(
    section: Any,
    compiled: V1CompiledOperation,
    config: ConverterConfig,
    env: List[Dict[str, Any]],
    run_uuid: str,
    *,
    tpu_slice: Optional[V1SliceSpec] = None,
) -> Dict[str, Any]:
    """Assemble one pod template spec for a job/service/replica section."""
    environment = getattr(section, "environment", None)
    plugins = compiled.plugins
    shm = bool(plugins and plugins.shm)
    collect_logs = not (plugins and plugins.collect_logs is False)
    collect_artifacts = not (plugins and plugins.collect_artifacts is False)

    # Requested connections: volumes + mounts + root-advertising env
    # (the initializer and user code resolve roots from these).
    conn_volumes: List[Dict[str, Any]] = []
    conn_mounts: List[Dict[str, Any]] = []
    conn_env: List[Dict[str, Any]] = []
    requested = getattr(section, "connections", None) or []
    if requested:
        catalog = config.get_catalog()
        for conn_name in requested:
            volume = catalog.volume_for(conn_name)
            if volume:
                conn_volumes.append(volume)
            mount = catalog.mount_for(conn_name)
            if mount:
                conn_mounts.append(mount)
            conn_env.extend(catalog.env_for(conn_name))
            res_volumes, res_mounts = catalog.resource_volumes_for(conn_name)
            conn_volumes.extend(res_volumes)
            conn_mounts.extend(res_mounts)
        # Volumes dedupe by name inside get_volumes (the merge point);
        # mounts dedupe here since duplicate (volume, path) pairs within
        # one container are redundant (e.g. two connections sharing a
        # secret at the same mount_path).
        seen: set = set()
        conn_mounts = [m for m in conn_mounts
                       if not ((m["name"], m.get("mountPath")) in seen
                               or seen.add((m["name"], m.get("mountPath"))))]

    pod: Dict[str, Any] = {
        "restartPolicy": "Never",
        "containers": [
            _main_container(section, config, env + conn_env,
                            tpu_slice=tpu_slice, shm=shm,
                            extra_mounts=conn_mounts),
        ],
        "volumes": get_volumes(
            shm=shm,
            artifacts_claim=config.artifacts_claim,
            artifacts_host_path=config.artifacts_host_path,
            extra=(getattr(section, "volumes", None) or []) + conn_volumes,
        ),
    }

    inits = get_init_containers(getattr(section, "init", None),
                                aux_image=config.aux_image)
    if inits:
        # Init containers resolve connections too (init.connection):
        # give them the same roots/env and mounts as the main container.
        for ic in inits:
            ic_env = list(ic.get("env") or [])
            present = {e.get("name") for e in ic_env}
            ic_env.extend(e for e in conn_env
                          if e.get("name") not in present)
            ic["env"] = ic_env
            ic.setdefault("volumeMounts", []).extend(conn_mounts)
        pod["initContainers"] = inits

    sidecars = [s.to_dict() for s in (getattr(section, "sidecars", None)
                                      or [])]
    if collect_logs or collect_artifacts:
        sidecars.append(get_sidecar_container(
            run_uuid, aux_image=config.aux_image,
            collect_logs=collect_logs,
            collect_artifacts=collect_artifacts))
    pod["containers"].extend(sidecars)

    node_selector: Dict[str, str] = {}
    tolerations: List[Dict[str, Any]] = []
    if tpu_slice is not None:
        node_selector.update(gpu.slice_node_selector(tpu_slice))
        tolerations.append(gpu.gpu_toleration())

    if environment is not None:
        if environment.node_selector:
            node_selector.update(environment.node_selector)
        if environment.tolerations:
            tolerations.extend(environment.tolerations)
        for src, dst in [
            ("affinity", "affinity"),
            ("node_name", "nodeName"),
            ("service_account_name", "serviceAccountName"),
            ("host_aliases", "hostAliases"),
            ("security_context", "securityContext"),
            ("host_network", "hostNetwork"),
            ("host_pid", "hostPID"),
            ("dns_policy", "dnsPolicy"),
            ("dns_config", "dnsConfig"),
            ("scheduler_name", "schedulerName"),
            ("priority_class_name", "priorityClassName"),
            ("priority", "priority"),
            ("restart_policy", "restartPolicy"),
        ]:
            value = getattr(environment, src, None)
            if value is not None:
                pod[dst] = value
        if environment.image_pull_secrets:
            pod["imagePullSecrets"] = [
                {"name": s} for s in environment.image_pull_secrets]
    if node_selector:
        pod["nodeSelector"] = node_selector
    if tolerations:
        pod["tolerations"] = tolerations
    return pod


def _metadata(compiled: V1CompiledOperation, config: ConverterConfig,
              run_uuid: str, project: Optional[str]) -> Dict[str, Any]:
    environment = getattr(compiled.run, "environment", None)
    annotations = dict(getattr(environment, "annotations", None) or {})
    labels = _labels(config, run_uuid, project)
    if environment is not None and environment.labels:
        labels.update(environment.labels)
    meta = {
        "name": f"ptpu-{run_uuid}",
        "namespace": config.namespace,
        "labels": labels,
    }
    if annotations:
        meta["annotations"] = annotations
    return meta


def _termination(compiled: V1CompiledOperation) -> Dict[str, Any]:
    t = compiled.termination
    if t is None:
        return {}
    out = {}
    if t.max_retries is not None:
        out["backoffLimit"] = t.max_retries
    if t.timeout is not None:
        out["activeDeadlineSeconds"] = t.timeout
    if t.ttl is not None:
        out["ttlSecondsAfterFinished"] = t.ttl
    return out


def convert(
    compiled: V1CompiledOperation,
    run_uuid: str,
    project: Optional[str] = None,
    config: Optional[ConverterConfig] = None,
) -> Dict[str, Any]:
    """Compiled operation -> ``Operation`` custom resource dict."""
    config = config or ConverterConfig()
    run = compiled.run
    kind = compiled.run_kind
    artifacts_path = f"{config.artifacts_root}/{run_uuid}"

    base_env = identity_env(
        run_uuid=run_uuid,
        project=project,
        run_name=compiled.name,
        host=config.host,
        namespace=config.namespace,
        artifacts_path=artifacts_path,
        auth_secret=config.auth_secret,
    )

    spec: Dict[str, Any] = {"runKind": kind}
    spec.update(_termination(compiled))

    if kind == RunKind.JOB or kind in (RunKind.TUNER, RunKind.NOTIFIER,
                                       RunKind.CLEANER):
        spec["template"] = {"spec": _pod_spec(run, compiled, config,
                                              base_env, run_uuid)}
    elif kind == RunKind.SERVICE:
        assert isinstance(run, V1Service)
        spec["template"] = {"spec": _pod_spec(run, compiled, config,
                                              base_env, run_uuid)}
        spec["replicas"] = run.replicas or 1
        if run.ports:
            spec["ports"] = list(run.ports)
    elif kind in RunKind.DISTRIBUTED:
        topology = normalize(run)
        # Pod hostname "{run}-{role}-{i}" + headless-Service subdomain
        # "ptpu-{run}-hs" (set per-pod by the operator) makes the
        # coordinator address resolvable cluster DNS.
        subdomain = f"ptpu-{run_uuid}-hs"
        service_fmt = "{run}-{role}-{index}." + subdomain
        spec["slice"] = {
            "type": topology.slice.type,
            "topology": (topology.slice.topology
                         or gpu.default_topology(
                             topology.slice.type,
                             topology.slice.chips_per_slice)),
            "numSlices": topology.slice.num_slices,
            "chipsPerHost": topology.slice.chips_per_host,
        }
        spec["coordinator"] = {
            "service": topology.coordinator_address(
                service_fmt=service_fmt, run=run_uuid,
                port=COORDINATOR_PORT),
            "port": COORDINATOR_PORT,
        }
        replica_specs: Dict[str, Any] = {}
        for group in topology.groups:
            env = base_env + topology_env(topology, group.role, run_uuid,
                                          port=COORDINATOR_PORT,
                                          service_fmt=service_fmt)
            pod = _pod_spec(group.spec, compiled, config, env, run_uuid,
                            tpu_slice=topology.slice)
            pod["subdomain"] = subdomain
            replica_specs[group.role] = {
                "replicas": group.replicas,
                "template": {"spec": pod},
            }
        spec["replicaSpecs"] = replica_specs
        clean = getattr(run, "clean_pod_policy", None)
        if clean:
            spec["cleanPodPolicy"] = clean
        strategy = getattr(run, "strategy", None)
        if strategy:
            spec["strategy"] = strategy
    else:
        raise ConverterError(
            f"Run kind {kind!r} is not convertible to a k8s resource "
            "(dag/schedule kinds expand in the scheduler)")

    return {
        "apiVersion": API_VERSION,
        "kind": OPERATION_KIND,
        "metadata": _metadata(compiled, config, run_uuid, project),
        "spec": spec,
    }


def cluster_ip_service(cr: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Companion Service for service kinds (notebooks/TensorBoard): the
    operator publishes ``status.endpoints`` as ``<name>.<namespace>``,
    which only resolves if something creates this Service."""
    spec = cr.get("spec", {})
    ports = spec.get("ports")
    if not ports or "replicaSpecs" in spec:
        return None
    meta = cr["metadata"]
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": meta["name"],
            "namespace": meta.get("namespace"),
            "labels": dict(meta.get("labels", {})),
        },
        "spec": {
            "selector": {"polyaxon-tpu/run-uuid":
                         meta["labels"]["polyaxon-tpu/run-uuid"]},
            "ports": [{"port": int(p)} for p in ports],
        },
    }


def headless_service(cr: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Companion headless Service giving replica pods stable DNS —
    the operator applies it alongside distributed Operations."""
    spec = cr.get("spec", {})
    if "replicaSpecs" not in spec:
        return None
    meta = cr["metadata"]
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": f"{meta['name']}-hs",
            "namespace": meta.get("namespace"),
            "labels": dict(meta.get("labels", {})),
        },
        "spec": {
            "clusterIP": "None",
            "selector": {"polyaxon-tpu/run-uuid":
                         meta["labels"]["polyaxon-tpu/run-uuid"]},
            "ports": [{"name": "coordinator",
                       "port": spec["coordinator"]["port"]}],
        },
    }
