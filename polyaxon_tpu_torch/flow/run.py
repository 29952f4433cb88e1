"""Runtime kinds: what a run *is* once scheduled.

Parity with the reference's runtime union (SURVEY.md 2.4/2.5; expected at
``polyaxon/_flow/run/`` — unverified):

- ``V1Job``      — batch workload.
- ``V1Service``  — long-running endpoint (notebook/TensorBoard/REST).
- ``V1Dag``      — graph of operations with dependencies.
- ``V1TPUJob``   — **our native distributed kind**: replicated workload on a
  TPU slice topology, the TPU-first replacement for the reference's
  delegated Kubeflow kinds.
- ``V1TFJob`` / ``V1PytorchJob`` / ``V1MPIJob`` — compatibility kinds with
  the reference's replica vocabulary (chief/worker/ps, master/worker,
  launcher/worker), normalized onto TPU replica topology so existing
  polyaxonfiles run unchanged on TPU (BASELINE configs 2/3/5).
- ``V1PaddleJob`` / ``V1XGBoostJob`` / ``V1RayJob`` / ``V1DaskJob`` /
  ``V1MXNetJob`` —
  later-version reference kinds (SURVEY 2.5 long tail), same
  normalization: primary role (master/head/scheduler) is process 0.
- ``V1TunerJob`` / ``V1NotifierJob`` / ``V1CleanerJob`` — auxiliary kinds.

Scheduling-time kinds (``V1Schedule*``) say *when* runs materialize.

The port's own copy of ``polyaxon_tpu/flow/run.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Any, Dict, List, Literal, Optional, Union

from pydantic import Field, field_validator

from .base import BaseSchema
from .environment import V1Environment, V1Init
from .k8s_refs import V1Container


class RunKind:
    JOB = "job"
    SERVICE = "service"
    DAG = "dag"
    TPUJOB = "tpujob"
    TFJOB = "tfjob"
    PYTORCHJOB = "pytorchjob"
    MPIJOB = "mpijob"
    PADDLEJOB = "paddlejob"
    XGBOOSTJOB = "xgboostjob"
    RAYJOB = "rayjob"
    DASKJOB = "daskjob"
    MXNETJOB = "mxnetjob"
    TUNER = "tuner"
    NOTIFIER = "notifier"
    CLEANER = "cleaner"

    DISTRIBUTED = {TPUJOB, TFJOB, PYTORCHJOB, MPIJOB,
                   PADDLEJOB, XGBOOSTJOB, RAYJOB, DASKJOB, MXNETJOB}


class V1Job(BaseSchema):
    kind: Literal["job"] = "job"
    environment: Optional[V1Environment] = None
    connections: Optional[List[str]] = None
    volumes: Optional[List[Dict[str, Any]]] = None
    init: Optional[List[V1Init]] = None
    sidecars: Optional[List[V1Container]] = None
    container: Optional[V1Container] = None


class V1Service(BaseSchema):
    kind: Literal["service"] = "service"
    environment: Optional[V1Environment] = None
    connections: Optional[List[str]] = None
    volumes: Optional[List[Dict[str, Any]]] = None
    init: Optional[List[V1Init]] = None
    sidecars: Optional[List[V1Container]] = None
    container: Optional[V1Container] = None
    ports: Optional[List[int]] = None
    replicas: Optional[int] = None
    is_external: Optional[bool] = None
    rewrite_path: Optional[bool] = None


# ---------------------------------------------------------------------------
# Distributed kinds
# ---------------------------------------------------------------------------

class V1TPUReplica(BaseSchema):
    """One replica role of a TPU job (parity: reference ``V1KFReplica``).

    On TPU a replica is one *host process* of a slice: ``replicas`` hosts,
    each seeing the chips its topology grants.  The runtime derives
    ``jax.distributed`` process ids from the replica index env the agent
    injects (SURVEY.md 3.2/5.8).
    """

    replicas: Optional[int] = None
    environment: Optional[V1Environment] = None
    connections: Optional[List[str]] = None
    volumes: Optional[List[Dict[str, Any]]] = None
    init: Optional[List[V1Init]] = None
    sidecars: Optional[List[V1Container]] = None
    container: Optional[V1Container] = None


class V1SliceSpec(BaseSchema):
    """TPU slice request: accelerator type + topology.

    Examples: ``type="v5litepod-16", topology="4x4"`` (16 chips, 4 hosts).
    ``num_slices > 1`` enables multi-slice jobs: ICI within a slice, DCN
    across slices — the mesh axes the parallel runtime builds on.
    """

    type: str = "v5litepod-8"
    topology: Optional[str] = None
    num_slices: int = 1
    chips_per_host: int = 4
    megascale: Optional[bool] = None

    @property
    def chips_per_slice(self) -> int:
        if self.topology:
            dims = [int(d) for d in self.topology.lower().split("x")]
            n = 1
            for d in dims:
                n *= d
            return n
        # v5litepod-8 -> 8 chips etc.
        tail = self.type.rsplit("-", 1)
        if len(tail) == 2 and tail[1].isdigit():
            return int(tail[1])
        raise ValueError(f"Cannot infer chip count from slice type {self.type!r}")

    @property
    def hosts_per_slice(self) -> int:
        return max(1, self.chips_per_slice // self.chips_per_host)

    @property
    def total_chips(self) -> int:
        return self.chips_per_slice * self.num_slices


class V1TPUJob(BaseSchema):
    """Native TPU distributed kind (replaces delegated TFJob/PytorchJob/MPIJob).

    ``coordinator`` is replica 0 of ``worker`` unless a dedicated
    coordinator replica is given; its stable DNS name seeds
    ``jax.distributed.initialize``.
    """

    kind: Literal["tpujob"] = "tpujob"
    slice: Optional[V1SliceSpec] = Field(default=None)
    clean_pod_policy: Optional[str] = None
    scheduling_policy: Optional[Dict[str, Any]] = None
    coordinator: Optional[V1TPUReplica] = None
    worker: Optional[V1TPUReplica] = None
    strategy: Optional[Dict[str, Any]] = None  # dp/tp/pp/sp/ep axis sizes

    def get_replica_roles(self) -> Dict[str, V1TPUReplica]:
        roles = {}
        if self.coordinator:
            roles["coordinator"] = self.coordinator
        if self.worker:
            roles["worker"] = self.worker
        return roles


class V1KFReplica(BaseSchema):
    """Replica spec compatible with the reference's Kubeflow vocabulary."""

    replicas: Optional[int] = None
    environment: Optional[V1Environment] = None
    connections: Optional[List[str]] = None
    volumes: Optional[List[Dict[str, Any]]] = None
    init: Optional[List[V1Init]] = None
    sidecars: Optional[List[V1Container]] = None
    container: Optional[V1Container] = None


class V1TFJob(BaseSchema):
    """Compatibility kind: reference ``V1TFJob`` (chief/worker/ps/evaluator).

    The compiler maps chief+worker onto TPU worker processes; ps/evaluator
    roles are rejected on TPU (parameter servers have no ICI analogue) with
    a clear error unless replicas == 0.
    """

    kind: Literal["tfjob"] = "tfjob"
    clean_pod_policy: Optional[str] = None
    scheduling_policy: Optional[Dict[str, Any]] = None
    slice: Optional[V1SliceSpec] = None
    chief: Optional[V1KFReplica] = None
    worker: Optional[V1KFReplica] = None
    ps: Optional[V1KFReplica] = None
    evaluator: Optional[V1KFReplica] = None


class V1PytorchJob(BaseSchema):
    """Compatibility kind: reference ``V1PytorchJob`` (master/worker, DDP).

    DDP-over-NCCL becomes DP with XLA AllReduce over ICI."""

    kind: Literal["pytorchjob"] = "pytorchjob"
    clean_pod_policy: Optional[str] = None
    scheduling_policy: Optional[Dict[str, Any]] = None
    slice: Optional[V1SliceSpec] = None
    master: Optional[V1KFReplica] = None
    worker: Optional[V1KFReplica] = None
    n_proc_per_node: Optional[int] = None


class V1MPIJob(BaseSchema):
    """Compatibility kind: reference ``V1MPIJob`` (launcher/worker, Horovod).

    Horovod ring-allreduce becomes XLA AllReduce on the ICI torus (the
    hardware *is* the ring)."""

    kind: Literal["mpijob"] = "mpijob"
    clean_pod_policy: Optional[str] = None
    scheduling_policy: Optional[Dict[str, Any]] = None
    slice: Optional[V1SliceSpec] = None
    slots_per_worker: Optional[int] = None
    launcher: Optional[V1KFReplica] = None
    worker: Optional[V1KFReplica] = None


class V1PaddleJob(BaseSchema):
    """Compatibility kind: reference ``V1PaddleJob`` (master/worker).

    Paddle's fleet collectives become XLA AllReduce over ICI."""

    kind: Literal["paddlejob"] = "paddlejob"
    clean_pod_policy: Optional[str] = None
    scheduling_policy: Optional[Dict[str, Any]] = None
    slice: Optional[V1SliceSpec] = None
    master: Optional[V1KFReplica] = None
    worker: Optional[V1KFReplica] = None


class V1XGBoostJob(BaseSchema):
    """Compatibility kind: reference ``V1XGBoostJob`` (master/worker).

    Rabit allreduce becomes XLA AllReduce; trees build data-parallel."""

    kind: Literal["xgboostjob"] = "xgboostjob"
    clean_pod_policy: Optional[str] = None
    scheduling_policy: Optional[Dict[str, Any]] = None
    slice: Optional[V1SliceSpec] = None
    master: Optional[V1KFReplica] = None
    worker: Optional[V1KFReplica] = None


class V1RayJob(BaseSchema):
    """Compatibility kind: reference ``V1RayJob`` (head + worker groups,
    entrypoint/rayVersion/runtimeEnv metadata).

    The head role maps to process 0 (the jax.distributed coordinator);
    named worker groups each become a replica group; Ray's object-store
    data paths have no TPU analogue — replicas run the SPMD program.
    ``entrypoint``/``ray_version``/``runtime_env`` are accepted for
    polyaxonfile compatibility (the container command is the program)."""

    kind: Literal["rayjob"] = "rayjob"
    clean_pod_policy: Optional[str] = None
    scheduling_policy: Optional[Dict[str, Any]] = None
    slice: Optional[V1SliceSpec] = None
    entrypoint: Optional[str] = None
    ray_version: Optional[str] = None
    runtime_env: Optional[Dict[str, Any]] = None
    metadata: Optional[Dict[str, Any]] = None
    head: Optional[V1KFReplica] = None
    worker: Optional[V1KFReplica] = None
    workers: Optional[Dict[str, V1KFReplica]] = None  # named groups


class V1DaskJob(BaseSchema):
    """Compatibility kind: reference ``V1DaskJob`` (job/scheduler/worker).

    The scheduler role maps to process 0; job + workers join the one
    SPMD gang."""

    kind: Literal["daskjob"] = "daskjob"
    clean_pod_policy: Optional[str] = None
    scheduling_policy: Optional[Dict[str, Any]] = None
    slice: Optional[V1SliceSpec] = None
    job: Optional[V1KFReplica] = None
    scheduler: Optional[V1KFReplica] = None
    worker: Optional[V1KFReplica] = None


class V1MXNetJob(BaseSchema):
    """Compatibility kind: reference ``V1MXJob`` (scheduler/server/worker,
    SURVEY 2.5 long tail).

    MXNet's KVStore topology collapses like tfjob's: ``server``
    (parameter-server) replicas have no TPU analogue — gradients ride
    XLA AllReduce on ICI — so the normalizer rejects them; the
    ``scheduler`` maps to process 0 and workers join the SPMD gang.
    ``tuner``/``tuner_tracker``/``tuner_server`` are accepted for
    polyaxonfile compatibility (auto-tuning is the tuner subsystem's
    job here) but take no processes."""

    kind: Literal["mxnetjob"] = "mxnetjob"
    clean_pod_policy: Optional[str] = None
    scheduling_policy: Optional[Dict[str, Any]] = None
    slice: Optional[V1SliceSpec] = None
    scheduler: Optional[V1KFReplica] = None
    server: Optional[V1KFReplica] = None
    worker: Optional[V1KFReplica] = None
    tuner: Optional[V1KFReplica] = None
    tuner_tracker: Optional[V1KFReplica] = None
    tuner_server: Optional[V1KFReplica] = None


# ---------------------------------------------------------------------------
# DAG
# ---------------------------------------------------------------------------

class V1Dag(BaseSchema):
    """A graph of operations; edges from explicit dependencies + param refs."""

    kind: Literal["dag"] = "dag"
    operations: Optional[List[Any]] = None  # List[V1Operation]; late-bound
    components: Optional[List[Any]] = None  # List[V1Component]; late-bound
    concurrency: Optional[int] = None
    early_stopping: Optional[List[Any]] = None
    environment: Optional[V1Environment] = None
    connections: Optional[List[str]] = None
    volumes: Optional[List[Dict[str, Any]]] = None


# ---------------------------------------------------------------------------
# Auxiliary kinds
# ---------------------------------------------------------------------------

class V1TunerJob(BaseSchema):
    kind: Literal["tuner"] = "tuner"
    container: Optional[V1Container] = None
    environment: Optional[V1Environment] = None
    connections: Optional[List[str]] = None
    init: Optional[List[V1Init]] = None


class V1NotifierJob(BaseSchema):
    kind: Literal["notifier"] = "notifier"
    container: Optional[V1Container] = None
    environment: Optional[V1Environment] = None
    connections: Optional[List[str]] = None


class V1CleanerJob(BaseSchema):
    kind: Literal["cleaner"] = "cleaner"
    container: Optional[V1Container] = None
    environment: Optional[V1Environment] = None
    connections: Optional[List[str]] = None


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

class V1CronSchedule(BaseSchema):
    kind: Literal["cron"] = "cron"
    cron: str
    start_at: Optional[str] = None
    end_at: Optional[str] = None
    max_runs: Optional[int] = None
    depends_on_past: Optional[bool] = None


class V1IntervalSchedule(BaseSchema):
    kind: Literal["interval"] = "interval"
    frequency: Union[int, float]
    start_at: Optional[str] = None
    end_at: Optional[str] = None
    max_runs: Optional[int] = None
    depends_on_past: Optional[bool] = None


class V1DateTimeSchedule(BaseSchema):
    kind: Literal["datetime"] = "datetime"
    start_at: str


V1Schedule = Union[V1CronSchedule, V1IntervalSchedule, V1DateTimeSchedule]

V1Runtime = Union[
    V1Job,
    V1Service,
    V1Dag,
    V1TPUJob,
    V1TFJob,
    V1PytorchJob,
    V1MPIJob,
    V1PaddleJob,
    V1XGBoostJob,
    V1RayJob,
    V1DaskJob,
    V1MXNetJob,
    V1TunerJob,
    V1NotifierJob,
    V1CleanerJob,
]

RUNTIME_BY_KIND = {
    RunKind.JOB: V1Job,
    RunKind.SERVICE: V1Service,
    RunKind.DAG: V1Dag,
    RunKind.TPUJOB: V1TPUJob,
    RunKind.TFJOB: V1TFJob,
    RunKind.PYTORCHJOB: V1PytorchJob,
    RunKind.MPIJOB: V1MPIJob,
    RunKind.PADDLEJOB: V1PaddleJob,
    RunKind.XGBOOSTJOB: V1XGBoostJob,
    RunKind.RAYJOB: V1RayJob,
    RunKind.DASKJOB: V1DaskJob,
    RunKind.MXNETJOB: V1MXNetJob,
    RunKind.TUNER: V1TunerJob,
    RunKind.NOTIFIER: V1NotifierJob,
    RunKind.CLEANER: V1CleanerJob,
}

SCHEDULE_BY_KIND = {
    "cron": V1CronSchedule,
    "interval": V1IntervalSchedule,
    "datetime": V1DateTimeSchedule,
}


def parse_runtime(data: Union[Dict[str, Any], V1Runtime, None]):
    if data is None or not isinstance(data, dict):
        return data
    kind = data.get("kind")
    cls = RUNTIME_BY_KIND.get(kind)
    if cls is None:
        raise ValueError(
            f"Unknown run kind {kind!r}; expected one of {sorted(RUNTIME_BY_KIND)}"
        )
    return cls.from_dict(data)


def parse_schedule(data: Union[Dict[str, Any], None]):
    if data is None or not isinstance(data, dict):
        return data
    kind = data.get("kind")
    cls = SCHEDULE_BY_KIND.get(kind)
    if cls is None:
        raise ValueError(
            f"Unknown schedule kind {kind!r}; expected one of {sorted(SCHEDULE_BY_KIND)}"
        )
    return cls.from_dict(data)
