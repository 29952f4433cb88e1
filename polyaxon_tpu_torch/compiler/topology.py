"""Normalize distributed run kinds onto TPU process topology.

The reference delegates distributed topology to Kubeflow CRs per kind
(TFJob chief/worker/ps, PytorchJob master/worker, MPIJob launcher/worker —
SURVEY.md 2.5).  On TPU every kind collapses to the same shape: N host
processes over one or more slices, process 0 doubling as the
``jax.distributed`` coordinator.  This module computes that normal form;
the k8s converter, the agent's env injection, and the runtime bootstrap
all consume it.

The port's own copy of ``polyaxon_tpu/compiler/topology.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..flow.run import (
    RunKind,
    V1MPIJob,
    V1SliceSpec,
    V1TFJob,
    V1TPUJob,
)


class TopologyError(ValueError):
    pass


# Compat kinds that collapse to "primary role (process 0, the
# jax.distributed coordinator) + secondary roles in one SPMD gang"
# (SURVEY 2.5): kind -> (primary role, secondary roles in order).
_COMPAT_ROLES = {
    RunKind.PYTORCHJOB: ("master", ("worker",)),
    RunKind.PADDLEJOB: ("master", ("worker",)),
    RunKind.XGBOOSTJOB: ("master", ("worker",)),
    RunKind.RAYJOB: ("head", ("worker",)),
    RunKind.DASKJOB: ("scheduler", ("job", "worker")),
    RunKind.MXNETJOB: ("scheduler", ("worker",)),
}

# Roles with no TPU analogue, per kind: parameter-server topologies
# dissolve into XLA collectives.
_COMPAT_REJECT = {
    RunKind.TFJOB: ("ps", "evaluator"),
    RunKind.MXNETJOB: ("server",),
}


def _reject_roles(run: Any, kind: str) -> None:
    for bad in _COMPAT_REJECT.get(kind, ()):
        rep = getattr(run, bad, None)
        if rep is not None and _nonzero(rep) > 0:
            raise TopologyError(
                f"{kind} role {bad!r} has no TPU analogue (parameter "
                "servers are not used with XLA collectives); set its "
                "replicas to 0 or use collective training")


@dataclass
class ReplicaGroup:
    """One role of the job (e.g. worker) with its process count."""

    role: str
    replicas: int
    spec: Any  # V1TPUReplica | V1KFReplica


@dataclass
class ProcessTopology:
    """The normal form every distributed kind maps to."""

    kind: str
    slice: V1SliceSpec
    groups: List[ReplicaGroup] = field(default_factory=list)

    @property
    def num_processes(self) -> int:
        return sum(g.replicas for g in self.groups)

    @property
    def coordinator_role(self) -> str:
        return self.groups[0].role if self.groups else "worker"

    def coordinator_address(self, service_fmt: str = "{run}-{role}-{index}",
                            run: str = "run", port: int = 8476) -> str:
        """Stable DNS of process 0 — seeds jax.distributed.initialize."""
        role = self.coordinator_role
        return f"{service_fmt.format(run=run, role=role, index=0)}:{port}"

    def process_env(self, role: str, index: int, run: str = "run",
                    port: int = 8476,
                    service_fmt: str = "{run}-{role}-{index}",
                    ) -> Dict[str, str]:
        """Env block injected per pod so in-container bootstrap can derive
        (coordinator, num_processes, process_id) — SURVEY.md 3.2/5.8.

        ``service_fmt`` must yield a resolvable DNS name; in-cluster the
        converter passes a pod-hostname.headless-subdomain format."""
        offset = 0
        for g in self.groups:
            if g.role == role:
                if not 0 <= index < g.replicas:
                    raise TopologyError(
                        f"Replica index {index} out of range for role "
                        f"{role!r} with {g.replicas} replicas"
                    )
                break
            offset += g.replicas
        else:
            raise TopologyError(f"Unknown role {role!r}")
        return {
            "PTPU_COORDINATOR_ADDRESS": self.coordinator_address(
                service_fmt=service_fmt, run=run, port=port),
            "PTPU_NUM_PROCESSES": str(self.num_processes),
            "PTPU_PROCESS_ID": str(offset + index),
            "PTPU_REPLICA_ROLE": role,
            "PTPU_REPLICA_INDEX": str(index),
            "PTPU_SLICE_TYPE": self.slice.type,
            "PTPU_SLICE_TOPOLOGY": self.slice.topology or "",
            "PTPU_NUM_SLICES": str(self.slice.num_slices),
            "PTPU_CHIPS_PER_HOST": str(self.slice.chips_per_host),
        }


def _nonzero(replica) -> int:
    if replica is None:
        return 0
    return replica.replicas if replica.replicas is not None else 1


def normalize(run: Any) -> ProcessTopology:
    """Map any distributed run kind to ProcessTopology."""
    kind = getattr(run, "kind", None)
    slice_spec = getattr(run, "slice", None) or V1SliceSpec()

    if isinstance(run, V1TPUJob) or kind == RunKind.TPUJOB:
        groups = []
        if run.coordinator and _nonzero(run.coordinator):
            groups.append(ReplicaGroup("coordinator", _nonzero(run.coordinator),
                                       run.coordinator))
        if run.worker and _nonzero(run.worker):
            groups.append(ReplicaGroup("worker", _nonzero(run.worker), run.worker))
        if not groups:
            raise TopologyError("tpujob needs at least one replica group")
        return ProcessTopology(kind=RunKind.TPUJOB, slice=slice_spec, groups=groups)

    if isinstance(run, V1TFJob) or kind == RunKind.TFJOB:
        _reject_roles(run, RunKind.TFJOB)
        groups = []
        if run.chief and _nonzero(run.chief):
            groups.append(ReplicaGroup("chief", _nonzero(run.chief), run.chief))
        if run.worker and _nonzero(run.worker):
            groups.append(ReplicaGroup("worker", _nonzero(run.worker), run.worker))
        if not groups:
            raise TopologyError("tfjob needs chief and/or worker replicas")
        return ProcessTopology(kind=RunKind.TFJOB, slice=slice_spec, groups=groups)

    if isinstance(run, V1MPIJob) or kind == RunKind.MPIJOB:
        # The MPI launcher does not participate in collectives; on TPU the
        # coordinator is worker 0, so the launcher role dissolves.
        groups = []
        if run.worker and _nonzero(run.worker):
            groups.append(ReplicaGroup("worker", _nonzero(run.worker), run.worker))
        if not groups:
            raise TopologyError("mpijob needs worker replicas")
        return ProcessTopology(kind=RunKind.MPIJOB, slice=slice_spec, groups=groups)

    if kind in _COMPAT_ROLES:
        _reject_roles(run, kind)
        primary_role, secondary_roles = _COMPAT_ROLES[kind]
        groups = []
        for role in (primary_role,) + tuple(secondary_roles):
            rep = getattr(run, role, None)
            if rep is not None and _nonzero(rep):
                groups.append(ReplicaGroup(role, _nonzero(rep), rep))
        # rayjob: named worker groups (the reference's `workers` dict);
        # insertion order defines their process-id offsets.  Group names
        # become pod hostnames / DNS labels and must be unique roles —
        # a duplicate would collapse two groups into one replicaSpec
        # while the process count still counts both (a gang that never
        # fully assembles).
        seen_roles = {g.role for g in groups}
        for group_name, rep in (getattr(run, "workers", None) or {}).items():
            if rep is None or not _nonzero(rep):
                continue
            # The name is a FRAGMENT of the pod hostname
            # ("<run-uuid>-<role>-<index>", assembled by the converter):
            # budget 63-char DNS label minus 12-char uuid, two dashes,
            # and up to 4 index digits -> 45 chars for the role.
            if not re.fullmatch(r"[a-z0-9]([-a-z0-9]{0,43}[a-z0-9])?",
                                group_name):
                raise TopologyError(
                    f"worker group name {group_name!r} is not a valid "
                    "pod-hostname fragment (lowercase alphanumerics and "
                    "'-', max 45 chars: the 63-char DNS label budget "
                    "minus the run-uuid prefix and replica index)")
            if group_name in seen_roles:
                raise TopologyError(
                    f"worker group name {group_name!r} collides with "
                    "another replica role")
            seen_roles.add(group_name)
            groups.append(ReplicaGroup(group_name, _nonzero(rep), rep))
        if not groups:
            raise TopologyError(
                f"{kind} needs {primary_role} and/or worker replicas")
        return ProcessTopology(kind=kind, slice=slice_spec, groups=groups)

    raise TopologyError(f"Run kind {kind!r} is not a distributed kind")
