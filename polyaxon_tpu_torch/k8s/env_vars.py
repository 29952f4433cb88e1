"""Env-var injection blocks for converted pods.

Two blocks (SURVEY.md 2.9/2.10, call stack 3.2):

- **run identity** — lets in-container ``tracking.init()`` self-identify
  (run UUID, project, API host, auth) without arguments;
- **process topology** — the ``PTPU_*`` block that
  ``parallel.bootstrap.initialize_from_env()`` turns into a
  ``torch.distributed`` process group (coordinator, world size, rank)
  — the north-star replacement for ``TF_CONFIG``/NCCL/MPI bootstrap.

Per-pod fields (``PTPU_PROCESS_ID`` / ``PTPU_REPLICA_INDEX``) are
completed by the operator when it stamps out one pod per replica; the
converter emits everything role-level.

The port's own copy of ``polyaxon_tpu/k8s/env_vars.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ..compiler.topology import ProcessTopology

ENV_RUN_UUID = "POLYAXON_TPU_RUN_UUID"
ENV_RUN_NAME = "POLYAXON_TPU_RUN_NAME"
ENV_PROJECT = "POLYAXON_TPU_PROJECT"
ENV_HOST = "POLYAXON_TPU_HOST"
ENV_AUTH_TOKEN = "POLYAXON_TPU_AUTH_TOKEN"
ENV_NAMESPACE = "POLYAXON_TPU_NAMESPACE"
ENV_ARTIFACTS_PATH = "POLYAXON_TPU_ARTIFACTS_PATH"
ENV_CONTEXT_PATH = "POLYAXON_TPU_CONTEXT_PATH"


def env_list(env: Dict[str, str]) -> List[Dict[str, Any]]:
    return [{"name": k, "value": v} for k, v in env.items()]


def identity_env(
    run_uuid: str,
    project: Optional[str] = None,
    run_name: Optional[str] = None,
    host: Optional[str] = None,
    namespace: Optional[str] = None,
    artifacts_path: Optional[str] = None,
    auth_secret: Optional[str] = None,
) -> List[Dict[str, Any]]:
    env: List[Dict[str, Any]] = [{"name": ENV_RUN_UUID, "value": run_uuid}]
    if run_name:
        env.append({"name": ENV_RUN_NAME, "value": run_name})
    if project:
        env.append({"name": ENV_PROJECT, "value": project})
    if host:
        env.append({"name": ENV_HOST, "value": host})
    if namespace:
        env.append({"name": ENV_NAMESPACE, "value": namespace})
    if artifacts_path:
        env.append({"name": ENV_ARTIFACTS_PATH, "value": artifacts_path})
    if auth_secret:
        env.append({
            "name": ENV_AUTH_TOKEN,
            "valueFrom": {"secretKeyRef": {"name": auth_secret,
                                           "key": "token"}},
        })
    env.append({
        "name": "POLYAXON_TPU_POD_ID",
        "valueFrom": {"fieldRef": {"fieldPath": "metadata.name"}},
    })
    return env


def topology_env(topology: ProcessTopology, role: str,
                 run_uuid: str, port: int = 8476,
                 service_fmt: str = "{run}-{role}-{index}",
                 ) -> List[Dict[str, Any]]:
    """Role-level PTPU_* block (index-free; operator adds per-pod ids)."""
    env = topology.process_env(role, 0, run=run_uuid, port=port,
                               service_fmt=service_fmt)
    env.pop("PTPU_PROCESS_ID")
    env.pop("PTPU_REPLICA_INDEX")
    return env_list(env)
