"""Auxiliary containers: init containers and the artifacts/logs sidecar.

Parity: reference ``get_init_container()`` / ``get_sidecar_container()``
(SURVEY.md 2.10 — expected at ``polyaxon/_k8s/converter/`` auxiliaries,
unverified).  Init actions are executed by ``polyaxon_tpu_torch.initializer``
(in-repo, so the same image as the main container works as the aux
image); the sidecar is ``polyaxon_tpu_torch.sidecar``.

The port's own copy of ``polyaxon_tpu/k8s/auxiliaries.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from ..flow.environment import V1Init
from ..flow.k8s_refs import V1Container

CONTEXT_VOLUME = "ptpu-context"
CONTEXT_MOUNT = "/ptpu-context"
ARTIFACTS_VOLUME = "ptpu-artifacts"
ARTIFACTS_MOUNT = "/ptpu-artifacts"
# Shared emptyDir holding the run's LOCAL store (tracking events, logs,
# outputs): the main container writes here (POLYAXON_TPU_HOME) and the
# sidecar tails it — without a shared volume the sidecar would see
# nothing to upload.
RUN_HOME_VOLUME = "ptpu-home"
RUN_HOME_MOUNT = "/ptpu-home"
SHM_VOLUME = "ptpu-shm"

DEFAULT_AUX_IMAGE = "polyaxon-tpu-torch/aux:latest"


def _aux_container(name: str, image: str, argv: List[str],
                   env: Optional[List[Dict[str, Any]]] = None
                   ) -> Dict[str, Any]:
    return {
        "name": name,
        "image": image,
        "command": ["python", "-m", "polyaxon_tpu_torch.initializer"],
        "args": argv,
        "env": env or [],
        "volumeMounts": [
            {"name": CONTEXT_VOLUME, "mountPath": CONTEXT_MOUNT},
            {"name": ARTIFACTS_VOLUME, "mountPath": ARTIFACTS_MOUNT},
        ],
    }


def get_init_containers(
    inits: Optional[List[V1Init]],
    aux_image: str = DEFAULT_AUX_IMAGE,
) -> List[Dict[str, Any]]:
    containers: List[Dict[str, Any]] = []
    for idx, init in enumerate(inits or []):
        name = f"ptpu-init-{idx}"
        if init.container is not None:
            # Custom init container passes through, with the shared
            # context/artifacts mounts appended.
            c = init.container.to_dict()  # camelCase aliases built in
            c.setdefault("name", name)
            mounts = c.setdefault("volumeMounts", [])
            mounts.extend([
                {"name": CONTEXT_VOLUME, "mountPath": CONTEXT_MOUNT},
                {"name": ARTIFACTS_VOLUME, "mountPath": ARTIFACTS_MOUNT},
            ])
            containers.append(c)
            continue
        dest = init.path or CONTEXT_MOUNT
        if init.git is not None:
            argv = ["git", "--url", init.git.url or "", "--dest", dest]
            if init.git.revision:
                argv += ["--revision", init.git.revision]
            for flag in init.git.flags or []:
                argv += ["--flag", flag]
        elif init.artifacts is not None:
            argv = ["artifacts", "--dest", dest]
            for f in init.artifacts.files or []:
                argv += ["--file", str(f)]
            for d in init.artifacts.dirs or []:
                argv += ["--dir", str(d)]
            if init.connection:
                argv += ["--connection", init.connection]
        elif init.file is not None:
            argv = ["file", "--dest", dest,
                    "--filename", init.file.filename or "file",
                    "--content", init.file.content or ""]
            if init.file.chmod:
                argv += ["--chmod", init.file.chmod]
        elif init.dockerfile is not None:
            argv = ["dockerfile", "--dest", dest,
                    "--spec", json.dumps(init.dockerfile.to_dict())]
        elif init.tensorboard is not None:
            argv = ["tensorboard", "--dest", dest,
                    "--spec", json.dumps(init.tensorboard.to_dict())]
        elif init.connection:
            argv = ["artifacts", "--dest", dest,
                    "--connection", init.connection]
        else:
            raise ValueError(f"Init entry {idx} declares no action")
        containers.append(_aux_container(name, aux_image, argv))
    return containers


def get_sidecar_container(
    run_uuid: str,
    aux_image: str = DEFAULT_AUX_IMAGE,
    sync_interval: int = 10,
    collect_logs: bool = True,
    collect_artifacts: bool = True,
) -> Dict[str, Any]:
    """Watcher-uploader streaming run events/logs to the artifacts store."""
    return {
        "name": "ptpu-sidecar",
        "image": aux_image,
        "command": ["python", "-m", "polyaxon_tpu_torch.sidecar"],
        "args": [
            "--run-uuid", run_uuid,
            "--local-root", f"{RUN_HOME_MOUNT}/runs/{run_uuid}",
            "--store-root", ARTIFACTS_MOUNT,
            "--sync-interval", str(sync_interval),
            "--collect-logs", "true" if collect_logs else "false",
            "--collect-artifacts", "true" if collect_artifacts else "false",
        ],
        "env": [],
        "volumeMounts": [
            {"name": RUN_HOME_VOLUME, "mountPath": RUN_HOME_MOUNT},
            {"name": ARTIFACTS_VOLUME, "mountPath": ARTIFACTS_MOUNT},
        ],
    }


def get_volumes(
    *,
    shm: bool = False,
    artifacts_claim: Optional[str] = None,
    artifacts_host_path: Optional[str] = None,
    extra: Optional[List[Dict[str, Any]]] = None,
) -> List[Dict[str, Any]]:
    volumes: List[Dict[str, Any]] = [
        {"name": CONTEXT_VOLUME, "emptyDir": {}},
        {"name": RUN_HOME_VOLUME, "emptyDir": {}},
    ]
    if artifacts_claim:
        volumes.append({
            "name": ARTIFACTS_VOLUME,
            "persistentVolumeClaim": {"claimName": artifacts_claim},
        })
    elif artifacts_host_path:
        volumes.append({
            "name": ARTIFACTS_VOLUME,
            "hostPath": {"path": artifacts_host_path},
        })
    else:
        volumes.append({"name": ARTIFACTS_VOLUME, "emptyDir": {}})
    if shm:
        volumes.append({
            "name": SHM_VOLUME,
            "emptyDir": {"medium": "Memory"},
        })
    volumes.extend(extra or [])
    # Dedupe at the merge point: builtin + user section + connection
    # volumes can collide on name (e.g. two connections sharing one
    # secret), and the k8s API rejects duplicate volumes[].name.
    seen: set = set()
    return [v for v in volumes
            if not (v["name"] in seen or seen.add(v["name"]))]
