"""Environment / termination / plugins / init / cache / build / hooks schemas.

Parity targets: reference ``V1Environment``, ``V1Termination``, ``V1Plugins``,
``V1Init``, ``V1Cache``, ``V1Hook`` (SURVEY.md 2.3; expected reference
location ``polyaxon/_flow/`` — unverified).

The port's own copy of ``polyaxon_tpu/flow/environment.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

from .base import BaseOpenSchema, BaseSchema
from .k8s_refs import V1Container


class V1Environment(BaseOpenSchema):
    """Pod-level scheduling knobs for a run."""

    labels: Optional[Dict[str, str]] = None
    annotations: Optional[Dict[str, str]] = None
    node_selector: Optional[Dict[str, str]] = None
    affinity: Optional[Dict[str, Any]] = None
    tolerations: Optional[List[Dict[str, Any]]] = None
    node_name: Optional[str] = None
    service_account_name: Optional[str] = None
    host_aliases: Optional[List[Dict[str, Any]]] = None
    security_context: Optional[Dict[str, Any]] = None
    image_pull_secrets: Optional[List[str]] = None
    host_network: Optional[bool] = None
    host_pid: Optional[bool] = None
    dns_policy: Optional[str] = None
    dns_config: Optional[Dict[str, Any]] = None
    scheduler_name: Optional[str] = None
    priority_class_name: Optional[str] = None
    priority: Optional[int] = None
    restart_policy: Optional[str] = None


class V1Termination(BaseSchema):
    """Retry/timeout/TTL policy enforced by the operator-equivalent."""

    max_retries: Optional[int] = None
    ttl: Optional[int] = None
    timeout: Optional[int] = None


class V1Plugins(BaseSchema):
    """Feature toggles controlling auxiliaries injected by the converter."""

    auth: Optional[bool] = None
    docker: Optional[bool] = None
    shm: Optional[bool] = None
    mount_artifacts_store: Optional[bool] = None
    collect_artifacts: Optional[bool] = None
    collect_logs: Optional[bool] = None
    collect_resources: Optional[bool] = None
    sync_statuses: Optional[bool] = None
    auto_resume: Optional[bool] = None
    log_level: Optional[str] = None
    side_car: Optional[Dict[str, Any]] = None
    external_host: Optional[bool] = None
    sidecar: Optional[Dict[str, Any]] = None


class V1GitInit(BaseSchema):
    url: Optional[str] = None
    revision: Optional[str] = None
    flags: Optional[List[str]] = None


class V1ArtifactsInit(BaseSchema):
    files: Optional[List[Any]] = None
    dirs: Optional[List[Any]] = None
    workers: Optional[int] = None


class V1DockerfileInit(BaseOpenSchema):
    image: Optional[str] = None
    env: Optional[Dict[str, str]] = None
    run: Optional[List[str]] = None
    filename: Optional[str] = None
    workdir: Optional[str] = None
    copy_: Optional[List[Any]] = None


class V1FileInit(BaseSchema):
    content: Optional[str] = None
    filename: Optional[str] = None
    kind: Optional[str] = None
    chmod: Optional[str] = None


class V1TensorboardInit(BaseSchema):
    port: Optional[int] = None
    uuids: Optional[List[str]] = None
    use_names: Optional[bool] = None
    path_prefix: Optional[str] = None


class V1Init(BaseSchema):
    """One init action: git clone, artifact pull, dockerfile gen, inline file,
    or a custom init container — run before the main container starts."""

    git: Optional[V1GitInit] = None
    artifacts: Optional[V1ArtifactsInit] = None
    dockerfile: Optional[V1DockerfileInit] = None
    file: Optional[V1FileInit] = None
    tensorboard: Optional[V1TensorboardInit] = None
    lineage_ref: Optional[str] = None
    model_ref: Optional[str] = None
    artifact_ref: Optional[str] = None
    connection: Optional[str] = None
    path: Optional[str] = None
    container: Optional[V1Container] = None

    def has_connection(self) -> bool:
        return bool(self.connection)


class V1Cache(BaseSchema):
    disable: Optional[bool] = None
    ttl: Optional[int] = None
    io_keys: Optional[List[str]] = None
    sections: Optional[List[str]] = None


class V1Hook(BaseSchema):
    """Post-run action (e.g. notify or launch another component)."""

    connection: Optional[str] = None
    trigger: Optional[str] = None  # succeeded | failed | stopped | done
    hub_ref: Optional[str] = None
    conditions: Optional[str] = None
    queue: Optional[str] = None
    presets: Optional[List[str]] = None
    params: Optional[Dict[str, Any]] = None
    disable_defaults: Optional[bool] = None


class V1Build(BaseSchema):
    """Pre-run image build directive."""

    hub_ref: Optional[str] = None
    connection: Optional[str] = None
    queue: Optional[str] = None
    presets: Optional[List[str]] = None
    params: Optional[Dict[str, Any]] = None
    run_patch: Optional[Dict[str, Any]] = None
    patch_strategy: Optional[str] = None


class V1Notification(BaseSchema):
    connections: List[str]
    trigger: Optional[str] = None
