"""Slim typed pods-and-containers vocabulary used by environments/containers.

The reference leans on full Kubernetes client models; we keep a minimal,
validated subset sufficient for the converter (SURVEY.md 2.10) while
remaining open (extra fields allowed) so real k8s YAML passes through.

The port's own copy of ``polyaxon_tpu/flow/k8s_refs.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from pydantic import field_validator

from .base import BaseOpenSchema


class V1EnvVar(BaseOpenSchema):
    name: str
    value: Optional[str] = None
    value_from: Optional[Dict[str, Any]] = None


class V1ResourceRequirements(BaseOpenSchema):
    limits: Optional[Dict[str, Any]] = None
    requests: Optional[Dict[str, Any]] = None


class V1VolumeMount(BaseOpenSchema):
    name: str
    mount_path: Optional[str] = None
    sub_path: Optional[str] = None
    read_only: Optional[bool] = None


class V1ContainerPort(BaseOpenSchema):
    container_port: int
    name: Optional[str] = None
    host_port: Optional[int] = None


class V1Container(BaseOpenSchema):
    """Main/init/sidecar container spec."""

    name: Optional[str] = None
    image: Optional[str] = None
    image_pull_policy: Optional[str] = None
    command: Optional[List[str]] = None
    args: Optional[List[str]] = None
    env: Optional[List[V1EnvVar]] = None
    resources: Optional[V1ResourceRequirements] = None
    volume_mounts: Optional[List[V1VolumeMount]] = None
    working_dir: Optional[str] = None
    ports: Optional[List[V1ContainerPort]] = None

    @field_validator("command", "args", mode="before")
    @classmethod
    def _stringify(cls, v):
        # Template resolution yields native types ({{ epochs }} -> 4); exec
        # argv is strings.  Use YAML/JSON spellings (true, not True; JSON
        # for containers) so programs parse what the spec author wrote.
        import json

        def conv(x):
            if isinstance(x, str):
                return x
            if x is None:
                return ""
            if isinstance(x, bool):
                return "true" if x else "false"
            if isinstance(x, (dict, list)):
                return json.dumps(x)
            return str(x)

        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        return v

    def get_resources(self) -> V1ResourceRequirements:
        return self.resources or V1ResourceRequirements()
