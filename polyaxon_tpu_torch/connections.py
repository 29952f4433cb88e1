"""Typed connections: external stores/services a run mounts or reaches.

Parity: reference connection schemas + fs adapters (SURVEY.md 2.13;
expected at ``polyaxon/_connections/`` — unverified).  A connection has
a kind (object store / volume / git / registry), a typed config schema,
and optional secret/config-map references the converter materializes as
env or mounts.  Filesystem access goes through ``fs_adapter``: local
paths natively, fsspec-backed schemes (gs://, s3://) when the optional
dependency is present — gated, never imported at module load.

The port's own copy of ``polyaxon_tpu/connections.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from pydantic import field_validator

from .flow.base import BaseSchema


class ConnectionKind:
    HOST_PATH = "host_path"
    VOLUME_CLAIM = "volume_claim"
    GCS = "gcs"
    S3 = "s3"
    WASB = "wasb"  # azure blob
    GIT = "git"
    REGISTRY = "registry"
    SLACK = "slack"
    WEBHOOK = "webhook"

    MOUNTABLE = {HOST_PATH, VOLUME_CLAIM}
    BLOB = {GCS, S3, WASB}
    ARTIFACT = MOUNTABLE | BLOB


class V1HostPathConnection(BaseSchema):
    host_path: str
    mount_path: Optional[str] = None
    read_only: Optional[bool] = None


class V1ClaimConnection(BaseSchema):
    volume_claim: str
    mount_path: str
    read_only: Optional[bool] = None


class V1BucketConnection(BaseSchema):
    bucket: str


class V1GitConnection(BaseSchema):
    url: str
    revision: Optional[str] = None
    flags: Optional[List[str]] = None


class V1UrlConnection(BaseSchema):
    url: str


class V1ConnectionResource(BaseSchema):
    """A k8s secret or config-map the connection needs at runtime."""

    name: str
    mount_path: Optional[str] = None
    items: Optional[List[str]] = None
    default_mode: Optional[str] = None
    is_requested: Optional[bool] = None


_SCHEMA_BY_KIND = {
    ConnectionKind.HOST_PATH: V1HostPathConnection,
    ConnectionKind.VOLUME_CLAIM: V1ClaimConnection,
    ConnectionKind.GCS: V1BucketConnection,
    ConnectionKind.S3: V1BucketConnection,
    ConnectionKind.WASB: V1BucketConnection,
    ConnectionKind.GIT: V1GitConnection,
    ConnectionKind.REGISTRY: V1UrlConnection,
    ConnectionKind.SLACK: V1UrlConnection,
    ConnectionKind.WEBHOOK: V1UrlConnection,
}


class V1Connection(BaseSchema):
    """A named, typed external resource."""

    name: str
    kind: str
    description: Optional[str] = None
    tags: Optional[List[str]] = None
    schema_: Optional[Dict[str, Any]] = None
    secret: Optional[V1ConnectionResource] = None
    config_map: Optional[V1ConnectionResource] = None
    env: Optional[List[Dict[str, Any]]] = None
    annotations: Optional[Dict[str, str]] = None

    @field_validator("kind")
    @classmethod
    def _kind(cls, v):
        if v not in _SCHEMA_BY_KIND:
            raise ValueError(
                f"Unknown connection kind {v!r}; known: "
                f"{sorted(_SCHEMA_BY_KIND)}")
        return v

    def typed_schema(self):
        """Validate + return the kind-specific config."""
        cls = _SCHEMA_BY_KIND[self.kind]
        return cls.from_dict(self.schema_ or {})

    @property
    def is_artifact_store(self) -> bool:
        return self.kind in ConnectionKind.ARTIFACT

    def store_root(self) -> str:
        """Filesystem-ish root for artifact-store kinds."""
        schema = self.typed_schema()
        if self.kind == ConnectionKind.HOST_PATH:
            return schema.host_path
        if self.kind == ConnectionKind.VOLUME_CLAIM:
            return schema.mount_path
        if self.kind in ConnectionKind.BLOB:
            prefix = {"gcs": "gs://", "s3": "s3://",
                      "wasb": "wasb://"}[self.kind]
            bucket = schema.bucket
            return bucket if "://" in bucket else prefix + bucket
        raise ValueError(
            f"Connection {self.name!r} ({self.kind}) is not an artifact "
            "store")

    def env_name(self) -> str:
        """Env var the initializer resolves this connection's root from."""
        return ("POLYAXON_TPU_CONNECTION_"
                + self.name.upper().replace("-", "_") + "_ROOT")


class ConnectionCatalog:
    """The deployment's named connections (agent/converter side).

    Loaded from a JSON/YAML catalog file (``POLYAXON_TPU_CONNECTIONS_FILE``)
    or built programmatically.  The converter asks it for volumes/env to
    attach; the initializer resolves roots via the env vars it emits.
    """

    def __init__(self, connections: Optional[List[V1Connection]] = None):
        self._by_name: Dict[str, V1Connection] = {
            c.name: c for c in connections or []}

    @classmethod
    def load(cls, path: Optional[str] = None) -> "ConnectionCatalog":
        path = path or os.environ.get("POLYAXON_TPU_CONNECTIONS_FILE")
        if not path:
            from .config import ClientConfig

            path = ClientConfig.read_file_layer().get("connections_file")
        if not path or not os.path.exists(path):
            return cls()
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or []
        if isinstance(data, dict):
            data = data.get("connections") or []
        return cls([V1Connection.from_dict(d) for d in data])

    def get(self, name: str) -> V1Connection:
        if name not in self._by_name:
            raise KeyError(
                f"Unknown connection {name!r}; cataloged: "
                f"{sorted(self._by_name)}")
        return self._by_name[name]

    def names(self) -> List[str]:
        return sorted(self._by_name)

    def add(self, connection: V1Connection) -> None:
        self._by_name[connection.name] = connection

    # -- converter hooks -------------------------------------------------

    def volume_for(self, name: str) -> Optional[Dict[str, Any]]:
        """k8s volume spec for mountable kinds (None for blob/url kinds)."""
        conn = self.get(name)
        schema = conn.typed_schema()
        if conn.kind == ConnectionKind.HOST_PATH:
            return {"name": f"conn-{name}",
                    "hostPath": {"path": schema.host_path}}
        if conn.kind == ConnectionKind.VOLUME_CLAIM:
            return {"name": f"conn-{name}",
                    "persistentVolumeClaim":
                        {"claimName": schema.volume_claim}}
        return None

    def mount_for(self, name: str) -> Optional[Dict[str, Any]]:
        conn = self.get(name)
        schema = conn.typed_schema()
        if conn.kind == ConnectionKind.HOST_PATH:
            return {"name": f"conn-{name}",
                    "mountPath": schema.mount_path or schema.host_path,
                    "readOnly": bool(schema.read_only)}
        if conn.kind == ConnectionKind.VOLUME_CLAIM:
            return {"name": f"conn-{name}",
                    "mountPath": schema.mount_path,
                    "readOnly": bool(schema.read_only)}
        return None

    def env_for(self, name: str) -> List[Dict[str, Any]]:
        """Env entries advertising the connection root + custom env."""
        conn = self.get(name)
        env: List[Dict[str, Any]] = []
        if conn.is_artifact_store:
            mount = self.mount_for(name)
            root = (mount["mountPath"] if mount else conn.store_root())
            env.append({"name": conn.env_name(), "value": root})
        env.extend(conn.env or [])
        if conn.secret and not conn.secret.mount_path:
            # env-style secret: expose every requested key
            for key in conn.secret.items or []:
                env.append({
                    "name": key,
                    "valueFrom": {"secretKeyRef":
                                  {"name": conn.secret.name, "key": key}},
                })
        return env

    def resource_volumes_for(self, name: str):
        """(volumes, mounts) for mounted secrets/config-maps — e.g. a GCS
        service-account keyfile at its mount_path."""
        conn = self.get(name)
        volumes: List[Dict[str, Any]] = []
        mounts: List[Dict[str, Any]] = []
        if conn.secret and conn.secret.mount_path:
            vol_name = f"secret-{conn.secret.name}"
            volumes.append({"name": vol_name,
                            "secret": {"secretName": conn.secret.name}})
            mounts.append({"name": vol_name,
                           "mountPath": conn.secret.mount_path,
                           "readOnly": True})
        if conn.config_map and conn.config_map.mount_path:
            vol_name = f"cm-{conn.config_map.name}"
            volumes.append({"name": vol_name,
                            "configMap": {"name": conn.config_map.name}})
            mounts.append({"name": vol_name,
                           "mountPath": conn.config_map.mount_path,
                           "readOnly": True})
        return volumes, mounts


# -- filesystem adapter ----------------------------------------------------


def fs_adapter(root: str):
    """Filesystem for a store root: local paths natively, remote schemes
    through fsspec when available (gated — zero hard deps)."""
    if "://" not in root:
        return _LocalFs(root)
    try:
        import fsspec  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            f"Remote store root {root!r} needs fsspec, which is not "
            "installed in this environment; use a mounted/local "
            "connection instead") from e
    fs, path = fsspec.core.url_to_fs(root)
    return _FsspecFs(fs, path)


class _LocalFs:
    def __init__(self, root: str):
        self.root = root

    def _p(self, rel: str) -> str:
        return os.path.join(self.root, rel) if rel else self.root

    def open(self, rel: str, mode: str = "r"):
        if "w" in mode or "a" in mode:
            os.makedirs(os.path.dirname(self._p(rel)), exist_ok=True)
        return open(self._p(rel), mode)

    def exists(self, rel: str) -> bool:
        return os.path.exists(self._p(rel))

    def listdir(self, rel: str = "") -> List[str]:
        path = self._p(rel)
        return sorted(os.listdir(path)) if os.path.isdir(path) else []

    def makedirs(self, rel: str) -> None:
        os.makedirs(self._p(rel), exist_ok=True)

    def upload(self, local_path: str, rel: str) -> None:
        import shutil

        dest = self._p(rel)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        if os.path.isdir(local_path):
            shutil.copytree(local_path, dest, dirs_exist_ok=True)
        else:
            shutil.copy2(local_path, dest)

    def download(self, rel: str, local_path: str) -> None:
        import shutil

        src = self._p(rel)
        os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
        if os.path.isdir(src):
            shutil.copytree(src, local_path, dirs_exist_ok=True)
        else:
            shutil.copy2(src, local_path)


class _FsspecFs:
    def __init__(self, fs, root: str):
        self.fs = fs
        self.root = root

    def _p(self, rel: str) -> str:
        return f"{self.root}/{rel}" if rel else self.root

    def open(self, rel: str, mode: str = "r"):
        return self.fs.open(self._p(rel), mode)

    def exists(self, rel: str) -> bool:
        return self.fs.exists(self._p(rel))

    def listdir(self, rel: str = "") -> List[str]:
        return sorted(os.path.basename(p)
                      for p in self.fs.ls(self._p(rel)))

    def makedirs(self, rel: str) -> None:
        self.fs.makedirs(self._p(rel), exist_ok=True)

    def upload(self, local_path: str, rel: str) -> None:
        self.fs.put(local_path, self._p(rel), recursive=True)

    def download(self, rel: str, local_path: str) -> None:
        self.fs.get(self._p(rel), local_path, recursive=True)
