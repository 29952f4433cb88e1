"""Client/deployment configuration: env layering + home config.

Parity: reference ``ClientConfig`` / env vars / home managers
(SURVEY.md 2.15/5.6; expected at ``polyaxon/_env_vars``, ``_managers/``
— unverified).  Layering, lowest to highest precedence:

    1. defaults
    2. home config file (``$POLYAXON_TPU_HOME/config.json``)
    3. ``POLYAXON_TPU_*`` environment variables
    4. explicit constructor kwargs

TPU additions: default mesh/topology settings (slice type, strategy
axes) ride the same config so a deployment can pin them fleet-wide.

The port's own copy of ``polyaxon_tpu/config.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

ENV_PREFIX = "POLYAXON_TPU_"

_ENV_KEYS = {
    "host": "HOST",
    "token": "AUTH_TOKEN",
    "project": "PROJECT",
    "namespace": "NAMESPACE",
    "timeout": "TIMEOUT",
    "verify_ssl": "VERIFY_SSL",
    "debug": "DEBUG",
    "default_slice_type": "DEFAULT_SLICE_TYPE",
    "default_strategy": "DEFAULT_STRATEGY",
    "connections_file": "CONNECTIONS_FILE",
}

_BOOLS = {"verify_ssl", "debug"}
_FLOATS = {"timeout"}
_JSON = {"default_strategy"}


def home_dir() -> str:
    from .client.store import default_home

    return default_home()


def _config_path() -> str:
    return os.path.join(home_dir(), "config.json")


def _write_config(path: str, payload: Dict[str, Any]) -> None:
    """Atomic write, 0600: config.json may hold the API bearer token, so
    it must not be readable by other local users (ADVICE r1)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    os.chmod(path, 0o600)


def _coerce(key: str, value: Any) -> Any:
    if value is None or not isinstance(value, str):
        return value
    if key in _BOOLS:
        return value.lower() in ("1", "true", "yes", "on")
    if key in _FLOATS:
        return float(value)
    if key in _JSON:
        try:
            return json.loads(value)
        except ValueError:
            return value
    return value


@dataclass
class ClientConfig:
    host: Optional[str] = None
    token: Optional[str] = None
    project: str = "default"
    namespace: str = "polyaxon-tpu"
    timeout: float = 30.0
    verify_ssl: bool = True
    debug: bool = False
    # TPU-wide defaults
    default_slice_type: str = "v5litepod-8"
    default_strategy: Dict[str, int] = field(default_factory=dict)
    connections_file: Optional[str] = None

    @staticmethod
    def read_file_layer() -> Dict[str, Any]:
        """Raw key -> value pairs persisted in the home config file."""
        path = _config_path()
        if not os.path.exists(path):
            return {}
        try:
            with open(path) as f:
                stored = json.load(f)
            return {k: v for k, v in stored.items() if k in _ENV_KEYS}
        except (OSError, ValueError):
            return {}

    @classmethod
    def load(cls, **overrides: Any) -> "ClientConfig":
        """Apply the full layering."""
        values: Dict[str, Any] = dict(cls.read_file_layer())
        for key, suffix in _ENV_KEYS.items():
            env_val = os.environ.get(ENV_PREFIX + suffix)
            if env_val is not None:
                values[key] = _coerce(key, env_val)
        values.update({k: v for k, v in overrides.items()
                       if v is not None})
        return cls(**values)

    def save(self) -> str:
        """Persist to the home config file (the `config set` surface)."""
        path = _config_path()
        payload = {k: v for k, v in dataclasses.asdict(self).items()
                   if v not in (None, {}, [])}
        _write_config(path, payload)
        return path

    @classmethod
    def set_file_values(cls, pairs: Dict[str, str]) -> str:
        """Mutate ONLY the file layer: never freeze env values or
        package defaults into config.json (a stale exported token/host
        must not outlive its shell)."""
        stored = cls.read_file_layer()
        for key, raw in pairs.items():
            if key not in _ENV_KEYS:
                raise KeyError(
                    f"Unknown config key {key!r}; known: "
                    f"{sorted(_ENV_KEYS)}")
            stored[key] = _coerce(key, raw)
        path = _config_path()
        _write_config(path, stored)
        return path

    @classmethod
    def unset_file_values(cls, keys) -> str:
        """Remove keys from the file layer (atomic write)."""
        stored = cls.read_file_layer()
        for key in keys:
            stored.pop(key, None)
        path = _config_path()
        _write_config(path, stored)
        return path

    def set_value(self, key: str, raw: str) -> None:
        if key not in _ENV_KEYS:
            raise KeyError(
                f"Unknown config key {key!r}; known: {sorted(_ENV_KEYS)}")
        setattr(self, key, _coerce(key, raw))

    @property
    def in_cluster(self) -> bool:
        return bool(os.environ.get(ENV_PREFIX + "RUN_UUID"))
