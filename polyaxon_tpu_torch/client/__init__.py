"""Clients: the hub every consumer (CLI, tracking, tuner, agent) goes through.

Parity: reference ``RunClient``/``ProjectClient`` (SURVEY.md 2.7).  Local
mode talks straight to the file store; API mode (control plane) swaps in an
HTTP transport with the same interface.

The port's own copy of ``polyaxon_tpu/client/__init__.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from .run_client import ProjectClient, RunClient, get_client
from .store import FileRunStore, StoreError, default_home
