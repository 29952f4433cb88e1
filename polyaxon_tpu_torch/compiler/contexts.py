"""Context building for template resolution.

Parity with the reference's compiler contexts (SURVEY.md 2.6): a resolved
operation exposes ``globals.*`` (run identity and canonical paths),
``inputs``/``outputs`` by name, and — for matrix children — ``matrix.*``.

The port's own copy of ``polyaxon_tpu/compiler/contexts.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional


def run_artifacts_path(run_uuid: str, root: Optional[str] = None) -> str:
    """Canonical artifacts dir for a run.

    Must agree with ``client.store.FileRunStore.artifacts_path`` — the
    templated ``{{ globals.run_artifacts_path }}`` a job writes to is the
    same tree the store, lineage, and tuner joins read from.  ``root``
    overrides the home dir (e.g. a mounted artifacts store in-cluster).
    """
    from ..client.store import default_home

    home = root or default_home()
    return os.path.join(home, "runs", run_uuid, "artifacts")


def run_outputs_path(run_uuid: str, root: Optional[str] = None) -> str:
    return os.path.join(run_artifacts_path(run_uuid, root), "outputs")


def build_globals(
    run_uuid: str,
    run_name: Optional[str] = None,
    project: Optional[str] = None,
    iteration: Optional[int] = None,
    created_at: Optional[str] = None,
    store_path: Optional[str] = None,
) -> Dict[str, Any]:
    from ..client.store import default_home

    artifacts = run_artifacts_path(run_uuid, store_path)
    return {
        "run_uuid": run_uuid,
        "uuid": run_uuid,
        "run_name": run_name or run_uuid,
        "name": run_name or run_uuid,
        "project_name": project or "default",
        "project_uuid": project or "default",
        "iteration": iteration,
        "created_at": created_at,
        "run_artifacts_path": artifacts,
        "run_outputs_path": os.path.join(artifacts, "outputs"),
        "artifacts_path": artifacts,
        "outputs_path": os.path.join(artifacts, "outputs"),
        "store_path": store_path or default_home(),
        "namespace": os.environ.get("POLYAXON_TPU_NAMESPACE", "polyaxon-tpu"),
    }


# Namespaces bare IO names must never shadow.
RESERVED_CONTEXT_KEYS = frozenset(
    {"globals", "inputs", "outputs", "params", "matrix", "dag", "connections"}
)


def build_contexts(
    globals_ctx: Dict[str, Any],
    inputs: Optional[Dict[str, Any]] = None,
    outputs: Optional[Dict[str, Any]] = None,
    matrix: Optional[Dict[str, Any]] = None,
    connections: Optional[Dict[str, Any]] = None,
    dag: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    ctx: Dict[str, Any] = {
        "globals": dict(globals_ctx),
        "inputs": dict(inputs or {}),
        "outputs": dict(outputs or {}),
        "params": {**(inputs or {}), **(outputs or {})},
        "connections": dict(connections or {}),
    }
    if matrix:
        ctx["matrix"] = dict(matrix)
    if dag:
        ctx["dag"] = dict(dag)
    # IO names are addressable bare ({{ lr }}) like the reference, but may
    # never shadow the reserved namespaces above.
    for name, value in {**(inputs or {}), **(outputs or {})}.items():
        if name not in RESERVED_CONTEXT_KEYS:
            ctx.setdefault(name, value)
    return ctx
