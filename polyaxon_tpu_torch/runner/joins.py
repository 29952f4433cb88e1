"""Join resolution: query-based fan-in of upstream run values.

Parity: reference ``V1Join`` (SURVEY.md 2.3/2.11) — an operation
declaring ``joins`` collects, for each join param, a LIST of values
gathered from every run matching the join's query (tuner analyses,
ensemble/report steps).  Value expressions:

    outputs.<key>    the run's recorded output
    inputs.<key>     the run's resolved input
    globals.<field>  run record field (uuid, name, status, ...)
    artifacts.<sub>  path under the run's artifact tree

The port's own copy of ``polyaxon_tpu/runner/joins.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class JoinError(ValueError):
    pass


def _extract(record: Dict[str, Any], expr: str, store) -> Any:
    if expr.startswith("outputs."):
        return (record.get("outputs") or {}).get(expr[len("outputs."):])
    if expr.startswith("inputs."):
        return (record.get("inputs") or {}).get(expr[len("inputs."):])
    if expr.startswith("globals."):
        field = expr[len("globals."):]
        if field == "run_artifacts_path":
            return store.artifacts_path(record["uuid"])
        if field == "run_outputs_path":
            return store.outputs_path(record["uuid"])
        return record.get(field) or record.get(
            {"run_uuid": "uuid", "run_name": "name"}.get(field, field))
    if expr.startswith("artifacts."):
        import os

        return os.path.join(store.artifacts_path(record["uuid"]),
                            expr[len("artifacts."):])
    if expr == "uuid":
        return record["uuid"]
    raise JoinError(
        f"Unknown join value expression {expr!r}; expected "
        "outputs.*/inputs.*/globals.*/artifacts.*")


def get_joins(operation) -> List[Any]:
    """Effective joins (joins are operation-level in the schema; the
    getattr keeps this robust if components ever grow them)."""
    if getattr(operation, "joins", None):
        return operation.joins
    component = getattr(operation, "component", None)
    return getattr(component, "joins", None) or []


def resolve_joins(operation, store,
                  project: Optional[str] = None) -> Dict[str, List[Any]]:
    """{param_name: [values across matched runs]} for every join."""
    out: Dict[str, List[Any]] = {}
    for join in get_joins(operation):
        records = store.list_runs(
            project=project, query=join.query, sort=join.sort,
            limit=join.limit, offset=join.offset or 0)
        for name, param in (join.params or {}).items():
            expr = param.value
            if not isinstance(expr, str):
                raise JoinError(
                    f"Join param {name!r} needs a string value "
                    f"expression, got {expr!r}")
            out[name] = [_extract(r, expr, store) for r in records]
    return out
