"""Query/filter/sort DSL for run records.

Parity with the reference's query language (SURVEY.md 2.16) used by
``ops ls --query`` and tuner joins:

    status:running
    status:running|queued            (OR within a field)
    metrics.loss:<0.1
    tags:tpu, project:vision        (comma = AND)
    name:~resnet                    (~ prefix = negate; bare substring match)
    created_at:>2026-01-01
    uuid:abc123..def456             (range)

Sort: comma-separated field names, ``-`` prefix for descending:
``--sort="-created_at,name"``.

The port's own copy of ``polyaxon_tpu/query.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional


class QueryError(ValueError):
    pass


def _coerce(value: str) -> Any:
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    if value.lower() in ("true", "false"):
        return value.lower() == "true"
    return value


def _get_field(record: Dict[str, Any], field: str,
               metrics_reader: Optional[Callable] = None) -> Any:
    if field.startswith("metrics."):
        name = field[len("metrics."):]
        metrics = record.get("_metrics")
        if metrics is None and metrics_reader is not None:
            metrics = metrics_reader(record["uuid"])
            record["_metrics"] = metrics
        return (metrics or {}).get(name)
    if field.startswith(("inputs.", "outputs.", "meta_info.")):
        ns, _, key = field.partition(".")
        return (record.get(ns) or {}).get(key)
    return record.get(field)


def _match_one(actual: Any, cond: str) -> bool:
    negate = False
    if cond.startswith("~"):
        negate, cond = True, cond[1:]
    result = _compare(actual, cond)
    return (not result) if negate else result


def _ordered(op, actual: Any, expected: Any) -> bool:
    """Ordered comparison that never raises on mixed types.

    ISO dates in the query (created_at:>2026-01-01) are converted to epoch
    floats so they compare correctly against the store's float timestamps;
    any remaining type mismatch falls back to string comparison.
    """
    if actual is None:
        return False
    if isinstance(actual, (int, float)) and isinstance(expected, str):
        try:
            from datetime import datetime, timezone

            dt = datetime.fromisoformat(expected)
            if dt.tzinfo is None:
                dt = dt.replace(tzinfo=timezone.utc)
            expected = dt.timestamp()
        except ValueError:
            pass
    try:
        return op(actual, expected)
    except TypeError:
        return op(str(actual), str(expected))


def _compare(actual: Any, cond: str) -> bool:
    import operator

    if cond.startswith(">="):
        return _ordered(operator.ge, actual, _coerce(cond[2:]))
    if cond.startswith("<="):
        return _ordered(operator.le, actual, _coerce(cond[2:]))
    if cond.startswith(">"):
        return _ordered(operator.gt, actual, _coerce(cond[1:]))
    if cond.startswith("<"):
        return _ordered(operator.lt, actual, _coerce(cond[1:]))
    if ".." in cond:
        lo, _, hi = cond.partition("..")
        return (_ordered(operator.ge, actual, _coerce(lo))
                and _ordered(operator.le, actual, _coerce(hi)))
    if isinstance(actual, list):
        return _coerce(cond) in actual or cond in actual
    if isinstance(actual, str):
        return actual == cond or (len(cond) > 0 and cond in actual
                                  and not cond.replace(".", "").isdigit())
    return actual == _coerce(cond)


def parse_query(query: str) -> List[tuple]:
    """-> [(field, [or_conditions...]), ...] (AND over the list)."""
    clauses = []
    for part in query.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise QueryError(
                f"Bad query clause {part!r}: expected field:condition"
            )
        field, _, cond = part.partition(":")
        ors = [c.strip() for c in cond.split("|") if c.strip()]
        if not ors:
            raise QueryError(f"Bad query clause {part!r}: empty condition")
        clauses.append((field.strip(), ors))
    return clauses


def apply_query(records: List[Dict[str, Any]], query: str,
                metrics_reader: Optional[Callable] = None) -> List[Dict[str, Any]]:
    clauses = parse_query(query)

    def keep(record: Dict[str, Any]) -> bool:
        for field, ors in clauses:
            actual = _get_field(record, field, metrics_reader)
            if not any(_match_one(actual, c) for c in ors):
                return False
        return True

    return [r for r in records if keep(r)]


def apply_sort(records: List[Dict[str, Any]], sort: str) -> List[Dict[str, Any]]:
    for field in reversed([s.strip() for s in sort.split(",") if s.strip()]):
        reverse = field.startswith("-")
        if reverse:
            field = field[1:]

        def key(r, f=field):
            v = _get_field(r, f)
            return (v is None, v)

        try:
            records = sorted(records, key=key, reverse=reverse)
        except TypeError:  # mixed types in the field: fall back to str
            records = sorted(
                records,
                key=lambda r, f=field: str(_get_field(r, f)),
                reverse=reverse,
            )
    return records
