"""Hook execution: post-run actions (notify / follow-up operations).

Parity: reference ``V1Hook`` + notifier kind (SURVEY.md 2.3; notifier
auxiliaries).  After a run reaches a terminal status the executor calls
``run_hooks``: each hook whose ``trigger`` matches fires — connection
hooks emit a notification through the connection (webhook/slack POST
with a short timeout; always recorded as a notification artifact so
air-gapped clusters still get an audit trail), hub_ref hooks are
recorded for the scheduler to materialize.

The port's own copy of ``polyaxon_tpu/runner/hooks.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import logging
import time
from typing import Any, Dict, List, Optional

from ..lifecycle import V1Statuses

logger = logging.getLogger(__name__)

_TRIGGER_STATUSES = {
    "succeeded": {V1Statuses.SUCCEEDED},
    "failed": {V1Statuses.FAILED, V1Statuses.UPSTREAM_FAILED},
    "stopped": {V1Statuses.STOPPED},
}


def trigger_matches(trigger: Optional[str], status: str) -> bool:
    if not trigger or trigger == "done":
        return status in V1Statuses.DONE
    return status in _TRIGGER_STATUSES.get(trigger, set())


_COND_OPS = [
    ("==", lambda a, b: a == b),
    ("!=", lambda a, b: a != b),
    (">=", lambda a, b: a >= b),
    ("<=", lambda a, b: a <= b),
    (">", lambda a, b: a > b),
    ("<", lambda a, b: a < b),
]


def _cond_operand(token: str, ctx: Dict[str, Any]) -> Any:
    token = token.strip()
    try:
        return json.loads(token)  # numbers, booleans, quoted strings
    except ValueError:
        pass
    from ..compiler.templates import TemplateError, _lookup

    try:
        return _lookup(token, ctx)
    except TemplateError:
        if "." in token:
            # Dotted tokens are context paths; a missing path must make
            # the condition False, not silently become a string literal
            # ('outputs.accuracy != 0' on a run with no outputs).
            raise
        return token  # bare string literal (status == succeeded)


def evaluate_condition(condition: Optional[str],
                       ctx: Dict[str, Any]) -> bool:
    """Minimal safe condition language: ``lhs OP rhs`` (optionally
    ``{{ ... }}``-wrapped) over the run context; a bare path is truthy-
    tested.  Unknown paths / type errors evaluate False (a hook must
    never crash a finished run)."""
    if not condition:
        return True
    expr = condition.strip()
    if expr.startswith("{{") and expr.endswith("}}"):
        expr = expr[2:-2].strip()
    try:
        for op, fn in _COND_OPS:
            if op in expr:
                lhs, _, rhs = expr.partition(op)
                return bool(fn(_cond_operand(lhs, ctx),
                               _cond_operand(rhs, ctx)))
        return bool(_cond_operand(expr, ctx))
    except Exception as e:  # noqa: BLE001 - conditions are best-effort
        logger.warning("hook condition %r failed to evaluate: %s",
                       condition, e)
        return False


def _notify_connection(conn, payload: Dict[str, Any],
                       timeout: float = 5.0) -> str:
    """POST the payload to webhook-ish connections; returns delivery
    state (sent/skipped/error:...)."""
    from ..connections import ConnectionKind

    if conn.kind not in (ConnectionKind.SLACK, ConnectionKind.WEBHOOK):
        return "skipped"
    url = conn.typed_schema().url
    try:
        import urllib.request

        if conn.kind == ConnectionKind.SLACK:
            body = {"text": payload.get("message", ""),
                    "attachments": [{"fields": [
                        {"title": k, "value": str(v), "short": True}
                        for k, v in payload.items() if k != "message"]}]}
        else:
            body = payload
        req = urllib.request.Request(
            url, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=timeout):
            pass
        return "sent"
    except Exception as e:  # noqa: BLE001 - notification must not fail runs
        logger.warning("notification to %s failed: %s", conn.name, e)
        return f"error: {e}"


def run_hooks(compiled, record: Dict[str, Any], store,
              catalog=None) -> List[Dict[str, Any]]:
    """Fire matching hooks; returns the notification records written."""
    hooks = getattr(compiled, "hooks", None) or []
    if not hooks:
        return []
    status = record.get("status")
    if catalog is None:
        from ..connections import ConnectionCatalog

        catalog = ConnectionCatalog.load()

    cond_ctx = {
        "outputs": record.get("outputs") or {},
        "inputs": record.get("inputs") or {},
        "status": status,
        "globals": record,
    }
    fired: List[Dict[str, Any]] = []
    for hook in hooks:
        if not trigger_matches(hook.trigger, status):
            continue
        if not evaluate_condition(hook.conditions, cond_ctx):
            continue
        payload = {
            "message": f"Run {record.get('name')} ({record['uuid']}) "
                       f"finished with status {status}",
            "uuid": record["uuid"],
            "name": record.get("name"),
            "project": record.get("project"),
            "status": status,
            "duration": record.get("duration"),
            "outputs": record.get("outputs") or {},
            "ts": time.time(),
        }
        entry: Dict[str, Any] = {"trigger": hook.trigger or "done",
                                 "payload": payload}
        if hook.connection:
            entry["connection"] = hook.connection
            try:
                conn = catalog.get(hook.connection)
                entry["delivery"] = _notify_connection(conn, payload)
            except KeyError as e:
                entry["delivery"] = f"error: {e}"
        if hook.hub_ref:
            # Follow-up operation: recorded; the scheduler/CLI can
            # materialize it (hub resolution is deployment-specific).
            entry["hub_ref"] = hook.hub_ref
            entry["params"] = hook.params or {}
        fired.append(entry)

    if fired:
        store.append_events(record["uuid"], "notification", "hooks",
                            fired)
    return fired
