"""SNAPSHOT-LOCK: the /debug/state consistency contract.

The port's own copy of ``polyaxon_tpu/analysis/rules/snapshot_lock.py``,
retargeted from JAX to torch: the reference flagged any ``jax.*`` call
under the board lock; here the sink is any ``torch.*`` call and any
tensor host copy (``.cpu()``, ``.item()``, ``.tolist()``,
``.numpy()``) and the serving stack's own fences (``slots.host_copy``,
``slots.sync_device``), each of which waits for in-flight work on the
card.
"""

from __future__ import annotations

import ast
from typing import List

from ._base import Finding, Rule, _ScopedVisitor, _in_serving, \
    _src_line, dotted_name


_HOST_COPIES = frozenset({"cpu", "item", "tolist", "numpy"})


class SnapshotLockRule(Rule):
    """The ``/debug/state`` consistency contract (docs/DESIGN.md):
    code holding a snapshot-board ``*state_lock`` must never acquire
    the device lock — directly or by calling into a device-
    dispatching entry point.

    The introspection surface exists to answer "why is the engine
    making no progress" — which it cannot do if serving a snapshot
    can queue behind the very device call that is wedged.  Flags,
    inside a ``with <...state_lock>`` body (not descending into
    nested defs):

    - a nested ``with`` on (or blocking ``.acquire()`` of) a lock
      named ``device_lock`` / ``_lock`` — the server's device lock;
    - calls whose dotted tail is a device-dispatching serving entry
      point (``generate`` / ``prefill_prompt`` / ``submit`` /
      ``tick`` / ``_decode_step`` / ``_advance_prefill``);
    - any ``torch.*`` call or tensor host copy (``.cpu()`` /
      ``.item()`` / ``.tolist()`` / ``.numpy()``) — snapshot
      serialization is plain host-dict work by contract, so no torch
      call belongs under the board lock (a host copy of a CUDA tensor
      syncs against in-flight device work).
    """

    id = "SNAPSHOT-LOCK"

    _DEVICE_ENTRY = frozenset({
        "generate", "prefill_prompt", "submit", "tick",
        "_decode_step", "_advance_prefill"})
    _DEVICE_LOCKS = frozenset({"device_lock", "_lock"})

    def applies_to(self, relpath: str) -> bool:
        return _in_serving(relpath)

    def check(self, tree, lines, relpath):
        findings: List[Finding] = []
        rule = self

        def _lock_tail(expr) -> str:
            name = dotted_name(expr)
            if name is None and isinstance(expr, ast.Call):
                name = dotted_name(expr.func)
            return (name or "").rsplit(".", 1)[-1]

        class V(_ScopedVisitor):
            def visit_With(self, node):
                if any(_lock_tail(item.context_expr)
                       .endswith("state_lock")
                       for item in node.items):
                    for stmt in node.body:
                        self._scan(stmt)
                self.generic_visit(node)

            visit_AsyncWith = visit_With

            def _flag(self, node, msg: str) -> None:
                findings.append(Finding(
                    rule.id, relpath, node.lineno, self.func,
                    _src_line(lines, node.lineno),
                    f"{msg} while holding the snapshot state lock: "
                    f"/debug/state must answer even when the device "
                    f"is wedged — build the snapshot at a step "
                    f"boundary and serve the published copy "
                    f"(docs/DESIGN.md SNAPSHOT-LOCK)"))

            def _scan(self, node) -> None:
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef,
                                     ast.Lambda)):
                    return      # runs later, not under the lock
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        if _lock_tail(item.context_expr) \
                                in rule._DEVICE_LOCKS:
                            self._flag(item.context_expr,
                                       "acquiring the device lock")
                if isinstance(node, ast.Call):
                    name = dotted_name(node.func) or ""
                    tail = name.rsplit(".", 1)[-1]
                    if tail == "acquire" and \
                            isinstance(node.func, ast.Attribute) and \
                            (dotted_name(node.func.value) or "") \
                            .rsplit(".", 1)[-1] in rule._DEVICE_LOCKS:
                        self._flag(node,
                                   "acquiring the device lock")
                    elif tail in rule._DEVICE_ENTRY and \
                            isinstance(node.func, ast.Attribute):
                        self._flag(
                            node,
                            f"calling the device-dispatching entry "
                            f"point .{tail}()")
                    elif name.startswith("torch.") or tail in (
                            "host_copy", "sync_device"):
                        self._flag(node, f"torch call ({name})")
                    elif isinstance(node.func, ast.Attribute) and \
                            node.func.attr in _HOST_COPIES and \
                            not node.args:
                        self._flag(node, f"tensor host copy "
                                         f".{node.func.attr}()")
                for child in ast.iter_child_nodes(node):
                    self._scan(child)

        V().visit(tree)
        return findings

RULES = (SnapshotLockRule(),)
