"""RETRY-BACKOFF: bounded-retry discipline in serving/.

The port's own copy of ``polyaxon_tpu/analysis/rules/retry_backoff.py``,
retargeted from JAX to torch: a retried ``try`` is risky when it holds a
``torch.*`` call (the reference's sink was a ``jax.*`` call) or socket
I/O.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ._base import (Finding, Rule, _SOCKET_IO, _ScopedVisitor,
                    _in_serving, _src_line, dotted_name)


class RetryBackoffRule(Rule):
    """Bounded-retry discipline in serving/ (docs/SERVING.md "Fault
    tolerance"): an unbounded ``while True`` retry loop around a torch
    or socket call — a broad handler that swallows the error and
    loops again — turns a PERMANENT failure (a dead card, a gone
    peer) into an invisible infinite spin: no error surfaces, no
    counter advances, and the caller hangs forever, which is exactly
    the crash-never anti-pattern the crash-only contract forbids.
    The sanctioned spelling is the shared
    :class:`~polyaxon_tpu_torch.serving.recovery.RetryPolicy`: an attempt
    bound (``max_attempts``) plus jittered backoff (``delay_s``),
    escalating — raising, shedding, or quarantining — once retries
    exhaust.

    Flags, in serving/ only: a constant-true ``while`` loop whose
    body has a ``try`` around a ``torch.*`` or socket/HTTP I/O call
    with a broad handler (bare / ``Exception`` / ``BaseException`` /
    ``OSError`` family) that reaches the next iteration with NO
    bounded escape — no ``raise`` / ``return`` / ``break`` anywhere
    in the handler — while the loop nowhere references the bounded-
    retry spelling (``retry_policy`` / ``max_attempts`` /
    ``delay_s``).  Service loops with external termination
    (``while not self._stop``) are not constant-true and never
    flagged."""

    id = "RETRY-BACKOFF"

    _BROAD = frozenset({"Exception", "BaseException", "OSError",
                        "IOError", "ConnectionError", "TimeoutError",
                        "socket.error", "socket.timeout"})
    _BOUNDED = frozenset({"retry_policy", "max_attempts", "delay_s"})

    def applies_to(self, relpath: str) -> bool:
        return _in_serving(relpath)

    def check(self, tree, lines, relpath):
        findings: List[Finding] = []
        rule = self

        def _walk_no_defs(node):
            """The loop-iteration view: nested defs/lambdas run on
            their own schedule, so nothing inside them retries (or
            bounds) THIS loop."""
            yield node
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef,
                                      ast.Lambda)):
                    continue
                yield from _walk_no_defs(child)

        def _risky_call(try_node) -> Optional[str]:
            for stmt in try_node.body:
                for n in _walk_no_defs(stmt):
                    if not isinstance(n, ast.Call):
                        continue
                    name = dotted_name(n.func) or ""
                    if name.startswith("torch."):
                        return name
                    if name.rsplit(".", 1)[-1] in _SOCKET_IO:
                        return name or "socket I/O"
            return None

        def _broad(t) -> bool:
            if t is None:
                return True
            elts = t.elts if isinstance(t, ast.Tuple) else [t]
            return any((dotted_name(el) or "") in rule._BROAD
                       for el in elts)

        def _escapes(handler) -> bool:
            return any(isinstance(n, (ast.Raise, ast.Return,
                                      ast.Break))
                       for n in _walk_no_defs(handler))

        def _bounded(loop) -> bool:
            for n in _walk_no_defs(loop):
                if isinstance(n, ast.Attribute) \
                        and n.attr in rule._BOUNDED:
                    return True
                if isinstance(n, ast.Name) \
                        and n.id in rule._BOUNDED:
                    return True
            return False

        class V(_ScopedVisitor):
            def visit_While(self, node):
                if isinstance(node.test, ast.Constant) \
                        and bool(node.test.value) \
                        and not _bounded(node):
                    for n in _walk_no_defs(node):
                        if isinstance(n, ast.Try):
                            self._check_try(n)
                self.generic_visit(node)

            def _check_try(self, t) -> None:
                risky = _risky_call(t)
                if risky is None:
                    return
                for h in t.handlers:
                    if _broad(h.type) and not _escapes(h):
                        findings.append(Finding(
                            rule.id, relpath, h.lineno, self.func,
                            _src_line(lines, h.lineno),
                            f"unbounded while-True retry around "
                            f"{risky}: a permanent failure spins "
                            f"forever with no error surfaced — "
                            f"bound it with the shared RetryPolicy "
                            f"(attempt < max_attempts + delay_s "
                            f"backoff; serving/recovery.py) and "
                            f"escalate once retries exhaust"))
                        return

        V().visit(tree)
        return findings

RULES = (RetryBackoffRule(),)
