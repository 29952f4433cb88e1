"""SOCKET-TIMEOUT: explicit timeouts on every outbound network call.

The port's own copy of ``polyaxon_tpu/analysis/rules/socket_timeout.py``
(stdlib only, kept here so the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import ast
from typing import List

from ._base import Finding, Rule, _ScopedVisitor, _in_serving, \
    _src_line, dotted_name


class SocketTimeoutRule(Rule):
    """Explicit timeouts on every outbound network call in serving/.

    The router tier probes replicas and forwards requests over plain
    sockets; a ``socket.create_connection`` / ``urllib.request.
    urlopen`` / ``http.client.HTTPConnection`` call WITHOUT an
    explicit timeout inherits the global default (None = block
    forever) — and a timeout-less probe against a hung replica is
    how the whole ROUTER wedges: one dead endpoint collects the
    probe thread, then the handler threads, and the healthy fleet
    behind the router goes dark with it (the arXiv:2011.03641
    pathology moved up a tier).  Every outbound call must pass
    ``timeout=`` (or the positional timeout its signature defines).

    Flagged call shapes (by trailing name): ``create_connection``
    (timeout is the 2nd positional), ``urlopen`` (3rd), and the
    ``HTTPConnection``/``HTTPSConnection`` constructors (kwarg).  A
    visible timeout — positional in the right slot or ``timeout=``
    anywhere — clears the finding; reading the VALUE is out of scope
    (a named constant is fine, and ``timeout=None`` spelled out at
    least shows intent at the call site)."""

    id = "SOCKET-TIMEOUT"

    # tail -> minimum positional-arg count that covers the timeout
    # slot (0 = keyword-only for this shape).
    _SHAPES = {"create_connection": 2, "urlopen": 3,
               "HTTPConnection": 0, "HTTPSConnection": 0}

    def applies_to(self, relpath: str) -> bool:
        return _in_serving(relpath)

    def check(self, tree, lines, relpath):
        findings: List[Finding] = []
        rule = self

        class V(_ScopedVisitor):
            def visit_Call(self, node):
                name = dotted_name(node.func) or ""
                tail = name.rsplit(".", 1)[-1]
                pos_slot = rule._SHAPES.get(tail)
                if pos_slot is not None:
                    has_kw = any(kw.arg == "timeout"
                                 for kw in node.keywords)
                    has_pos = pos_slot > 0 \
                        and len(node.args) >= pos_slot
                    if not has_kw and not has_pos:
                        findings.append(Finding(
                            rule.id, relpath, node.lineno, self.func,
                            _src_line(lines, node.lineno),
                            f"{tail} without an explicit timeout: "
                            f"the default blocks forever, and a "
                            f"timeout-less probe/forward against a "
                            f"hung replica wedges the router (and "
                            f"every healthy replica behind it) — "
                            f"pass timeout= at the call site"))
                self.generic_visit(node)

        V().visit(tree)
        return findings

RULES = (SocketTimeoutRule(),)
