"""EXC-SWALLOW: no silently dropped errors.

The port's own copy of ``polyaxon_tpu/analysis/rules/exc_swallow.py``
(stdlib only, kept here so the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import ast
from typing import List

from ._base import Finding, Rule, _ScopedVisitor, _src_line, \
    dotted_name


class ExcSwallowRule(Rule):
    """``except Exception: pass`` — or ``continue`` — (body is only
    control flow) silently drops errors.  The ``continue`` form is
    the loop-sweep variant the request-lifecycle paths invite: an
    eviction/cancellation sweep that swallows per-item errors and
    moves on leaks the very slots it exists to reclaim, invisibly.
    Best-effort teardown belongs in the committed baseline with a
    justification; everything else must at least log at debug level
    so a broken subsystem is diagnosable."""

    id = "EXC-SWALLOW"

    def check(self, tree, lines, relpath):
        findings: List[Finding] = []
        rule = self

        class V(_ScopedVisitor):
            def visit_ExceptHandler(self, node):
                if self._broad(node.type) and all(
                        isinstance(s, (ast.Pass, ast.Continue))
                        for s in node.body):
                    what = "continue" if any(
                        isinstance(s, ast.Continue)
                        for s in node.body) else "pass"
                    findings.append(Finding(
                        rule.id, relpath, node.lineno, self.func,
                        _src_line(lines, node.lineno),
                        f"except-and-{what} drops the error without "
                        f"a trace; log it (debug level is enough) or "
                        f"baseline it as best-effort teardown"))
                self.generic_visit(node)

            @staticmethod
            def _broad(t) -> bool:
                if t is None:
                    return True
                names = [dotted_name(el) for el in t.elts] \
                    if isinstance(t, ast.Tuple) else [dotted_name(t)]
                return any(n in ("Exception", "BaseException")
                           for n in names)

        V().visit(tree)
        return findings

RULES = (ExcSwallowRule(),)
