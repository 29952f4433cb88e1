"""JIT-DEADLINE: lifecycle control stays host-side — no ``time.*``
calls at all inside CUDA-graph captures.

The port's own copy of ``polyaxon_tpu/analysis/rules/jit_deadline.py``,
retargeted from ``jax.jit`` bodies to CUDA-graph capture bodies
(``_jit._collect_captured``).
"""

from __future__ import annotations

import ast
from typing import List

from ._base import Finding, Rule, _src_line, dotted_name
from ._jit import _collect_captured


class DeadlineInJitRule(Rule):
    """Lifecycle control stays HOST-SIDE: no ``time.*`` deadline math
    inside a captured step program.

    The request-lifecycle layer (serving/engine.py sweep) delivers
    cancellation, deadline expiry, and preemption at step boundaries
    by comparing host wall-clock against per-group deadlines.  Any
    ``time.*`` call inside a captured body — not just the clocks
    JIT-PURITY flags, but ALL of the module (``time_ns``,
    ``monotonic_ns``, ``sleep``, ``strftime`` ...) — executes once at
    capture time and is absent from every replay: a deadline
    comparison there would evaluate exactly once and never fire
    again, silently turning "evict at the boundary" into "immortal".
    This is the Podracer decoupled-dataflow discipline
    (arXiv:2104.06272): scheduling decisions on the host, pure math
    on the device."""

    id = "JIT-DEADLINE"

    def check(self, tree, lines, relpath):
        findings: List[Finding] = []
        for body, label in _collect_captured(tree):
            for node in ast.walk(body):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func) or ""
                if name.startswith("time."):
                    findings.append(Finding(
                        self.id, relpath, node.lineno, label,
                        _src_line(lines, node.lineno),
                        f"{name}() inside a CUDA-graph capture: "
                        f"deadline/lifecycle math is host-side "
                        f"scheduling — it runs once at capture time "
                        f"and never in a replay, so a deadline check "
                        f"here would evaluate once and never fire "
                        f"again"))
        return findings

RULES = (DeadlineInJitRule(),)
