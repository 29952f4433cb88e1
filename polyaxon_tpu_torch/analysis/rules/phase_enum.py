"""PHASE-ENUM: closed phase vocabulary for the tail-latency ledger.

The port's own copy of ``polyaxon_tpu/analysis/rules/phase_enum.py``
(stdlib only, kept here so the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import ast
from typing import List

from ._base import Finding, Rule, _ScopedVisitor, _in_serving, \
    _src_line, dotted_name


class PhaseEnumRule(Rule):
    """Closed phase vocabulary for the tail-latency ledger
    (serving/forensics.py).

    The phase ledger's whole value is that every surface — history
    record, ``timings`` block, stitched fleet timeline, /metrics
    gauges, the anomaly sentry — speaks ONE enum: the ``PHASE_*``
    constants in forensics.py.  A consumer that hand-writes
    ``"queue_wait"`` instead of importing ``PHASE_QUEUE_WAIT``
    compiles today and silently stops matching the day the enum is
    renamed or extended — dashboards join on a name that no longer
    exists, and nothing errors.  Flagged in serving/ outside
    forensics.py: any string literal spelling a phase-enum member.

    Deliberately narrow: only the phase names UNIQUE to the ledger
    vocabulary are flagged — ``prefill``/``decode``/``kv_handoff``/
    ``prefill_remote`` double as span names all over the stack and
    cannot be flagged without drowning the signal.  The test suite
    pins this rule's set against the live enum (tests/
    test_analysis.py), so a new phase constant that is not also a
    span name must be added here or the suite fails."""

    id = "PHASE-ENUM"

    # PHASES + ROUTER_PHASES minus the names shared with the span
    # vocabulary (prefill, decode, kv_handoff, prefill_remote).
    _PHASE_LITERALS = frozenset({
        "queue_wait", "device_lock_wait", "admit_wait",
        "kv_wire_fetch", "preempt_gap", "finalize", "unattributed",
        "route_pick", "replica_attempt", "retry_backoff",
    })

    def applies_to(self, relpath: str) -> bool:
        return _in_serving(relpath) \
            and not relpath.endswith("forensics.py")

    def check(self, tree, lines, relpath):
        findings: List[Finding] = []
        rule = self

        class V(_ScopedVisitor):
            def visit_Constant(self, node):
                if isinstance(node.value, str) \
                        and node.value in rule._PHASE_LITERALS:
                    findings.append(Finding(
                        rule.id, relpath, node.lineno, self.func,
                        _src_line(lines, node.lineno),
                        f"phase name {node.value!r} written as a "
                        f"string literal: import the PHASE_* "
                        f"constant from serving/forensics.py — a "
                        f"hand-spelled phase silently stops "
                        f"matching when the enum changes (the "
                        f"ledger partition is only auditable "
                        f"because every surface speaks ONE "
                        f"vocabulary)"))
                self.generic_visit(node)

        V().visit(tree)
        return findings

RULES = (PhaseEnumRule(),)
