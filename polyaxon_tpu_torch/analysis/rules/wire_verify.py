"""WIRE-VERIFY: checksum discipline on wire-payload admission.

The port's own copy of ``polyaxon_tpu/analysis/rules/wire_verify.py``
(stdlib only, kept here so the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import ast
from typing import Any, Dict, List, Tuple

from ._base import Finding, Rule, _ScopedVisitor, _in_serving, \
    _src_line, dotted_name


class WireVerifyRule(Rule):
    """Checksum discipline on wire-payload admission (serving/
    paged.py fleet wire format).

    Every payload that crosses the fleet wire — a ``/prefix/fetch``
    response, a handoff push, a disagg KV admission — is a
    length-prefixed header plus raw C-order buffers, and the header
    carries a crc32 over the buffer body.  The ONLY safe way to
    admit one is ``unpack_spilled``, which verifies that checksum
    and raises the typed ``WirePayloadError`` on mismatch (HTTP 400
    ``payload_integrity``, degrade-to-re-prefill).  A hand-rolled
    decode — ``np.frombuffer`` over wire bytes in a function that
    neither calls ``crc32`` itself nor goes through
    ``unpack_spilled`` — admits whatever a truncated proxy response
    or a torn socket handed it, and the corruption surfaces later as
    silently wrong KV (wrong tokens, not an error).  Flagged in
    serving/: any ``frombuffer`` call whose enclosing function
    contains neither a ``crc32`` call nor an ``unpack_spilled``
    call."""

    id = "WIRE-VERIFY"

    _VERIFIERS = frozenset({"crc32", "unpack_spilled"})

    def applies_to(self, relpath: str) -> bool:
        return _in_serving(relpath)

    def check(self, tree, lines, relpath):
        findings: List[Finding] = []
        rule = self
        # Calls grouped by INNERMOST enclosing def.  The
        # verification scope is the LEXICAL chain: a closure decodes
        # under its enclosing function's crc32 (one body, one
        # payload), but a sibling top-level helper does not — it can
        # be called from anywhere, so a crc32 in one caller blesses
        # nothing.
        scopes: Dict[Tuple[str, ...], Dict[str, Any]] = {}

        class V(_ScopedVisitor):
            def visit_Call(self, node):
                key = tuple(self._stack)
                sc = scopes.setdefault(
                    key, {"func": self.func, "tails": set(),
                          "hits": []})
                name = dotted_name(node.func) or ""
                tail = name.rsplit(".", 1)[-1]
                sc["tails"].add(tail)
                if tail == "frombuffer":
                    sc["hits"].append(node)
                self.generic_visit(node)

        V().visit(tree)
        for key, sc in scopes.items():
            if not sc["hits"]:
                continue
            chain_tails = set()
            for k in range(len(key) + 1):
                outer = scopes.get(key[:k])
                if outer is not None:
                    chain_tails |= outer["tails"]
            if rule._VERIFIERS & chain_tails:
                continue
            for node in sc["hits"]:
                findings.append(Finding(
                    rule.id, relpath, node.lineno, sc["func"],
                    _src_line(lines, node.lineno),
                    "frombuffer over wire payload without a "
                    "checksum verify in the same function: admit "
                    "fleet-wire bytes through unpack_spilled (or "
                    "verify crc32 here) — an unverified decode "
                    "turns a truncated/torn transfer into silently "
                    "wrong KV instead of the typed "
                    "payload_integrity degrade"))
        return findings

RULES = (WireVerifyRule(),)
