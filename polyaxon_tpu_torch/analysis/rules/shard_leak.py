"""SHARD-LEAK: meshed-serving placement discipline.

The port's own copy of ``polyaxon_tpu/analysis/rules/shard_leak.py``,
kept so the catalog's ids and order match the reference's.  It waits
for **Parallelism and meshes** (ROADMAP Queue 1): the port has no
``serving/meshed.py`` yet, so :meth:`ShardLeakRule.applies_to` matches
only that module, which no file of the port is, and the rule's sinks
stay the reference's until that item retargets them to the port's
mesh placement.
"""

from __future__ import annotations

import ast
import re
from typing import List

from ._base import Finding, Rule, _ScopedVisitor, _in_serving, \
    _src_line, dotted_name


# Serving KV-pool state attrs whose allocation must flow through the
# mesh-aware allocator helpers (slots._alloc_stacked /
# paged._alloc_pool commit pools to their NamedShardings at birth).
_POOL_STATE_ATTRS = {"_stacked", "_draft_stacked", "_pool",
                     "_draft_pool"}
_ZEROS_FAMILY = {"zeros", "ones", "full", "empty", "zeros_like",
                 "ones_like", "full_like"}
_ALLOC_HELPERS = re.compile(r"(^|\.)(_alloc|_ensure)")


class ShardLeakRule(Rule):
    """Meshed-serving placement discipline (serving/meshed.py).

    A meshed engine's step programs compile with explicit in/out
    shardings over committed operands; a host-built array placed
    UNCOMMITTED (``jax.device_put(x)`` with no sharding) lands on the
    default device, and feeding it to a mesh-compiled program forces
    a transfer/reshard on every call — invisible steady-state tax
    that profiles as mystery step latency.  The sanctioned spellings
    are ``device_put(x, sharding)`` / ``ServingMesh.put_replicated``
    (committed), or keeping the array host-side and letting the
    program's explicit ``in_shardings`` place it.  Pool-state
    allocations (``self._stacked = jnp.zeros(...)``) must go through
    the ``_alloc*``/``_ensure*`` helpers for the same reason: a pool
    born unsharded silently demotes every subsequent step to
    replicated layout."""

    id = "SHARD-LEAK"

    def applies_to(self, relpath: str) -> bool:
        # Only the meshed server, which Parallelism and meshes ports.
        return _in_serving(relpath) and relpath.endswith(
            "serving/meshed.py")

    def check(self, tree, lines, relpath):
        findings: List[Finding] = []
        rule = self

        class V(_ScopedVisitor):
            def _flag(self, node, msg):
                findings.append(Finding(
                    rule.id, relpath, node.lineno, self.func,
                    _src_line(lines, node.lineno), msg))

            def visit_Call(self, node):
                name = dotted_name(node.func) or ""
                tail = name.rsplit(".", 1)[-1]
                if tail == "device_put" and len(node.args) == 1 \
                        and not node.keywords:
                    self._flag(
                        node,
                        "single-argument device_put places the array "
                        "UNCOMMITTED on the default device; fed to a "
                        "mesh-compiled program that costs a transfer "
                        "per call — pass a NamedSharding (or "
                        "ServingMesh.put_replicated)")
                self.generic_visit(node)

            def visit_Assign(self, node):
                if not _ALLOC_HELPERS.search(self.func):
                    for t in node.targets:
                        if isinstance(t, ast.Attribute) and \
                                t.attr in _POOL_STATE_ATTRS and \
                                self._allocates(node.value):
                            self._flag(
                                node,
                                f"KV-pool state ({t.attr}) allocated "
                                f"outside the _alloc*/_ensure* "
                                f"helpers: pools must be committed "
                                f"to their mesh shardings at birth "
                                f"(an unsharded pool demotes every "
                                f"step to replicated layout)")
                self.generic_visit(node)

            @staticmethod
            def _allocates(value) -> bool:
                for n in ast.walk(value):
                    if isinstance(n, ast.Call):
                        name = dotted_name(n.func) or ""
                        if name.rsplit(".", 1)[-1] in _ZEROS_FAMILY:
                            return True
                return False

        V().visit(tree)
        return findings

RULES = (ShardLeakRule(),)
