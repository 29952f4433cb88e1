"""SHARD-LEAK: meshed-serving placement discipline.

The port's own copy of ``polyaxon_tpu/analysis/rules/shard_leak.py``,
retargeted to the port's placement (``serving/meshed.py``), where the
reference's sinks are ``jax.device_put`` with no sharding and a pool
array allocated outside the mesh-aware allocators:

- in ``serving/meshed.py``, a tensor MOVED to a device (``.to(dev)``,
  ``.cuda()``, an allocation with ``device=``) outside the placement
  helpers (``place_*``, ``stacked_pool``, ``gather``): every shard is
  placed once, by the helpers, so a stray move is either a copy the
  layout did not plan or a shard landing on the wrong device;
- in ``serving/meshed.py``, ``slots.py`` and ``paged.py``, KV-pool state
  (``_pool``/``_dpool``/``_pools``/``_dpools``) allocated outside the
  ``_alloc*``/``_ensure*`` helpers, which allocate a meshed pool per
  device at birth (``ServingMesh.stacked_pool``, the paged pool's
  per-shard pools): a pool born anywhere else is born whole on one
  device, and the mesh's memory win silently disappears.
"""

from __future__ import annotations

import ast
import re
from typing import List

from ._base import Finding, Rule, _ScopedVisitor, _in_serving, \
    _src_line, dotted_name


# Serving KV-pool state attrs whose allocation must flow through the
# mesh-aware allocator helpers.
_POOL_STATE_ATTRS = {"_pool", "_dpool", "_pools", "_dpools"}
# Calls that allocate a pool: torch's zeros family and the caches'
# and the mesh's pool builders.
_ALLOCATORS = {"zeros", "ones", "full", "empty", "zeros_like",
               "ones_like", "full_like", "stacked", "stacked_pool",
               "place_cache", "_stacked_like", "_alloc_pool"}
_ALLOC_HELPERS = re.compile(r"(^|\.)(_alloc|_ensure)")
# ServingMesh's placement helpers (any enclosing function).
_PLACEMENT_HELPERS = re.compile(
    r"(^|\.)(place_\w*|stacked_pool|gather)(\.|$)")
_MODULES = ("serving/meshed.py", "serving/slots.py", "serving/paged.py")


def _device_like(node) -> bool:
    """An argument that names a device: ``torch.device(...)`` or a
    name/attribute spelled with ``dev`` or ``primary``."""
    if isinstance(node, ast.Call):
        return (dotted_name(node.func) or "").endswith("device")
    name = dotted_name(node) or ""
    tail = name.rsplit(".", 1)[-1].lower()
    return "dev" in tail or "primary" in tail


class ShardLeakRule(Rule):
    """Meshed-serving placement discipline (serving/meshed.py)."""

    id = "SHARD-LEAK"

    def applies_to(self, relpath: str) -> bool:
        # The meshed placement and the two slot pools it allocates.
        return _in_serving(relpath) and relpath.endswith(_MODULES)

    def check(self, tree, lines, relpath):
        findings: List[Finding] = []
        rule = self
        meshed = relpath.endswith("serving/meshed.py")

        class V(_ScopedVisitor):
            def _flag(self, node, msg):
                findings.append(Finding(
                    rule.id, relpath, node.lineno, self.func,
                    _src_line(lines, node.lineno), msg))

            def visit_Call(self, node):
                if meshed and not _PLACEMENT_HELPERS.search(self.func) \
                        and self._moves(node):
                    self._flag(
                        node,
                        "tensor moved to a device outside ServingMesh's "
                        "placement helpers (place_*/stacked_pool/"
                        "gather): each shard is placed once, by them — "
                        "a stray move is an unplanned copy or a shard "
                        "on the wrong device")
                self.generic_visit(node)

            @staticmethod
            def _moves(node) -> bool:
                func = node.func
                if isinstance(func, ast.Attribute) and func.attr == "cuda":
                    return True
                if any(k.arg == "device" and _device_like(k.value)
                       for k in node.keywords):
                    return True
                return isinstance(func, ast.Attribute) \
                    and func.attr == "to" and bool(node.args) \
                    and _device_like(node.args[0])

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
                                f"helpers: a meshed pool is allocated "
                                f"per device at birth there (a pool "
                                f"born whole on one device loses the "
                                f"mesh's memory split)")
                self.generic_visit(node)

            @staticmethod
            def _allocates(value) -> bool:
                for n in ast.walk(value):
                    if isinstance(n, ast.Call):
                        name = dotted_name(n.func) or ""
                        if name.rsplit(".", 1)[-1] in _ALLOCATORS:
                            return True
                return False

        V().visit(tree)
        return findings


RULES = (ShardLeakRule(),)
