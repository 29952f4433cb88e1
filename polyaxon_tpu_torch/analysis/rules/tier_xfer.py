"""TIER-XFER: tiered-KV device<->host transfer discipline.

The port's own copy of ``polyaxon_tpu/analysis/rules/tier_xfer.py``,
retargeted from JAX to torch.  The reference's sinks were
``jax.device_put`` / ``jax.device_get`` of page payloads; here they are
the torch spellings of the same transfer: ``x.cpu()``, ``x.cuda()``,
``x.to(<device>)`` (a ``device=`` keyword, a ``torch.device(...)``, a
``"cpu"`` / ``"cuda"`` string or a ``*.device`` attribute — a dtype
cast is not a transfer) and ``dst.copy_(src)`` where one side is
evidently on the other device (``.cpu()``, ``.cuda()``,
``torch.from_numpy``, ``.pin_memory()`` or a ``.to(<device>)`` in it).
The sanctioned helper set is the reference's, and the port's
``serving/paged.py`` defines the same helpers (``spill_pages``,
``rematerialize``, ``materialize``, ``_alloc_pool``,
``scatter_cache``).
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional

from ._base import Finding, Rule, _ScopedVisitor, _in_serving, \
    _src_line, dotted_name


# Identifier shapes that name page-pool payload state: the pools
# themselves (_pool/_draft_pool/pool), page-id collections
# (pages/page_tables/shared_pages), and page-granular leaves.
_TIER_NAMES = re.compile(
    r"(^|_)(pages?|pools?)($|_)|page_table")

# The sanctioned tiered-memory helpers (serving/paged.py): the ONLY
# functions allowed to move page-pool payloads across the
# device<->host boundary.  Matched against the innermost enclosing
# function name.
_TIER_SANCTIONED = {"spill_pages", "rematerialize", "materialize",
                    "_alloc_pool", "scatter_cache"}


class TierXferRule(Rule):
    """Tiered-KV transfer discipline (serving/paged.py host tier).

    The two-tier prefix store moves page payloads device->host only
    through ``spill_pages`` (page-pressure reclaim) and host->device
    only through ``rematerialize``/``scatter_cache`` (prefix-hit
    admission / promotion) — both OFF the decode step path.  A stray
    ``.cpu()`` / ``.cuda()`` / ``.to(device)`` / cross-device
    ``copy_`` whose operand touches pool/page state is a page-sized
    PCIe transfer on whatever path it sits; on the step path it is a
    silent TTFT cliff.  Flagged in serving/ outside the sanctioned
    helper set."""

    id = "TIER-XFER"

    def applies_to(self, relpath: str) -> bool:
        return _in_serving(relpath)

    @staticmethod
    def _touches_pool(node: ast.AST) -> Optional[str]:
        for n in ast.walk(node):
            if isinstance(n, ast.Attribute) \
                    and _TIER_NAMES.search(n.attr):
                return n.attr
            if isinstance(n, ast.Name) \
                    and _TIER_NAMES.search(n.id):
                return n.id
        return None

    @staticmethod
    def _device_arg(node: ast.AST) -> bool:
        """Does this ``.to(...)`` argument name a device?"""
        if isinstance(node, ast.Constant):
            return isinstance(node.value, str) and \
                node.value.split(":", 1)[0] in ("cpu", "cuda")
        if isinstance(node, ast.Call):
            return dotted_name(node.func) in ("torch.device", "device")
        name = dotted_name(node) or ""
        return name.rsplit(".", 1)[-1] in ("device", "dev")

    @classmethod
    def _moves(cls, call: ast.Call) -> bool:
        """A ``.cpu()`` / ``.cuda()`` / ``.to(<device>)`` call."""
        if not isinstance(call.func, ast.Attribute):
            return False
        tail = call.func.attr
        if tail in ("cpu", "cuda"):
            return True
        if tail == "to":
            return any(kw.arg == "device" for kw in call.keywords) \
                or any(cls._device_arg(a) for a in call.args)
        return False

    @classmethod
    def _other_device(cls, node: ast.AST) -> bool:
        """Is ``node`` evidently on the other side of a transfer?"""
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                tail = (dotted_name(n.func) or "").rsplit(".", 1)[-1]
                if tail in ("from_numpy", "pin_memory") or cls._moves(n):
                    return True
        return False

    def _operands(self, node: ast.Call) -> List[ast.AST]:
        """The page payloads a transfer call moves, or []."""
        if not isinstance(node.func, ast.Attribute):
            return []
        if self._moves(node):
            return [node.func.value]
        if node.func.attr == "copy_" and node.args:
            sides = [node.func.value, node.args[0]]
            if any(self._other_device(sd) for sd in sides):
                return sides
        return []

    def check(self, tree, lines, relpath):
        findings: List[Finding] = []
        rule = self

        class V(_ScopedVisitor):
            def visit_Call(self, node):
                operands = rule._operands(node)
                if operands:
                    tail = node.func.attr
                    inner = self._stack[-1] if self._stack else ""
                    if inner not in _TIER_SANCTIONED:
                        for arg in operands:
                            hit = rule._touches_pool(arg)
                            if hit:
                                findings.append(Finding(
                                    rule.id, relpath, node.lineno,
                                    self.func,
                                    _src_line(lines, node.lineno),
                                    f".{tail}() of page-pool payload "
                                    f"({hit}) outside the sanctioned "
                                    f"tiered-memory helpers "
                                    f"({', '.join(sorted(_TIER_SANCTIONED))})"
                                    f": page-sized device<->host "
                                    f"transfers belong to the spill/"
                                    f"re-materialize tier — on the "
                                    f"step path this is a silent "
                                    f"TTFT cliff"))
                                break
                self.generic_visit(node)

        V().visit(tree)
        return findings

RULES = (TierXferRule(),)
