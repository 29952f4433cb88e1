"""PAGE-REF: paged-KV page-pool accounting discipline.

The port's own copy of ``polyaxon_tpu/analysis/rules/page_ref.py``
(stdlib only, kept here so the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional

from ._base import (Finding, Rule, _ScopedVisitor, _in_serving,
                    _src_line, dotted_name)


_PAGE_POOL_MODULE = "serving/paged.py"
_PAGE_POOL_LOCK = re.compile(r"(^|_)page_lock$")
_PAGE_INTERNALS = {"refcounts", "_free_pages", "page_tables"}
_PAGE_MUTABLE = {"refcounts", "_free_pages"}
_LIST_MUTATORS = {"append", "pop", "remove", "extend", "insert",
                  "clear"}


class PageRefRule(Rule):
    """Paged-KV page-pool discipline (serving/paged.py).

    The page pool's accounting state — ``refcounts`` and the
    ``_free_pages`` list — is mutated from handler threads (prefix
    pin/unpin) AND the engine thread (admission reserve, eviction
    release), so every mutation must sit under the pool's
    ``_page_lock``; a lockless bump is a lost-update seed that frees
    a page still mapped into a co-tenant's table (the stale-KV leak
    class the page-poison tests pin).  And the pool's internals are
    PRIVATE to the pool module: outside it, code must go through the
    accounting API (``pin``/``unpin``/``try_reserve``/``can_admit``)
    — flagged are (a) inside the pool module, ``refcounts`` /
    ``_free_pages`` mutations not lexically under a ``with
    *page_lock`` block; (b) outside it, ANY access to ``refcounts`` /
    ``_free_pages`` / ``page_tables`` attributes; (c) outside it, raw
    integer page-index literals passed to ``pin``/``unpin`` — page
    ids are pool-issued handles, never constants."""

    id = "PAGE-REF"

    def applies_to(self, relpath: str) -> bool:
        return _in_serving(relpath)

    def check(self, tree, lines, relpath):
        in_pool = relpath.replace("\\", "/").endswith(
            _PAGE_POOL_MODULE)
        parents: Dict[ast.AST, ast.AST] = {}
        for p in ast.walk(tree):
            for c in ast.iter_child_nodes(p):
                parents[c] = p

        def _tail_attr(node) -> Optional[str]:
            """The attribute name at the base of a target chain:
            ``self.refcounts[i]`` -> ``refcounts``."""
            while isinstance(node, ast.Subscript):
                node = node.value
            if isinstance(node, ast.Attribute):
                return node.attr
            return None

        def _locked(node) -> bool:
            """A ``with *page_lock`` ancestor BELOW the nearest
            enclosing function def — a with-block outside the def
            doesn't protect code that runs later."""
            n = parents.get(node)
            while n is not None:
                if isinstance(n, (ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.Lambda)):
                    return False
                if isinstance(n, (ast.With, ast.AsyncWith)):
                    for item in n.items:
                        name = dotted_name(item.context_expr) or ""
                        if _PAGE_POOL_LOCK.search(
                                name.rsplit(".", 1)[-1]):
                            return True
                n = parents.get(n)
            return False

        findings: List[Finding] = []
        rule = self

        class V(_ScopedVisitor):
            def _flag(self, node, msg):
                findings.append(Finding(
                    rule.id, relpath, node.lineno, self.func,
                    _src_line(lines, node.lineno), msg))

            def _check_mutation(self, node, target):
                attr = _tail_attr(target)
                if attr in _PAGE_MUTABLE and not _locked(node):
                    self._flag(
                        node,
                        f"page-pool state ({attr}) mutated outside "
                        f"`with _page_lock`: handler threads and the "
                        f"engine thread race here — a lost update "
                        f"frees a page still mapped by a co-tenant")

            def visit_Assign(self, node):
                if in_pool:
                    for t in node.targets:
                        self._check_mutation(node, t)
                self.generic_visit(node)

            def visit_AnnAssign(self, node):
                if in_pool and node.value is not None:
                    self._check_mutation(node, node.target)
                self.generic_visit(node)

            def visit_AugAssign(self, node):
                if in_pool:
                    self._check_mutation(node, node.target)
                self.generic_visit(node)

            def visit_Call(self, node):
                name = dotted_name(node.func) or ""
                tail = name.rsplit(".", 1)[-1]
                if in_pool:
                    # free-list mutation via list methods
                    if tail in _LIST_MUTATORS and \
                            isinstance(node.func, ast.Attribute) and \
                            _tail_attr(node.func.value) in \
                            _PAGE_MUTABLE and not _locked(node):
                        self._flag(
                            node,
                            f"free-list .{tail}() outside `with "
                            f"_page_lock`: page allocation must be "
                            f"race-free")
                elif tail in ("pin", "unpin") and \
                        isinstance(node.func, ast.Attribute):
                    for arg in node.args:
                        for el in ast.walk(arg):
                            if isinstance(el, ast.Constant) and \
                                    isinstance(el.value, int) and \
                                    not isinstance(el.value, bool):
                                self._flag(
                                    node,
                                    f"raw page-index literal "
                                    f"{el.value} passed to "
                                    f".{tail}(): page ids are "
                                    f"pool-issued handles, never "
                                    f"constants")
                                break
                        else:
                            continue
                        break
                self.generic_visit(node)

            def visit_Attribute(self, node):
                if not in_pool and node.attr in _PAGE_INTERNALS:
                    self._flag(
                        node,
                        f"page-pool internal .{node.attr} accessed "
                        f"outside the pool module: use the "
                        f"accounting API (pin/unpin/try_reserve/"
                        f"can_admit/page_stats)")
                self.generic_visit(node)

        V().visit(tree)
        return findings

RULES = (PageRefRule(),)
