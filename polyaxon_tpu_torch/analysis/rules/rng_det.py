"""RNG-DET: position-keyed RNG discipline in serving-critical paths.

The port's own copy of ``polyaxon_tpu/analysis/rules/rng_det.py``,
retargeted from ``jax.random`` to the port's ``prng`` module (jax's
threefry on torch): the split sink is ``prng.split`` and the fresh-key
sink ``prng.PRNGKey``, under the same position-keyed ``fold_in``
contract.  The port adds one sink the reference has no analogue of: a
draw from torch's global generator (``torch.rand*``,
``torch.multinomial``, ``torch.normal``, ``torch.bernoulli`` with no
``generator=``), whose values depend on every draw made before it in
the process.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional

from ._base import Finding, Rule, _ScopedVisitor, _in_serving, \
    _src_line, dotted_name


class RngDetRule(Rule):
    """Position-keyed RNG only in serving-critical paths.

    Flags ``prng.split`` and fresh ``PRNGKey(...)``
    construction, UNLESS the key is immediately position-keyed: the
    ``PRNGKey`` call sits inside a ``fold_in(...)`` argument, or is
    assigned to a name that is passed to ``fold_in`` within the same
    function.  Guards the contract that a stream's i-th token key is
    ``fold_in(fold_in(PRNGKey(seed), row), i)`` — a function of the
    request alone — so co-tenancy and admission order can never
    change sampled tokens (docs/SERVING.md).  Also flags a draw from
    torch's process-wide generator (``torch.rand``, ``torch.randn``,
    ``torch.randint``, ``torch.randperm``, their ``_like`` forms,
    ``torch.multinomial``, ``torch.normal``, ``torch.bernoulli``)
    without ``generator=``: its values depend on every other draw in
    the process, which is exactly the co-tenancy leak the contract
    forbids."""

    id = "RNG-DET"

    _SPLIT = re.compile(r"(^|\.)prng\.split$")
    _GLOBAL_DRAWS = frozenset({
        "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
        "torch.rand_like", "torch.randn_like", "torch.randint_like",
        "torch.multinomial", "torch.normal", "torch.bernoulli"})

    def applies_to(self, relpath: str) -> bool:
        return _in_serving(relpath) or \
            relpath.endswith("models/generate.py")

    def check(self, tree, lines, relpath):
        findings: List[Finding] = []
        rule = self

        class V(_ScopedVisitor):
            def visit_Call(self, node):
                name = dotted_name(node.func)
                if name is not None:
                    if rule._SPLIT.search(name):
                        findings.append(Finding(
                            rule.id, relpath, node.lineno, self.func,
                            _src_line(lines, node.lineno),
                            "prng.split chains make token "
                            "values depend on the draw schedule; use "
                            "position-keyed fold_in "
                            "(sample_stream_keys)"))
                    elif name in rule._GLOBAL_DRAWS and not any(
                            kw.arg == "generator"
                            for kw in node.keywords):
                        findings.append(Finding(
                            rule.id, relpath, node.lineno, self.func,
                            _src_line(lines, node.lineno),
                            f"{name} without generator= draws from "
                            f"torch's process-wide generator: its "
                            f"values depend on every other draw in the "
                            f"process; draw from a position-keyed prng "
                            f"key instead"))
                    elif name.endswith("PRNGKey") and \
                            not self._folded(node):
                        findings.append(Finding(
                            rule.id, relpath, node.lineno, self.func,
                            _src_line(lines, node.lineno),
                            "fresh PRNGKey outside a fold_in: "
                            "serving-path draws must be "
                            "position-keyed (fold_in(PRNGKey(seed), "
                            "row) ... fold_in(base, index))"))
                self.generic_visit(node)

            def _folded(self, node) -> bool:
                # Only fold_in calls in the SAME enclosing function
                # count (module-wide matching would let any unrelated
                # fold_in elsewhere in the file launder a fresh key).
                local = [c for c in self._fold_calls
                         if self._fn_of.get(id(c))
                         is self._fn_of.get(id(node))]
                # (a) nested directly inside a fold_in(...) call
                for anc_call in local:
                    for arg in ast.walk(anc_call):
                        if arg is node:
                            return True
                # (b) assigned to a name folded in the same function
                tgt = self._assign_target(node)
                if tgt is not None:
                    for call in local:
                        for arg in call.args:
                            if isinstance(arg, ast.Name) and \
                                    arg.id == tgt:
                                return True
                return False

            def _assign_target(self, node) -> Optional[str]:
                parent = self._parents.get(node)
                if isinstance(parent, ast.Assign) and \
                        len(parent.targets) == 1 and \
                        isinstance(parent.targets[0], ast.Name):
                    return parent.targets[0].id
                return None

        v = V()
        # Pre-pass: every fold_in call, a child->parent map, and each
        # node's enclosing FunctionDef (lambdas don't open a scope —
        # a fold_in inside a vmapped lambda still belongs to the def
        # that wrote it), so the "immediately folded" exemption can
        # look up and sideways WITHIN one function only.
        v._fold_calls = [
            n for n in ast.walk(tree)
            if isinstance(n, ast.Call)
            and (dotted_name(n.func) or "").endswith("fold_in")]
        v._parents = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                v._parents[child] = parent

        def fn_of(n):
            n = v._parents.get(n)
            while n is not None and not isinstance(
                    n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                n = v._parents.get(n)
            return n

        v._fn_of = {id(n): fn_of(n) for n in ast.walk(tree)}
        v.visit(tree)
        return findings

RULES = (RngDetRule(),)
