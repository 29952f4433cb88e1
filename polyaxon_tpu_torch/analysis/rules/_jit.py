"""The shared capture-body collector: JIT-PURITY and JIT-DEADLINE
both consume it, so the two rules can never disagree about what
"inside a captured program" means.

The port's own copy of ``polyaxon_tpu/analysis/rules/_jit.py``,
retargeted from ``jax.jit`` to CUDA-graph capture.  A jitted body's
Python ran once, at trace time; a captured body's Python runs once, at
capture time, and every replay after it runs only the kernels it
queued.  So the bodies are the callables handed to the step pool's
capture path (the ``body`` of ``StepPool._replay`` / ``_capture`` and
of the ``_dispatch`` / ``_dispatch_spec`` wrappers that forward it),
everything lexically inside a ``with torch.cuda.graph(...)`` block,
and every function those bodies call that resolves in the same module.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ._base import dotted_name

# Capture entry points -> positional index of their ``body`` argument
# (``self`` not counted); ``body=`` as a keyword is matched too.
_CAPTURE_CALLS = {"_replay": 1, "_capture": 0, "_dispatch": 1,
                  "_dispatch_spec": 1}

_SCOPES = (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef,
           ast.ClassDef)


def _is_graph_ctx(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and \
        dotted_name(node.func) in ("torch.cuda.graph", "cuda.graph")


def _collect_captured(tree: ast.Module) -> List[Tuple[ast.AST, str]]:
    """Every captured body in a module as ``[(node, label)]``,
    deduplicated.  A ``body`` argument resolves LEXICALLY, as the
    reference resolves ``jax.jit(fn_name)``: a lambda is its own body,
    a bare name is the innermost def of that name visible from the
    call, and ``self.name`` is the method of the enclosing class.
    Calls inside a body resolve the same way, to a fixpoint, so a
    lambda that calls ``self._body(...)`` brings ``_body`` (and what it
    calls in this module) in with it.  Both rules ask for the same
    tree, so the result is kept on it."""
    cached = getattr(tree, "_ptpu_captured", None)
    if cached is None:
        cached = tree._ptpu_captured = _collect(tree)
    return cached


def _roots(tree: ast.Module) -> List[Tuple[ast.AST, ast.AST]]:
    """``(site, body expr or with-node)`` for every capture site."""
    out: List[Tuple[ast.AST, ast.AST]] = []
    for n in ast.walk(tree):
        if isinstance(n, ast.Call):
            tail = n.func.attr if isinstance(n.func, ast.Attribute) \
                else (dotted_name(n.func) or "")
            idx = _CAPTURE_CALLS.get(tail)
            if idx is None:
                continue
            arg = next((kw.value for kw in n.keywords
                        if kw.arg == "body"), None)
            if arg is None and len(n.args) > idx:
                arg = n.args[idx]
            if arg is not None:
                out.append((n, arg))
        elif isinstance(n, (ast.With, ast.AsyncWith)) and any(
                _is_graph_ctx(it.context_expr) for it in n.items):
            out.append((n, n))
    return out


def _collect(tree: ast.Module) -> List[Tuple[ast.AST, str]]:
    roots = _roots(tree)
    if not roots:
        return []
    parents: Dict[ast.AST, ast.AST] = {}
    for p in ast.walk(tree):
        for c in ast.iter_child_nodes(p):
            parents[c] = p
    scopes: Dict[ast.AST, Dict[str, ast.AST]] = {}
    for n in ast.walk(tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            s = parents.get(n)
            while s is not None and not isinstance(s, _SCOPES):
                s = parents.get(s)
            scopes.setdefault(s, {})[n.name] = n

    def resolve(node: ast.AST, name: str):
        """Innermost def named ``name`` visible from ``node``; a class
        body is not a scope for the functions nested in its methods,
        as in Python."""
        s = parents.get(node)
        first = True
        while s is not None:
            if isinstance(s, _SCOPES) and (
                    first or not isinstance(s, ast.ClassDef)):
                d = scopes.get(s, {}).get(name)
                if d is not None:
                    return d
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                first = False
            s = parents.get(s)
        return None

    def method(node: ast.AST, name: str):
        """``self.name`` seen from ``node``: the enclosing class's."""
        s = parents.get(node)
        while s is not None and not isinstance(s, ast.ClassDef):
            s = parents.get(s)
        return scopes.get(s, {}).get(name) if s is not None else None

    def target(node: ast.AST, expr: ast.AST):
        if isinstance(expr, ast.Lambda):
            return expr, "<lambda>"
        if isinstance(expr, ast.Name):
            d = resolve(node, expr.id)
            return (d, d.name) if d is not None else (None, "")
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self":
            d = method(node, expr.attr)
            return (d, d.name) if d is not None else (None, "")
        return None, ""

    bodies: List[Tuple[ast.AST, str]] = []
    seen: Set[int] = set()

    def add(node: Optional[ast.AST], label: str) -> None:
        if node is not None and id(node) not in seen:
            seen.add(id(node))
            bodies.append((node, label))

    def enclosing_name(node: ast.AST) -> str:
        s = parents.get(node)
        while s is not None and not isinstance(
                s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            s = parents.get(s)
        return s.name if s is not None else "<module>"

    for site, body in roots:
        if body is site:
            add(site, enclosing_name(site))
        else:
            add(*target(site, body))

    # Calls made from a captured body run inside the capture too.
    i = 0
    while i < len(bodies):
        body, _label = bodies[i]
        i += 1
        for n in ast.walk(body):
            if isinstance(n, ast.Call):
                d, label = target(n, n.func)
                if d is not None and not isinstance(d, ast.Lambda):
                    add(d, label)
    return bodies
