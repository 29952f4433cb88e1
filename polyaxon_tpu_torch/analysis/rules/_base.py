"""Shared scaffolding for the rule families (`analysis/rules/`).

One Finding shape, one Rule interface, one scoped visitor — every
family module builds on these so the checker, the baseline, and the
suppression machinery never need to know which family produced a
finding.  Helpers that more than one family leans on (dotted-name
resolution, the ``*_lock`` name pattern, the socket-I/O call set)
live here too, so the families can never drift apart on what counts
as "a lock" or "network I/O".

The port's own copy of ``polyaxon_tpu/analysis/rules/_base.py``
(stdlib only, kept here so the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Finding", "Rule", "dotted_name", "_src_line",
           "_ScopedVisitor", "_in_serving", "_LOCK_NAME",
           "_SOCKET_IO"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location.

    ``key()`` deliberately excludes the line number: baselines match
    on (rule, path, enclosing function, source text), so edits above
    a baselined finding don't invalidate the whole file's entries.
    """

    rule: str
    path: str       # posix-style path relative to the checked root
    line: int       # 1-based, for humans and editors
    func: str       # enclosing def chain, or "<module>"
    code: str       # stripped source line
    message: str

    def key(self) -> Tuple[str, str, str, str]:
        return (self.rule, self.path, self.func, self.code)

    def sort_key(self):
        return (self.path, self.line, self.rule, self.code)

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} "
                f"[{self.func}] {self.message}\n    {self.code}")


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Attribute/Name chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _src_line(lines: Sequence[str], lineno: int) -> str:
    if 1 <= lineno <= len(lines):
        return lines[lineno - 1].strip()
    return ""


class Rule:
    """One rule family.  Subclasses set ``id`` and implement
    ``applies_to`` (path scoping) and ``check``."""

    id: str = ""
    message: str = ""

    def applies_to(self, relpath: str) -> bool:
        return True

    def check(self, tree: ast.Module, lines: Sequence[str],
              relpath: str) -> List[Finding]:
        raise NotImplementedError


class _ScopedVisitor(ast.NodeVisitor):
    """NodeVisitor tracking the enclosing function-def chain."""

    def __init__(self):
        self._stack: List[str] = []

    @property
    def func(self) -> str:
        return ".".join(self._stack) if self._stack else "<module>"

    def visit_FunctionDef(self, node):
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef


def _in_serving(relpath: str) -> bool:
    return "/serving/" in "/" + relpath


_LOCK_NAME = re.compile(r"(^|_)lock$")

_SOCKET_IO = {"create_connection", "urlopen", "recv", "accept",
              "connect", "sendall", "getresponse", "request"}
