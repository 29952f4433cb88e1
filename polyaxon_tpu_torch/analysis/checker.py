"""Run the rule families (rules/) over source trees.

One entry point for every surface: the ``ptpu-torch check`` CLI, the tier-1
clean-check test (tests/test_torch_check_clean.py), and the analyzer's own
unit tests (which feed snippets through :func:`check_source` under
virtual paths, so path-scoped rules can be exercised without touching
the real tree).

Two kinds of analysis run here.  The per-module families
(rules/ALL_RULES) see one file at a time.  The *program* analyses —
LOCK-ORDER (analysis/lockgraph.py) and THREAD-SHARE
(analysis/threads.py) — see the whole in-scope file set at once
(:data:`lockgraph.PROGRAM_SCOPE`: serving/ plus locksan.py) and are
run by :func:`check_paths` after the per-module pass, or directly via
:func:`check_program` with virtual paths (the fixture tests do this).
Their findings ride the same Finding shape, so suppression, baseline,
text/JSON rendering, and exit semantics need no special cases.

Suppression comments are extracted from the raw source, not the AST:
``# ptpu: ignore[RULE-A,RULE-B]`` on the flagged line or the line
directly above silences those rule ids (``*`` silences all) for that
line.  Findings come back in one stable order — (path, line, rule,
code) — so check output diffs cleanly in review.

The port's own copy of ``polyaxon_tpu/analysis/checker.py``
(stdlib only, kept here so the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Sequence, Set

from .rules import ALL_RULES, Finding, Rule
from . import lockgraph as _lockgraph
from . import threads as _threads

__all__ = ["check_source", "check_file", "check_paths",
           "check_program", "iter_py_files", "PROGRAM_RULE_IDS"]

# The interprocedural families check_program arms (rules/RULE_IDS
# covers the per-module families; the union is the full catalog).
PROGRAM_RULE_IDS = ("LOCK-ORDER", "THREAD-SHARE")

_SUPPRESS = re.compile(r"#\s*ptpu:\s*ignore\[([^\]]*)\]")

_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "node_modules",
              ".venv", "venv"}


def _suppressions(lines: Sequence[str]) -> Dict[int, Set[str]]:
    """line number (1-based) -> suppressed rule ids, with a comment
    on line N covering findings on N and N+1 (comment-above style)."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(lines, 1):
        m = _SUPPRESS.search(line)
        if not m:
            continue
        ids = {tok.strip() for tok in m.group(1).split(",")
               if tok.strip()}
        out.setdefault(i, set()).update(ids)
        out.setdefault(i + 1, set()).update(ids)
    return out


def check_source(source: str, relpath: str,
                 rules: Sequence[Rule] = ALL_RULES) -> List[Finding]:
    """Analyze one module's source under a (possibly virtual) posix
    relpath; returns stably-sorted findings with suppressions
    applied.  Syntax errors surface as one SYNTAX finding rather than
    an exception — a half-written file must not crash the whole
    check."""
    relpath = relpath.replace(os.sep, "/")
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("SYNTAX", relpath, e.lineno or 0, "<module>",
                        (e.text or "").strip(),
                        f"cannot parse: {e.msg}")]
    lines = source.splitlines()
    sup = _suppressions(lines)
    findings: List[Finding] = []
    for rule in rules:
        if not rule.applies_to(relpath):
            continue
        for f in rule.check(tree, lines, relpath):
            ids = sup.get(f.line, ())
            if f.rule in ids or "*" in ids:
                continue
            findings.append(f)
    findings.sort(key=Finding.sort_key)
    return findings


def check_file(path: str, root: str,
               rules: Sequence[Rule] = ALL_RULES) -> List[Finding]:
    relpath = os.path.relpath(os.path.abspath(path),
                              os.path.abspath(root))
    with open(path, encoding="utf-8") as f:
        return check_source(f.read(), relpath, rules)


def iter_py_files(paths: Iterable[str]) -> List[str]:
    """Every .py file under ``paths``, first-seen order, deduplicated
    by absolute path — overlapping arguments (``pkg pkg/sub``) must
    not double-count findings, which would both report phantom "new"
    findings on a clean tree and write doubled count budgets into an
    updated baseline."""
    out: List[str] = []
    seen: Set[str] = set()

    def add(f: str) -> None:
        key = os.path.abspath(f)
        if key not in seen:
            seen.add(key)
            out.append(f)

    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                add(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in _SKIP_DIRS)
            for f in sorted(filenames):
                if f.endswith(".py"):
                    add(os.path.join(dirpath, f))
    return out


def check_program(sources: Dict[str, str]) -> List[Finding]:
    """Run the whole-program analyses over the in-scope subset of
    ``sources`` ({relpath: source}) — LOCK-ORDER then THREAD-SHARE —
    with per-line suppressions applied.  Files outside
    :data:`lockgraph.PROGRAM_SCOPE` and files that don't parse are
    dropped silently (the per-module pass already reports SYNTAX)."""
    scoped: Dict[str, str] = {}
    for relpath, src in sources.items():
        rp = relpath.replace(os.sep, "/")
        if not _lockgraph.in_program_scope(rp):
            continue
        try:
            ast.parse(src)
        except SyntaxError:
            continue
        scoped[rp] = src
    if not scoped:
        return []
    model = _lockgraph.build_model(scoped)
    findings = _lockgraph.lock_order_findings(
        _lockgraph.build_lock_graph(model))
    findings += _threads.thread_share_findings(model)
    sup_cache: Dict[str, Dict[int, Set[str]]] = {}
    out: List[Finding] = []
    for f in findings:
        sup = sup_cache.get(f.path)
        if sup is None:
            sup = sup_cache[f.path] = _suppressions(
                scoped.get(f.path, "").splitlines())
        ids = sup.get(f.line, ())
        if f.rule in ids or "*" in ids:
            continue
        out.append(f)
    out.sort(key=Finding.sort_key)
    return out


def check_paths(paths: Iterable[str], root: str = ".",
                rules: Sequence[Rule] = ALL_RULES,
                program: bool = True) -> List[Finding]:
    """Analyze every .py file under ``paths``; findings are reported
    with paths relative to ``root`` and sorted stably.  The
    whole-program families run over the in-scope subset of the same
    file set (``program=False`` restricts to per-module rules)."""
    findings: List[Finding] = []
    sources: Dict[str, str] = {}
    absroot = os.path.abspath(root)
    for path in iter_py_files(paths):
        relpath = os.path.relpath(os.path.abspath(path),
                                  absroot).replace(os.sep, "/")
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        findings.extend(check_source(src, relpath, rules))
        sources[relpath] = src
    if program:
        findings.extend(check_program(sources))
    findings.sort(key=Finding.sort_key)
    return findings
