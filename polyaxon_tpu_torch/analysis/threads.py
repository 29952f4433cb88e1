"""THREAD-SHARE: cross-thread shared-state analysis.

Rides the whole-program model from :mod:`analysis.lockgraph` (call
graph, per-site held-lock sets, attribute writes) and answers the
question the lock graph doesn't: *which attributes are written by two
threads that agree on no lock?*

1. **Thread roots** are inferred, not configured: every
   ``Thread(target=f)`` site, every ``run`` method of a
   ``threading.Thread`` subclass, every HTTP handler entry point
   (``do_GET``/``do_POST``/...), and every ``Timer(t, f)`` callback.
   The engine loop shows up via its ``Thread(target=self._loop)``
   spawn like everything else.  The main thread (public API calls —
   ``close()``, constructor-time wiring) is deliberately NOT a root:
   it would make every attribute bi-rooted and drown the signal; the
   contract this family checks is between the *standing* threads.

2. Per root, a **must-held** set is propagated through the call graph
   (meet = intersection over call paths, seeded empty at the root):
   the locks a function is guaranteed to hold whenever that thread
   reaches it.  A write site's effective protection is the must-held
   set plus whatever is lexically held at the write.

3. A finding is one (class, attribute) pair written from ≥ 2 roots
   whose effective lock sets have **empty intersection** — no single
   lock orders those writes.  Constructor writes (``__init__`` et
   al.) are construction-time publication and don't count.

Sanctioned lock-free sharing is annotated in the code, not silenced
in config: ``# ptpu: lockfree[reason]`` on (or directly above) any
write to the attribute sanctions the whole attribute — the idiom for
GIL-atomic monotonic counters, epoch stamps read for staleness only,
and single-writer/racy-reader gauges.  The usual machinery still
applies on top: ``# ptpu: ignore[THREAD-SHARE]`` per line, and the
committed baseline for historical findings.

Precision limits are the model's (see lockgraph.py docstring): a call
the model cannot resolve contributes no reachability, so a write
reached only through an untyped receiver is invisible — the locksan
runtime cross-check exists precisely to keep the model honest on the
paths tests exercise.

The port's own copy of ``polyaxon_tpu/analysis/threads.py``
(stdlib only, kept here so the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import re
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .rules._base import Finding, _src_line
from .lockgraph import (ProgramModel, build_model, _CTOR_NAMES,
                        WriteSite)

__all__ = ["thread_roots", "thread_share_findings", "analyze"]

_LOCKFREE = re.compile(r"#\s*ptpu:\s*lockfree\[([^\]]*)\]")

_HANDLER_ENTRIES = ("do_GET", "do_POST", "do_PUT", "do_DELETE",
                    "do_HEAD", "do_PATCH")


def thread_roots(model: ProgramModel) -> Dict[str, str]:
    """fqn -> display name for every inferred thread entry point."""
    roots: Dict[str, str] = {}
    # Thread(target=...) and Timer(t, fn) spawn sites.
    for fi in model.functions.values():
        for sp in fi.spawns:
            if sp.target_fqn and sp.target_fqn in model.functions:
                tgt = model.functions[sp.target_fqn]
                label = sp.thread_name or "thread"
                roots.setdefault(sp.target_fqn, f"{label}@{tgt.qual}")
    # threading.Thread subclasses: run() is the entry point.
    for cls in model.classes.values():
        if "Thread" in cls.bases and "run" in cls.methods:
            fqn = cls.methods["run"]
            roots.setdefault(fqn, f"thread@{cls.name}.run")
    # HTTP handler pool entry points.
    for fqn, fi in model.functions.items():
        if fi.cls is not None and fi.name in _HANDLER_ENTRIES:
            roots.setdefault(fqn, f"handler@{fi.qual}")
    return roots


def _per_connection_classes(model: ProgramModel) -> Set[str]:
    """HTTP handler classes: http.server constructs a fresh instance
    per connection, so their ``self`` attributes are thread-private
    and never shared-state findings."""
    out: Set[str] = set()
    for cls in model.classes.values():
        if ("BaseHTTPRequestHandler" in cls.bases
                or any(m in cls.methods for m in _HANDLER_ENTRIES)):
            out.add(cls.name)
    return out


def _must_held(model: ProgramModel,
               root: str) -> Dict[str, FrozenSet[str]]:
    """Locks guaranteed held whenever this root's thread reaches each
    function (meet-over-call-paths, intersection)."""
    held: Dict[str, FrozenSet[str]] = {root: frozenset()}
    work: List[str] = [root]
    while work:
        f = work.pop()
        fi = model.functions.get(f)
        if fi is None:
            continue
        base = held[f]
        for cs in fi.calls:
            contrib = base | frozenset(cs.held)
            for t in cs.targets:
                if t not in model.functions:
                    continue
                cur = held.get(t)
                new = contrib if cur is None else (cur & contrib)
                if cur is None or new != cur:
                    held[t] = new
                    work.append(t)
    return held


def _lockfree_reason(model: ProgramModel, w: WriteSite,
                     def_line: int) -> Optional[str]:
    """``# ptpu: lockfree[reason]`` on the write line, the line
    directly above, or on/above the enclosing ``def`` line (which
    sanctions every write in that function — for the
    reset-a-batch-of-fields idiom where one ownership argument
    covers them all)."""
    lines = model.sources.get(w.relpath, ())
    for ln in (w.line, w.line - 1, def_line, def_line - 1):
        m = _LOCKFREE.search(_src_line(lines, ln))
        if m:
            return m.group(1)
    return None


def thread_share_findings(model: ProgramModel) -> List[Finding]:
    roots = thread_roots(model)
    if len(roots) < 2:
        return []
    # (class, attr) -> root fqn -> [(write, effective held)]
    shared: Dict[Tuple[str, str],
                 Dict[str, List[Tuple[WriteSite, FrozenSet[str]]]]] = {}
    sanctioned: Set[Tuple[str, str]] = set()
    private = _per_connection_classes(model)
    for root in roots:
        held = _must_held(model, root)
        for fqn in held:
            fi = model.functions[fqn]
            if fi.name in _CTOR_NAMES:
                continue            # construction-time publication
            def_line = getattr(fi.node, "lineno", 0)
            for w in fi.writes:
                if w.cls in private:
                    continue        # per-connection instance
                if _lockfree_reason(model, w, def_line) is not None:
                    sanctioned.add((w.cls, w.attr))
                    continue
                eff = held[fqn] | frozenset(w.held)
                shared.setdefault((w.cls, w.attr), {}).setdefault(
                    root, []).append((w, eff))
    out: List[Finding] = []
    for (cls, attr), by_root in sorted(shared.items()):
        if (cls, attr) in sanctioned or len(by_root) < 2:
            continue
        common: Optional[FrozenSet[str]] = None
        sites: List[Tuple[WriteSite, FrozenSet[str]]] = []
        for writes in by_root.values():
            for w, eff in writes:
                common = eff if common is None else (common & eff)
                sites.append((w, eff))
        if common:
            continue                # one lock orders every write
        sites.sort(key=lambda p: (p[0].relpath, p[0].line))
        anchor = min(
            sites, key=lambda p: (bool(p[1]), p[0].relpath, p[0].line)
        )[0]
        root_names = ", ".join(sorted(roots[r] for r in by_root))
        examples = "; ".join(
            f"{w.relpath}:{w.line} [{w.func}] holds "
            f"{{{', '.join(sorted(eff)) or 'nothing'}}}"
            for w, eff in sites[:3])
        more = f" (+{len(sites) - 3} more)" if len(sites) > 3 else ""
        out.append(Finding(
            rule="THREAD-SHARE", path=anchor.relpath, line=anchor.line,
            func=anchor.func,
            code=_src_line(model.sources.get(anchor.relpath, ()),
                           anchor.line),
            message=(f"{cls}.{attr} is written from "
                     f"{len(by_root)} thread roots ({root_names}) "
                     f"with no common lock: {examples}{more} — guard "
                     f"the writes with one lock or annotate one with "
                     f"'# ptpu: lockfree[reason]' if the sharing is "
                     f"by design")))
    out.sort(key=lambda f: f.sort_key())
    return out


def analyze(sources: Dict[str, str]) -> List[Finding]:
    """THREAD-SHARE program analysis over the in-scope file set."""
    return thread_share_findings(build_model(sources))
