"""Committed-findings baseline for ``ptpu-torch check``.

The baseline is the explicit, reviewed list of findings the repo has
decided to live with — each entry carries a human justification, so
"we checked and it's fine" is a diffable artifact instead of tribal
knowledge.  Entries match findings on (rule, path, enclosing
function, source-line text) with a count, NOT on line numbers:
editing code above a baselined site doesn't invalidate it, while
changing the flagged line itself (or adding a second occurrence)
surfaces as a NEW finding — exactly the review granularity wanted.

``ptpu-torch check`` exits non-zero on findings beyond the baseline;
``--update-baseline`` rewrites the file (stable sort, justifications
preserved for entries that survive; new entries get a TODO
placeholder a reviewer must replace).

The port's own copy of ``polyaxon_tpu/analysis/baseline.py``
(stdlib only, kept here so the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, List, Sequence, Tuple

from .rules import Finding

__all__ = ["DEFAULT_BASELINE", "load_baseline", "save_baseline",
           "apply_baseline"]

# The committed baseline ships inside the package so `ptpu-torch check`
# finds it from any working directory.
DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__),
                                "baseline.json")

_Key = Tuple[str, str, str, str]

_TODO = "TODO: justify or fix (written by --update-baseline)"


def _entry_key(e: Dict) -> _Key:
    return (e["rule"], e["path"], e.get("func", "<module>"),
            e["code"])


def load_baseline(path: str) -> List[Dict]:
    """Entries from a baseline file; a missing file is an empty
    baseline (first run of a fresh checkout)."""
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    entries = doc.get("entries", []) if isinstance(doc, dict) else doc
    for e in entries:
        for field in ("rule", "path", "code"):
            if field not in e:
                raise ValueError(
                    f"{path}: baseline entry missing {field!r}: {e}")
        e.setdefault("func", "<module>")
        e.setdefault("count", 1)
        e.setdefault("justification", _TODO)
    return entries


def save_baseline(path: str, findings: Sequence[Finding],
                  previous: Sequence[Dict] = (),
                  preserve: Sequence[Dict] = ()) -> List[Dict]:
    """Write ``findings`` as the new baseline, carrying forward
    justifications from ``previous`` where the entry survives.
    ``preserve`` entries are kept VERBATIM — the CLI passes the
    previous entries for paths OUTSIDE the checked set, so updating
    from a path subset can never delete (and lose the written
    justifications of) debt it didn't re-examine.  Entries are sorted
    by (path, func, rule, code) so baseline diffs are reviewable."""
    kept = {_entry_key(e): e.get("justification", _TODO)
            for e in previous}
    counts = Counter(f.key() for f in findings)
    lineno = {}
    for f in findings:
        lineno.setdefault(f.key(), f.line)
    entries = [
        {"rule": rule, "path": p, "func": func, "code": code,
         "count": n, "line": lineno[(rule, p, func, code)],
         "justification": kept.get((rule, p, func, code), _TODO)}
        for (rule, p, func, code), n in counts.items()]
    built = {_entry_key(e) for e in entries}
    entries += [dict(e) for e in preserve
                if _entry_key(e) not in built]
    entries.sort(key=lambda e: (e["path"], e["func"], e["rule"],
                                e["code"]))
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1, "entries": entries}, f, indent=1)
        f.write("\n")
    return entries


def apply_baseline(findings: Sequence[Finding],
                   entries: Sequence[Dict]
                   ) -> Tuple[List[Finding], List[Dict]]:
    """Split findings against the baseline.

    Returns ``(new, stale)``: ``new`` is every finding not covered by
    a baseline entry (a key's findings beyond the baselined count are
    new, oldest-line first absorbed); ``stale`` is entries that no
    longer match anything — fixed code whose baseline debt should be
    deleted via --update-baseline."""
    budget: Dict[_Key, int] = Counter()
    for e in entries:
        budget[_entry_key(e)] += int(e.get("count", 1))
    used: Dict[_Key, int] = Counter()
    new: List[Finding] = []
    for f in sorted(findings, key=Finding.sort_key):
        k = f.key()
        if used[k] < budget.get(k, 0):
            used[k] += 1
        else:
            new.append(f)
    stale = [e for e in entries
             if used.get(_entry_key(e), 0) == 0]
    return new, stale
