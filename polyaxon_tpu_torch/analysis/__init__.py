"""Analysis of the port: the static checker (``ptpu-torch check``) and
the runtime sanitizers that machine-check the serving stack's own
invariants.

The port's own copy of ``polyaxon_tpu/analysis/__init__.py``: the same
layers and exports, over the port's own copies of every module (all
stdlib, kept here so the port imports nothing of the JAX package).

- :mod:`rules` / :mod:`checker` — the AST linter (``ptpu-torch
  check``), per-module rule families RNG-DET, LOCK-HOLD, JIT-PURITY,
  HOST-SYNC, EXC-SWALLOW, ... with ``# ptpu: ignore[RULE]``
  suppressions.  The families whose reference sinks named JAX match
  the torch spelling of the same hazard (``rules/__init__.py``).
- :mod:`lockgraph` / :mod:`threads` — the whole-program concurrency
  families LOCK-ORDER (static lock-acquisition graph over a call
  graph with held-lock propagation; cycles are potential deadlocks;
  module-level locks such as ``slots._CAPTURE_LOCK`` are nodes) and
  THREAD-SHARE (attributes written from ≥ 2 inferred thread roots with
  no common lock; ``# ptpu: lockfree[reason]`` sanctions by-design
  sharing).  The committed ``lockorder.json`` is the canonical
  lock-order DAG, and locksan's runtime edges are cross-checked against
  the static graph (``chip_smoke.py`` on the card).
- :mod:`baseline` — the committed, justified list of accepted
  findings; the tier-1 clean-check test
  (``tests/test_torch_check_clean.py``) holds the package to it.
- :mod:`locksan` / :mod:`recompile` — runtime sanitizers for what
  static analysis can't see: lock-order inversions / long holds, and
  steady-state recapture storms (the recompile sentinel).
- :mod:`xprof` — the ``torch.profiler`` Chrome-trace parser behind the
  serving flight recorder (serving/profiling.py).  Pure stdlib,
  importable for offline dump analysis.
"""

from .baseline import (DEFAULT_BASELINE, apply_baseline,
                       load_baseline, save_baseline)
from .checker import (PROGRAM_RULE_IDS, check_file, check_paths,
                      check_program, check_source)
from .locksan import (LOCK_REGISTRY, LockHeldTooLongError,
                      LockOrderError, LockSanitizer, SanitizedLock)
from .recompile import RecompileSentinel
from .rules import ALL_RULES, RULE_IDS, Finding

__all__ = [
    "ALL_RULES", "RULE_IDS", "PROGRAM_RULE_IDS", "Finding",
    "check_source", "check_file", "check_paths", "check_program",
    "DEFAULT_BASELINE", "load_baseline", "save_baseline",
    "apply_baseline",
    "LockSanitizer", "SanitizedLock", "LockOrderError",
    "LockHeldTooLongError", "LOCK_REGISTRY",
    "RecompileSentinel",
]
