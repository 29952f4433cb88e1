"""Repo-specific static-analysis rule families — the registry.

Each rule family machine-checks one of the serving stack's
written-in-prose contracts (docs/ANALYSIS.md maps every rule to the
contract it guards) and lives in its own module under
``analysis/rules/``; this package assembles them into the one
ordered registry the checker consumes.  Adding a family is: write
``analysis/rules/<family>.py`` exposing a ``RULES`` tuple, append the
module to ``_FAMILY_MODULES`` below, document it in docs/ANALYSIS.md
— no existing module grows.

Per-module rules are AST visitors over one module at a time; they
are deliberately narrow — a rule that cries wolf gets suppressed
into uselessness, so each one flags only the patterns that have
actually bitten (or would bite) this codebase.  The catalog:

- RNG-DET       position-keyed RNG discipline (rng_det.py)
- LOCK-HOLD     no unbounded blocking under a held lock (lock_hold.py)
- JIT-PURITY    no capture-time impurity in CUDA graphs (jit_purity.py)
- JIT-DEADLINE  no ``time.*`` at all in captured programs (jit_deadline.py)
- HOST-SYNC     explicit device->host syncs in the hot path (host_sync.py)
- EXC-SWALLOW   no silently dropped errors (exc_swallow.py)
- PAGE-REF      page-pool accounting discipline (page_ref.py)
- SHARD-LEAK    committed placement on meshes (shard_leak.py)
- TIME-TRUTH    honest host-clock deltas over async CUDA (time_truth.py)
- SNAPSHOT-LOCK /debug/state never queues behind the device (snapshot_lock.py)
- RETRY-BACKOFF bounded retries only (retry_backoff.py)
- TIER-XFER     page payloads move via the spill tier only (tier_xfer.py)
- SOCKET-TIMEOUT every outbound call carries a timeout (socket_timeout.py)
- WIRE-VERIFY   checksummed wire-payload admission (wire_verify.py)
- PHASE-ENUM    one phase vocabulary, forensics.py's (phase_enum.py)

The interprocedural families LOCK-ORDER and THREAD-SHARE are NOT in
this registry: they analyze the whole serving program at once (call
graph + held-lock propagation) rather than one module, and live in
``analysis/lockgraph.py`` / ``analysis/threads.py``, registered with
the checker as program analyses (checker.PROGRAM_ANALYSES).

The port's own copy of ``polyaxon_tpu/analysis/rules/__init__.py``,
with the reference's catalog in the reference's order.  Five families
are the reference's as they are (EXC-SWALLOW, PAGE-REF, PHASE-ENUM,
SOCKET-TIMEOUT, WIRE-VERIFY); RNG-DET, LOCK-HOLD, JIT-PURITY,
JIT-DEADLINE, HOST-SYNC, TIME-TRUTH, SNAPSHOT-LOCK, RETRY-BACKOFF and
TIER-XFER had a jax-named sink and are retargeted to what they guard
in the port (each module's docstring says which sink it matches), and
SHARD-LEAK guards the serving mesh's placement (``serving/meshed.py``
and the slot pools it allocates).
"Jitted" reads "captured into a CUDA graph" in the port.

Suppression: ``# ptpu: ignore[RULE-A,RULE-B]`` on the flagged line or
the line directly above silences those rules for that line;
``# ptpu: ignore[*]`` silences everything.  Suppressions are for
findings whose justification is local to the code; findings whose
justification is historical (legacy reference paths) belong in the
committed baseline (analysis/baseline.py) with a per-entry
justification.
"""

from __future__ import annotations

from typing import Tuple

from ._base import Finding, Rule, dotted_name
from . import (exc_swallow, host_sync, jit_deadline, jit_purity,
               lock_hold, page_ref, phase_enum, retry_backoff,
               rng_det, shard_leak, snapshot_lock, socket_timeout,
               tier_xfer, time_truth, wire_verify)

__all__ = ["Finding", "Rule", "ALL_RULES", "RULE_IDS", "dotted_name"]

# Registry order is the historical one (it does not affect reported
# findings — those sort by location — but keeps rule listings and
# docs diffs stable).
_FAMILY_MODULES = (rng_det, lock_hold, jit_purity, jit_deadline,
                   host_sync, exc_swallow, page_ref, shard_leak,
                   time_truth, snapshot_lock, retry_backoff,
                   tier_xfer, socket_timeout, wire_verify,
                   phase_enum)

ALL_RULES: Tuple[Rule, ...] = tuple(
    rule for mod in _FAMILY_MODULES for rule in mod.RULES)
RULE_IDS: Tuple[str, ...] = tuple(r.id for r in ALL_RULES)

# Convenience re-exports so `from ..rules import PhaseEnumRule`-style
# imports (tests, tools) keep working across the package split.
_BY_ID = {r.id: type(r) for r in ALL_RULES}
globals().update({cls.__name__: cls for cls in _BY_ID.values()})
