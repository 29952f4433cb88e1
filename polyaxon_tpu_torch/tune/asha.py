"""ASHA — Asynchronous Successive Halving (Li et al. 2020).

The reference's sweep algorithms (SURVEY.md 2.11) top out at Hyperband,
whose rungs are BARRIERS: every config in a rung must finish before any
promotion happens, so straggler trials idle the whole worker pool.  On
a TPU-slice fleet stragglers are the norm (preemptions, queue delays),
so the tuner adds ASHA: promotion decisions are made the moment a
worker frees up —

- rung k trains with resource ``r_k = R * eta^(k - max_rung)`` — the
  top rung at exactly ``max_iterations`` (R), descending by eta down
  to a bottom rung that still gets at least ``min_resource``;
- a free worker first tries to PROMOTE: scanning rungs top-down, any
  completed trial that sits in the top ``floor(|rung| / eta)`` of its
  rung and hasn't been promoted yet advances to rung k+1 immediately;
- otherwise it STARTS a fresh config at rung 0 (until ``num_runs``
  configs have been sampled);
- when neither applies it waits for in-flight trials (a straggler's
  completion can unlock promotions).

No barriers anywhere: one slow trial delays only its own promotion,
never the pool.  The synchronous counterpart lives in hyperband.py.

The port's own copy of ``polyaxon_tpu/tune/asha.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .space import sample_params


@dataclass
class _Entry:
    config_id: int
    params: Dict[str, Any]
    metric: Optional[float] = None
    promoted: bool = False


@dataclass
class AshaJob:
    config_id: int
    rung: int
    resource: float
    params: Dict[str, Any]


class ASHAManager:
    """Bookkeeping for one ASHA run.  Thread-compatible but NOT
    thread-safe — the controller serializes next_job()/report() under
    its own lock (the decisions must be atomic with respect to each
    other anyway)."""

    def __init__(self, config):
        self.config = config
        self.eta = float(config.eta)
        if self.eta <= 1:
            raise ValueError("asha eta must be > 1")
        self.R = float(config.max_iterations)
        self.r0 = float(config.min_resource)
        if self.r0 <= 0 or self.r0 > self.R:
            raise ValueError(
                f"min_resource must be in (0, max_iterations]; got "
                f"{self.r0} vs R={self.R}")
        # Rungs are anchored DOWNWARD from R (like hyperband's
        # bracket_r): the top rung trains at exactly max_iterations,
        # rung k at R * eta^(k - max_rung), with max_rung the largest
        # depth whose bottom rung still gets >= min_resource.  An
        # upward r0*eta^k ladder would strand up to an eta-factor of
        # the user's budget (R=100, eta=3: top rung 81, never 100).
        self.max_rung = int(math.floor(
            math.log(self.R / self.r0) / math.log(self.eta) + 1e-9))
        if config.resource.cast(
                self.R * self.eta ** (-self.max_rung)) <= 0:
            # int resource + fractional min_resource can truncate the
            # bottom rung to 0 — children would "train" for zero
            # epochs yet still compete for promotion.
            raise ValueError(
                f"min_resource={self.r0} with resource type "
                f"{config.resource.type!r} yields a rung-0 resource of "
                f"0 after casting; raise min_resource so the bottom "
                f"rung trains at >= 1")
        self.num_runs = int(config.num_runs)
        self.rng = np.random.default_rng(config.seed)
        # rung index -> completed entries (in completion order)
        self.rungs: Dict[int, List[_Entry]] = {
            k: [] for k in range(self.max_rung + 1)}
        self._started = 0
        self._next_config_id = 0

    # ------------------------------------------------------------------

    def resource_at(self, rung: int) -> float:
        r = self.R * self.eta ** (rung - self.max_rung)
        return self.config.resource.cast(r)

    def _is_better(self, a: float, b: float) -> bool:
        return self.config.metric.is_better(a, b)

    def _promotable(self, rung: int) -> Optional[_Entry]:
        """Best unpromoted entry inside rung's top floor(n/eta), if
        any.  The top set GROWS as completions arrive — that is the
        asynchrony: early completions promote before the rung 'fills'
        (there is no notion of full).  NaN metrics (diverged trials)
        are excluded like failures: Python's sort leaves NaN wherever
        it lands (all comparisons False), which would let a diverged
        config win every promotion."""
        entries = [e for e in self.rungs[rung]
                   if e.metric is not None
                   and not math.isnan(e.metric)]
        k = int(math.floor(len(entries) / self.eta))
        if k <= 0:
            return None
        ordered = sorted(entries, key=lambda e: e.metric,
                         reverse=self.config.metric.optimization
                         == "maximize")
        for e in ordered[:k]:
            if not e.promoted:
                return e
        return None

    def next_job(self) -> Optional[AshaJob]:
        """Promotion first (top rung down — deeper trials are worth
        more compute), else a fresh rung-0 config, else None (caller
        waits on in-flight trials or finishes)."""
        for rung in range(self.max_rung - 1, -1, -1):
            e = self._promotable(rung)
            if e is not None:
                e.promoted = True
                return AshaJob(config_id=e.config_id, rung=rung + 1,
                               resource=self.resource_at(rung + 1),
                               params=dict(e.params))
        if self._started < self.num_runs:
            self._started += 1
            cid = self._next_config_id
            self._next_config_id += 1
            params = sample_params(self.config.params, self.rng)
            return AshaJob(config_id=cid, rung=0,
                           resource=self.resource_at(0), params=params)
        return None

    def report(self, job: AshaJob, metric: Optional[float]) -> None:
        """Record a completed trial.  ``metric=None`` (failed child)
        still lands in the rung so the sweep terminates, but it can
        never promote."""
        self.rungs[job.rung].append(_Entry(
            config_id=job.config_id, params=job.params, metric=metric))

    # ------------------------------------------------------------------

    def counts(self) -> Dict[int, int]:
        return {k: len(v) for k, v in self.rungs.items()}

    def best(self) -> Optional[Tuple[Dict[str, Any], float]]:
        top: Optional[_Entry] = None
        for entries in self.rungs.values():
            for e in entries:
                if e.metric is None or math.isnan(e.metric):
                    continue
                if top is None or self._is_better(e.metric, top.metric):
                    top = e
        return None if top is None else (dict(top.params), top.metric)
