"""Hyperband: successive-halving brackets (Li et al. 2018).

Parity with the reference's bracket/rung math (SURVEY.md 2.11/3.3 —
``hypertune`` hyperband manager, unverified path).  Given ``max_iterations``
(R) and ``eta``:

    s_max = floor(log_eta(R));  B = (s_max + 1) * R

Bracket s in [s_max, ..., 0]:
    n_s = ceil(B/R * eta^s / (s+1))   initial configs
    r_s = R * eta^-s                  initial resource
Rung i in [0..s]:
    n_i = floor(n_s * eta^-i)        configs surviving into rung i
    r_i = r_s * eta^i                resource for rung i
Top n_{i+1} by metric advance to the next rung.

The port's own copy of ``polyaxon_tpu/tune/hyperband.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from ..flow.matrix import V1Hyperband
from .space import sample_params


@dataclass
class Rung:
    bracket: int
    rung: int
    n_configs: int
    resource: float


class HyperbandManager:
    def __init__(self, config: V1Hyperband):
        self.config = config
        self.eta = float(config.eta)
        self.max_iterations = int(config.max_iterations)
        if self.eta <= 1:
            raise ValueError("hyperband eta must be > 1")
        self.s_max = int(math.floor(
            math.log(self.max_iterations) / math.log(self.eta)))
        self.B = (self.s_max + 1) * self.max_iterations
        self.rng = np.random.default_rng(config.seed)

    # -- static math ------------------------------------------------------

    def brackets(self) -> List[int]:
        return list(range(self.s_max, -1, -1))

    def bracket_n(self, s: int) -> int:
        return int(math.ceil(
            (self.B / self.max_iterations) * (self.eta ** s) / (s + 1)))

    def bracket_r(self, s: int) -> float:
        return self.max_iterations * (self.eta ** (-s))

    def rungs(self, s: int) -> List[Rung]:
        n, r = self.bracket_n(s), self.bracket_r(s)
        out = []
        for i in range(s + 1):
            out.append(Rung(
                bracket=s, rung=i,
                n_configs=int(math.floor(n * self.eta ** (-i))),
                resource=r * (self.eta ** i),
            ))
        return out

    def promote_count(self, s: int, rung_i: int) -> int:
        """How many configs advance out of rung i of bracket s."""
        rungs = self.rungs(s)
        if rung_i + 1 >= len(rungs):
            return 0
        return rungs[rung_i + 1].n_configs

    # -- suggestion flow --------------------------------------------------

    def initial_suggestions(self, s: int) -> List[Dict[str, Any]]:
        return [sample_params(self.config.params, self.rng)
                for _ in range(self.bracket_n(s))]

    def resource_value(self, rung: Rung):
        return self.config.resource.cast(rung.resource)

    def select_top(self, results: List[Dict[str, Any]], k: int) -> List[Dict[str, Any]]:
        """results: [{'params':..., 'metric': float}]; best-k by metric."""
        metric = self.config.metric
        scored = [r for r in results if r.get("metric") is not None]
        reverse = metric.optimization == "maximize"
        scored.sort(key=lambda r: r["metric"], reverse=reverse)
        return scored[:k]
