"""Tree-structured Parzen Estimator (hyperopt-style) implemented natively.

Parity: the reference's ``V1Hyperopt`` delegates to the hyperopt package
(SURVEY.md 2.11); here TPE runs on numpy: observations are split at the
gamma-quantile into good/bad sets, each modeled with a per-dimension
Gaussian KDE in unit space, and candidates maximize l(x)/g(x).

The port's own copy of ``polyaxon_tpu/tune/tpe.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..flow.matrix import V1Hyperopt
from .space import from_unit, sample_params, to_unit


class TPEManager:
    def __init__(self, config: V1Hyperopt, gamma: float = 0.25,
                 n_candidates: int = 128):
        self.config = config
        self.rng = np.random.default_rng(config.seed)
        self.names = list(config.params)
        self.gamma = gamma
        self.n_candidates = n_candidates

    def _encode(self, params: Dict[str, Any]) -> List[float]:
        return [to_unit(self.config.params[n], params[n]) for n in self.names]

    def _decode(self, unit: np.ndarray) -> Dict[str, Any]:
        return {n: from_unit(self.config.params[n], float(u))
                for n, u in zip(self.names, unit)}

    @staticmethod
    def _kde_logpdf(points: np.ndarray, samples: np.ndarray,
                    bandwidth: float) -> np.ndarray:
        # points [c, d], samples [n, d] -> log density per candidate
        d2 = (points[:, None, :] - samples[None, :, :]) ** 2
        log_k = -0.5 * d2 / bandwidth ** 2
        per_dim = np.logaddexp.reduce(log_k, axis=1) - np.log(len(samples))
        return per_dim.sum(-1)

    def suggest(self, observations: List[Dict[str, Any]]) -> Dict[str, Any]:
        if self.config.algorithm == "rand":
            return sample_params(self.config.params, self.rng)
        obs = [o for o in observations if o.get("metric") is not None]
        if len(obs) < 4:
            return sample_params(self.config.params, self.rng)
        metric = self.config.metric
        sign = -1.0 if (metric and metric.optimization == "maximize") else 1.0
        x = np.array([self._encode(o["params"]) for o in obs])
        y = sign * np.array([float(o["metric"]) for o in obs])  # lower=better

        n_good = max(1, int(np.ceil(self.gamma * len(obs))))
        order = np.argsort(y)
        good, bad = x[order[:n_good]], x[order[n_good:]]
        bandwidth = max(0.05, 1.0 / max(2, len(obs)) ** 0.5)

        candidates = np.clip(
            good[self.rng.integers(len(good), size=self.n_candidates)]
            + self.rng.normal(0, bandwidth, size=(self.n_candidates,
                                                  len(self.names))),
            0.0, 1.0,
        )
        score = (self._kde_logpdf(candidates, good, bandwidth)
                 - self._kde_logpdf(candidates, bad, bandwidth))
        return self._decode(candidates[int(np.argmax(score))])
