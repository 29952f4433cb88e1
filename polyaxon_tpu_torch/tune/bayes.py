"""Bayesian optimization with a native Gaussian-process surrogate.

Parity: the reference's bayes manager (SURVEY.md 2.11) wraps an external
optimizer; here the GP (RBF kernel + jitter, exact solve — trial counts are
tiny) and the acquisition (expected improvement / UCB / POI) are implemented
directly on numpy, with params mapped into the unit cube via
``space.to_unit``.

The port's own copy of ``polyaxon_tpu/tune/bayes.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np

from ..flow.matrix import V1Bayes
from .space import from_unit, sample_params, to_unit


class GaussianProcess:
    def __init__(self, length_scale: float = 0.2, noise: float = 1e-6):
        self.length_scale = length_scale
        self.noise = noise
        self._x: Optional[np.ndarray] = None
        self._y: Optional[np.ndarray] = None
        self._chol: Optional[np.ndarray] = None
        self._alpha: Optional[np.ndarray] = None

    def _kernel(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / self.length_scale ** 2)

    def fit(self, x: np.ndarray, y: np.ndarray) -> None:
        self._x = np.asarray(x, dtype=float)
        y = np.asarray(y, dtype=float)
        self._y_mean = y.mean()
        self._y_std = y.std() or 1.0
        self._y = (y - self._y_mean) / self._y_std
        k = self._kernel(self._x, self._x)
        k[np.diag_indices_from(k)] += self.noise
        self._chol = np.linalg.cholesky(k)
        self._alpha = np.linalg.solve(
            self._chol.T, np.linalg.solve(self._chol, self._y))

    def predict(self, x: np.ndarray):
        x = np.asarray(x, dtype=float)
        ks = self._kernel(x, self._x)
        mean = ks @ self._alpha
        v = np.linalg.solve(self._chol, ks.T)
        var = np.clip(1.0 - (v ** 2).sum(0), 1e-12, None)
        return (mean * self._y_std + self._y_mean,
                np.sqrt(var) * self._y_std)


def _norm_cdf(z: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))


def _norm_pdf(z: np.ndarray) -> np.ndarray:
    return np.exp(-0.5 * z ** 2) / math.sqrt(2 * math.pi)


class BayesManager:
    def __init__(self, config: V1Bayes):
        self.config = config
        self.rng = np.random.default_rng(config.seed)
        self.names = list(config.params)
        utility = config.utility_function or {}
        self.acquisition = utility.get("acquisitionFunction",
                                       utility.get("acquisition_function", "ei"))
        self.kappa = float(utility.get("kappa", 2.576))
        self.eps = float(utility.get("eps", 1e-2))
        self.n_candidates = int(utility.get("numCandidates", 512))

    # ------------------------------------------------------------------

    def initial_suggestions(self) -> List[Dict[str, Any]]:
        return [sample_params(self.config.params, self.rng)
                for _ in range(self.config.num_initial_runs)]

    def _encode(self, params: Dict[str, Any]) -> List[float]:
        return [to_unit(self.config.params[n], params[n]) for n in self.names]

    def _decode(self, unit: np.ndarray) -> Dict[str, Any]:
        return {n: from_unit(self.config.params[n], float(u))
                for n, u in zip(self.names, unit)}

    def suggest(self, observations: List[Dict[str, Any]]) -> Dict[str, Any]:
        """observations: [{'params': {...}, 'metric': float}] -> next params."""
        obs = [o for o in observations if o.get("metric") is not None]
        if len(obs) < 2:
            return sample_params(self.config.params, self.rng)
        sign = 1.0 if self.config.metric.optimization == "maximize" else -1.0
        x = np.array([self._encode(o["params"]) for o in obs])
        y = sign * np.array([float(o["metric"]) for o in obs])

        gp = GaussianProcess()
        gp.fit(x, y)
        candidates = self.rng.uniform(0, 1, size=(self.n_candidates, len(self.names)))
        mean, std = gp.predict(candidates)
        best = y.max()

        if self.acquisition == "ucb":
            score = mean + self.kappa * std
        elif self.acquisition == "poi":
            score = _norm_cdf((mean - best - self.eps) / std)
        else:  # expected improvement
            z = (mean - best - self.eps) / std
            score = (mean - best - self.eps) * _norm_cdf(z) + std * _norm_pdf(z)
        return self._decode(candidates[int(np.argmax(score))])
