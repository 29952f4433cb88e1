"""Search-space sampling/enumeration over the V1Hp* distribution schemas.

Parity: the reference's per-algorithm suggestion managers share this
vocabulary (SURVEY.md 2.11).  All randomness flows through a seeded
``numpy.random.Generator`` so suggestion tests are deterministic.

The port's own copy of ``polyaxon_tpu/tune/space.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np

from ..flow.matrix import DISCRETE_KINDS


class SpaceError(ValueError):
    pass


def enumerate_hp(hp: Any) -> List[Any]:
    """All values of a discrete distribution (grid expansion)."""
    kind = getattr(hp, "kind", None)
    if kind is None:
        return [hp]  # literal
    if kind == "choice":
        return list(hp.value)
    if kind == "range":
        start, stop, step = hp.as_tuple()
        vals = list(np.arange(start, stop, step))
        return [v.item() if hasattr(v, "item") else v for v in vals]
    if kind == "linspace":
        start, stop, num = hp.as_tuple()
        return [v.item() for v in np.linspace(start, stop, num)]
    if kind == "logspace":
        start, stop, num = hp.as_tuple()
        return [v.item() for v in np.logspace(start, stop, num)]
    if kind == "geomspace":
        start, stop, num = hp.as_tuple()
        return [v.item() for v in np.geomspace(start, stop, num)]
    raise SpaceError(
        f"Distribution {kind!r} is continuous; it cannot be enumerated "
        f"(grid supports {sorted(DISCRETE_KINDS)})"
    )


def sample_hp(hp: Any, rng: np.random.Generator) -> Any:
    """One random draw from any distribution."""
    kind = getattr(hp, "kind", None)
    if kind is None:
        return hp
    if kind == "choice":
        return hp.value[int(rng.integers(len(hp.value)))]
    if kind == "pchoice":
        options = [pair[0] for pair in hp.value]
        probs = [float(pair[1]) for pair in hp.value]
        return options[int(rng.choice(len(options), p=probs))]
    if kind in DISCRETE_KINDS:
        values = enumerate_hp(hp)
        return values[int(rng.integers(len(values)))]
    if kind == "uniform":
        low, high = hp.as_tuple()
        return float(rng.uniform(low, high))
    if kind == "quniform":
        low, high = hp.as_tuple()
        return round(float(rng.uniform(low, high)))
    if kind == "loguniform":
        low, high = hp.as_tuple()
        if low <= 0 or high <= 0:
            raise SpaceError("loguniform bounds must be > 0")
        return float(np.exp(rng.uniform(math.log(low), math.log(high))))
    if kind == "qloguniform":
        low, high = hp.as_tuple()
        return round(float(np.exp(rng.uniform(math.log(low), math.log(high)))))
    if kind == "normal":
        loc, scale = hp.as_tuple()
        return float(rng.normal(loc, scale))
    if kind == "qnormal":
        loc, scale = hp.as_tuple()
        return round(float(rng.normal(loc, scale)))
    if kind == "lognormal":
        loc, scale = hp.as_tuple()
        return float(rng.lognormal(loc, scale))
    if kind == "qlognormal":
        loc, scale = hp.as_tuple()
        return round(float(rng.lognormal(loc, scale)))
    raise SpaceError(f"Unknown distribution kind {kind!r}")


def sample_params(params: Dict[str, Any], rng: np.random.Generator) -> Dict[str, Any]:
    return {name: sample_hp(hp, rng) for name, hp in params.items()}


def grid_params(params: Dict[str, Any],
                num_runs: Optional[int] = None) -> List[Dict[str, Any]]:
    """Cartesian product of all discrete axes."""
    import itertools

    names = list(params)
    axes = [enumerate_hp(params[n]) for n in names]
    combos = itertools.product(*axes)
    out = [dict(zip(names, combo)) for combo in combos]
    if num_runs is not None:
        out = out[:num_runs]
    return out


def to_unit(hp: Any, value: Any) -> float:
    """Map a value into [0,1] for surrogate models (bayes/TPE)."""
    kind = getattr(hp, "kind", None)
    if kind in ("choice", "pchoice"):
        options = (hp.value if kind == "choice"
                   else [p[0] for p in hp.value])
        return options.index(value) / max(1, len(options) - 1)
    if kind in ("uniform", "quniform"):
        low, high = hp.as_tuple()
        return (float(value) - low) / max(1e-12, high - low)
    if kind in ("loguniform", "qloguniform"):
        low, high = hp.as_tuple()
        return ((math.log(float(value)) - math.log(low))
                / max(1e-12, math.log(high) - math.log(low)))
    if kind in ("normal", "qnormal"):
        loc, scale = hp.as_tuple()
        return 0.5 + 0.5 * math.erf((float(value) - loc) / (scale * math.sqrt(2)))
    if kind in ("lognormal", "qlognormal"):
        loc, scale = hp.as_tuple()
        return 0.5 + 0.5 * math.erf((math.log(max(float(value), 1e-300)) - loc)
                                    / (scale * math.sqrt(2)))
    if kind in DISCRETE_KINDS:
        values = enumerate_hp(hp)
        return values.index(value) / max(1, len(values) - 1)
    raise SpaceError(f"Cannot normalize kind {kind!r}")


def from_unit(hp: Any, unit: float) -> Any:
    """Inverse of to_unit (approximate for q*/discrete kinds)."""
    unit = min(1.0, max(0.0, unit))
    kind = getattr(hp, "kind", None)
    if kind in ("choice", "pchoice"):
        options = (hp.value if kind == "choice"
                   else [p[0] for p in hp.value])
        return options[int(round(unit * (len(options) - 1)))]
    if kind in ("uniform", "quniform"):
        low, high = hp.as_tuple()
        v = low + unit * (high - low)
        return round(v) if kind == "quniform" else float(v)
    if kind in ("loguniform", "qloguniform"):
        low, high = hp.as_tuple()
        v = math.exp(math.log(low) + unit * (math.log(high) - math.log(low)))
        return round(v) if kind == "qloguniform" else float(v)
    if kind in DISCRETE_KINDS:
        values = enumerate_hp(hp)
        return values[int(round(unit * (len(values) - 1)))]
    if kind in ("normal", "qnormal", "lognormal", "qlognormal"):
        from statistics import NormalDist

        loc, scale = hp.as_tuple()
        unit = min(1.0 - 1e-9, max(1e-9, unit))
        z = NormalDist(loc, scale).inv_cdf(unit)
        if kind == "normal":
            return float(z)
        if kind == "qnormal":
            return round(z)
        v = math.exp(z)
        return round(v) if kind == "qlognormal" else float(v)
    raise SpaceError(f"Cannot denormalize kind {kind!r}")
