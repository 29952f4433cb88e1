"""Matrix (hyperparameter search space) schemas.

Parity with the reference's ``V1Matrix*`` kinds (SURVEY.md 2.11; expected at
``polyaxon/_flow/matrix/`` — unverified): grid / random / hyperband / bayes /
hyperopt / iterative / mapping, plus hp-distribution vocabulary and early
stopping policies.  The algorithms themselves live in ``polyaxon_tpu_torch.tune``;
these schemas are the declarative surface.

The port's own copy of ``polyaxon_tpu/flow/matrix.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Any, Dict, List, Literal, Optional, Union

from pydantic import field_validator

from .base import BaseSchema

# ---------------------------------------------------------------------------
# HP distributions
# ---------------------------------------------------------------------------


class V1HpChoice(BaseSchema):
    kind: Literal["choice"] = "choice"
    value: List[Any]


class V1HpPChoice(BaseSchema):
    """Weighted choice: value is a list of [option, probability] pairs."""

    kind: Literal["pchoice"] = "pchoice"
    value: List[Any]

    @field_validator("value")
    @classmethod
    def _check(cls, v):
        total = 0.0
        for pair in v:
            if not isinstance(pair, (list, tuple)) or len(pair) != 2:
                raise ValueError("pchoice entries must be [option, prob] pairs")
            try:
                prob = float(pair[1])
            except (TypeError, ValueError):
                raise ValueError(
                    f"pchoice probability must be a number, got {pair[1]!r}"
                )
            if prob < 0:
                raise ValueError(f"pchoice probability must be >= 0, got {prob}")
            total += prob
        if abs(total - 1.0) > 1e-6:
            raise ValueError(f"pchoice probabilities must sum to 1, got {total}")
        return v


class V1HpRange(BaseSchema):
    kind: Literal["range"] = "range"
    value: Any  # [start, stop, step] or {"start":..,"stop":..,"step":..}

    def as_tuple(self):
        v = self.value
        if isinstance(v, dict):
            return v["start"], v["stop"], v.get("step", 1)
        if isinstance(v, str):
            parts = [float(x) for x in v.split(":")]
            return tuple(parts) if len(parts) == 3 else (*parts, 1)
        return v[0], v[1], (v[2] if len(v) > 2 else 1)


class _SpaceDist(BaseSchema):
    value: Any  # [start, stop, num] | {"start":..} | "start:stop:num"

    def as_tuple(self):
        v = self.value
        if isinstance(v, dict):
            return v["start"], v["stop"], int(v.get("num", 10))
        if isinstance(v, str):
            parts = v.split(":")
            if len(parts) not in (2, 3):
                raise ValueError(
                    f"{self.kind} expects 'start:stop:num', got {v!r}")
            start, stop = float(parts[0]), float(parts[1])
            num = int(parts[2]) if len(parts) == 3 else 10
            return start, stop, num
        return v[0], v[1], int(v[2])


class V1HpLinSpace(_SpaceDist):
    kind: Literal["linspace"] = "linspace"


class V1HpLogSpace(_SpaceDist):
    kind: Literal["logspace"] = "logspace"


class V1HpGeomSpace(_SpaceDist):
    kind: Literal["geomspace"] = "geomspace"


class _Dist2(BaseSchema):
    value: Any  # [low, high] or {"low":..,"high":..}

    def as_tuple(self):
        v = self.value
        if isinstance(v, dict):
            if "low" in v:
                return v["low"], v["high"]
            return v["loc"], v["scale"]
        return v[0], v[1]


class V1HpUniform(_Dist2):
    kind: Literal["uniform"] = "uniform"


class V1HpQUniform(_Dist2):
    kind: Literal["quniform"] = "quniform"


class V1HpLogUniform(_Dist2):
    kind: Literal["loguniform"] = "loguniform"


class V1HpQLogUniform(_Dist2):
    kind: Literal["qloguniform"] = "qloguniform"


class V1HpNormal(_Dist2):
    kind: Literal["normal"] = "normal"


class V1HpQNormal(_Dist2):
    kind: Literal["qnormal"] = "qnormal"


class V1HpLogNormal(_Dist2):
    kind: Literal["lognormal"] = "lognormal"


class V1HpQLogNormal(_Dist2):
    kind: Literal["qlognormal"] = "qlognormal"


V1HpParam = Union[
    V1HpChoice, V1HpPChoice, V1HpRange, V1HpLinSpace, V1HpLogSpace,
    V1HpGeomSpace, V1HpUniform, V1HpQUniform, V1HpLogUniform,
    V1HpQLogUniform, V1HpNormal, V1HpQNormal, V1HpLogNormal, V1HpQLogNormal,
]

HP_BY_KIND = {
    "choice": V1HpChoice, "pchoice": V1HpPChoice, "range": V1HpRange,
    "linspace": V1HpLinSpace, "logspace": V1HpLogSpace,
    "geomspace": V1HpGeomSpace, "uniform": V1HpUniform,
    "quniform": V1HpQUniform, "loguniform": V1HpLogUniform,
    "qloguniform": V1HpQLogUniform, "normal": V1HpNormal,
    "qnormal": V1HpQNormal, "lognormal": V1HpLogNormal,
    "qlognormal": V1HpQLogNormal,
}

# Distributions a grid search can enumerate exhaustively.
DISCRETE_KINDS = {"choice", "range", "linspace", "logspace", "geomspace"}


def parse_hp_params(data: Optional[Dict[str, Any]]) -> Optional[Dict[str, V1HpParam]]:
    if data is None:
        return None
    out = {}
    for name, spec in data.items():
        if isinstance(spec, dict):
            kind = spec.get("kind")
            cls = HP_BY_KIND.get(kind)
            if cls is None:
                raise ValueError(f"Unknown hp kind {kind!r} for param {name!r}")
            out[name] = cls.from_dict(spec)
        else:
            out[name] = spec
    return out


# ---------------------------------------------------------------------------
# Early stopping
# ---------------------------------------------------------------------------


class V1MetricEarlyStopping(BaseSchema):
    kind: Literal["metric_early_stopping"] = "metric_early_stopping"
    metric: str
    value: float
    optimization: Literal["maximize", "minimize"] = "maximize"
    policy: Optional[Dict[str, Any]] = None


class V1FailureEarlyStopping(BaseSchema):
    kind: Literal["failure_early_stopping"] = "failure_early_stopping"
    percent: float


V1EarlyStopping = Union[V1MetricEarlyStopping, V1FailureEarlyStopping]


class V1OptimizationMetric(BaseSchema):
    name: str
    optimization: Literal["maximize", "minimize"] = "maximize"

    def is_better(self, a: float, b: float) -> bool:
        """True if a is strictly better than b."""
        return a > b if self.optimization == "maximize" else a < b


class V1OptimizationResource(BaseSchema):
    """Hyperband resource axis (e.g. epochs or steps)."""

    name: str
    type: Literal["int", "float"] = "int"

    def cast(self, v):
        return int(v) if self.type == "int" else float(v)


# ---------------------------------------------------------------------------
# Matrix kinds
# ---------------------------------------------------------------------------


class V1GridSearch(BaseSchema):
    kind: Literal["grid"] = "grid"
    params: Dict[str, Any]
    num_runs: Optional[int] = None
    concurrency: Optional[int] = None
    early_stopping: Optional[List[V1EarlyStopping]] = None

    @field_validator("params")
    @classmethod
    def _parse(cls, v):
        parsed = parse_hp_params(v)
        for name, hp in (parsed or {}).items():
            kind = getattr(hp, "kind", None)
            if kind is not None and kind not in DISCRETE_KINDS:
                raise ValueError(
                    f"Grid search param {name!r} uses continuous distribution "
                    f"{kind!r}; grid requires one of {sorted(DISCRETE_KINDS)}"
                )
        return parsed


class V1RandomSearch(BaseSchema):
    kind: Literal["random"] = "random"
    params: Dict[str, Any]
    num_runs: int = 10
    seed: Optional[int] = None
    concurrency: Optional[int] = None
    early_stopping: Optional[List[V1EarlyStopping]] = None

    @field_validator("params")
    @classmethod
    def _parse(cls, v):
        return parse_hp_params(v)


class V1Hyperband(BaseSchema):
    """Successive-halving brackets (Li et al.): parity with reference
    hyperband bracket/rung math (SURVEY.md 2.11/3.3)."""

    kind: Literal["hyperband"] = "hyperband"
    params: Dict[str, Any]
    max_iterations: int
    eta: float = 3
    resource: V1OptimizationResource
    metric: V1OptimizationMetric
    resume: Optional[bool] = None
    seed: Optional[int] = None
    concurrency: Optional[int] = None
    early_stopping: Optional[List[V1EarlyStopping]] = None

    @field_validator("params")
    @classmethod
    def _parse(cls, v):
        return parse_hp_params(v)


class V1Asha(BaseSchema):
    """Asynchronous successive halving (Li et al. 2020) — barrier-free
    promotions, built for straggler-heavy TPU fleets (preemptions,
    queue delays).  An ADDITION over the reference's matrix kinds
    (SURVEY.md 2.11 tops out at hyperband); the synchronous math lives
    in tune/hyperband.py, the async manager in tune/asha.py."""

    kind: Literal["asha"] = "asha"
    params: Dict[str, Any]
    num_runs: int
    max_iterations: int
    eta: float = 3
    min_resource: float = 1
    resource: V1OptimizationResource
    metric: V1OptimizationMetric
    seed: Optional[int] = None
    concurrency: Optional[int] = None
    early_stopping: Optional[List[V1EarlyStopping]] = None

    @field_validator("params")
    @classmethod
    def _parse(cls, v):
        return parse_hp_params(v)


class V1Bayes(BaseSchema):
    kind: Literal["bayes"] = "bayes"
    params: Dict[str, Any]
    num_initial_runs: int = 5
    max_iterations: int = 10
    metric: V1OptimizationMetric
    utility_function: Optional[Dict[str, Any]] = None
    seed: Optional[int] = None
    concurrency: Optional[int] = None
    early_stopping: Optional[List[V1EarlyStopping]] = None

    @field_validator("params")
    @classmethod
    def _parse(cls, v):
        return parse_hp_params(v)


class V1Hyperopt(BaseSchema):
    """TPE-style search (reference delegates to hyperopt; we implement TPE
    natively in ``polyaxon_tpu_torch.tune.tpe``)."""

    kind: Literal["hyperopt"] = "hyperopt"
    params: Dict[str, Any]
    num_runs: int = 10
    max_iterations: Optional[int] = None
    algorithm: Literal["tpe", "rand", "anneal"] = "tpe"
    metric: Optional[V1OptimizationMetric] = None
    seed: Optional[int] = None
    concurrency: Optional[int] = None
    early_stopping: Optional[List[V1EarlyStopping]] = None

    @field_validator("params")
    @classmethod
    def _parse(cls, v):
        return parse_hp_params(v)


class V1Iterative(BaseSchema):
    """User-driven iterative tuning: a tuner container proposes suggestions."""

    kind: Literal["iterative"] = "iterative"
    params: Dict[str, Any]
    max_iterations: int
    seed: Optional[int] = None
    tuner: Optional[Dict[str, Any]] = None
    concurrency: Optional[int] = None
    early_stopping: Optional[List[V1EarlyStopping]] = None

    @field_validator("params")
    @classmethod
    def _parse(cls, v):
        return parse_hp_params(v)


class V1Mapping(BaseSchema):
    """Explicit list of param dicts — one child run per entry."""

    kind: Literal["mapping"] = "mapping"
    values: List[Dict[str, Any]]
    concurrency: Optional[int] = None
    early_stopping: Optional[List[V1EarlyStopping]] = None


V1Matrix = Union[
    V1GridSearch, V1RandomSearch, V1Hyperband, V1Asha, V1Bayes,
    V1Hyperopt, V1Iterative, V1Mapping,
]

MATRIX_BY_KIND = {
    "grid": V1GridSearch,
    "random": V1RandomSearch,
    "hyperband": V1Hyperband,
    "asha": V1Asha,
    "bayes": V1Bayes,
    "hyperopt": V1Hyperopt,
    "iterative": V1Iterative,
    "mapping": V1Mapping,
}


def parse_matrix(data):
    if data is None or not isinstance(data, dict):
        return data
    kind = data.get("kind")
    cls = MATRIX_BY_KIND.get(kind)
    if cls is None:
        raise ValueError(
            f"Unknown matrix kind {kind!r}; expected one of {sorted(MATRIX_BY_KIND)}"
        )
    return cls.from_dict(data)


