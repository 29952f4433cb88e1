"""Hyperparameter tuning (the polytune-equivalent).

Native implementations (no hyperopt/skopt dependency): grid & mapping
expansion, seeded random search, Hyperband bracket/rung successive halving,
GP-based Bayesian optimization, TPE (hyperopt-style), iterative sampling —
all driven by ``TuneController`` which creates child runs through an
executor and joins on tracked metrics (SURVEY.md 2.11, call stack 3.3).

The port's own copy of ``polyaxon_tpu/tune/__init__.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from .bayes import BayesManager, GaussianProcess
from .controller import TuneController, TuneError
from .asha import AshaJob, ASHAManager
from .hyperband import HyperbandManager, Rung
from .space import (
    SpaceError,
    enumerate_hp,
    from_unit,
    grid_params,
    sample_hp,
    sample_params,
    to_unit,
)
from .tpe import TPEManager
