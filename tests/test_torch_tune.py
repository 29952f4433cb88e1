"""The port's tuner (``tune/``) against the JAX package's.

Each package's ``TuneController`` drives one sweep through an executor
that records a run per suggestion in that package's own file store, with
a metric that is a fixed function of the suggested params (the same
observations for both).  With one trial at a time the sweep is
deterministic, so the two packages must suggest the same params in the
same order, end on the same best run's params, and schedule the same
resources.
"""

from __future__ import annotations

import math

import pytest
import torch

from polyaxon_tpu.client import FileRunStore as JStore
from polyaxon_tpu.flow import V1Operation as JOperation
from polyaxon_tpu.tune import TuneController as JController
from polyaxon_tpu_torch.client import FileRunStore as TStore
from polyaxon_tpu_torch.flow import V1Operation as TOperation
from polyaxon_tpu_torch.tune import TuneController as TController

torch.set_num_threads(2)

PARAMS = {"lr": {"kind": "loguniform", "value": [1e-5, 1e-1]},
          "units": {"kind": "choice", "value": [32, 64, 128]}}
RESOURCE = {"name": "steps", "type": "int"}
LOSS = {"name": "loss", "optimization": "minimize"}

MATRICES = {
    "grid": {"kind": "grid", "params": {
        "lr": {"kind": "logspace", "value": "-4:-1:4"},
        "units": {"kind": "range", "value": [32, 129, 48]}}},
    "random": {"kind": "random", "numRuns": 6, "seed": 3,
               "params": PARAMS},
    "hyperband": {"kind": "hyperband", "maxIterations": 9, "eta": 3,
                  "seed": 1, "resource": RESOURCE, "metric": LOSS,
                  "params": PARAMS},
    "asha": {"kind": "asha", "numRuns": 6, "maxIterations": 9, "eta": 3,
             "minResource": 1, "seed": 2, "resource": RESOURCE,
             "metric": LOSS, "params": PARAMS},
    "bayes": {"kind": "bayes", "numInitialRuns": 3, "maxIterations": 4,
              "seed": 4, "metric": LOSS, "params": PARAMS},
    "tpe": {"kind": "hyperopt", "algorithm": "tpe", "numRuns": 8,
            "seed": 5, "metric": LOSS, "params": PARAMS},
}


def _loss(params) -> float:
    """A fixed, data-free objective: best near lr=1e-3, units=64, and
    lower with more steps."""
    return (math.log10(params["lr"]) + 3) ** 2 \
        + abs(params["units"] - 64) / 64 + 1 / (1 + params.get("steps", 1))


class _Executor:
    """Records each suggestion as a succeeded run with its loss."""

    def __init__(self, store):
        self.store = store
        self.suggestions = []

    def run_operation(self, op, matrix_values=None, pipeline=None):
        self.suggestions.append(dict(matrix_values))
        rec = self.store.create_run(name=op.name, pipeline=pipeline,
                                    meta_info={"matrix_values":
                                               matrix_values})
        self.store.append_events(rec["uuid"], "metric", "loss",
                                 [{"step": 1, "value": _loss(matrix_values),
                                   "timestamp": 0.0}])
        for status in ("running", "succeeded"):
            self.store.set_status(rec["uuid"], status, force=True)
        return self.store.get_run(rec["uuid"])


def _sweep(store_cls, op_cls, controller_cls, matrix, home):
    store = store_cls(str(home))
    op = op_cls.from_dict({
        "kind": "operation", "name": "sweep",
        "matrix": {**matrix, "concurrency": 1},
        "component": {"kind": "component", "name": "trainer",
                      "inputs": [{"name": "lr", "type": "float"},
                                 {"name": "units", "type": "int"},
                                 {"name": "steps", "type": "int",
                                  "value": 1, "isOptional": True}],
                      "run": {"kind": "job",
                              "container": {"command": ["true"]}}}})
    executor = _Executor(store)
    parent = store.create_run(name="sweep")
    record = controller_cls(executor, op, parent["uuid"]).execute()
    return executor.suggestions, record


@pytest.mark.parametrize("algorithm", list(MATRICES))
def test_suggestions_match_reference(algorithm, tmp_path):
    matrix = MATRICES[algorithm]
    j_seq, j_rec = _sweep(JStore, JOperation, JController, matrix,
                          tmp_path / "jax")
    t_seq, t_rec = _sweep(TStore, TOperation, TController, matrix,
                          tmp_path / "torch")
    assert len(t_seq) > 1
    assert t_seq == j_seq
    assert t_rec["status"] == j_rec["status"] == "succeeded"
    # best_run names a run uuid, which each store draws at random.
    assert {k: v for k, v in t_rec["outputs"].items() if k != "best_run"} \
        == {k: v for k, v in j_rec["outputs"].items() if k != "best_run"}
    assert ("best_params" in t_rec["outputs"]) == ("metric" in matrix)
    if "resource" in matrix:
        assert len({s["steps"] for s in t_seq}) > 1  # promotions happened
