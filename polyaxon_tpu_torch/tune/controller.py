"""Tuner controller: drives matrix operations as pipelines of child runs.

Parity: reference call stack 3.3 (SURVEY.md) — the controller computes
suggestion batches, creates child operations (bounded by ``concurrency``),
joins on tracked metrics from the store, applies early stopping, promotes
(hyperband) or re-suggests (bayes/TPE), and aggregates the final status +
best result onto the pipeline run.

The port's own copy of ``polyaxon_tpu/tune/controller.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Any, Dict, List, Optional

import numpy as np

from ..flow import V1Operation
from ..flow.matrix import (
    V1Asha,
    V1Bayes,
    V1FailureEarlyStopping,
    V1GridSearch,
    V1Hyperband,
    V1Hyperopt,
    V1Iterative,
    V1Mapping,
    V1MetricEarlyStopping,
    V1RandomSearch,
)
from ..lifecycle import V1Statuses
from .asha import ASHAManager
from .bayes import BayesManager
from .hyperband import HyperbandManager
from .space import grid_params, sample_params
from .tpe import TPEManager


class TuneError(RuntimeError):
    pass


class TuneController:
    def __init__(self, executor, operation: V1Operation, pipeline_uuid: str):
        if operation.matrix is None:
            raise TuneError("Operation has no matrix")
        self.executor = executor
        self.store = executor.store
        self.operation = operation
        self.matrix = operation.matrix
        self.pipeline_uuid = pipeline_uuid
        self.concurrency = getattr(self.matrix, "concurrency", None) or 4
        self.results: List[Dict[str, Any]] = []
        self._stop = threading.Event()
        self._stopped_by_user = False
        self._lock = threading.Lock()

    # ------------------------------------------------------------------

    def _metric_name(self) -> Optional[str]:
        metric = getattr(self.matrix, "metric", None)
        return metric.name if metric else None

    def _child_operation(self, index: int) -> V1Operation:
        name = self.operation.name or "tune"
        return self.operation.model_copy(update={
            "matrix": None,
            "schedule": None,
            "name": f"{name}-{index}",
        })

    def _run_child(self, index: int, params: Dict[str, Any],
                   extra_meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Execute one suggestion; returns {'params', 'metric', 'status', 'uuid'}."""
        self._poll_pipeline_stop()
        if self._stop.is_set():
            out = {"params": params, "metric": None, "metrics": {},
                   "status": V1Statuses.SKIPPED, "uuid": None}
            with self._lock:
                self.results.append(out)
            return out
        op = self._child_operation(index)
        try:
            record = self.executor.run_operation(
                op, matrix_values=params, pipeline=self.pipeline_uuid)
            uuid = record["uuid"]
            if extra_meta:
                self.store.update_run(uuid, meta_info=extra_meta)
            metrics = self.store.last_metrics(uuid)
            metric_name = self._metric_name()
            metric = metrics.get(metric_name) if metric_name else None
            out = {"params": params, "metric": metric, "metrics": metrics,
                   "status": record["status"], "uuid": uuid}
        except Exception as e:  # child failure must not kill the sweep
            out = {"params": params, "metric": None, "metrics": {},
                   "status": V1Statuses.FAILED, "uuid": None,
                   "error": str(e)}
        with self._lock:
            self.results.append(out)
            self._check_early_stopping()
        return out

    def _poll_pipeline_stop(self) -> None:
        """Honor `ops stop <pipeline-uuid>`: stop launching trials."""
        try:
            status = self.store.get_run(self.pipeline_uuid).get("status")
        except Exception:
            return
        if status in (V1Statuses.STOPPING, V1Statuses.STOPPED):
            self._stopped_by_user = True
            self._stop.set()

    def _check_early_stopping(self) -> None:
        for policy in getattr(self.matrix, "early_stopping", None) or []:
            if isinstance(policy, V1MetricEarlyStopping):
                for r in self.results:
                    # The policy names its own metric series — it need not
                    # be the sweep's optimization metric.
                    v = (r.get("metrics") or {}).get(policy.metric)
                    if v is None:
                        continue
                    hit = (v >= policy.value
                           if policy.optimization == "maximize"
                           else v <= policy.value)
                    if hit:
                        self._stop.set()
                        return
            elif isinstance(policy, V1FailureEarlyStopping):
                done = [r for r in self.results]
                if done:
                    failed = sum(1 for r in done
                                 if r["status"] == V1Statuses.FAILED)
                    if 100.0 * failed / len(done) >= policy.percent:
                        self._stop.set()
                        return

    def _run_batch(self, suggestions: List[Dict[str, Any]],
                   start_index: int,
                   extra_meta: Optional[Dict[str, Any]] = None
                   ) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        with ThreadPoolExecutor(max_workers=self.concurrency) as pool:
            futures = {
                pool.submit(self._run_child, start_index + i, params,
                            extra_meta): i
                for i, params in enumerate(suggestions)
            }
            for fut in as_completed(futures):
                out.append(fut.result())
        return out

    # ------------------------------------------------------------------

    def execute(self) -> Dict[str, Any]:
        self.store.set_status(self.pipeline_uuid, V1Statuses.RUNNING,
                              reason="TuneController", force=True)
        try:
            matrix = self.matrix
            if isinstance(matrix, V1Mapping):
                self._run_batch(list(matrix.values), 0)
            elif isinstance(matrix, V1GridSearch):
                self._run_batch(grid_params(matrix.params, matrix.num_runs), 0)
            elif isinstance(matrix, V1RandomSearch):
                rng = np.random.default_rng(matrix.seed)
                suggestions = [sample_params(matrix.params, rng)
                               for _ in range(matrix.num_runs)]
                self._run_batch(suggestions, 0)
            elif isinstance(matrix, V1Hyperband):
                self._run_hyperband(matrix)
            elif isinstance(matrix, V1Asha):
                self._run_asha(matrix)
            elif isinstance(matrix, V1Bayes):
                self._run_bayes(matrix)
            elif isinstance(matrix, V1Hyperopt):
                self._run_hyperopt(matrix)
            elif isinstance(matrix, V1Iterative):
                self._run_iterative(matrix)
            else:
                raise TuneError(f"Unsupported matrix kind: {matrix.kind}")
        except Exception as e:
            self.store.set_status(self.pipeline_uuid, V1Statuses.FAILED,
                                  reason="TuneController", message=str(e),
                                  force=True)
            raise

        return self._finalize()

    # -- per-algorithm drivers -------------------------------------------

    def _run_hyperband(self, matrix: V1Hyperband) -> None:
        mgr = HyperbandManager(matrix)
        index = 0
        for s in mgr.brackets():
            if self._stop.is_set():
                break
            rungs = mgr.rungs(s)
            population = mgr.initial_suggestions(s)
            for rung in rungs:
                if self._stop.is_set():
                    break
                population = population[:rung.n_configs]
                resource_value = mgr.resource_value(rung)
                suggestions = [
                    {**params, matrix.resource.name: resource_value}
                    for params in population
                ]
                batch = self._run_batch(
                    suggestions, index,
                    extra_meta={"bracket": s, "rung": rung.rung},
                )
                index += len(batch)
                keep = mgr.promote_count(s, rung.rung)
                if keep <= 0:
                    break
                top = mgr.select_top(batch, keep)
                population = [
                    {k: v for k, v in r["params"].items()
                     if k != matrix.resource.name}
                    for r in top
                ]
                if not population:
                    break

    def _run_asha(self, matrix: V1Asha) -> None:
        """Barrier-free worker pool: each free worker asks the manager
        for a promotion or a fresh config the moment it idles; a worker
        with nothing to do waits on the condition because a straggler's
        completion can unlock promotions.  Contrast _run_hyperband,
        whose rungs are batch barriers."""
        mgr = ASHAManager(matrix)
        cond = threading.Condition()
        state = {"inflight": 0, "index": 0}

        def worker():
            while True:
                with cond:
                    if self._stop.is_set():
                        cond.notify_all()
                        return
                    job = mgr.next_job()
                    while job is None and state["inflight"] > 0 \
                            and not self._stop.is_set():
                        cond.wait(timeout=0.5)
                        job = mgr.next_job()
                    if job is None or self._stop.is_set():
                        cond.notify_all()
                        return
                    state["inflight"] += 1
                    idx = state["index"]
                    state["index"] += 1
                # finally-guarded: an exception escaping _run_child
                # (e.g. early-stopping policy math on a bad metric
                # value) must still decrement inflight, or every other
                # worker waits on the condition forever.
                out = None
                try:
                    params = {**job.params,
                              matrix.resource.name: job.resource}
                    out = self._run_child(idx, params, extra_meta={
                        "rung": job.rung, "config_id": job.config_id})
                finally:
                    with cond:
                        ok = out is not None and \
                            out["status"] == V1Statuses.SUCCEEDED
                        mgr.report(job,
                                   out.get("metric") if ok else None)
                        state["inflight"] -= 1
                        cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.concurrency)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def _run_bayes(self, matrix: V1Bayes) -> None:
        mgr = BayesManager(matrix)
        self._run_batch(mgr.initial_suggestions(), 0)
        for i in range(matrix.max_iterations):
            if self._stop.is_set():
                break
            with self._lock:
                observations = list(self.results)
            params = mgr.suggest(observations)
            self._run_batch([params], len(self.results))

    def _run_hyperopt(self, matrix: V1Hyperopt) -> None:
        mgr = TPEManager(matrix)
        n_initial = min(4, matrix.num_runs)
        rng = np.random.default_rng(matrix.seed)
        self._run_batch([sample_params(matrix.params, rng)
                         for _ in range(n_initial)], 0)
        for i in range(matrix.num_runs - n_initial):
            if self._stop.is_set():
                break
            with self._lock:
                observations = list(self.results)
            self._run_batch([mgr.suggest(observations)], len(self.results))

    def _run_iterative(self, matrix: V1Iterative) -> None:
        rng = np.random.default_rng(matrix.seed)
        for i in range(matrix.max_iterations):
            if self._stop.is_set():
                break
            self._run_batch([sample_params(matrix.params, rng)],
                            len(self.results))

    # ------------------------------------------------------------------

    def _finalize(self) -> Dict[str, Any]:
        metric_name = self._metric_name()
        succeeded = [r for r in self.results
                     if r["status"] == V1Statuses.SUCCEEDED]
        outputs: Dict[str, Any] = {
            "num_trials": len(self.results),
            "num_succeeded": len(succeeded),
            "num_failed": sum(1 for r in self.results
                              if r["status"] == V1Statuses.FAILED),
        }
        if metric_name:
            metric = getattr(self.matrix, "metric")
            scored = [r for r in self.results if r.get("metric") is not None]
            if scored:
                best = (max if metric.optimization == "maximize" else min)(
                    scored, key=lambda r: r["metric"])
                outputs["best_metric"] = best["metric"]
                outputs["best_params"] = best["params"]
                outputs["best_run"] = best["uuid"]
        self.store.update_run(self.pipeline_uuid, outputs=outputs)
        if self._stopped_by_user:
            status = V1Statuses.STOPPED
        elif succeeded:
            status = V1Statuses.SUCCEEDED
        else:
            status = V1Statuses.FAILED
        self.store.set_status(self.pipeline_uuid, status,
                              reason="TuneController", force=True)
        return self.store.get_run(self.pipeline_uuid)
