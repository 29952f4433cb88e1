"""Executors: turn compiled operations into real processes.

Local mode (SURVEY.md §7 step 4 — the minimum end-to-end slice) executes
components as host subprocesses with the same env-injection contract the
k8s converter uses in-cluster, so a spec runs identically under
``ptpu run`` on a laptop and under the operator on a TPU pod-slice.

The port's own copy of ``polyaxon_tpu/runner/__init__.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from .local import ExecutionError, LocalExecutor
