"""DAG execution: topological scheduling of member operations.

Parity: reference DAG runtime (SURVEY.md 2.4 ``V1Dag``): edges come from
explicit ``dependencies`` plus implicit ``params.ref == ops.<name>`` IO
references; ``concurrency`` bounds parallel ops; per-op ``trigger``
policies gate on upstream outcomes; failures propagate as
``upstream_failed`` unless the trigger tolerates them.

The port's own copy of ``polyaxon_tpu/runner/dag.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import threading
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Any, Dict, List, Optional, Set

from ..flow import V1Component, V1Operation
from ..lifecycle import V1Statuses


class DagError(RuntimeError):
    pass


class DagStopped(RuntimeError):
    """A member run was deliberately stopped; the dag finalizes as stopped."""


def _op_from_entry(entry: Any, components: Dict[str, V1Component]) -> V1Operation:
    if isinstance(entry, V1Operation):
        op = entry
    elif isinstance(entry, dict):
        op = V1Operation.from_dict(entry)
    else:
        raise DagError(f"Bad dag operation entry: {entry!r}")
    if op.component is None and op.dag_ref:
        comp = components.get(op.dag_ref)
        if comp is None:
            raise DagError(f"dagRef {op.dag_ref!r} matches no dag component")
        op = op.model_copy(update={"component": comp, "dag_ref": None})
    if op.component is None:
        raise DagError(
            f"Dag operation {op.name!r} has no component (inline or dagRef)"
        )
    return op


class DagRunner:
    def __init__(self, executor, compiled, pipeline_uuid: str):
        self.executor = executor
        self.pipeline_uuid = pipeline_uuid
        dag = compiled.run
        components = {}
        for centry in dag.components or []:
            comp = (centry if isinstance(centry, V1Component)
                    else V1Component.from_dict(centry))
            components[comp.name] = comp
        self.ops: Dict[str, V1Operation] = {}
        for entry in dag.operations or []:
            op = _op_from_entry(entry, components)
            if not op.name:
                raise DagError("Every dag operation needs a name")
            if op.name in self.ops:
                raise DagError(f"Duplicate dag operation name {op.name!r}")
            self.ops[op.name] = op
        self.concurrency = dag.concurrency or 4
        self.edges: Dict[str, Set[str]] = {name: set() for name in self.ops}
        for name, op in self.ops.items():
            for dep in op.dependencies or []:
                if dep not in self.ops:
                    raise DagError(
                        f"Operation {name!r} depends on unknown op {dep!r}"
                    )
                self.edges[name].add(dep)
            for param in (op.params or {}).values():
                if param.ref and param.ref.startswith("ops."):
                    dep = param.ref[len("ops."):]
                    if dep not in self.ops:
                        raise DagError(
                            f"Operation {name!r} references unknown op {dep!r}"
                        )
                    self.edges[name].add(dep)
        self._check_cycles()
        self.results: Dict[str, Dict[str, Any]] = {}
        self.statuses: Dict[str, str] = {}
        self._lock = threading.Lock()

    def _check_cycles(self) -> None:
        seen: Dict[str, int] = {}

        def visit(node: str, stack: List[str]):
            state = seen.get(node, 0)
            if state == 1:
                cycle = stack[stack.index(node):] + [node]
                raise DagError(f"Dag cycle: {' -> '.join(cycle)}")
            if state == 2:
                return
            seen[node] = 1
            for dep in self.edges[node]:
                visit(dep, stack + [node])
            seen[node] = 2

        for node in self.edges:
            visit(node, [])

    # ------------------------------------------------------------------

    def _upstream_ok(self, name: str) -> Optional[bool]:
        """True=run, False=skip (None is unused; kept for clarity)."""
        op = self.ops[name]
        trigger = op.trigger or "all_succeeded"
        deps = self.edges[name]
        stats = [self.statuses[d] for d in deps]
        if trigger == "all_succeeded":
            return all(s == V1Statuses.SUCCEEDED for s in stats)
        if trigger == "all_failed":
            return all(s in (V1Statuses.FAILED, V1Statuses.UPSTREAM_FAILED)
                       for s in stats)
        if trigger == "all_done":
            return True
        if trigger == "one_succeeded":
            return any(s == V1Statuses.SUCCEEDED for s in stats)
        if trigger == "one_failed":
            return any(s in (V1Statuses.FAILED, V1Statuses.UPSTREAM_FAILED)
                       for s in stats)
        if trigger == "one_done":
            return bool(stats)
        raise DagError(f"Unknown trigger {trigger!r} on op {name!r}")

    def _run_one(self, name: str) -> str:
        op = self.ops[name]
        deps = self.edges[name]
        dag_values: Dict[str, Any] = {}
        for dep in deps:
            for key, value in self.results.get(dep, {}).items():
                dag_values.setdefault(key, value)
                dag_values[f"{dep}.{key}"] = value

        def ref_resolver(ref: str, key: str):
            if ref.startswith("ops."):
                dep = ref[len("ops."):]
                outputs = self.results.get(dep, {})
                if key not in outputs:
                    raise DagError(
                        f"Op {name!r} wants output {key!r} of {dep!r} but "
                        f"it only produced {sorted(outputs)}"
                    )
                return outputs[key]
            if ref.startswith("runs."):
                return self.executor.store.get_run(
                    ref[len("runs."):]).get("outputs", {}).get(key)
            raise DagError(f"Unsupported ref {ref!r}")

        record = self.executor.run_operation_with_refs(
            op, dag_values=dag_values, ref_resolver=ref_resolver,
            pipeline=self.pipeline_uuid,
        )
        with self._lock:
            self.results[name] = record.get("outputs", {}) or {}
        return record["status"]

    def execute(self) -> Dict[str, str]:
        remaining = set(self.ops)
        futures = {}
        with ThreadPoolExecutor(max_workers=self.concurrency) as pool:
            while remaining or futures:
                ready = [
                    n for n in list(remaining)
                    if self.edges[n] <= set(self.statuses)
                ]
                skipped_any = False
                for name in ready:
                    remaining.discard(name)
                    if not self._upstream_ok(name):
                        skip_status = (
                            V1Statuses.UPSTREAM_FAILED
                            if any(self.statuses[d] in
                                   (V1Statuses.FAILED,
                                    V1Statuses.UPSTREAM_FAILED)
                                   for d in self.edges[name])
                            else V1Statuses.SKIPPED
                        )
                        self.statuses[name] = skip_status
                        skipped_any = True
                        continue
                    futures[pool.submit(self._run_one, name)] = name
                if skipped_any:
                    # Skip decisions may have made more ops ready.
                    continue
                if not futures:
                    if remaining:
                        raise DagError(
                            f"Deadlock: {sorted(remaining)} never became ready"
                        )
                    break
                done, _ = wait(list(futures), return_when=FIRST_COMPLETED)
                for fut in done:
                    name = futures.pop(fut)
                    try:
                        self.statuses[name] = fut.result()
                    except Exception:
                        self.statuses[name] = V1Statuses.FAILED
        stopped = [n for n, s in self.statuses.items()
                   if s == V1Statuses.STOPPED]
        if stopped:
            raise DagStopped(f"Dag stopped: members {sorted(stopped)}")
        failed = [n for n, s in self.statuses.items()
                  if s in (V1Statuses.FAILED, V1Statuses.UPSTREAM_FAILED)]
        if failed:
            raise DagError(f"Dag finished with failures: {sorted(failed)}")
        return self.statuses
