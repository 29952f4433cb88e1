"""Local executor.

Execution semantics per run kind:

- ``job``:     one subprocess (command/args from the container spec).
- ``tpujob``/``tfjob``/``pytorchjob``/``mpijob``: N subprocesses — one per
  process in the normalized topology — each receiving the same PTPU_* env
  block the agent would inject in-cluster (coordinator on localhost).
  This is the "multi-node without a cluster" harness (SURVEY.md §4).
- ``dag``:     topological execution of member operations with concurrency.
- ``service``: spawned DETACHED in its own session (logs to the run's
  log file), gated on port readiness, left RUNNING; ``ops stop`` reaps
  it via the recorded pid (cli.main._reap_local_service).

Matrix operations are handled by the tuner controller
(``polyaxon_tpu_torch.tune.controller``), which calls back into this executor
for each child run.

The port's own copy of ``polyaxon_tpu/runner/local.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import json
import logging
import os
import shlex
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from ..client import FileRunStore, RunClient
from ..client.run_client import ENV_PROJECT, ENV_RUN_UUID
from ..compiler import normalize, resolve
from ..compiler.resolver import make_compiled
from ..compiler.topology import ProcessTopology
from ..flow import V1Operation
from ..flow.run import RunKind
from ..lifecycle import V1Statuses


logger = logging.getLogger(__name__)


class ExecutionError(RuntimeError):
    pass


class StopRequested(Exception):
    """Raised inside _wait when ``ops stop`` flipped the run to stopping."""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _merge_container_env(env, container) -> None:
    """Overlay the container's literal env entries onto ``env`` (one
    place: job, distributed, and service spawns all share it)."""
    for e in (container.env or []):
        if e.value is not None:
            env[e.name] = str(e.value)


def _port_open(host: str, port: int, timeout: float = 0.5) -> bool:
    try:
        with socket.create_connection((host, port), timeout=timeout):
            return True
    except OSError:
        return False


class LocalExecutor:
    def __init__(self, store: Optional[FileRunStore] = None,
                 project: str = "default", stream_logs: bool = False):
        self.store = store or FileRunStore()
        self.project = project
        self.stream_logs = stream_logs

    # ------------------------------------------------------------------

    def create_run(self, operation: V1Operation,
                   pipeline: Optional[str] = None,
                   meta_info: Optional[Dict[str, Any]] = None) -> str:
        record = self.store.create_run(
            name=operation.name,
            project=self.project,
            description=operation.description,
            tags=operation.tags,
            content=operation.to_dict(),
            kind=getattr(operation.component.run, "kind", None)
            if operation.has_component else None,
            pipeline=pipeline,
            meta_info=meta_info,
        )
        return record["uuid"]

    def run_operation(
        self,
        operation: V1Operation,
        run_uuid: Optional[str] = None,
        matrix_values: Optional[Dict[str, Any]] = None,
        dag_values: Optional[Dict[str, Any]] = None,
        pipeline: Optional[str] = None,
        timeout: Optional[float] = None,
        ref_resolver=None,
    ) -> Dict[str, Any]:
        """Execute synchronously; returns the final run record."""
        if operation.matrix is not None:
            from ..tune.controller import TuneController

            run_uuid = run_uuid or self.create_run(operation,
                                                   pipeline=pipeline)
            controller = TuneController(self, operation, run_uuid)
            try:
                controller.execute()
            finally:
                # Sweep-level hooks fire once on the parent — also on
                # failure paths where execute() raises (the controller
                # has already set the terminal status).
                try:
                    self._finalize(run_uuid, make_compiled(operation))
                except Exception:  # noqa: BLE001 - hooks never mask
                    logger.debug("sweep finalize hooks failed",
                                 exc_info=True)
            return self.store.get_run(run_uuid)

        run_uuid = run_uuid or self.create_run(
            operation, pipeline=pipeline,
            meta_info={"matrix_values": matrix_values} if matrix_values else None,
        )
        try:
            from .joins import get_joins, resolve_joins

            join_values = None
            if get_joins(operation):
                join_values = resolve_joins(operation, self.store,
                                            project=self.project)
            compiled = resolve(
                operation, run_uuid=run_uuid, project=self.project,
                matrix_values=matrix_values, dag_values=dag_values,
                ref_resolver=ref_resolver, store_path=self.store.home,
                join_values=join_values,
            )
        except Exception as e:
            self.store.set_status(run_uuid, V1Statuses.FAILED,
                                  reason="CompilationError", message=str(e),
                                  force=True)
            # failed-trigger hooks still fire (hooks live on the raw
            # component; resolution never got that far)
            try:
                self._finalize(run_uuid, make_compiled(operation))
            except Exception:  # noqa: BLE001 - best effort on a failure
                logger.debug("failed-run finalize hooks failed",
                             exc_info=True)
            raise

        self.store.update_run(
            run_uuid,
            inputs=compiled.get_io_dict(),
        )
        self.store.set_status(run_uuid, V1Statuses.COMPILED,
                              reason="LocalExecutor")

        # Run memoization (SURVEY 2.3 V1Cache): with `cache: {}` declared
        # (and not disabled), an identical (component, inputs) run reuses
        # a prior SUCCEEDED run's outputs instead of re-executing.
        # Opt-in here (the reference defaults caching ON inside
        # pipelines; explicit declaration keeps local reuse predictable).
        cached = self._try_cache(run_uuid, operation, compiled)
        if cached is not None:
            return cached

        kind = compiled.run_kind
        termination = compiled.termination
        max_retries = (termination.max_retries if termination and
                       termination.max_retries else 0)
        timeout = timeout or (termination.timeout if termination else None)

        attempt = 0
        while True:
            try:
                if kind == RunKind.JOB:
                    self._run_job(run_uuid, compiled, timeout)
                elif kind in RunKind.DISTRIBUTED:
                    self._run_distributed(run_uuid, compiled, timeout)
                elif kind == RunKind.DAG:
                    self._run_dag(run_uuid, operation, compiled)
                elif kind == RunKind.SERVICE:
                    # Detached: the run stays RUNNING after we return;
                    # `ops stop` reaps it via the recorded pid.
                    self._run_service(run_uuid, compiled)
                    return self.store.get_run(run_uuid)
                else:
                    raise ExecutionError(
                        f"Run kind {kind!r} is not executable locally")
                break
            except StopRequested:
                self.store.set_status(run_uuid, V1Statuses.STOPPED,
                                      reason="StopRequested")
                return self._finalize(run_uuid, compiled)
            except ExecutionError as e:
                attempt += 1
                if attempt > max_retries:
                    self.store.set_status(run_uuid, V1Statuses.FAILED,
                                          reason="ExecutionError",
                                          message=str(e), force=True)
                    return self._finalize(run_uuid, compiled)
                self.store.set_status(run_uuid, V1Statuses.RETRYING,
                                      reason="Retry",
                                      message=f"attempt {attempt}", force=True)

        self.store.set_status(run_uuid, V1Statuses.SUCCEEDED,
                              reason="LocalExecutor")
        return self._finalize(run_uuid, compiled)

    def _cache_fingerprint(self, run_uuid: str, compiled, cache) -> str:
        """sha256 over the RESOLVED run section + inputs.

        Hashing the compiled run (not the raw component) means
        ``runPatch`` edits and matrix-templated commands fingerprint
        differently — two runs only match when the program they would
        execute is identical.  Run-scoped values (``{{ globals.* }}``
        paths embed the uuid) are masked so they don't defeat caching.
        ``cache.io_keys`` restricts which declared inputs participate;
        values already substituted into the command remain part of the
        run-section hash.
        """
        import hashlib

        inputs = compiled.get_io_dict()
        if cache.io_keys:
            inputs = {k: v for k, v in inputs.items()
                      if k in set(cache.io_keys)}
        run_dict = compiled.run.to_dict() if compiled.run is not None \
            else None
        blob = json.dumps({"run": run_dict, "inputs": inputs},
                          sort_keys=True, default=str)
        blob = blob.replace(run_uuid, "{run_uuid}")
        return hashlib.sha256(blob.encode()).hexdigest()

    def _try_cache(self, run_uuid: str, operation, compiled):
        """Cache lookup; returns the finished record on a hit, else None.

        A hit copies the prior run's outputs (record fields, the
        artifacts/outputs tree, AND tracked events — the tuner joins on
        metrics) and marks this run succeeded with
        ``meta_info.cache_hit``.
        """
        cache = compiled.cache
        if cache is None or cache.disable:
            return None

        fingerprint = self._cache_fingerprint(run_uuid, compiled, cache)
        self.store.update_run(run_uuid,
                              meta_info={"cache_fingerprint": fingerprint})

        now = time.time()
        # Newest-first, succeeded-only, bounded scan: the cache is an
        # optimization — missing a hit older than the window is fine,
        # reading every record in a huge store every run is not.
        candidates = self.store.list_runs(
            project=self.project,
            query=f"status:{V1Statuses.SUCCEEDED}",
            sort="-created_at", limit=500)
        for record in candidates:
            if record["uuid"] == run_uuid:
                continue
            meta = record.get("meta_info") or {}
            if meta.get("cache_fingerprint") != fingerprint:
                continue
            finished = record.get("finished_at") or record.get(
                "updated_at") or 0
            if cache.ttl and now - float(finished or 0) > cache.ttl:
                continue
            if self._copy_cached(record["uuid"], run_uuid):
                self.store.update_run(
                    run_uuid,
                    outputs=record.get("outputs") or {},
                    meta_info={"cache_hit": record["uuid"]})
                self.store.set_status(
                    run_uuid, V1Statuses.SUCCEEDED, reason="CacheHit",
                    message=f"reused outputs of {record['uuid']}",
                    force=True)
                return self._finalize(run_uuid, compiled)
        return None

    def _copy_cached(self, src_uuid: str, dst_uuid: str) -> bool:
        """Copy outputs + tracked events from a prior run; on failure
        (prior run deleted mid-copy) remove the debris and report a
        miss."""
        import shutil

        pairs = [
            (self.store.outputs_path(src_uuid),
             self.store.outputs_path(dst_uuid)),
            # events carry the metrics the tuner/queries join on
            (os.path.join(self.store.run_path(src_uuid), "events"),
             os.path.join(self.store.run_path(dst_uuid), "events")),
        ]
        try:
            for src, dst in pairs:
                if os.path.isdir(src):
                    shutil.copytree(src, dst, dirs_exist_ok=True)
            return True
        except OSError:
            for _, dst in pairs:  # no phantom artifacts from a dead run
                shutil.rmtree(dst, ignore_errors=True)
                os.makedirs(dst, exist_ok=True)
            return False

    def _finalize(self, run_uuid: str, compiled) -> Dict[str, Any]:
        """Terminal bookkeeping: fire hooks, return the final record."""
        record = self.store.get_run(run_uuid)
        try:
            from .hooks import run_hooks

            run_hooks(compiled, record, self.store)
        except Exception:  # noqa: BLE001 - hooks never fail the run
            import logging

            logging.getLogger(__name__).exception("hook execution failed")
        return record

    def run_operation_with_refs(self, operation: V1Operation,
                                dag_values=None, ref_resolver=None,
                                pipeline: Optional[str] = None) -> Dict[str, Any]:
        """DAG-member entrypoint (outputs of upstream ops via refs)."""
        return self.run_operation(operation, dag_values=dag_values,
                                  ref_resolver=ref_resolver,
                                  pipeline=pipeline)

    # -- job ------------------------------------------------------------

    def _build_env(self, run_uuid: str, extra: Optional[Dict[str, str]] = None
                   ) -> Dict[str, str]:
        env = dict(os.environ)
        # The child must track against THIS executor's store: against the
        # API host when the store is remote (agent mode), otherwise the
        # local file store — a stale configured host would silently send
        # metrics elsewhere (breaking tuner joins in --eager mode).
        remote_host = getattr(self.store, "host", None)
        if remote_host:
            env["POLYAXON_TPU_HOST"] = remote_host
        else:
            env.pop("POLYAXON_TPU_HOST", None)
        env[ENV_RUN_UUID] = run_uuid
        env[ENV_PROJECT] = self.project
        env["POLYAXON_TPU_HOME"] = self.store.home
        env.update(extra or {})
        return env

    def _container_argv(self, container) -> List[str]:
        if container is None or (not container.command and not container.args):
            raise ExecutionError("Container has no command to execute")
        argv = list(container.command or [])
        argv += [str(a) for a in (container.args or [])]
        if len(argv) == 1 and " " in argv[0]:
            argv = shlex.split(argv[0])
        return argv

    def _spawn(self, run_uuid: str, argv: List[str], env: Dict[str, str],
               replica: str, cwd: Optional[str] = None) -> subprocess.Popen:
        log_path = self.store.logs_path(run_uuid, replica)
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        proc = subprocess.Popen(
            argv, env=env, cwd=cwd,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )

        def pump():
            assert proc.stdout is not None
            with open(log_path, "a") as sink:
                for line in proc.stdout:
                    sink.write(line)
                    sink.flush()
                    if self.stream_logs:
                        sys.stdout.write(f"[{replica}] {line}")
                        sys.stdout.flush()

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        proc._ptpu_pump = t  # joined before wait() returns
        return proc

    def _wait(self, run_uuid: str, procs: Dict[str, subprocess.Popen],
              timeout: Optional[float], poll_interval: float = 0.3) -> None:
        """Wait for all replicas; honors timeouts and cooperative stop
        (``ops stop`` flips the run to ``stopping``; we kill and finalize
        as ``stopped``)."""
        deadline = time.time() + timeout if timeout else None
        pending = dict(procs)
        failed: Dict[str, int] = {}
        last_status_check = 0.0
        while pending:
            for replica, proc in list(pending.items()):
                rc = proc.poll()
                if rc is not None:
                    proc._ptpu_pump.join(timeout=5)
                    del pending[replica]
                    if rc != 0:
                        failed[replica] = rc
            if not pending:
                break
            now = time.time()
            if deadline is not None and now >= deadline:
                self._kill_all(pending)
                raise ExecutionError(f"Run timed out after {timeout}s")
            if now - last_status_check >= poll_interval:
                last_status_check = now
                try:
                    status = self.store.get_run(run_uuid).get("status")
                except Exception:
                    status = None
                if status == V1Statuses.STOPPING:
                    self._kill_all(pending)
                    raise StopRequested()
            time.sleep(min(poll_interval, 0.05))
        if failed:
            detail = ", ".join(f"{r} exited {c}" for r, c in failed.items())
            raise ExecutionError(f"Process failure: {detail}")

    @staticmethod
    def _kill_all(procs: Dict[str, subprocess.Popen]) -> None:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()

    def _run_service(self, run_uuid: str, compiled) -> None:
        """Run a service kind DETACHED: spawn the container in its own
        session with logs sunk straight to the run's log file (no pipe
        — a pump thread would die with this process and block the
        service on a full pipe), gate on port readiness, record
        pid/ports in meta_info, and leave it RUNNING.  `ops stop`
        reaps it via the recorded pid (cli.main.ops_stop).

        Parity: the reference runs notebooks/TensorBoard as `V1Service`
        until stopped (SURVEY.md 2.4); locally the executor process is
        the operator-equivalent.
        """
        container = compiled.run.container
        argv = self._container_argv(container)
        env = self._build_env(run_uuid)
        _merge_container_env(env, container)
        ports = [int(p) for p in (compiled.run.ports or [])]
        if ports and _port_open("127.0.0.1", ports[0]):
            # A stale listener would make the readiness probe pass
            # while OUR process dies on EADDRINUSE — fail fast with
            # the real cause instead of a phantom-RUNNING record.
            raise ExecutionError(
                f"port {ports[0]} is already in use (a previous "
                f"service still in shutdown grace, or an unrelated "
                f"listener)")
        log_path = self.store.logs_path(run_uuid, "main")
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        with open(log_path, "a") as sink:
            proc = subprocess.Popen(
                argv, env=env, cwd=container.working_dir,
                stdout=sink, stderr=subprocess.STDOUT,
                start_new_session=True)
        self.store.set_status(run_uuid, V1Statuses.RUNNING,
                              reason="LocalExecutor", force=True)
        self.store.update_run(run_uuid, meta_info={
            "service": {"pid": proc.pid, "ports": ports,
                        "host": "127.0.0.1"}})
        ready_timeout = float(os.environ.get(
            "POLYAXON_TPU_SERVICE_READY_TIMEOUT", "60"))
        deadline = time.time() + ready_timeout
        while True:
            # `ops stop` during startup reaps the pid and force-sets
            # "stopped" — honor it instead of misreading the kill as
            # a startup crash (FAILED) or respawning via retries.
            try:
                status = self.store.get_run(run_uuid).get("status")
            except Exception:
                status = None
            if status in (V1Statuses.STOPPING, V1Statuses.STOPPED):
                raise StopRequested()
            if proc.poll() is not None:
                raise ExecutionError(
                    f"service exited during startup "
                    f"(rc={proc.returncode}); see logs")
            if not ports or _port_open("127.0.0.1", ports[0]):
                # The port answering isn't proof OUR process owns it —
                # re-check liveness once so a racing listener can't
                # bless a dead service.
                if proc.poll() is not None:
                    raise ExecutionError(
                        f"service exited right after port "
                        f"{ports[0] if ports else '?'} opened "
                        f"(rc={proc.returncode}); see logs")
                return
            if time.time() >= deadline:
                try:
                    os.killpg(proc.pid, 15)
                except ProcessLookupError:
                    pass
                raise ExecutionError(
                    f"service did not answer on port {ports[0]} "
                    f"within {ready_timeout:.0f}s")
            time.sleep(0.25)

    def _run_job(self, run_uuid: str, compiled, timeout: Optional[float]) -> None:
        container = compiled.run.container
        argv = self._container_argv(container)
        env = self._build_env(run_uuid)
        _merge_container_env(env, container)
        self.store.set_status(run_uuid, V1Statuses.RUNNING,
                              reason="LocalExecutor", force=True)
        proc = self._spawn(run_uuid, argv, env, "main",
                           cwd=container.working_dir)
        self._wait(run_uuid, {"main": proc}, timeout)

    # -- distributed -----------------------------------------------------

    def _run_distributed(self, run_uuid: str, compiled,
                         timeout: Optional[float]) -> None:
        topo: ProcessTopology = normalize(compiled.run)
        port = _free_port()
        procs: Dict[str, subprocess.Popen] = {}
        self.store.set_status(run_uuid, V1Statuses.RUNNING,
                              reason="LocalExecutor", force=True)
        for group in topo.groups:
            container = group.spec.container or getattr(
                compiled.run, "worker", None) and compiled.run.worker.container
            argv = self._container_argv(container)
            for index in range(group.replicas):
                replica = f"{group.role}-{index}"
                topo_env = topo.process_env(group.role, index, run=run_uuid,
                                            port=port)
                # Local simulation: every process is on this host.
                topo_env["PTPU_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
                env = self._build_env(run_uuid, topo_env)
                _merge_container_env(env, container)
                procs[replica] = self._spawn(run_uuid, argv, env, replica,
                                             cwd=container.working_dir)
        self._wait(run_uuid, procs, timeout)

    # -- dag -------------------------------------------------------------

    def _run_dag(self, run_uuid: str, operation: V1Operation, compiled) -> None:
        from .dag import DagError, DagRunner, DagStopped

        self.store.set_status(run_uuid, V1Statuses.RUNNING,
                              reason="LocalExecutor", force=True)
        try:
            DagRunner(self, compiled, pipeline_uuid=run_uuid).execute()
        except DagStopped as e:
            raise StopRequested() from e
        except DagError as e:
            raise ExecutionError(str(e)) from e
