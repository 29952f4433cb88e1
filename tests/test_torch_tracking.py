"""The port's tracking (``tracking/``, ``client/``) against the JAX
package's.

The file store is the wire format between the two: a run the port tracks
reads back the same through the JAX package's ``FileRunStore`` and the
other way round.  On the CPU the GPU block of the system metrics is
empty, and neither importing nor initialising tracking touches CUDA.  A
topology of two processes starts the process group and shares the
chief's run (``tests/test_torch_gang.py`` holds the gang helper).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from polyaxon_tpu import tracking as jtracking
from polyaxon_tpu.client import FileRunStore as JStore
from polyaxon_tpu_torch import tracking as ttracking
from polyaxon_tpu_torch import train as ttrain
from polyaxon_tpu_torch.client import FileRunStore as TStore
from polyaxon_tpu_torch.tracking import processors

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def _track(run, artifact: Path) -> str:
    run.log_inputs(model="gpt2-tiny", lr=0.001, batch_size=2)
    for step, loss in enumerate((7.5, 7.25, 7.0), start=1):
        run.log_metrics(step=step, loss=loss, grad_norm=1.0 / step)
    run.log_text("hello", name="note", step=3)
    run.log_artifact(str(artifact), name="weights")
    run.log_outputs(loss=7.0)
    run.end("succeeded")
    return run.run_uuid


def _read(store, uuid: str) -> dict:
    rec = store.get_run(uuid)
    return {
        "record": {k: rec[k] for k in ("name", "project", "kind", "status",
                                       "inputs", "outputs", "managed_by")},
        "statuses": [c.type for c in store.get_statuses(uuid)],
        "loss": [(e["step"], e["value"])
                 for e in store.read_events(uuid, "metric", "loss")],
        "text": [e["value"] for e in store.read_events(uuid, "text",
                                                       "note")],
        "last": store.last_metrics(uuid),
        "lineage": [(r["name"], r["kind"]) for r in store.get_lineage(uuid)],
        "artifacts": sorted(
            str(p.relative_to(store.artifacts_path(uuid)))
            for p in Path(store.artifacts_path(uuid)).rglob("*")
            if p.is_file()),
    }


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_store_is_the_wire_format(writer, tmp_home, tmp_path):
    artifact = tmp_path / "w.bin"
    artifact.write_bytes(b"\0" * 16)
    if writer == "port":
        run = ttracking.Run(name="tracked", track_env=False)
    else:
        run = jtracking.Run(name="tracked", track_env=False)
    uuid = _track(run, artifact)
    seen_by_port = _read(TStore(str(tmp_home)), uuid)
    seen_by_reference = _read(JStore(str(tmp_home)), uuid)
    assert seen_by_port == seen_by_reference
    assert seen_by_port["statuses"] == ["created", "running", "succeeded"]
    assert seen_by_port["loss"] == [(1, 7.5), (2, 7.25), (3, 7.0)]
    assert seen_by_port["record"]["outputs"] == {"loss": 7.0}
    assert seen_by_port["lineage"] == [("weights", "artifact")]
    assert seen_by_port["artifacts"] == ["assets/w.bin"]


def test_env_record_and_profiler_trace_on_the_cpu(tmp_home):
    run = ttracking.init(name="cpu-run")
    trace_dir = run.start_profiler_trace()
    torch.ones(8).sum()
    path = run.stop_profiler_trace(step=1)
    ttracking.end()
    store = TStore(str(tmp_home))
    env = store.read_events(run.run_uuid, "env", "env")[-1]["value"]
    assert env["backend"] == "cpu" and env["device_count"] == 0
    assert env["torch_version"] == torch.__version__
    assert not any(k.startswith("jax") for k in env)
    assert path == os.path.join(trace_dir, "trace_step1.json")
    assert os.path.exists(path)
    assert trace_dir == os.path.join(store.artifacts_path(run.run_uuid),
                                     "traces")
    assert [r["name"] for r in store.get_lineage(run.run_uuid)] == \
        ["profiler_trace"]
    assert store.get_run(run.run_uuid)["status"] == "succeeded"


def test_env_named_run_is_registered(tmp_home, monkeypatch):
    """A hand-set POLYAXON_TPU_RUN_UUID the store does not hold becomes a
    run of that uuid (the checkpoint directory keys on it)."""
    monkeypatch.setenv("POLYAXON_TPU_RUN_UUID", "by-hand")
    run = ttracking.init(name="train-x", track_env=False,
                         collect_system_metrics=False)
    run.log_inputs(lr=0.1)
    ttracking.end()
    rec = TStore(str(tmp_home)).get_run("by-hand")
    assert rec["inputs"] == {"lr": 0.1} and rec["status"] == "succeeded"
    again = ttracking.init(track_env=False, collect_system_metrics=False)
    assert again.run_uuid == "by-hand" and not again._owns_status
    ttracking.end()


def test_gpu_metrics_empty_without_a_driver():
    assert processors.gpu_devices() == []
    assert processors.gpu_metrics() == {}


def test_gpu_metrics_from_nvidia_smi(tmp_path, monkeypatch):
    """Without NVML the readings come from nvidia-smi's CSV."""
    smi = tmp_path / "nvidia-smi"
    smi.write_text("#!/bin/sh\necho '0, NVIDIA H100 80GB HBM3, 40960, "
                   "81920, 37, 312.5'\necho '1, NVIDIA H100 80GB HBM3, "
                   "0, 81920, 0, [N/A]'\n")
    smi.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}"
                       f"{os.environ.get('PATH', '')}")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1,0")
    got = processors.gpu_metrics()
    assert got["gpu_local_devices"] == 2.0
    assert got["gpu1_memory_used_gb"] == 40960 * 2 ** 20 / 1e9
    assert got["gpu1_memory_percent"] == 50.0
    assert got["gpu1_utilization"] == 37.0 and got["gpu1_power_w"] == 312.5
    assert got["gpu0_memory_used_gb"] == 0.0 and "gpu0_power_w" not in got
    names = [d["name"] for d in processors.gpu_devices()]
    assert names == ["NVIDIA H100 80GB HBM3"] * 2


def test_tracking_makes_no_cuda_call(tmp_path):
    """Importing and initialising tracking, the system-metrics monitor and
    the env probe: a fresh interpreter whose torch.cuda entry points
    raise, and no CUDA context afterwards."""
    script = "\n".join([
        "import os, torch",
        "def boom(*a, **k):",
        "    raise AssertionError('CUDA touched')",
        "for name in ('init', '_lazy_init', 'is_available', 'device_count',",
        "             'current_device', 'synchronize', 'get_device_name',",
        "             'mem_get_info', 'memory_allocated', 'set_device'):",
        "    setattr(torch.cuda, name, boom)",
        "from polyaxon_tpu_torch import tracking",
        "run = tracking.init(name='t', system_metrics_interval=0.05)",
        "assert run._monitor is not None",
        "import time; time.sleep(0.3)",
        "metrics = run._monitor.sample()",
        "tracking.end()",
        "assert 'cpu_percent' in metrics, metrics",
        "assert not torch.cuda.is_initialized()",
        "print('ok')",
    ])
    env = {**os.environ, "POLYAXON_TPU_HOME": str(tmp_path),
           "POLYAXON_TPU_RUN_UUID": "no-cuda", "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    system = os.listdir(tmp_path / "runs" / "no-cuda" / "events" / "system")
    assert "cpu_percent.jsonl" in system


def test_multi_process_topology_is_refused(tmp_home, tmp_path,
                                          monkeypatch):
    """A PTPU_* topology of two processes is no longer refused:
    ``tracking.init()`` starts the process group (gloo here) before the
    run, the chief creates the run and the other process attaches to its
    uuid over the broadcast (an unmanaged pair started by hand); one
    process still tracks a run of its own."""
    from test_torch_gang import run_gang

    script = tmp_path / "pair.py"
    script.write_text(
        "import torch.distributed as dist\n"
        "from polyaxon_tpu_torch import tracking\n"
        "run = tracking.init(track_env=False)\n"
        "assert dist.is_initialized() and dist.get_world_size() == 2\n"
        "run.log_metrics(step=1, loss=float(dist.get_rank()))\n"
        "print('uuid', run.run_uuid, flush=True)\n"
        "dist.barrier()\n"
        "tracking.end()\n")
    outs = run_gang([sys.executable, str(script)], 2, tmp_path)
    uuids = {line.split()[1] for out in outs for line in out.splitlines()
             if line.startswith("uuid ")}
    assert len(uuids) == 1, outs
    uuid = uuids.pop()
    store = TStore(str(tmp_home))
    assert [r["uuid"] for r in store.list_runs()] == [uuid]
    assert store.get_run(uuid)["status"] == "succeeded"
    # Only the chief tracks by default: process 1's series would carry
    # a /p1 suffix.
    assert [e["value"] for e in store.read_events(uuid, "metric",
                                                   "loss")] == [0.0]
    monkeypatch.setenv("PTPU_NUM_PROCESSES", "1")
    run = ttracking.init(track_env=False)
    ttracking.end()
    assert TStore(str(tmp_home)).get_run(run.run_uuid)["status"] == \
        "succeeded"