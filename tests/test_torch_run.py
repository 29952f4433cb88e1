"""``ptpu-torch run -f`` end to end on the CPU: the port's example
polyaxonfiles with ``--cpu`` added to their commands and gpt2-tiny, run
through the CLI in a temporary home, and read back with ``ops``.

- a ``job``: tracked losses equal the printed step lines, outputs,
  the checkpoint under the run's outputs, ``ops ls/get/metrics/statuses/
  logs``;
- a ``hyperband`` matrix: its trials are the ones the JAX package's
  ``TuneController`` schedules for the same seed and the same observed
  losses;
- a ``service``: its answer equals an in-process server's, and ``ops
  stop`` reaps it;
- a ``job`` whose child exits 1 ends ``failed`` with its last log lines
  shown.
"""

from __future__ import annotations

import json
import os
import re
import socket
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from click.testing import CliRunner

from polyaxon_tpu.flow import V1Operation as JOperation
from polyaxon_tpu.tune import TuneController as JController
from polyaxon_tpu_torch.cli import main as cli_main
from polyaxon_tpu_torch.client import FileRunStore
from polyaxon_tpu_torch.serving import ModelServer

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "polyaxon_tpu_torch" / "examples"


@pytest.fixture
def home(tmp_path, monkeypatch):
    """A temporary home; children find the package and use 2 threads."""
    home = tmp_path / "home"
    monkeypatch.setenv("POLYAXON_TPU_HOME", str(home))
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    for name in ("POLYAXON_TPU_RUN_UUID", "POLYAXON_TPU_HOST",
                 "POLYAXON_TPU_PROJECT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.chdir(tmp_path)
    return home


def _on_cpu(example: str, tmp_path: Path, **matrix) -> str:
    """The port's example with ``--cpu`` added to its command and
    gpt2-tiny as its model."""
    spec = yaml.safe_load((EXAMPLES / example).read_text())
    spec["component"]["run"]["container"]["args"].append("--cpu")
    for io in spec["component"]["inputs"]:
        if io["name"] == "model":
            io["value"] = "gpt2-tiny"
    if matrix:
        spec["matrix"].update(matrix)
    path = tmp_path / example
    path.write_text(yaml.safe_dump(spec))
    return str(path)


def _cli(*args):
    return CliRunner().invoke(cli_main.cli, list(args))


def _uuid(output: str) -> str:
    return re.search(r"^\s+uuid: (\w+)$", output, re.M).group(1)


def test_job_is_tracked_and_listed(home, tmp_path):
    out = _cli("run", "-f", _on_cpu("gpt2_job.yaml", tmp_path),
               "-P", "steps=3", "-P", "log_every=1", "-P", "batch_size=2",
               "-P", "profile_at=1", "-P", "profile_steps=1", "--no-watch")
    assert out.exit_code == 0, out.output
    uuid = _uuid(out.output)
    store = FileRunStore(str(home))
    rec = store.get_run(uuid)
    assert rec["status"] == "succeeded"
    assert [c.type for c in store.get_statuses(uuid)] == \
        ["created", "compiled", "running", "succeeded"]
    losses = store.read_events(uuid, "metric", "loss")
    printed = re.findall(r"^step (\d+)/3 loss=(\S+)", store.read_logs(uuid),
                         re.M)
    assert [(str(e["step"]), f"{e['value']:.4g}") for e in losses] == \
        printed and len(printed) == 3
    assert rec["outputs"]["loss"] == losses[-1]["value"]
    assert rec["inputs"]["model"] == "gpt2-tiny"
    assert rec["inputs"]["backend"] == "cpu"
    outputs = Path(store.outputs_path(uuid))
    assert (outputs / "checkpoints" / "3" / "state.pt").exists()
    assert (outputs / "profile" / "trace_step2.json").exists()

    listed = _cli("ops", "ls")
    assert listed.exit_code == 0 and uuid in listed.output \
        and "succeeded" in listed.output
    got = json.loads(_cli("ops", "get", uuid).output)
    assert got["outputs"] == rec["outputs"]
    series = _cli("ops", "metrics", uuid, "--name", "loss").output
    assert series.splitlines() == [f"step={e['step']} value={e['value']}"
                                   for e in losses]
    assert f"loss: {losses[-1]['value']}" in _cli("ops", "metrics",
                                                  uuid).output
    statuses = _cli("ops", "statuses", uuid).output.splitlines()
    assert [ln.split()[1] for ln in statuses] == \
        ["created", "compiled", "running", "succeeded"]
    assert "step 3/3 loss=" in _cli("ops", "logs", uuid, "--tail",
                                    "2").output
    followed = _cli("ops", "logs", uuid, "--follow")
    assert followed.exit_code == 0 and "step 1/3" in followed.output


def _trial_key(values):
    return (values["steps"], values["lr"])


def test_hyperband_sweep_schedules_as_the_reference(home, tmp_path):
    data = tmp_path / "tokens"
    data.mkdir()
    np.save(data / "tokens.npy",
            np.random.RandomState(0).randint(0, 1024, 4096).astype(np.int32))
    # The example's maxIterations 6: rung 0 trains 2 steps, so its
    # losses differ by lr.
    path = _on_cpu("hyperband.yaml", tmp_path, concurrency=3)
    out = _cli("run", "-f", path, "-P", f"data_dir={data}", "-P",
               "batch_size=2", "-P", "seq_len=32", "--no-watch")
    assert out.exit_code == 0, out.output
    store = FileRunStore(str(home))
    sweep = store.get_run(_uuid(out.output))
    trials = store.list_runs(pipeline=sweep["uuid"])
    assert sweep["status"] == "succeeded" and len(trials) == 6
    assert all(t["status"] == "succeeded" for t in trials)
    observed = {_trial_key(t["meta_info"]["matrix_values"]):
                t["outputs"]["loss"] for t in trials}
    assert len(observed) == 6

    class Replay:
        """The reference's executor seam, answering each suggestion with
        the loss the port's trial of those params tracked."""

        def __init__(self, store):
            self.store, self.seen = store, []

        def run_operation(self, op, matrix_values=None, pipeline=None):
            self.seen.append(dict(matrix_values))
            rec = self.store.create_run(name=op.name, pipeline=pipeline)
            self.store.append_events(rec["uuid"], "metric", "loss", [{
                "step": 1, "timestamp": 0.0,
                "value": observed[_trial_key(matrix_values)]}])
            self.store.set_status(rec["uuid"], "succeeded", force=True)
            return self.store.get_run(rec["uuid"])

    from polyaxon_tpu.client import FileRunStore as JStore

    jstore = JStore(str(tmp_path / "reference"))
    op = JOperation.from_dict(yaml.safe_load(Path(path).read_text()))
    replay = Replay(jstore)
    parent = jstore.create_run(name="sweep")
    final = JController(replay, op, parent["uuid"]).execute()
    assert sorted(map(_trial_key, replay.seen)) == sorted(observed)
    best = min(trials, key=lambda t: t["outputs"]["loss"])
    assert sweep["outputs"]["best_run"] == best["uuid"]
    assert sweep["outputs"]["best_params"] == final["outputs"]["best_params"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def test_service_answers_and_is_reaped(home, tmp_path):
    port = _free_port()
    preset = tmp_path / "port.yaml"
    preset.write_text(f"isPreset: true\nparams: {{port: {{value: {port}}}}}"
                      f"\ncomponent: {{run: {{ports: [{port}]}}}}\n")
    out = _cli("run", "-f", _on_cpu("serving.yaml", tmp_path), "--preset",
               str(preset))
    uuid = _uuid(out.output)
    store = FileRunStore(str(home))
    rec = store.get_run(uuid)
    try:
        assert out.exit_code == 0 and rec["status"] == "running", \
            out.output + store.read_logs(uuid)
        assert f"service is up on port {port}" in out.output
        body = {"prompt": [5, 6, 7, 8], "max_new_tokens": 8}
        req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                     data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            served = json.loads(r.read())["tokens"]
    finally:
        stopped = _cli("ops", "stop", uuid)
    assert stopped.exit_code == 0 and "reaped" in stopped.output
    pid = rec["meta_info"]["service"]["pid"]
    deadline = time.time() + 30
    while not _gone(pid) and time.time() < deadline:
        time.sleep(0.1)
    assert _gone(pid)
    assert store.get_run(uuid)["status"] == "stopped"
    model = cli_main._build_serving_model("gpt2-tiny", 1, 0, "cpu")
    ms = ModelServer(model, model_name="gpt2-tiny")
    try:
        assert served == ms.generate(body)["tokens"]
    finally:
        ms.close()


def test_failing_job_ends_failed_with_its_logs(home, tmp_path):
    """The child refuses a dataset it cannot build (span corruption with
    no data directory) and exits 1."""
    spec = yaml.safe_load(Path(_on_cpu("gpt2_job.yaml", tmp_path))
                          .read_text())
    spec["component"]["run"]["container"]["args"].append(
        "--dataset=span-corruption")
    path = tmp_path / "failing.yaml"
    path.write_text(yaml.safe_dump(spec))
    out = _cli("run", "-f", str(path), "-P", "steps=1", "--no-watch")
    assert out.exit_code != 0
    assert "Run finished with status 'failed'" in out.output
    assert "--- last logs ---" in out.output
    assert "--dataset span-corruption requires --data-dir" \
        in out.output
    rec = FileRunStore(str(home)).get_run(_uuid(out.output))
    assert rec["status"] == "failed"
