"""Gangs of ``polyaxon_tpu_torch.train`` through its entry points, on the
CPU (``--cpu``: gloo), each with the deadlines of
``tests/test_torch_gang.py``'s ``run_gang``.

- ``ptpu-torch run -f`` of ``examples/gpt2_mpijob.yaml`` with 2 workers
  on gpt2-tiny ends ``succeeded`` as one tracked run with both replicas'
  logs, the losses a one-process run of the same global batch prints.
- A pair started by hand with the PTPU_* block (no managed run) shares
  the chief's run uuid and reports the one-process ``eval_accuracy`` on
  digits.
- A two-process ``fsdp`` gang's checkpoint restores into a one-process
  run that continues with the gang's next loss (and a gang resumes a
  checkpoint on every rank); ``serve --checkpoint``'s loader and
  ``generate --checkpoint`` take it.
- A SIGTERM to one rank stops every rank after the same step, with one
  checkpoint saved.

Losses are compared as printed (4 significant digits) where both sides
are runs of the CLI; the float32 gradient mean of two halves rounds
apart from the full batch's far below that.
"""

from __future__ import annotations

import os
import re
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
import yaml
from click.testing import CliRunner

from polyaxon_tpu_torch import train as ttrain
from polyaxon_tpu_torch.checkpoint import CheckpointManager
from polyaxon_tpu_torch.cli import main as cli_main
from polyaxon_tpu_torch.client import FileRunStore
from test_torch_gang import ROOT, free_port, gang_env, run_gang

torch.set_num_threads(2)

TRAIN = [sys.executable, "-m", "polyaxon_tpu_torch.train", "--cpu"]


def _losses(out: str) -> list:
    return re.findall(r"^step (\d+)/\d+ loss=(\S+)", out, re.M)


def _same_losses(got, want) -> None:
    """Printed losses (4 significant digits) of the same steps, equal up
    to the last printed digit's rounding."""
    assert [s for s, _ in got] == [s for s, _ in want] and got, (got, want)
    for (_, g), (_, w) in zip(got, want):
        assert abs(float(g) - float(w)) <= 1.5e-3, (got, want)


@pytest.fixture
def home(tmp_path, monkeypatch):
    home = tmp_path / "home"
    monkeypatch.setenv("POLYAXON_TPU_HOME", str(home))
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for name in ("POLYAXON_TPU_RUN_UUID", "POLYAXON_TPU_HOST",
                 "POLYAXON_TPU_PROJECT", "PTPU_COORDINATOR_ADDRESS",
                 "PTPU_NUM_PROCESSES", "PTPU_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.chdir(tmp_path)
    return home


def test_mpijob_example_runs_as_one_tracked_gang(home, tmp_path,
                                                 capsys):
    spec = yaml.safe_load((ROOT / "polyaxon_tpu_torch" / "examples"
                           / "gpt2_mpijob.yaml").read_text())
    run = spec["component"]["run"]
    assert run["kind"] == "mpijob" and run["worker"]["replicas"] == 4
    run["worker"]["replicas"] = 2
    # SGD: Adam's first update, lr * g / (|g| + eps), turns the rounding
    # difference between the mean of two half-batch gradients and the
    # full batch's, at the elements whose gradient is near eps, into
    # differences of up to 2 lr (about 1e-4 of the next loss here); the
    # gangs' Adam steps are held to the reference with that bound in
    # tests/test_torch_gang.py.
    run["worker"]["container"]["args"] += ["--cpu", "--optimizer=sgd"]
    path = tmp_path / "gpt2_mpijob.yaml"
    path.write_text(yaml.safe_dump(spec))
    out = CliRunner().invoke(cli_main.cli, [
        "run", "-f", str(path), "-P", "model=gpt2-tiny", "-P", "steps=3",
        "-P", "log_every=1", "-P", "batch_size=4", "--no-watch"])
    assert out.exit_code == 0, out.output
    uuid = re.search(r"^\s+uuid: (\w+)$", out.output, re.M).group(1)
    store = FileRunStore(str(home))
    assert [r["uuid"] for r in store.list_runs()] == [uuid]
    rec = store.get_run(uuid)
    logs = {r: (Path(store.logs_path(uuid, f"worker-{r}"))).read_text()
            for r in range(2)}
    assert rec["status"] == "succeeded", logs
    assert rec["kind"] == "mpijob" and rec["inputs"]["n_chips"] == 2
    for log in logs.values():
        assert "slice health: 2 devices healthy" in log
        assert len(_losses(log)) == 3
    assert _losses(logs[0]) == _losses(logs[1])
    tracked = [(str(e["step"]), f"{e['value']:.4g}")
               for e in store.read_events(uuid, "metric", "loss")]
    assert tracked == _losses(logs[0])
    # One process on the same global batch, tracked beside it: the
    # same losses (rtol 1e-4: float32 sums over 4 x 128 tokens, the
    # gradient a mean of two halves).
    assert ttrain.main(["--cpu", "--model", "gpt2-tiny", "--steps", "3",
                        "--log-every", "1", "--batch-size", "4",
                        "--lr", "0.00025", "--optimizer", "sgd",
                        "--no-resume"]) == 0
    one = [r["uuid"] for r in store.list_runs() if r["uuid"] != uuid]
    assert len(one) == 1
    for a, b in zip(store.read_events(uuid, "metric", "loss"),
                    store.read_events(one[0], "metric", "loss"),
                    strict=True):
        assert a["step"] == b["step"]
        assert abs(a["value"] - b["value"]) <= 1e-4 * abs(b["value"])
    assert (Path(store.outputs_path(uuid)) / "checkpoints" / "3"
            / "state.pt").exists()


def test_hand_started_pair_shares_the_chiefs_run_and_eval(home,
                                                          tmp_path,
                                                          capsys):
    args = ["--model", "mlp", "--dataset", "digits", "--steps", "4",
            "--log-every", "2", "--eval-every", "2", "--batch-size", "32",
            "--optimizer", "sgd", "--lr", "0.05"]
    outs = run_gang(TRAIN + args + ["--strategy", "dp:2"], 2, tmp_path)
    store = FileRunStore(str(home))
    runs = store.list_runs()
    assert len(runs) == 1, [r["uuid"] for r in runs]
    uuid = runs[0]["uuid"]
    assert store.get_run(uuid)["status"] == "succeeded"
    evals = [re.findall(r"final eval_accuracy=(\S+)", o) for o in outs]
    assert evals[0] == evals[1] and len(evals[0]) == 1
    tracked = store.read_events(uuid, "metric", "eval_accuracy")
    assert [e["step"] for e in tracked] == [2, 4, 4]
    assert f"{tracked[-1]['value']:.4f}" == evals[0][0]
    (tmp_path / "one").mkdir()
    os.chdir(tmp_path / "one")       # its own checkpoints directory
    assert ttrain.main(["--cpu"] + args + ["--no-resume"]) == 0
    one = capsys.readouterr().out
    assert re.findall(r"final eval_accuracy=(\S+)", one) == evals[0]
    assert _losses(outs[0]) == _losses(outs[1])
    _same_losses(_losses(one), _losses(outs[0]))


def test_fsdp_gang_checkpoint_restores_in_one_process_and_serves(
        home, tmp_path, capsys):
    args = ["--model", "gpt2-tiny", "--log-every", "1", "--batch-size",
            "4", "--strategy", "dp:1,fsdp:2"]
    gang_dir, one_dir = tmp_path / "gang", tmp_path / "one"
    gang_dir.mkdir()
    run_gang(TRAIN + args + ["--steps", "3"], 2, gang_dir)
    ckpt = gang_dir / "checkpoints"
    assert sorted(os.listdir(ckpt)) == ["3"]
    shutil.copytree(ckpt, one_dir / "checkpoints")
    # The gang resumes on every rank and takes step 4 ...
    outs = run_gang(TRAIN + args + ["--steps", "4"], 2, gang_dir)
    for out in outs:
        assert "resuming from checkpoint step 3" in out
    gang4 = _losses(outs[0])
    assert gang4 == _losses(outs[1]) and [s for s, _ in gang4] == ["4"]
    # ... and one process restores the gang's checkpoint and takes the
    # same step 4.
    os.chdir(one_dir)
    assert ttrain.main(["--cpu", "--model", "gpt2-tiny", "--steps", "4",
                        "--log-every", "1", "--batch-size", "4"]) == 0
    out = capsys.readouterr().out
    assert "resuming from checkpoint step 3" in out
    _same_losses(_losses(out), gang4)
    # The serving loader takes the gang's full state.
    saved = CheckpointManager(str(ckpt)).restore()      # the gang's step 4
    assert saved["params"]["wte.weight"].shape == (1024, 64)
    model = cli_main._build_serving_model("gpt2-tiny", 1, device="cpu",
                                          ckpt_dir=str(ckpt))
    for name, t in model.state_dict().items():
        torch.testing.assert_close(
            t, saved["params"][name].to(t.dtype), rtol=0, atol=0)
    out = CliRunner().invoke(cli_main.cli, [
        "generate", "--cpu", "--model", "gpt2-tiny", "--checkpoint",
        str(ckpt), "--prompt", "1,2,3", "--max-new-tokens", "3"])
    assert out.exit_code == 0, out.output


def test_sigterm_to_one_rank_stops_the_gang_after_one_save(home,
                                                           tmp_path):
    port = free_port()
    argv = TRAIN + ["--model", "gpt2-tiny", "--steps", "400",
                    "--log-every", "1", "--batch-size", "4",
                    "--strategy", "dp:2"]
    logs = [open(tmp_path / f"rank{r}.log", "w") for r in range(2)]
    procs = [subprocess.Popen(argv, cwd=str(tmp_path),
                              env=gang_env(2, r, port), stdout=logs[r],
                              stderr=subprocess.STDOUT,
                              start_new_session=True) for r in range(2)]
    try:
        deadline = time.monotonic() + 100
        while "step 2/400" not in (tmp_path / "rank1.log").read_text():
            assert time.monotonic() < deadline and procs[1].poll() is None
            time.sleep(0.2)
        procs[1].send_signal(signal.SIGTERM)
        for proc in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
        for f in logs:
            f.close()
    outs = [(tmp_path / f"rank{r}.log").read_text() for r in range(2)]
    assert [p.returncode for p in procs] == [0, 0], outs
    last = [_losses(o)[-1][0] for o in outs]
    for out in outs:
        assert "preempted: checkpoint flushed, exiting" in out
    steps = os.listdir(tmp_path / "checkpoints")
    assert len(steps) == 1 and int(steps[0]) < 400
    # The stop was agreed: both ranks left after the same step, and the
    # checkpoint is the last step they took.
    assert int(steps[0]) >= int(last[0]) and last[0] == last[1]
