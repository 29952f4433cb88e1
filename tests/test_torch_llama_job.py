"""``polyaxon_tpu_torch/examples/tinyllama_job.yaml`` on the CPU: the
example with ``--cpu`` added to its command, compiled with ``-P
model=llama-tiny``, run through ``ptpu-torch run -f`` in a temporary
home as ``tests/test_torch_run.py`` runs the GPT-2 job, and its tracked
losses read back with ``ops``.
"""

from __future__ import annotations

import re
from pathlib import Path

import pytest
import torch
import yaml
from click.testing import CliRunner

from polyaxon_tpu_torch.cli import main as cli_main
from polyaxon_tpu_torch.client import FileRunStore
from polyaxon_tpu_torch.polyaxonfile import check_polyaxonfile

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
EXAMPLE = ROOT / "polyaxon_tpu_torch" / "examples" / "tinyllama_job.yaml"


@pytest.fixture
def home(tmp_path, monkeypatch):
    home = tmp_path / "home"
    monkeypatch.setenv("POLYAXON_TPU_HOME", str(home))
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    for name in ("POLYAXON_TPU_RUN_UUID", "POLYAXON_TPU_HOST",
                 "POLYAXON_TPU_PROJECT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.chdir(tmp_path)
    return home


def _on_cpu(tmp_path: Path) -> str:
    spec = yaml.safe_load(EXAMPLE.read_text())
    spec["component"]["run"]["container"]["args"].append("--cpu")
    path = tmp_path / EXAMPLE.name
    path.write_text(yaml.safe_dump(spec))
    return str(path)


def test_example_compiles_to_the_tinyllama_job():
    op = check_polyaxonfile([str(EXAMPLE)])
    run = op.component.run
    assert run.kind == "job"
    inputs = {io.name: io.value for io in op.component.inputs}
    assert inputs["model"] == "tinyllama-1.1b"
    assert inputs["batch_size"] == 4
    assert run.container.command == ["python", "-m",
                                     "polyaxon_tpu_torch.train"]
    assert "--model={{ model }}" in run.container.args


def test_job_trains_llama_tiny_and_is_tracked(home, tmp_path):
    out = CliRunner().invoke(cli_main.cli, [
        "run", "-f", _on_cpu(tmp_path), "-P", "model=llama-tiny",
        "-P", "steps=3", "-P", "log_every=1", "-P", "batch_size=2",
        "--no-watch"])
    assert out.exit_code == 0, out.output
    uuid = re.search(r"^\s+uuid: (\w+)$", out.output, re.M).group(1)
    store = FileRunStore(str(home))
    rec = store.get_run(uuid)
    assert rec["status"] == "succeeded", store.read_logs(uuid)[-2000:]
    assert rec["inputs"]["model"] == "llama-tiny"
    assert rec["inputs"]["backend"] == "cpu"
    losses = store.read_events(uuid, "metric", "loss")
    printed = re.findall(r"^step (\d+)/3 loss=(\S+)", store.read_logs(uuid),
                         re.M)
    assert [(str(e["step"]), f"{e['value']:.4g}") for e in losses] == \
        printed and len(printed) == 3
    assert rec["outputs"]["loss"] == losses[-1]["value"]
    assert (Path(store.outputs_path(uuid)) / "checkpoints" / "3"
            / "state.pt").exists()
    series = CliRunner().invoke(cli_main.cli, [
        "ops", "metrics", uuid, "--name", "loss"]).output
    assert series.splitlines() == [f"step={e['step']} value={e['value']}"
                                   for e in losses]
