"""Tier-1 clean-check of the port: ``ptpu-torch check`` over
``polyaxon_tpu_torch/`` reports nothing beyond the port's committed
baseline, the committed lock-order graph is the one the sources give,
and the ``check`` command behaves as the reference's.

The port's counterpart of ``tests/test_check_clean.py``.  A new
finding means: fix it, suppress it inline with a local justification
(``# ptpu: ignore[RULE]``), or add a baseline entry with a written
justification (``ptpu-torch check --update-baseline``, then replace
the TODO placeholder) — never delete the test.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
from pathlib import Path

import pytest
import torch
from click.testing import CliRunner

import polyaxon_tpu_torch
from polyaxon_tpu_torch.analysis import (DEFAULT_BASELINE, PROGRAM_RULE_IDS,
                                         RULE_IDS, apply_baseline,
                                         check_paths, load_baseline,
                                         lockgraph)
from polyaxon_tpu_torch.analysis.checker import iter_py_files
from polyaxon_tpu_torch.cli.main import cli

torch.set_num_threads(2)

PKG = os.path.dirname(os.path.abspath(polyaxon_tpu_torch.__file__))
ROOT = os.path.dirname(PKG)

_BUGGY = """
import time

def f(self):
    with self.device_lock:
        time.sleep(1)
"""


@pytest.fixture(scope="module")
def findings():
    return check_paths([PKG], root=ROOT)


def _lock_graph():
    sources = {}
    for p in iter_py_files([PKG]):
        rel = os.path.relpath(os.path.abspath(p), ROOT).replace(os.sep, "/")
        if lockgraph.in_program_scope(rel):
            sources[rel] = Path(p).read_text(encoding="utf-8")
    return lockgraph.build_lock_graph(lockgraph.build_model(sources))


def test_port_is_clean_against_its_baseline(findings):
    new, stale = apply_baseline(findings, load_baseline(DEFAULT_BASELINE))
    assert not new, (
        "new static-analysis findings (fix, ptpu:ignore with a local "
        "justification, or baseline with a written one):\n"
        + "\n".join(f.render() for f in new))
    assert not stale, (
        "stale baseline entries (the flagged code was fixed — run "
        "`ptpu-torch check --update-baseline` to drop them):\n"
        + "\n".join(f"{e['rule']} {e['path']} [{e['func']}]"
                    for e in stale))


def test_baseline_entries_are_justified():
    entries = load_baseline(DEFAULT_BASELINE)
    assert entries, "committed baseline unexpectedly empty"
    todo = [e for e in entries
            if "TODO" in e.get("justification", "TODO")]
    assert not todo, "baseline entries with placeholder justifications: " \
        + ", ".join(f"{e['rule']} {e['path']} [{e['func']}]" for e in todo)
    assert all(e["path"].startswith("polyaxon_tpu_torch/")
               for e in entries)


def test_baseline_rules_are_in_the_catalog():
    unknown = ({e["rule"] for e in load_baseline(DEFAULT_BASELINE)}
               - set(RULE_IDS) - set(PROGRAM_RULE_IDS))
    assert not unknown, f"baseline references unknown rules: {unknown}"


def test_catalog_is_the_references_in_its_order():
    assert RULE_IDS == (
        "RNG-DET", "LOCK-HOLD", "JIT-PURITY", "JIT-DEADLINE",
        "HOST-SYNC", "EXC-SWALLOW", "PAGE-REF", "SHARD-LEAK",
        "TIME-TRUTH", "SNAPSHOT-LOCK", "RETRY-BACKOFF", "TIER-XFER",
        "SOCKET-TIMEOUT", "WIRE-VERIFY", "PHASE-ENUM")
    assert PROGRAM_RULE_IDS == ("LOCK-ORDER", "THREAD-SHARE")


def test_committed_lock_graph_matches_sources():
    """The committed ``analysis/lockorder.json`` is the graph the
    sources give (regenerate with ``ptpu-torch check --dump-lock-graph
    polyaxon_tpu_torch/analysis/lockorder.json``), it is acyclic, and
    it names the port's two module-level locks."""
    graph = _lock_graph()
    committed = json.loads(Path(PKG, "analysis",
                                "lockorder.json").read_text())
    assert lockgraph.canonical_graph(graph) == committed, (
        "static lock-order graph drifted from the committed artifact")
    assert lockgraph.lock_order_findings(graph) == []
    for node in ("slots._CAPTURE_LOCK", "telemetry._PROCESS_SLOT"):
        assert node in committed["nodes"], node
    assert {"from": "device_lock", "to": "slots._CAPTURE_LOCK",
            "blocking": True} in committed["edges"]


# -- the check command ------------------------------------------------------


def test_cli_check_clean_tree_from_any_cwd(tmp_path, monkeypatch):
    """The default PATHS and baseline resolve against the package, not
    the cwd (the text output is checked on a small tree below)."""
    monkeypatch.chdir(tmp_path)
    res = CliRunner().invoke(cli, ["check", "--format", "json"])
    assert res.exit_code == 0, res.output
    doc = json.loads(res.output)
    assert doc["new"] == 0 and doc["findings"] == []
    assert doc["stale_baseline_entries"] == []
    assert doc["baselined"] == sum(e["count"] for e in
                                   load_baseline(DEFAULT_BASELINE))


def test_cli_check_text_json_and_exit_code(tmp_path, monkeypatch):
    pkg = tmp_path / "polyaxon_tpu_torch" / "serving"
    pkg.mkdir(parents=True)
    (pkg / "bad.py").write_text(_BUGGY)
    monkeypatch.chdir(tmp_path)
    runner = CliRunner()
    empty = str(tmp_path / "baseline.json")
    res = runner.invoke(cli, ["check", "polyaxon_tpu_torch",
                              "--baseline", empty, "--format", "json"])
    assert res.exit_code == 1, res.output
    doc = json.loads(res.output)
    assert doc["new"] == 1 and doc["findings"][0]["rule"] == "LOCK-HOLD"
    res = runner.invoke(cli, ["check", "polyaxon_tpu_torch",
                              "--baseline", empty])
    assert res.exit_code == 1
    assert "LOCK-HOLD" in res.output and "1 new finding " in res.output
    res = runner.invoke(cli, ["check", "polyaxon_tpu_torch",
                              "--baseline", empty, "--update-baseline"])
    assert res.exit_code == 0, res.output
    assert "TODO" in json.loads(Path(empty).read_text())["entries"][0][
        "justification"]
    res = runner.invoke(cli, ["check", "polyaxon_tpu_torch",
                              "--baseline", empty])
    assert res.exit_code == 0, res.output
    assert "0 new findings (1 baselined)" in res.output


def test_cli_check_param_without_file_is_refused(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = CliRunner().invoke(cli, ["check", "-P", "lr=0.1"])
    assert res.exit_code != 0
    assert "-P/--param requires -f" in res.output


def test_cli_check_validates_a_port_example():
    example = os.path.join(PKG, "examples", "gpt2_job.yaml")
    res = CliRunner().invoke(cli, ["check", "-f", example])
    assert res.exit_code == 0, res.output
    assert res.output.startswith("Valid operation: name=")
    res = CliRunner().invoke(cli, ["check", "-f", example, "-P",
                                   "no_such_param=1"])
    assert res.exit_code != 0


def test_cli_dump_lock_graph(tmp_path):
    out = tmp_path / "graph.json"
    res = CliRunner().invoke(cli, ["check", "--dump-lock-graph", str(out)])
    assert res.exit_code == 0, res.output
    assert json.loads(out.read_text()) == json.loads(
        Path(PKG, "analysis", "lockorder.json").read_text())


def test_cli_check_changed_in_a_git_repo(tmp_path, monkeypatch):
    """``--changed [REF]`` checks the files changed against REF plus the
    untracked ones, with the findings and exit status of a full run on
    those files."""
    if shutil.which("git") is None:
        pytest.skip("no git")
    repo = tmp_path / "repo"
    pkg = repo / "polyaxon_tpu_torch"
    (pkg / "serving").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "serving" / "old.py").write_text("def f():\n    return 1\n")
    (pkg / "serving" / "kept.py").write_text(_BUGGY)
    env = {**os.environ, "GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t",
           "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@t"}

    def git(*args):
        subprocess.run(["git", *args], cwd=repo, env=env, check=True,
                       capture_output=True)

    git("init", "-q")
    git("add", "-A")
    git("commit", "-q", "-m", "seed")
    (pkg / "serving" / "old.py").write_text(_BUGGY)
    (pkg / "serving" / "new.py").write_text(_BUGGY)
    # The command's root is the package's parent, whatever the cwd.
    monkeypatch.setattr(polyaxon_tpu_torch, "__file__",
                        str(pkg / "__init__.py"))
    monkeypatch.chdir(tmp_path)
    baseline = str(tmp_path / "baseline.json")
    runner = CliRunner()
    res = runner.invoke(cli, ["check", "--format", "json", "--baseline",
                              baseline, "--changed"])
    assert res.exit_code == 1, res.output
    doc = json.loads(res.output)
    subset = [str(pkg / "serving" / n) for n in ("new.py", "old.py")]
    assert doc["checked_paths"] == subset
    full = check_paths(subset, root=str(repo))
    assert doc["findings"] == [f.to_dict() for f in full]
    assert {f["path"] for f in doc["findings"]} == {
        "polyaxon_tpu_torch/serving/new.py",
        "polyaxon_tpu_torch/serving/old.py"}
    # --changed=REF with PATHS: the intersection.
    res = runner.invoke(cli, ["check", "--format", "json", "--baseline",
                              baseline, "--changed=HEAD",
                              str(pkg / "serving" / "new.py")])
    assert json.loads(res.output)["checked_paths"] == subset[:1]
    git("add", "-A")
    git("commit", "-q", "-m", "more")
    res = runner.invoke(cli, ["check", "--baseline", baseline,
                              "--changed"])
    assert res.exit_code == 0, res.output
    assert "0 new findings (0 baselined)" in res.output
