"""Layout rules of the PyTorch port.

The port and its chip smoke import nothing of JAX and nothing of the
JAX package (checked on the source: jax may already sit in
``sys.modules`` when the interpreter starts), and importing a module of
the port builds no kernel and touches no CUDA.
"""

from __future__ import annotations

import ast
import os
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "polyaxon_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "polyaxon_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_imports_nothing_of_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_module_imports_without_building(monkeypatch):
    """No nvcc here: a module that compiled at import would fail."""
    from polyaxon_tpu_torch.ops import _build

    def refuse(name):
        raise AssertionError(f"kernel {name} built at import time")

    monkeypatch.setattr(_build, "build", refuse)
    modules = [".".join(p.relative_to(ROOT).with_suffix("").parts)
               for p in sorted(PORT.rglob("*.py"))]
    for name in modules:
        importlib.import_module(name.removesuffix(".__init__"))
    assert not _build._loaded


SERVING_MODULES = ("prng.py", "models/generate.py", "models/kv_cache.py",
                   "cli/main.py", "checkpoint.py",
                   "serving/__init__.py", "serving/_lru.py",
                   "serving/debug.py", "serving/engine.py",
                   "serving/faults.py", "serving/forensics.py",
                   "serving/paged.py", "serving/recovery.py",
                   "serving/scheduler.py", "serving/server.py",
                   "serving/slots.py", "serving/telemetry.py",
                   "analysis/recompile.py", "analysis/locksan.py",
                   "serving/radix.py", "serving/router.py",
                   "serving/meshed.py")

ANALYSIS_MODULES = ("analysis/__init__.py", "analysis/checker.py",
                    "analysis/baseline.py", "analysis/lockgraph.py",
                    "analysis/threads.py", "analysis/rules/__init__.py",
                    "analysis/rules/_base.py", "analysis/rules/_jit.py",
                    *(f"analysis/rules/{m}.py" for m in (
                        "exc_swallow", "host_sync", "jit_deadline",
                        "jit_purity", "lock_hold", "page_ref",
                        "phase_enum", "retry_backoff", "rng_det",
                        "shard_leak", "snapshot_lock", "socket_timeout",
                        "tier_xfer", "time_truth", "wire_verify")))


def test_serving_modules_are_checked():
    """The serving stack and the static checker are under the import
    rule above (SOURCES); each analysis module says it is the port's
    own copy."""
    for rel in SERVING_MODULES + ANALYSIS_MODULES:
        assert PORT / rel in SOURCES, rel
    for rel in ANALYSIS_MODULES:
        doc = ast.get_docstring(ast.parse((PORT / rel).read_text()))
        assert "port's own copy" in " ".join(doc.split()), rel


def test_analysis_imports_touch_no_cuda():
    """Importing ``polyaxon_tpu_torch.analysis`` (the checker, the lock
    graph, the sanitizer) and checking a source loads no jax, nothing of
    the JAX package and no CUDA (judged on the modules the import adds:
    jax may already sit in ``sys.modules`` at start-up)."""
    import subprocess
    import sys

    script = "\n".join([
        "import sys, torch",
        "before = set(sys.modules)",
        "def boom(*a, **k):",
        "    raise AssertionError('CUDA touched')",
        "for name in ('init', '_lazy_init', 'is_available', 'device_count',",
        "             'current_device', 'synchronize', 'set_device'):",
        "    setattr(torch.cuda, name, boom)",
        "import polyaxon_tpu_torch.analysis as A",
        "from polyaxon_tpu_torch.analysis import lockgraph, threads",
        "A.check_source('x = 1\\n', 'polyaxon_tpu_torch/serving/x.py')",
        "assert not torch.cuda.is_initialized()",
        "new = set(sys.modules) - before",
        "bad = sorted(m for m in new if m.split('.')[0] in",
        "             ('jax', 'jaxlib', 'polyaxon_tpu'))",
        "print('ok' if not bad else bad)",
    ])
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", \
        (out.stdout, out.stderr)


FLEET_MODULES = ("serving/router.py", "serving/paged.py",
                 "serving/server.py", "serving/__init__.py",
                 "cli/main.py")


@pytest.mark.parametrize("rel", FLEET_MODULES)
def test_fleet_modules_import_no_jax_nor_ml_dtypes(rel):
    """The router and the wire code (the host spill tier's format reads
    and writes bf16 without a bf16 numpy type) import no jax, nothing of
    the JAX package and no ``ml_dtypes``, which the card's machine does
    not have, and never ask numpy for a bf16 dtype."""
    bad = sorted(set(_imported_roots(PORT / rel))
                 & set(FORBIDDEN + ("ml_dtypes",)))
    assert not bad, f"{rel} imports {bad}"
    text = (PORT / rel).read_text().replace("'", '"')
    assert 'np.dtype("bfloat16")' not in text, rel


def test_fleet_serving_imports_touch_no_cuda():
    """Importing ``polyaxon_tpu_torch.serving`` (the router and the wire
    format with it), building a router over URL replicas and a bf16
    blob round trip touch no CUDA and load no jax, ml_dtypes or module
    of the JAX package (judged on the modules these imports add: jax
    may already sit in ``sys.modules`` at start-up)."""
    import subprocess
    import sys

    script = "\n".join([
        "import sys, torch",
        "before = set(sys.modules)",
        "def boom(*a, **k):",
        "    raise AssertionError('CUDA touched')",
        "for name in ('init', '_lazy_init', 'is_available', 'device_count',",
        "             'current_device', 'synchronize', 'Stream', 'CUDAGraph',",
        "             'graph', 'set_device', 'get_device_name'):",
        "    setattr(torch.cuda, name, boom)",
        "import polyaxon_tpu_torch.serving as S",
        "from polyaxon_tpu_torch.serving.paged import (pack_spilled,",
        "                                               unpack_spilled)",
        "r = S.ReplicaRouter([S.Replica('http://127.0.0.1:1', 'a')],",
        "                    autostart=False)",
        "r.close()",
        "x = torch.ones(1, 1, 2, 1, 1, dtype=torch.bfloat16)",
        "b = pack_spilled([[1, 2]], [None, x], 2, torch.zeros(1, 3))",
        "assert torch.equal(unpack_spilled(b)[1][1], x)",
        "assert not torch.cuda.is_initialized()",
        "new = set(sys.modules) - before",
        "bad = sorted(m for m in new if m.split('.')[0] in",
        "             ('jax', 'jaxlib', 'ml_dtypes', 'polyaxon_tpu'))",
        "print('ok' if not bad else bad)",
    ])
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", \
        (out.stdout, out.stderr)


LLAMA_MODULES = ("ops/rotary.py", "models/llama.py", "models/registry.py",
                 "models/gpt2.py", "models/layers.py", "convert.py")


def test_llama_modules_are_checked():
    """The Llama family's modules are under the import rule above and
    the no-CUDA import check below (both walk every module), and a CPU
    Llama model touches no CUDA: a fresh interpreter whose torch.cuda
    entry points raise builds mistral-tiny on the CPU and runs its
    windowed forward, a prefill and a slot-cache decode step."""
    import subprocess
    import sys

    for rel in LLAMA_MODULES:
        assert PORT / rel in SOURCES, rel
    script = "\n".join([
        "import torch",
        "def boom(*a, **k):",
        "    raise AssertionError('CUDA touched')",
        "for name in ('init', '_lazy_init', 'is_available', 'device_count',",
        "             'current_device', 'synchronize', 'set_device'):",
        "    setattr(torch.cuda, name, boom)",
        "from polyaxon_tpu_torch.models import generate as G",
        "from polyaxon_tpu_torch.models.kv_cache import KVCache",
        "from polyaxon_tpu_torch.models.registry import get_model",
        "m = get_model('mistral-tiny').init_params(seed=0, device='cpu')",
        "toks = torch.arange(40)[None] % 512",
        "assert m(toks).shape == (1, 40, 512)",
        "logits, cache = G.prefill(m, toks)",
        "slot = KVCache(cache.k, cache.v, positions=torch.tensor([40]))",
        "m(toks[:, :1], decode=True, cache=slot)",
        "assert not torch.cuda.is_initialized()",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_imports_touch_no_cuda():
    """Importing every module of the port (and the CLI) makes no CUDA
    call: a fresh interpreter whose torch.cuda entry points raise."""
    import subprocess
    import sys

    modules = [".".join(p.relative_to(ROOT).with_suffix("").parts)
               .removesuffix(".__init__") for p in sorted(PORT.rglob("*.py"))]
    script = "\n".join([
        "import importlib, torch",
        "def boom(*a, **k):",
        "    raise AssertionError('CUDA touched at import time')",
        "for name in ('init', '_lazy_init', 'is_available', 'device_count',",
        "             'current_device', 'synchronize', 'Stream', 'CUDAGraph',",
        "             'graph', 'set_device', 'get_device_name'):",
        "    setattr(torch.cuda, name, boom)",
        f"for name in {modules!r}:",
        "    importlib.import_module(name)",
        "assert not torch.cuda.is_initialized()",
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _packaged(rel: str) -> bool:
    """Whether the package-data globs of pyproject.toml cover ``rel`` (a
    path inside polyaxon_tpu_torch/)."""
    import fnmatch
    import tomllib

    cfg = tomllib.loads((ROOT / "pyproject.toml").read_text())
    globs = cfg["tool"]["setuptools"]["package-data"]["polyaxon_tpu_torch"]
    return any(fnmatch.fnmatch(rel, g) for g in globs)


def test_digits_and_examples_are_packaged():
    """The digits file ``data.digits_dataset`` reads and every example
    polyaxonfile ship with the package (the card's machine has no
    scikit-learn to read the digits from)."""
    from polyaxon_tpu_torch import data

    digits = Path(data.DIGITS_CSV)
    assert digits.exists() and digits.parent.parent == PORT
    assert _packaged(str(digits.relative_to(PORT)))
    for path in sorted((PORT / "examples").iterdir()):
        assert _packaged(str(path.relative_to(PORT))), path.name


def test_kernel_sources_are_packaged():
    """Every kernel source and every header a source includes ships with
    the package: an installed package builds its kernels from them."""
    import re

    from polyaxon_tpu_torch.ops import _build

    assert _build.sources() == ["flash_bwd", "flash_fwd"]
    for name in _build.sources():
        lib = _build.library_path(name)
        assert lib.parent == PORT / "build"
        src = _build.CSRC / f"{name}.cu"
        assert _packaged(str(src.relative_to(PORT)))
        todo, seen = [src], set()
        while todo:  # the headers it includes, and theirs
            including = todo.pop()
            for header in re.findall(r'^\s*#include\s+"([^"]+)"',
                                     including.read_text(), re.M):
                path = _build.CSRC / header
                assert path.exists(), \
                    f"{including.name} includes missing {header}"
                assert _packaged(str(path.relative_to(PORT))), \
                    f"{header} (included by {including.name}) is not " \
                    f"package data"
                if header not in seen:
                    seen.add(header)
                    todo.append(path)
        assert seen == {"flash_common.cuh", "flash_hopper.cuh"}, seen
    assert "polyaxon_tpu_torch/build/" in (ROOT / ".gitignore").read_text()


def _edit_renames_libraries(shared, tmp_path, monkeypatch):
    import shutil

    from polyaxon_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in _build.sources()}
    header = csrc / shared
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.sources()}
    assert sorted(before) == ["flash_bwd", "flash_fwd"]
    assert all(before[n] != after[n] for n in before)


def test_library_name_follows_shared_headers(tmp_path, monkeypatch):
    """Both kernel sources include csrc/flash_common.cuh (through
    csrc/flash_hopper.cuh): an edit there must rename (so rebuild) every
    kernel library."""
    _edit_renames_libraries("flash_common.cuh", tmp_path, monkeypatch)


def test_library_name_follows_hopper_header(tmp_path, monkeypatch):
    """The same for csrc/flash_hopper.cuh, the Hopper pieces both
    sources include."""
    _edit_renames_libraries("flash_hopper.cuh", tmp_path, monkeypatch)


SEQUENCE_PARALLEL_MODULES = ("parallel/ring.py", "parallel/ulysses.py",
                             "ops/attention.py", "ops/flash.py")


@pytest.mark.parametrize("rel", SEQUENCE_PARALLEL_MODULES)
def test_sequence_parallel_modules_import_no_jax(rel):
    """Ring and Ulysses attention and the modules that route to them are
    under the import rule: no jax, no JAX package."""
    path = PORT / rel
    assert path in SOURCES, rel
    assert not set(_imported_roots(path)) & set(FORBIDDEN), rel


ORCHESTRATION_MODULES = (
    "lifecycle.py", "query.py", "config.py", "connections.py",
    "flow/__init__.py", "flow/base.py", "flow/io.py", "flow/k8s_refs.py",
    "flow/environment.py", "flow/matrix.py", "flow/component.py",
    "flow/run.py", "polyaxonfile/__init__.py", "polyaxonfile/reader.py",
    "compiler/__init__.py", "compiler/contexts.py", "compiler/templates.py",
    "compiler/resolver.py", "compiler/topology.py", "client/__init__.py",
    "client/store.py", "client/run_client.py", "client/api_client.py",
    "tracking/__init__.py", "tracking/events.py", "tracking/writer.py",
    "tracking/processors.py", "tracking/run.py", "runner/__init__.py",
    "runner/local.py", "runner/dag.py", "runner/hooks.py",
    "runner/joins.py", "tune/__init__.py", "tune/space.py",
    "tune/hyperband.py", "tune/asha.py", "tune/bayes.py", "tune/tpe.py",
    "tune/controller.py")


DEPLOYMENT_MODULES = (
    "scheduler/__init__.py", "scheduler/api.py", "scheduler/crond.py",
    "scheduler/dashboard.py", "runner/agent.py", "initializer.py",
    "sidecar.py", "k8s/__init__.py", "k8s/converter.py",
    "k8s/auxiliaries.py", "k8s/env_vars.py", "k8s/kubeclient.py",
    "k8s/stub.py", "k8s/gpu.py", "deploy.py")


@pytest.mark.parametrize("rel", DEPLOYMENT_MODULES)
def test_deployment_modules_import_no_jax(rel):
    """The deployment twin (control plane, cron, dashboard, agent,
    converter, kube transport, init and sidecar, deploy manifests) is
    under the import rule: no jax, no JAX package."""
    path = PORT / rel
    assert path in SOURCES, rel
    assert not set(_imported_roots(path)) & set(FORBIDDEN), rel


def test_orchestration_modules_are_checked():
    """The orchestration layers are under the import rule above, and the
    example polyaxonfiles ship as package data."""
    for rel in ORCHESTRATION_MODULES:
        assert PORT / rel in SOURCES, rel
    for example in sorted((PORT / "examples").glob("*.yaml")):
        assert _packaged(str(example.relative_to(PORT))), example.name


def test_orchestration_touches_no_cuda(tmp_path):
    """Tracking, the runner, the tuner, the CLI's ``run``/``ops``, the
    control plane, the converter and the agent make no CUDA call: a
    fresh interpreter whose torch.cuda entry points raise compiles a
    polyaxonfile, tracks a run, schedules a sweep, lists the runs,
    starts a control plane, converts a ``tpujob`` and runs one agent
    tick, and has no CUDA context afterwards."""
    import subprocess
    import sys

    example = PORT / "examples" / "hyperband.yaml"
    script = "\n".join([
        "import torch",
        "def boom(*a, **k):",
        "    raise AssertionError('CUDA touched')",
        "for name in ('init', '_lazy_init', 'is_available', 'device_count',",
        "             'current_device', 'synchronize', 'get_device_name',",
        "             'mem_get_info', 'set_device'):",
        "    setattr(torch.cuda, name, boom)",
        "from click.testing import CliRunner",
        "from polyaxon_tpu_torch import tracking",
        "from polyaxon_tpu_torch.cli.main import cli",
        "from polyaxon_tpu_torch.polyaxonfile import check_polyaxonfile",
        "from polyaxon_tpu_torch.runner import LocalExecutor",
        "from polyaxon_tpu_torch.tune import HyperbandManager",
        "from polyaxon_tpu_torch.compiler import resolve",
        "from polyaxon_tpu_torch.flow import V1Operation",
        "from polyaxon_tpu_torch.k8s import convert",
        "from polyaxon_tpu_torch.runner.agent import Agent, ManifestBackend",
        "from polyaxon_tpu_torch.scheduler import ControlPlane, make_server",
        f"op = check_polyaxonfile([{str(example)!r}],",
        "                         params={'data_dir': '/d'})",
        "assert len(HyperbandManager(op.matrix).initial_suggestions(1)) == 3",
        "LocalExecutor().create_run(op)",
        "run = tracking.init(name='t')",
        "run.log_metrics(step=1, loss=1.0)",
        "tracking.end()",
        "for args in (['run', '--check-only', '-f', "
        f"{str(example)!r}, '-P', 'data_dir=/d'], ['ops', 'ls'],",
        "             ['version']):",
        "    out = CliRunner().invoke(cli, args)",
        "    assert out.exit_code == 0, (args, out.output, out.exception)",
        # The control plane, the converter and one agent tick.
        "tpujob = V1Operation.from_dict({'kind': 'operation', 'component': {",
        "    'kind': 'component', 'name': 'g', 'run': {'kind': 'tpujob',",
        "    'worker': {'replicas': 2, 'container': {'command': ['true']}}}}})",
        "cr = convert(resolve(tpujob, run_uuid='u1'), 'u1')",
        "assert 'nvidia.com/gpu' in str(cr)",
        "plane = ControlPlane()",
        "server = make_server('127.0.0.1', 0, plane=plane)",
        "server.server_close()",
        "rec = plane.store.create_run(name='g', content=tpujob.to_dict())",
        "plane.store.set_status(rec['uuid'], 'queued')",
        "agent = Agent(plane, backend=ManifestBackend('cluster'))",
        "assert agent.tick()",
        "assert plane.store.get_run(rec['uuid'])['status'] == 'starting'",
        "assert not torch.cuda.is_initialized()",
        "print('ok')",
    ])
    env = {**os.environ, "POLYAXON_TPU_HOME": str(tmp_path),
           "PYTHONPATH": str(ROOT)}
    env.pop("POLYAXON_TPU_RUN_UUID", None)
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
