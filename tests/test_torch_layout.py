"""Layout rules of the PyTorch port.

The port and its chip smoke import nothing of JAX and nothing of the
JAX package (checked on the source: jax may already sit in
``sys.modules`` when the interpreter starts), and importing a module of
the port builds no kernel and touches no CUDA.
"""

from __future__ import annotations

import ast
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


SERVING_MODULES = ("serving/__init__.py", "serving/_lru.py",
                   "serving/debug.py", "serving/engine.py",
                   "serving/faults.py", "serving/forensics.py",
                   "serving/paged.py", "serving/recovery.py",
                   "serving/scheduler.py", "serving/server.py",
                   "serving/slots.py", "serving/telemetry.py",
                   "analysis/recompile.py")


def test_serving_modules_are_checked():
    """The serving stack is under the import rule above (SOURCES)."""
    for rel in SERVING_MODULES:
        assert PORT / rel in SOURCES, rel


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
