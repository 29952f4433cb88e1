"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface.  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``polyaxon_tpu_torch/build/`` (listed in ``.gitignore``) and loaded with
``ctypes``.  The library's name carries a hash of its source and of the
headers beside it (``csrc/*.cuh``), so an edited source or header is
rebuilt and a stale library is never loaded.  Nothing
here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# nvcc's ptxas report (registers, shared memory, spills) of each build.
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
        "built from source at first use")


def library_path(name: str, csrc: Optional[Path] = None) -> Path:
    csrc = CSRC if csrc is None else Path(csrc)
    h = hashlib.sha256()
    for path in [csrc / f"{name}.cu", *sorted(csrc.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str, csrc: Optional[Path] = None) -> Path:
    """Compile ``csrc/<name>.cu`` (or ``<csrc>/<name>.cu``, another
    version of the source beside its headers) unless its library is
    already built.  Raises with nvcc's output when the build fails."""
    csrc = CSRC if csrc is None else Path(csrc)
    out = library_path(name, csrc)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}")
    build_log[name if csrc == CSRC else f"{name} ({csrc})"] = proc.stderr
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names: Optional[list] = None) -> None:
    """Build every kernel source at once, one nvcc process each; raises
    the first failure after all have finished."""
    names = sources() if names is None else names
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = [pool.submit(build, n) for n in names]
    for f in futures:
        f.result()
