"""System-metric processors: host (psutil) and NVIDIA GPU device stats.

Port of ``polyaxon_tpu/tracking/processors.py``.  ``host_metrics`` is
copied as it is.  The JAX package's TPU block (``tpu_metrics``) becomes
``gpu_metrics``, the GPU block of the reference polyaxon that the TPU
block had replaced: memory, utilization and power of every card this
process may use, read through NVML (``libnvidia-ml.so.1`` by ``ctypes``),
or through ``nvidia-smi`` where NVML cannot be loaded; ``{}`` when no
NVIDIA driver is present.

Neither reader makes a CUDA runtime call: the monitor samples on a daemon
thread, and a CUDA call there could create a context in a process that
has none, or break a CUDA graph another thread is capturing.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
import subprocess
import threading
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


def host_metrics() -> Dict[str, float]:
    out: Dict[str, float] = {}
    try:
        import psutil
    except ImportError:
        return out
    try:
        out["cpu_percent"] = psutil.cpu_percent(interval=None)
        vm = psutil.virtual_memory()
        out["memory_percent"] = vm.percent
        out["memory_used_gb"] = vm.used / 1e9
        du = psutil.disk_usage("/")
        out["disk_percent"] = du.percent
        net = psutil.net_io_counters()
        out["net_sent_gb"] = net.bytes_sent / 1e9
        out["net_recv_gb"] = net.bytes_recv / 1e9
        load1, _, _ = os.getloadavg()
        out["load1"] = load1
    except Exception:
        # Sampling is best-effort (a container without /proc/net or
        # loadavg just reports fewer fields) — but say so, or a host
        # with NO metrics looks identical to one never sampled.
        logger.debug("host metric sampling failed", exc_info=True)
    return out


class _Memory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


class _Utilization(ctypes.Structure):
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


@functools.lru_cache(maxsize=1)
def _nvml() -> Optional[ctypes.CDLL]:
    """The NVML library, initialised once; None where it cannot load."""
    try:
        lib = ctypes.CDLL("libnvidia-ml.so.1")
    except OSError:
        return None
    handle = ctypes.c_void_p
    lib.nvmlInit_v2.restype = ctypes.c_int
    lib.nvmlDeviceGetCount_v2.argtypes = [ctypes.POINTER(ctypes.c_uint)]
    lib.nvmlDeviceGetHandleByIndex_v2.argtypes = [
        ctypes.c_uint, ctypes.POINTER(handle)]
    lib.nvmlDeviceGetName.argtypes = [handle, ctypes.c_char_p, ctypes.c_uint]
    lib.nvmlDeviceGetMemoryInfo.argtypes = [handle, ctypes.POINTER(_Memory)]
    lib.nvmlDeviceGetUtilizationRates.argtypes = [
        handle, ctypes.POINTER(_Utilization)]
    lib.nvmlDeviceGetPowerUsage.argtypes = [handle,
                                            ctypes.POINTER(ctypes.c_uint)]
    if lib.nvmlInit_v2() != 0:
        return None
    return lib


def _visible(count: int) -> List[int]:
    """The NVML indices of the cards this process may use, in CUDA's
    order: ``CUDA_VISIBLE_DEVICES`` when it lists indices, else all."""
    raw = os.environ.get("CUDA_VISIBLE_DEVICES")
    if raw is None:
        return list(range(count))
    try:
        picked = [int(x) for x in raw.split(",") if x.strip()]
    except ValueError:  # UUIDs or MIG names: report every card
        return list(range(count))
    return [i for i in picked if 0 <= i < count]


def _nvml_devices(lib) -> List[Dict[str, Any]]:
    count = ctypes.c_uint()
    if lib.nvmlDeviceGetCount_v2(ctypes.byref(count)) != 0:
        return []
    devices = []
    for index in _visible(count.value):
        handle = ctypes.c_void_p()
        if lib.nvmlDeviceGetHandleByIndex_v2(index,
                                             ctypes.byref(handle)) != 0:
            continue
        dev: Dict[str, Any] = {}
        name = ctypes.create_string_buffer(96)
        if lib.nvmlDeviceGetName(handle, name, len(name)) == 0:
            dev["name"] = name.value.decode(errors="replace")
        mem = _Memory()
        if lib.nvmlDeviceGetMemoryInfo(handle, ctypes.byref(mem)) == 0:
            dev["used"], dev["total"] = mem.used, mem.total
        util = _Utilization()
        if lib.nvmlDeviceGetUtilizationRates(handle,
                                             ctypes.byref(util)) == 0:
            dev["utilization"] = float(util.gpu)
        milliwatts = ctypes.c_uint()
        if lib.nvmlDeviceGetPowerUsage(handle,
                                       ctypes.byref(milliwatts)) == 0:
            dev["power_w"] = milliwatts.value / 1e3
        devices.append(dev)
    return devices


def _smi_devices() -> List[Dict[str, Any]]:
    """The same readings from ``nvidia-smi`` (MiB and W); [] without it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,memory.used,"
             "memory.total,utilization.gpu,power.draw",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=10, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    rows = {}
    for line in out.strip().splitlines():
        cells = [c.strip() for c in line.split(",")]
        if len(cells) != 6:
            continue
        dev: Dict[str, Any] = {"name": cells[1]}
        for key, cell, scale in (("used", cells[2], 2 ** 20),
                                 ("total", cells[3], 2 ** 20),
                                 ("utilization", cells[4], 1),
                                 ("power_w", cells[5], 1)):
            try:
                dev[key] = float(cell) * scale
            except ValueError:  # "[N/A]"
                pass
        rows[int(cells[0])] = dev
    return [rows[i] for i in _visible(len(rows)) if i in rows]


def gpu_devices() -> List[Dict[str, Any]]:
    """Per card: ``name``, ``used``/``total`` memory bytes, ``utilization``
    (%) and ``power_w``, each where the driver reports it."""
    lib = _nvml()
    return _nvml_devices(lib) if lib is not None else _smi_devices()


def gpu_metrics() -> Dict[str, float]:
    """Per-process GPU device stats; {} when no NVIDIA driver is present."""
    devices = gpu_devices()
    if not devices:
        return {}
    out: Dict[str, float] = {"gpu_local_devices": float(len(devices))}
    for i, dev in enumerate(devices):
        used, total = dev.get("used"), dev.get("total")
        if used is not None:
            out[f"gpu{i}_memory_used_gb"] = used / 1e9
            if total:
                out[f"gpu{i}_memory_percent"] = 100.0 * used / total
        for key in ("utilization", "power_w"):
            if key in dev:
                out[f"gpu{i}_{key}"] = dev[key]
    return out


class SystemMetricsMonitor:
    """Daemon thread sampling host+GPU metrics into the event stream."""

    def __init__(self, log_fn, interval: float = 30.0):
        self._log_fn = log_fn  # (name, value, timestamp) -> None
        self._interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ptpu-sys-metrics")
        self._thread.start()

    def _loop(self) -> None:
        # A first sample at start: a run shorter than the interval still
        # records its devices.
        self.sample()
        while not self._stop.wait(self._interval):
            self.sample()

    def sample(self) -> Dict[str, float]:
        now = time.time()
        metrics = {**host_metrics(), **gpu_metrics()}
        for name, value in metrics.items():
            try:
                self._log_fn(name, value, now)
            except Exception:
                # One bad event must not end the monitor thread; a
                # persistently failing sink still leaves a trace.
                logger.debug("system metric log failed: %s", name,
                             exc_info=True)
        return metrics

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
