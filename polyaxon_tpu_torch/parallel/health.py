"""Slice health checks (failure detection).

Port of ``polyaxon_tpu/parallel/health.py``.  The operator supervises
pods and the control plane sweeps zombie heartbeats; this module covers
the third failure mode — the process is alive but the fabric under it
is not (a wedged driver, a card that dropped out of the NCCL ring, a
peer that hangs instead of raising).  ``check_slice_health`` runs a tiny
all-rank collective with a deadline in a worker thread: a healthy gang
answers in milliseconds; a wedged one hangs, the deadline fires, and the
caller can exit so the operator reschedules the gang (restart is the
recovery).

``train.py`` runs it right after the bootstrap, before touching the
checkpoint.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Optional

logger = logging.getLogger(__name__)


@dataclass
class SliceHealth:
    ok: bool
    detail: str
    latency_s: Optional[float] = None
    n_devices: int = 0


def check_slice_health(mesh=None, timeout_s: float = 60.0) -> SliceHealth:
    """Prove every rank (of ``mesh``, default: the world) can compute
    and communicate: an all-reduce of ones on each rank's device must
    return the number of ranks.  With no process group the probe sums
    one on this process's device.

    Never raises; never hangs past ``timeout_s`` (the probe runs in a
    daemon thread — a wedged collective strands that thread, not the
    caller)."""
    import torch

    from . import bootstrap

    distributed = bootstrap.is_initialized()
    if mesh is not None:
        n, device = int(mesh.devices.size), mesh.device
        distributed = mesh.is_distributed
    elif distributed:
        import torch.distributed as dist

        n, device = dist.get_world_size(), bootstrap.current_device()
    else:
        n, device = 1, None
    device = torch.device(device if device is not None else "cpu")
    result: dict = {}

    def probe():
        try:
            import torch.distributed as dist

            if device.type == "cuda":
                torch.cuda.set_device(device)
            ones = torch.ones(1, dtype=torch.float32, device=device)
            if distributed:
                dist.all_reduce(ones)
            result["value"] = float(ones.sum().item())
        except Exception as e:  # noqa: BLE001 - report, don't raise
            result["error"] = f"{type(e).__name__}: {e}"

    start = time.monotonic()
    thread = threading.Thread(target=probe, daemon=True,
                              name="ptpu-slice-health")
    thread.start()
    thread.join(timeout=timeout_s)
    latency = time.monotonic() - start

    if thread.is_alive():
        return SliceHealth(
            ok=False, latency_s=None, n_devices=n,
            detail=f"collective probe hung past {timeout_s:.0f}s "
                   f"(runtime wedged?); probe thread left to finish")
    if "error" in result:
        return SliceHealth(ok=False, latency_s=latency, n_devices=n,
                           detail=result["error"])
    value = result.get("value")
    if value != float(n):
        return SliceHealth(
            ok=False, latency_s=latency, n_devices=n,
            detail=f"all-reduce over {n} devices returned {value}")
    return SliceHealth(ok=True, latency_s=latency, n_devices=n,
                       detail=f"{n} devices healthy")
