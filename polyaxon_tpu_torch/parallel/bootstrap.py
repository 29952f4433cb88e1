"""Multi-process bootstrap: env-injected topology -> ``torch.distributed``.

Port of ``polyaxon_tpu/parallel/bootstrap.py``.  The converter/agent (or
the local runner, ``runner/local.py``) injects the PTPU_* env block;
calling :func:`initialize_from_env` before any collective starts one
process group over every process of the gang: a TCP rendezvous at
``PTPU_COORDINATOR_ADDRESS`` (the chief's store), ``world_size =
PTPU_NUM_PROCESSES``, ``rank = PTPU_PROCESS_ID``.  The backend follows
the device the process trains on: ``nccl`` on ``cuda``, ``gloo`` on the
CPU; ``PTPU_DIST_BACKEND=gloo`` asks for gloo over the cards' tensors
(NCCL places no two ranks on one card, gloo does: a gang of several
ranks on one card).

Device rule: each process drives one card, ``cuda:{PTPU_PROCESS_ID %
torch.cuda.device_count()}``, made the current device before the group
starts.  ``PTPU_CHIPS_PER_HOST`` counts TPU chips per host and is not
read as a GPU count.

Besides the group itself every process gets a host-side control group
(:func:`control_group`): gloo over the same ranks, for the small
agreements that must not wait on the card (the run uuid broadcast, the
preemption vote).  On the CPU it is the default group.

Importing this module starts nothing and touches no CUDA.
"""

from __future__ import annotations

import datetime
import logging
import os
from dataclasses import dataclass
from typing import Optional, Union

import torch

logger = logging.getLogger(__name__)

ENV_COORDINATOR = "PTPU_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "PTPU_NUM_PROCESSES"
ENV_PROCESS_ID = "PTPU_PROCESS_ID"
ENV_NUM_SLICES = "PTPU_NUM_SLICES"
ENV_SLICE_TYPE = "PTPU_SLICE_TYPE"
# Seconds a member may take to join (and any later collective to
# finish) before the group fails instead of hanging the gang.
ENV_INIT_TIMEOUT = "PTPU_INIT_TIMEOUT"
DEFAULT_TIMEOUT_S = 300.0
# The backend over the cards' tensors when not NCCL ("gloo").
ENV_DIST_BACKEND = "PTPU_DIST_BACKEND"

# The group this module started, its device and its control group.
# Written only by start_process_group / shutdown on the main thread.
_initialized = False
_device: Optional[torch.device] = None
_control = None


@dataclass
class TopologyEnv:
    coordinator_address: str
    num_processes: int
    process_id: int
    num_slices: int = 1
    slice_type: Optional[str] = None

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


def topology_from_env() -> Optional[TopologyEnv]:
    """Parse the injected topology block; None when not a managed
    distributed run."""
    addr = os.environ.get(ENV_COORDINATOR)
    if not addr:
        return None
    try:
        return TopologyEnv(
            coordinator_address=addr,
            num_processes=int(os.environ.get(ENV_NUM_PROCESSES, "1")),
            process_id=int(os.environ.get(ENV_PROCESS_ID, "0")),
            num_slices=int(os.environ.get(ENV_NUM_SLICES, "1") or "1"),
            slice_type=os.environ.get(ENV_SLICE_TYPE) or None,
        )
    except ValueError as e:
        raise RuntimeError(f"Malformed PTPU_* topology env: {e}") from e


def rank_device(process_id: int,
                device: Union[str, torch.device, None] = None
                ) -> torch.device:
    """The device process ``process_id`` drives: the CPU when asked for,
    else ``cuda:{process_id % device_count}`` (raising when no card is
    there: a gang never drops to the CPU on its own)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --cpu) "
            "to run on the CPU")
    return torch.device("cuda", process_id % torch.cuda.device_count())


def _timeout_s(timeout_s: Optional[float]) -> float:
    if timeout_s is not None:
        return float(timeout_s)
    return float(os.environ.get(ENV_INIT_TIMEOUT, DEFAULT_TIMEOUT_S))


def start_process_group(init_method: str, world_size: int, rank: int,
                        device: Union[str, torch.device],
                        timeout_s: Optional[float] = None,
                        backend: Optional[str] = None) -> str:
    """Start this process's member of a ``world_size`` group and return
    its backend: ``nccl`` when ``device`` is a card (made the current
    device first), ``gloo`` on the CPU, or ``backend`` when given
    (``gloo`` over a card's tensors).  ``init_method`` is the
    rendezvous (``tcp://host:port``); a member that never joins fails
    the others after ``timeout_s`` (default ``PTPU_INIT_TIMEOUT``, else
    300 s).  The one path every group takes: :func:`initialize_from_env`
    for a gang, ``chip_smoke.py`` for its one-rank NCCL group."""
    global _initialized, _device, _control
    import torch.distributed as dist

    device = torch.device(device)
    timeout = datetime.timedelta(seconds=_timeout_s(timeout_s))
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        backend = backend or "nccl"
        if backend == "nccl":
            kwargs["device_id"] = device
    else:
        backend = "gloo"
    logger.info("torch.distributed.init_process_group(%s, %s, "
                "world_size=%d, rank=%d)", backend, init_method,
                world_size, rank)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout, **kwargs)
    _device = device
    _control = dist.new_group(backend="gloo", timeout=timeout) \
        if backend == "nccl" else dist.group.WORLD
    _initialized = True
    return backend


def initialize_from_env(timeout_s: Optional[float] = None,
                        device: Union[str, torch.device, None] = None
                        ) -> Optional[TopologyEnv]:
    """Start the process group from env; idempotent; no-op when the
    topology block is absent or trivial (single process).  ``device``:
    ``"cpu"`` for a gloo gang, else this rank's card (NCCL)."""
    topo = topology_from_env()
    if topo is None or not topo.is_distributed:
        return topo
    if _initialized:
        return topo
    start_process_group(f"tcp://{topo.coordinator_address}",
                        topo.num_processes, topo.process_id,
                        rank_device(topo.process_id, device), timeout_s,
                        backend=os.environ.get(ENV_DIST_BACKEND) or None)
    return topo


def is_initialized() -> bool:
    """Whether this process is a member of a process group."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def current_device() -> Optional[torch.device]:
    """The device the group this module started trains on (None when it
    started none)."""
    return _device if _initialized else None


def control_group():
    """The host-side (gloo) group over every rank, or None with no
    group."""
    return _control if _initialized else None


def shutdown() -> None:
    """Leave the process group this module started (the reference's
    ``jax.distributed.shutdown``); a no-op when it started none."""
    global _initialized, _device, _control
    if not _initialized:
        return
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized, _device, _control = False, None, None
