"""Checkpoint/resume on ``torch.save``.

Port of ``polyaxon_tpu/checkpoint.py`` (Orbax there):

- one directory per step, ``<dir>/<step>/state.pt``, written under a
  temporary name and renamed into place, so a reader never sees half a
  checkpoint; the newest three steps are kept;
- saves off the step path: the state is copied to host memory on the
  caller's thread (the next step updates the parameters in place) and
  written to disk by a background thread; ``wait`` blocks until the
  queued saves are durable;
- ``restore_or_init``: the latest step wins, an empty directory starts
  fresh; a restore loads into the live state's model and optimizer;
- preemption: SIGTERM sets ``preempt_requested`` and the training loop
  saves the state after the step in flight and exits;
- a gang (a process group is up) saves collectively: every rank joins,
  each parameter a rank holds a shard of, and its optimizer state, is
  gathered into the whole tensor, over fsdp (FSDP2's DTensors) and then
  over its tensor or expert axis (``strategies.shard_tensors``; a
  by-heads ``qkv`` put back in order), and the chief (rank 0) writes one
  full state in the layout a one-process run writes (the optimizer's
  groups merged into one), so one process, or ``serve --checkpoint``,
  restores what a gang wrote and a gang restores on every rank what one
  process wrote, each rank keeping its shard on both axes.  A model
  split over pp (``strategies.keep_stage_blocks``) saves each stage's
  blocks from the pp rank that holds them (gathered over fsdp and tp on
  that stage first), and restores on each pp rank only its own.  SIGTERM at
  any rank stops every rank after the same step
  (``preemption_agreed``, a vote on the gang's host-side group).

Layout: ``<run outputs>/checkpoints/<step>/`` for a run named by
``POLYAXON_TPU_RUN_UUID`` (under ``POLYAXON_TPU_HOME``), else
``./checkpoints``.
"""

from __future__ import annotations

import logging
import os
import shutil
import signal
import threading
from typing import Any, Optional

import torch

logger = logging.getLogger(__name__)

CHECKPOINTS_DIR = "checkpoints"
MAX_TO_KEEP = 3
_STATE_FILE = "state.pt"


def _to_host(state: Any) -> Any:
    """The state as plain CPU data: modules and optimizers by their
    ``state_dict``, tensors copied to host memory."""
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    if isinstance(state, dict):
        return {k: _to_host(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_to_host(v) for v in state)
    return state


def _load_into(template: Any, saved: Any) -> Any:
    """``saved`` loaded into ``template``'s live objects: a module or
    optimizer loads its state dict in place; dicts recurse; anything else
    is replaced by the saved value.  A train state whose model a gang
    shards (FSDP, a tensor or an expert axis) loads the full state into
    its shards."""
    if _is_sharded_state(template):
        _load_sharded(template, saved)
        return {k: template[k] if k in ("params", "opt_state")
                else saved[k] for k in saved}
    if hasattr(template, "load_state_dict"):
        template.load_state_dict(saved)
        return template
    if isinstance(template, dict):
        return {k: _load_into(template[k], saved[k]) if k in template
                else saved[k] for k in saved}
    return saved


def _gang():
    """(rank, world) of this process's group; (0, 1) with none."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _is_sharded_state(state: Any) -> bool:
    """A train state ({params, opt_state, ...}) whose model FSDP wraps
    or holds tp / ep shards."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(state, dict) and \
        isinstance(state.get("params"), torch.nn.Module) and \
        (isinstance(state["params"], FSDPModule) or
         bool(_tensor_shards(state)) or
         _layout(state["params"]) is not None)


def _layout(model):
    """The pipeline layout of a model split over pp, else None."""
    return getattr(model, "pipeline_layout", None)


def _tensor_shards(state: Any) -> dict:
    """name -> (axis, dim) of the tp / ep shards a train state's model
    holds ({} for any other state)."""
    from .parallel.strategies import tensor_shards

    return tensor_shards(state["params"])


def _param_names(model) -> list:
    """The trainable parameters' names, in the order a one-process
    optimizer indexes them (``TrainStep.init_state``); a model split
    over pp names its other stages' too."""
    layout = _layout(model)
    if layout is not None:
        return list(layout.params)
    return [n for n, p in model.named_parameters() if p.requires_grad]


def _sharded_to_host(state: dict) -> dict:
    """Collective: the one-process layout of a sharded train state,
    on the chief's host (every rank gathers; the chief writes).  The
    optimizer state is indexed as a one-process optimizer's
    ``state_dict`` indexes it, its groups (sharded, replicated) merged
    into one."""
    from .parallel.strategies import gather_full

    model, opt = state["params"], state["opt_state"]
    host = _gang()[0] == 0

    def full(name, t):
        t = gather_full(model, name, t)
        return t.detach().to("cpu", copy=True) if host else None

    live = model.state_dict()
    layout = _layout(model)
    order = list(live) if layout is None else \
        [name for name, _, _ in layout.entries]
    # Every rank walks the whole model in one order; a pp rank passes
    # None for the blocks another stage holds.
    msd = {name: full(name, live.get(name)) for name in order}
    osd = opt.state_dict()
    groups = osd["param_groups"]
    hyper = {k: v for k, v in groups[0].items() if k != "params"}
    if any({k: v for k, v in g.items() if k != "params"} != hyper
           for g in groups):
        raise ValueError("checkpoint: optimizer groups differ in "
                         "hyperparameters")
    names = _opt_names(model, opt)
    by_name = {names[i]: st for i, st in osd["state"].items()}
    # Another stage's parameter: its state holds the same keys as this
    # rank's first one.
    like = next(iter(by_name.values()), None) if layout is not None \
        else None
    state_ = {}
    for i, name in enumerate(_param_names(model)):
        st = by_name.get(name, like)
        if st is not None:
            state_[i] = {k: full(name, by_name[name][k] if name in by_name
                                 else None)
                         if isinstance(v, torch.Tensor) and v.dim() else v
                         for k, v in st.items()}
    out = _to_host({k: v for k, v in state.items()
                    if k not in ("params", "opt_state")})
    out.update(params=msd, opt_state={
        "state": state_,
        "param_groups": [{**hyper, "params": list(range(
            len(_param_names(model))))}]})
    return out


def _like(p: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """``local`` as ``p`` holds its block: a DTensor laid out as ``p``
    when ``p`` is one (an optimizer's state must match its
    parameter)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(p, DTensor):
        return local
    return DTensor.from_local(local.to(p.to_local().device), p.device_mesh,
                              p.placements, run_check=False)


def _opt_names(model, opt) -> list:
    """The parameter name of each index of ``opt.state_dict()`` (its
    groups' parameters in order)."""
    name_of = {id(p): n for n, p in model.named_parameters()}
    return [name_of[id(p)] for g in opt.param_groups for p in g["params"]]


def _load_sharded(state: dict, saved: dict) -> None:
    """Load a full saved state (every rank holds it) into a sharded
    train state: each rank keeps its shard of each tensor, on every
    axis that shards it."""
    from .parallel.strategies import local_block, local_full

    model, opt = state["params"], state["opt_state"]
    live = model.state_dict()
    layout = _layout(model)
    names = live.keys() if layout is None else \
        {name for name, _, _ in layout.entries}
    if names != saved["params"].keys():
        raise KeyError(f"checkpoint does not match the model: "
                       f"{sorted(names ^ saved['params'].keys())}")
    with torch.no_grad():
        for name, t in live.items():
            local_block(t).copy_(
                local_full(model, name, t, saved["params"][name]))
    names = _opt_names(model, opt)
    params = [p for g in opt.param_groups for p in g["params"]]
    index = {n: i for i, n in enumerate(_param_names(model))}
    osd = saved["opt_state"]
    hyper = {k: v for k, v in osd["param_groups"][0].items()
             if k != "params"}
    state_ = {}
    for i, (name, p) in enumerate(zip(names, params)):
        st = osd["state"].get(index[name])
        if st is not None:
            state_[i] = {k: _like(p, local_full(model, name, p, v))
                         if isinstance(v, torch.Tensor) and v.dim() else v
                         for k, v in st.items()}
    groups, at = [], 0
    for g in opt.param_groups:        # the live groups, in order
        n = len(g["params"])
        groups.append({**hyper, "params": list(range(at, at + n))})
        at += n
    opt.load_state_dict({"state": state_, "param_groups": groups})


class CheckpointManager:
    """Step-numbered checkpoints in one directory (default:
    :func:`default_checkpoint_dir`), the newest ``MAX_TO_KEEP`` kept."""

    def __init__(self, directory: Optional[str] = None):
        self.directory = os.path.abspath(directory
                                         or default_checkpoint_dir())
        os.makedirs(self.directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        # The steps on disk as every rank of a gang agrees on them: the
        # chief's write of a step may still be in flight when another
        # rank asks, so a gang never decides from a listing.
        self._steps = set(self.all_steps())
        # Set by the SIGTERM hook; the training loop polls it and saves
        # cooperatively after the step in flight.
        self.preempt_requested = False

    # -- save/restore ----------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def save(self, step: int, state: Any) -> bool:
        """Start a save of ``state`` as ``step``; returns whether one was
        started.  Idempotent: re-saving an existing step is a no-op, not
        an error (the final save often lands on the last periodic
        step)."""
        step = int(step)
        self.wait()  # one write in flight at a time, in step order
        rank, world = _gang()
        if step in (self._steps if world > 1 else self.all_steps()):
            return False
        self._steps.add(step)
        # Collective for a sharded model: every rank gathers.
        host = _sharded_to_host(state) if _is_sharded_state(state) \
            else state
        if rank != 0:
            return False  # the chief writes the one full state
        payload = {"state": _to_host(host)}
        self._writer = threading.Thread(
            target=self._write, args=(step, payload), daemon=True)
        self._writer.start()
        return True

    def _write(self, step: int, payload: dict) -> None:
        tmp = f"{self._step_dir(step)}.tmp-{os.getpid()}"
        try:
            os.makedirs(tmp, exist_ok=True)
            torch.save(payload, os.path.join(tmp, _STATE_FILE))
            os.replace(tmp, self._step_dir(step))  # atomic publish
            for old in self.all_steps()[:-MAX_TO_KEEP]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
        except Exception as e:  # surfaced by wait()
            shutil.rmtree(tmp, ignore_errors=True)
            self._error = e

    def restore(self, step: Optional[int] = None,
                template: Any = None) -> Any:
        """Restore a step (default: latest).  ``template``: the live
        state, whose model and optimizer load the saved state in place
        (they keep their device); without it the saved data comes back
        as plain CPU data."""
        step = int(step) if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"No checkpoints under {self.directory}")
        saved = torch.load(os.path.join(self._step_dir(step), _STATE_FILE),
                           map_location="cpu", weights_only=True)["state"]
        return saved if template is None else _load_into(template, saved)

    def restore_or_init(self, init_state: Any) -> tuple:
        """(state, restored_step): auto-resume or fresh start."""
        step = self.latest_step()
        if step is None:
            return init_state, None
        logger.info("resuming from checkpoint step %s", step)
        return self.restore(step, template=init_state), step

    # -- introspection ---------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self):
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit())

    def wait(self) -> None:
        """Block until queued saves are durable; raises a failed save's
        error."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from err

    def close(self) -> None:
        self.wait()

    # -- preemption ------------------------------------------------------

    def preemption_agreed(self) -> bool:
        """Whether to save and stop after this step: this process's
        SIGTERM flag, or in a gang any rank's (a MAX vote on the gang's
        host-side group, so every rank stops after the same step)."""
        from .parallel import bootstrap

        group = bootstrap.control_group()
        if group is None:
            return self.preempt_requested
        import torch.distributed as dist

        flag = torch.tensor([int(self.preempt_requested)])
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
        self.preempt_requested = bool(flag.item())
        return self.preempt_requested

    def install_preemption_hook(self) -> None:
        """SIGTERM -> a save at the next step boundary.

        An eager step updates the parameters in place, so a save from
        inside the signal handler could catch a half-applied update.
        The handler only sets ``preempt_requested``; the training loop
        checks the flag after each step, saves the state and exits
        within the operator's SIGTERM grace period.
        """
        def handler(signum, frame):
            logger.warning("preemption notice: checkpoint at the next "
                           "step boundary")
            self.preempt_requested = True

        self.preempt_requested = False
        signal.signal(signal.SIGTERM, handler)


def run_outputs_path(run_uuid: str) -> str:
    """``<home>/runs/<uuid>/artifacts/outputs``, the JAX package's
    ``compiler.contexts.run_outputs_path`` (home: ``POLYAXON_TPU_HOME``,
    else ``~/.polyaxon_tpu``)."""
    home = os.environ.get(
        "POLYAXON_TPU_HOME",
        os.path.join(os.path.expanduser("~"), ".polyaxon_tpu"))
    return os.path.join(home, "runs", run_uuid, "artifacts", "outputs")


def default_checkpoint_dir(run_uuid: Optional[str] = None) -> str:
    """``<run outputs>/checkpoints`` for the active (or given) run."""
    run_uuid = run_uuid or os.environ.get("POLYAXON_TPU_RUN_UUID")
    if run_uuid:
        return os.path.join(run_outputs_path(run_uuid), CHECKPOINTS_DIR)
    return os.path.join(os.getcwd(), CHECKPOINTS_DIR)
