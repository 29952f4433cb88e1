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
  saves the state after the step in flight and exits.

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
    is replaced by the saved value."""
    if hasattr(template, "load_state_dict"):
        template.load_state_dict(saved)
        return template
    if isinstance(template, dict):
        return {k: _load_into(template[k], saved[k]) if k in template
                else saved[k] for k in saved}
    return saved


class CheckpointManager:
    """Step-numbered checkpoints in one directory (default:
    :func:`default_checkpoint_dir`), the newest ``MAX_TO_KEEP`` kept."""

    def __init__(self, directory: Optional[str] = None):
        self.directory = os.path.abspath(directory
                                         or default_checkpoint_dir())
        os.makedirs(self.directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
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
        if step in self.all_steps():
            return False
        payload = {"state": _to_host(state)}
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
