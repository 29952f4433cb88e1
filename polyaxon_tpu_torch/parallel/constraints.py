"""The ambient mesh and activation constraints (the training half).

Port of ``polyaxon_tpu/parallel/constraints.py``.  Models don't know the
mesh, so the train step publishes it as an *ambient mesh* for the
duration of the step (a contextvar).  The reference's models read it at
trace time to pin activation layouts; the port's losses and batch norms
read it to reduce over the data axes (``collectives.data_all_reduce``).

``constrain`` is the identity.  The reference pins a layout with
``with_sharding_constraint`` so that XLA's SPMD partitioner keeps
activations batch-sharded; under data parallelism here every
activation is already rank-local — each process computes on its own
rows of the batch with whole parameters (FSDP gathers them before the
forward) — so there is no layout to pin.  Tensor-axis constraints and
the serving-exact mesh (``exact_mesh``) come with tensor and expert
parallelism and are refused by that item's name.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Sequence, Tuple, Union

AxisName = Union[None, str, Sequence[str]]

EXACT_MESH_REFUSAL = (
    "the serving-exact mesh (exact_mesh, serving/meshed.py) comes with "
    "tensor and expert parallelism (ROADMAP Queue 1: Parallelism and "
    "meshes)")

_AMBIENT_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "ptpu_ambient_mesh", default=None)

# The canonical batch-dim axes (matches mesh.active_batch_axes).
BATCH: Tuple[str, ...] = ("dp", "fsdp")


@contextlib.contextmanager
def ambient_mesh(mesh):
    """Publish ``mesh`` to the losses and layers run inside the block."""
    token = _AMBIENT_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT_MESH.reset(token)


def current_mesh():
    return _AMBIENT_MESH.get()


def exact_mesh(mesh):
    """The reference's serving-exact mesh: refused."""
    raise NotImplementedError(EXACT_MESH_REFUSAL)


def current_exact_mesh():
    """The reference's serving-exact mesh: refused."""
    raise NotImplementedError(EXACT_MESH_REFUSAL)


def constrain(x, *axes: AxisName):
    """The reference's ``with_sharding_constraint`` against the ambient
    mesh: the identity, since a data-parallel activation is rank-local
    (module docstring)."""
    return x
