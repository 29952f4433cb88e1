"""The ambient mesh, the serving-exact mesh and activation constraints.

Port of ``polyaxon_tpu/parallel/constraints.py``.  Models don't know the
mesh, so their callers publish it in a contextvar for the duration of a
call.  Two channels, with different semantics:

- the AMBIENT mesh (training): the train step publishes it; the port's
  losses and batch norms read it to reduce over the data axes
  (``collectives.data_all_reduce``).  ``constrain`` ignores it: under
  data parallelism every activation is already rank-local — each
  process computes on its own rows of the batch with whole parameters
  (FSDP gathers them before the forward) — so there is no layout to
  pin, where the reference pins one with ``with_sharding_constraint``.
  Under a tensor or expert axis the LAYERS, not ``constrain``, enter
  and leave the region where the reference's tensor-axis sites stand:
  a column-parallel dense layer's input passes ``copy_to_region``, a
  row-parallel one's output ``reduce_from_region``, a vocab-parallel
  table's lookup and logits reduce and gather, and ``moe_layer``
  splits and gathers the sequence over ep (``models/layers.py``,
  ``parallel/moe.py``).  Each layer knows whether it holds a shard
  (``strategies.shard_tensors`` swapped it in), so the model code
  reads the same on one device and on a gang, and ``constrain`` stays
  the identity in training.
- the SERVING-EXACT mesh (``exact_mesh``, ``serving/meshed.py``): a
  placed model publishes its mesh group for each forward.  The serving
  layout sums nothing across devices (tokens bitwise equal to unmeshed
  execution on the CPU; ``serving/meshed.py`` for CUDA), so every
  ``constrain`` site that names a TENSOR axis ("tp"/"ep") forces the
  activation REPLICATED: the column shards are concatenated on the
  group's primary device right before the row-parallel contraction that
  Megatron's layout would psum.  Concatenation moves bytes and never
  reassociates a sum, so column-parallel products keep each output
  element's accumulation order and per-head attention stays per head.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Sequence, Tuple, Union

AxisName = Union[None, str, Sequence[str]]

_AMBIENT_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "ptpu_ambient_mesh", default=None)

# The serving-exact mesh: a SECOND channel (module docstring).
_EXACT_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "ptpu_serving_exact_mesh", default=None)

# The canonical batch-dim axes (matches mesh.active_batch_axes).
BATCH: Tuple[str, ...] = ("dp", "fsdp")

# Axes whose constrain sites sit immediately before a contraction over
# the constrained dim (o_proj/down_proj/fc2 inputs): the exact mode's
# force-replicate points.
TENSOR_AXES: Tuple[str, ...] = ("tp", "ep")


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


@contextlib.contextmanager
def exact_mesh(mesh):
    """Publish ``mesh`` (an object with ``gather``: a
    ``serving.meshed.MeshGroup``) as the serving-exact mesh for the
    calls inside the block (no-op when ``mesh`` is None).
    Contextvar-scoped, so concurrent meshed and unmeshed calls on other
    threads never see it."""
    if mesh is None:
        yield None
        return
    token = _EXACT_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _EXACT_MESH.reset(token)


def current_exact_mesh():
    return _EXACT_MESH.get()


def _names(a) -> tuple:
    return (a,) if isinstance(a, str) else tuple(a or ())


def constrain(x, *axes: AxisName):
    """The reference's ``with_sharding_constraint`` site.

    Outside a serving-exact mesh: the identity (a data-parallel
    activation is rank-local, module docstring).  Under one, a site
    naming a TENSOR axis returns ``x`` REPLICATED on the mesh group's
    primary device: a list of column shards is concatenated there along
    the last dim (``mesh.gather``), a tensor is moved there; every other
    site is a no-op."""
    emesh = _EXACT_MESH.get()
    if emesh is not None and any(n in TENSOR_AXES for a in axes
                                 for n in _names(a)):
        return emesh.gather(x)
    return x
