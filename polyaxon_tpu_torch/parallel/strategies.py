"""The train step: one device, or data parallel over a mesh.

Port of ``TrainStep`` and ``make_train_step`` of
``polyaxon_tpu/parallel/strategies.py``.  The reference jits a pure
``step(state, batch, rng) -> (state, metrics)`` over a mesh with donated
state; here the state's parameters live in an ``nn.Module`` and its
optimizer state in a ``torch.optim.Optimizer``, both updated in place
(the eager counterpart of donation: no second copy of either).

Over a mesh built on a process group (``mesh.build_mesh`` after the
bootstrap) every rank computes on its rows of the global batch
(``batch_sharding``) and the step is the global one:

- **dp**: the parameters are replicated; after the backward their
  gradients are all-reduced as a mean over the data axes (dp x fsdp) in
  flat buckets.
- **fsdp**: the parameters the reference's ``infer_param_spec`` shards
  (at least ``fsdp_min_size`` elements, on their largest matmul dim,
  when it divides by the fsdp size: :func:`param_placement`) and their
  optimizer state are sharded over the ``fsdp`` axis with FSDP2's
  ``fully_shard`` (each block of a layer list, then the model); the
  smaller ones stay replicated and take the dp all-reduce.  With dp > 1
  as well FSDP2 replicates over dp (HSDP).

Losses and batch norms reduce over the data axes themselves where the
reference's are global sums (the MLM mask count, batch statistics); the
ambient mesh (``constraints.ambient_mesh``) tells them the axes.  The
metrics are their mean over the data ranks, and ``grad_norm`` the global
norm of the reduced gradients.  A mesh built over a process group takes
this path even with one rank, so a one-rank NCCL group runs the wrap a
gang runs; a mesh with no group, or none, is the one-device path.

Tensor, expert, sequence and pipeline axes above 1 are refused by the
ROADMAP item that carries them; ``precompile`` (AOT compilation) has no
eager counterpart.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch

from .. import prng
from ..models.layers import batch_stats
from .collectives import data_all_reduce_mean
from .constraints import ambient_mesh
from .mesh import MeshSpec, build_mesh, data_sharding

PARALLELISM_REFUSAL = (
    "tensor, expert, sequence and pipeline parallelism in training come "
    "with later slices of the port (ROADMAP Queue 1: Parallelism and "
    "meshes, item (b2) for tp/ep)")

# Flat gradient buckets of the dp all-reduce.
BUCKET_BYTES = 25 * 2 ** 20


def check_mesh(mesh) -> None:
    """Refuse a mesh whose tp, ep, sp or pp axis is above 1."""
    big = {a: mesh.shape[a] for a in ("tp", "ep", "sp", "pp")
           if mesh.shape.get(a, 1) > 1}
    if big:
        raise NotImplementedError(f"mesh {big}: {PARALLELISM_REFUSAL}")


def param_placement(shape, *, layers: int = 1, fsdp: bool = True,
                    fsdp_min_size: int = 2 ** 16) -> Optional[int]:
    """The dim of a port parameter that the fsdp axis shards, or None
    (replicated): the fsdp branch of the reference's
    ``infer_param_spec``, applied to the leaf the reference holds.

    The reference scans its layer stacks, so a block's parameter is one
    leaf ``[layers, *shape]`` there: ``layers`` > 1 says so, and the
    size and dims are the stacked leaf's.  A leaf of at least
    ``fsdp_min_size`` elements shards its largest matmul dim (ties: the
    earlier), else its largest other dim.  The matmul dims are the
    leaf's trailing two, except for a 4-D convolution kernel, which the
    port holds as (out, in, kh, kw) where flax holds (kh, kw, in, out):
    its first two.  A stacked leaf whose chosen dim is the layer axis
    stays replicated here (the port shards each block's parameter, and
    has no layer axis)."""
    shape = tuple(int(d) for d in shape)
    full = ((layers,) if layers > 1 else ()) + shape
    if not fsdp or not shape or math.prod(full) < fsdp_min_size:
        return None
    n, off = len(full), len(full) - len(shape)
    matmul = [0, 1] if n == 4 and not off else list(range(max(0, n - 2), n))
    lead = [i for i in range(n) if i not in matmul]
    order = sorted(matmul, key=lambda i: -full[i]) + \
        sorted(lead, key=lambda i: -full[i])
    dim = order[0] - off
    return dim if dim >= 0 else None


def _stack_sizes(model: torch.nn.Module) -> Dict[str, int]:
    """Name prefix of each block of a layer list -> the list's length,
    for a model whose reference scans its stacks (``scan_layers``, on
    unless the config turns it off)."""
    if not getattr(getattr(model, "cfg", None), "scan_layers", True):
        return {}
    return {f"{name}.{i}.": len(lst)
            for name, lst in model.named_modules()
            if isinstance(lst, torch.nn.ModuleList)
            for i in range(len(lst))}


def make_param_placements(model: torch.nn.Module, mesh, *,
                          fsdp_min_size: int = 2 ** 16
                          ) -> Dict[str, Optional[int]]:
    """name -> sharded dim or None for every parameter of ``model``
    (the counterpart of ``make_param_shardings`` for the data axes): a
    dim that does not divide by the fsdp size stays replicated, as the
    reference drops an axis that does not divide.  The fsdp axis is on
    when the mesh's spec asks for it (a size above 1, or -1 filled)."""
    spec = getattr(mesh, "spec", None)
    size = mesh.shape.get("fsdp", 1)
    on = size > 1 or (spec is not None and spec.fsdp == -1)
    stacks = _stack_sizes(model)
    out = {}
    for name, p in model.named_parameters():
        layers = next((n for prefix, n in stacks.items()
                       if name.startswith(prefix)), 1)
        dim = param_placement(p.shape, layers=layers, fsdp=on,
                              fsdp_min_size=fsdp_min_size)
        out[name] = dim if dim is not None and p.shape[dim] % size == 0 \
            else None
    return out


def _layer_blocks(model: torch.nn.Module) -> list:
    """The blocks of the model's layer lists (each an FSDP unit)."""
    return [m for lst in model.modules()
            if isinstance(lst, torch.nn.ModuleList) for m in lst]


def _data_groups(mesh) -> list:
    """The process groups of the data axes above 1; the dp group on a
    mesh of one rank, so its all-reduce still runs."""
    groups = [mesh.group(a) for a in ("dp", "fsdp") if mesh.shape[a] > 1]
    return groups or [mesh.group("dp")]


def all_reduce_grads(grads, mesh) -> None:
    """Replace each gradient by its mean over the data axes, in flat
    buckets of at most :data:`BUCKET_BYTES` of one dtype."""
    import torch.distributed as dist

    n = mesh.shape["dp"] * mesh.shape["fsdp"]
    groups = _data_groups(mesh)
    bucket, size = [], 0

    def flush():
        if not bucket:
            return
        flat = torch.cat([g.reshape(-1) for g in bucket])
        for group in groups:
            dist.all_reduce(flat, group=group)
        if n > 1:
            flat.div_(n)
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        bucket.clear()

    for g in sorted(grads, key=lambda g: str(g.dtype)):
        if bucket and (g.dtype != bucket[0].dtype or
                       size + g.numel() * g.element_size() > BUCKET_BYTES):
            flush()
            size = 0
        bucket.append(g)
        size += g.numel() * g.element_size()
    flush()


def _is_dtensor(t) -> bool:
    return type(t).__name__ == "DTensor"


class TrainStep:
    """``loss_fn(batch, rng) -> (loss, aux)`` into
    ``step(state, batch, rng) -> (state, metrics)``; ``state`` is a dict
    {params: the model, opt_state: its optimizer, step: int}.

    ``optimizer`` is a factory ``params -> torch.optim.Optimizer``
    (``train.make_optimizer``), bound to the model by :meth:`init_state`.
    ``mesh``: None (one device), a :class:`~.mesh.Mesh`, or axis sizes
    ({"dp": -1}, ...) built into one.  Over a distributed mesh ``batch``
    is this rank's rows of the global batch
    (``batch_sharding.shard(global_batch)``; ``data.prefetch_to_device``
    with ``batch_sharding`` stages them).

    With ``grad_accum`` k the batch splits into k micro-batches along its
    first axis; loss, gradients and aux are averaged over them, as the
    reference's scan does, and micro-batch i draws from
    ``fold_in(rng, i)``.  Metrics are the loss, ``grad_norm`` (the
    global L2 norm of the gradients before the update, optax's
    ``global_norm``) and the aux, as device scalars.

    Batch-norm running averages (``layers.batch_stats``, the
    reference's ``batch_stats`` riding the aux as ``__new_vars__``)
    advance once a step and stay out of the metrics: the loss's train
    forward advances them in place; under ``grad_accum`` every
    micro-batch starts from the step's old averages and the step keeps
    the mean of the k results, as the reference's scan averages its
    stacked aux."""

    def __init__(self, loss_fn: Callable, optimizer: Callable,
                 mesh=None, *, grad_accum: int = 1,
                 fsdp_min_size: int = 2 ** 16):
        if isinstance(mesh, dict):
            mesh = build_mesh(MeshSpec.from_dict(mesh))
        if mesh is not None:
            check_mesh(mesh)
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1; got {grad_accum}")
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.grad_accum = grad_accum
        self.mesh = mesh
        self.fsdp_min_size = fsdp_min_size
        self.distributed = mesh is not None and mesh.is_distributed
        self.batch_sharding = data_sharding(mesh) \
            if mesh is not None else None
        self.placements: Dict[str, Optional[int]] = {}

    def init_state(self, model: torch.nn.Module) -> Dict[str, Any]:
        if self.distributed:
            self._distribute(model)
        params = [p for p in model.parameters() if p.requires_grad]
        sharded = [p for p in params if _is_dtensor(p)]
        if sharded and len(sharded) < len(params):
            # One group of DTensors and one of plain tensors: the fused
            # (foreach) optimizer kernels take one kind at a time.
            params = [{"params": sharded},
                      {"params": [p for p in params if not _is_dtensor(p)]}]
        return {"params": model, "opt_state": self.optimizer(params),
                "step": 0}

    def _distribute(self, model: torch.nn.Module) -> None:
        """Rank 0's weights and buffers on every rank (the reference
        places one host tree), then the fsdp wrap."""
        import torch.distributed as dist

        with torch.no_grad():
            for t in list(model.parameters()) + list(model.buffers()):
                dist.broadcast(t.data, src=0)
        self.placements = make_param_placements(
            model, self.mesh, fsdp_min_size=self.fsdp_min_size)
        sharded = {name: dim for name, dim in self.placements.items()
                   if dim is not None}
        if not sharded:
            return
        from torch.distributed.fsdp import fully_shard
        from torch.distributed.tensor import Shard

        dm = self.mesh.device_mesh
        dm = dm["dp", "fsdp"] if self.mesh.shape["dp"] > 1 else dm["fsdp"]
        params = dict(model.named_parameters())
        dims = {id(params[name]): dim for name, dim in sharded.items()}
        ignored = {p for name, p in params.items() if name not in sharded}

        def placement(p):
            return Shard(dims[id(p)])

        for block in _layer_blocks(model):
            fully_shard(block, mesh=dm, shard_placement_fn=placement,
                        ignored_params=ignored)
        fully_shard(model, mesh=dm, shard_placement_fn=placement,
                    ignored_params=ignored)

    def __call__(self, state: Dict[str, Any], batch, rng=None):
        model, opt = state["params"], state["opt_state"]
        opt.zero_grad(set_to_none=True)
        with ambient_mesh(self.mesh):
            loss, aux = self._forward_backward(model, batch, rng)
        grads = [p.grad for group in opt.param_groups
                 for p in group["params"] if p.grad is not None]
        if self.distributed:
            grad_norm, loss, aux = self._reduce(grads, loss, aux)
        else:
            grad_norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g.float()) for g in grads]))
        opt.step()
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": grad_norm, **aux}

    def _forward_backward(self, model, batch, rng):
        accum = self.grad_accum
        if accum == 1:
            loss, aux = self.loss_fn(batch, rng)
            loss.backward()
            return loss.detach(), aux
        micro = {k: torch.as_tensor(v).reshape(
            (accum, v.shape[0] // accum) + tuple(v.shape[1:]))
            for k, v in batch.items()}
        stats = batch_stats(model)
        old = [b.clone() for b in stats]
        new = [torch.zeros_like(b) for b in stats]
        loss, aux = 0.0, {}
        for i in range(accum):
            r = None if rng is None else prng.fold_in(rng, i)
            l, a = self.loss_fn({k: v[i] for k, v in micro.items()}, r)
            (l / accum).backward()
            loss = loss + l.detach() / accum
            for k, v in a.items():
                aux[k] = aux.get(k, 0.0) + v.detach() / accum
            with torch.no_grad():
                for b, o, n in zip(stats, old, new):
                    n.add_(b)
                    b.copy_(o)
        with torch.no_grad():
            for b, n in zip(stats, new):
                b.copy_(n / accum)
        return loss, aux

    def _reduce(self, grads, loss, aux):
        """The dp all-reduce of the replicated gradients (FSDP reduced
        the sharded ones in the backward), the global gradient norm, and
        the metrics' mean over the data ranks."""
        import torch.distributed as dist

        sharded = [g for g in grads if _is_dtensor(g)]
        plain = [g for g in grads if not _is_dtensor(g)]
        all_reduce_grads(plain, self.mesh)
        sq = torch.zeros((), dtype=torch.float32, device=self.mesh.device)
        for g in sharded:
            sq = sq + g.to_local().float().square().sum()
        if sharded:
            # Each fsdp rank holds its shard; replicas over dp agree.
            dist.all_reduce(sq, group=self.mesh.group("fsdp"))
        for g in plain:
            sq = sq + g.float().square().sum()
        keys = list(aux)
        vals = torch.stack([loss.float()] +
                           [torch.as_tensor(aux[k]).float() for k in keys])
        vals = data_all_reduce_mean(vals, self.mesh)
        return torch.sqrt(sq), vals[0], dict(zip(keys, vals[1:]))


def make_train_step(loss_fn: Callable, optimizer: Callable, mesh=None,
                    spec: Optional[MeshSpec] = None,
                    **kwargs) -> TrainStep:
    """``mesh`` as :class:`TrainStep` takes it, or built from ``spec``."""
    if mesh is None and spec is not None:
        mesh = build_mesh(spec)
    return TrainStep(loss_fn, optimizer, mesh, **kwargs)
