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

- **tp / ep**: the parameters the reference's :data:`TP_RULES` place on
  a tensor or expert axis (:func:`make_tensor_placements`, on the
  reference's parameter paths, ``convert.reference_paths``) are split
  there: each rank keeps its shard of rank 0's weights as a plain
  parameter (:func:`shard_tensors`): column- and row-parallel dense
  layers and vocab-parallel tables (``models/layers.py``), the experts'
  ``[E / ep, ...]`` blocks (``parallel/moe.py::moe_layer``).  The layers
  enter and leave the region through the Megatron operators of
  ``collectives.py``, so a parameter replicated over tp gets the same
  gradient on every tp rank and is not summed; a router, replicated
  over ep but fed a different 1/ep of the tokens on each ep rank, has
  its gradient summed over ep.  ``grad_norm`` sums a sharded
  parameter's squares over its axis and counts a replicated one once.

Losses and batch norms reduce over the data axes themselves where the
reference's are global sums (the MLM mask count, batch statistics); the
ambient mesh (``constraints.ambient_mesh``) tells them the axes.  The
metrics are their mean over the data ranks, and ``grad_norm`` the global
norm of the reduced gradients.  A mesh built over a process group takes
this path even with one rank, so a one-rank NCCL group runs the wrap a
gang runs; a mesh with no group, or none, is the one-device path (tp
and ep sizes above 1 need a gang).

- **sp**: the activations stay replicated over sp, as in the
  reference; only attention splits the sequence, through ring or
  Ulysses attention (``ops/attention.py``'s sequence-parallel route,
  which ``train.py`` activates).  Every sp rank holds the same rows and,
  after the backward, the same gradients, so sp adds no gradient
  reduction.

A pipeline axis above 1, fsdp together with tp or ep, and sp together
with fsdp or ep are refused by the ROADMAP items that carry them;
``precompile`` (AOT compilation) has no eager counterpart.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from .. import prng
from ..models.layers import batch_stats
from .collectives import data_all_reduce_mean
from .constraints import ambient_mesh
from .mesh import MeshError, MeshSpec, build_mesh, data_sharding

PARALLELISM_REFUSAL = (
    "pipeline parallelism in training comes with a later slice of the "
    "port (ROADMAP Queue 1: Parallelism and meshes, item (d))")
# fsdp placed jointly with a tensor or expert axis.
FSDP_TENSOR_REFUSAL = (
    "fsdp together with tp or ep comes with a later slice of the port "
    "(ROADMAP Queue 1: Parallelism and meshes, item (b3) fsdp with "
    "tp / ep)")
# A sequence axis beside an fsdp or an expert axis.
SP_FSDP_REFUSAL = (
    "sequence parallelism together with fsdp comes with a later slice "
    "of the port (ROADMAP Queue 1: Parallelism and meshes, item (c2) sp "
    "with fsdp)")
SP_EP_REFUSAL = (
    "sequence parallelism together with ep comes with a later slice of "
    "the port (ROADMAP Queue 1: Parallelism and meshes, item (c3) sp "
    "with ep)")

# Flat gradient buckets of the dp all-reduce.
BUCKET_BYTES = 25 * 2 ** 20

# The reference's rules: (regex over the flax param path, spec over the
# leaf's TRAILING dims).  First match wins.  A spec entry is None, an
# axis name, or a tuple of names placed jointly on one dim.
TP_RULES: List[Tuple[str, tuple]] = [
    # Row-parallel (input dim sharded) first: the more specific names.
    (r"(o_proj|out_proj|attention_out|proj_out)[^/]*/kernel",
     ("tp", None)),
    (r"(fc2|wo|down_proj|output_dense|mlp_out)[^/]*/kernel", ("tp", None)),
    # Column-parallel (output dim sharded).
    (r"(q_proj|k_proj|v_proj|qkv|query|key|value)[^/]*/kernel",
     (None, "tp")),
    (r"(fc1|wi|up_proj|gate_proj|intermediate)[^/]*/kernel", (None, "tp")),
    # Untied LM head (kernel [hidden, vocab]): vocab is the output axis.
    (r"lm_head[^/]*/kernel", (None, ("tp", "fsdp"))),
    # Embedding tables [vocab, hidden]: the vocab dim.
    (r"(embed|embedding|wte)[^/]*/embedding", (("tp", "fsdp"), None)),
    # Expert-parallel params [E, in, out]: the expert dim over ep.
    (r"experts_w[12]$", ("ep", None, None)),
]

def check_mesh(mesh) -> None:
    """Refuse a mesh whose pp axis is above 1, whose fsdp axis is above
    1 beside a tp or ep axis above 1, or whose sp axis is above 1 beside
    an fsdp or ep axis above 1."""
    if mesh.shape.get("pp", 1) > 1:
        raise NotImplementedError(
            f"mesh {{'pp': {mesh.shape['pp']}}}: {PARALLELISM_REFUSAL}")
    sp = mesh.shape.get("sp", 1)
    for axis, refusal in (("fsdp", SP_FSDP_REFUSAL), ("ep", SP_EP_REFUSAL)):
        if sp > 1 and mesh.shape.get(axis, 1) > 1:
            raise NotImplementedError(
                f"mesh {{'sp': {sp}, '{axis}': {mesh.shape[axis]}}}: "
                f"{refusal}")
    tensor = {a: mesh.shape[a] for a in ("tp", "ep")
              if mesh.shape.get(a, 1) > 1}
    if tensor and mesh.shape.get("fsdp", 1) > 1:
        raise NotImplementedError(
            f"mesh {dict(tensor, fsdp=mesh.shape['fsdp'])}: "
            f"{FSDP_TENSOR_REFUSAL}")


def check_model_axes(cfg, mesh) -> None:
    """The model's divisibility against the mesh's tensor and expert
    axes, before any weight is built: its heads (and KV heads) against
    tp, its experts against ep (the reference's ``moe_layer`` text)."""
    tp, ep = mesh.shape.get("tp", 1), mesh.shape.get("ep", 1)
    heads = getattr(cfg, "num_heads", None)
    if tp > 1 and heads is not None:
        for label in ("num_heads", "num_kv_heads"):
            n = getattr(cfg, label, None)
            if n is not None and n % tp:
                raise MeshError(
                    f"the model's head count ({label}={n}) is not "
                    f"divisible by mesh tp={tp}; pick a tp that divides "
                    f"it")
    experts = getattr(cfg, "num_experts", None)
    if ep > 1 and experts is not None and experts % ep:
        raise MeshError(
            f"num experts {experts} must be divisible by ep axis size "
            f"{ep}")


def infer_param_spec(path: str, shape, *, tp: bool = False,
                     ep: bool = False) -> tuple:
    """The tensor- and expert-axis branch of the reference's
    ``infer_param_spec``: the spec (one entry a dim) that the first
    :data:`TP_RULES` match gives the flax leaf at ``path``
    (``"h_3/attn/qkv/kernel"``) of ``shape``, in the flax layout,
    right-aligned on the leaf's trailing dims.  Its fsdp branch is
    :func:`param_placement`'s; its pp branch comes with item (d)."""
    shape = tuple(int(d) for d in shape)
    if tp or ep:
        for pattern, cand in TP_RULES:
            if re.search(pattern, path):
                cand = list(cand)
                if len(cand) <= len(shape):
                    return tuple([None] * (len(shape) - len(cand)) + cand)
                return tuple(cand[len(cand) - len(shape):])
    return (None,) * len(shape)


def _drop_indivisible(spec: tuple, shape, sizes: Dict[str, int]) -> tuple:
    """The reference's ``make_param_shardings`` fix-up: a dim's axes
    shrink from the right until their product divides it."""
    out = []
    for dim, entry in zip(shape, spec):
        names = entry if isinstance(entry, tuple) else \
            ((entry,) if entry else ())
        while names and dim % math.prod(sizes.get(n, 1)
                                        for n in names) != 0:
            names = names[:-1]
        out.append(names if len(names) > 1
                   else (names[0] if names else None))
    return tuple(out)


# Port dim of each flax dim: a Dense kernel [in, out] is the port's
# weight [out, in]; a convolution's HWIO kernel the port's OIHW.
_PORT_DIMS = {"dense": (1, 0), "conv": (2, 3, 1, 0)}


def make_tensor_placements(model: torch.nn.Module, mesh
                           ) -> Dict[str, Optional[Tuple[str, int]]]:
    """name -> (axis, port dim) for every parameter of ``model`` that
    the reference places on a tensor or expert axis above 1 of
    ``mesh``, else None: :data:`TP_RULES` on the reference's path of
    each parameter (``convert.reference_paths``), the divisibility drop
    of ``make_param_shardings``, and the flax-to-port transposition.
    A spec entry placing ``("tp", "fsdp")`` jointly lands on tp (fsdp is
    1 beside tp: item (b3))."""
    from ..convert import reference_paths

    sizes = dict(mesh.shape)
    active = {a for a in ("tp", "ep") if sizes.get(a, 1) > 1}
    out: Dict[str, Optional[Tuple[str, int]]] = {}
    paths = reference_paths(model) if active else {}
    for name, p in model.named_parameters():
        out[name] = None
        if not active:
            continue
        path, kind = paths[name]
        perm = _PORT_DIMS.get(kind, tuple(range(p.dim())))
        if len(perm) != p.dim():
            perm = tuple(range(p.dim()))
        flax_shape = tuple(p.shape[perm[i]] for i in range(p.dim()))
        spec = _drop_indivisible(
            infer_param_spec(path, flax_shape, tp="tp" in active,
                             ep="ep" in active), flax_shape, sizes)
        for i, entry in enumerate(spec):
            names = entry if isinstance(entry, tuple) else (entry,)
            axis = next((a for a in names if a in active), None)
            if axis is not None:
                out[name] = (axis, perm[i])
                break
    return out


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
    (the counterpart of ``make_param_shardings``): with a tp or ep axis
    above 1, the dim :func:`make_tensor_placements` places there;
    otherwise the fsdp dim: a dim that does not divide by the fsdp size
    stays replicated, as the reference drops an axis that does not
    divide.  The fsdp axis is on when the mesh's spec asks for it (a
    size above 1, or -1 filled)."""
    if any(mesh.shape.get(a, 1) > 1 for a in ("tp", "ep")):
        return {name: None if pl is None else pl[1] for name, pl in
                make_tensor_placements(model, mesh).items()}
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


def _set_module(model: torch.nn.Module, name: str,
                module: torch.nn.Module) -> None:
    parent, _, attr = name.rpartition(".")
    setattr(model.get_submodule(parent) if parent else model, attr, module)


def shard_tensors(model: torch.nn.Module, mesh,
                  placements: Dict[str, Optional[Tuple[str, int]]]
                  ) -> Dict[str, Tuple[str, int]]:
    """Keep this rank's shard of every parameter ``placements`` puts on a
    tensor or expert axis, in place, and return name -> (axis, dim) of
    every parameter the model now holds a shard of.

    A dense weight split by rows (the reference's column-parallel
    kernel) becomes a :class:`~..models.layers.ColumnParallelDense`
    with its bias split alike; a fused ``qkv`` is split BY HEADS
    (``gpt2.qkv_rows_by_heads``: each rank's q, k and v columns of its
    own heads, so attention runs on local heads).  Split by columns it
    becomes a :class:`~..models.layers.RowParallelDense`; a table split
    by rows a :class:`~..models.layers.VocabParallelEmbedding`; another
    parameter (the experts) keeps its block of ``dim`` and its module
    records it in ``sharded_params``, with ``tensor_mesh`` set.  A model
    that declares ``TP_REGIONS`` keeps a column layer's output split
    for the row layer after it (the Megatron pairing of its blocks; an
    untied ``lm_head`` still gathers its logits); any other model
    gathers each column output and splits each row input."""
    from ..models.gpt2 import qkv_rows_by_heads
    from ..models.layers import (ColumnParallelDense, Dense,
                                 RowParallelDense, VocabParallelEmbedding,
                                 contiguous_rows)

    regions = getattr(model, "TP_REGIONS", False)
    for mod_name, module in list(model.named_modules()):
        prefix = f"{mod_name}." if mod_name else ""
        attr = mod_name.rpartition(".")[2]
        pl = placements.get(f"{prefix}weight")
        if isinstance(module, Dense) and pl is not None:
            axis, dim = pl
            n = mesh.shape[axis]
            if dim == 0:
                rows = qkv_rows_by_heads(module.in_features, n) \
                    if attr == "qkv" else \
                    contiguous_rows(module.out_features, n)
                new = ColumnParallelDense(
                    module, rows, mesh, axis,
                    gather_output=not regions or attr == "lm_head")
            else:
                new = RowParallelDense(module, mesh, axis,
                                       split_input=not regions)
            _set_module(model, mod_name, new)
        elif isinstance(module, torch.nn.Embedding) and pl is not None:
            _set_module(model, mod_name, VocabParallelEmbedding(
                module, mesh, pl[0]))
        else:
            for pname, p in list(module.named_parameters(recurse=False)):
                pl = placements.get(f"{prefix}{pname}")
                if pl is None:
                    continue
                axis, dim = pl
                block = p.detach().chunk(mesh.shape[axis], dim)[
                    mesh.coordinate(axis)].clone()
                setattr(module, pname, torch.nn.Parameter(block))
                module.sharded_params = dict(
                    getattr(module, "sharded_params", {}),
                    **{pname: (axis, dim)})
                module.tensor_mesh = mesh
    return tensor_shards(model)


def tensor_shards(model: torch.nn.Module) -> Dict[str, Tuple[str, int]]:
    """name -> (axis, dim) of every parameter ``model`` holds a tensor-
    or expert-axis shard of (after :func:`shard_tensors`)."""
    return {f"{mod_name}.{attr}" if mod_name else attr: spec
            for mod_name, module in model.named_modules()
            for attr, spec in getattr(module, "sharded_params",
                                      {}).items()}


def _shard_of(model: torch.nn.Module, name: str):
    """(module, axis, dim, mesh, every rank's rows or None) of the shard
    parameter ``name`` is."""
    mod_name, _, attr = name.rpartition(".")
    module = model.get_submodule(mod_name) if mod_name else model
    axis, dim = module.sharded_params[attr]
    return (module, axis, dim, module.tensor_mesh,
            getattr(module, "all_rows", None))


def gather_shard(model: torch.nn.Module, name: str,
                 local: torch.Tensor) -> torch.Tensor:
    """Collective over the parameter's axis: the whole tensor of which
    ``local`` is this rank's shard of parameter ``name`` (the parameter
    itself, or optimizer state shaped like it), in the one-process
    layout (a by-heads ``qkv`` put back in order)."""
    import torch.distributed as dist

    _, axis, dim, mesh, rows = _shard_of(model, name)
    parts = [torch.empty_like(local) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, local.contiguous(), group=mesh.group(axis))
    full = torch.cat(parts, dim)
    if rows is None:
        return full
    out = torch.empty_like(full)
    return out.index_copy_(dim, torch.cat(rows).to(full.device), full)


def local_shard(model: torch.nn.Module, name: str,
                full: torch.Tensor) -> torch.Tensor:
    """This rank's shard of the whole tensor ``full`` of parameter
    ``name`` (the inverse of :func:`gather_shard`)."""
    _, axis, dim, mesh, rows = _shard_of(model, name)
    rank = mesh.coordinate(axis)
    if rows is not None:
        return full.index_select(dim, rows[rank].to(full.device))
    return full.chunk(mesh.shape[axis], dim)[rank].contiguous()


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
        # name -> (axis, dim) of the tp / ep shards this rank holds.
        self.shards: Dict[str, Tuple[str, int]] = {}
        self._summed: Dict[int, str] = {}
        self._axis_of: Dict[int, str] = {}

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
        if any(self.mesh.shape[a] > 1 for a in ("tp", "ep")):
            self._distribute_tensors(model)
            return
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

    def _distribute_tensors(self, model: torch.nn.Module) -> None:
        """tp / ep: the model's divisibility checked, each rank's shards
        kept (:func:`shard_tensors`), and the gradients to sum over ep
        noted: a module's ``EP_SUMMED`` parameters (the router) beside
        its expert shards."""
        check_model_axes(getattr(model, "cfg", None), self.mesh)
        self.shards = shard_tensors(model, self.mesh,
                                    make_tensor_placements(model,
                                                           self.mesh))
        params = dict(model.named_parameters())
        self._axis_of = {id(params[n]): axis
                         for n, (axis, _) in self.shards.items()}
        self._summed = {
            id(getattr(m, name)): "ep" for m in model.modules()
            if getattr(m, "tensor_mesh", None) is not None
            for name in getattr(m, "EP_SUMMED", ())}

    def __call__(self, state: Dict[str, Any], batch, rng=None):
        model, opt = state["params"], state["opt_state"]
        opt.zero_grad(set_to_none=True)
        with ambient_mesh(self.mesh):
            loss, aux = self._forward_backward(model, batch, rng)
        params = [p for group in opt.param_groups
                  for p in group["params"] if p.grad is not None]
        grads = [p.grad for p in params]
        if self.distributed:
            grad_norm, loss, aux = self._reduce(params, loss, aux)
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

    def _reduce(self, params, loss, aux):
        """The dp all-reduce of the replicated gradients (FSDP reduced
        the sharded ones in the backward), the ep sum of the routers',
        the global gradient norm, and the metrics' mean over the data
        ranks."""
        import torch.distributed as dist

        grads = [p.grad for p in params]
        sharded = [g for g in grads if _is_dtensor(g)]
        plain = [g for g in grads if not _is_dtensor(g)]
        all_reduce_grads(plain, self.mesh)
        for p in params:
            if id(p) in self._summed:
                dist.all_reduce(p.grad,
                                group=self.mesh.group(self._summed[id(p)]))
        zero = torch.zeros((), dtype=torch.float32, device=self.mesh.device)
        sq = zero
        for g in sharded:
            sq = sq + g.to_local().float().square().sum()
        if sharded:
            # Each fsdp rank holds its shard; replicas over dp agree.
            dist.all_reduce(sq, group=self.mesh.group("fsdp"))
        # A tp / ep shard's squares sum over its axis; a parameter
        # replicated there counts once.
        by_axis: Dict[str, torch.Tensor] = {}
        for p in params:
            if _is_dtensor(p.grad):
                continue
            term = p.grad.float().square().sum()
            axis = self._axis_of.get(id(p))
            if axis is None:
                sq = sq + term
            else:
                by_axis[axis] = by_axis.get(axis, zero) + term
        for axis, part in by_axis.items():
            dist.all_reduce(part, group=self.mesh.group(axis))
            sq = sq + part
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
