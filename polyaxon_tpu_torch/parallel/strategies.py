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
  when it divides by the fsdp size: :func:`make_placements`) and their
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

- **composed**: fsdp beside tp or ep shards each parameter on both
  axes as the reference's one spec does (:func:`make_placements`): its
  tensor dim first (:func:`shard_tensors`), then FSDP2 over the fsdp
  axis on the local shard's fsdp dim (the reference's largest
  still-unsharded dim; a joint ``("tp", "fsdp")`` vocab dim splits the
  tp rank's rows).  sp beside fsdp or ep runs each sp coordinate's own
  fsdp and ep groups: the sp ranks hold equal rows and gradients.

- **pp**: the reference's pp rule (:func:`make_stage_placements`) puts
  a stacked block leaf's layer axis over pp: block i lives on pp rank
  ``i // (num_layers / pp)``.  Each rank keeps only its stage's blocks
  (:func:`keep_stage_blocks`; the others become :class:`RemoteBlock`
  stand-ins without parameters, so the optimizer holds only their
  state) and the embedding, the final norm and the head whole; tp
  shards and the fsdp wrap then apply to what it keeps.  The pipelined
  losses (``pipeline.py``) leave each pp rank its share of a parameter
  replicated over pp, which the step sums over pp; a block's squares
  sum over pp in ``grad_norm``.  pp composes with dp, fsdp and tp; sp
  or ep beside it is refused with the reference's message
  (:func:`pipeline_refusal`).

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

def pipeline_refusal(sizes: Dict[str, int]) -> Optional[str]:
    """Why a mesh of axis ``sizes`` cannot train, or None: the
    reference's message for a pp axis above 1 beside an sp or ep axis
    above 1 (its pipeline composes with the batch axes and tp only)."""
    if int(sizes.get("pp", 1)) <= 1:
        return None
    for axis in ("sp", "ep"):
        if int(sizes.get(axis, 1)) > 1:
            return (f"strategy combines pp>1 with {axis}>1, which is not "
                    f"supported: pipeline stages compose with dp/fsdp "
                    f"(batch) and tp (tensor) axes only")
    return None


def check_mesh(mesh) -> None:
    """Refuse a mesh :func:`pipeline_refusal` refuses."""
    refusal = pipeline_refusal(mesh.shape)
    if refusal is not None:
        raise NotImplementedError(
            f"mesh {{'pp': {mesh.shape['pp']}}}: {refusal}")


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


def _names(entry) -> tuple:
    return entry if isinstance(entry, tuple) else ((entry,) if entry else ())


# A scanned block stack's path ("h/block/...", "layers/layer/..."): with
# pipeline parallelism its leaves' layer axis goes over pp.
_STACK_RE = re.compile(r"(^|/)(h|layers)/")
# The port's unrolled name of a stacked block ("h_3/", "layer_3/").
_UNROLLED_RE = re.compile(r"(^|/)(h|layer)_\d+/")


def _stacked_path(path: str) -> str:
    """The reference's path of a scanned block's leaf: ``h_3/qkv/kernel``
    -> ``h/qkv/kernel``, ``layer_3/...`` -> ``layers/...``."""
    return _UNROLLED_RE.sub(
        lambda m: m.group(1) + ("h" if m.group(2) == "h" else "layers") +
        "/", path)


def infer_param_spec(path: str, shape, *, tp: bool = False,
                     ep: bool = False, fsdp: bool = False,
                     pp: bool = False,
                     fsdp_min_size: int = 2 ** 16) -> tuple:
    """The reference's ``infer_param_spec``: the spec (one entry a dim)
    of the flax leaf at ``path`` (``"h/block/attn/qkv/kernel"``) of
    ``shape``, in the flax layout (a scanned block's leaf with its layer
    axis first).  The first :data:`TP_RULES` match, right-aligned on the
    leaf's trailing dims; with ``pp``, a leaf of a scanned stack
    (``h/`` or ``layers/``, two dims or more) puts pp on its layer axis
    when no rule took it; then, unless a rule placed fsdp, a leaf of at
    least ``fsdp_min_size`` elements puts fsdp on its largest
    still-unsharded dim, the trailing two (the matmul dims) first."""
    shape = tuple(int(d) for d in shape)
    spec = [None] * len(shape)
    if tp or ep:
        for pattern, cand in TP_RULES:
            if re.search(pattern, path):
                cand = list(cand)
                spec = [None] * (len(shape) - len(cand)) + cand \
                    if len(cand) <= len(shape) \
                    else cand[len(cand) - len(shape):]
                break
    if pp and len(shape) >= 2 and spec[0] is None and \
            _STACK_RE.search(path):
        spec[0] = "pp"
    if fsdp and not any("fsdp" in _names(e) for e in spec) and \
            math.prod(shape or (1,)) >= fsdp_min_size:
        n = len(shape)
        matmul = list(range(max(0, n - 2), n))
        lead = [i for i in range(n) if i not in matmul]
        for i in sorted(matmul, key=lambda i: -shape[i]) + \
                sorted(lead, key=lambda i: -shape[i]):
            if spec[i] is None:
                spec[i] = "fsdp"
                break
    return tuple(spec)


def _drop_indivisible(spec: tuple, shape, sizes: Dict[str, int]) -> tuple:
    """The reference's ``make_param_shardings`` fix-up: a dim's axes
    shrink from the right until their product divides it."""
    out = []
    for dim, entry in zip(shape, spec):
        names = _names(entry)
        while names and dim % math.prod(sizes.get(n, 1)
                                        for n in names) != 0:
            names = names[:-1]
        out.append(names if len(names) > 1
                   else (names[0] if names else None))
    return tuple(out)


# Port dim of each flax dim: a Dense kernel [in, out] is the port's
# weight [out, in]; a convolution's HWIO kernel the port's OIHW.
_PORT_DIMS = {"dense": (1, 0), "conv": (2, 3, 1, 0)}

Placement = Tuple[Optional[Tuple[str, int]], Optional[int]]


def make_placements(model: torch.nn.Module, mesh, *,
                    fsdp_min_size: int = 2 ** 16) -> Dict[str, Placement]:
    """name -> (tensor placement, fsdp dim) of every parameter of
    ``model``: the reference's one spec of its leaf
    (:func:`infer_param_spec` on ``convert.reference_paths``'s path and
    the flax shape, stacked over the layers where the reference scans
    them, then ``make_param_shardings``' divisibility drop), carried to
    the port's dims.  The tensor placement is (axis, port dim) of the tp
    or ep axis above 1 that holds a dim, else None; the fsdp dim is the
    port dim fsdp holds, alone or after tp on a joint ``("tp", "fsdp")``
    dim, else None.  fsdp on a stacked leaf's layer axis stays
    replicated: the port shards each block's parameter and has no layer
    axis.  The fsdp axis is on when the mesh's spec asks for it (a size
    above 1, or -1 filled: a one-rank group runs the wrap a gang runs);
    a dim that does not divide by its size stays replicated."""
    from ..convert import reference_paths

    sizes = dict(mesh.shape)
    active = {a for a in ("tp", "ep", "fsdp") if sizes.get(a, 1) > 1}
    mesh_spec = getattr(mesh, "spec", None)
    if mesh_spec is not None and mesh_spec.fsdp == -1:
        active.add("fsdp")
    if not active:
        return {name: (None, None) for name, _ in model.named_parameters()}
    paths = reference_paths(model)
    pp = sizes.get("pp", 1) > 1
    stacks = _stack_sizes(model) if "fsdp" in active else {}
    out: Dict[str, Placement] = {}
    for name, p in model.named_parameters():
        path, kind = paths[name]
        perm = _PORT_DIMS.get(kind, tuple(range(p.dim())))
        if len(perm) != p.dim():
            perm = tuple(range(p.dim()))
        layers = next((n for prefix, n in stacks.items()
                       if name.startswith(prefix)), 1)
        lead = (layers,) if layers > 1 else ()
        full = lead + tuple(p.shape[perm[i]] for i in range(p.dim()))
        spec = _drop_indivisible(infer_param_spec(
            _stacked_path(path) if lead else path, full,
            tp="tp" in active, ep="ep" in active, fsdp="fsdp" in active,
            pp=pp, fsdp_min_size=fsdp_min_size), full, sizes)
        tensor = fsdp = None
        for i, entry in enumerate(spec[len(lead):]):
            names = [a for a in _names(entry) if a in active]
            if tensor is None and names and names[0] != "fsdp":
                tensor = (names[0], perm[i])
            if "fsdp" in names:
                fsdp = perm[i]
        out[name] = (tensor, fsdp)
    return out


def make_tensor_placements(model: torch.nn.Module, mesh
                           ) -> Dict[str, Optional[Tuple[str, int]]]:
    """name -> (axis, port dim) for every parameter of ``model`` that
    the reference places on a tensor or expert axis above 1 of
    ``mesh``, else None (:func:`make_placements`' tensor half)."""
    if not any(mesh.shape.get(a, 1) > 1 for a in ("tp", "ep")):
        return {name: None for name, _ in model.named_parameters()}
    return {name: tensor for name, (tensor, _) in
            make_placements(model, mesh).items()}


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


def make_stage_placements(model: torch.nn.Module, mesh
                          ) -> Dict[str, Optional[int]]:
    """name -> the pp rank holding each parameter of ``model``, None for
    one replicated over pp: the reference's pp rule
    (:func:`infer_param_spec` with ``pp`` on the stacked leaf of a block
    of a scanned stack) puts the stack's layer axis over pp, so block i
    lives on pp rank ``i // (num_layers / pp)``.  Every parameter is None
    with pp at 1 or a stack whose depth pp does not divide."""
    from ..convert import reference_paths

    pp = mesh.shape.get("pp", 1)
    if pp <= 1:
        return {name: None for name, _ in model.named_parameters()}
    paths = reference_paths(model)
    stacks = _stack_sizes(model)
    out: Dict[str, Optional[int]] = {}
    for name, p in model.named_parameters():
        prefix = next((pre for pre in stacks if name.startswith(pre)), None)
        owner = None
        if prefix is not None:
            layers = stacks[prefix]
            full = (layers,) + tuple(p.shape)
            spec = _drop_indivisible(infer_param_spec(
                _stacked_path(paths[name][0]), full, pp=True), full,
                {"pp": pp})
            if spec[0] == "pp":
                block = int(prefix[:-1].rpartition(".")[2])
                owner = block // (layers // pp)
        out[name] = owner
    return out


class RemoteBlock(torch.nn.Module):
    """The stand-in for block ``index`` of a layer list on a pp rank
    that does not hold it (:func:`keep_stage_blocks`): no parameters."""

    def __init__(self, index: int, owner: int):
        super().__init__()
        self.index, self.owner = index, owner

    def forward(self, *args, **kwargs):
        raise RuntimeError(
            f"block {self.index} lives on pp rank {self.owner}: a model "
            f"split over pp runs through a pipelined loss "
            f"(parallel/pipeline.py)")


class PipelineLayout:
    """What a pp rank of a model split over pp knows of the whole model:
    the one-process state dict's entries in order (name, shape, dtype),
    the trainable parameters' names in a one-process optimizer's order,
    and the pp rank holding each stage entry (``owner``).  A collective
    checkpoint gathers the blocks from their owners through it."""

    def __init__(self, model: torch.nn.Module, mesh,
                 owner: Dict[str, int]):
        self.mesh = mesh
        self.entries = [(n, tuple(t.shape), t.dtype)
                        for n, t in model.state_dict().items()]
        self.params = [n for n, p in model.named_parameters()
                       if p.requires_grad]
        self.owner = owner
        self._like = {n: (shape, dtype) for n, shape, dtype in self.entries}

    def from_owner(self, name: str,
                   full: Optional[torch.Tensor]) -> torch.Tensor:
        """Collective over the pp group: stage entry ``name``'s whole
        tensor (or a tensor shaped like it), ``full`` on its owner
        (None on the other pp ranks), broadcast to every pp rank."""
        import torch.distributed as dist

        group = self.mesh.group("pp")
        if full is None:
            shape, dtype = self._like[name]
            full = torch.empty(shape, dtype=dtype, device=self.mesh.device)
        full = full.contiguous()
        dist.broadcast(full, src=dist.get_global_rank(
            group, self.owner[name]), group=group)
        return full


def keep_stage_blocks(model: torch.nn.Module, mesh
                      ) -> Optional[PipelineLayout]:
    """Keep this pp rank's stage blocks (:func:`make_stage_placements`)
    in place: every other block of the layer lists becomes a
    :class:`RemoteBlock`.  Sets and returns ``model.pipeline_layout``
    (None, and nothing changed, when no parameter goes over pp)."""
    stages = make_stage_placements(model, mesh)
    if all(owner is None for owner in stages.values()):
        return None
    owner: Dict[str, int] = {}
    for prefix in _stack_sizes(model):
        owners = {stages[n] for n in stages if n.startswith(prefix)}
        if len(owners) == 1 and None not in owners:
            owner.update({n: next(iter(owners))
                          for n in model.state_dict()
                          if n.startswith(prefix)})
    layout = PipelineLayout(model, mesh, owner)
    me = mesh.coordinate("pp")
    for name, lst in list(model.named_modules()):
        if isinstance(lst, torch.nn.ModuleList):
            for i in range(len(lst)):
                prefix = f"{name}.{i}."
                held = {owner[n] for n in owner if n.startswith(prefix)}
                if held and held != {me}:
                    lst[i] = RemoteBlock(i, held.pop())
    model.pipeline_layout = layout
    return layout


def make_param_placements(model: torch.nn.Module, mesh, *,
                          fsdp_min_size: int = 2 ** 16
                          ) -> Dict[str, Optional[int]]:
    """name -> sharded dim or None for every parameter of ``model``
    (the counterpart of ``make_param_shardings``): with a tp or ep axis
    above 1, the dim placed there (an fsdp axis beside it:
    :func:`make_placements`' second half); otherwise the fsdp dim."""
    both = make_placements(model, mesh, fsdp_min_size=fsdp_min_size)
    if any(mesh.shape.get(a, 1) > 1 for a in ("tp", "ep")):
        return {name: None if tensor is None else tensor[1]
                for name, (tensor, _) in both.items()}
    return {name: fsdp for name, (_, fsdp) in both.items()}


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


def _is_shard(model: torch.nn.Module, name: str) -> bool:
    mod_name, _, attr = name.rpartition(".")
    module = model.get_submodule(mod_name) if mod_name else model
    return attr in getattr(module, "sharded_params", {})


def gather_full(model: torch.nn.Module, name: str,
                local: Optional[torch.Tensor]) -> torch.Tensor:
    """Collective: the whole tensor of which ``local`` is this rank's
    block, ``name`` being the parameter (or buffer) it is or is shaped
    like: a DTensor's blocks gathered over the axes that shard it
    (fsdp), then a tensor or expert shard's over its axis
    (:func:`gather_shard`).  Plain ``all_gather`` on the mesh's groups,
    which every backend takes for a card's tensors.  A stage block's
    entry of a model split over pp is gathered on its owner's pp
    coordinate, then broadcast over pp (``local`` is None on the pp
    ranks that do not hold it)."""
    layout = getattr(model, "pipeline_layout", None)
    if layout is not None and name in layout.owner:
        return layout.from_owner(name, None if local is None
                                 else _gather_rank(model, name, local))
    return _gather_rank(model, name, local)


def _gather_rank(model: torch.nn.Module, name: str,
                 local: torch.Tensor) -> torch.Tensor:
    """:func:`gather_full` over the fsdp and tensor axes of this rank's
    pp coordinate."""
    import torch.distributed as dist

    if _is_dtensor(local):
        mesh, placements = local.device_mesh, local.placements
        local = local.to_local()
        for i, pl in enumerate(placements):
            if pl.is_shard():
                group = mesh.get_group(i)
                parts = [torch.empty_like(local)
                         for _ in range(dist.get_world_size(group))]
                dist.all_gather(parts, local.contiguous(), group=group)
                local = torch.cat(parts, pl.dim)
    return gather_shard(model, name, local) if _is_shard(model, name) \
        else local


def local_full(model: torch.nn.Module, name: str, like: torch.Tensor,
               full: torch.Tensor) -> torch.Tensor:
    """This rank's block of the whole tensor ``full`` (the inverse of
    :func:`gather_full`), ``like`` being the live tensor it goes to: a
    plain tensor, the DTensor's local block."""
    if _is_shard(model, name):
        full = local_shard(model, name, full)
    if _is_dtensor(like):
        mesh = like.device_mesh
        for i, pl in enumerate(like.placements):
            if pl.is_shard():
                full = full.chunk(mesh.size(i), pl.dim)[
                    mesh.get_local_rank(i)]
    return full.contiguous()


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


def local_block(t: torch.Tensor) -> torch.Tensor:
    """This rank's block of a DTensor (the tensor itself otherwise)."""
    return t.to_local() if _is_dtensor(t) else t


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
        # id of a parameter -> the axis its gradient sums over (a
        # router's ep) / the tensor axis it is a shard of.
        self._summed: Dict[int, str] = {}
        self._axis_of: Dict[int, str] = {}
        # ids of the stage blocks' parameters this pp rank holds.
        self._staged: set = set()

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
        places one host tree), each rank's tp / ep shards, then the fsdp
        wrap over what the fsdp axis shards."""
        import torch.distributed as dist

        with torch.no_grad():
            for t in list(model.parameters()) + list(model.buffers()):
                dist.broadcast(t.data, src=0)
        layout = keep_stage_blocks(model, self.mesh)
        both = make_placements(model, self.mesh,
                               fsdp_min_size=self.fsdp_min_size)
        tensor = any(self.mesh.shape[a] > 1 for a in ("tp", "ep"))
        self.placements = {
            name: (None if t is None else t[1]) if tensor else dim
            for name, (t, dim) in both.items()}
        if tensor:
            self._distribute_tensors(model, {
                name: t for name, (t, _) in both.items()})
        # On the local shard: a column layer's bias, which the reference
        # leaves whole over tp, is split with its rows.
        local = dict(model.named_parameters())
        sharded = {name: dim for name, (_, dim) in both.items()
                   if dim is not None and local[name].shape[dim] %
                   self.mesh.shape["fsdp"] == 0}
        if sharded:
            self._fully_shard(model, sharded)
        # By name: the wrap registers new (DTensor) parameters.
        params = dict(model.named_parameters())
        self._axis_of = {id(params[n]): axis
                         for n, (axis, _) in self.shards.items()}
        self._summed = {
            id(getattr(m, name)): "ep" for m in model.modules()
            if getattr(m, "tensor_mesh", None) is not None
            for name in getattr(m, "EP_SUMMED", ())}
        self._staged = set() if layout is None else {
            id(p) for n, p in params.items() if n in layout.owner}

    def _fully_shard(self, model: torch.nn.Module,
                     sharded: Dict[str, int]) -> None:
        """FSDP2 over the fsdp axis (HSDP over dp and fsdp when dp is
        above 1) on each block of the layer lists, then the model (a
        tied table stays in the root unit), each parameter of
        ``sharded`` on its dim; the others are left to the dp
        all-reduce."""
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
            if not isinstance(block, RemoteBlock):
                fully_shard(block, mesh=dm, shard_placement_fn=placement,
                            ignored_params=ignored)
        fully_shard(model, mesh=dm, shard_placement_fn=placement,
                    ignored_params=ignored)
        if getattr(model, "pipeline_layout", None) is not None:
            from torch.distributed.fsdp import register_fsdp_forward_method

            # The pipelined losses call these, not the model's forward.
            for method in ("embed_tokens", "head"):
                register_fsdp_forward_method(model, method)

    def _distribute_tensors(self, model: torch.nn.Module,
                            placements: Dict[str, Optional[Tuple[str, int]]]
                            ) -> None:
        """tp / ep: the model's divisibility checked and each rank's
        shards kept (:func:`shard_tensors`)."""
        check_model_axes(getattr(model, "cfg", None), self.mesh)
        self.shards = shard_tensors(model, self.mesh, placements)

    def __call__(self, state: Dict[str, Any], batch, rng=None):
        model, opt = state["params"], state["opt_state"]
        opt.zero_grad(set_to_none=True)
        with ambient_mesh(self.mesh):
            loss, aux = self._forward_backward(model, batch, rng)
        if self._staged:
            # A pp rank that ran neither the embedding's nor the head's
            # backward holds a zero share of their gradients.
            for group in opt.param_groups:
                for p in group["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
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
        """The dp all-reduce of the gradients FSDP does not reduce, the
        ep sum of the routers', the pp sum of the shares of a parameter
        replicated over pp, the global gradient norm, and the metrics'
        mean over the data ranks."""
        import torch.distributed as dist

        plain = [p.grad for p in params if not _is_dtensor(p.grad)]
        all_reduce_grads(plain, self.mesh)
        with torch.no_grad():
            for p in params:
                if id(p) in self._summed:
                    dist.all_reduce(local_block(p.grad),
                                    group=self.mesh.group(self._summed[id(p)]))
                elif self._staged and id(p) not in self._staged:
                    dist.all_reduce(local_block(p.grad),
                                    group=self.mesh.group("pp"))
            # A shard's squares sum over each axis that shards it (fsdp,
            # then its tensor axis, a stage block's over pp); a parameter
            # replicated over an axis counts once there (its replicas
            # agree).
            parts: Dict[tuple, torch.Tensor] = {}
            for p in params:
                key = (_is_dtensor(p.grad), self._axis_of.get(id(p)) or "",
                       id(p) in self._staged)
                term = local_block(p.grad).float().square().sum()
                parts[key] = parts[key] + term if key in parts else term
            sq = torch.zeros((), dtype=torch.float32,
                             device=self.mesh.device)
            for (fsdp, axis, staged), part in sorted(parts.items()):
                if fsdp:
                    dist.all_reduce(part, group=self.mesh.group("fsdp"))
                if axis:
                    dist.all_reduce(part, group=self.mesh.group(axis))
                if staged:
                    dist.all_reduce(part, group=self.mesh.group("pp"))
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
