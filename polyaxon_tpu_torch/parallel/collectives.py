"""Collective helpers over mesh axes.

Port of ``polyaxon_tpu/parallel/collectives.py``.  There each helper is
an XLA collective over named mesh axes inside ``shard_map``; here each
runs ``torch.distributed`` over the process group of one or more axes
of a :class:`~.mesh.Mesh` (``mesh.group(axis)``).  ``mesh`` defaults to
the ambient mesh the train step publishes (``constraints.ambient_mesh``);
with no mesh, or over axes of size 1, each helper is the identity (a sum
over one device), so model and loss code stays strategy-agnostic.

Every helper is differentiable, as the reference's ``psum`` is under
``grad``: the backward of an all-reduce is the all-reduce of the
cotangent, of a reduce-scatter the all-gather, of an all-gather the
reduce-scatter, of an all-to-all the inverse all-to-all and of a ring
permute the opposite shift.  So a loss that reduces over the data axes
(the MLM mask count, the batch norms' statistics) backpropagates its
global gradient, and the gradient all-reduce of the train step (a mean
over the data ranks) yields the gradient of the global loss.

The hierarchical multi-slice all-reduce (reduce-scatter inside the
slice, all-reduce across slices, all-gather inside) equals the flat
all-reduce.

Those backwards are right for the data axes, whose ranks hold
different rows.  They are wrong inside a tensor or expert region, whose
ranks hold the SAME activations downstream: there a sum's backward that
all-reduces would scale every gradient upstream of it by the axis size.
The four Megatron region operators carry their own backward instead
(the reference gets the same transposes from GSPMD):

- :func:`copy_to_region`: identity forward, all-reduce backward (the
  input of a column-parallel layer);
- :func:`reduce_from_region`: all-reduce forward, identity backward
  (the output of a row-parallel layer);
- :func:`split_to_region`: this rank's block forward, all-gather
  backward;
- :func:`gather_from_region`: all-gather forward, this rank's block
  backward.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

AxisName = Union[str, Sequence[str]]


def _mesh(mesh):
    if mesh is not None:
        return mesh
    from .constraints import current_mesh

    return current_mesh()


def _axis_groups(axis: AxisName, mesh) -> List[Tuple[object, int]]:
    """(group, size) of each named axis of size > 1."""
    mesh = _mesh(mesh)
    if mesh is None or not mesh.is_distributed:
        return []
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    return [(mesh.group(a), mesh.shape[a]) for a in names
            if mesh.shape.get(a, 1) > 1]


def _one_group(axis: str, mesh):
    if not isinstance(axis, str):
        raise TypeError(f"one mesh axis expected, got {axis!r}")
    groups = _axis_groups(axis, mesh)
    return groups[0] if groups else (None, 1)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _gather(x, group, n, dim):
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def _scatter(x, group, n, dim):
    """This rank's block of the sum of ``x`` over the group: NCCL's
    reduce-scatter (each rank receives 1/n of the sum), or on gloo,
    which has none, the all-reduce's block."""
    import torch.distributed as dist

    if dist.get_backend(group) == "nccl":
        full = x.movedim(dim, 0).contiguous()
        out = full.new_empty((full.shape[0] // n,) + tuple(full.shape[1:]))
        dist.reduce_scatter_tensor(out, full, group=group)
        return out.movedim(0, dim).contiguous()
    total = x.clone()
    dist.all_reduce(total, group=group)
    return total.chunk(n, dim)[dist.get_rank(group)].contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.group, ctx.n, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        if x.shape[dim] % n:
            raise ValueError(f"reduce_scatter: dim {dim} of size "
                             f"{x.shape[dim]} does not divide by {n}")
        return _scatter(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.n, ctx.dim), None, None, None


def _all_to_all(x, group, n, split_dim, concat_dim):
    """Block ``i`` of ``x`` along ``split_dim`` to rank ``i``; the
    blocks received concatenated along ``concat_dim`` in rank order (one
    ``all_to_all_single`` over the blocks stacked: gloo takes it over a
    card's tensors too)."""
    import torch.distributed as dist

    # The stacked blocks of a strided cotangent can keep its layout; the
    # collective takes contiguous tensors only.
    ins = torch.stack(x.chunk(n, split_dim)).contiguous()
    outs = torch.empty_like(ins)
    dist.all_to_all_single(outs, ins, group=group)
    return torch.cat(outs.unbind(0), concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_dim, concat_dim):
        if x.shape[split_dim] % n:
            raise ValueError(f"all_to_all: dim {split_dim} of size "
                             f"{x.shape[split_dim]} does not divide by {n}")
        ctx.args = (group, n, split_dim, concat_dim)
        return _all_to_all(x, group, n, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, n, split_dim, concat_dim = ctx.args
        return (_all_to_all(g, group, n, concat_dim, split_dim),
                None, None, None, None)


def _permute(x, group, n, shift):
    """Send ``x`` to the rank ``shift`` ahead on the group's ring and
    receive the one ``shift`` behind: one ``all_to_all_single`` whose
    only non-empty blocks are the one sent and the one received (gloo's
    point-to-point ops take CPU tensors only; its all-to-all, as NCCL's,
    takes a card's tensors too)."""
    import torch.distributed as dist

    me = dist.get_rank(group)
    dst, src = (me + shift) % n, (me - shift) % n
    size = x.numel()
    out = torch.empty_like(x)
    dist.all_to_all_single(
        out.view(-1), x.contiguous().view(-1),
        output_split_sizes=[size if j == src else 0 for j in range(n)],
        input_split_sizes=[size if j == dst else 0 for j in range(n)],
        group=group)
    return out


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, shift):
        ctx.args = (group, n, shift)
        return _permute(x, group, n, shift)

    @staticmethod
    def backward(ctx, g):
        group, n, shift = ctx.args
        return _permute(g, group, n, -shift), None, None, None


def _block(x, group, n, dim):
    """This rank's block of ``n`` equal blocks of ``x`` along ``dim``."""
    import torch.distributed as dist

    if x.shape[dim] % n:
        raise ValueError(f"split: dim {dim} of size {x.shape[dim]} does "
                         f"not divide by {n}")
    return x.chunk(n, dim)[dist.get_rank(group)].contiguous()


class _CopyToRegion(_AllReduce):
    """The all-reduce's backward behind an identity."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)


class _ReduceFromRegion(_AllReduce):
    """The all-reduce's forward before an identity backward."""

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SplitToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.args = (group, n, dim)
        return _block(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None, None


class _GatherFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.args = (group, n, dim)
        return _gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(g, *ctx.args), None, None, None


def copy_to_region(x: torch.Tensor, axis: str, *, mesh=None
                   ) -> torch.Tensor:
    """Enter a tensor region: ``x`` as it is, its cotangent summed over
    ``axis`` (each rank's partial gradient of a replicated input)."""
    group, n = _one_group(axis, mesh)
    return x if n == 1 else _CopyToRegion.apply(x, group)


def reduce_from_region(x: torch.Tensor, axis: str, *, mesh=None
                       ) -> torch.Tensor:
    """Leave a tensor region: the sum of the ranks' partial ``x`` over
    ``axis``, its cotangent passed through (it is the same on every
    rank)."""
    group, n = _one_group(axis, mesh)
    return x if n == 1 else _ReduceFromRegion.apply(x, group)


def split_to_region(x: torch.Tensor, axis: str, *, dim: int, mesh=None
                    ) -> torch.Tensor:
    """This rank's block of a replicated ``x`` along ``dim``; the
    cotangent gathered back to the whole tensor."""
    group, n = _one_group(axis, mesh)
    return x if n == 1 else _SplitToRegion.apply(x, group, n, dim)


def gather_from_region(x: torch.Tensor, axis: str, *, dim: int,
                       mesh=None) -> torch.Tensor:
    """The ranks' blocks of ``x`` concatenated along ``dim``; the
    cotangent's block of this rank passed back."""
    group, n = _one_group(axis, mesh)
    return x if n == 1 else _GatherFromRegion.apply(x, group, n, dim)


def all_reduce(x: torch.Tensor, axis: AxisName, *, mesh=None
               ) -> torch.Tensor:
    """Sum over one or more mesh axes."""
    for group, _ in _axis_groups(axis, mesh):
        x = _AllReduce.apply(x, group)
    return x


def all_reduce_mean(x: torch.Tensor, axis: AxisName, *, mesh=None
                    ) -> torch.Tensor:
    groups = _axis_groups(axis, mesh)
    n = 1
    for group, size in groups:
        x = _AllReduce.apply(x, group)
        n *= size
    return x / n if n > 1 else x


def reduce_scatter(x: torch.Tensor, axis: str, *, scatter_dim: int = 0,
                   mesh=None) -> torch.Tensor:
    group, n = _one_group(axis, mesh)
    return x if n == 1 else _ReduceScatter.apply(x, group, n, scatter_dim)


def all_gather(x: torch.Tensor, axis: str, *, gather_dim: int = 0,
               mesh=None) -> torch.Tensor:
    group, n = _one_group(axis, mesh)
    return x if n == 1 else _AllGather.apply(x, group, n, gather_dim)


def all_to_all(x: torch.Tensor, axis: str, *, split_dim: int,
               concat_dim: int, mesh=None) -> torch.Tensor:
    group, n = _one_group(axis, mesh)
    if n == 1:
        return x
    return _AllToAll.apply(x, group, n, split_dim, concat_dim)


def ring_permute(x: torch.Tensor, axis: str, *, shift: int = 1,
                 mesh=None) -> torch.Tensor:
    """Rotate shards around an axis: rank i's block goes to rank
    i + shift (one all-to-all over the group: :func:`_permute`)."""
    group, n = _one_group(axis, mesh)
    if n == 1 or shift % n == 0:
        return x
    return _RingPermute.apply(x, group, n, shift)


def hierarchical_all_reduce(
    x: torch.Tensor,
    ici_axis: str = "fsdp",
    dcn_axis: str = "dp",
    *,
    scatter_dim: int = 0,
    mesh=None,
) -> torch.Tensor:
    """Bandwidth-optimal multi-slice all-reduce:

    1. reduce-scatter over the in-slice axis (each rank ends with 1/n of
       the sum)
    2. all-reduce the shard over the cross-slice axis
    3. all-gather back over the in-slice axis.

    Equivalent to the all-reduce over both axes."""
    shard = reduce_scatter(x, ici_axis, scatter_dim=scatter_dim, mesh=mesh)
    shard = all_reduce(shard, dcn_axis, mesh=mesh)
    return all_gather(shard, ici_axis, gather_dim=scatter_dim, mesh=mesh)


def data_all_reduce(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Sum over the data axes (dp x fsdp) of the (ambient) mesh: the
    global value of a per-rank sum over its rows of the batch."""
    return all_reduce(x, ("dp", "fsdp"), mesh=mesh)


def data_all_reduce_mean(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Mean over the data axes: the global value of a mean over equal
    shards of the batch."""
    return all_reduce_mean(x, ("dp", "fsdp"), mesh=mesh)


def data_shard(mesh=None):
    """(this rank's block, number of blocks) of the global batch over
    the data axes of the (ambient) mesh; (0, 1) with none."""
    mesh = _mesh(mesh)
    if mesh is None:
        return 0, 1
    from .mesh import data_sharding

    sh = data_sharding(mesh)
    return sh.index, sh.count
