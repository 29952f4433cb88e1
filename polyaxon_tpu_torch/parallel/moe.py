"""Switch-style (top-1) mixture-of-experts routing, and expert
parallelism over a gang.

Port of ``polyaxon_tpu/parallel/moe.py``: :func:`top1_dispatch`, the
reference's dense one-hot routing tensors, computed as the reference
computes them (the port's one-device models route by index instead,
``models/moe_gpt.py``, and are held against it), and :func:`moe_layer`,
the expert-parallel layer: each ``ep`` rank routes its 1/ep of the
sequence with the capacity of its own tokens, the experts' buckets
cross the ``ep`` group by all-to-all there and back, and ``aux`` is the
mean of the ranks' load-balance terms.  Without a mesh, or with ``ep``
of 1, it is the dense layer of one device.
"""

from __future__ import annotations

import torch

def route_top1(logits: torch.Tensor):
    """The routing every switch path shares, from router logits [T, E]:
    (probs [T, E] float32, expert [T] (the first maximum, as
    ``jnp.argmax``), gate [T] = the expert's probability, position of
    each token in its expert's queue [T], counted over the tokens in
    order)."""
    probs = torch.softmax(logits.float(), dim=-1)
    expert = torch.argmax(probs, dim=-1)
    gate = probs.gather(1, expert[:, None])[:, 0]
    onehot = _onehot(expert, probs.shape[-1]).to(torch.int64)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    return probs, expert, gate, pos


def _onehot(index: torch.Tensor, n: int) -> torch.Tensor:
    """[T] -> [T, n] bool, by comparison (no host read of the values:
    the decode step runs inside a CUDA graph)."""
    return index[:, None] == torch.arange(n, device=index.device)


def load_balance_loss(probs: torch.Tensor,
                      expert: torch.Tensor) -> torch.Tensor:
    """The switch load-balancing loss ``E * sum_e(fraction_e *
    mean_prob_e)``, its gradient through ``probs`` only.  Over a
    data-parallel mesh both means are the global batch's (means over
    equal shards, averaged over the data axes), as the reference's are."""
    from .collectives import data_all_reduce_mean

    e = probs.shape[-1]
    fraction = _onehot(expert, e).float().mean(0)
    return e * torch.sum(data_all_reduce_mean(fraction)
                         * data_all_reduce_mean(probs.mean(0)))


def _dispatch(logits: torch.Tensor, capacity: int):
    """(dispatch, combine, probs, expert) of top-1 routing: the
    reference's float32 one-hot tensors [T, E, C]."""
    probs, expert, gate, pos = route_top1(logits)
    e = probs.shape[-1]
    keep = pos < capacity
    gate = gate * keep
    onehot = _onehot(expert, e).float()
    pos_onehot = _onehot(pos, capacity).float()   # 0 past capacity
    dispatch = onehot[:, :, None] * pos_onehot[:, None, :]
    combine = dispatch * gate[:, None, None]
    return dispatch, combine, probs, expert


def top1_dispatch(logits: torch.Tensor, capacity: int):
    """Dispatch and combine tensors for top-1 routing with a capacity.

    logits: [T, E] router scores.  Returns (dispatch [T, E, C] float32
    of 0/1, combine [T, E, C] float32 = dispatch * gate, aux scalar).
    A token past its expert's ``capacity`` gets an all-zero row."""
    dispatch, combine, probs, expert = _dispatch(logits, capacity)
    return dispatch, combine, load_balance_loss(probs, expert)


def moe_layer(x: torch.Tensor, router_w: torch.Tensor,
              expert_w1: torch.Tensor, expert_w2: torch.Tensor, mesh, *,
              axis_name: str = "ep", capacity_factor: float = 1.25,
              activation=None, batch_axes=("dp", "fsdp")):
    """Expert-parallel switch MoE layer (the reference's ``moe_layer``).

    ``x``: this rank's rows ``[B, S, D]`` of the batch, the whole
    sequence (every ``ep`` rank of a data group holds the same rows);
    ``router_w`` ``[D, E]`` replicated; ``expert_w1`` ``[E / ep, D, F]``
    and ``expert_w2`` ``[E / ep, F, D]``: this rank's experts (all of
    them with no mesh or ``ep`` of 1).  Returns ``([B, S, D]`` in
    ``x``'s dtype, aux).

    Each ``ep`` rank takes its 1/ep of the sequence
    (``split_to_region``: the cotangent is gathered back), routes its
    ``T`` tokens with capacity ``max(1, int(capacity_factor * T / E))``
    through the reference's float32 one-hot dispatch, sends each
    expert's bucket to the rank that holds the expert and back
    (``collectives.all_to_all``), combines, and gathers the sequence
    (``gather_from_region``).  ``aux`` is the mean of the ranks' own
    load-balance terms over ``ep`` and the data axes: over ``ep`` with
    an identity backward (``reduce_from_region``), since each rank's
    loss holds the same mean, over the data axes as the data losses
    are.  The router's gradient is then this rank's share and sums over
    ``ep`` (the train step does)."""
    from .collectives import (all_reduce_mean, all_to_all,
                              gather_from_region, reduce_from_region,
                              split_to_region)
    from .mesh import active_batch_axes

    act = activation or (lambda t: torch.nn.functional.gelu(
        t, approximate="tanh"))
    b, s, d = x.shape
    e = router_w.shape[-1]
    ep = 1 if mesh is None or not getattr(mesh, "is_distributed", False) \
        else mesh.shape.get(axis_name, 1)
    if e % ep:
        raise ValueError(
            f"num experts {e} must be divisible by ep axis size {ep}")
    if s % ep:
        raise ValueError(
            f"sequence length {s} must be divisible by ep axis size {ep}")
    el = expert_w1.shape[0]
    if el * ep != e:
        raise ValueError(f"this rank holds {el} experts; {e} over ep "
                         f"{ep} is {e // ep}")
    xl = split_to_region(x, axis_name, dim=1, mesh=mesh)
    t = xl.shape[0] * xl.shape[1]
    flat = xl.reshape(t, d).float()
    capacity = max(1, int(capacity_factor * t / e))
    dispatch, combine, probs, expert = _dispatch(
        flat @ router_w.float(), capacity)
    expert_in = torch.einsum("tec,td->ecd", dispatch, flat)
    # Each rank keeps its own experts' buckets from every rank: after
    # the exchange the leading blocks index the SOURCE rank.
    expert_in = all_to_all(expert_in, axis_name, split_dim=0,
                           concat_dim=0, mesh=mesh)
    xin = expert_in.reshape(ep, el, capacity, d).transpose(0, 1) \
        .reshape(el, ep * capacity, d)
    h = torch.bmm(act(torch.bmm(xin, expert_w1.float())),
                  expert_w2.float())
    h = h.reshape(el, ep, capacity, d).transpose(0, 1) \
        .reshape(e, capacity, d)
    h = all_to_all(h, axis_name, split_dim=0, concat_dim=0, mesh=mesh)
    out = torch.einsum("tec,ecd->td", combine, h)
    fraction = _onehot(expert, e).float().mean(0)
    aux = e * torch.sum(fraction * probs.mean(0))
    aux = reduce_from_region(aux, axis_name, mesh=mesh) / ep
    batch = active_batch_axes(mesh, batch_axes) if ep > 1 else None
    if batch:
        aux = all_reduce_mean(aux, batch, mesh=mesh)
    out = out.reshape(xl.shape).to(x.dtype)
    return gather_from_region(out, axis_name, dim=1, mesh=mesh), aux
