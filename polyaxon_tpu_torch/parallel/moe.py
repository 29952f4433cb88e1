"""Switch-style (top-1) mixture-of-experts routing.

Port of ``polyaxon_tpu/parallel/moe.py``'s :func:`top1_dispatch`, the
reference's dense one-hot routing tensors, computed as the reference
computes them.  The port's models route by index instead
(``models/moe_gpt.py``); this function is the definition they are held
against.  ``moe_layer`` (experts sharded over a mesh's ``ep`` axis,
tokens exchanged by all-to-all) needs a mesh and is refused by the
ROADMAP item that carries meshes.
"""

from __future__ import annotations

import torch

MESH_REFUSAL = ("expert parallelism in training (moe_layer over a "
                "mesh's 'ep' axis) comes with a later slice of the "
                "port (ROADMAP Queue 1: Parallelism and meshes, item "
                "(b2))")


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


def top1_dispatch(logits: torch.Tensor, capacity: int):
    """Dispatch and combine tensors for top-1 routing with a capacity.

    logits: [T, E] router scores.  Returns (dispatch [T, E, C] float32
    of 0/1, combine [T, E, C] float32 = dispatch * gate, aux scalar).
    A token past its expert's ``capacity`` gets an all-zero row."""
    probs, expert, gate, pos = route_top1(logits)
    e = probs.shape[-1]
    keep = pos < capacity
    gate = gate * keep
    onehot = _onehot(expert, e).float()
    pos_onehot = _onehot(pos, capacity).float()   # 0 past capacity
    dispatch = onehot[:, :, None] * pos_onehot[:, None, :]
    combine = dispatch * gate[:, None, None]
    return dispatch, combine, load_balance_loss(probs, expert)


def moe_layer(*args, **kwargs):
    """The reference's expert-parallel layer needs a mesh: refused."""
    raise NotImplementedError(MESH_REFUSAL)
