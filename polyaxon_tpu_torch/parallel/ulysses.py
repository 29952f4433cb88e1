"""Ulysses sequence parallelism: an all-to-all head / sequence reshard.

Port of ``polyaxon_tpu/parallel/ulysses.py``.  Instead of rotating K/V
(the ring), each rank trades its sequence block of every head for the
whole sequence of H/sp heads (one all-to-all before attention, one
after), so the attention in between is the ordinary full-sequence one,
the flash kernel's shape.  Needs heads % sp == 0.

The layout is the ring's (``parallel/ring.py``): the activations are
replicated over sp outside attention; :func:`ulysses_attention` takes the
global q / k / v, gives each rank its S/sp rows (``split_to_region``)
and joins the output (``gather_from_region``).  The all-to-alls are
``collectives.all_to_all`` over the sp group, whose backward is the
inverse all-to-all.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from .collectives import all_to_all, gather_from_region, split_to_region


def _ulysses_shard(q, k, v, mask, *, mesh, axis_name: str, attn_fn):
    """Per-shard body: inputs [B, S/sp, H, D] -> output [B, S/sp, H, D].

    ``mask``: None or boolean [B, H?, Sq, Sk] replicated across the sp
    axis (full sequence dims); when it carries a real head dim, each
    rank slices its own head range after the all-to-all."""

    def seq2head(x):
        # [B, S/sp, H, D] -> [B, S, H/sp, D]: split heads, gather sequence.
        return all_to_all(x, axis_name, split_dim=2, concat_dim=1,
                          mesh=mesh)

    def head2seq(x):
        return all_to_all(x, axis_name, split_dim=1, concat_dim=2,
                          mesh=mesh)

    q_full, k_full, v_full = seq2head(q), seq2head(k), seq2head(v)
    if mask is None:
        # Unmasked: the three-argument attn_fn contract, so a custom
        # kernel (attn_fn=lambda q, k, v: ...) stays valid.
        o_full = attn_fn(q_full, k_full, v_full)
    else:
        mask_local = mask
        if mask.shape[1] > 1:
            h_per = mask.shape[1] // mesh.shape[axis_name]
            mask_local = mask.narrow(1, mesh.coordinate(axis_name) * h_per,
                                     h_per)
        o_full = attn_fn(q_full, k_full, v_full, mask_local)
    return head2seq(o_full)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    mask: Optional[torch.Tensor] = None,
    axis_name: str = "sp",
    causal: bool = True,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    attn_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """Ulysses attention over a mesh axis; q / k / v GLOBAL [B, S, H, D],
    the same on every rank of the axis.  Returns the whole output on
    every rank.

    ``mask``: optional boolean [B, H?, Sq, Sk] (True = attend).  Its
    sequence dims stay full (after the all-to-all each rank sees the
    whole sequence); a real head dim must divide by the sp axis as q's.

    ``attn_fn``: a custom kernel, called ``attn_fn(q, k, v)`` with no
    mask (the original contract) and ``attn_fn(q, k, v, mask)`` with
    one, so a three-argument kernel stays valid for unmasked use."""
    sp = mesh.shape.get(axis_name, 1)
    n_heads = q.shape[2]
    if n_heads % sp:
        raise ValueError(
            f"Ulysses needs heads ({n_heads}) divisible by {axis_name} "
            f"axis size ({sp}); use ring attention otherwise")
    if mask is not None:
        if mask.ndim != 4:
            raise ValueError(
                f"mask must be 4-d [B,H,Sq,Sk]; got {tuple(mask.shape)}")
        if mask.shape[1] > 1 and mask.shape[1] % sp:
            raise ValueError(
                f"mask head dim ({mask.shape[1]}) must divide sp ({sp})")
    if window is not None:
        if not causal:
            raise ValueError("sliding window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1; got {window}")
        if attn_fn is not None:
            raise ValueError(
                "window with a custom attn_fn would be silently "
                "ignored; apply the window inside your kernel instead")
    if attn_fn is None:
        # After the all-to-all each rank holds the FULL sequence for a
        # head subset: the ordinary local attention, the flash kernel's
        # shape where it is eligible.
        from ..ops.attention import _local_attention

        attn_fn = functools.partial(
            _local_attention, causal=causal, window=window,
            scale=q.shape[-1] ** -0.5 if scale is None else scale)
    local = [split_to_region(t, axis_name, dim=1, mesh=mesh)
             for t in (q, k, v)]
    o = _ulysses_shard(*local, mask, mesh=mesh, axis_name=axis_name,
                       attn_fn=attn_fn)
    return gather_from_region(o, axis_name, dim=1, mesh=mesh)
