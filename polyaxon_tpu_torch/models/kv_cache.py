"""Decode-time KV cache.

Port of ``polyaxon_tpu/models/kv_cache.py``'s :func:`append_kv_cache`
and its paged helpers (plain storage; int8 KV, RoPE rotation and the
ring cache come with later slices).  Flax keeps the cache in a mutable
variable collection; here it is an explicit object, :class:`KVCache`,
holding every layer's keys and values and the shared write index.

SLOT-INDEXED decode (the serving engine's pool, ``serving/slots.py``):
a cache whose ``positions`` is a [B] long tensor on the device holds B
independent requests, row b at its own absolute position
``positions[b]`` — the port's counterpart of the reference stepping
per-slot ``cache_index`` variables under ``jax.vmap``.  Every read of
the position is a tensor operation, so the step runs inside a CUDA
graph with the positions read from a device buffer at replay time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class LayerCache:
    """One layer's view of a :class:`KVCache`: ``k``/``v`` [B, cap, H, D]
    (views into the stacked tensors, so writes land in the cache) and
    the number of positions already filled."""
    k: torch.Tensor
    v: torch.Tensor
    index: int
    positions: Optional[torch.Tensor] = None


@dataclass
class KVCache:
    """``k``/``v``: [layers, B, cap, H, D]; ``index``: positions filled.

    The index advances once per model forward (every layer appends the
    same chunk), not once per layer.  ``positions`` ([B] long, on the
    cache's device) makes it a SLOT cache: row b appends its one token
    at ``positions[b]``, and ``index`` is neither read nor advanced —
    the owner (the slot pool) advances the positions."""
    k: torch.Tensor
    v: torch.Tensor
    index: int = 0
    positions: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.k.shape[2]

    def layer(self, i: int) -> LayerCache:
        return LayerCache(self.k[i], self.v[i], self.index, self.positions)


def append_kv_cache(cache: LayerCache, k, v, window: Optional[int] = None):
    """Append this step's k/v ([B, S, H, D]) at positions
    ``[index, index + S)`` of ``cache``.

    Works for single-token steps and chunked prefill: new token i sits
    at absolute position ``index + i``, so the returned mask
    ([1, 1, S, cap]) admits key j iff ``j <= index + i``, clipped to
    ``window`` when given.  The write is IN PLACE into the cache's
    tensors (the JAX version returns an updated copy); stale entries
    past the index are masked by absolute position, never trusted.

    CAPACITY contract: the cache's own width wins — the mask spans
    ``cap`` keys whatever the model's ``max_position``.

    Returns ``(k_full, v_full, mask, positions)``; the caller advances
    the index.  A slot cache (``cache.positions`` set) takes the
    per-row path, :func:`append_kv_slots`.
    """
    if cache.positions is not None:
        return append_kv_slots(cache, k, v, window)
    b, s, h, d = k.shape
    idx = cache.index
    cap = cache.k.shape[1]
    if idx + s > cap:
        # jax.lax.dynamic_update_slice would clamp the write silently.
        raise ValueError(f"KV cache overflow: positions [{idx}, {idx + s})"
                         f" do not fit its {cap} slots")
    cache.k[:, idx:idx + s] = k
    cache.v[:, idx:idx + s] = v
    pos_q = idx + torch.arange(s, device=k.device)
    keys = torch.arange(cap, device=k.device)
    valid = keys[None, :] <= pos_q[:, None]  # [S, cap]
    if window is not None:
        valid &= keys[None, :] >= pos_q[:, None] - window
    return cache.k, cache.v, valid[None, None], pos_q


def append_kv_slots(cache: LayerCache, k, v, window: Optional[int] = None):
    """Slot-indexed append: row b's one new token ([B, 1, H, D]) is
    written at ``cache.positions[b]`` — a per-row scatter, no host
    read of any position — and the returned mask ([B, 1, 1, cap])
    admits key j for row b iff ``j <= positions[b]`` (clipped to
    ``window`` when given).  Positions past ``cap`` are the caller's
    to prevent (the engine validates every request's budget and parks
    idle rows at 0); checking here would need a host sync."""
    b, s, h, d = k.shape
    if s != 1:
        raise ValueError(f"slot-indexed decode appends one token per row;"
                         f" got {s}")
    cap = cache.k.shape[1]
    pos = cache.positions
    index = pos.view(b, 1, 1).expand(b, 1, h * d)
    cache.k.view(b, cap, h * d).scatter_(1, index, k.reshape(b, 1, h * d))
    cache.v.view(b, cap, h * d).scatter_(1, index, v.reshape(b, 1, h * d))
    keys = torch.arange(cap, device=k.device)
    valid = keys[None, :] <= pos[:, None]  # [B, cap]
    if window is not None:
        valid &= keys[None, :] >= pos[:, None] - window
    return cache.k, cache.v, valid[:, None, None, :], pos[:, None]


# -- paged storage (serving/paged.py) ---------------------------------------
#
# A paged pool stores a cache tensor's position axis as fixed-size
# pages: ``lead + (n_pages, page_tokens) + rest``.  A slot's page table
# gathers its pages into a position-contiguous view, so the decode step
# sees an ordinary (narrower) slot cache.


def paged_pool_shape(leaf_shape, pos_axis: int, n_pages: int,
                     page_tokens: int):
    """Pool shape for a cache tensor: the position axis splits into
    ``(n_pages, page_tokens)``."""
    return (tuple(leaf_shape[:pos_axis]) + (n_pages, page_tokens)
            + tuple(leaf_shape[pos_axis + 1:]))


def gather_pages(pool_leaf, table, pos_axis: int, out=None):
    """The position-contiguous view of the pages ``table`` names: a
    table [P] gives position width ``P * page_tokens`` at ``pos_axis``;
    a table [S, P] gives S such rows there (a slot cache).  ``out``, if
    given, is a contiguous buffer of ``lead + (S * P, page_tokens) +
    rest`` elements that receives the pages (a fixed address for a
    CUDA graph)."""
    flat = table.reshape(-1)
    pages = torch.index_select(pool_leaf, pos_axis, flat, out=out)
    shape = pool_leaf.shape
    pt = shape[pos_axis + 1]
    return pages.view(tuple(shape[:pos_axis]) + tuple(table.shape[:-1])
                      + (table.shape[-1] * pt,)
                      + tuple(shape[pos_axis + 2:]))


def scatter_pages(pool_leaf, pages, targets, pos_axis: int) -> None:
    """Write ``pages`` (``lead + (n, page_tokens) + rest``) into the
    pool at page ids ``targets`` [n], in place.  Callers keep the
    targets of live content distinct; duplicate targets are only ever
    scratch pages, whose content is masked by absolute position."""
    pool_leaf.index_copy_(pos_axis, targets, pages.to(pool_leaf.dtype))
