"""Decode-time KV cache.

Port of ``polyaxon_tpu/models/kv_cache.py``: :func:`append_kv_cache`
(the O(max_position) cache, with the RoPE models' ``rotate`` of the new
keys before the write, and int8 storage), :func:`append_ring_kv_cache`
(the O(window) ring of sliding-window models, whose sessions stream past
``max_position``) and the paged helpers.  Flax keeps the cache in a
mutable variable collection; here it is an explicit object,
:class:`KVCache`, holding every layer's keys and values
([layers, B, cap, kv_heads, D]: a grouped-query model stores its
``num_kv_heads``) and the shared write index.  The cache's own layout
picks the discipline: int8 storage when it holds ``k_scale``/``v_scale``
(``[layers, B, cap, kv_heads, 1]`` bf16, one per token and head), the
ring when it holds ``ring_pos`` (the absolute position each ring slot
holds, -1 when unwritten; ``generate.init_cache`` builds both from the
config).

SLOT-INDEXED decode (the serving engine's pool, ``serving/slots.py``):
a cache whose ``positions`` is a [B] long tensor on the device holds B
independent requests, row b at its own absolute position
``positions[b]`` (a chunk of S tokens at ``positions[b] + [0, S)``) — the port's counterpart of the reference stepping
per-slot ``cache_index`` variables under ``jax.vmap``.  Every read of
the position is a tensor operation, so the step runs inside a CUDA
graph with the positions read from a device buffer at replay time.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import torch

from ..ops.quant import symmetric_int8


def kv_cache_dims(cfg) -> tuple:
    """(KV heads, head width) of a decoder config's cache: a
    grouped-query config's own ``num_kv_heads`` and ``head_dim``; GPT-2
    (full multi-head attention, whose config has neither field, as the
    reference's) caches every head, ``hidden_size // num_heads`` wide."""
    heads = getattr(cfg, "num_kv_heads", None) or cfg.num_heads
    dim = getattr(cfg, "head_dim", None) or cfg.hidden_size // cfg.num_heads
    return heads, dim


def quantize_chunk(x: torch.Tensor):
    """Per-(token, head) symmetric int8 over the feature axis:
    [B, S, H, D] -> (int8 [B, S, H, D], bf16 scale [B, S, H, 1])."""
    return symmetric_int8(x, dims=(-1,))


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype):
    """int8 cache entries back to ``dtype``: the product is taken in
    ``dtype`` (the reference's ``q.astype(k.dtype) *
    scale.astype(k.dtype)``); unwritten entries hold scale 0."""
    return q.to(dtype) * scale.to(dtype)


@dataclass
class LayerCache:
    """One layer's view of a :class:`KVCache`: ``k``/``v`` [B, cap, H, D]
    (views into the stacked tensors, so writes land in the cache), the
    number of positions already filled, and the int8 scales and ring
    table when the cache has them (the ring table is every layer's)."""
    k: torch.Tensor
    v: torch.Tensor
    index: int
    positions: Optional[torch.Tensor] = None
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    ring_pos: Optional[torch.Tensor] = None


@dataclass
class KVCache:
    """``k``/``v``: [layers, B, cap, H, D]; ``index``: positions filled.

    The index advances once per model forward (every layer appends the
    same chunk), not once per layer.  ``positions`` ([B] long, on the
    cache's device) makes it a SLOT cache: row b appends its chunk at
    ``positions[b]``, and ``index`` is neither read nor advanced —
    the owner (the slot pool) advances the positions.

    ``k_scale``/``v_scale`` ([layers, B, cap, H, 1] bf16) make it an
    int8 cache.  ``ring_pos`` makes it a RING of ``cap`` slots: the
    absolute position each slot holds (-1: never written), [cap] for a
    solo cache (rows and layers append in lockstep) and [B, cap] for a
    slot cache; it advances with the index (:meth:`advance`)."""
    k: torch.Tensor
    v: torch.Tensor
    index: int = 0
    positions: Optional[torch.Tensor] = None
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None
    ring_pos: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def device(self) -> torch.device:
        return self.k.device

    def at_positions(self, positions: torch.Tensor) -> "KVCache":
        """This cache as a SLOT cache at ``positions`` ([B] long): a
        view over the same tensors."""
        return dataclasses.replace(self, positions=positions)

    def stacked(self, n: int, device=None) -> "KVCache":
        """A B=1 cache -> the zeroed ``n``-row pool of the same kind
        (a ring table of -1: no slot written), on ``device`` (default:
        this cache's)."""
        dev = self.device if device is None else device

        def wide(t):
            shape = list(t.shape)
            shape[1] = n
            return torch.zeros(shape, dtype=t.dtype, device=dev)

        ring = self.ring_pos
        return self.with_leaves(
            [wide(t) for t in self.leaves()], index=0,
            ring_pos=None if ring is None else torch.full(
                (n, ring.shape[-1]), -1, dtype=ring.dtype, device=dev))

    def copy_lane(self, slot: int, src: "KVCache") -> None:
        """Copy the B=1 cache ``src`` into row ``slot`` of this pool
        wholesale (every leaf, and a ring's position table)."""
        for dst, t in zip(self.leaves(), src.leaves()):
            dst[:, slot].copy_(t[:, 0])
        if self.ring_pos is not None:
            self.ring_pos[slot].copy_(src.ring_pos)

    def ring_tensors(self) -> List[torch.Tensor]:
        """A ring cache's entries and position table (what a graph
        capture's warm-up must restore); [] for any other cache."""
        if self.ring_pos is None:
            return []
        return self.leaves() + [self.ring_pos]

    def layer(self, i: int) -> LayerCache:
        return LayerCache(
            self.k[i], self.v[i], self.index, self.positions,
            None if self.k_scale is None else self.k_scale[i],
            None if self.v_scale is None else self.v_scale[i],
            self.ring_pos)

    def leaves(self) -> List[torch.Tensor]:
        """The per-position tensors, [layers, B, cap, H, X] each: keys,
        values, and the int8 scales when present.  What a slot pool
        stacks, a page pool pages and a beam reorders."""
        leaves = [self.k, self.v]
        if self.k_scale is not None:
            leaves += [self.k_scale, self.v_scale]
        return leaves

    @staticmethod
    def from_leaves(leaves, **kw) -> "KVCache":
        """The cache whose :meth:`leaves` are ``leaves``."""
        leaves = list(leaves)
        scales = leaves[2:4] if len(leaves) > 2 else [None, None]
        return KVCache(leaves[0], leaves[1], k_scale=scales[0],
                       v_scale=scales[1], **kw)

    def with_leaves(self, leaves, **kw) -> "KVCache":
        """This cache's kind (index, positions, ring table, unless
        ``kw`` replaces them) with ``leaves`` in :meth:`leaves`'
        order."""
        kw = {"index": self.index, "positions": self.positions,
              "ring_pos": self.ring_pos, **kw}
        return KVCache.from_leaves(leaves, **kw)

    def tile_rows(self, k: int) -> "KVCache":
        """Every row repeated ``k`` times, b-major (a beam per copy).
        A ring's position table has no batch axis (beams decode in
        lockstep and share it): it is not tiled."""
        return self.with_leaves([t.repeat_interleave(k, dim=1)
                                 for t in self.leaves()])

    def take_rows(self, rows: torch.Tensor) -> "KVCache":
        """The rows ``rows`` [N] of every leaf (a beam step's
        parents); the ring table stays as it is."""
        return self.with_leaves([t.index_select(1, rows)
                                 for t in self.leaves()])

    def clone(self) -> "KVCache":
        """A copy no later append can reach (the prefix store's)."""
        return self.with_leaves(
            [t.clone() for t in self.leaves()],
            ring_pos=None if self.ring_pos is None
            else self.ring_pos.clone())

    def advance(self, s: int) -> None:
        """After a forward of ``s`` tokens: record the chunk's tail in
        the ring table (every layer wrote it at ``position % cap``) and,
        on a solo cache, advance the index."""
        if self.ring_pos is not None:
            cap = self.ring_pos.shape[-1]
            keep = min(s, cap)
            off = torch.arange(s - keep, s, device=self.ring_pos.device)
            if self.positions is None:
                tail = self.index + off
                self.ring_pos.index_copy_(0, tail % cap, tail)
            else:
                tail = self.positions[:, None] + off          # [B, keep]
                self.ring_pos.scatter_(1, tail % cap, tail)
        if self.positions is None:
            self.index += s


@dataclass
class ShardedLayerCache:
    """One layer's view of a :class:`ShardedKVCache`: one
    :class:`LayerCache` per tensor-parallel shard, in shard order."""
    shards: List[LayerCache]


@dataclass
class ShardedKVCache:
    """A cache split over the devices of a serving mesh (module
    docstring): ``shards[g * tp + r]`` on ``devices[g * tp + r]``.
    ``positions`` ([B] long, on the first shard's device) makes it a
    SLOT cache; each shard then holds its own group's rows of it on its
    own device.  The index, the ring tables and every in-place write
    live in the shards, which are ordinary :class:`KVCache` objects."""
    shards: List[KVCache]
    tp: int
    devices: List[torch.device]
    positions: Optional[torch.Tensor] = None

    @property
    def dp(self) -> int:
        return len(self.shards) // self.tp

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def rows(self) -> int:
        """Rows per shard (a slot group's share of the batch)."""
        return self.shards[0].k.shape[1]

    @property
    def index(self) -> int:
        return self.shards[0].index

    @index.setter
    def index(self, value: int) -> None:
        for s in self.shards:
            s.index = value

    def _map(self, fn) -> "ShardedKVCache":
        return ShardedKVCache([fn(s, d) for s, d in
                               zip(self.shards, self.devices)],
                              self.tp, list(self.devices), self.positions)

    def layer(self, i: int) -> ShardedLayerCache:
        if self.dp != 1:
            raise ValueError("layer() of a dp-split cache: step each "
                             "slot group (group(g)) on its own")
        return ShardedLayerCache([s.layer(i) for s in self.shards])

    def group(self, g: int) -> "ShardedKVCache":
        """Slot group ``g``'s tp shards (its rows of ``positions``)."""
        tp, n = self.tp, self.rows
        pos = None if self.positions is None \
            else self.positions[g * n:(g + 1) * n]
        return ShardedKVCache(self.shards[g * tp:(g + 1) * tp], tp,
                              self.devices[g * tp:(g + 1) * tp], pos)

    def at_positions(self, positions: torch.Tensor) -> "ShardedKVCache":
        """Every shard at its group's rows of ``positions``, moved to
        the shard's device (a no-op where it already lies there)."""
        n = self.rows
        shards = [s.at_positions(positions[(i // self.tp) * n:
                                           (i // self.tp + 1) * n].to(d))
                  for i, (s, d) in enumerate(zip(self.shards,
                                                 self.devices))]
        return ShardedKVCache(shards, self.tp, list(self.devices),
                              positions)

    def leaves(self) -> List[torch.Tensor]:
        """Every shard's :meth:`KVCache.leaves`, shard after shard."""
        return [t for s in self.shards for t in s.leaves()]

    def leaf_devices(self) -> List[torch.device]:
        """The device of each of :meth:`leaves`."""
        per = len(self.shards[0].leaves())
        return [d for d in self.devices for _ in range(per)]

    def with_leaves(self, leaves, *, index: Optional[int] = None,
                    positions: Optional[torch.Tensor] = None
                    ) -> "ShardedKVCache":
        """A cache of this one's sharding over ``leaves`` (in
        :meth:`leaves`' order), at ``index`` (default: this one's) or,
        given ``positions``, a slot cache."""
        leaves = list(leaves)
        per = len(leaves) // len(self.shards)
        idx = self.index if index is None else index
        out = ShardedKVCache(
            [KVCache.from_leaves(leaves[i * per:(i + 1) * per], index=idx)
             for i in range(len(self.shards))], self.tp,
            list(self.devices))
        return out if positions is None else out.at_positions(positions)

    def merge_heads(self, leaves: Sequence[torch.Tensor]
                    ) -> List[torch.Tensor]:
        """Leaves in :meth:`leaves`' order (one slot group) -> the
        unsharded cache's leaves: each kind's shards concatenated along
        the heads axis (ndim - 2) on the first shard's device."""
        per = len(leaves) // self.tp
        return [torch.cat([leaves[r * per + j].to(leaves[j].device)
                           for r in range(self.tp)], dim=-2)
                for j in range(per)]

    def split_heads(self, leaves: Sequence[torch.Tensor]
                    ) -> List[torch.Tensor]:
        """The inverse of :meth:`merge_heads`: unsharded leaves -> this
        cache's shard order, each piece on its shard's device."""
        parts = [t.chunk(self.tp, dim=-2) for t in leaves]
        return [parts[j][r].to(self.devices[r]).contiguous()
                for r in range(self.tp) for j in range(len(leaves))]

    def tile_rows(self, k: int) -> "ShardedKVCache":
        return self._map(lambda s, d: s.tile_rows(k))

    def take_rows(self, rows: torch.Tensor) -> "ShardedKVCache":
        return self._map(lambda s, d: s.take_rows(rows.to(d)))

    def clone(self) -> "ShardedKVCache":
        return self._map(lambda s, d: s.clone())

    def advance(self, s: int) -> None:
        for shard in self.shards:
            shard.advance(s)

    def copy_lane(self, slot: int, src: "ShardedKVCache") -> None:
        """Copy the B=1 sharded cache ``src`` (one group) into row
        ``slot`` of this pool: shard ``r`` of ``src`` into shard ``r``
        of the slot's group, device to device."""
        g, lane = divmod(slot, self.rows)
        for r in range(self.tp):
            self.shards[g * self.tp + r].copy_lane(lane, src.shards[r])

    def ring_tensors(self) -> List[torch.Tensor]:
        return [t for s in self.shards for t in s.ring_tensors()]


def append_kv_cache(cache: LayerCache, k, v, window: Optional[int] = None,
                    rotate: Optional[Callable] = None):
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

    ``rotate``: optional ``fn(positions, k) -> k`` applied to the new
    keys BEFORE the write (RoPE models store rotated keys); the
    returned ``positions`` ([S] here, [B, S] on a slot cache) let the
    caller rotate q to match.

    An int8 cache (``cache.k_scale`` set) stores each token and head as
    int8 with a bf16 scale over the feature axis, quantized after the
    rotation, and returns the whole cache dequantized to the keys' type
    (the new chunk included, as stored).

    Returns ``(k_full, v_full, mask, positions)``; the caller advances
    the index.  A slot cache (``cache.positions`` set) takes the
    per-row path, :func:`append_kv_slots`.
    """
    if cache.positions is not None:
        return append_kv_slots(cache, k, v, window, rotate)
    b, s, h, d = k.shape
    idx = cache.index
    cap = cache.k.shape[1]
    if idx + s > cap:
        # jax.lax.dynamic_update_slice would clamp the write silently.
        raise ValueError(f"KV cache overflow: positions [{idx}, {idx + s})"
                         f" do not fit its {cap} slots")
    pos_q = idx + torch.arange(s, device=k.device)
    if rotate is not None:
        k = rotate(pos_q, k)
    if cache.k_scale is not None:
        kq, ks = quantize_chunk(k)
        vq, vs = quantize_chunk(v)
        cache.k[:, idx:idx + s] = kq
        cache.v[:, idx:idx + s] = vq
        cache.k_scale[:, idx:idx + s] = ks
        cache.v_scale[:, idx:idx + s] = vs
        k_full = dequantize(cache.k, cache.k_scale, k.dtype)
        v_full = dequantize(cache.v, cache.v_scale, k.dtype)
    else:
        cache.k[:, idx:idx + s] = k
        cache.v[:, idx:idx + s] = v
        k_full, v_full = cache.k, cache.v
    keys = torch.arange(cap, device=k.device)
    valid = keys[None, :] <= pos_q[:, None]  # [S, cap]
    if window is not None:
        valid &= keys[None, :] >= pos_q[:, None] - window
    return k_full, v_full, valid[None, None], pos_q


def _slot_positions(cache: LayerCache, s: int, device):
    """[B, S] absolute positions of a slot cache's new rows."""
    pos = cache.positions
    return pos[:, None] if s == 1 else \
        pos[:, None] + torch.arange(s, device=device)


def _scatter_rows(dst: torch.Tensor, rows: torch.Tensor,
                  src: torch.Tensor) -> None:
    """Per-row scatter: ``dst`` [B, cap, H, X] gets ``src`` [B, n, H, X]
    at slots ``rows`` [B, n] of each row."""
    b, cap = dst.shape[:2]
    n = rows.shape[1]
    w = dst[0, 0].numel()
    dst.view(b, cap, w).scatter_(
        1, rows[:, :, None].expand(b, n, w), src.reshape(b, n, w))


def append_kv_slots(cache: LayerCache, k, v, window: Optional[int] = None,
                    rotate: Optional[Callable] = None):
    """Slot-indexed append: row b's S new tokens ([B, S, H, D]) sit at
    ``cache.positions[b] + [0, S)``.  They are rotated there (given
    ``rotate``) and written there, a per-row scatter with no host read
    of any position, and the returned mask ([B, 1, S, cap]) admits key
    j to query i of row b iff ``j <= positions[b] + i`` (clipped to
    ``window`` when given).  S = 1 is a decode step; S = K + 1 is a
    speculative round's verify chunk, each row at its own position.
    Positions past ``cap`` are the caller's to prevent (the engine
    validates every request's budget, spec slack included, and parks
    idle rows at 0); checking here would need a host sync.  An int8
    cache scatters the quantized rows and their scales the same way.

    Speculative ROLLBACK is the owner's positions rewind: entries past
    a rewound position stay, masked by absolute position, and the next
    chunk overwrites them before any of its queries can admit them
    (the reference's contract, ``polyaxon_tpu/models/kv_cache.py``)."""
    b, s, h, d = k.shape
    cap = cache.k.shape[1]
    pos_q = _slot_positions(cache, s, k.device)
    if rotate is not None:
        k = rotate(pos_q, k)
    if cache.k_scale is not None:
        kq, ks = quantize_chunk(k)
        vq, vs = quantize_chunk(v)
        for dst, src in ((cache.k, kq), (cache.v, vq),
                         (cache.k_scale, ks), (cache.v_scale, vs)):
            _scatter_rows(dst, pos_q, src)
        k_full = dequantize(cache.k, cache.k_scale, k.dtype)
        v_full = dequantize(cache.v, cache.v_scale, k.dtype)
    else:
        _scatter_rows(cache.k, pos_q, k)
        _scatter_rows(cache.v, pos_q, v)
        k_full, v_full = cache.k, cache.v
    keys = torch.arange(cap, device=k.device)
    valid = keys <= pos_q[:, :, None]  # [B, S, cap]
    if window is not None:
        valid &= keys >= pos_q[:, :, None] - window
    return k_full, v_full, valid[:, None], pos_q


def append_ring_kv_cache(cache: LayerCache, k, v, window: int,
                         rotate: Optional[Callable] = None):
    """Sliding-window decode with an O(window) RING cache, the
    long-context serving path of Mistral-style models.

    The ring holds ``cap = window + 1 + slack`` slots keyed by
    ``position % cap`` (``generate.init_cache`` sizes it; slack is the
    speculative rollback margin), so sessions stream past
    ``max_position``: RoPE needs no table.  Per append: (1) read the old
    ring (its slot order is scrambled; attention is order-agnostic under
    the mask), dequantized on an int8 cache; (2) rotate (and quantize)
    the chunk at its absolute positions; (3) hand attention
    ``concat(old_ring, chunk)``, the chunk itself unquantized, with
    validity from ABSOLUTE positions (``q_pos - window <= k_pos <=
    q_pos``; unwritten slots hold position -1) AND, for ring entries,
    strictly older than the chunk's first position (after a speculative
    rollback the ring still holds rejected entries at positions the
    chunk re-commits); (4) scatter the chunk's last ``min(S, cap)`` rows
    into the ring.  The ring table itself advances after the forward
    (``KVCache.advance``), since every layer reads the old one.

    Returns ``(k_full, v_full, mask, positions)`` like
    :func:`append_kv_cache`, with key axis ``cap + S``: mask [1, 1, S,
    cap + S] on a solo cache, [B, 1, S, cap + S] on a slot cache (each
    row its own positions and ring table)."""
    b, s, h, d = k.shape
    cap = cache.k.shape[1]
    ring = cache.ring_pos
    slots = cache.positions is not None
    if slots:
        pos_q = _slot_positions(cache, s, k.device)            # [B, S]
        first = cache.positions[:, None]
    else:
        pos_q = cache.index + torch.arange(s, device=k.device)  # [S]
        first = cache.index
    if rotate is not None:
        k = rotate(pos_q, k)
    if cache.k_scale is not None:
        kq, ks = quantize_chunk(k)
        vq, vs = quantize_chunk(v)
        k_old = dequantize(cache.k, cache.k_scale, k.dtype)
        v_old = dequantize(cache.v, cache.v_scale, k.dtype)
        writes = ((cache.k, kq), (cache.v, vq), (cache.k_scale, ks),
                  (cache.v_scale, vs))
    else:
        k_old, v_old = cache.k, cache.v
        writes = ((cache.k, k), (cache.v, v))
    k_full = torch.cat([k_old, k], dim=1)
    v_full = torch.cat([v_old, v], dim=1)
    pos_k = torch.cat([ring, pos_q], dim=-1)                # [.., cap+S]
    older = torch.cat([ring < first, torch.ones_like(pos_q, dtype=bool)],
                      dim=-1)
    pk, pq = pos_k[..., None, :], pos_q[..., :, None]
    valid = (pk <= pq) & (pk >= pq - window) & (pk >= 0) \
        & older[..., None, :]                               # [.., S, cap+S]
    keep = min(s, cap)
    tail = pos_q[..., s - keep:] % cap
    for dst, src in writes:
        if slots:
            _scatter_rows(dst, tail, src[:, s - keep:])
        else:
            dst.index_copy_(1, tail, src[:, s - keep:])
    mask = valid[:, None] if slots else valid[None, None]
    return k_full, v_full, mask, pos_q


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
