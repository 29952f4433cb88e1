"""Decode-time KV cache.

Port of ``polyaxon_tpu/models/kv_cache.py``'s :func:`append_kv_cache`
(plain storage; int8 KV, RoPE rotation, the ring cache and the paged
helpers come with later slices).  Flax keeps the cache in a mutable
variable collection; here it is an explicit object, :class:`KVCache`,
holding every layer's keys and values and the shared write index.
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


@dataclass
class KVCache:
    """``k``/``v``: [layers, B, cap, H, D]; ``index``: positions filled.

    The index advances once per model forward (every layer appends the
    same chunk), not once per layer."""
    k: torch.Tensor
    v: torch.Tensor
    index: int = 0

    @property
    def capacity(self) -> int:
        return self.k.shape[2]

    def layer(self, i: int) -> LayerCache:
        return LayerCache(self.k[i], self.v[i], self.index)


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
    the index.
    """
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
