"""Rotary position embeddings (RoPE), Su et al., RoFormer.

Port of ``polyaxon_tpu/ops/rotary.py``: the half-split (``rotate_half``)
convention over the head dim, the angle table built in float32 from
``theta ** (-arange(half) / half)``, the rotation computed in float32
and cast back to the input's type.  ``positions`` may be [S] (one row of
positions for the batch: the full forward and the solo cache) or [B, S]
(one row each: the slot pool's per-row positions, a device tensor).
Every read of the positions is a tensor operation, so the rotation runs
inside a CUDA graph with the positions read at replay time.
"""

from __future__ import annotations

from typing import Optional

import torch


def _cos_sin(dim: int, theta: float, positions: torch.Tensor):
    """cos and sin of the angle table, ``positions.shape + (dim / 2,)``,
    float32 (bf16 angles lose too much precision at long positions)."""
    half = dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def rotate(x: torch.Tensor, positions: torch.Tensor, *,
           theta: float = 10000.0) -> torch.Tensor:
    """One tensor ([B, S, H, D]) rotated at ``positions`` ([S] or
    [B, S]): the full forward's q and k at ``arange(S)``, the decode
    path's keys inside the cache append, and its queries at the
    positions the append returns."""
    if x.shape[-1] % 2:
        raise ValueError(f"RoPE needs an even head dim; got {x.shape[-1]}")
    return _rot(x, *_angles(x.shape[-1], theta, positions))


def apply_rotary(q: torch.Tensor, k: torch.Tensor, *,
                 theta: float = 10000.0, position_offset: int = 0,
                 positions: Optional[torch.Tensor] = None):
    """The reference's signature over :func:`rotate`: q and k
    ([B, S, H, D]) rotated at ``positions`` ([S] or [B, S]), by default
    ``position_offset + arange(S)``; returns (q, k)."""
    seq = q.shape[1]
    if k.shape[1] != seq:
        # Rotating a short q against a long k (decode against a cache)
        # must go through two calls: the cached k are already rotated.
        raise ValueError(
            f"apply_rotary needs matching q/k seq lengths (got "
            f"{seq} vs {k.shape[1]}); rotate new k at its own "
            f"position_offset and reuse the cached rotated keys")
    if positions is None:
        positions = position_offset + torch.arange(seq, device=q.device)
    return (rotate(q, positions, theta=theta),
            rotate(k, positions, theta=theta))


def _angles(dim: int, theta: float, positions: torch.Tensor):
    """cos, sin broadcastable to [B, S, H, D/2]: [S] positions give
    [1, S, 1, D/2], [B, S] positions [B, S, 1, D/2]."""
    cos, sin = _cos_sin(dim, theta, positions)
    if positions.ndim == 1:
        return cos[None, :, None, :], sin[None, :, None, :]
    return cos.unsqueeze(-2), sin.unsqueeze(-2)


def _rot(x, cos, sin):
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)
