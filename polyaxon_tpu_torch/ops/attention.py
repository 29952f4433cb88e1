"""Multi-head attention: the flash kernel where it applies, plain
PyTorch elsewhere.

Port of ``polyaxon_tpu/ops/attention.py``.  Input convention: q/k/v are
[batch, seq, heads, head_dim] (BSHD).  The plain path accumulates in f32
whatever the input type.  The sequence-parallel route (ring / Ulysses)
comes with the parallelism slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash import flash_attention, flash_eligible

BIG_NEG = -1e30


def _torch_attention(q, k, v, mask, causal, scale, window=None,
                     bias=None):
    """The reference's ``_xla_attention``: f32 scores, BIG_NEG masking,
    causal offset ``sk - sq``, window [i-window, i], additive bias."""
    orig_dtype = q.dtype
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        # Additive logit bias, applied after scaling and before masking
        # so masked positions stay at BIG_NEG whatever the bias.
        scores = scores + bias.float()
    # masked_fill with a Python scalar: no host-to-device copy, so the
    # plain path can run inside a CUDA graph capture.
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        ones = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
        cmask = torch.tril(ones, diagonal=sk - sq)
        if window:
            # Sliding window: position i attends to [i-window, i].
            cmask = cmask & torch.triu(ones, diagonal=sk - sq - window)
        scores = scores.masked_fill(~cmask[None, None], BIG_NEG)
    if mask is not None:
        # mask: broadcastable to [B, H, Sq, Sk]; True = attend.
        scores = scores.masked_fill(~mask.to(torch.bool), BIG_NEG)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(orig_dtype)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over [B, S, H, D] tensors; returns [B, Sq, H, D].

    ``window``: position i attends to [i-window, i]; requires
    ``causal=True`` and ``window >= 1``.  ``bias``: additive logit bias
    broadcastable to [B, H, Sq, Sk]; it takes the plain path (the flash
    kernel has no bias operand).  Shapes ``flash_eligible`` admits go
    to the flash kernel; the rest (decode masks, ragged lengths) to the
    plain path."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if window is not None:
        if not causal:
            raise ValueError(
                "sliding window attention requires causal=True")
        if window < 1:
            raise ValueError(
                f"window must be >= 1 (got {window}); 0 would silently "
                "disable windowing in the falsy checks downstream")
    if bias is not None:
        return _torch_attention(q, k, v, mask, causal, scale,
                                window=window, bias=bias)
    if flash_eligible(q.shape[1], k.shape[1], q.shape[-1], mask):
        kv_mask = None if mask is None else mask[:, 0, 0, :]
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               kv_mask=kv_mask, window=window)
    return _torch_attention(q, k, v, mask, causal, scale, window=window)
