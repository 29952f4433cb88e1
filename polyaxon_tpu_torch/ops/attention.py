"""Multi-head attention: the flash kernel where it applies, plain
PyTorch elsewhere.

Port of ``polyaxon_tpu/ops/attention.py``.  Input convention: q/k/v are
[batch, seq, heads, head_dim] (BSHD).  The plain path accumulates in f32
whatever the input type.

Under an active sequence-parallel context (:func:`sequence_parallel`,
which ``train.py`` enters for a strategy with sp above 1) every call
routes through ring or Ulysses attention over the sp group
(``parallel/ring.py``, ``parallel/ulysses.py``), so every model of the
zoo trains over sp without a change.  The route is read at each call:
the port's steps are eager, so a step built before activation takes the
sp route too (the reference refuses activation while compiled steps
exist, since their cached traces would keep local attention).
"""

from __future__ import annotations

import contextlib
import logging
import threading
from typing import Optional

import torch

from .flash import flash_attention, flash_eligible, narrow_kv_mask

BIG_NEG = -1e30

logger = logging.getLogger(__name__)

# The active sequence-parallel context of this thread: (mesh, mode) or
# None.
_SP_STATE = threading.local()


def activate_sequence_parallel(mesh, mode: str = "ring", *,
                               force: bool = False) -> None:
    """Route this thread's later attention calls through sequence
    parallelism over ``mesh``'s sp axis (nothing when it is 1).
    ``force`` is the reference's escape hatch past its compiled-step
    guard; the port reads the route at call time and has no such guard,
    so it changes nothing."""
    if mode not in ("ring", "ulysses"):
        raise ValueError(f"unknown sequence-parallel mode {mode!r}")
    _SP_STATE.ctx = (mesh, mode) if mesh.shape.get("sp", 1) > 1 else None


def deactivate_sequence_parallel() -> None:
    _SP_STATE.ctx = None


@contextlib.contextmanager
def sequence_parallel(mesh, mode: str = "ring", *, force: bool = False):
    """Scoped form of :func:`activate_sequence_parallel`."""
    prev = getattr(_SP_STATE, "ctx", None)
    activate_sequence_parallel(mesh, mode, force=force)
    try:
        yield
    finally:
        _SP_STATE.ctx = prev


def current_sequence_parallel():
    """This thread's sequence-parallel context: (mesh, mode) or None."""
    return getattr(_SP_STATE, "ctx", None)


@contextlib.contextmanager
def restored_sequence_parallel(ctx):
    """This thread's context set to ``ctx`` (as
    :func:`current_sequence_parallel` gave it) inside the block: a
    recomputed (remat) block's forward runs again in the backward, on
    the autograd engine's device thread for a CUDA tensor, and must take
    the route its first forward took."""
    prev = getattr(_SP_STATE, "ctx", None)
    _SP_STATE.ctx = ctx
    try:
        yield
    finally:
        _SP_STATE.ctx = prev


def _sp_route(q, k, v, mask, causal, scale):
    """The (mesh, mode) to use, or None for local attention.

    Masked batches (padding) stay sequence-parallel: the ring slices the
    mask's kv dim per rotation, Ulysses slices its heads after the
    all-to-all."""
    ctx = getattr(_SP_STATE, "ctx", None)
    if ctx is None:
        return None
    mesh, mode = ctx
    sp = mesh.shape.get("sp", 1)
    seq = q.shape[1]
    heads = q.shape[2]
    if seq % sp or q.shape[1] != k.shape[1]:
        logger.warning("sequence_parallel: seq %d not divisible by sp %d;"
                       " falling back to local attention", seq, sp)
        return None
    if mask is not None and (mask.ndim != 4 or
                             mask.shape[2] not in (1, seq) or
                             mask.shape[3] not in (1, seq)):
        logger.warning("sequence_parallel: mask shape %s not broadcastable"
                       " to [B,H,S,S]; falling back to local attention",
                       tuple(mask.shape))
        return None
    if mode == "ulysses" and (heads % sp or (
            mask is not None and mask.shape[1] > 1 and
            mask.shape[1] % sp)):
        logger.warning("sequence_parallel: heads %d (mask heads %s) not "
                       "divisible by sp %d; falling back to ring", heads,
                       None if mask is None else mask.shape[1], sp)
        mode = "ring"
    return mesh, mode


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
    kernel and the sequence-parallel schedules have no bias operand, so
    biased attention stays local under sp).  Under sequence parallelism
    the call routes through ring / Ulysses attention (``_sp_route``);
    otherwise shapes ``flash_eligible`` admits go to the flash kernel,
    the rest (decode masks, ragged lengths) to the plain path."""
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
        if getattr(_SP_STATE, "ctx", None) is not None:
            logger.warning(
                "sequence_parallel: additive attention bias is not "
                "supported by the ring/Ulysses schedules; falling back "
                "to local attention for this call")
        return _torch_attention(q, k, v, mask, causal, scale,
                                window=window, bias=bias)
    route = _sp_route(q, k, v, mask, causal, scale)
    if route is not None:
        mesh, mode = route
        if mode == "ulysses":
            from ..parallel.ulysses import ulysses_attention

            return ulysses_attention(q, k, v, mesh, mask=mask,
                                     causal=causal, scale=scale,
                                     window=window)
        from ..parallel.ring import ring_attention

        return ring_attention(q, k, v, mesh, mask=mask, causal=causal,
                              scale=scale, window=window)
    return _local_attention(q, k, v, mask, causal=causal, scale=scale,
                            window=window)


def _local_attention(q, k, v, mask=None, *, causal: bool, scale: float,
                     window: Optional[int] = None) -> torch.Tensor:
    """Attention on this rank alone: the flash kernel for the shapes
    ``flash_eligible`` admits (at most a key-padding mask, narrowed to
    the kernels' [B, Sk] form), the plain path for the rest."""
    if flash_eligible(q.shape[1], k.shape[1], q.shape[-1], mask):
        kv_mask = None if mask is None else \
            narrow_kv_mask(mask, q.shape[0], k.shape[1])
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               kv_mask=kv_mask, window=window)
    return _torch_attention(q, k, v, mask, causal, scale, window=window)
