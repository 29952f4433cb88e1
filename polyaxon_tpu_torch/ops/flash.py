"""Flash-attention forward: a hand-written Hopper kernel and its plain
PyTorch version.

The port of ``polyaxon_tpu/ops/flash.py``'s forward half.  For a CUDA
tensor :func:`flash_attention` / :func:`flash_attention_lse` launch the
CUDA kernel in ``csrc/flash_fwd.cu`` (built at first use by
``ops/_build.py``); for a CPU tensor they run
:func:`_flash_forward_reference`, the plain version of the same
function.  There is no fallback from one to the other: a CUDA tensor
the kernel does not take raises.

The backward kernels (``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``) come
with the training slice; until then a tensor that requires grad is
refused.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
# Query rows of a kernel block; the kernel takes Sq, Sk multiples of it.
KERNEL_BLOCK = 64
KERNEL_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# Launches of the CUDA kernel: bumped once per launch, nowhere else.
launch_count = 0


def flash_eligible(sq: int, sk: int, head_dim: int, mask=None, *,
                   mask_kv_len: Optional[int] = None) -> bool:
    """The routing predicate of every flash consumer: 128-aligned
    sequences, a head dim that is a multiple of 64, and at most a
    key-padding mask [B, 1, 1, kv_len] (the reference's rule,
    ``polyaxon_tpu/ops/flash.py:81-86``; its TPU-backend condition has no
    counterpart here)."""
    if sq % 128 or sk % 128 or head_dim % 64:
        return False
    return mask is None or (
        mask.ndim == 4 and mask.shape[1] == 1 and mask.shape[2] == 1
        and mask.shape[3] == (mask_kv_len if mask_kv_len is not None
                              else sk))


def _flash_forward_reference(q, k, v, kv_mask, causal: bool, scale: float,
                             window=None) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Plain PyTorch version of the kernel on BSHD tensors: f32 scores,
    the same masks (causal with ``q_shift = sk - sq``, raw window, key
    padding), P rounded to V's type before the PV product, fully masked
    rows -> O = 0 and LSE = NEG_INF.  Returns (O [B, Sq, H, D] in q's
    type, LSE [B, H, Sq] f32)."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    q_ids = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    k_ids = torch.arange(sk, device=q.device)[None, :]
    valid = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        valid = valid & (q_ids >= k_ids)
    if window is not None:
        valid = valid & (q_ids - k_ids <= window)
    valid = valid[None, None]
    if kv_mask is not None:
        valid = valid & kv_mask.to(torch.bool)[:, None, None, :]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    empty = l == 0.0
    safe_l = torch.where(empty, torch.ones_like(l), l)
    pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    out = (pv / safe_l).transpose(1, 2).to(q.dtype)
    lse = torch.where(empty, torch.full_like(l, NEG_INF),
                      m + torch.log(safe_l))[..., 0]
    return out, lse


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel can read it in place (a contiguous,
    16-byte aligned [H, D] block per row, 16-byte aligned row strides —
    the q/k/v views of a fused QKV projection qualify), else a copy."""
    b, s, h, d = t.shape
    size = t.element_size()
    ok = (t.stride(3) == 1 and t.stride(2) == d
          and (t.stride(1) * size) % 16 == 0
          and (t.stride(0) * size) % 16 == 0
          and t.data_ptr() % 16 == 0)
    return t if ok else t.contiguous()


_fn = None


def _kernel_fn():
    """The C entry of ``csrc/flash_fwd.cu`` with its argument types, built
    and loaded at first use."""
    global _fn
    if _fn is None:
        from . import _build

        fn = _build.load("flash_fwd").flash_fwd
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                       + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6
                       + [ctypes.c_float] + [ctypes.c_int] * 2
                       + [ctypes.c_longlong, ctypes.c_void_p])
        _fn = fn
    return _fn


def _flash_forward_kernel(q, k, v, kv_mask, causal: bool, scale: float,
                          window=None) -> Tuple[torch.Tensor,
                                                torch.Tensor]:
    """Launch ``csrc/flash_fwd.cu`` on CUDA tensors (BSHD); returns
    (O [B, Sq, H, D], LSE [B, H, Sq] f32)."""
    global launch_count
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash kernel takes float32, bfloat16 or "
                         f"float16; got {q.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dims "
                         f"{KERNEL_HEAD_DIMS}; got {d}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash: {name} is {t.dtype} on {t.device}; "
                             f"q is {q.dtype} on {q.device}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"flash: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.device.index != torch.cuda.current_device():
        # The C entry launches on the current device.
        with torch.cuda.device(q.device):
            return _flash_forward_kernel(q, k, v, kv_mask, causal, scale,
                                         window)
    q, k, v = (_kernel_view(t) for t in (q, k, v))
    mask_ptr = None
    if kv_mask is not None:
        kv_mask = kv_mask.to(device=q.device, dtype=torch.bool)
        kv_mask = kv_mask.expand(b, sk).contiguous()
        mask_ptr = kv_mask.data_ptr()
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel_fn()(
        _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        mask_ptr, out.data_ptr(), lse.data_ptr(), b, h, sq, sk, q.stride(0),
        q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        float(scale), int(causal), int(window is not None),
        0 if window is None else int(window), stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error "
                           f"{err}")
    launch_count += 1
    return out, lse


def _flash_forward(q, k, v, kv_mask, causal: bool, scale: float,
                   window=None):
    """BSHD -> (O, LSE [B, H, Sq]): the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    sq, sk = q.shape[1], k.shape[1]
    if sq % 128 or sk % 128:
        raise ValueError(
            f"flash_attention needs seq lengths divisible by 128 (the "
            f"TPU lane tile); got Sq={sq}, Sk={sk}. Use "
            f"ops.dot_product_attention for ragged shapes.")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash attention has no backward yet: the dq/dkv kernels "
            "come with the training slice of the port (run under "
            "torch.no_grad())")
    if q.is_cuda:
        return _flash_forward_kernel(q, k, v, kv_mask, causal, scale,
                                     window)
    return _flash_forward_reference(q, k, v, kv_mask, causal, scale,
                                    window)


def flash_attention_lse(q, k, v, *, causal: bool = False,
                        scale: float = 1.0, kv_mask=None, window=None):
    """Flash attention over BSHD tensors returning ``(out, lse)``.

    ``out``: [B, Sq, H, D]; ``lse``: [B, H, Sq] f32 row logsumexp of the
    scaled scores (NEG_INF on fully-masked rows, whose out-rows are
    zero).  ``window`` has the RAW kernel semantics: None = off; any int
    masks q_pos - k_pos <= window, including non-positive values.
    Sq/Sk must be multiples of 128."""
    return _flash_forward(q, k, v, kv_mask, causal, scale,
                          None if window is None else int(window))


def flash_attention(q, k, v, *, causal: bool = False, scale: float = 1.0,
                    kv_mask=None, window=None) -> torch.Tensor:
    """Flash attention over BSHD tensors.  ``kv_mask``: optional [B, Sk]
    boolean key-padding mask (True = attend).  ``window``: position i
    attends to [i-window, i]; needs ``causal=True`` and ``window >= 1``.
    Sq and Sk must be multiples of 128; ragged shapes belong on
    ``ops.attention.dot_product_attention``."""
    if window is not None:
        if not causal:
            raise ValueError(
                "sliding window attention is causal: position i "
                "attends to [i-window, i]; pass causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1; got {window}")
    out, _ = _flash_forward(q, k, v, kv_mask, causal, scale,
                            None if window is None else int(window))
    return out
