"""Flash attention: hand-written Hopper kernels and their plain PyTorch
versions, forward and backward.

The port of ``polyaxon_tpu/ops/flash.py``.  For a CUDA tensor
:func:`flash_attention` / :func:`flash_attention_lse` launch the CUDA
kernel in ``csrc/flash_fwd.cu`` and, in the backward, the dq and dkv
kernels in ``csrc/flash_bwd.cu`` (built at first use by
``ops/_build.py``); for a CPU tensor they run
:func:`_flash_forward_reference` and :func:`_flash_backward_reference`,
the plain versions of the same functions.  There is no fallback from one
to the other: a CUDA tensor the kernels do not take raises.  The two
``torch.autograd.Function``\\ s are the counterparts of the reference's
``custom_vjp``\\ s ``_flash`` and ``_flash_lse``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# Launches of each CUDA kernel: bumped once per launch, nowhere else.
launch_count = 0
dq_launch_count = 0
dkv_launch_count = 0


def flash_eligible(sq: int, sk: int, head_dim: int, mask=None, *,
                   mask_kv_len: Optional[int] = None) -> bool:
    """The routing predicate of every flash consumer: the
    ``POLYAXON_TPU_NO_FLASH`` kill-switch (set: every caller takes the
    plain path), 128-aligned sequences, a head dim that is a multiple of
    64, and at most a key-padding mask [B, 1, 1, kv_len] (the
    reference's rule, ``polyaxon_tpu/ops/flash.py:69-86``; its
    TPU-backend condition has no counterpart here)."""
    if os.environ.get("POLYAXON_TPU_NO_FLASH"):
        return False
    if sq % 128 or sk % 128 or head_dim % 64:
        return False
    return mask is None or (
        mask.ndim == 4 and mask.shape[1] == 1 and mask.shape[2] == 1
        and mask.shape[3] == (mask_kv_len if mask_kv_len is not None
                              else sk))


def narrow_kv_mask(mask, batch: int, sk: int) -> torch.Tensor:
    """[B?, 1, 1, Sk] boolean -> the [batch, sk] form the kernels take."""
    return mask[:, 0, 0, :].expand(batch, sk)


def _valid(q, k, kv_mask, causal: bool, window) -> torch.Tensor:
    """The admitted (q, k) pairs, [B or 1, 1, Sq, Sk]: causal with
    ``q_shift = sk - sq``, raw window, key padding."""
    sq, sk = q.shape[1], k.shape[1]
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
    return valid


def _flash_forward_reference(q, k, v, kv_mask, causal: bool, scale: float,
                             window=None) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Plain PyTorch version of the kernel on BSHD tensors: f32 scores,
    the same masks (causal with ``q_shift = sk - sq``, raw window, key
    padding), P rounded to V's type before the PV product, fully masked
    rows -> O = 0 and LSE = NEG_INF.  Returns (O [B, Sq, H, D] in q's
    type, LSE [B, H, Sq] f32)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    valid = _valid(q, k, kv_mask, causal, window)
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


def _delta(o, do, dlse=None) -> torch.Tensor:
    """``rowsum(dO * O)`` in f32, minus the LSE cotangent: [B, H, Sq].
    With ``dlse`` the blockwise combination's ``+P * dlse`` term of dS
    folds into delta (``polyaxon_tpu/ops/flash.py:502-511``)."""
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def _bwd_p_ds(q, k, v, kv_mask, o, lse, do, causal: bool, scale: float,
              window=None, dlse=None):
    """(P, dS) of the backward in f32, [B, H, Sq, Sk]: P = exp(S * scale -
    LSE) recomputed and zeroed by a select (a fully masked row's LSE of
    -1e30 makes exp overflow; a multiply would give NaN), and
    dS = P * (dO V^T - delta) * scale."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    valid = _valid(q, k, kv_mask, causal, window)
    p = torch.where(valid, torch.exp(s - lse.float()[..., None]),
                    torch.zeros_like(s))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - _delta(o, do, dlse)[..., None]) * scale


def _dq_from(ds, k, dtype):
    # dS rounded to K's type before dS K (flash.py:398-400).
    return torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                        k.float()).to(dtype)


def _dkv_from(p, ds, q, do, k_dtype, v_dtype):
    # P rounded to dO's type before P^T dO, dS to Q's type before dS^T Q
    # (flash.py:454-456, :462-464).
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return dk.to(k_dtype), dv.to(v_dtype)


def _bwd_dq_reference(q, k, v, kv_mask, o, lse, do, causal: bool,
                      scale: float, window=None, dlse=None):
    """Plain PyTorch version of the dq kernel: dQ in q's type."""
    _, ds = _bwd_p_ds(q, k, v, kv_mask, o, lse, do, causal, scale, window,
                      dlse)
    return _dq_from(ds, k, q.dtype)


def _bwd_dkv_reference(q, k, v, kv_mask, o, lse, do, causal: bool,
                       scale: float, window=None, dlse=None):
    """Plain PyTorch version of the dkv kernel: (dK, dV) in k's and v's
    types."""
    p, ds = _bwd_p_ds(q, k, v, kv_mask, o, lse, do, causal, scale, window,
                      dlse)
    return _dkv_from(p, ds, q, do, k.dtype, v.dtype)


def _flash_backward_reference(q, k, v, kv_mask, o, lse, do, causal: bool,
                              scale: float, window=None, dlse=None):
    """Plain PyTorch version of both backward kernels on BSHD tensors,
    with the reference's masks and three rounding points; all other
    arithmetic in f32.  Returns (dq, dk, dv) in the inputs' types."""
    p, ds = _bwd_p_ds(q, k, v, kv_mask, o, lse, do, causal, scale, window,
                      dlse)
    return (_dq_from(ds, k, q.dtype),
            *_dkv_from(p, ds, q, do, k.dtype, v.dtype))


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


_FWD_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 6
                 + [ctypes.c_float] + [ctypes.c_int] * 2
                 + [ctypes.c_longlong, ctypes.c_void_p])
_BWD_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10
                 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 8
                 + [ctypes.c_float] + [ctypes.c_int] * 2
                 + [ctypes.c_longlong, ctypes.c_void_p])
_entries = {}


def _entry(source: str, name: str, argtypes):
    """The C entry ``name`` of ``csrc/<source>.cu`` with its argument
    types, built and loaded at first use."""
    fn = _entries.get(name)
    if fn is None:
        from . import _build

        fn = getattr(_build.load(source), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _entries[name] = fn
    return fn


def _check_kernel_inputs(q, k, v) -> None:
    if any(type(t).__name__ == "DTensor" for t in (q, k, v)):
        # The kernel reads raw device pointers: a sharded DTensor would
        # hand it one shard.  FSDP gathers a block's parameters before
        # its forward, so attention sees rank-local tensors.
        raise TypeError("flash kernel takes rank-local tensors; got a "
                        "DTensor")
    b, _, h, d = q.shape
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


def _mask_bytes(kv_mask, b: int, sk: int, device):
    """[B, Sk] bytes on the device (None stays None)."""
    if kv_mask is None:
        return None
    kv_mask = kv_mask.to(device=device, dtype=torch.bool)
    return kv_mask.expand(b, sk).contiguous()


def _window_args(window):
    return int(window is not None), 0 if window is None else int(window)


def _fwd_kernel_args(q, k, v, kv_mask, causal: bool, scale: float,
                     window=None):
    """The C arguments of ``csrc/flash_fwd.cu``'s entry on CUDA tensors of
    the current device, but the stream, and the outputs (O [B, Sq, H, D],
    LSE [B, H, Sq] f32) it writes.  The argument tuple holds the tensors
    it points into."""
    _check_kernel_inputs(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    q, k, v = (_kernel_view(t) for t in (q, k, v))
    mask = _mask_bytes(kv_mask, b, sk, q.device)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    args = (_DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), None if mask is None else mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, h, sq, sk, q.stride(0),
            q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            float(scale), int(causal), *_window_args(window))
    return _KernelArgs(args, (q, k, v, mask, out, lse)), out, lse


def _flash_forward_kernel(q, k, v, kv_mask, causal: bool, scale: float,
                          window=None) -> Tuple[torch.Tensor,
                                                torch.Tensor]:
    """Launch ``csrc/flash_fwd.cu`` on CUDA tensors (BSHD); returns
    (O [B, Sq, H, D], LSE [B, H, Sq] f32)."""
    global launch_count
    if q.device.index != torch.cuda.current_device():
        # The C entry launches on the current device.
        with torch.cuda.device(q.device):
            return _flash_forward_kernel(q, k, v, kv_mask, causal, scale,
                                         window)
    args, out, lse = _fwd_kernel_args(q, k, v, kv_mask, causal, scale,
                                      window)
    err = _entry("flash_fwd", "flash_fwd", _FWD_ARGTYPES)(
        *args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error "
                           f"{err}")
    launch_count += 1
    return out, lse


def _bwd_kernel_args(q, k, v, kv_mask, o, lse, do, causal: bool,
                     scale: float, window=None, dlse=None):
    """The C arguments of both ``csrc/flash_bwd.cu`` entries on CUDA
    tensors of the current device, but the stream, and the outputs (dq,
    dk, dv) they write: contiguous BSHD in the inputs' types.  delta is
    one torch pass, as the reference leaves it to XLA.  The argument
    tuple holds the tensors it points into."""
    _check_kernel_inputs(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"flash backward: dO is {tuple(do.shape)} "
                         f"{do.dtype}; q is {tuple(q.shape)} {q.dtype}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    q, k, v, do = (_kernel_view(t) for t in (q, k, v, do))
    delta = _delta(o, do, dlse)
    lse = lse.float().contiguous()
    mask = _mask_bytes(kv_mask, b, sk, q.device)
    outs = (torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device),
            torch.empty((b, sk, h, d), dtype=k.dtype, device=q.device),
            torch.empty((b, sk, h, d), dtype=v.dtype, device=q.device))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(),
            None if mask is None else mask.data_ptr(),
            *(t.data_ptr() for t in outs))
    args = (_DTYPE_CODES[q.dtype], d, *ptrs, b, h, sq, sk, q.stride(0),
            q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            do.stride(0), do.stride(1), float(scale), int(causal),
            *_window_args(window))
    return _KernelArgs(args, (q, k, v, do, lse, delta, mask, *outs)), outs


class _KernelArgs(tuple):
    """C arguments that keep the tensors they point into alive."""

    def __new__(cls, args, keep):
        obj = super().__new__(cls, args)
        obj.keep = keep
        return obj


def _launch_bwd(which: str, args) -> None:
    """Launch ``flash_bwd_dq`` (``which="dq"``) or ``flash_bwd_dkv`` on
    the current stream."""
    global dq_launch_count, dkv_launch_count
    name = f"flash_bwd_{which}"
    err = _entry("flash_bwd", name, _BWD_ARGTYPES)(
        *args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    if which == "dq":
        dq_launch_count += 1
    else:
        dkv_launch_count += 1


def _flash_backward_kernel(q, k, v, kv_mask, o, lse, do, causal: bool,
                           scale: float, window=None, dlse=None):
    """Launch the dq and dkv kernels of ``csrc/flash_bwd.cu`` on CUDA
    tensors (BSHD); returns (dq, dk, dv), contiguous, in the inputs'
    types."""
    if q.device.index != torch.cuda.current_device():
        # The C entries launch on the current device.
        with torch.cuda.device(q.device):
            return _flash_backward_kernel(q, k, v, kv_mask, o, lse, do,
                                          causal, scale, window, dlse)
    args, outs = _bwd_kernel_args(q, k, v, kv_mask, o, lse, do, causal,
                                  scale, window, dlse)
    _launch_bwd("dq", args)
    _launch_bwd("dkv", args)
    return outs


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
    if q.is_cuda:
        return _flash_forward_kernel(q, k, v, kv_mask, causal, scale,
                                     window)
    return _flash_forward_reference(q, k, v, kv_mask, causal, scale,
                                    window)


def _flash_backward(q, k, v, kv_mask, o, lse, do, causal: bool,
                    scale: float, window=None, dlse=None):
    """(dq, dk, dv): the kernels for a CUDA tensor, the plain version for
    a CPU tensor."""
    if q.is_cuda:
        return _flash_backward_kernel(q, k, v, kv_mask, o, lse, do, causal,
                                      scale, window, dlse)
    return _flash_backward_reference(q, k, v, kv_mask, o, lse, do, causal,
                                     scale, window, dlse)


def _save(ctx, q, k, v, kv_mask, out, lse, causal, scale, window):
    ctx.save_for_backward(q, k, v, kv_mask, out, lse)
    ctx.attrs = (causal, scale, window)


def _grads(ctx, do, dlse):
    q, k, v, kv_mask, out, lse = ctx.saved_tensors
    causal, scale, window = ctx.attrs
    if do is None:  # only the LSE was used
        do = torch.zeros_like(out)
    dq, dk, dv = _flash_backward(q, k, v, kv_mask, out, lse, do, causal,
                                 scale, window, dlse)
    return dq, dk, dv, None, None, None, None


class _Flash(torch.autograd.Function):
    """O of flash attention; backward through the dq / dkv kernels
    (the reference's ``_flash`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale, window):
        out, lse = _flash_forward(q, k, v, kv_mask, causal, scale, window)
        _save(ctx, q, k, v, kv_mask, out, lse, causal, scale, window)
        return out

    @staticmethod
    def backward(ctx, do):
        return _grads(ctx, do.contiguous(), None)


class _FlashLse(torch.autograd.Function):
    """(O, LSE); the LSE cotangent folds into delta (the reference's
    ``_flash_lse`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale, window):
        ctx.set_materialize_grads(False)
        out, lse = _flash_forward(q, k, v, kv_mask, causal, scale, window)
        _save(ctx, q, k, v, kv_mask, out, lse, causal, scale, window)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        return _grads(ctx, None if do is None else do.contiguous(), dlse)


def flash_attention_lse(q, k, v, *, causal: bool = False,
                        scale: float = 1.0, kv_mask=None, window=None):
    """Flash attention over BSHD tensors returning ``(out, lse)``.

    ``out``: [B, Sq, H, D]; ``lse``: [B, H, Sq] f32 row logsumexp of the
    scaled scores (NEG_INF on fully-masked rows, whose out-rows are
    zero).  ``window`` has the RAW kernel semantics: None = off; any int
    masks q_pos - k_pos <= window, including non-positive values.
    Sq/Sk must be multiples of 128.  Differentiable in q, k and v,
    through both outputs."""
    return _FlashLse.apply(q, k, v, kv_mask, causal, scale,
                           None if window is None else int(window))


def flash_attention(q, k, v, *, causal: bool = False, scale: float = 1.0,
                    kv_mask=None, window=None) -> torch.Tensor:
    """Flash attention over BSHD tensors.  ``kv_mask``: optional [B, Sk]
    boolean key-padding mask (True = attend).  ``window``: position i
    attends to [i-window, i]; needs ``causal=True`` and ``window >= 1``.
    Sq and Sk must be multiples of 128; ragged shapes belong on
    ``ops.attention.dot_product_attention``.  Differentiable in q, k and
    v."""
    if window is not None:
        if not causal:
            raise ValueError(
                "sliding window attention is causal: position i "
                "attends to [i-window, i]; pass causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1; got {window}")
    return _Flash.apply(q, k, v, kv_mask, causal, scale,
                        None if window is None else int(window))
