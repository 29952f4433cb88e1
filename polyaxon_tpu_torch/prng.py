"""JAX's threefry2x32 random numbers on torch tensors.

The counterpart of the ``jax.random`` functions the reference's
sampling draws through (``PRNGKey``, ``fold_in``, ``split``,
``uniform``, ``gumbel``, ``categorical``), computed bit for bit as jax
computes them with ``jax_threefry_partitionable`` on (the default of
the jax the reference pins): the same keys, the same random bits and
the same uniforms, on any device.  Every function is plain tensor
arithmetic with no host read, so it runs inside a CUDA graph capture.

A KEY is an int64 tensor ``[..., 2]`` holding the two uint32 words of a
jax key (values in ``[0, 2**32)``).  Leading dims make a BATCH of keys,
one per row, the counterpart of ``jax.vmap`` over keys.  uint32 has
almost no arithmetic on CUDA tensors and ``>>`` on int32 is
arithmetic, so the words live in int64 and every add and rotation is
masked back to 32 bits.

Source of the arithmetic: ``jax/_src/prng.py`` (``threefry_seed``,
``_threefry2x32_lowering``, ``_threefry_fold_in``,
``_threefry_split_foldlike``, ``_threefry_random_bits_partitionable``,
``iota_2x32_shape``) and ``jax/_src/random.py`` (``_uniform``,
``_gumbel`` in its default "low" mode, ``categorical`` with
replacement).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

__all__ = ["PRNGKey", "fold_in", "split", "random_bits", "uniform",
           "gumbel", "categorical", "threefry2x32"]

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA

# (bits drawn, mantissa bits, bit pattern of 1.0, integer view) per
# float type, as ``_uniform`` picks them: 16-bit types with fewer than
# 8 mantissa bits draw 8 random bits.
_FLOAT_BITS = {
    torch.float32: (32, 23, 0x3F800000, torch.int32),
    torch.float16: (16, 10, 0x3C00, torch.int16),
    torch.bfloat16: (8, 7, 0x3F80, torch.int16),
}


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the count pairs
    ``(x1, x2)`` under key words ``(k1, k2)``; all int64 in
    ``[0, 2**32)``, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: ``[0, seed mod 2**32]`` for a seed
    jax takes as a 32-bit integer."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor,
            data: Union[int, torch.Tensor]) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the count pair
    ``(0, data mod 2**32)`` under ``key``.  ``data`` may be a tensor
    broadcast against the key's batch dims (one index per row)."""
    if not isinstance(data, torch.Tensor):
        data = torch.tensor(int(data) & M32, dtype=torch.int64,
                            device=key.device)
    else:
        data = data.to(torch.int64) & M32
    y1, y2 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def _iota_2x32(shape: Sequence[int], device) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """``iota_2x32_shape``: the row-major index of every element of
    ``shape`` as (high word, low word)."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=device).view(tuple(shape))
    return idx >> 32, idx & M32


def _hash_over(key: torch.Tensor, shape: Sequence[int]):
    hi, lo = _iota_2x32(shape, key.device)
    expand = (...,) + (None,) * len(shape)
    return threefry2x32(key[..., 0][expand], key[..., 1][expand], hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` (the fold-like split of the
    partitionable layout): ``[..., num, 2]``."""
    b1, b2 = _hash_over(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element of ``shape`` (``bits1 ^ bits2`` of the
    hashed element indices), int64 ``[..., *shape]``."""
    b1, b2 = _hash_over(key, tuple(shape))
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int],
            dtype: torch.dtype = torch.float32, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform``: the random bits' top mantissa bits under
    the exponent of 1.0, minus 1, scaled into ``[minval, maxval)``."""
    if dtype not in _FLOAT_BITS:
        raise TypeError(f"uniform takes float32, float16 or bfloat16; "
                        f"got {dtype}")
    rng_bits, nmant, one, view = _FLOAT_BITS[dtype]
    bits = random_bits(key, shape)
    if rng_bits < 32:
        bits = bits & ((1 << rng_bits) - 1)
    float_bits = (bits >> (rng_bits - nmant)) | one
    floats = float_bits.to(view).view(dtype) - 1.0
    # The bounds rounded to ``dtype`` on the host: no device copy, so
    # the draw stays capturable.
    lo = torch.tensor(minval, dtype=dtype)
    span = float(torch.tensor(maxval, dtype=dtype) - lo)
    lo = float(lo)
    return torch.clamp_min(floats * span + lo, lo)


def gumbel(key: torch.Tensor, shape: Sequence[int],
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.gumbel`` in its default "low" mode:
    ``-log(-log(u))`` of a uniform in ``[tiny, 1)``."""
    u = uniform(key, shape, dtype, minval=torch.finfo(dtype).tiny,
                maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the
    argmax (first maximum) of ``gumbel + logits``, the noise drawn in
    the logits' type.  One key ``[2]`` draws over the whole logits
    shape, as jax does; a batch of keys ``[..., 2]`` with the logits'
    leading dims draws each row with its own key over the last axis
    (``jax.vmap`` over rows)."""
    if key.dim() == 1:
        g = gumbel(key, logits.shape, logits.dtype)
    else:
        if key.shape[:-1] != logits.shape[:-1]:
            raise ValueError(
                f"a batch of keys {tuple(key.shape)} must match the "
                f"logits' leading dims {tuple(logits.shape[:-1])}")
        g = gumbel(key, logits.shape[-1:], logits.dtype)
    return torch.argmax(g + logits, dim=-1)
