"""Pieces the zoo's decoders share: the dense layer holding its
parameters in one type and computing in another (an int8 weight and
bias dequantize at this read, ``ops/quant.py``), the layer stack (remat
in training, the cache in decode), and the refusal of config options
that later slices of the port carry.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .kv_cache import KVCache


class Dense(nn.Linear):
    """``nn.Linear`` holding its parameters in ``param_dtype`` and
    computing in ``dtype`` (flax ``Dense(dtype=...)``, ``use_bias``
    as ``bias``).  Quantized by ``ops.quant.quantize_params``, its
    ``weight`` and ``bias`` are int8 buffers read through their
    dequantizing parametrization."""

    def __init__(self, n_in: int, n_out: int, dtype, param_dtype, device,
                 bias: bool = True):
        super().__init__(n_in, n_out, bias=bias, dtype=param_dtype,
                         device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x, self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


def refuse_unported(cfg) -> None:
    """Refuse the config options of the zoo's decoders that later slices
    of the port carry, each naming its ROADMAP item."""
    if cfg.remat and cfg.remat_policy is not None:
        raise NotImplementedError(
            f"remat_policy={cfg.remat_policy!r}: named remat policies "
            f"are not ported yet (ROADMAP Queue 1: Named remat policies); "
            f"remat=True with remat_policy=None recomputes whole blocks")


def model_device(model: nn.Module) -> torch.device:
    """The device a model's weights live on, read without touching a
    quantized weight (reading one dequantizes it)."""
    for t in model.parameters():
        return t.device
    return next(model.buffers()).device


def run_stack(blocks: nn.ModuleList, cfg, x,
              cache: Optional[KVCache] = None):
    """The layer stack: each block in turn, recomputed in the backward
    under ``cfg.remat`` (training), or appending to ``cache`` (decode),
    whose index then advances by the chunk's length."""
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    for i, block in enumerate(blocks):
        if remat:
            x = checkpoint(block, x, use_reentrant=False)
        else:
            x = block(x, None if cache is None else cache.layer(i))
    if cache is not None:
        # The index (a slot cache's positions are its owner's) and the
        # ring table advance once per forward.
        cache.advance(x.shape[1])
    return x
