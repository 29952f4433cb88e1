"""CIFAR-10 ConvNet, in PyTorch: the BASELINE's configuration 4 (the
hyperband sweep's target).

Port of ``polyaxon_tpu/models/convnet.py``: ``[conv-conv-pool]`` blocks
of 3x3 SAME convolutions with biases (ReLU), 2x2 max pools, a global
average pool, ``fc1`` (ReLU) and a float32 ``head``, in ``cfg.dtype``
(bf16) on float32 parameters.  NHWC inputs run as channels-last NCHW.

``dropout > 0`` draws its mask from torch's generator, not from flax's
``make_rng("dropout")`` stream (ROADMAP Queue 3, deliberate
differences); the default is 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import default_device
from .layers import Conv, Dense, model_device


@dataclass(frozen=True)
class ConvNetConfig:
    widths: Tuple[int, ...] = (64, 128, 256)
    dense_width: int = 256
    num_classes: int = 10
    dropout: float = 0.0
    in_channels: int = 3
    dtype: torch.dtype = torch.bfloat16


class ConvNet(nn.Module):
    def __init__(self, cfg: ConvNetConfig, device=None, param_dtype=None):
        super().__init__()
        device = default_device(device)
        self.cfg = cfg
        pd = param_dtype or torch.float32
        c_in = cfg.in_channels
        for i, width in enumerate(cfg.widths):
            for j in range(2):
                self.add_module(f"block{i + 1}_conv{j + 1}", Conv(
                    c_in, width, 3, dtype=cfg.dtype, param_dtype=pd,
                    device=device))
                c_in = width
        self.fc1 = Dense(c_in, cfg.dense_width, cfg.dtype, pd, device)
        self.head = Dense(cfg.dense_width, cfg.num_classes, torch.float32,
                          pd, device)

    @property
    def device(self) -> torch.device:
        return model_device(self)

    def forward(self, x, *, train: bool = False):
        """NHWC images -> logits [B, classes] in float32."""
        cfg = self.cfg
        x = x.to(cfg.dtype).permute(0, 3, 1, 2)
        for i in range(len(cfg.widths)):
            for j in range(2):
                x = F.relu(getattr(self, f"block{i + 1}_conv{j + 1}")(x))
            x = F.max_pool2d(x, 2, 2)
        x = F.relu(self.fc1(x.mean((2, 3))))
        if cfg.dropout > 0:
            x = F.dropout(x, cfg.dropout, training=train)
        return self.head(x)
