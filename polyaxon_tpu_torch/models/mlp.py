"""MNIST MLP, in PyTorch: the BASELINE's configuration 1.

Port of ``polyaxon_tpu/models/mlp.py``: flattened NHWC images through
``fc1 .. fcN`` (ReLU) and a float32 ``head``.  Parameters are float32
(flax's default ``param_dtype``), each dense layer computes in
``cfg.dtype``.  Parameter names follow the flax tree, so
``convert.mlp_state_dict_from_jax`` maps one onto the other.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import default_device
from .layers import Dense, model_device


@dataclass(frozen=True)
class MLPConfig:
    features: Tuple[int, ...] = (512, 256)
    num_classes: int = 10
    # Inputs are flattened whatever their shape; the first layer's
    # width is fixed at construction (flax infers it at init).
    in_features: int = 28 * 28
    dtype: torch.dtype = torch.float32


class MLP(nn.Module):
    def __init__(self, cfg: MLPConfig, device=None, param_dtype=None):
        super().__init__()
        device = default_device(device)
        self.cfg = cfg
        pd = param_dtype or torch.float32
        widths = (cfg.in_features,) + tuple(cfg.features)
        for i in range(len(cfg.features)):
            self.add_module(f"fc{i + 1}", Dense(
                widths[i], widths[i + 1], cfg.dtype, pd, device))
        self.head = Dense(widths[-1], cfg.num_classes, torch.float32, pd,
                          device)

    @property
    def device(self) -> torch.device:
        return model_device(self)

    def forward(self, x, *, train: bool = False):
        """Logits [B, classes] in float32 (``train`` changes nothing)."""
        del train
        x = x.reshape(x.shape[0], -1).to(self.cfg.dtype)
        for i in range(len(self.cfg.features)):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return self.head(x)
