"""ResNet-50, in PyTorch: the BASELINE's configuration 2.

Port of ``polyaxon_tpu/models/resnet.py`` (ResNet v1.5: the stride sits
on the bottleneck's 3x3).  The dtype placement is the reference's:
convolutions in ``cfg.dtype`` (bf16) on float32 parameters; batch norm
in ``cfg.norm_dtype`` (float32) with float32 statistics, so the ReLUs,
the max pool and the residual stream run in float32 and each
convolution casts its input; the head is a float32 dense layer after
the spatial mean.  NHWC inputs run as channels-last NCHW tensors (the
NHWC memory layout, cuDNN's fast one for bf16 convolutions).

The traps of the translation, each pinned by a CPU test against the
reference (``tests/test_torch_zoo.py``):

- flax's SAME padding with stride 2 is asymmetric (low = total // 2):
  the 7x7/s2 stem on 224 pads (2, 3), a 3x3/s2 on an even size (0, 1),
  and the 3x3/s2 max pool (0, 1) with -inf; torch's symmetric
  ``padding=`` would shift every window (``layers.Conv``, ``pad_hw``);
- batch norm keeps flax's biased running variance (``layers.BatchNorm``);
- ``bn3``'s scale starts at zero (the residual branch starts as the
  identity): ``registry._init_weights`` reads ``BatchNorm.zero_scale``.

Stems: ``conv7`` (7x7/s2) or ``space_to_depth`` (2x2 space-to-depth,
then a 4x4/s1 conv padded ((1, 2), (1, 2))).  Module names follow the
flax tree (``stem_conv``, ``stem_bn``, ``stage{i}_block{j}.{conv1,bn1,
conv2,bn2,conv3,bn3,proj_conv,proj_bn}``, ``head``), so
``convert.resnet_state_dict_from_jax`` maps one onto the other, its
``batch_stats`` onto the norms' running buffers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import default_device
from .layers import BatchNorm, Conv, Dense, _same_pads, model_device, pad_hw


@dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (3, 4, 6, 3)
    num_classes: int = 1000
    width: int = 64
    in_channels: int = 3
    dtype: torch.dtype = torch.bfloat16
    norm_dtype: torch.dtype = torch.float32
    stem: str = "conv7"

    def __post_init__(self):
        if self.stem not in ("conv7", "space_to_depth"):
            raise ValueError(f"stem must be 'conv7' or 'space_to_depth', "
                             f"got {self.stem!r}")


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 bottleneck, projection shortcut when
    the shape changes."""

    def __init__(self, cfg: ResNetConfig, c_in: int, filters: int,
                 stride: int, device, pd):
        super().__init__()
        conv = dict(dtype=cfg.dtype, param_dtype=pd, device=device,
                    bias=False)
        norm = dict(device=device, dtype=cfg.norm_dtype)
        self.conv1 = Conv(c_in, filters, 1, **conv)
        self.bn1 = BatchNorm(filters, **norm)
        self.conv2 = Conv(filters, filters, 3, stride, **conv)
        self.bn2 = BatchNorm(filters, **norm)
        self.conv3 = Conv(filters, 4 * filters, 1, **conv)
        self.bn3 = BatchNorm(4 * filters, zero_scale=True, **norm)
        self.project = stride != 1 or c_in != 4 * filters
        if self.project:
            self.proj_conv = Conv(c_in, 4 * filters, 1, stride, **conv)
            self.proj_bn = BatchNorm(4 * filters, **norm)

    def forward(self, x, train: bool):
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        residual = self.proj_bn(self.proj_conv(x), train) \
            if self.project else x
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet v1.5; the default config is ResNet-50."""

    def __init__(self, cfg: ResNetConfig, device=None, param_dtype=None):
        super().__init__()
        device = default_device(device)
        self.cfg = cfg
        pd = param_dtype or torch.float32
        conv = dict(dtype=cfg.dtype, param_dtype=pd, device=device,
                    bias=False)
        if cfg.stem == "space_to_depth":
            self.stem_conv = Conv(4 * cfg.in_channels, cfg.width, 4,
                                  padding=((1, 2), (1, 2)), **conv)
        else:
            self.stem_conv = Conv(cfg.in_channels, cfg.width, 7, 2, **conv)
        self.stem_bn = BatchNorm(cfg.width, device=device,
                                 dtype=cfg.norm_dtype)
        self.block_names = []
        c_in = cfg.width
        for i, count in enumerate(cfg.stage_sizes):
            for j in range(count):
                name = f"stage{i + 1}_block{j + 1}"
                filters = cfg.width * 2 ** i
                self.add_module(name, BottleneckBlock(
                    cfg, c_in, filters, 2 if i > 0 and j == 0 else 1,
                    device, pd))
                self.block_names.append(name)
                c_in = 4 * filters
        self.head = Dense(c_in, cfg.num_classes, torch.float32, pd, device)

    @property
    def device(self) -> torch.device:
        return model_device(self)

    def forward(self, x, *, train: bool = False):
        """NHWC images -> logits [B, classes] in float32.  ``train``:
        batch statistics (advancing the running averages), else the
        running averages."""
        cfg = self.cfg
        x = x.to(cfg.dtype)
        if cfg.stem == "space_to_depth":
            b, h, w, c = x.shape
            x = x.reshape(b, h // 2, 2, w // 2, 2, c) \
                .permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
        x = x.permute(0, 3, 1, 2)       # NCHW view of NHWC memory
        x = F.relu(self.stem_bn(self.stem_conv(x), train))
        pads = tuple(_same_pads(n, 3, 2) for n in x.shape[-2:])
        x = F.max_pool2d(pad_hw(x, pads, float("-inf")), 3, 2)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        return self.head(x.mean((2, 3)))
