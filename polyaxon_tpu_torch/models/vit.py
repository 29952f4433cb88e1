"""ViT, in PyTorch: the zoo's vision transformer classifier.

Port of ``polyaxon_tpu/models/vit.py``: a strided patch convolution,
a CLS token and learned positions (float32 parameters cast to
``cfg.dtype``), pre-LN encoder blocks (float32 LayerNorms, fused
``qkv``, non-causal attention through
``ops.attention.dot_product_attention``, GELU tanh-approximate unless
``gelu_approximate=False``, HF's exact form, which ``--init-hf`` sets),
the final LayerNorm and a float32 head on the CLS token.  At 224 / 16 a
sequence holds 197 tokens, which ``flash_eligible`` refuses (not a
multiple of 128) in both packages: ViT's attention takes the plain path
and launches no kernel.  ``cfg.remat`` recomputes each block in the
backward as ``cfg.remat_policy`` says (``layers.py``).

Images are NHWC, as the reference takes them; the convolution runs on
their NCHW view (channels-last memory).  Parameter names follow the flax
tree (``patch_embed``, ``cls``, ``pos_embed``,
``h.{i}.{ln1,qkv,o_proj,ln2,fc1,fc2}``, ``ln_f``, ``head``), so
``convert.vit_state_dict_from_jax`` maps one onto the other.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import default_device
from ..ops.attention import dot_product_attention
from .layers import Conv, Dense, check_remat_policy, f32_param, \
    model_device, remat_call


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-6
    # tanh GELU by default; HF ViT uses the exact (erf) form.
    gelu_approximate: bool = True
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False
    remat_policy: Optional[str] = None

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @staticmethod
    def base() -> "ViTConfig":
        return ViTConfig()  # ViT-B/16

    @staticmethod
    def tiny() -> "ViTConfig":
        return ViTConfig(image_size=32, patch_size=8, num_classes=10,
                         hidden_size=64, num_layers=2, num_heads=4,
                         intermediate_size=128)


def _layer_norm(cfg: ViTConfig, device) -> nn.LayerNorm:
    return nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                        dtype=torch.float32, device=device)


class ViTBlock(nn.Module):
    """Pre-LN encoder block (non-causal attention over patches + CLS)."""

    def __init__(self, cfg: ViTConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        pd = param_dtype or cfg.dtype

        def dense(n_in, n_out):
            return Dense(n_in, n_out, cfg.dtype, pd, device)

        self.ln1 = _layer_norm(cfg, device)
        self.qkv = dense(h, 3 * h)
        self.o_proj = dense(h, h)
        self.ln2 = _layer_norm(cfg, device)
        self.fc1 = dense(h, cfg.intermediate_size)
        self.fc2 = dense(cfg.intermediate_size, h)

    def forward(self, x):
        cfg = self.cfg
        h = self.ln1(x.float()).to(cfg.dtype)
        # -1 heads: all of them, or a tp rank's (qkv split by heads).
        shape = h.shape[:-1] + (-1, cfg.hidden_size // cfg.num_heads)
        q, k, v = (t.reshape(shape) for t in self.qkv(h).chunk(3, dim=-1))
        a = dot_product_attention(q, k, v, causal=False)
        x = x + self.o_proj(a.flatten(-2))
        h = self.ln2(x.float()).to(cfg.dtype)
        h = F.gelu(self.fc1(h), approximate="tanh" if cfg.gelu_approximate
                   else "none")
        return x + self.fc2(h)


class ViTModel(nn.Module):
    """``forward(images [B, H, W, C]) -> logits [B, num_classes]``
    float32.  ``param_dtype`` (default ``cfg.dtype``) holds the
    convolution and the blocks' dense layers; the CLS token, the
    positions, the norms and the head are float32.  ``TP_REGIONS``:
    GPT-2's two Megatron pairs a block over tp."""

    TP_REGIONS = True

    def __init__(self, cfg: ViTConfig, device=None, param_dtype=None):
        super().__init__()
        check_remat_policy(cfg)
        device = default_device(device)
        self.cfg = cfg
        pd = param_dtype or cfg.dtype
        h = cfg.hidden_size
        self.patch_embed = Conv(3, h, cfg.patch_size, cfg.patch_size,
                                dtype=cfg.dtype, param_dtype=pd,
                                device=device)
        self.cls = f32_param((1, 1, h), device, 0.0)
        self.pos_embed = f32_param((1, cfg.num_patches + 1, h), device,
                                   0.02)
        self.h = nn.ModuleList(ViTBlock(cfg, device, pd)
                               for _ in range(cfg.num_layers))
        self.ln_f = _layer_norm(cfg, device)
        self.head = Dense(h, cfg.num_classes, torch.float32, torch.float32,
                          device)

    @property
    def device(self) -> torch.device:
        return model_device(self)

    def forward(self, images, *, train: bool = False):
        del train
        cfg = self.cfg
        b = images.shape[0]
        x = images.to(cfg.dtype).permute(0, 3, 1, 2)   # NCHW view
        x = self.patch_embed(x).permute(0, 2, 3, 1).reshape(
            b, -1, cfg.hidden_size)
        cls = self.cls.to(cfg.dtype).expand(b, 1, cfg.hidden_size)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(cfg.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        for block in self.h:
            x = remat_call(block, cfg.remat_policy, x) if remat \
                else block(x)
        x = self.ln_f(x.float())
        return self.head(x[:, 0])
