"""BERT, in PyTorch: the BASELINE's configuration 3 (MLM pretraining).

Port of ``polyaxon_tpu/models/bert.py``: token, position and (given
``token_type_ids``) type embeddings, ``ln_embed`` in float32, post-LN
encoder layers (fused ``qkv``, non-causal attention through
``ops.attention.dot_product_attention``, so the flash kernels run on
the card; a key-padding ``attention_mask`` becomes the kernels'
``kv_mask``), and an MLM head decoding through the tied embedding plus
a float32 ``mlm_bias``.  GELU is tanh-approximate unless
``gelu_approximate=False`` (HF's exact form, set by ``--init-hf``).
The dtype placement is the flax modules': dense layers and embeddings
in ``cfg.dtype`` on parameters held in ``param_dtype`` (float32 masters
for training), LayerNorms in float32.  ``cfg.remat`` recomputes each
layer in the backward (the reference's ``nn.remat`` has no policy
here).

Parameter names follow the flax tree (``embed``, ``pos_embed``,
``type_embed``, ``ln_embed``, ``layers.{i}.{attn.{qkv,o_proj},ln_attn,
fc1,fc2,ln_mlp}``, ``mlm_dense``, ``mlm_ln``, ``mlm_bias``), so
``convert.bert_state_dict_from_jax`` reads the scanned
``layers/layer/...`` leaves (leading ``[num_layers]`` axis) or the
unrolled ``layer_{i}`` ones.  The reference creates ``type_embed`` only
when a call passes ``token_type_ids``; the port always holds it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import default_device
from ..ops.attention import dot_product_attention
from .layers import Dense, embed, model_device, remat_call, tied_logits


@dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    gelu_approximate: bool = True
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False
    # The flax param layout (scanned vs layer_{i}); the port always
    # holds a ModuleList and the converter reads either layout.
    scan_layers: bool = True

    @staticmethod
    def base() -> "BertConfig":
        return BertConfig()

    @staticmethod
    def tiny() -> "BertConfig":
        return BertConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                          num_heads=4, intermediate_size=128,
                          max_position=128)


def _layer_norm(cfg: BertConfig, device) -> nn.LayerNorm:
    return nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                        dtype=torch.float32, device=device)


def _gelu(cfg: BertConfig, x):
    return F.gelu(x, approximate="tanh" if cfg.gelu_approximate
                  else "none")


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, device, pd):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.qkv = Dense(h, 3 * h, cfg.dtype, pd, device)
        self.o_proj = Dense(h, h, cfg.dtype, pd, device)

    def forward(self, x, mask):
        cfg = self.cfg
        # -1 heads: all of them, or a tp rank's (qkv split by heads).
        shape = x.shape[:-1] + (-1, cfg.hidden_size // cfg.num_heads)
        q, k, v = (t.reshape(shape) for t in self.qkv(x).chunk(3, dim=-1))
        out = dot_product_attention(q, k, v, mask=mask, causal=False)
        return self.o_proj(out.flatten(-2))


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, device, pd):
        super().__init__()
        self.cfg = cfg
        self.attn = BertSelfAttention(cfg, device, pd)
        self.ln_attn = _layer_norm(cfg, device)
        self.fc1 = Dense(cfg.hidden_size, cfg.intermediate_size, cfg.dtype,
                         pd, device)
        self.fc2 = Dense(cfg.intermediate_size, cfg.hidden_size, cfg.dtype,
                         pd, device)
        self.ln_mlp = _layer_norm(cfg, device)

    def forward(self, x, mask):
        # Post-LN, as in the original encoder; the residual sums in the
        # operands' promoted type, as flax's.
        x = self.ln_attn((x + self.attn(x, mask)).float())
        h = self.fc2(_gelu(self.cfg, self.fc1(x)))
        return self.ln_mlp(x + h).to(self.cfg.dtype)


class BertModel(nn.Module):
    """Encoder with the tied MLM head.  ``param_dtype`` (default
    ``cfg.dtype``) is the type the parameters are held in.
    ``TP_REGIONS``: GPT-2's two Megatron pairs a layer over tp."""

    TP_REGIONS = True

    def __init__(self, cfg: BertConfig, device=None, param_dtype=None):
        super().__init__()
        device = default_device(device)
        self.cfg = cfg
        pd = param_dtype or cfg.dtype
        h = cfg.hidden_size

        def embed(rows):
            return nn.Embedding(rows, h, dtype=pd, device=device)

        self.embed = embed(cfg.vocab_size)
        self.pos_embed = embed(cfg.max_position)
        self.type_embed = embed(cfg.type_vocab_size)
        self.ln_embed = _layer_norm(cfg, device)
        self.layers = nn.ModuleList(BertLayer(cfg, device, pd)
                                    for _ in range(cfg.num_layers))
        self.mlm_dense = Dense(h, h, cfg.dtype, pd, device)
        self.mlm_ln = _layer_norm(cfg, device)
        self.mlm_bias = nn.Parameter(torch.zeros(
            cfg.vocab_size, dtype=torch.float32, device=device))

    @property
    def device(self) -> torch.device:
        return model_device(self)

    def forward(self, input_ids, *, token_type_ids=None,
                attention_mask: Optional[torch.Tensor] = None,
                train: bool = False):
        """MLM logits [B, S, V] in float32.  ``attention_mask`` [B, S]:
        nonzero = a real token (keys elsewhere are masked out)."""
        del train
        cfg, dt = self.cfg, self.cfg.dtype
        pos = torch.arange(input_ids.shape[-1], device=input_ids.device)
        x = embed(self.embed, input_ids, dt) + embed(self.pos_embed, pos, dt)
        if token_type_ids is not None:
            x = x + embed(self.type_embed, token_type_ids, dt)
        x = self.ln_embed(x.float()).to(dt)
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].to(torch.bool)
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            x = remat_call(layer, None, x, mask) if remat \
                else layer(x, mask)
        h = self.mlm_ln(_gelu(cfg, self.mlm_dense(x)).float())
        return tied_logits(h.to(dt), self.embed, dt).float() + self.mlm_bias
