"""GPT-2 — the flagship decoder, in PyTorch.

Port of ``polyaxon_tpu/models/gpt2.py`` (and of ``scan_stack.py``, whose
rolled layer stack becomes an ``nn.ModuleList``).  The dtype placement
mirrors the flax modules: LayerNorm in f32 then cast to ``cfg.dtype``;
dense layers, the embeddings and the residual stream in ``cfg.dtype``;
GELU in its tanh form (flax's default); the LM head tied to ``wte`` in
``cfg.dtype`` and returned as f32.  Parameters are held in
``param_dtype``: ``cfg.dtype`` for serving, float32 for training, where
each weight is cast to ``cfg.dtype`` at its use as flax's ``Dense`` and
``Embed`` do (an AdamW step of about 1e-3 x lr would round away on a
bf16 weight).  ``cfg.remat`` recomputes each block in the backward
(``torch.utils.checkpoint``, the counterpart of ``nn.remat`` with no
policy).  Sharding hints have no meaning on one device and are
dropped.  Parameter names follow the flax tree
(``wte``, ``wpe``, ``h.{i}.{ln1,qkv,o_proj,ln2,fc1,fc2}``, ``ln_f``) so
``convert.gpt2_state_dict_from_jax`` maps one onto the other.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import default_device
from ..ops.attention import dot_product_attention
from .kv_cache import KVCache, LayerCache, append_kv_cache


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    max_position: int = 1024
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # remat: recompute each block in the backward.  Named policies and the
    # int8 KV cache are not ported yet and are refused.
    remat: bool = False
    remat_policy: Optional[str] = None
    # The flax param layout (stacked [num_layers] vs h_{i}); the port
    # always holds a ModuleList and the converter reads either layout.
    scan_layers: bool = True
    kv_cache_int8: bool = False

    @property
    def intermediate_size(self) -> int:
        return 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def medium() -> "GPT2Config":
        return GPT2Config()  # 1024h/24L/16H == gpt2-medium (~355M)

    @staticmethod
    def small() -> "GPT2Config":
        return GPT2Config(hidden_size=768, num_layers=12, num_heads=12)

    @staticmethod
    def mini() -> "GPT2Config":
        # f32 like the reference's mini: a random-init model's greedy
        # argmax must not tie at one bf16 ulp.
        return GPT2Config(vocab_size=4096, hidden_size=256,
                          num_layers=4, num_heads=8, max_position=512,
                          dtype=torch.float32)

    @staticmethod
    def tiny() -> "GPT2Config":
        return GPT2Config(vocab_size=1024, hidden_size=64, num_layers=2,
                          num_heads=4, max_position=128)


def _layer_norm(cfg: GPT2Config, device) -> nn.LayerNorm:
    return nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                        dtype=torch.float32, device=device)


class Dense(nn.Linear):
    """``nn.Linear`` holding its parameters in ``param_dtype`` and
    computing in ``dtype`` (flax ``Dense(dtype=...)``)."""

    def __init__(self, n_in: int, n_out: int, dtype, param_dtype, device):
        super().__init__(n_in, n_out, dtype=param_dtype, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.linear(x, self.weight.to(self.compute_dtype),
                        self.bias.to(self.compute_dtype))


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None, param_dtype=None):
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

    def forward(self, x, cache: Optional[LayerCache] = None):
        """``cache`` given: a KV-cache step (prefill chunk or one decode
        token) appending at ``cache.index``; else the causal
        full-sequence forward."""
        cfg = self.cfg
        h = self.ln1(x.float()).to(cfg.dtype)
        qkv = self.qkv(h)
        q, k, v = qkv.split(cfg.hidden_size, dim=-1)
        shape = h.shape[:-1] + (cfg.num_heads, cfg.head_dim)
        q, k, v = (t.reshape(shape) for t in (q, k, v))
        mask = None
        if cache is not None:
            k, v, mask, _ = append_kv_cache(cache, k, v)
        a = dot_product_attention(q, k, v, causal=cache is None,
                                  mask=mask)
        x = x + self.o_proj(a.reshape(h.shape))
        h = self.ln2(x.float()).to(cfg.dtype)
        h = self.fc2(F.gelu(self.fc1(h), approximate="tanh"))
        return x + h


class GPT2Model(nn.Module):
    """``embed_tokens`` / ``run_blocks`` / ``head`` compose ``forward``,
    as in the reference.  ``param_dtype`` (default ``cfg.dtype``) is the
    type the parameters are held in."""

    def __init__(self, cfg: GPT2Config, device=None, param_dtype=None):
        super().__init__()
        if cfg.kv_cache_int8:
            raise NotImplementedError(
                "kv_cache_int8 comes with the int8 slice of the port")
        if cfg.remat and cfg.remat_policy is not None:
            raise NotImplementedError(
                f"remat_policy={cfg.remat_policy!r}: named remat policies "
                f"are not ported yet; remat=True with remat_policy=None "
                f"recomputes whole blocks")
        device = default_device(device)
        self.cfg = cfg
        pd = param_dtype or cfg.dtype
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                dtype=pd, device=device)
        self.wpe = nn.Embedding(cfg.max_position, cfg.hidden_size,
                                dtype=pd, device=device)
        self.h = nn.ModuleList(GPT2Block(cfg, device, pd)
                               for _ in range(cfg.num_layers))
        self.ln_f = _layer_norm(cfg, device)

    @property
    def device(self) -> torch.device:
        return self.wte.weight.device

    def embed_tokens(self, input_ids,
                     position: Union[int, torch.Tensor, None] = None):
        """``position``: the absolute position of token 0 (decode) — one
        int for the batch, or a [B] tensor, one per row (the slot pool;
        ``wpe`` is then gathered per row, with no host read)."""
        pos = torch.arange(input_ids.shape[-1], device=input_ids.device)
        if isinstance(position, torch.Tensor):
            pos = pos[None, :] + position[:, None]
        elif position is not None:
            pos = pos + position
        dtype = self.cfg.dtype
        return (F.embedding(input_ids, self.wte.weight.to(dtype))
                + F.embedding(pos, self.wpe.weight.to(dtype)))

    def run_blocks(self, x, cache: Optional[KVCache] = None):
        remat = self.cfg.remat and cache is None and torch.is_grad_enabled()
        for i, block in enumerate(self.h):
            if remat:
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x, None if cache is None else cache.layer(i))
        if cache is not None and cache.positions is None:
            # A slot cache's positions are advanced by its owner.
            cache.index += x.shape[1]
        return x

    def head(self, x):
        dtype = self.cfg.dtype
        x = self.ln_f(x.float()).to(dtype)
        return F.linear(x, self.wte.weight.to(dtype)).float()

    def forward(self, input_ids, *, train: bool = False,
                decode: bool = False,
                decode_position: Union[int, torch.Tensor, None] = None,
                last_only: bool = False,
                cache: Optional[KVCache] = None):
        """Logits [B, S, V] in f32.  ``train`` is the reference's flag:
        GPT-2 has no dropout, so it changes nothing.  ``decode_position``
        is an int, or a [B] tensor with a slot cache (one token per row,
        each at its own position)."""
        del train
        if decode and decode_position is None:
            # GPT-2's learned wpe needs the absolute position — omitting
            # it would silently give every token position 0.
            raise ValueError(
                "GPT-2 decode needs decode_position (the absolute "
                "position of this token; generate() supplies it)")
        if decode and cache is None:
            raise ValueError("GPT-2 decode needs a KV cache "
                             "(generate.init_cache)")
        x = self.embed_tokens(
            input_ids, position=decode_position if decode else None)
        x = self.run_blocks(x, cache=cache if decode else None)
        if last_only:  # prefill: one row of logits, not [B, P, V]
            x = x[:, -1:]
        return self.head(x)
