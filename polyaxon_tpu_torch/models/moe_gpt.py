"""MoE-GPT: a GPT-2-style decoder whose FFN is a top-1 (switch) mixture
of experts, in PyTorch.

Port of ``polyaxon_tpu/models/moe_gpt.py`` on one device.  Attention,
the embeddings, the LayerNorms and the tied head are GPT-2's
(``gpt2.py``): causal attention through
``ops.attention.dot_product_attention`` (the flash kernels on the card),
the KV cache of ``kv_cache.py`` in decode (int8 under
``kv_cache_int8``).  The router and the experts are float32 parameters
computed in float32 whatever ``cfg.dtype`` is, as the reference declares
them; the FFN's output is cast to ``cfg.dtype``.

The FFN has three paths, the reference's, each a function of the same
routing (``parallel.moe.route_top1``):

- training (no cache): switch routing with capacity
  ``int(capacity_factor * tokens / experts)``.  The reference contracts
  [T, E, C] one-hot dispatch and combine tensors with einsums; here each
  token is scattered by index into its expert's [C, d] bucket (its
  position in the expert's queue, counted over the batch's tokens in
  order), the experts run as two batched products, and each kept token
  gathers its row back times its gate; a token past capacity gets 0.
  Each output of the einsum form has exactly one non-zero term, so the
  two are the same function.  The load-balance loss is
  ``E * sum(fraction * mean prob)``;
- one decode token (a cache and one position): each token gathers only
  its routed expert's weights;
- a prefill chunk (a cache and more positions): the training path at
  a capacity of the chunk's length, so no token drops (aux 0).

Decode and prefill run inside CUDA graphs: no host read, no
data-dependent shape.  The model returns ``(logits, aux)``, ``aux`` the
mean of the layers' load-balance losses (0 in decode).  Expert
parallelism over a mesh (the reference's ``moe_layer``) is refused by
the parallelism item.  Parameter names follow the flax tree (``wte``,
``wpe``, ``h.{i}.{ln1,qkv,o_proj,ln2,moe.{router,experts_w1,
experts_w2}}``, ``ln_f``), the router ``[d, E]`` and the experts
``[E, d, f]`` / ``[E, f, d]`` in the reference's layout, so
``convert.moe_gpt_state_dict_from_jax`` maps one onto the other.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from .. import default_device
from ..ops.attention import dot_product_attention
from ..parallel.moe import load_balance_loss, route_top1
from .kv_cache import KVCache, LayerCache, append_kv_cache
from .layers import Dense, f32_param, model_device, remat_call


@dataclass(frozen=True)
class MoEGPTConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_experts: int = 8
    capacity_factor: float = 1.25
    aux_weight: float = 0.01
    max_position: int = 1024
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False
    # Serve-time option: an int8 KV cache with per-(token, head) bf16
    # scales (generate.init_cache builds it).
    kv_cache_int8: bool = False

    @property
    def intermediate_size(self) -> int:
        return 4 * self.hidden_size

    @staticmethod
    def small() -> "MoEGPTConfig":
        return MoEGPTConfig()  # gpt2-small dims x 8 experts (~0.6B total)

    @staticmethod
    def tiny() -> "MoEGPTConfig":
        return MoEGPTConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                            num_heads=4, num_experts=4, max_position=128)


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # flax nn.gelu's default


def _experts(buckets, w1, w2):
    """Every expert's FFN over its bucket rows, float32: [E, N, d] ->
    [E, N, d]."""
    return torch.bmm(_gelu(torch.bmm(buckets, w1.float())), w2.float())


def switch_ffn_decode(flat, router_w, w1, w2):
    """One token per row: gather only each token's routed expert's
    weights.  flat [T, d] -> ([T, d] float32, aux 0)."""
    x32 = flat.float()
    _, expert, gate, _ = route_top1(x32 @ router_w.float())
    h = _gelu(torch.bmm(x32[:, None, :], w1.float()[expert]))
    out = torch.bmm(h, w2.float()[expert])[:, 0]
    return out * gate[:, None], x32.new_zeros(())


def switch_ffn_train(flat, router_w, w1, w2, capacity: int):
    """Top-1 with ``capacity`` rows an expert, by index: the function
    of the reference's one-hot einsums (``_switch_ffn_dense``).  A
    token past its expert's capacity lands in a spare row that no
    expert reads and gets 0.  Returns ([T, d] float32, aux)."""
    t, d = flat.shape
    e = router_w.shape[-1]
    x32 = flat.float()
    probs, expert, gate, pos = route_top1(x32 @ router_w.float())
    keep = pos < capacity
    n = e * capacity
    rows = torch.where(keep, expert * capacity + pos, n)
    buckets = x32.new_zeros(n + 1, d).index_copy(0, rows, x32)[:n]
    out = _experts(buckets.view(e, capacity, d), w1, w2).reshape(n, d)
    out = torch.where(keep[:, None],
                      out[rows.clamp(max=n - 1)] * gate[:, None], 0.0)
    return out, load_balance_loss(probs, expert)


class MoEMlp(nn.Module):
    """The switch FFN: router ``[d, E]`` and experts ``[E, d, f]`` /
    ``[E, f, d]``, all float32."""

    def __init__(self, cfg: MoEGPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, e, f = cfg.hidden_size, cfg.num_experts, cfg.intermediate_size
        self.router = f32_param((d, e), device, 0.02)
        self.experts_w1 = f32_param((e, d, f), device, 0.02)
        self.experts_w2 = f32_param((e, f, d), device, 0.02)

    def forward(self, x, decode: bool = False):
        cfg = self.cfg
        b, s, d = x.shape
        flat = x.reshape(b * s, d)
        w = (self.router, self.experts_w1, self.experts_w2)
        if decode and s == 1:
            out, aux = switch_ffn_decode(flat, *w)
        elif decode:
            # A prefill chunk: drop-free, capacity = the chunk's tokens.
            out, _ = switch_ffn_train(flat, *w, capacity=b * s)
            aux = out.new_zeros(())
        else:
            capacity = max(1, int(cfg.capacity_factor * b * s
                                  / cfg.num_experts))
            out, aux = switch_ffn_train(flat, *w, capacity)
        return out.reshape(x.shape).to(cfg.dtype), aux


def _layer_norm(cfg: MoEGPTConfig, device) -> nn.LayerNorm:
    return nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                        dtype=torch.float32, device=device)


class MoEBlock(nn.Module):
    """Pre-LN decoder block: GPT-2's attention + the switch FFN.
    Returns (x, aux)."""

    def __init__(self, cfg: MoEGPTConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        pd = param_dtype or cfg.dtype
        self.ln1 = _layer_norm(cfg, device)
        self.qkv = Dense(h, 3 * h, cfg.dtype, pd, device)
        self.o_proj = Dense(h, h, cfg.dtype, pd, device)
        self.ln2 = _layer_norm(cfg, device)
        self.moe = MoEMlp(cfg, device)

    def forward(self, x, cache: Optional[LayerCache] = None):
        cfg = self.cfg
        h = self.ln1(x.float()).to(cfg.dtype)
        q, k, v = self.qkv(h).split(cfg.hidden_size, dim=-1)
        shape = h.shape[:-1] + (cfg.num_heads,
                                cfg.hidden_size // cfg.num_heads)
        q, k, v = (t.reshape(shape) for t in (q, k, v))
        mask = None
        if cache is not None:
            k, v, mask, _ = append_kv_cache(cache, k, v)
        a = dot_product_attention(q, k, v, causal=cache is None, mask=mask)
        x = x + self.o_proj(a.reshape(h.shape))
        h = self.ln2(x.float()).to(cfg.dtype)
        ffn, aux = self.moe(h, decode=cache is not None)
        return x + ffn, aux


class MoEGPTModel(nn.Module):
    """``forward(input_ids) -> (logits [B, S, V] float32, aux)``.
    ``param_dtype`` (default ``cfg.dtype``) holds the dense layers and
    embeddings; the router and experts are float32 always."""

    def __init__(self, cfg: MoEGPTConfig, device=None, param_dtype=None):
        super().__init__()
        device = default_device(device)
        self.cfg = cfg
        pd = param_dtype or cfg.dtype
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                dtype=pd, device=device)
        self.wpe = nn.Embedding(cfg.max_position, cfg.hidden_size,
                                dtype=pd, device=device)
        self.h = nn.ModuleList(MoEBlock(cfg, device, pd)
                               for _ in range(cfg.num_layers))
        self.ln_f = _layer_norm(cfg, device)

    @property
    def device(self) -> torch.device:
        return model_device(self)

    def embed_tokens(self, input_ids,
                     position: Union[int, torch.Tensor, None] = None):
        """As GPT-2's: ``position`` an int or a [B] tensor (a slot
        cache's rows)."""
        pos = torch.arange(input_ids.shape[-1], device=input_ids.device)
        if isinstance(position, torch.Tensor):
            pos = pos[None, :] + position[:, None]
        elif position is not None:
            pos = pos + position
        dtype = self.cfg.dtype
        return (F.embedding(input_ids, self.wte.weight.to(dtype))
                + F.embedding(pos, self.wpe.weight.to(dtype)))

    def run_blocks(self, x, cache: Optional[KVCache] = None):
        """The layer stack with the summed aux carry: each block
        recomputed in the backward under ``cfg.remat`` (training), or
        appending to ``cache`` (decode)."""
        remat = self.cfg.remat and cache is None and torch.is_grad_enabled()
        aux = x.new_zeros((), dtype=torch.float32)
        for i, block in enumerate(self.h):
            if remat:
                x, a = remat_call(block, None, x)
            else:
                x, a = block(x, None if cache is None else cache.layer(i))
            aux = aux + a
        if cache is not None:
            cache.advance(x.shape[1])
        return x, aux

    def head(self, x):
        dtype = self.cfg.dtype
        x = self.ln_f(x.float()).to(dtype)
        return F.linear(x, self.wte.weight.to(dtype)).float()

    def forward(self, input_ids, *, train: bool = False,
                decode: bool = False,
                decode_position: Union[int, torch.Tensor, None] = None,
                last_only: bool = False,
                cache: Optional[KVCache] = None):
        del train
        if decode and decode_position is None:
            raise ValueError(
                "MoE-GPT decode needs decode_position (learned wpe; "
                "generate() supplies it)")
        if decode and cache is None:
            raise ValueError("MoE-GPT decode needs a KV cache "
                             "(generate.init_cache)")
        x = self.embed_tokens(
            input_ids, position=decode_position if decode else None)
        x, aux = self.run_blocks(x, cache=cache if decode else None)
        if last_only:
            x = x[:, -1:]
        return self.head(x), aux / self.cfg.num_layers
