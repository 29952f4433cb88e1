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
bf16 weight).  Served with int8 weights (``ops/quant.py``), ``wte``,
``wpe``, the dense layers and (at full width) the stacked LayerNorm
leaves dequantize where they are read: the quantized ``wte`` feeds
both the lookup and the tied head.  ``cfg.remat`` recomputes each
block in the backward (``torch.utils.checkpoint``, the counterpart of
``nn.remat``), keeping the outputs ``cfg.remat_policy`` names
(``layers.py``).  Under a serving mesh (``serving/meshed.py``) a block
runs its EXACT forward (:func:`attention`): the fused ``qkv`` is
split BY HEADS (shard ``r`` holds the q, k and v columns of heads
``[r * H / tp, (r + 1) * H / tp)``, a column permutation made once at
placement, so each shard's attention needs no gather before it; the
reference takes contiguous thirds and lets XLA reshard after its
``constrain``, the same values), each shard attends over its heads and
its own head shard of the cache, and the shards' outputs are
concatenated at the reference's ``constrain`` sites before ``o_proj``
and ``fc2`` (``fc1`` is column-split too when its width divides).
Parameter names follow the flax tree
(``wte``, ``wpe``, ``h.{i}.{ln1,qkv,o_proj,ln2,fc1,fc2}``, ``ln_f``) so
``convert.gpt2_state_dict_from_jax`` maps one onto the other.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from .. import default_device
from ..ops.attention import dot_product_attention
from ..parallel.constraints import BATCH, constrain, current_exact_mesh
from .kv_cache import KVCache, LayerCache, append_kv_cache
from .layers import (Dense, check_remat_policy, embed, model_device,
                     run_stack, tied_logits)


@dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    max_position: int = 1024
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # remat: recompute each block in the backward, keeping what the
    # named policy saves (layers.py; None = save nothing).
    remat: bool = False
    remat_policy: Optional[str] = None
    # The flax param layout (stacked [num_layers] vs h_{i}); the port
    # always holds a ModuleList, the converter reads either layout, and
    # ops.quant.quantize_params picks its scale axes by it.
    scan_layers: bool = True
    # Serve-time option: an int8 KV cache with per-(token, head) bf16
    # scales (generate.init_cache builds it; kv_cache.py appends to it).
    kv_cache_int8: bool = False

    @property
    def intermediate_size(self) -> int:
        return 4 * self.hidden_size

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


def qkv_rows_by_heads(hidden: int, tp: int) -> list:
    """Rows of a fused ``[3h, h]`` qkv weight for each of ``tp``
    shards: shard ``r`` takes the q, k and v rows of its own heads."""
    hs = hidden // tp
    return [torch.cat([torch.arange(j * hidden + r * hs,
                                    j * hidden + (r + 1) * hs)
                       for j in range(3)]) for r in range(tp)]


def attention(block: nn.Module, h, cache=None) -> torch.Tensor:
    """GPT-2's attention (``block.qkv``, ``cfg.num_heads``) over the
    ln1'd input ``h``: q/k/v projected, k/v appended to ``cache`` (a
    decode step) and the heads' output [..., hidden], before
    ``o_proj``.  Under a serving mesh each tensor-parallel shard
    projects its heads (the by-heads :class:`layers.ColumnShards`, or
    the whole ``qkv`` at tp = 1), appends to its shard of the cache (a
    ``ShardedLayerCache``) and attends on its device, and the heads are
    concatenated on the primary device (the ``constrain`` site before
    ``o_proj``).  Shared by MoE-GPT's blocks."""
    group = current_exact_mesh()
    if group is None:
        return _attend_heads(block.cfg, block.qkv(h), cache)
    qkv = group.shards_of(block)["qkv"]
    return constrain([
        _attend_heads(block.cfg,
                      block.qkv(h) if qkv is None else qkv.shard(r, h),
                      None if cache is None else cache.shards[r])
        for r in range(group.tp)], BATCH, None, "tp")


def _attend_heads(cfg, qkv, cache) -> torch.Tensor:
    """Attention over a [..., 3 * heads * D] projection (all heads, or
    one shard's: its q, k and v thirds) -> [..., heads * D]."""
    hd = cfg.hidden_size // cfg.num_heads
    q, k, v = (t.unflatten(-1, (-1, hd)) for t in qkv.chunk(3, dim=-1))
    mask = None
    if cache is not None:
        k, v, mask, _ = append_kv_cache(cache, k, v)
    return dot_product_attention(q, k, v, causal=cache is None,
                                 mask=mask).flatten(-2)


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

    def place_exact(self, placer) -> dict:
        """This block's column shards on a serving mesh group
        (``serving/meshed.py``): ``qkv`` by heads, ``fc1`` in contiguous
        blocks; None where the mesh keeps the weight whole."""
        return {"qkv": placer.columns(
                    "qkv", self.qkv,
                    qkv_rows_by_heads(self.cfg.hidden_size, placer.tp)),
                "fc1": placer.columns("fc1", self.fc1)}

    def forward(self, x, cache: Optional[LayerCache] = None):
        """``cache`` given: a KV-cache step (prefill chunk or one decode
        token) appending at ``cache.index``; else the causal
        full-sequence forward.  Under a serving mesh: the exact
        sharded forward (module docstring)."""
        cfg = self.cfg
        h = self.ln1(x.float()).to(cfg.dtype)
        x = x + self.o_proj(attention(self, h, cache))
        h = self.ln2(x.float()).to(cfg.dtype)
        return x + self.fc2(self._fc1_gelu(h))

    def _fc1_gelu(self, h):
        """``gelu(fc1(h))``: under a serving mesh, each column shard's on
        its device, concatenated on the primary before ``fc2``."""
        group = current_exact_mesh()
        fc1 = None if group is None else group.shards_of(self)["fc1"]
        if fc1 is None:
            return F.gelu(self.fc1(h), approximate="tanh")
        return constrain([F.gelu(fc1.shard(r, h), approximate="tanh")
                          for r in range(group.tp)], BATCH, None, "tp")


class GPT2Model(nn.Module):
    """``embed_tokens`` / ``run_blocks`` / ``head`` compose ``forward``,
    as in the reference.  ``param_dtype`` (default ``cfg.dtype``) is the
    type the parameters are held in.  ``TP_REGIONS``: over a training
    mesh's tp axis (``strategies.shard_tensors``) each block is a
    Megatron pair twice: ``qkv`` (by heads) then ``o_proj``, ``fc1``
    then ``fc2``; attention runs on the rank's local heads."""

    TP_REGIONS = True

    def __init__(self, cfg: GPT2Config, device=None, param_dtype=None):
        super().__init__()
        check_remat_policy(cfg)
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
        return model_device(self)

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
        return embed(self.wte, input_ids, dtype) + embed(self.wpe, pos,
                                                         dtype)

    def run_blocks(self, x, cache: Optional[KVCache] = None):
        return run_stack(self.h, self.cfg, x, cache)

    def head(self, x):
        dtype = self.cfg.dtype
        x = self.ln_f(x.float()).to(dtype)
        return tied_logits(x, self.wte, dtype).float()

    def forward(self, input_ids, *, train: bool = False,
                decode: bool = False,
                decode_position: Union[int, torch.Tensor, None] = None,
                last_only: bool = False,
                cache: Optional[KVCache] = None):
        """Logits [B, S, V] in f32.  ``train`` is the reference's flag:
        GPT-2 has no dropout, so it changes nothing.  ``decode_position``
        is an int, or a [B] tensor with a slot cache (each row's chunk at
        its own position: one decode token, or a speculative round's
        K + 1 verify tokens)."""
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
