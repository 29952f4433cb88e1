"""Llama-family decoder, in PyTorch: RMSNorm, RoPE, SwiGLU, grouped-query
attention and an optional sliding window (Mistral).

Port of ``polyaxon_tpu/models/llama.py`` in the idiom of ``gpt2.py``:
the scanned layer stack becomes an ``nn.ModuleList``, parameters are
held in ``param_dtype`` (float32 masters for training) and cast to
``cfg.dtype`` at their use, and ``cfg.remat`` recomputes each block in
the backward (``torch.utils.checkpoint``).  RMSNorm runs in float32 and
its output is cast to ``cfg.dtype``; the LM head is an untied
``lm_head`` with no bias (or the embedding, with ``tie_embeddings``),
and the logits are float32.

GQA: the K/V projections and the decode cache are at ``num_kv_heads``;
each KV head is repeated consecutively up to the query head count
(``[h0, h0, h1, h1]``, the reference's ``jnp.repeat``) right before
attention, so the flash kernels see full-width K/V, and autograd of the
repeat sums their dK/dV back to the KV heads.  RoPE: the full forward
rotates q and k at ``arange(S)``; a decode step rotates the new keys
inside the cache append, at the cache's absolute positions (per row on
a slot cache, read on the device), and q at the positions the append
returns.  Parameter names follow the flax tree (``embed``,
``h.{i}.{input_norm,attn.{q,k,v,o}_proj,post_attn_norm,gate_proj,
up_proj,down_proj}``, ``final_norm``, ``lm_head``) so
``convert.llama_state_dict_from_jax`` maps one onto the other.

Under a serving mesh (``serving/meshed.py``) each block runs its EXACT
forward: shard ``r`` of ``tp`` projects the q heads and the KV heads
``[r * kv / tp, (r + 1) * kv / tp)`` (the q heads that share them, so
the KV repeat stays on the shard), rotates and appends to its own head
shard of the cache, attends there, and the heads are concatenated on
the primary device before ``o_proj``; ``gate_proj`` / ``up_proj`` are
column-split when their width divides and concatenated before
``down_proj``.

Serving options: int8 weights (``ops/quant.py``: the embedding, the
dense layers, ``lm_head`` and, at full width, the stacked norm scales
dequantize where they are read), the int8 KV cache (``kv_cache_int8``)
and, for a sliding-window model, the O(window) ring cache
(``kv_cache_ring``), whose sessions run past ``max_position``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import default_device
from ..ops.attention import dot_product_attention
from ..ops.rotary import rotate
from ..parallel.constraints import BATCH, constrain, current_exact_mesh
from .layers import (Dense, check_remat_policy, embed, model_device,
                     run_stack, tied_logits)
from .kv_cache import (KVCache, LayerCache, append_kv_cache,
                       append_ring_kv_cache)


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_layers: int = 22
    num_heads: int = 32
    num_kv_heads: int = 4
    max_position: int = 2048
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    # Sliding-window (local) attention: position i attends to
    # [i-window, i], window+1 keys.  None = full causal attention.
    sliding_window: Optional[int] = None
    dtype: torch.dtype = torch.bfloat16
    tie_embeddings: bool = False
    remat: bool = False
    remat_policy: Optional[str] = None
    # The flax param layout (stacked [num_layers] vs h_{i}); the port
    # always holds a ModuleList and the converter reads either layout.
    scan_layers: bool = True
    # Serve-time option: store the decode KV cache as int8 with
    # per-(token, head) bf16 scales (kv_cache.py).
    kv_cache_int8: bool = False
    # Serve-time option for sliding-window models: an O(window) RING
    # cache instead of O(max_position), so sessions stream past
    # max_position (RoPE needs no table); kv_cache.append_ring_kv_cache.
    kv_cache_ring: bool = False
    # Extra ring slots beyond window + 1: speculative decoding with
    # draft length k needs >= k - 1 (generate_speculative enforces it);
    # plain decoding needs 0.
    kv_cache_ring_slack: int = 0

    def __post_init__(self):
        if self.sliding_window is not None and self.sliding_window < 1:
            raise ValueError(
                f"sliding_window must be >= 1 or None; got "
                f"{self.sliding_window} (0 would silently disable "
                "windowing)")
        if self.kv_cache_ring and self.sliding_window is None:
            raise ValueError(
                "kv_cache_ring requires sliding_window (a full-"
                "attention model needs every past position — there is "
                "no window to ring over)")
        if self.num_heads % self.num_kv_heads:
            raise ValueError(
                f"num_heads ({self.num_heads}) must be divisible by "
                f"num_kv_heads ({self.num_kv_heads}) for GQA sharing")
        if self.hidden_size % self.num_heads:
            raise ValueError(
                f"hidden_size ({self.hidden_size}) must be divisible "
                f"by num_heads ({self.num_heads})")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def tinyllama() -> "LlamaConfig":
        # TinyLlama-1.1B dims; remat as the reference's config sets it.
        return LlamaConfig(remat=True)

    @staticmethod
    def tiny() -> "LlamaConfig":
        return LlamaConfig(vocab_size=512, hidden_size=64,
                           intermediate_size=128, num_layers=2,
                           num_heads=4, num_kv_heads=2, max_position=128)


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm(dtype=float32)``: ``x * rsqrt(mean(x^2) + eps)
    * scale`` on float32, the scale held in float32."""

    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                              device=device))

    def forward(self, x):
        x = x.to(torch.float32)
        ms = x.square().mean(-1, keepdim=True)
        return x * torch.rsqrt(ms + self.eps) * self.weight


def _dense(cfg: LlamaConfig, n_in: int, n_out: int, param_dtype,
           device) -> Dense:
    """flax ``nn.Dense(use_bias=False, dtype=cfg.dtype)``."""
    return Dense(n_in, n_out, cfg.dtype, param_dtype or cfg.dtype, device,
                 bias=False)


_QKV = ("q_proj", "k_proj", "v_proj")


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        h, hd = cfg.hidden_size, cfg.head_dim
        self.q_proj = _dense(cfg, h, cfg.num_heads * hd, param_dtype, device)
        self.k_proj = _dense(cfg, h, cfg.num_kv_heads * hd, param_dtype,
                             device)
        self.v_proj = _dense(cfg, h, cfg.num_kv_heads * hd, param_dtype,
                             device)
        self.o_proj = _dense(cfg, cfg.num_heads * hd, h, param_dtype, device)

    def forward(self, x, cache: Optional[LayerCache] = None,
                shards: Optional[dict] = None):
        """``cache`` given: a KV-cache step (prefill chunk or one decode
        token per row); else the causal (windowed) full forward.
        ``shards`` (under a serving mesh, :meth:`place_exact`'s): each
        shard's heads attend over its own shard of the cache (a
        ``ShardedLayerCache``) on its device, and the heads are
        concatenated on the primary device before ``o_proj``."""
        if shards is None:
            return self.o_proj(self._heads(x, cache))
        group = current_exact_mesh()
        return self.o_proj(constrain([
            self._heads(x, None if cache is None else cache.shards[r],
                        shards, r)
            for r in range(group.tp)], BATCH, None, "tp"))

    def place_exact(self, placer) -> dict:
        """q/k/v column shards in contiguous head blocks (shard ``r``'s
        q heads are those sharing its KV heads)."""
        return {n: placer.columns(f"attn.{n}", getattr(self, n))
                for n in _QKV}

    def _heads(self, x, cache, shards=None, r: int = 0):
        """The attention of ``x``'s q/k/v projections (all heads, or
        shard ``r``'s of the column ``shards``) -> [B, S, heads * D]."""
        b, s = x.shape[:2]
        q, k, v = (getattr(self, n)(x) if shards is None or shards[n] is None
                   else shards[n].shard(r, x) for n in _QKV)
        hd = self.cfg.head_dim
        a = self._attend(q.view(b, s, -1, hd), k.view(b, s, -1, hd),
                         v.view(b, s, -1, hd), cache)
        return a.reshape(b, s, -1)

    def _attend(self, q, k, v, cache: Optional[LayerCache]):
        """RoPE, the cache append, the GQA repeat and attention over
        [B, S, heads, D] projections (all heads, or one shard's)."""
        cfg = self.cfg
        s = q.shape[1]
        theta = cfg.rope_theta
        mask = None
        if cache is None:
            pos = torch.arange(s, device=q.device)
            q, k = rotate(q, pos, theta=theta), rotate(k, pos, theta=theta)
        else:
            # Keys rotate at their absolute positions inside the append
            # (stored rotated, and quantized after the rotation on an
            # int8 cache); q at the positions it returns.
            rot = lambda p, kk: rotate(kk, p, theta=theta)  # noqa: E731
            if cfg.kv_cache_ring:
                # O(window) ring: unbounded streaming decode.
                k, v, mask, pos = append_ring_kv_cache(
                    cache, k, v, cfg.sliding_window, rotate=rot)
            else:
                k, v, mask, pos = append_kv_cache(
                    cache, k, v, window=cfg.sliding_window, rotate=rot)
            q = rotate(q, pos, theta=theta)
        if cfg.num_kv_heads != cfg.num_heads:
            rep = cfg.num_heads // cfg.num_kv_heads
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        return dot_product_attention(
            q, k, v, causal=cache is None, mask=mask,
            window=None if cache is not None else cfg.sliding_window)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, param_dtype=None):
        super().__init__()
        self.cfg = cfg
        h, inter = cfg.hidden_size, cfg.intermediate_size
        self.input_norm = RMSNorm(h, cfg.rms_norm_eps, device)
        self.attn = LlamaAttention(cfg, device, param_dtype)
        self.post_attn_norm = RMSNorm(h, cfg.rms_norm_eps, device)
        self.gate_proj = _dense(cfg, h, inter, param_dtype, device)
        self.up_proj = _dense(cfg, h, inter, param_dtype, device)
        self.down_proj = _dense(cfg, inter, h, param_dtype, device)

    def place_exact(self, placer) -> dict:
        """The attention's shards and the column-split ``gate_proj`` /
        ``up_proj`` (None each where the mesh keeps it whole)."""
        return {"attn": self.attn.place_exact(placer),
                "gate_proj": placer.columns("gate_proj", self.gate_proj),
                "up_proj": placer.columns("up_proj", self.up_proj)}

    def forward(self, x, cache: Optional[LayerCache] = None):
        dtype = self.cfg.dtype
        group = current_exact_mesh()
        sh = None if group is None else group.shards_of(self)
        x = x + self.attn(self.input_norm(x).to(dtype), cache,
                          None if sh is None else sh["attn"])
        h = self.post_attn_norm(x).to(dtype)
        gate = up = None
        if sh is not None:
            gate, up = sh["gate_proj"], sh["up_proj"]
        if gate is None or up is None:
            mlp = F.silu(self.gate_proj(h)) * self.up_proj(h)
        else:
            mlp = constrain([F.silu(gate.shard(r, h)) * up.shard(r, h)
                             for r in range(group.tp)], BATCH, None, "tp")
        return x + self.down_proj(mlp)


class LlamaModel(nn.Module):
    """``embed_tokens`` / ``run_blocks`` / ``head`` compose ``forward``,
    as in ``GPT2Model``.  ``param_dtype`` (default ``cfg.dtype``) is the
    type the parameters are held in; the norms' scales stay float32.
    ``TP_REGIONS``: over a tp axis ``q/k/v_proj`` split by query and KV
    heads (contiguous blocks, so a rank's query heads share its KV
    heads), ``o_proj`` row-parallel, ``gate``/``up`` then ``down``."""

    TP_REGIONS = True

    def __init__(self, cfg: LlamaConfig, device=None, param_dtype=None):
        super().__init__()
        check_remat_policy(cfg)
        device = default_device(device)
        self.cfg = cfg
        pd = param_dtype or cfg.dtype
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                  dtype=pd, device=device)
        self.h = nn.ModuleList(LlamaBlock(cfg, device, pd)
                               for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                  device)
        if not cfg.tie_embeddings:
            self.lm_head = _dense(cfg, cfg.hidden_size, cfg.vocab_size, pd,
                                  device)

    @property
    def device(self) -> torch.device:
        return model_device(self)

    def embed_tokens(self, input_ids):
        return embed(self.embed, input_ids, self.cfg.dtype)

    def run_blocks(self, x, cache: Optional[KVCache] = None):
        return run_stack(self.h, self.cfg, x, cache)

    def head(self, x):
        dtype = self.cfg.dtype
        x = self.final_norm(x).to(dtype)
        if self.cfg.tie_embeddings:
            return tied_logits(x, self.embed, dtype).float()
        return self.lm_head(x).float()

    def forward(self, input_ids, *, train: bool = False,
                decode: bool = False, decode_position=None,
                last_only: bool = False,
                cache: Optional[KVCache] = None):
        """Logits [B, S, V] in f32.  ``decode_position`` is accepted for
        the zoo's uniform calling convention and unused: RoPE positions
        come from the cache (its index, or a slot cache's per-row
        positions).  ``last_only`` projects only the final position
        through the head (prefill)."""
        del train, decode_position
        if input_ids.shape[-1] > self.cfg.max_position:
            raise ValueError(
                f"sequence length {input_ids.shape[-1]} exceeds "
                f"max_position {self.cfg.max_position}; raise it (RoPE "
                f"needs no new params) or shorten the batch")
        if decode and cache is None:
            raise ValueError("Llama decode needs a KV cache "
                             "(generate.init_cache)")
        x = self.run_blocks(self.embed_tokens(input_ids),
                            cache=cache if decode else None)
        if last_only:  # prefill: one row of logits, not [B, P, V]
            x = x[:, -1:]
        return self.head(x)
