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
mean of the layers' load-balance losses (0 in decode).

On a serving mesh (``serving/meshed.py``) a block's attention is
GPT-2's (``gpt2.attention``, exact under the mesh) and its experts are
split over ``ep`` (:class:`ExpertShards`): decode FETCHES each token's
routed expert from the device that holds it, and a prefill chunk's
buckets run on their experts' devices; the per-expert math is the
unmeshed one.  Training over a gang's ``ep`` axis runs the
reference's ``moe_layer`` (``parallel/moe.py``: each ep rank routes
1/ep of the sequence to experts exchanged by all-to-all); its ``tp``
axis splits the attention by heads (``gpt2.py``).  Parameter names
follow the flax tree (``wte``, ``wpe``, ``h.{i}.{ln1,qkv,o_proj,ln2,
moe.{router,experts_w1,experts_w2}}``, ``ln_f``), the router ``[d,
E]`` and the experts ``[E, d, f]`` / ``[E, f, d]`` in the reference's
layout, so ``convert.moe_gpt_state_dict_from_jax`` maps one onto the
other.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from .. import default_device
from ..parallel.constraints import current_exact_mesh
from ..parallel.moe import load_balance_loss, moe_layer, route_top1
from .kv_cache import KVCache, LayerCache
from .gpt2 import attention, qkv_rows_by_heads
from .layers import Dense, embed, f32_param, model_device, remat_call, \
    tied_logits


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


class ExpertShards:
    """The experts ``[E, d, f]`` / ``[E, f, d]`` split over a serving
    mesh group's ``ep`` devices, ``E / ep`` consecutive experts each
    (the reference's ``experts_w[12]`` over ``ep``)."""

    axis = "ep"

    def __init__(self, w1: torch.Tensor, w2: torch.Tensor, group):
        self.devices = list(group.ep_devices)
        self.primary = group.primary
        ep = len(self.devices)
        self.per = w1.shape[0] // ep
        self.w1 = [t.detach().to(d).clone() for t, d in
                   zip(w1.chunk(ep), self.devices)]
        self.w2 = [t.detach().to(d).clone() for t, d in
                   zip(w2.chunk(ep), self.devices)]

    def held(self) -> List[List[torch.Tensor]]:
        """The tensors each shard holds on its device."""
        return [[a, b] for a, b in zip(self.w1, self.w2)]

    def decode(self, x32: torch.Tensor, expert: torch.Tensor):
        """One token a row ([T, d] float32, ``expert`` [T]) through its
        routed expert, on the device that holds it: only the tokens
        and the outputs cross devices, never an expert's weights.  A
        decode step's shapes are static (its CUDA graph), so every shard
        runs all T rows against its own experts (another shard's token
        clamped onto an edge expert of this one) and each row keeps the
        output of its expert's shard: the gather and the FFN are the
        unmeshed decode's on each device, ``ep`` times that in all (on
        one card's virtual devices, ``ep`` times its time)."""
        out = None
        for e, (dev, w1, w2) in enumerate(zip(self.devices, self.w1,
                                              self.w2)):
            local = (expert - e * self.per).clamp(0, self.per - 1)
            y = _decode_ffn(x32.to(dev), local.to(dev), w1,
                            w2).to(self.primary)
            out = y if out is None else torch.where(
                (expert // self.per == e)[:, None], y, out)
        return out

    def run(self, buckets: torch.Tensor) -> torch.Tensor:
        """Every expert's FFN over its bucket rows ([E, N, d]), each
        shard's buckets on its device; concatenated on the primary."""
        return torch.cat([
            _experts(chunk.to(dev), w1, w2).to(self.primary)
            for chunk, dev, w1, w2 in zip(buckets.chunk(len(self.devices)),
                                          self.devices, self.w1, self.w2)])


def _decode_ffn(x32, expert, w1, w2):
    """[T, d] float32 rows through the experts ``expert`` [T] of ``w1`` /
    ``w2``, gathering only those experts' weights -> [T, d]."""
    h = _gelu(torch.bmm(x32[:, None, :], w1.float()[expert]))
    return torch.bmm(h, w2.float()[expert])[:, 0]


def switch_ffn_decode(flat, router_w, w1, w2, experts=None):
    """One token per row: gather only each token's routed expert's
    weights (on a mesh, run each on the device of its expert:
    ``experts``, an :class:`ExpertShards`).
    flat [T, d] -> ([T, d] float32, aux 0)."""
    x32 = flat.float()
    _, expert, gate, _ = route_top1(x32 @ router_w.float())
    out = _decode_ffn(x32, expert, w1, w2) if experts is None \
        else experts.decode(x32, expert)
    return out * gate[:, None], x32.new_zeros(())


def switch_ffn_train(flat, router_w, w1, w2, capacity: int,
                     experts=None):
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
    buckets = buckets.view(e, capacity, d)
    out = (_experts(buckets, w1, w2) if experts is None
           else experts.run(buckets)).reshape(n, d)
    out = torch.where(keep[:, None],
                      out[rows.clamp(max=n - 1)] * gate[:, None], 0.0)
    return out, load_balance_loss(probs, expert)


class MoEMlp(nn.Module):
    """The switch FFN: router ``[d, E]`` and experts ``[E, d, f]`` /
    ``[E, f, d]``, all float32.  Over a training mesh's ``ep`` axis
    (``strategies.shard_tensors`` keeps this rank's experts and sets
    ``tensor_mesh``) the training forward is the reference's
    ``moe_layer``, and the router's gradient sums over ``ep``
    (``EP_SUMMED``)."""

    EP_SUMMED = ("router",)
    tensor_mesh = None

    def __init__(self, cfg: MoEGPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, e, f = cfg.hidden_size, cfg.num_experts, cfg.intermediate_size
        self.router = f32_param((d, e), device, 0.02)
        self.experts_w1 = f32_param((e, d, f), device, 0.02)
        self.experts_w2 = f32_param((e, f, d), device, 0.02)

    def forward(self, x, decode: bool = False,
                experts: Optional[ExpertShards] = None):
        """``experts``: the mesh's expert shards (None: this module's
        own weights)."""
        cfg = self.cfg
        b, s, d = x.shape
        flat = x.reshape(b * s, d)
        w = (self.router, self.experts_w1, self.experts_w2)
        if self.tensor_mesh is not None:
            if decode:
                raise NotImplementedError(
                    "MoE decode over a training mesh's ep shards: "
                    "restore the checkpoint in one process (or on a "
                    "serving mesh) to decode")
            out, aux = moe_layer(x, *w, self.tensor_mesh,
                                 capacity_factor=cfg.capacity_factor,
                                 activation=_gelu)
            return out.to(cfg.dtype), aux
        if decode and s == 1:
            out, aux = switch_ffn_decode(flat, *w, experts=experts)
        elif decode:
            # A prefill chunk: drop-free, capacity = the chunk's tokens.
            out, _ = switch_ffn_train(flat, *w, capacity=b * s,
                                      experts=experts)
            aux = out.new_zeros(())
        else:
            capacity = max(1, int(cfg.capacity_factor * b * s
                                  / cfg.num_experts))
            out, aux = switch_ffn_train(flat, *w, capacity,
                                        experts=experts)
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

    def place_exact(self, placer) -> dict:
        """``qkv`` by heads (GPT-2's), and the experts over ``ep``."""
        return {"qkv": placer.columns(
                    "qkv", self.qkv,
                    qkv_rows_by_heads(self.cfg.hidden_size, placer.tp)),
                "experts": placer.experts(
                    "moe", self.moe.experts_w1, self.moe.experts_w2)}

    def forward(self, x, cache: Optional[LayerCache] = None):
        cfg = self.cfg
        group = current_exact_mesh()
        h = self.ln1(x.float()).to(cfg.dtype)
        x = x + self.o_proj(attention(self, h, cache))
        h = self.ln2(x.float()).to(cfg.dtype)
        ffn, aux = self.moe(h, decode=cache is not None, experts=None
                            if group is None
                            else group.shards_of(self)["experts"])
        return x + ffn, aux


class MoEGPTModel(nn.Module):
    """``forward(input_ids) -> (logits [B, S, V] float32, aux)``.
    ``param_dtype`` (default ``cfg.dtype``) holds the dense layers and
    embeddings; the router and experts are float32 always.
    ``TP_REGIONS``: GPT-2's attention pair over a tp axis."""

    TP_REGIONS = True

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
        return embed(self.wte, input_ids, dtype) + embed(self.wpe, pos,
                                                         dtype)

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
        return tied_logits(x, self.wte, dtype).float()

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
