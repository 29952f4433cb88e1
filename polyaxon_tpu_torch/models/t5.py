"""T5 encoder-decoder, in PyTorch: the zoo's seq2seq family.

Port of ``polyaxon_tpu/models/t5.py``.  T5's departures from the
decoder zoo are kept as the reference has them:

- no attention scaling: every attention call passes ``scale=1.0``;
- bucketed relative-position bias (HF's bucketing,
  :func:`relative_position_bucket`): one ``[num_buckets, num_heads]``
  float32 table for the encoder and one for the decoder, shared across
  layers, added to the self-attention logits.  The bias sends
  self-attention down the plain path; cross-attention carries no bias,
  so it takes the flash kernels whenever both lengths are multiples of
  128 (non-causal, ``scale=1.0``, the encoder's key padding as the
  kernels' key mask);
- ``d_kv`` decoupled from ``d_model`` (``inner_dim = num_heads *
  d_kv``); RMSNorm pre-LN blocks in float32; ReLU (v1.0) or gated-GELU
  (v1.1) feed-forward; a tied head scaled by ``d_model ** -0.5`` or an
  untied ``lm_head``.

Decoding: the decoder's self-attention appends to a
:class:`~.kv_cache.KVCache` (int8 under ``kv_cache_int8``), and the
cross-attention K/V are projected ONCE, at the first decode call, into
the :class:`T5Cache`, then read back on every later step.  The bias of
a decode step comes from the absolute ``decode_position``.
``models.generate.generate_seq2seq`` / ``generate_beam_seq2seq`` own the
encode-once loops.

Parameter names follow the flax tree (``embed``,
``enc_rel.rel_bias``, ``dec_rel.rel_bias``, ``enc.{i}`` / ``dec.{i}``
blocks with ``ln_self``, ``attn.{q,k,v,o}_proj``, ``ln_cross``,
``cross.{q,k,v,o}_proj``, ``ln_ff``, ``wi`` or ``wi_0``/``wi_1``, ``wo``;
``enc_norm``, ``dec_norm``, ``lm_head``), so
``convert.t5_state_dict_from_jax`` maps one onto the other.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import default_device
from ..ops.attention import dot_product_attention
from .kv_cache import KVCache, LayerCache, append_kv_cache
from .layers import (ColumnParallelDense, Dense, check_remat_policy,
                     embed, model_device, remat_call, tied_logits)
from .llama import RMSNorm


@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 512
    # T5 decouples the per-head dim from d_model / num_heads.
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6          # encoder depth
    num_decoder_layers: int = 6
    num_heads: int = 8
    rel_pos_buckets: int = 32
    rel_pos_max_distance: int = 128
    # Decoder KV-cache capacity (relative positions need no table, so
    # this bounds only the decode length).
    max_position: int = 512
    layer_norm_eps: float = 1e-6
    feed_forward: str = "relu"   # "relu" (v1.0) | "gated-gelu" (v1.1)
    tie_embeddings: bool = True  # v1.0 ties (and scales by d**-0.5)
    pad_id: int = 0              # also the decoder start token
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False
    remat_policy: Optional[str] = None
    # The flax param layout (scanned vs enc_{i}); the port always holds
    # ModuleLists and the converter reads either layout.
    scan_layers: bool = True
    # Serve-time option: the decoder's self-attention cache as int8
    # with per-(token, head) bf16 scales; the cross K/V stay exact.
    kv_cache_int8: bool = False

    def __post_init__(self):
        if self.feed_forward not in ("relu", "gated-gelu"):
            raise ValueError(
                f"feed_forward must be 'relu' or 'gated-gelu'; got "
                f"{self.feed_forward!r}")

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv

    @staticmethod
    def small() -> "T5Config":
        return T5Config()  # t5-small dims

    @staticmethod
    def tiny() -> "T5Config":
        return T5Config(vocab_size=512, d_model=64, d_kv=16, d_ff=128,
                        num_layers=2, num_decoder_layers=2, num_heads=4,
                        max_position=128)


def relative_position_bucket(rel: torch.Tensor, *, bidirectional: bool,
                             num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """T5's bucketed relative positions (``rel = key_pos - q_pos``), as
    HF's ``_relative_position_bucket``: half the buckets exact offsets,
    the rest log-spaced out to ``max_distance``, the last bucket beyond
    it; bidirectional buckets split by sign, causal ones cover only the
    past."""
    rel = rel.to(torch.int32)
    n = num_buckets
    ret = torch.zeros_like(rel)
    if bidirectional:
        n //= 2
        ret = ret + (rel > 0).to(torch.int32) * n
        rel = rel.abs()
    else:
        rel = -torch.clamp_max(rel, 0)
    max_exact = n // 2
    is_small = rel < max_exact
    # max(rel, 1) keeps log() finite; those lanes are is_small anyway.
    large = max_exact + (
        torch.log(torch.clamp_min(rel, 1).to(torch.float32) / max_exact)
        / math.log(max_distance / max_exact) * (n - max_exact)
    ).to(torch.int32)
    large = torch.clamp_max(large, n - 1)
    return ret + torch.where(is_small, rel, large)


class T5RelativeBias(nn.Module):
    """One float32 ``[num_buckets, num_heads]`` table; called with
    absolute query and key positions -> additive logits [1, H, Q, K]."""

    def __init__(self, cfg: T5Config, bidirectional: bool, device=None):
        super().__init__()
        self.cfg, self.bidirectional = cfg, bidirectional
        self.rel_bias = nn.Embedding(cfg.rel_pos_buckets, cfg.num_heads,
                                     dtype=torch.float32, device=device)

    def forward(self, q_pos, k_pos):
        cfg = self.cfg
        buckets = relative_position_bucket(
            k_pos[None, :] - q_pos[:, None],
            bidirectional=self.bidirectional,
            num_buckets=cfg.rel_pos_buckets,
            max_distance=cfg.rel_pos_max_distance)
        return F.embedding(buckets.long(),
                           self.rel_bias.weight).permute(2, 0, 1)[None]


@dataclass
class T5Cache:
    """A seq2seq decode cache: the decoder's self-attention
    :class:`KVCache` and, once the first decode call made them, each
    layer's cross-attention (K, V), [B, S_enc, H, d_kv]."""
    self_kv: KVCache
    cross: List[Optional[Tuple[torch.Tensor, torch.Tensor]]] = \
        field(default_factory=list)

    def tile_rows(self, k: int) -> "T5Cache":
        """Every row repeated ``k`` times, b-major (a beam per copy)."""
        return T5Cache(self.self_kv.tile_rows(k),
                       [None if c is None else
                        tuple(t.repeat_interleave(k, dim=0) for t in c)
                        for c in self.cross])

    def take_rows(self, rows: torch.Tensor) -> "T5Cache":
        """The self-attention rows ``rows`` (a beam step's parents).
        The cross K/V are beam-invariant (parents never cross a batch
        row) and are not gathered."""
        return T5Cache(self.self_kv.take_rows(rows), self.cross)


class T5Attention(nn.Module):
    """Self- or cross-attention, T5 style: no scaling, bias-free
    projections, an optional additive position bias."""

    def __init__(self, cfg: T5Config, causal: bool = False, device=None,
                 param_dtype=None):
        super().__init__()
        self.cfg, self.causal = cfg, causal
        pd = param_dtype or cfg.dtype

        def dense(n_in, n_out):
            return Dense(n_in, n_out, cfg.dtype, pd, device, bias=False)

        self.q_proj = dense(cfg.d_model, cfg.inner_dim)
        self.k_proj = dense(cfg.d_model, cfg.inner_dim)
        self.v_proj = dense(cfg.d_model, cfg.inner_dim)
        self.o_proj = dense(cfg.inner_dim, cfg.d_model)

    def _heads(self, proj, src):
        """[B, S, heads, d_kv]: all heads, or a tp rank's."""
        return proj(src).reshape(src.shape[0], src.shape[1], -1,
                                 self.cfg.d_kv)

    def project_kv(self, src):
        """(K, V) of ``src`` [B, S, d_model], [B, S, H, d_kv] each."""
        return self._heads(self.k_proj, src), self._heads(self.v_proj, src)

    def forward(self, x, kv=None, mask=None, bias=None,
                cache: Optional[LayerCache] = None, cross_kv=None):
        """``kv``: the encoder output (cross-attention).  In decode,
        ``cache`` (self-attention) or ``cross_kv`` (the cached cross (K,
        V)) is given."""
        b, sq = x.shape[:2]
        q = self._heads(self.q_proj, x)
        if bias is not None and isinstance(self.q_proj, ColumnParallelDense):
            # The bias of this rank's heads; its cotangent gathers back
            # onto the replicated table.
            bias = self.q_proj.split(bias, dim=1)
        causal = self.causal
        if cross_kv is not None:
            k, v = cross_kv
        elif cache is not None:
            # The append mask covers causality over the filled prefix.
            k, v, mask, _ = append_kv_cache(cache, *self.project_kv(x))
            causal = False
        else:
            k, v = self.project_kv(x if kv is None else kv)
        a = dot_product_attention(q, k, v, mask=mask, causal=causal,
                                  scale=1.0, bias=bias)
        return self.o_proj(a.reshape(b, sq, -1))


class T5Block(nn.Module):
    """Pre-LN residual block: self-attention [+ cross-attention] + FF."""

    def __init__(self, cfg: T5Config, is_decoder: bool, device=None,
                 param_dtype=None):
        super().__init__()
        self.cfg, self.is_decoder = cfg, is_decoder
        pd = param_dtype or cfg.dtype
        norm = lambda: RMSNorm(cfg.d_model, cfg.layer_norm_eps,  # noqa
                               device)
        self.ln_self = norm()
        self.attn = T5Attention(cfg, is_decoder, device, pd)
        if is_decoder:
            self.ln_cross = norm()
            self.cross = T5Attention(cfg, False, device, pd)
        self.ln_ff = norm()

        def dense(n_in, n_out):
            return Dense(n_in, n_out, cfg.dtype, pd, device, bias=False)

        if cfg.feed_forward == "gated-gelu":
            self.wi_0 = dense(cfg.d_model, cfg.d_ff)
            self.wi_1 = dense(cfg.d_model, cfg.d_ff)
        else:
            self.wi = dense(cfg.d_model, cfg.d_ff)
        self.wo = dense(cfg.d_ff, cfg.d_model)

    def forward(self, x, self_bias=None, self_mask=None, enc_out=None,
                enc_mask=None, cache: Optional[LayerCache] = None,
                cross_kv=None):
        cfg = self.cfg
        h = self.ln_self(x).to(cfg.dtype)
        x = x + self.attn(h, mask=self_mask, bias=self_bias, cache=cache)
        if self.is_decoder:
            h = self.ln_cross(x).to(cfg.dtype)
            x = x + self.cross(h, kv=enc_out, mask=enc_mask,
                               cross_kv=cross_kv)
        h = self.ln_ff(x).to(cfg.dtype)
        if cfg.feed_forward == "gated-gelu":
            h = F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h)
        else:
            h = F.relu(self.wi(h))
        return x + self.wo(h)


def shift_right(ids: torch.Tensor, start_id: int) -> torch.Tensor:
    """T5's decoder inputs: the start (pad) token, then the targets but
    the last."""
    return torch.cat([torch.full_like(ids[:, :1], start_id), ids[:, :-1]],
                     dim=1)


class T5Model(nn.Module):
    """Encoder-decoder with a shared embedding.  ``forward(input_ids,
    decoder_input_ids)`` is the teacher-forced training path (the
    decoder inputs default to ``shift_right(input_ids)``); ``encode`` /
    ``decode`` are the halves the seq2seq decoding loops call.
    ``param_dtype`` (default ``cfg.dtype``) holds the embedding and the
    dense layers; the bias tables and norms are float32.
    ``TP_REGIONS``: over a tp axis ``q/k/v_proj`` split by heads then
    ``o_proj``, ``wi`` (``wi_0`` / ``wi_1``) then ``wo``; the relative
    bias tables stay replicated (no rule of the reference matches them)
    and each rank attends with its heads' slice of the bias."""

    TP_REGIONS = True

    def __init__(self, cfg: T5Config, device=None, param_dtype=None):
        super().__init__()
        check_remat_policy(cfg)
        device = default_device(device)
        self.cfg = cfg
        pd = param_dtype or cfg.dtype
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model, dtype=pd,
                                  device=device)
        self.enc_rel = T5RelativeBias(cfg, True, device)
        self.dec_rel = T5RelativeBias(cfg, False, device)
        self.enc = nn.ModuleList(T5Block(cfg, False, device, pd)
                                 for _ in range(cfg.num_layers))
        self.dec = nn.ModuleList(T5Block(cfg, True, device, pd)
                                 for _ in range(cfg.num_decoder_layers))
        self.enc_norm = RMSNorm(cfg.d_model, cfg.layer_norm_eps, device)
        self.dec_norm = RMSNorm(cfg.d_model, cfg.layer_norm_eps, device)
        if not cfg.tie_embeddings:
            self.lm_head = Dense(cfg.d_model, cfg.vocab_size, cfg.dtype,
                                 pd, device, bias=False)

    @property
    def device(self) -> torch.device:
        return model_device(self)

    def _embed(self, ids):
        return embed(self.embed, ids, self.cfg.dtype)

    def _remat(self) -> bool:
        return self.cfg.remat and torch.is_grad_enabled()

    def encode(self, input_ids, enc_mask=None):
        """Token ids [B, S] -> encoder output [B, S, d_model] in
        ``cfg.dtype`` (final norm applied).  ``enc_mask`` [B, S]:
        nonzero = a real token."""
        cfg = self.cfg
        input_ids = torch.as_tensor(input_ids, device=self.device)
        x = self._embed(input_ids)
        pos = torch.arange(input_ids.shape[-1], device=x.device)
        bias = self.enc_rel(pos, pos)
        mask4 = None if enc_mask is None else torch.as_tensor(
            enc_mask, device=x.device)[:, None, None, :].to(torch.bool)
        for blk in self.enc:
            x = remat_call(blk, cfg.remat_policy, x, bias, mask4) \
                if self._remat() else blk(x, bias, mask4)
        return self.enc_norm(x).to(cfg.dtype)

    def init_decode_cache(self, batch_size: int) -> T5Cache:
        """An empty decode cache: the self-attention cache
        ([num_decoder_layers, B, max_position, H, d_kv], int8 with bf16
        scales under ``kv_cache_int8``) and no cross K/V yet."""
        cfg = self.cfg
        shape = (cfg.num_decoder_layers, batch_size, cfg.max_position,
                 cfg.num_heads, cfg.d_kv)
        dev = self.device
        dt = torch.int8 if cfg.kv_cache_int8 else cfg.dtype
        scales = {}
        if cfg.kv_cache_int8:
            scales = {n: torch.zeros(shape[:-1] + (1,),
                                     dtype=torch.bfloat16, device=dev)
                      for n in ("k_scale", "v_scale")}
        kv = KVCache(torch.zeros(shape, dtype=dt, device=dev),
                     torch.zeros(shape, dtype=dt, device=dev), **scales)
        return T5Cache(kv, [None] * cfg.num_decoder_layers)

    def decode(self, decoder_input_ids, enc_out, enc_mask=None, *,
               decode: bool = False, decode_position: int = 0,
               last_only: bool = False, cache: Optional[T5Cache] = None):
        """Teacher-forced (``decode=False``) or cached (``decode=True``
        with ``cache``) decoder pass -> logits [B, T, V] float32.  In
        decode ``decode_position`` is the absolute position of the first
        new token: the bias is computed from it."""
        cfg = self.cfg
        t = decoder_input_ids.shape[-1]
        x = self._embed(decoder_input_ids)
        dev = x.device
        if decode:
            if cache is None:
                raise ValueError("T5 decode needs a T5Cache "
                                 "(model.init_decode_cache)")
            if t > cfg.max_position:
                raise ValueError(f"decode chunk {t} exceeds max_position "
                                 f"{cfg.max_position}")
            q_pos = decode_position + torch.arange(t, device=dev)
            bias = self.dec_rel(q_pos, torch.arange(cfg.max_position,
                                                    device=dev))
        else:
            pos = torch.arange(t, device=dev)
            bias = self.dec_rel(pos, pos)
        mask4 = None if enc_mask is None else torch.as_tensor(
            enc_mask, device=dev)[:, None, None, :].to(torch.bool)
        for i, blk in enumerate(self.dec):
            if decode:
                if cache.cross[i] is None:
                    # The first decode call projects the cross K/V once.
                    cache.cross[i] = blk.cross.project_kv(enc_out)
                x = blk(x, bias, None, enc_out, mask4,
                        cache=cache.self_kv.layer(i),
                        cross_kv=cache.cross[i])
            elif self._remat():
                x = remat_call(blk, cfg.remat_policy, x, bias, None,
                               enc_out, mask4)
            else:
                x = blk(x, bias, None, enc_out, mask4)
        if decode:
            cache.self_kv.advance(t)
        x = self.dec_norm(x)
        if last_only:
            x = x[:, -1:]
        return self.head(x)

    def head(self, x):
        cfg = self.cfg
        x = x.to(cfg.dtype)
        if cfg.tie_embeddings:
            # The tied head scales its input by d_model**-0.5 (the scale
            # the attention logits dropped).
            return tied_logits(x * (cfg.d_model ** -0.5), self.embed,
                               cfg.dtype).float()
        return self.lm_head(x).float()

    def forward(self, input_ids, decoder_input_ids=None, *, enc_mask=None,
                train: bool = False):
        del train
        if decoder_input_ids is None:
            decoder_input_ids = shift_right(input_ids, self.cfg.pad_id)
        enc_out = self.encode(input_ids, enc_mask=enc_mask)
        return self.decode(decoder_input_ids, enc_out, enc_mask=enc_mask)
