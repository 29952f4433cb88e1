"""Autoregressive generation with a KV cache: greedy and sampled.

Port of ``polyaxon_tpu/models/generate.py`` (greedy, the chain-keyed
sampled ``generate`` and the position-keyed ``generate_positional``).
The model holds its own weights (an ``nn.Module``), so the entry points
take ``model`` where the reference takes ``model, variables``.  Prefill
runs one forward over the whole prompt — or fixed-size pieces with
``prefill_chunk`` — then a Python loop decodes token by token.  Random
draws go through ``polyaxon_tpu_torch.prng``, jax's threefry stream bit
for bit, so a seed draws the reference's random bits; keys are int64
``[2]`` tensors (``prng.PRNGKey``).  ``generate_speculative`` (a draft
model's K-token rounds verified by one K + 1-wide target forward: greedy,
the chain-keyed ``rng`` schedule, or the position-keyed ``seed``/``keys``
schedule the engine's speculative slots share) and ``generate_beam``
(the cache tiled per beam) are the reference's.  Every entry point
serves int8 weights (dequantized where each module reads them,
``ops/quant.py``), the int8 KV cache and, for sliding-window models, the
ring cache, whose sessions skip the ``max_position`` budget checks
(prefill chunks at ``max_position``).  ``generate_seq2seq`` and
``generate_beam_seq2seq`` decode an encoder-decoder (T5): the encoder
runs once, then the decoder steps from an empty :class:`T5Cache` whose
first step projects the cross-attention K/V; sampling is chain-keyed
(``positional_eligible`` is False for a model with ``encode``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import prng
from .kv_cache import KVCache, kv_cache_dims

NEG = -1e30
M32 = 0xFFFFFFFF


def _is_ring(model) -> bool:
    return bool(getattr(model.cfg, "kv_cache_ring", False))


def init_cache(model, batch_size: int) -> KVCache:
    """A zeroed decode cache for a decoder-only ``model``:
    [layers, B, cap, kv_heads, D] (``kv_cache_dims``: GPT-2 caches all
    its ``num_heads``), index 0.  ``cap`` is ``max_position``, or for a ring
    model (``kv_cache_ring``) ``sliding_window + 1 +
    kv_cache_ring_slack``, the capacity the reference's one-token
    ``init_cache`` trace creates.  The entries are in the model's dtype,
    or int8 with zeroed bf16 scales ([layers, B, cap, H, 1]) under
    ``kv_cache_int8``.  A ring's position table starts at -1 in every
    slot (``append_ring_kv_cache``'s contract for unwritten slots; the
    reference's ``init_cache`` zero-fills it instead, which lets a
    prompt shorter than the ring attend to position-0 zero entries).
    A model placed on a serving mesh (``serving/meshed.MeshedModel``)
    builds its own, split over its devices by heads."""
    if hasattr(model, "init_cache"):
        return model.init_cache(batch_size)
    cfg = model.cfg
    ring = _is_ring(model)
    cap = cfg.sliding_window + 1 + cfg.kv_cache_ring_slack if ring \
        else cfg.max_position
    shape = (cfg.num_layers, batch_size, cap, *kv_cache_dims(cfg))
    dev = model.device
    int8 = bool(getattr(cfg, "kv_cache_int8", False))
    dt = torch.int8 if int8 else cfg.dtype
    scales = {}
    if int8:
        scales = {n: torch.zeros(shape[:-1] + (1,), dtype=torch.bfloat16,
                                 device=dev)
                  for n in ("k_scale", "v_scale")}
    return KVCache(torch.zeros(shape, dtype=dt, device=dev),
                   torch.zeros(shape, dtype=dt, device=dev),
                   ring_pos=torch.full((cap,), -1, dtype=torch.long,
                                       device=dev) if ring else None,
                   **scales)


def _check_budget(model, position: int, new: int, what: str) -> None:
    """Past ``max_position`` the cache write and GPT-2's ``wpe`` lookup
    have no slot: refuse up front.  Ring models stream past it by
    design (RoPE needs no table)."""
    max_pos = model.cfg.max_position
    if not _is_ring(model) and position + new > max_pos:
        raise ValueError(
            f"{what} ({position}) + max_new_tokens ({new}) exceeds the "
            f"model's max_position ({max_pos})")


def extract_logits(out) -> torch.Tensor:
    """The zoo's output contract: ``logits`` or ``(logits, aux)``."""
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, tuple) and len(out) == 2 and \
            isinstance(out[0], torch.Tensor):
        return out[0]
    raise TypeError(
        f"model output must be logits or (logits, aux); got "
        f"{type(out).__name__}")


def _modified_logits(logits, temperature: float, top_k: Optional[int],
                     top_p: Optional[float] = None):
    """The temperature/top-k/top-p-shaped logits ``_sample`` draws from
    (the CHAIN schedule's shaping: one sort per token, kept in the
    logits' own type)."""
    logits = logits / temperature
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG, logits)
    if top_p is not None:
        # Nucleus: a token survives iff the mass strictly before it in
        # the descending order is < top_p (the top token always does).
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        before = torch.cumsum(probs, dim=-1) - probs
        cut = torch.where(before < top_p, sorted_l, float("inf"))
        kth = torch.min(cut, dim=-1, keepdim=True).values
        logits = torch.where(logits < kth, NEG, logits)
    return logits


def _sample(logits, rng, temperature: float, top_k: Optional[int],
            top_p: Optional[float] = None):
    """One token per row: the first maximum (greedy), or one
    ``categorical`` draw with key ``rng`` over the shaped logits."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    return prng.categorical(
        rng, _modified_logits(logits, temperature, top_k, top_p))


def _check_top_p(top_p) -> None:
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(
            f"top_p must be in (0, 1]; got {top_p} (use "
            f"temperature=0 for greedy decoding)")


def _check_temperature(temperature) -> None:
    if temperature < 0.0:
        raise ValueError(
            f"temperature must be >= 0; got {temperature}")


def _check_top_k(top_k, vocab=None) -> None:
    if top_k is None:
        return
    if top_k < 1 or (vocab is not None and top_k > vocab):
        hi = vocab if vocab is not None else "vocab_size"
        raise ValueError(f"top_k must be in [1, {hi}]; got {top_k}")


def _check_spec_k(spec_k) -> None:
    """A draft length < 1 proposes nothing: one message for the server,
    the CLI and the library."""
    if spec_k < 1:
        raise ValueError(f"spec_k must be >= 1; got {spec_k}")


# Shared by the server and the CLI: speculative + beam is refused with
# one message whichever surface fields the request.
SPEC_BEAM_MSG = ("speculative decoding cannot combine with beam "
                 "search (greedy or sampled only)")


# The reference's server and CLI decode an encoder-decoder through the
# decoder-only programs, which fail deep inside with a TypeError; the
# port refuses such a request before any program runs, naming the fault.
SEQ2SEQ_SERVE_MSG = (
    "seq2seq (encoder-decoder) models are not decoded through the "
    "decoder-only generate programs of the server and the CLI: the "
    "reference's fail there with \"TypeError: T5Model.__call__() got an "
    "unexpected keyword argument 'decode'\" (ROADMAP Queue 3: seq2seq "
    "generate requests); decode with models.generate.generate_seq2seq")


# A classifier, an image model or an encoder has nothing to decode: the
# reference fails generate on one with a TypeError from inside the
# model, the port refuses it by name before any program is built.
NO_LM_HEAD_MSG = (
    "{name} has no causal LM head (its forward takes no decode step): "
    "generate, the server and the CLI decode causal language models "
    "only (ROADMAP Queue 3: Generate on a model with no LM head)")


def check_lm_head(model) -> None:
    """Refuse a model whose forward has no ``decode`` step (ViT, the
    MLP, the ConvNet, ResNet, BERT) with NO_LM_HEAD_MSG, a
    NotImplementedError; a seq2seq model passes (it has its own
    refusal where the decoder-only programs would run it)."""
    import inspect

    if hasattr(model, "encode"):
        return
    if "decode" not in inspect.signature(model.forward).parameters:
        raise NotImplementedError(
            NO_LM_HEAD_MSG.format(name=type(model).__name__))


def check_decoder_only(model) -> None:
    """Refuse a seq2seq model on a decoder-only path (SEQ2SEQ_SERVE_MSG)
    and a model with no causal LM head (NO_LM_HEAD_MSG), each a
    NotImplementedError: the server's 501."""
    if hasattr(model, "encode"):
        raise NotImplementedError(SEQ2SEQ_SERVE_MSG)
    check_lm_head(model)


def _check_positional_sampling(top_k, top_p, temperature,
                               vocab=None) -> None:
    """Validation of the positional entry points: ``0`` is the internal
    "disabled" encoding of top_k/top_p, so it passes here (the HTTP
    surface refuses it)."""
    if isinstance(top_k, int) and top_k:
        _check_top_k(top_k, vocab)
    if isinstance(top_p, (int, float)) and top_p:
        _check_top_p(float(top_p))
    if isinstance(temperature, (int, float)):
        _check_temperature(temperature)


def positional_eligible(model, temperature) -> bool:
    """Whether a request decodes under the POSITION-KEYED schedule:
    sampled (temperature != 0) on a decoder-only model.  The one
    predicate behind the server and the CLI, so every surface samples
    alike (greedy never consults the PRNG)."""
    return temperature != 0.0 and not hasattr(model, "encode")


def _decode_loop(apply_step, cache, first_logits, *,
                 max_new_tokens: int, rng, temperature: float,
                 top_k: Optional[int], eos_id: Optional[int],
                 top_p: Optional[float] = None):
    """Sample-first, then one ``apply_step(cache, tok, t) -> logits``
    per token, each token drawn with the next key of the CHAIN
    ``rng, key = split(rng)``; ``eos_id`` freezes finished rows (they
    keep emitting eos).  Returns the new tokens [B, max_new_tokens]."""
    rng, key = prng.split(rng)
    tok = _sample(first_logits, key, temperature, top_k, top_p)
    done = torch.zeros_like(tok, dtype=torch.bool)
    if eos_id is not None:
        done = tok == eos_id
    out = [tok]
    for t in range(max_new_tokens - 1):
        logits = apply_step(cache, tok, t)
        rng, key = prng.split(rng)
        nxt = _sample(logits, key, temperature, top_k, top_p)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        tok = nxt
        out.append(tok)
    return torch.stack(out, dim=1)


# -- position-keyed sampling ---------------------------------------------
#
# Row r's i-th token draws with fold_in(fold_in(PRNGKey(seed), r), i):
# a pure function of (seed, row, token index), never of batch shape,
# slot id, step count or co-tenancy, so the engine's slots and the solo
# reference draw identical samples under any admission schedule.


def sample_stream_keys(seed: int, rows: int, device=None) -> torch.Tensor:
    """Per-row base keys ``fold_in(PRNGKey(seed), r)``, [rows, 2]."""
    return prng.fold_in(prng.PRNGKey(seed, device=device).expand(rows, 2),
                        torch.arange(rows, device=device))


def _sortable_bits(x):
    """float32 -> an order-preserving key in ``[0, 2**32)`` (int64):
    unsigned comparison of the keys is comparison of the (NaN-free)
    floats.  Positive floats get the sign bit set, negative ones are
    bit-complemented."""
    b = x.float().contiguous().view(torch.int32).to(torch.int64) & M32
    return torch.where((b >> 31) == 0, b | 0x80000000, ~b & M32)


def _bitwise_threshold(pred, rows_shape, device):
    """Per row, the largest ``t`` in ``[0, 2**32)`` with ``pred(t)``
    true, for a predicate monotone non-increasing in ``t``: greedy
    MSB-first construction in 32 fixed steps (exact selection, no
    vocab sort).  ``t`` is int64 ``rows_shape + (1,)``."""
    t = torch.zeros(tuple(rows_shape) + (1,), dtype=torch.int64,
                    device=device)
    for i in range(32):
        t_try = t | (1 << (31 - i))
        t = torch.where(pred(t_try), t_try, t)
    return t


def _shape_logits_positional(logits, temperature, top_k, top_p):
    """Temperature/top-k/top-p shaping with per-row parameters in
    float32: the engine's slot step feeds per-slot tensors, the solo
    positional path request scalars, and both run THIS function.
    ``logits`` is [..., V]; each parameter is a scalar or a tensor of
    the leading dims.

    Returns ``(shaped float32 logits, greedy flag)``.  ``temperature <=
    0`` marks a row greedy (shaping still runs, in a dead lane);
    ``top_k <= 0`` / ``top_p <= 0`` disable those masks and ``top_p >=
    1`` is a no-op.  Both cutoffs are found by the 32-step bitwise
    search (:func:`_bitwise_threshold`): top-k keeps ``{x : x >= k-th
    largest}`` (ties survive), top-p keeps ``{x : mass(values > x) <
    top_p}``."""
    v = logits.shape[-1]
    lead = logits.shape[:-1]
    dev = logits.device

    def per_row(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev).expand(
            lead).unsqueeze(-1)

    temperature = per_row(temperature, torch.float32)
    top_k = per_row(top_k, torch.int64)
    top_p = per_row(top_p, torch.float32)
    greedy = temperature <= 0.0
    # Greedy rows divide by 1, so the dead lane stays finite.
    l = logits.float() / torch.where(greedy, 1.0, temperature)
    lbits = _sortable_bits(l)
    k = top_k.clamp(1, v)
    t_k = _bitwise_threshold(
        lambda t: (lbits >= t).sum(-1, keepdim=True) >= k, lead, dev)
    l = torch.where((top_k > 0) & (lbits < t_k), NEG, l)
    # Nucleus over the top-k-masked logits (masked lanes underflow to
    # probability 0).
    lbits = _sortable_bits(l)
    e = torch.exp(l - l.max(-1, keepdim=True).values)
    pz = top_p * e.sum(-1, keepdim=True)
    t_p = _bitwise_threshold(
        lambda t: torch.where(lbits > t, e, 0.0).sum(-1, keepdim=True)
        >= pz, lead, dev)
    l = torch.where((top_p > 0.0) & (top_p < 1.0) & (lbits <= t_p),
                    NEG, l)
    return l, greedy.squeeze(-1)


def _sample_positional_row(logits, base_key, index, temperature,
                           top_k, top_p):
    """One token per row under the position-keyed contract: the row's
    key is ``fold_in(base_key, index)``.  ``logits`` [..., V],
    ``base_key`` [..., 2], the rest scalars or tensors of the leading
    dims (the engine feeds per-slot tensors).  ``temperature <= 0``
    rows take the argmax of the raw logits, the greedy lane."""
    key = prng.fold_in(base_key, index)
    l, greedy = _shape_logits_positional(logits, temperature, top_k,
                                         top_p)
    sampled = prng.categorical(key, l)
    return torch.where(greedy, torch.argmax(logits, dim=-1), sampled)


def _sample_positional(logits, keys, index, temperature, top_k, top_p):
    """[B, V] logits + [B, 2] base keys -> [B] tokens, one request's
    scalar parameters broadcast to every row."""
    return _sample_positional_row(logits, keys, index, temperature,
                                  top_k, top_p)


# -- position-keyed speculative draws -------------------------------------
#
# A speculative round draws three kinds of randomness per proposed
# token: the draft's proposal, the accept/reject uniform and the
# residual resample.  Each is keyed by (base key, token index, lane), a
# pure function of the request, so an engine slot and the solo
# reference commit the same tokens under any co-tenancy, and a
# partially rejected round re-derives the same tokens next round.

_SPEC_LANE_DRAFT = 1
_SPEC_LANE_ACCEPT = 2
_SPEC_LANE_RESIDUAL = 3


def _per_lane(x):
    """A scalar parameter, or a tensor of the leading dims [...] made
    broadcastable against a trailing [..., K] axis."""
    if isinstance(x, torch.Tensor) and x.dim():
        return x.unsqueeze(-1)
    return x


def _spec_round_key(base_key, index, lane: int):
    """``fold_in(fold_in(base, index), lane)``: disjoint from the plain
    schedule's ``fold_in(base, index)`` committed-token keys."""
    return prng.fold_in(prng.fold_in(base_key, index), lane)


def _spec_draft_row(logits, base_key, index, temperature, top_k, top_p):
    """The draft's proposal at new-token ``index``: ``(token, q)`` with
    ``q`` the draft's shaped density (what the accept test divides by).
    ``logits`` [..., V], ``base_key`` [..., 2], the rest scalars or
    tensors of the leading dims.  ``temperature <= 0`` rows take the
    argmax lane (``q`` is then a dead value)."""
    l, greedy = _shape_logits_positional(logits, temperature, top_k,
                                         top_p)
    key = _spec_round_key(base_key, index, _SPEC_LANE_DRAFT)
    sampled = prng.categorical(key, l)
    tok = torch.where(greedy, torch.argmax(logits, dim=-1), sampled)
    return tok, torch.softmax(l, dim=-1)


def _spec_verify_row(t_logits, d_toks, q_rows, base_key, index0,
                     temperature, top_k, top_p, k_eff):
    """Verify K proposals per row against the target.  ``t_logits``
    [..., K, V] are the target's logits at the K draft positions,
    ``d_toks`` [..., K] the proposals, ``q_rows`` [..., K, V] their
    draft densities, ``base_key`` [..., 2], ``index0`` the new-token
    index of the first proposal; the sampling parameters and ``k_eff``
    are scalars or tensors of the leading dims.  Returns ``(out [...,
    K], c [...], m [...])``: a row commits ``out[:c]``, ``c`` in ``[1,
    k_eff]``, and ``m`` counts its accepted proposals.

    Greedy lane (``temperature <= 0``): the longest prefix where the
    draft matches the target's argmax, then the target's argmax as the
    correction.  Sampled lane: rejection sampling (accept ``x ~ q``
    with probability ``min(1, p(x)/q(x))``; the first rejection
    resamples from ``norm(max(p - q, 0))``) under the position-keyed
    schedule, both densities shaped by ``_shape_logits_positional``.
    ``k_eff <= K`` caps a row's accepts and commits at its own draft
    length inside a K-wide round."""
    k = d_toks.shape[-1]
    dev = t_logits.device
    lanes = torch.arange(k, device=dev)
    idxs = torch.as_tensor(index0, device=dev).expand(
        base_key.shape[:-1])[..., None] + lanes             # [..., K]
    shaped, _ = _shape_logits_positional(
        t_logits, _per_lane(temperature), _per_lane(top_k),
        _per_lane(top_p))
    p_rows = torch.softmax(shaped, dim=-1)                  # [..., K, V]
    px = p_rows.gather(-1, d_toks[..., None])[..., 0]
    qx = q_rows.gather(-1, d_toks[..., None])[..., 0]
    keys = base_key[..., None, :].expand(idxs.shape + (2,))
    u = prng.uniform(_spec_round_key(keys, idxs, _SPEC_LANE_ACCEPT), ())
    t_arg = torch.argmax(t_logits, dim=-1)
    greedy = _per_lane(torch.as_tensor(temperature, dtype=torch.float32,
                                       device=dev) <= 0.0)
    # u < p/q without the divide.
    accept = torch.where(greedy, d_toks == t_arg, u * qx < px)
    k_eff = torch.as_tensor(k_eff, device=dev).clamp(1, k)
    accept = accept & (lanes < _per_lane(k_eff))
    m = torch.cumprod(accept.long(), dim=-1).sum(-1)
    c = torch.minimum(m + 1, k_eff)
    resid = torch.clamp_min(p_rows - q_rows, 0.0)
    res = prng.categorical(
        _spec_round_key(keys, idxs, _SPEC_LANE_RESIDUAL),
        torch.log(resid + 1e-20))
    correction = torch.where(greedy, t_arg, res)
    out = torch.where(lanes < m[..., None], d_toks, correction)
    return out, c, m


def _decode_loop_positional(apply_step, cache, first_logits, *,
                            max_new_tokens: int, keys,
                            temperature, top_k, top_p,
                            eos_id: Optional[int]):
    """Position-keyed twin of :func:`_decode_loop`: token i draws with
    ``fold_in(base, i)``, so a prefill/continue split or the engine's
    slot schedule never shifts the stream."""
    tok = _sample_positional(first_logits, keys, 0, temperature, top_k,
                             top_p)
    done = torch.zeros_like(tok, dtype=torch.bool)
    if eos_id is not None:
        done = tok == eos_id
    out = [tok]
    for t in range(max_new_tokens - 1):
        logits = apply_step(cache, tok, t)
        nxt = _sample_positional(logits, keys, t + 1, temperature,
                                 top_k, top_p)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        tok = nxt
        out.append(tok)
    return torch.stack(out, dim=1)


def _as_tokens(prompt, device) -> torch.Tensor:
    return torch.as_tensor(prompt, dtype=torch.long, device=device)


def _default_rng(rng, device):
    return prng.PRNGKey(0, device=device) if rng is None \
        else torch.as_tensor(rng, dtype=torch.int64, device=device)


@torch.no_grad()
def generate(model, prompt, *, max_new_tokens: int,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None, rng=None,
             eos_id: Optional[int] = None,
             prefill_chunk: Optional[int] = None) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt`` [B, P]
    (a shared prompt length).  Returns [B, P + max_new_tokens].
    ``temperature=0`` is greedy; otherwise token i draws with the i-th
    key of the chain ``rng, key = split(rng)`` from ``rng`` (default
    ``PRNGKey(0)``).  ``eos_id`` freezes finished rows."""
    check_lm_head(model)
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0; got "
                         f"{max_new_tokens}")
    _check_top_p(top_p)
    cfg = model.cfg
    _check_top_k(top_k, cfg.vocab_size)
    _check_temperature(temperature)
    dev = model.device
    rng = _default_rng(rng, dev)
    prompt = _as_tokens(prompt, dev)
    if max_new_tokens == 0:
        return prompt
    b, p_len = prompt.shape
    _check_budget(model, p_len, max_new_tokens, "prompt")
    first_logits, cache = _prefill(model, prompt, chunk=prefill_chunk)
    new = generate_continue(
        model, cache, first_logits, p_len, max_new_tokens=max_new_tokens,
        temperature=temperature, top_k=top_k, top_p=top_p, rng=rng,
        eos_id=eos_id, _validated=True)
    return torch.cat([prompt, new], dim=1)


@torch.no_grad()
def generate_positional(model, prompt, *, max_new_tokens: int,
                        seed: int = 0, keys=None, temperature=1.0,
                        top_k=None, top_p=None,
                        eos_id: Optional[int] = None,
                        prefill_chunk: Optional[int] = None
                        ) -> torch.Tensor:
    """:func:`generate` under the POSITION-KEYED schedule, the solo
    reference the engine's sampled slots are held against: row r's
    i-th new token draws with ``fold_in(fold_in(PRNGKey(seed), r),
    i)``.  ``top_k=None``/``0`` and ``top_p=None``/``0`` disable the
    masks; ``temperature=0`` decodes greedily; ``keys`` ([B, 2])
    overrides the seed's per-row base keys."""
    check_lm_head(model)
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0; got "
                         f"{max_new_tokens}")
    cfg = model.cfg
    _check_positional_sampling(top_k, top_p, temperature,
                               cfg.vocab_size)
    top_k = top_k or 0
    top_p = top_p or 0.0
    dev = model.device
    prompt = _as_tokens(prompt, dev)
    if max_new_tokens == 0:
        return prompt
    b, p_len = prompt.shape
    _check_budget(model, p_len, max_new_tokens, "prompt")
    if keys is None:
        keys = sample_stream_keys(seed, b, device=dev)
    first_logits, cache = _prefill(model, prompt, chunk=prefill_chunk)
    new = generate_continue_positional(
        model, cache, first_logits, p_len,
        max_new_tokens=max_new_tokens, keys=keys,
        temperature=temperature, top_k=top_k, top_p=top_p,
        eos_id=eos_id, _validated=True)
    return torch.cat([prompt, new], dim=1)


@torch.no_grad()
def prefill(model, prompt, *, chunk: Optional[int] = None,
            cache: Optional[KVCache] = None, position: int = 0):
    """Fill — or EXTEND — a decode cache with ``prompt`` tokens.

    With ``cache=None`` a fresh cache is filled from position 0; with an
    existing ``cache`` (and the ``position`` it has consumed up to) the
    tokens are appended, so ``prefill(suffix, cache=c, position=n)``
    after ``prefill(prefix)`` equals one ``prefill(prefix ++ suffix)``.
    The cache is written in place.  Returns ``(last_position_logits
    [B, V], cache)`` — feed both to :func:`generate_continue`."""
    prompt = _as_tokens(prompt, model.device)
    return _prefill(model, prompt, chunk=chunk, cache=cache,
                    position=position)


@torch.no_grad()
def generate_continue(model, cache: KVCache, last_logits, position: int,
                      *, max_new_tokens: int, temperature: float = 0.0,
                      top_k: Optional[int] = None,
                      top_p: Optional[float] = None, rng=None,
                      eos_id: Optional[int] = None,
                      _validated: bool = False) -> torch.Tensor:
    """Decode ``max_new_tokens`` from a prefilled cache (see
    :func:`prefill`): returns the NEW tokens [B, max_new_tokens].

    Exactness contract: ``generate(model, prompt, ...)`` equals
    ``prompt ++ generate_continue(model, *prefill(model, prompt),
    len(prompt), ...)`` with the same ``rng``."""
    cfg = model.cfg
    if not _validated:
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1; got "
                             f"{max_new_tokens}")
        _check_top_p(top_p)
        _check_top_k(top_k, cfg.vocab_size)
        _check_temperature(temperature)
        _check_budget(model, position, max_new_tokens, "position")
    rng = _default_rng(rng, last_logits.device)

    def apply_step(cache, tok, t):
        out = model(tok[:, None], decode=True, decode_position=position + t,
                    cache=cache)
        return extract_logits(out)[:, -1]

    return _decode_loop(apply_step, cache, last_logits,
                        max_new_tokens=max_new_tokens, rng=rng,
                        temperature=temperature, top_k=top_k, top_p=top_p,
                        eos_id=eos_id)


@torch.no_grad()
def generate_continue_positional(model, cache: KVCache, last_logits,
                                 position: int, *, max_new_tokens: int,
                                 seed: int = 0, keys=None,
                                 temperature=1.0, top_k=None, top_p=None,
                                 eos_id: Optional[int] = None,
                                 _validated: bool = False
                                 ) -> torch.Tensor:
    """Decode from a prefilled cache under the position-keyed schedule
    (:func:`generate_positional`'s split form).  Token indices start at
    0 for the first NEW token whatever ``position`` is."""
    cfg = model.cfg
    if not _validated:
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1; got "
                             f"{max_new_tokens}")
        _check_positional_sampling(top_k, top_p, temperature,
                                   cfg.vocab_size)
        _check_budget(model, position, max_new_tokens, "position")
    top_k = top_k or 0
    top_p = top_p or 0.0
    if keys is None:
        keys = sample_stream_keys(seed, last_logits.shape[0],
                                  device=last_logits.device)

    def apply_step(cache, tok, t):
        out = model(tok[:, None], decode=True, decode_position=position + t,
                    cache=cache)
        return extract_logits(out)[:, -1]

    return _decode_loop_positional(
        apply_step, cache, last_logits, max_new_tokens=max_new_tokens,
        keys=keys, temperature=temperature, top_k=top_k, top_p=top_p,
        eos_id=eos_id)


def _prefill(model, prompt, chunk: Optional[int] = None,
             cache: Optional[KVCache] = None, position: int = 0):
    """Returns (last-position logits [B, V], cache).  Default: one
    forward over the whole prompt; ``chunk`` consumes it ``chunk``
    tokens at a time (the cache is position-keyed, so chunking changes
    memory, never logits)."""
    if chunk is not None and chunk < 1:
        raise ValueError(f"prefill_chunk must be >= 1; got {chunk}")
    b, p_len = prompt.shape
    max_pos = model.cfg.max_position
    if _is_ring(model) and p_len > max_pos:
        # A ring session streams past max_position, but one forward
        # still takes at most max_position tokens: chunk there (and
        # clamp a wider explicit chunk), as the reference does.
        chunk = min(chunk, max_pos) if chunk else max_pos
    if cache is None:
        cache = init_cache(model, b)
        position = 0

    def apply_chunk(toks, pos):
        out = model(toks, decode=True, decode_position=pos,
                    last_only=True, cache=cache)
        return extract_logits(out)[:, -1]

    if not chunk or p_len <= chunk:
        return apply_chunk(prompt, position), cache
    logits = None
    for start in range(0, p_len, chunk):
        logits = apply_chunk(prompt[:, start:start + chunk],
                             position + start)
    return logits, cache


def _rollback_cache(cache: KVCache, new_index) -> None:
    """Rewind a decode cache to ``new_index`` consumed tokens, in place:
    the solo cache's index, or a slot cache's per-row positions (a [B]
    tensor).  No data moves: stale entries past the index are masked by
    absolute position and overwritten by the next append."""
    if cache.positions is not None:
        cache.positions.copy_(torch.as_tensor(
            new_index, device=cache.positions.device))
    else:
        cache.index = int(new_index)


def _check_spec_fits(models, p_len: int, max_new_tokens: int, k: int):
    for m, nm in models:
        max_pos = m.cfg.max_position
        if _is_ring(m):
            # Position-keyed, not capacity-bounded; but a k + 1-wide
            # verify overwrites the K/V ``cap`` positions back, which a
            # partial-acceptance rollback puts back inside the window
            # unless the ring has k - 1 spare slots.
            slack = m.cfg.kv_cache_ring_slack
            if slack < k - 1:
                raise ValueError(
                    f"speculative decoding with k={k} on a ring-cache "
                    f"{nm} model needs kv_cache_ring_slack >= {k - 1} "
                    f"(got {slack}): the verify chunk overwrites up "
                    f"to k-1 still-in-window slots on a rollback")
            continue
        # The final round (entered with at most p_len + max_new_tokens
        # - 2 tokens consumed) appends k + 1 entries.
        if p_len + max_new_tokens + k - 1 > max_pos:
            raise ValueError(
                f"prompt ({p_len}) + max_new_tokens ({max_new_tokens}) "
                f"+ k ({k}) - 1 exceeds the {nm} model's max_position "
                f"({max_pos}); speculative rounds need k-1 slack slots")


@torch.no_grad()
def generate_speculative(model, draft_model, prompt, *,
                         max_new_tokens: int, k: int = 4,
                         eos_id: Optional[int] = None,
                         prefill_chunk: Optional[int] = None,
                         temperature: float = 0.0,
                         top_k: Optional[int] = None,
                         top_p: Optional[float] = None, rng=None,
                         seed: Optional[int] = None,
                         keys=None) -> torch.Tensor:
    """Speculative decoding: ``draft_model`` proposes ``k`` tokens a
    round; ``model`` verifies them in ONE forward of ``k + 1`` tokens.

    Greedy (``temperature=0``): commits the longest prefix where the
    draft matches the target's argmax plus the target's correction, so
    the output equals greedy ``generate``.  Sampled: rejection
    speculative sampling, every committed token an exact sample of the
    target's shaped distribution, from one of two schedules: ``rng``
    (a split chain per round, shaping by ``_modified_logits``) or
    ``seed``/``keys``, the POSITION-KEYED schedule of the engine's
    speculative slots (every draw keyed by (seed, row, token index,
    lane) through ``_spec_draft_row`` / ``_spec_verify_row``), so a
    sampled speculative request returns the same tokens solo or in a
    slot.

    The batch advances in LOCKSTEP by the smallest acceptance of its
    rows (one cache index); rows that verified further re-derive those
    tokens next round.  Commits are capped at ``k`` a round.  Both
    caches rewind by index (``_rollback_cache``).  ``eos_id`` freezes
    a row after its first eos.  Returns [B, P + max_new_tokens]."""
    check_lm_head(model)
    check_lm_head(draft_model)
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1; got "
                         f"{max_new_tokens}")
    _check_spec_k(k)
    sampled = temperature != 0.0
    positional = sampled and (keys is not None or seed is not None)
    if sampled and rng is None and not positional:
        raise ValueError("temperature > 0 requires an rng key or a "
                         "seed (use temperature=0 for greedy "
                         "decoding)")
    if positional and rng is not None:
        raise ValueError(
            "pass either rng (split-chain schedule) or seed/keys "
            "(position-keyed schedule), not both")
    _check_temperature(temperature)
    _check_top_p(top_p)
    _check_top_k(top_k, model.cfg.vocab_size)
    dev = model.device
    prompt = _as_tokens(prompt, dev)
    b, p_len = prompt.shape
    if positional and keys is None:
        keys = sample_stream_keys(seed, b, device=dev)
    _check_spec_fits(((model, "target"), (draft_model, "draft")), p_len,
                     max_new_tokens, k)
    t_logits, t_cache = _prefill(model, prompt, chunk=prefill_chunk)
    _, d_cache = _prefill(draft_model, prompt, chunk=prefill_chunk)
    tk_, tp_ = (top_k or 0), (top_p or 0.0)
    if positional:
        keys = torch.as_tensor(keys, dtype=torch.int64, device=dev)
        first = _sample_positional(t_logits, keys, 0, temperature, tk_,
                                   tp_)
    elif sampled:
        rng, key = prng.split(_default_rng(rng, dev))
        first = _sample(t_logits, key, temperature, top_k, top_p)
    else:
        first = torch.argmax(t_logits, dim=-1)
    buf = torch.zeros((b, max_new_tokens + k), dtype=torch.long,
                      device=dev)
    buf[:, 0] = first
    x, count = first, 1
    while count < max_new_tokens:
        consumed = p_len + count - 1       # tokens both caches hold
        if sampled and not positional:
            rng, r_draft, r_accept, r_res = prng.split(rng, 4)
        d_toks, q_rows, tok = [], [], x
        for j in range(k):
            logits = extract_logits(draft_model(
                tok[:, None], decode=True, decode_position=consumed + j,
                cache=d_cache))[:, -1]
            if positional:
                tok, q = _spec_draft_row(logits, keys, count + j,
                                         temperature, tk_, tp_)
            elif sampled:
                r_draft, sub = prng.split(r_draft)
                q_logits = _modified_logits(logits, temperature, top_k,
                                            top_p)
                tok = prng.categorical(sub, q_logits)
                q = torch.softmax(q_logits.float(), dim=-1)
            else:
                tok, q = torch.argmax(logits, dim=-1), None
            d_toks.append(tok)
            q_rows.append(q)
        d_toks = torch.stack(d_toks, dim=1)                  # [B, k]
        chunk = torch.cat([x[:, None], d_toks], dim=1)
        t_all = extract_logits(model(chunk, decode=True,
                                     decode_position=consumed,
                                     cache=t_cache))         # [B, k+1, V]
        if positional:
            out_toks, c_rows, _ = _spec_verify_row(
                t_all[:, :k], d_toks, torch.stack(q_rows, dim=1), keys,
                count, temperature, tk_, tp_, k)
            # Lockstep advance by the batch minimum; the tokens stay
            # per-row exact (every draw is keyed by row and index).
            c = int(c_rows.min())
        elif sampled:
            p_logits = _modified_logits(t_all[:, :k], temperature,
                                        top_k, top_p)
            p_rows = torch.softmax(p_logits.float(), dim=-1)  # [B, k, V]
            q_rows = torch.stack(q_rows, dim=1)
            px = p_rows.gather(-1, d_toks[..., None])[..., 0]
            qx = q_rows.gather(-1, d_toks[..., None])[..., 0]
            u = prng.uniform(r_accept, (b, k))
            accept = u * qx < px
            m_row = torch.cumprod(accept.long(), dim=1).sum(1)
            c = min(int(m_row.min()) + 1, k)
            # Residual resample at every position; only each row's
            # first-rejection column is ever committed.
            res = prng.categorical(
                r_res, torch.log(torch.clamp_min(p_rows - q_rows, 0.0)
                                 + 1e-20))
            cols = torch.arange(k, device=dev)[None, :]
            out_toks = torch.where(cols < m_row[:, None], d_toks, res)
        else:
            t_toks = torch.argmax(t_all, dim=-1)             # [B, k+1]
            matches = d_toks == t_toks[:, :k]
            m_row = torch.cumprod(matches.long(), dim=1).sum(1)
            c = min(int(m_row.min()) + 1, k)
            out_toks = t_toks[:, :k]
        # A k-wide window at count; the next round overwrites past c.
        buf[:, count:count + k] = out_toks
        x = out_toks[:, c - 1]
        _rollback_cache(t_cache, consumed + c)
        _rollback_cache(d_cache, consumed + c)
        count += c
    new = buf[:, :max_new_tokens]
    if eos_id is not None:
        hit = torch.cumsum(torch.cumsum((new == eos_id).long(), dim=1),
                           dim=1) > 1
        new = torch.where(hit, torch.full_like(new, eos_id), new)
    return torch.cat([prompt, new], dim=1)


@torch.no_grad()
def generate_beam(model, prompt, *, max_new_tokens: int,
                  num_beams: int = 4, eos_id: Optional[int] = None,
                  length_penalty: float = 1.0,
                  prefill_chunk: Optional[int] = None) -> torch.Tensor:
    """Beam search with the KV cache tiled per beam.  Returns the
    highest-scoring sequence per row, [B, P + max_new_tokens]: scores
    are summed token log-probs divided by ``len ** length_penalty``;
    finished beams (eos) freeze their score and keep emitting eos.
    ``num_beams=1`` is greedy search."""
    check_lm_head(model)
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1; got "
                         f"{max_new_tokens}")
    if num_beams < 1:
        raise ValueError(f"num_beams must be >= 1; got {num_beams}")
    dev = model.device
    prompt = _as_tokens(prompt, dev)
    b, p_len = prompt.shape
    _check_budget(model, p_len, max_new_tokens, "prompt")
    first_logits, cache = _prefill(model, prompt, chunk=prefill_chunk)

    def apply_step(cache, toks_flat, t):
        out = model(toks_flat, decode=True, decode_position=p_len + t,
                    cache=cache)
        return extract_logits(out)[:, -1]

    seq = _beam_loop(apply_step, cache, first_logits, b=b,
                     max_new_tokens=max_new_tokens, num_beams=num_beams,
                     eos_id=eos_id, length_penalty=length_penalty)
    return torch.cat([prompt, seq], dim=1)


def _beam_loop(apply_step, cache: KVCache, first_logits, *, b: int,
               max_new_tokens: int, num_beams: int,
               eos_id: Optional[int], length_penalty: float):
    """Beam search over a prefilled batch-B cache: the cache is tiled to
    B*K rows, b-major ([layers, B*K, cap, H, D]; an int8 cache's scales
    with them), and every step gathers its rows by parent.  A ring's
    position table has no batch axis (beams decode in lockstep, so they
    share it) and is neither tiled nor reordered; a seq2seq cache's
    cross K/V are tiled but never reordered (``T5Cache``: they are
    beam-invariant).  ``apply_step(cache,
    toks [B*K, 1], t) -> logits [B*K, V]``.  Returns the generated
    tokens [B, max_new_tokens]."""
    k = num_beams
    dev = first_logits.device
    lp = torch.log_softmax(first_logits.float(), dim=-1)
    vocab = lp.shape[-1]
    scores, first = torch.topk(lp, k, dim=-1)                # [B, K]
    cache = cache.tile_rows(k)
    done = (first == eos_id) if eos_id is not None \
        else torch.zeros((b, k), dtype=torch.bool, device=dev)
    # Per-beam generated length at finish (the length-penalty
    # denominator); unfinished beams hold the full budget.
    fin_len = torch.where(done, 1.0, float(max_new_tokens))
    frozen = None
    if eos_id is not None:
        # A finished beam has exactly one continuation, eos at no cost:
        # it competes but never forks.
        frozen = torch.full((vocab,), float("-inf"), device=dev)
        frozen[eos_id] = 0.0
    tok, toks, parents = first, [], []
    rows = torch.arange(b, device=dev)[:, None] * k
    for t in range(max_new_tokens - 1):
        logits = apply_step(cache, tok.reshape(b * k, 1), t)
        lp = torch.log_softmax(logits.float(), dim=-1).reshape(b, k, vocab)
        if frozen is not None:
            lp = torch.where(done[..., None], frozen, lp)
        cand = scores[..., None] + lp                         # [B, K, V]
        scores, flat = torch.topk(cand.reshape(b, k * vocab), k, dim=-1)
        parent = flat // vocab
        tok = flat % vocab
        flat_parent = (rows + parent).reshape(-1)
        cache = cache.take_rows(flat_parent)
        done = done.gather(1, parent)
        fin_len = fin_len.gather(1, parent)
        if eos_id is not None:
            newly = ~done & (tok == eos_id)
            # The token of loop step t is generated token t + 2.
            fin_len = torch.where(newly, float(t + 2), fin_len)
            done = done | newly
        toks.append(tok)
        parents.append(parent)
    # Backtrack the best beam from the last step to the first.
    beam = torch.argmax(scores / fin_len ** length_penalty, dim=-1)
    rev = []
    for tok_t, parent_t in zip(reversed(toks), reversed(parents)):
        rev.append(tok_t.gather(1, beam[:, None])[:, 0])
        beam = parent_t.gather(1, beam[:, None])[:, 0]
    first_tok = first.gather(1, beam[:, None])[:, 0]
    return torch.stack([first_tok] + rev[::-1], dim=1)


def _check_seq2seq(model, max_new_tokens: int) -> None:
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1; got "
                         f"{max_new_tokens}")
    max_pos = model.cfg.max_position
    if max_new_tokens > max_pos:
        # Cache slots used: the start token at 0 plus the fed-back
        # tokens at 1..max_new_tokens-1 (the last is never fed back).
        raise ValueError(
            f"max_new_tokens ({max_new_tokens}) exceeds the decoder's "
            f"max_position ({max_pos})")


def _seq2seq_start(model, enc_tokens, enc_mask, start_id):
    """(encoder output, mask tensor or None, start tokens [B, 1])."""
    dev = model.device
    enc_tokens = _as_tokens(enc_tokens, dev)
    if enc_mask is not None:
        enc_mask = torch.as_tensor(enc_mask, device=dev)
    if start_id is None:
        start_id = model.cfg.pad_id
    enc_out = model.encode(enc_tokens, enc_mask=enc_mask)
    start = torch.full((enc_tokens.shape[0], 1), start_id,
                       dtype=torch.long, device=dev)
    return enc_out, enc_mask, start


def _seq2seq_step(model, enc_out, enc_mask):
    """``apply_step(cache, toks [B, 1], pos) -> logits [B, V]``: one
    cached decoder step at absolute position ``pos``."""
    def apply_step(cache, toks, pos):
        out = model.decode(toks, enc_out, enc_mask, decode=True,
                           decode_position=pos, last_only=True,
                           cache=cache)
        return out[:, -1]
    return apply_step


@torch.no_grad()
def generate_seq2seq(model, enc_tokens, *, max_new_tokens: int,
                     temperature: float = 0.0,
                     top_k: Optional[int] = None,
                     top_p: Optional[float] = None, rng=None,
                     eos_id: Optional[int] = None, enc_mask=None,
                     start_id: Optional[int] = None) -> torch.Tensor:
    """Seq2seq generation (T5): encode ``enc_tokens`` [B, S] once, then
    decode token by token from an empty cache, whose first step (the
    start token, ``cfg.pad_id`` unless ``start_id``) projects the
    cross-attention K/V.  Token i draws with the i-th key of the chain
    from ``rng`` (default ``PRNGKey(0)``); ``eos_id`` freezes finished
    rows.  Returns the GENERATED tokens [B, max_new_tokens]."""
    _check_seq2seq(model, max_new_tokens)
    _check_top_p(top_p)
    _check_top_k(top_k, model.cfg.vocab_size)
    _check_temperature(temperature)
    enc_out, enc_mask, start = _seq2seq_start(model, enc_tokens, enc_mask,
                                              start_id)
    rng = _default_rng(rng, enc_out.device)
    step = _seq2seq_step(model, enc_out, enc_mask)
    cache = model.init_decode_cache(start.shape[0])
    logits = step(cache, start, 0)
    return _decode_loop(
        lambda cache, tok, t: step(cache, tok[:, None], 1 + t), cache,
        logits, max_new_tokens=max_new_tokens, rng=rng,
        temperature=temperature, top_k=top_k, top_p=top_p, eos_id=eos_id)


@torch.no_grad()
def generate_beam_seq2seq(model, enc_tokens, *, max_new_tokens: int,
                          num_beams: int = 4,
                          eos_id: Optional[int] = None,
                          length_penalty: float = 1.0, enc_mask=None,
                          start_id: Optional[int] = None) -> torch.Tensor:
    """Beam search for seq2seq (T5): encode once, run the start step on
    the batch (it projects the cross K/V), then beam over the decoder
    cache tiled per beam (:func:`_beam_loop`); the encoder mask is tiled
    b-major for the cross-attention.  Returns the highest-scoring
    GENERATED tokens [B, max_new_tokens]."""
    _check_seq2seq(model, max_new_tokens)
    if num_beams < 1:
        raise ValueError(f"num_beams must be >= 1; got {num_beams}")
    enc_out, enc_mask, start = _seq2seq_start(model, enc_tokens, enc_mask,
                                              start_id)
    b = start.shape[0]
    cache = model.init_decode_cache(b)
    first = _seq2seq_step(model, enc_out, enc_mask)(cache, start, 0)
    step = _seq2seq_step(
        model, enc_out.repeat_interleave(num_beams, dim=0),
        None if enc_mask is None
        else enc_mask.repeat_interleave(num_beams, dim=0))
    return _beam_loop(lambda cache, toks, t: step(cache, toks, 1 + t),
                      cache, first, b=b, max_new_tokens=max_new_tokens,
                      num_beams=num_beams, eos_id=eos_id,
                      length_penalty=length_penalty)
