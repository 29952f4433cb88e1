"""Autoregressive generation with a KV cache: greedy and sampled.

Port of ``polyaxon_tpu/models/generate.py`` (greedy, the chain-keyed
sampled ``generate`` and the position-keyed ``generate_positional``).
The model holds its own weights (an ``nn.Module``), so the entry points
take ``model`` where the reference takes ``model, variables``.  Prefill
runs one forward over the whole prompt — or fixed-size pieces with
``prefill_chunk`` — then a Python loop decodes token by token.  Random
draws go through ``polyaxon_tpu_torch.prng``, jax's threefry stream bit
for bit, so a seed draws the reference's random bits; keys are int64
``[2]`` tensors (``prng.PRNGKey``).  Beam search and speculative
decoding come with a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import prng
from .kv_cache import KVCache

NEG = -1e30
M32 = 0xFFFFFFFF


def init_cache(model, batch_size: int) -> KVCache:
    """A zeroed decode cache for a decoder-only ``model``:
    [layers, B, max_position, H, D] in the model's dtype, index 0."""
    cfg = model.cfg
    shape = (cfg.num_layers, batch_size, cfg.max_position, cfg.num_heads,
             cfg.hidden_size // cfg.num_heads)
    dev = model.wte.weight.device
    return KVCache(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   torch.zeros(shape, dtype=cfg.dtype, device=dev))


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
    base = prng.PRNGKey(seed, device=device)
    return prng.fold_in(base.expand(rows, 2),
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
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0; got "
                         f"{max_new_tokens}")
    _check_top_p(top_p)
    cfg = model.cfg
    _check_top_k(top_k, cfg.vocab_size)
    _check_temperature(temperature)
    dev = model.wte.weight.device
    rng = _default_rng(rng, dev)
    prompt = _as_tokens(prompt, dev)
    if max_new_tokens == 0:
        return prompt
    b, p_len = prompt.shape
    total = p_len + max_new_tokens
    if total > cfg.max_position:
        # Past max_position the cache write and the wpe lookup have no
        # slot — refuse up front.
        raise ValueError(
            f"prompt ({p_len}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds the model's max_position ({cfg.max_position})")
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
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0; got "
                         f"{max_new_tokens}")
    cfg = model.cfg
    _check_positional_sampling(top_k, top_p, temperature,
                               cfg.vocab_size)
    top_k = top_k or 0
    top_p = top_p or 0.0
    dev = model.wte.weight.device
    prompt = _as_tokens(prompt, dev)
    if max_new_tokens == 0:
        return prompt
    b, p_len = prompt.shape
    if p_len + max_new_tokens > cfg.max_position:
        raise ValueError(
            f"prompt ({p_len}) + max_new_tokens ({max_new_tokens}) "
            f"exceeds the model's max_position ({cfg.max_position})")
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
    prompt = _as_tokens(prompt, model.wte.weight.device)
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
        if position + max_new_tokens > cfg.max_position:
            raise ValueError(
                f"position ({position}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the model's max_position "
                f"({cfg.max_position})")
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
        if position + max_new_tokens > cfg.max_position:
            raise ValueError(
                f"position ({position}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the model's max_position "
                f"({cfg.max_position})")
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
