"""Autoregressive generation with a KV cache — greedy decoding.

Port of the greedy half of ``polyaxon_tpu/models/generate.py``.  The
model holds its own weights (an ``nn.Module``), so the entry points take
``model`` where the reference takes ``model, variables``.  Prefill runs
one forward over the whole prompt — or fixed-size pieces with
``prefill_chunk`` — then a Python loop decodes token by token.  Sampled
decoding (temperature > 0) needs the reference's threefry stream
bit-for-bit and comes with a later slice; until then it raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kv_cache import KVCache


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


def _check_greedy(temperature) -> None:
    _check_temperature(temperature)
    if temperature != 0.0:
        raise NotImplementedError(
            "sampled decoding (temperature > 0) is not ported yet: it "
            "needs the reference's threefry stream bit-for-bit and comes "
            "with the sampled-decoding slice; use temperature=0")


def _sample(logits, temperature: float):
    """Greedy only: the first index of the row maximum (as jnp.argmax)."""
    _check_greedy(temperature)
    return torch.argmax(logits, dim=-1)


def _decode_loop(apply_step, cache, first_logits, *,
                 max_new_tokens: int, temperature: float,
                 eos_id: Optional[int]):
    """Sample-first, then one ``apply_step(cache, tok, t) -> logits``
    per token; ``eos_id`` freezes finished rows (they keep emitting
    eos).  Returns the new tokens [B, max_new_tokens]."""
    tok = _sample(first_logits, temperature)
    done = torch.zeros_like(tok, dtype=torch.bool)
    if eos_id is not None:
        done = tok == eos_id
    out = [tok]
    for t in range(max_new_tokens - 1):
        logits = apply_step(cache, tok, t)
        nxt = _sample(logits, temperature)
        if eos_id is not None:
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
        tok = nxt
        out.append(tok)
    return torch.stack(out, dim=1)


def _as_tokens(prompt, device) -> torch.Tensor:
    return torch.as_tensor(prompt, dtype=torch.long, device=device)


@torch.no_grad()
def generate(model, prompt, *, max_new_tokens: int,
             temperature: float = 0.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None, eos_id: Optional[int] = None,
             prefill_chunk: Optional[int] = None) -> torch.Tensor:
    """Generate ``max_new_tokens`` continuations of ``prompt`` [B, P]
    (a shared prompt length).  Returns [B, P + max_new_tokens].
    ``temperature=0`` is greedy; ``eos_id`` freezes finished rows."""
    if max_new_tokens < 0:
        raise ValueError(f"max_new_tokens must be >= 0; got "
                         f"{max_new_tokens}")
    _check_top_p(top_p)
    cfg = model.cfg
    _check_top_k(top_k, cfg.vocab_size)
    _check_greedy(temperature)
    prompt = _as_tokens(prompt, model.wte.weight.device)
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
        temperature=temperature, top_k=top_k, top_p=top_p, eos_id=eos_id,
        _validated=True)
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
                      top_p: Optional[float] = None,
                      eos_id: Optional[int] = None,
                      _validated: bool = False) -> torch.Tensor:
    """Decode ``max_new_tokens`` from a prefilled cache (see
    :func:`prefill`): returns the NEW tokens [B, max_new_tokens].

    Exactness contract: ``generate(model, prompt, ...)`` equals
    ``prompt ++ generate_continue(model, *prefill(model, prompt),
    len(prompt), ...)``."""
    cfg = model.cfg
    if not _validated:
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1; got "
                             f"{max_new_tokens}")
        _check_top_p(top_p)
        _check_top_k(top_k, cfg.vocab_size)
        _check_greedy(temperature)
        if position + max_new_tokens > cfg.max_position:
            raise ValueError(
                f"position ({position}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the model's max_position "
                f"({cfg.max_position})")

    def apply_step(cache, tok, t):
        out = model(tok[:, None], decode=True, decode_position=position + t,
                    cache=cache)
        return extract_logits(out)[:, -1]

    return _decode_loop(apply_step, cache, last_logits,
                        max_new_tokens=max_new_tokens,
                        temperature=temperature, eos_id=eos_id)


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
