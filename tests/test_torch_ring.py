"""The O(window) ring KV cache of the port (``kv_cache_ring``) against
the JAX reference, on mistral-tiny (window 31, max_position 256) in
float32 with the reference's weights carried across.

A ring holds ``window + 1 + slack`` slots (32 with no slack) keyed by
``position % cap``, so a session streams past ``max_position``.

- A prompt at least the ring's capacity: tokens equal the reference
  ring's, solo (greedy, sampled, int8 KV, beam, speculative) and past
  ``max_position``, the prefill auto-chunked at ``max_position`` when
  the prompt itself is longer.
- A shorter prompt: tokens equal the reference's PLAIN cache (see
  ``test_short_prompt_equals_reference_plain_cache``).
- Speculative decoding needs ``kv_cache_ring_slack >= k - 1``; the
  fixed-lane engine equals solo; the paged pool refuses a ring.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from polyaxon_tpu.models import generate as JG
from polyaxon_tpu_torch.cli import main as cli_main
from polyaxon_tpu_torch.models import generate as TG
from polyaxon_tpu_torch.serving import (DecodeEngine, SamplingSpec,
                                        SchedulerPolicy)

from test_torch_int8_kv import SAMPLED, make_pair

torch.set_num_threads(2)

NAME = "mistral-tiny"
RING = dict(kv_cache_ring=True)
CAP = 32                        # window 31 + 1, no slack


def _prompt(seed, n, rows=1):
    return np.random.RandomState(seed).randint(0, 512, (rows, n))


_PAIRS = {}


def _pair(**over):
    key = tuple(sorted(over.items()))
    if key not in _PAIRS:
        _PAIRS[key] = make_pair(NAME, **over)
    return _PAIRS[key]


def _ref(jmodel, variables, p, new, **kw):
    return np.asarray(JG.generate(jmodel, variables, jnp.asarray(p),
                                  max_new_tokens=new, **kw))


def test_long_prompt_equals_reference_ring_past_max_position():
    """A 40-token prompt (>= the ring's 32 slots, so the prefill writes
    every slot) and 260 new tokens: 300 positions, past max_position
    256.  Greedy with and without a chunked prefill, and sampled."""
    jm, var, tm = _pair(**RING)
    p = _prompt(1, 40, rows=2)
    want = _ref(jm, var, p, 260)
    assert want.shape[1] > tm.cfg.max_position
    for chunk in (None, 16):
        got = TG.generate(tm, p, max_new_tokens=260, prefill_chunk=chunk)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=chunk)
    want = np.asarray(JG.generate_positional(
        jm, var, jnp.asarray(p), max_new_tokens=60, seed=2, **SAMPLED))
    got = TG.generate_positional(tm, p, max_new_tokens=60, seed=2,
                                 **SAMPLED)
    np.testing.assert_array_equal(got.numpy(), want)
    cache = TG.prefill(tm, p)[1]
    assert cache.capacity == CAP and cache.ring_pos.shape == (CAP,)


def test_prompt_past_max_position_auto_chunks():
    """A 300-token prompt on a model of max_position 256: one forward
    takes at most 256 tokens, so the prefill chunks there (an explicit
    wider chunk is clamped), as the reference's does."""
    jm, var, tm = _pair(**RING)
    p = _prompt(2, 300)
    want = _ref(jm, var, p, 12)
    for chunk in (None, 280):
        got = TG.generate(tm, p, max_new_tokens=12, prefill_chunk=chunk)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=chunk)


def test_short_prompt_equals_reference_plain_cache():
    """A prompt SHORTER than the ring (10 < 32 slots) decodes to the
    reference's PLAIN-cache tokens, not its ring's.

    ``append_ring_kv_cache`` documents that unwritten ring slots hold
    position -1, and the port's ``init_cache`` starts them there.  The
    reference's ``generate.init_cache`` instead zero-fills every cache
    leaf, ``cached_pos`` included, so until the prompt has written all
    32 slots each unwritten slot claims position 0 with zero K/V and
    passes both the window and the ring-older tests: its ring tokens
    leave its plain cache's from the second new token on (this input).
    The plain cache is what the documented contract computes, and the
    JAX package stays as it is."""
    jm, var, tm = _pair(**RING)
    jplain, _, _ = _pair()
    p = np.arange(1, 11)[None]
    plain = _ref(jplain, var, p, 40)
    ring = _ref(jm, var, p, 40)
    assert (plain != ring).any()            # the reference's own split
    got = TG.generate(tm, p, max_new_tokens=40)
    np.testing.assert_array_equal(got.numpy(), plain)


def test_int8_ring_equals_reference():
    jm, var, tm = _pair(kv_cache_int8=True, **RING)
    p = _prompt(3, 36, rows=2)
    np.testing.assert_array_equal(
        TG.generate(tm, p, max_new_tokens=250).numpy(),
        _ref(jm, var, p, 250))
    cache = TG.prefill(tm, p)[1]
    assert cache.k.dtype == torch.int8 and cache.k_scale.shape[2] == CAP


def test_beam_on_ring_equals_reference():
    """Beam search tiles and reorders the ring's entries per beam; the
    position table has no batch axis and is shared by every beam."""
    jm, var, tm = _pair(**RING)
    p = _prompt(4, 34, rows=2)
    want = np.asarray(JG.generate_beam(jm, var, jnp.asarray(p),
                                       max_new_tokens=20, num_beams=3))
    got = TG.generate_beam(tm, p, max_new_tokens=20, num_beams=3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_speculative_on_ring_needs_slack():
    """k = 3 with slack 2 (k - 1): greedy and sampled speculative tokens
    equal the reference's, past max_position; slack 1 is refused by
    both packages with the same reason."""
    jt, vt, tt = _pair(kv_cache_ring_slack=2, **RING)
    jd, vd, td = _pair(num_layers=1, seed=7, kv_cache_ring_slack=2,
                       **RING)
    p = _prompt(5, 40)
    for kw in ({}, dict(seed=4, **SAMPLED)):
        want = np.asarray(JG.generate_speculative(
            jt, vt, jd, vd, jnp.asarray(p), max_new_tokens=230, k=3,
            **kw))
        got = TG.generate_speculative(tt, td, p, max_new_tokens=230, k=3,
                                      **kw)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(kw))
    j1, v1, t1 = _pair(kv_cache_ring_slack=1, **RING)
    with pytest.raises(ValueError, match="kv_cache_ring_slack >= 2") as e:
        TG.generate_speculative(t1, t1, p, max_new_tokens=8, k=3)
    with pytest.raises(ValueError) as r:
        JG.generate_speculative(j1, v1, j1, v1, jnp.asarray(p),
                                max_new_tokens=8, k=3)
    assert str(e.value) == str(r.value)


@pytest.mark.parametrize("int8", [False, True])
def test_fixed_lane_engine_equals_solo(int8):
    """Two residents past max_position on the fixed-lane pool, whose
    lanes are the 32-slot rings: a greedy stream and a sampled one, a
    third admitted mid-run — each equals solo (the port's and the
    reference's one-shot prefill).  The plain ring prefills in chunks
    of 16, which changes nothing in the port.  (The reference's chunked
    prefill of these prompts differs from its one-shot one: a chunk
    shorter than the ring leaves zero-filled slots at position 0 that
    the next chunk admits, the fault of
    ``test_short_prompt_equals_reference_plain_cache``.)  The int8 ring
    prefills each prompt in one piece: a chunk attends to its own
    entries unquantized and to older ones as stored, so there the
    chunking is part of the result in both packages."""
    over = dict(kv_cache_int8=int8, **RING)
    jm, var, tm = _pair(**over)
    eng = DecodeEngine(tm, autostart=False, policy=SchedulerPolicy(
        n_slots=2, decode_window=4, prefill_chunk=None if int8 else 16))
    pa, pb, pc = _prompt(6, 40), _prompt(7, 33), _prompt(8, 35)
    a = eng.submit(pa, 240, None, None)
    b = eng.submit(pb, 230, None, None,
                   sampling=SamplingSpec(seed=3, **SAMPLED))
    for _ in range(3):
        eng.tick()
    c = eng.submit(pc, 30, None, None)
    eng.run_until_idle()
    assert eng.slots._k.shape[2] == CAP
    assert eng.slots._pool.ring_pos.shape == (2, CAP)
    for g, p, new in ((a, pa, 240), (c, pc, 30)):
        want = _ref(jm, var, p, new)
        assert g.result().tolist() == want.tolist()
        assert g.result().tolist() == TG.generate(
            tm, p, max_new_tokens=new).tolist()
    want = JG.generate_positional(jm, var, jnp.asarray(pb),
                                  max_new_tokens=230, seed=3, **SAMPLED)
    assert b.result().tolist() == np.asarray(want).tolist()


def test_spec_engine_on_ring():
    """A speculative pool over rings: spec_k_cap 3 needs slack 2 in both
    models (every resident writes a 4-wide verify chunk a round);
    speculative and plain co-tenants then equal solo."""
    _, _, tt = _pair(kv_cache_ring_slack=2, **RING)
    _, _, td = _pair(num_layers=1, seed=7, kv_cache_ring_slack=2, **RING)
    eng = DecodeEngine(tt, autostart=False, draft_model=td,
                       policy=SchedulerPolicy(n_slots=2, decode_window=2,
                                              spec_k_cap=3))
    pa, pb = _prompt(9, 36), _prompt(10, 40)
    a = eng.submit(pa, 240, None, None, sampling=SamplingSpec(
        seed=0, temperature=0.0, spec_k=3))
    b = eng.submit(pb, 30, None, None)
    eng.run_until_idle()
    assert a.result().tolist() == TG.generate(
        tt, pa, max_new_tokens=240).tolist()
    assert b.result().tolist() == TG.generate(
        tt, pb, max_new_tokens=30).tolist()
    _, _, t0 = _pair(**RING)
    with pytest.raises(ValueError, match="kv_cache_ring_slack >= "
                                         "spec_k_cap-1"):
        DecodeEngine(t0, autostart=False, draft_model=td,
                     policy=SchedulerPolicy(n_slots=2, spec_k_cap=3))


def test_paged_ring_refused():
    """The paged pool keeps plain/int8 max_position caches: the engine
    and ``serve`` refuse a ring with the reference's words."""
    _, _, tm = _pair(**RING)
    with pytest.raises(ValueError, match="ring caches keep the "
                                         "fixed-lane manager"):
        DecodeEngine(tm, autostart=False, policy=SchedulerPolicy(
            n_slots=2, kv_paged=True, kv_page_tokens=8))
    out = CliRunner().invoke(cli_main.cli, [
        "serve", "--model", NAME, "--cpu", "--kv-ring", "--kv-paged"])
    assert out.exit_code != 0
    assert "cannot combine with --kv-ring (the ring is already " \
        "O(window))" in out.output


def test_capture_warm_up_leaves_the_ring_as_it_found_it():
    """A CUDA-graph capture first runs its window once (the warm-up) on
    the live pool.  On a ring that run overwrites in-window entries at
    ``position % cap`` ahead of where the replay starts, so the pool puts
    the ring back after it (``_run_restoring``): a window run after a
    restored warm-up gives the tokens and the ring of one run alone."""
    _, _, tm = _pair(**RING)
    tokens, rings = [], []
    for warm_up in (False, True):
        eng = DecodeEngine(tm, autostart=False, policy=SchedulerPolicy(
            n_slots=2, decode_window=8))
        for seed in (11, 12):
            eng.submit(_prompt(seed, 40), 30, None, None)
        while len(eng._resident) < 2:
            eng.tick()
        pool = eng.slots
        assert pool._capture_state()
        pool._load_state()
        if warm_up:
            pool._run_restoring(lambda: pool._body(8))
            pool._load_state()
        pool._body(8)
        tokens.append(pool._outs.clone())
        rings.append([t.clone() for t in pool._capture_state()])
    assert torch.equal(tokens[0], tokens[1])
    assert all(torch.equal(a, b) for a, b in zip(*rings))
