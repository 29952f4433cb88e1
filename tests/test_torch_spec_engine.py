"""Speculative slots in the port's continuous-batching engine, held
against the JAX package's ``DecodeEngine`` with the same flax weights
(float32, converted for the port).

The schedules of the reference's ``tests/test_spec_engine.py`` run on
both engines; the port's runs on the fixed-lane pool and the paged pool
(eager and lazy reservation).  Tokens and the ``spec_rounds`` /
``spec_drafted`` / ``spec_accepted`` counters are held EQUAL to the
reference engine's, and tokens to the solo ``generate_speculative``
(seed mode) / greedy ``generate``.  Also: gpt2-tiny, llama-tiny and
mistral-tiny (its window) speculative engines on both pools, the
refusals, and ``TestRollbackMasking`` for the plain cache, the int8
cache and the ring.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import generate as JG
from polyaxon_tpu.serving import DecodeEngine as JEngine
from polyaxon_tpu.serving import SchedulerPolicy as JPolicy
from polyaxon_tpu.serving.scheduler import SamplingSpec as JSpec
from polyaxon_tpu_torch.models import generate as TG
from polyaxon_tpu_torch.serving import (DecodeEngine, SamplingSpec,
                                        SchedulerPolicy)

from test_torch_speculative import FAMILIES, _jax_model, _port, \
    _vocab32_pair

torch.set_num_threads(2)

PROMPT = np.asarray([[3, 1, 4, 1]])
SPEC = dict(temperature=0.9, top_k=16)
POOLS = {"fixed": {}, "paged": {"kv_paged": True, "kv_page_tokens": 8},
         "lazy": {"kv_paged": True, "kv_page_tokens": 8,
                  "kv_lazy": True}}


@pytest.fixture(scope="module")
def pair():
    """The vocab-32 target and an independent draft (low acceptance)."""
    return _vocab32_pair(0), _vocab32_pair(99)


def _engines(pair, pool, **policy):
    """(reference engine, port engine) on the same weights."""
    (jt, vt, tt), (jd, vd, td) = pair
    kw = {**dict(n_slots=4, decode_window=8, spec_k_cap=4), **policy}
    jeng = JEngine(jt, vt, autostart=False, policy=JPolicy(**kw),
                   draft_model=jt, draft_variables=vd)
    teng = DecodeEngine(tt, autostart=False, draft_model=td,
                        policy=SchedulerPolicy(**kw, **POOLS[pool]))
    return jeng, teng


def _run(eng, spec_cls, schedule):
    """Drive ``schedule`` — (tick before submit, prompt, new, eos,
    sampling kwargs) — and return every group's tokens and the spec
    counters."""
    groups = []
    for ticks, prompt, new, eos, samp in schedule:
        for _ in range(ticks):
            eng.tick()
        groups.append(eng.submit(np.asarray(prompt), new, eos, None,
                                 sampling=spec_cls(**samp)
                                 if samp is not None else None))
    eng.run_until_idle()
    st = eng.stats()
    return ([g.result().tolist() for g in groups],
            {k: st[k] for k in ("spec_rounds_total", "spec_drafted_total",
                                "spec_accepted_total",
                                "admitted_spec_total",
                                "completed_spec_total")})


SCHEDULES = {
    # the reference's three schedules of one sampled spec request
    "alone": [(0, PROMPT, 12, None, dict(seed=7, spec_k=3, **SPEC))],
    "mid_flight": [
        (0, [[2, 7, 1, 8]], 16, None, None),
        (0, [[5, 6, 7, 8]], 16, None, dict(seed=3, temperature=1.0)),
        (3, PROMPT, 12, None, dict(seed=7, spec_k=3, **SPEC))],
    "mixed_k": [(0, PROMPT, 12, None, dict(seed=7, spec_k=4, **SPEC)),
                (0, [[9, 8, 7, 6]], 12, None,
                 dict(seed=11, spec_k=2, **SPEC))],
    "greedy": [(0, PROMPT, 12, None, dict(seed=0, spec_k=3)),
               (1, [[4, 4, 2, 2]], 9, None, None)],
}
_REFERENCE = {}


def _reference(pair, name):
    if name not in _REFERENCE:
        jeng, _ = _engines(pair, "fixed")
        _REFERENCE[name] = _run(jeng, JSpec, SCHEDULES[name])
    return _REFERENCE[name]


@pytest.mark.parametrize("pool", sorted(POOLS))
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_spec_engine_equals_reference_engine(pair, name, pool):
    want = _reference(pair, name)
    _, teng = _engines(pair, pool)
    got = _run(teng, SamplingSpec, SCHEDULES[name])
    assert got == want


def test_spec_requests_equal_solo(pair):
    """The engine's spec slots equal the solo references: seed mode
    for sampled spec, greedy generate for greedy spec, and the
    co-tenants their own solo decodes."""
    (_, _, tt), (_, _, td) = pair
    toks, _ = _reference(pair, "mid_flight")
    assert toks[0] == TG.generate(tt, [[2, 7, 1, 8]],
                                  max_new_tokens=16).tolist()
    assert toks[1] == TG.generate_positional(
        tt, [[5, 6, 7, 8]], max_new_tokens=16, seed=3,
        temperature=1.0).tolist()
    assert toks[2] == TG.generate_speculative(
        tt, td, PROMPT, max_new_tokens=12, k=3, seed=7, **SPEC).tolist()
    toks, _ = _reference(pair, "greedy")
    assert toks[0] == TG.generate(tt, PROMPT, max_new_tokens=12).tolist()


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_eos_mid_round_and_windows_match_solo(pair, pool):
    """An eos inside a round's committed prefix freezes the stream as
    solo does; decode_window 1 and 8 give the same tokens."""
    (_, _, tt), (_, _, td) = pair
    free = TG.generate_speculative(tt, td, PROMPT, max_new_tokens=12,
                                   k=3, seed=7, **SPEC)[0, 4:].tolist()
    eos = next(tok for i, tok in enumerate(free)
               if i >= 2 and tok not in free[:i])
    want = TG.generate_speculative(tt, td, PROMPT, max_new_tokens=12,
                                   k=3, seed=7, eos_id=eos,
                                   **SPEC).tolist()
    for window in (1, 8):
        _, eng = _engines(pair, pool, decode_window=window)
        g = eng.submit(PROMPT, 12, eos, None,
                       sampling=SamplingSpec(seed=7, spec_k=3, **SPEC))
        eng.run_until_idle()
        assert g.result().tolist() == want


def test_spec_never_blocks_greedy_admission(pair):
    """A long speculative resident lets short greedy co-tenants admit
    and finish first, each with its solo tokens."""
    (_, _, tt), _ = pair
    _, eng = _engines(pair, "fixed", n_slots=2)
    spec = eng.submit(PROMPT, 40, None, None,
                      sampling=SamplingSpec(seed=7, spec_k=3, **SPEC))
    while not eng._resident:
        eng.tick()
    shorts = [eng.submit(np.asarray([[i, 1, 2, 3]]), 3, None, None)
              for i in range(3)]
    while not all(s.event.is_set() for s in shorts):
        assert not spec.event.is_set()
        eng.tick()
    eng.run_until_idle()
    for i, s in enumerate(shorts):
        assert s.result().tolist() == TG.generate(
            tt, [[i, 1, 2, 3]], max_new_tokens=3).tolist()
    assert spec.event.is_set()


def test_acceptance_counters_flow(pair):
    """Self draft: every proposal accepts, the histogram's top buckets
    take the one observation, and the tokens are greedy generate's."""
    (_, _, tt), _ = pair
    eng = DecodeEngine(tt, autostart=False, draft_model=tt,
                       policy=SchedulerPolicy(n_slots=2, decode_window=1))
    g = eng.submit(PROMPT, 9, None, None, sampling=SamplingSpec(spec_k=4))
    eng.run_until_idle()
    assert g.result().tolist() == TG.generate(tt, PROMPT,
                                              max_new_tokens=9).tolist()
    s = eng.stats()
    assert s["spec_accept_count"] == 1
    assert s["spec_accept_hist"][-2] + s["spec_accept_hist"][-1] == 1
    assert 0 < s["spec_accepted_total"] <= s["spec_drafted_total"]


@pytest.mark.parametrize("pool", ["fixed", "paged"])
def test_spec_streams_resume_token_identically(pair, pool):
    """Crash recovery and SLO preemption cover spec slots: a sampled
    spec stream requeued mid-decode (``recover_from_crash``, then an
    eviction through ``_evict_requeue``) re-prefills both caches and
    finishes with the uninterrupted run's tokens."""
    (_, _, tt), (_, _, td) = pair
    want = TG.generate_speculative(tt, td, PROMPT, max_new_tokens=16, k=3,
                                   seed=7, **SPEC).tolist()
    _, eng = _engines(pair, pool)
    g = eng.submit(PROMPT, 16, None, None,
                   sampling=SamplingSpec(seed=7, spec_k=3, **SPEC))
    for _ in range(3):
        eng.tick()
    assert eng._resident and eng.recover_from_crash() == 1
    for _ in range(3):
        eng.tick()
    (slot, stream), = eng._resident.items()
    assert 1 < len(stream.out) < 16
    eng._evict_requeue(slot, stream, "preempted", 0.0)
    eng.run_until_idle()
    assert g.result().tolist() == want
    assert eng.resumed_total == 2


def test_spec_refusals(pair):
    (_, _, tt), (_, _, td) = pair
    eng = DecodeEngine(tt, autostart=False,
                       policy=SchedulerPolicy(n_slots=2))
    with pytest.raises(ValueError, match="draft"):
        eng.submit(PROMPT, 4, None, None, sampling=SamplingSpec(spec_k=3))
    _, eng = _engines(pair, "paged")
    with pytest.raises(ValueError, match="spec_k_cap"):
        eng.submit(PROMPT, 4, None, None, sampling=SamplingSpec(spec_k=5))
    with pytest.raises(ValueError, match="prefix"):
        eng.submit(PROMPT, 4, None, None, sampling=SamplingSpec(spec_k=2),
                   prefix=(2, None, None))
    # Every request of a spec-capable pool leaves spec_k_cap - 1 slack.
    with pytest.raises(ValueError, match="spec_k_cap-1"):
        eng.submit(PROMPT, 64 - 4 - 2, None, None)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(target pair, 1-layer draft pair) of a zoo family, float32."""
    name = request.param
    jt, vt = _jax_model(name)
    jd, vd = _jax_model(name, seed=7, num_layers=1)
    return name, (jt, vt, _port(name, jt, vt)), (jd, vd, _port(name, jd, vd))


def test_family_spec_engine_equals_reference(family):
    """Greedy and sampled spec requests beside a plain co-tenant on
    gpt2-tiny, llama-tiny and mistral-tiny (24 new tokens, past its
    31-token window): the port's fixed-lane and paged engines equal
    the reference engine, tokens and counters."""
    name, (jt, vt, tt), (jd, vd, td) = family
    rs = np.random.RandomState(4)
    vocab = tt.cfg.vocab_size
    sched = [(0, rs.randint(0, vocab, (1, 12)), 24, None,
              dict(seed=0, spec_k=3)),
             (0, rs.randint(0, vocab, (1, 9)), 24, None,
              dict(seed=5, spec_k=4, temperature=0.8, top_p=0.9)),
             (1, rs.randint(0, vocab, (1, 7)), 20, None, None)]
    kw = dict(n_slots=4, decode_window=8, spec_k_cap=4)
    jeng = JEngine(jt, vt, autostart=False, policy=JPolicy(**kw),
                   draft_model=jd, draft_variables=vd)
    want = _run(jeng, JSpec, sched)
    for pool in ("fixed", "paged"):
        teng = DecodeEngine(tt, autostart=False, draft_model=td,
                            policy=SchedulerPolicy(**kw, **POOLS[pool]))
        assert _run(teng, SamplingSpec, sched) == want, pool
    assert want[0][0] == TG.generate(tt, sched[0][1],
                                     max_new_tokens=24).tolist()


class TestRollbackMasking:
    """The accept/rewind contract on the port's cache: after
    ``_rollback_cache`` the entries past the rewound index are dead
    (masked by absolute position, overwritten by the next append
    before any query can admit them)."""

    def test_rollback_then_redecode_equals_pristine(self, pair):
        (_, _, tt), _ = pair
        prompt = np.asarray([[3, 1, 4, 1, 5, 9]])
        logits, cache = TG.prefill(tt, prompt)
        pristine = TG.prefill(tt, prompt)[1]
        with torch.no_grad():
            tt(torch.tensor([[31, 30, 29]]), decode=True,
               decode_position=6, cache=cache)
        TG._rollback_cache(cache, 6)
        a = TG.generate_continue(tt, cache, logits, 6, max_new_tokens=6)
        b = TG.generate_continue(tt, pristine, logits, 6,
                                 max_new_tokens=6)
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    def test_rollback_then_chunk_extend_equals_pristine(self, pair):
        (_, _, tt), _ = pair
        prompt = np.asarray([[3, 1, 4, 1, 5, 9]])
        _, cache = TG.prefill(tt, prompt)
        _, pristine = TG.prefill(tt, prompt)
        with torch.no_grad():
            tt(torch.tensor([[31, 30, 29, 28]]), decode=True,
               decode_position=6, cache=cache)
        TG._rollback_cache(cache, 6)
        la, _ = TG.prefill(tt, [[2, 6]], cache=cache, position=6)
        lb, _ = TG.prefill(tt, [[2, 6]], cache=pristine, position=6)
        np.testing.assert_array_equal(la.numpy(), lb.numpy())

    def test_slot_rollback_masks_stale_entries(self, pair):
        """The slot cache's multi-token append and positions rewind:
        a 4-token garbage chunk per row at per-row positions, rewound,
        then one-token decodes equal a pristine slot cache's."""
        from polyaxon_tpu_torch.models.kv_cache import KVCache

        (_, _, tt), _ = pair
        prompts = [[3, 1, 4, 1, 5, 9], [2, 7, 1, 8, 2, 8]]
        lanes = [TG.prefill(tt, [p])[1] for p in prompts]

        def slot_cache():
            return KVCache(torch.cat([c.k for c in lanes], dim=1).clone(),
                           torch.cat([c.v for c in lanes], dim=1).clone(),
                           positions=torch.tensor([6, 6]))

        dirty, clean = slot_cache(), slot_cache()
        with torch.no_grad():
            tt(torch.tensor([[31, 30, 29, 28], [1, 2, 3, 4]]),
               decode=True, decode_position=dirty.positions, cache=dirty)
            TG._rollback_cache(dirty, torch.tensor([6, 6]))
            for tok in ([5, 6], [7, 8]):
                a = tt(torch.tensor(tok)[:, None], decode=True,
                       decode_position=dirty.positions, cache=dirty)
                b = tt(torch.tensor(tok)[:, None], decode=True,
                       decode_position=clean.positions, cache=clean)
                np.testing.assert_array_equal(a.numpy(), b.numpy())
                dirty.positions += 1
                clean.positions += 1

    # The same contract on the int8 cache (codes and scales rewound
    # together) and on the ring, whose position table and ring-older
    # test mask the rejected entries (slack k - 1 keeps the in-window
    # ones a 3-wide garbage chunk would overwrite).

    @staticmethod
    def _int8(tt):
        import dataclasses

        from polyaxon_tpu_torch.models.gpt2 import GPT2Model

        m = GPT2Model(dataclasses.replace(tt.cfg, kv_cache_int8=True),
                      device="cpu")
        m.load_state_dict(tt.state_dict())
        return m.eval()

    @staticmethod
    def _ring():
        from test_torch_int8_kv import make_pair

        return make_pair("mistral-tiny", kv_cache_ring=True,
                         kv_cache_ring_slack=2)[2]

    def _redecode(self, tt, prompt, garbage):
        n = prompt.shape[1]
        logits, cache = TG.prefill(tt, prompt)
        pristine = TG.prefill(tt, prompt)[1]
        with torch.no_grad():
            tt(torch.tensor([garbage]), decode=True, decode_position=n,
               cache=cache)
        TG._rollback_cache(cache, n)
        a = TG.generate_continue(tt, cache, logits, n, max_new_tokens=6)
        b = TG.generate_continue(tt, pristine, logits, n,
                                 max_new_tokens=6)
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    def _extend(self, tt, prompt, garbage, suffix):
        n = prompt.shape[1]
        _, cache = TG.prefill(tt, prompt)
        _, pristine = TG.prefill(tt, prompt)
        with torch.no_grad():
            tt(torch.tensor([garbage]), decode=True, decode_position=n,
               cache=cache)
        TG._rollback_cache(cache, n)
        la, _ = TG.prefill(tt, [suffix], cache=cache, position=n)
        lb, _ = TG.prefill(tt, [suffix], cache=pristine, position=n)
        np.testing.assert_array_equal(la.numpy(), lb.numpy())

    def _slots(self, tt, prompts, garbage, feeds):
        """Per-row garbage chunks, rewound, then one-token decodes: equal
        to a pristine slot cache's (the ring's table per row)."""
        from polyaxon_tpu_torch.models.kv_cache import KVCache

        lanes = [TG.prefill(tt, [p])[1] for p in prompts]
        n = len(prompts[0])

        def slot_cache():
            leaves = [torch.cat(ts, dim=1).clone() for ts in
                      zip(*(c.leaves() for c in lanes))]
            ring = lanes[0].ring_pos
            return KVCache.from_leaves(
                leaves, positions=torch.full((len(prompts),), n),
                ring_pos=None if ring is None else torch.stack(
                    [c.ring_pos for c in lanes]).clone())

        dirty, clean = slot_cache(), slot_cache()
        with torch.no_grad():
            tt(torch.tensor(garbage), decode=True,
               decode_position=dirty.positions, cache=dirty)
            TG._rollback_cache(dirty, torch.full((len(prompts),), n))
            for tok in feeds:
                a = tt(torch.tensor(tok)[:, None], decode=True,
                       decode_position=dirty.positions, cache=dirty)
                b = tt(torch.tensor(tok)[:, None], decode=True,
                       decode_position=clean.positions, cache=clean)
                np.testing.assert_array_equal(a.numpy(), b.numpy())
                dirty.positions += 1
                clean.positions += 1

    def test_int8_rollback_then_redecode_equals_pristine(self, pair):
        tt = self._int8(pair[0][2])
        self._redecode(tt, np.asarray([[3, 1, 4, 1, 5, 9]]), [31, 30, 29])

    def test_int8_rollback_then_chunk_extend_equals_pristine(self, pair):
        tt = self._int8(pair[0][2])
        self._extend(tt, np.asarray([[3, 1, 4, 1, 5, 9]]),
                     [31, 30, 29, 28], [2, 6])

    def test_int8_slot_rollback_masks_stale_entries(self, pair):
        tt = self._int8(pair[0][2])
        self._slots(tt, [[3, 1, 4, 1, 5, 9], [2, 7, 1, 8, 2, 8]],
                    [[31, 30, 29, 28], [1, 2, 3, 4]], ([5, 6], [7, 8]))

    def test_ring_rollback_then_redecode_equals_pristine(self):
        prompt = np.random.RandomState(1).randint(0, 512, (1, 40))
        self._redecode(self._ring(), prompt, [31, 30, 29])

    def test_ring_rollback_then_chunk_extend_equals_pristine(self):
        prompt = np.random.RandomState(2).randint(0, 512, (1, 40))
        self._extend(self._ring(), prompt, [31, 30, 29], [2, 6])

    def test_ring_slot_rollback_masks_stale_entries(self):
        rng = np.random.RandomState(3)
        prompts = rng.randint(0, 512, (2, 40)).tolist()
        self._slots(self._ring(), prompts, [[31, 30, 29], [1, 2, 3]],
                    ([5, 6], [7, 8], [9, 10]))
