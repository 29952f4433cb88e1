"""Sampled continuous batching in the port (``serving/slots.py``'s
sampled body and ``serving/engine.py``'s sampled admission) against
the reference's, on a float32 vocab-32 model (the reference's
``tests/test_sampled_engine.py`` shape) with converted weights.

Tokens are held EQUAL to the reference's solo ``generate_positional``
(the position-keyed contract: co-tenancy and window fusion never move
a sampled stream) and to the reference's own slot step; at vocab 32 in
float32 the top-2 gaps of shaped logits + noise are far above the tie
rule's 1e-4.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import generate as JG
from polyaxon_tpu.models.gpt2 import GPT2Config as JConfig
from polyaxon_tpu.models.gpt2 import GPT2Model as JModel
from polyaxon_tpu.serving import SchedulerPolicy as JPolicy
from polyaxon_tpu.serving.engine import DecodeEngine as JEngine
from polyaxon_tpu.serving.scheduler import SamplingSpec as JSpec
from polyaxon_tpu.serving.slots import SlotKVManager as JSlots
from polyaxon_tpu_torch.convert import gpt2_state_dict_from_jax
from polyaxon_tpu_torch.models import generate as TG
from polyaxon_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from polyaxon_tpu_torch.serving import DecodeEngine, SchedulerPolicy
from polyaxon_tpu_torch.serving.scheduler import SamplingSpec
from polyaxon_tpu_torch.serving.slots import SlotKVManager

torch.set_num_threads(2)

PROMPT = np.asarray([[3, 1, 4, 1]], np.int64)


@pytest.fixture(scope="module")
def small_pair():
    jcfg = dataclasses.replace(
        JConfig.tiny(), vocab_size=32, hidden_size=32, num_layers=2,
        num_heads=2, max_position=64, dtype=jnp.float32)
    jmodel = JModel(cfg=jcfg)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 4), jnp.int32))
    cfg = GPT2Config(vocab_size=32, hidden_size=32, num_layers=2,
                     num_heads=2, max_position=64, dtype=torch.float32)
    tmodel = GPT2Model(cfg, device="cpu")
    tmodel.load_state_dict(gpt2_state_dict_from_jax(
        jax.tree.map(np.asarray, variables["params"]), cfg), strict=True)
    return jmodel, variables, tmodel.eval()


def _ref_positional(small_pair, prompt, new, seed, **kw):
    jmodel, variables, _ = small_pair
    return np.asarray(JG.generate_positional(
        jmodel, variables, np.asarray(prompt, np.int32),
        max_new_tokens=new, seed=seed, **kw)).tolist()


def _ref_greedy(small_pair, prompt, new):
    jmodel, variables, _ = small_pair
    return np.asarray(JG.generate(jmodel, variables,
                                  np.asarray(prompt, np.int32),
                                  max_new_tokens=new)).tolist()


def _engine(model, **policy):
    kw = dict(n_slots=4, decode_window=8)
    kw.update(policy)
    return DecodeEngine(model, autostart=False,
                        policy=SchedulerPolicy(**kw))


@pytest.mark.parametrize("window", [1, 4])
def test_sampled_slot_step_matches_reference(small_pair, window):
    """``SlotKVManager.step(W, sampled=True)`` over a mixed pool (two
    sampled slots with their own parameters, one greedy, one idle)
    equals the reference's slot step token for token."""
    jmodel, variables, tmodel = small_pair
    rows = [(np.asarray([[3, 1, 4, 1]]), (0.9, 16, 0.0), 11),
            (np.asarray([[2, 7, 1, 8, 2]]), (1.2, 0, 0.8), 3),
            (np.asarray([[5, 6, 7]]), (0.0, 0, 0.0), 0)]
    jpool = JSlots(jmodel, variables, 4)
    tpool = SlotKVManager(tmodel, 4, max_window=4)
    for slot, (p, (t, k, tp), seed) in enumerate(rows):
        jl, jc = JG.prefill(jmodel, variables, np.asarray(p, np.int32))
        tl, tc = TG.prefill(tmodel, p)
        key = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), 0))
        first = int(JG._sample_positional_row(jl[0], key, 0, t, k, tp))
        assert first == int(TG._sample_positional_row(
            tl[0], torch.from_numpy(key.astype(np.int64)), 0, t, k, tp))
        for pool, cache in ((jpool, jc), (tpool, tc)):
            pool.acquire()
            pool.insert(slot, cache, first, p.shape[1], base_key=key,
                        next_index=1, temperature=t, top_k=k, top_p=tp)
    for _ in range(2):
        want = jpool.step(window, sampled=True)
        got = tpool.step(window, sampled=True)
        assert got[:, :3].tolist() == np.asarray(want)[:, :3].tolist()
    assert tpool.next_index[:3].tolist() == [1 + 2 * window] * 3


def test_sampled_engine_matches_solo_under_three_schedules(small_pair):
    """Token identity per seed: alone; admitted beside running
    co-tenants (greedy and sampled); slot-starved (queued, admitted
    into an evicted slot)."""
    _, _, tmodel = small_pair
    spec = dict(seed=7, temperature=1.0, top_k=8)
    want = _ref_positional(small_pair, PROMPT, 12, **spec)

    eng = _engine(tmodel)                                   # alone
    g = eng.submit(PROMPT, 12, None, None, sampling=SamplingSpec(**spec))
    eng.run_until_idle()
    assert g.result().tolist() == want

    eng = _engine(tmodel)                                   # co-tenants
    a = eng.submit(np.asarray([[2, 7, 1, 8]]), 16, None, None)
    b = eng.submit(np.asarray([[5, 6, 7, 8]]), 16, None, None,
                   sampling=SamplingSpec(seed=3, temperature=1.0))
    for _ in range(3):
        eng.tick()
    g = eng.submit(PROMPT, 12, None, None, sampling=SamplingSpec(**spec))
    eng.run_until_idle()
    assert g.result().tolist() == want
    assert a.result().tolist() == _ref_greedy(small_pair,
                                              [[2, 7, 1, 8]], 16)
    assert b.result().tolist() == _ref_positional(
        small_pair, [[5, 6, 7, 8]], 16, 3, temperature=1.0)

    eng = _engine(tmodel, n_slots=2)                        # starved
    others = [eng.submit(np.asarray([[i, i + 1, 2, 3]]), 4 + i, None,
                         None) for i in range(2)]
    g = eng.submit(PROMPT, 12, None, None, sampling=SamplingSpec(**spec))
    eng.run_until_idle()
    assert g.result().tolist() == want
    assert all(o.error is None for o in others)
    stats = eng.stats()
    assert stats["admitted_sampled_total"] == 1
    assert stats["admitted_greedy_total"] == 2
    assert stats["completed_sampled_total"] == 1


def test_windowed_sampled_decode_is_exact(small_pair):
    """Fused windows reproduce the solo positional reference, with an
    eos firing INSIDE a window and a greedy co-tenant riding the same
    windows."""
    _, _, tmodel = small_pair
    spec = dict(seed=11, temperature=0.9, top_k=16)
    p_a, p_b = PROMPT, np.asarray([[2, 7, 1, 8]])
    gen = _ref_positional(small_pair, p_a, 12, **spec)[0][4:]
    eos = next(tok for i, tok in enumerate(gen)
               if i >= 2 and tok not in gen[:i])
    want_a = _ref_positional(small_pair, p_a, 12, eos_id=eos, **spec)
    want_b = _ref_greedy(small_pair, p_b, 12)
    eng = _engine(tmodel)
    a = eng.submit(p_a, 12, eos, None, sampling=SamplingSpec(**spec))
    b = eng.submit(p_b, 12, None, None)
    ticks = 0
    while not (a.event.is_set() and b.event.is_set()):
        eng.tick()
        ticks += 1
        assert ticks < 50
    assert ticks <= 8                  # windows actually fused
    assert a.result().tolist() == want_a
    assert b.result().tolist() == want_b


def test_single_step_and_fused_schedules_agree(small_pair):
    _, _, tmodel = small_pair
    prompt = np.asarray([[5, 6, 7, 8]])
    spec = SamplingSpec(seed=3, temperature=1.0, top_p=0.9)
    outs = []
    for window in (1, 8):
        eng = _engine(tmodel, n_slots=2, decode_window=window)
        g = eng.submit(prompt, 10, None, None, sampling=spec)
        eng.run_until_idle()
        outs.append(g.result().tolist())
    assert outs[0] == outs[1]
    assert outs[0] == _ref_positional(small_pair, prompt, 10, 3,
                                      temperature=1.0, top_p=0.9)


def test_engine_counts_match_reference_on_a_mixed_schedule(small_pair):
    """One mixed greedy/sampled schedule on both engines: the same
    tokens and the same admission, step and completion counts."""
    jmodel, variables, tmodel = small_pair
    sched = [([3, 1, 4, 1], 9, None), ([2, 7, 1, 8, 2], 12, (5, 0.8, 8)),
             ([9, 9, 2], 6, None), ([1, 2], 10, (1, 1.1, 0)),
             ([4, 4, 4, 4, 4], 7, (2, 0.7, 4))]
    results = []
    for make, spec_cls in ((
            lambda: JEngine(jmodel, variables, autostart=False,
                            policy=JPolicy(n_slots=2, decode_window=4)),
            JSpec), (lambda: _engine(tmodel, n_slots=2, decode_window=4),
                     SamplingSpec)):
        eng = make()
        groups = [eng.submit(np.asarray([p]), n, None, None,
                             sampling=None if s is None else spec_cls(
                                 seed=s[0], temperature=s[1],
                                 top_k=s[2]))
                  for p, n, s in sched]
        eng.run_until_idle()
        stats = eng.stats()
        results.append(([g.result().tolist() for g in groups],
                        {k: stats[k] for k in (
                            "admitted_total", "admitted_sampled_total",
                            "decode_steps_total", "completed_total",
                            "completed_sampled_total")}))
    assert results[1] == results[0]
