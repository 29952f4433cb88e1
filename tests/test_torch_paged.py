"""The port's paged KV pool (``serving/paged.py``, the paged helpers of
``models/kv_cache.py`` and the engine's ``kv_paged`` branch) against
the reference, on the float32 vocab-32 model of the reference's
``tests/test_paged_engine.py`` and ``tests/test_kv_tiered.py``, with
converted weights.

- DETERMINISM: paged (eager or lazy reservation) == the reference's
  solo ``generate`` / ``generate_positional`` == the port's fixed-lane
  engine, token for token, under the reference's schedules.
- PAGE HYGIENE: freed pages never leak stale KV; every terminal path
  returns its pages.
- OVERLOAD: a request that can never fit the pool sheds (``kv_pages``);
  one that fits but not now waits and admits when pages free.
- CAPTURES: zero steady-state captures per (window, sampled, pad
  class) after warm-up.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import generate as JG
from polyaxon_tpu.models import kv_cache as JKV
from polyaxon_tpu.models.gpt2 import GPT2Config as JConfig
from polyaxon_tpu.models.gpt2 import GPT2Model as JModel
from polyaxon_tpu_torch.convert import gpt2_state_dict_from_jax
from polyaxon_tpu_torch.models import kv_cache as TKV
from polyaxon_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from polyaxon_tpu_torch.serving import (DecodeEngine, ModelServer,
                                        SchedulerPolicy)
from polyaxon_tpu_torch.serving.paged import PagedSlotKVManager
from polyaxon_tpu_torch.serving.scheduler import SamplingSpec, ShedError

torch.set_num_threads(2)

PROMPT = np.asarray([[3, 1, 4, 1]], np.int64)
P2 = np.asarray([[9, 8, 7, 6]], np.int64)


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


@pytest.fixture(scope="module")
def model(small_pair):
    return small_pair[2]


def _greedy(small_pair, prompt, new):
    jmodel, variables, _ = small_pair
    return np.asarray(JG.generate(jmodel, variables,
                                  np.asarray(prompt, np.int32),
                                  max_new_tokens=new)).tolist()


def _positional(small_pair, prompt, new, seed, **kw):
    jmodel, variables, _ = small_pair
    return np.asarray(JG.generate_positional(
        jmodel, variables, np.asarray(prompt, np.int32),
        max_new_tokens=new, seed=seed, **kw)).tolist()


def _engine(model, *, paged=True, lazy=False, **policy):
    kw = dict(n_slots=4, decode_window=8)
    if paged:
        kw.update(kv_paged=True, kv_page_tokens=8, kv_lazy=lazy)
    kw.update(policy)
    return DecodeEngine(model, autostart=False,
                        policy=SchedulerPolicy(**kw))


def _all_free(eng):
    return eng.slots.free_page_count() == eng.slots.n_pages


# -- the paged helpers ---------------------------------------------------


def test_paged_helpers_match_reference():
    rng = np.random.RandomState(0)
    leaf = (2, 24, 3, 4)                      # [L, positions, H, D]
    assert TKV.paged_pool_shape(leaf, 1, 7, 8) == \
        JKV.paged_pool_shape(leaf, 1, 7, 8)
    pool = rng.randn(2, 7, 8, 3, 4).astype(np.float32)
    table = np.asarray([5, 0, 3], np.int32)
    want = np.asarray(JKV.gather_pages(jnp.asarray(pool),
                                       jnp.asarray(table), 1))
    got = TKV.gather_pages(torch.from_numpy(pool),
                           torch.from_numpy(table.astype(np.int64)), 1)
    assert np.array_equal(got.numpy(), want)
    # A [S, P] table gathers S rows (the slot cache the step decodes).
    tables = torch.tensor([[5, 0, 3], [1, 1, 6]])
    out = torch.empty((2, 6, 8, 3, 4))
    rows = TKV.gather_pages(torch.from_numpy(pool), tables, 1, out=out)
    assert rows.shape == (2, 2, 24, 3, 4)
    assert np.array_equal(rows[:, 0].numpy(), want)
    assert rows.data_ptr() == out.data_ptr()
    pages = rng.randn(2, 2, 8, 3, 4).astype(np.float32)
    targets = np.asarray([6, 2], np.int32)
    want = np.asarray(JKV.scatter_pages(jnp.asarray(pool),
                                        jnp.asarray(pages),
                                        jnp.asarray(targets), 1))
    tpool = torch.from_numpy(pool.copy())
    TKV.scatter_pages(tpool, torch.from_numpy(pages),
                      torch.from_numpy(targets.astype(np.int64)), 1)
    assert np.array_equal(tpool.numpy(), want)


# -- determinism: paged == solo == fixed-lane -----------------------------


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
def test_greedy_paged_matches_generate(small_pair, model, lazy):
    eng = _engine(model, lazy=lazy)
    g = eng.submit(PROMPT, 12, None, None)
    eng.run_until_idle()
    assert g.result().tolist() == _greedy(small_pair, PROMPT, 12)
    assert _all_free(eng)


@pytest.mark.parametrize("lazy", [False, True], ids=["eager", "lazy"])
def test_sampled_paged_matches_solo_under_three_schedules(small_pair,
                                                          model, lazy):
    spec = dict(seed=7, temperature=1.0, top_k=8)
    want = _positional(small_pair, PROMPT, 12, **spec)

    eng = _engine(model, lazy=lazy)                       # alone
    g = eng.submit(PROMPT, 12, None, None, sampling=SamplingSpec(**spec))
    eng.run_until_idle()
    assert g.result().tolist() == want

    eng = _engine(model, lazy=lazy)                       # co-tenants
    a = eng.submit(np.asarray([[2, 7, 1, 8]]), 16, None, None)
    b = eng.submit(np.asarray([[5, 6, 7, 8]]), 16, None, None,
                   sampling=SamplingSpec(seed=3, temperature=1.0))
    for _ in range(3):
        eng.tick()
    g = eng.submit(PROMPT, 12, None, None, sampling=SamplingSpec(**spec))
    eng.run_until_idle()
    assert g.result().tolist() == want
    assert a.result().tolist() == _greedy(small_pair, [[2, 7, 1, 8]], 16)
    assert b.result().tolist() == _positional(
        small_pair, [[5, 6, 7, 8]], 16, 3, temperature=1.0)

    eng = _engine(model, lazy=lazy, n_slots=2)            # starved
    for i in range(2):
        eng.submit(np.asarray([[i, i + 1, 2, 3]]), 4 + i, None, None)
    g = eng.submit(PROMPT, 12, None, None, sampling=SamplingSpec(**spec))
    eng.run_until_idle()
    assert g.result().tolist() == want
    assert _all_free(eng)


def _mixed_round(eng):
    groups = [
        eng.submit(PROMPT, 12, None, None),
        eng.submit(np.asarray([[5, 6, 7, 8]]), 10, None, None,
                   sampling=SamplingSpec(seed=3, temperature=1.0)),
        eng.submit(P2, 6, None, None),
    ]
    eng.run_until_idle()
    return [g.result().tolist() for g in groups]


def test_paged_equals_fixed_lane_engine(model):
    """Eager paged, lazy paged and fixed-lane: the same tokens for one
    mixed co-tenancy run (layout changes memory, never tokens)."""
    fixed = _mixed_round(_engine(model, paged=False))
    assert _mixed_round(_engine(model)) == fixed
    assert _mixed_round(_engine(model, lazy=True)) == fixed


def test_windowed_and_single_step_agree_on_paged(model):
    outs = []
    for window in (1, 8):
        eng = _engine(model, decode_window=window)
        g = eng.submit(PROMPT, 13, None, None,
                       sampling=SamplingSpec(seed=5, temperature=1.0,
                                             top_p=0.9))
        eng.run_until_idle()
        outs.append(g.result().tolist())
    assert outs[0] == outs[1]


# -- page hygiene ----------------------------------------------------------


def test_freed_page_reuse_never_leaks(model):
    """A request decoding in RECYCLED pages produces exactly the tokens
    a fresh-pool run does."""
    eng = _engine(model, kv_pages=6)
    g = eng.submit(P2, 12, None, None,
                   sampling=SamplingSpec(seed=11, temperature=1.0))
    eng.run_until_idle()
    want = g.result().tolist()
    eng = _engine(model, kv_pages=6)
    eng.submit(PROMPT, 30, None, None)            # 34 tokens -> 5 pages
    eng.run_until_idle()
    assert eng.slots.free_page_count() == 6
    g = eng.submit(P2, 12, None, None,
                   sampling=SamplingSpec(seed=11, temperature=1.0))
    eng.run_until_idle()
    assert g.result().tolist() == want


def test_cancel_and_failure_release_pages(model):
    eng = _engine(model)
    g = eng.submit(PROMPT, 30, None, None)
    for _ in range(3):
        eng.tick()
    assert eng.slots.free_page_count() < eng.slots.n_pages
    eng.cancel(g)
    eng.tick()
    assert g.error is not None
    assert _all_free(eng)
    # A device failure inside a step fails the group and frees pages.
    g = eng.submit(PROMPT, 30, None, None)
    eng.tick()
    real = eng.slots.step

    def broken(*a, **k):
        raise RuntimeError("injected step failure")

    eng.slots.step = broken
    with pytest.raises(RuntimeError, match="injected"):
        eng.tick()
    eng.slots.step = real
    eng._fail_all(RuntimeError("engine failed"))
    assert g.error is not None and _all_free(eng)


# -- overload --------------------------------------------------------------


def test_impossible_request_sheds_kv_pages(model):
    eng = _engine(model, n_slots=2, kv_pages=2)
    with pytest.raises(ShedError) as e:
        eng.submit(PROMPT, 30, None, None)       # 34 tokens > 16
    assert e.value.reason == "kv_pages"
    assert eng.shed_kv_pages_total == 1
    assert eng.stats()["shed_kv_pages_total"] == 1


def test_insert_page_race_requeues_instead_of_failing(small_pair, model):
    """Pages taken between the admission gate and the insert: the
    stream requeues and completes when pages free, never a failure."""
    eng = _engine(model)
    real_reserve = eng.slots.try_reserve
    stolen = {}

    def stealing_reserve(n, _real=real_reserve):
        if "done" not in stolen:
            stolen["done"] = True
            stolen["pages"] = _real(n)
            return None
        return _real(n)

    eng.slots.try_reserve = stealing_reserve
    g = eng.submit(PROMPT, 12, None, None)
    eng.tick()
    assert g.error is None
    eng.slots.try_reserve = real_reserve
    eng.slots.unpin(stolen["pages"])
    eng.run_until_idle()
    assert g.result().tolist() == _greedy(small_pair, PROMPT, 12)
    assert _all_free(eng)


def test_admission_resumes_when_pages_free(small_pair, model):
    eng = _engine(model, kv_pages=4, decode_window=1)
    eng.submit(PROMPT, 12, None, None)                   # 2 pages
    eng.submit(P2, 12, None, None)                       # 2 pages
    g3 = eng.submit(np.asarray([[1, 2, 3, 4]]), 12, None, None)
    for _ in range(3):
        eng.tick()
    assert g3.t_first_admit is None
    assert eng.slots.free_page_count() == 0
    eng.run_until_idle()
    assert g3.result().tolist() == _greedy(small_pair, [[1, 2, 3, 4]], 12)


def _captures(eng):
    return eng.sentinel.snapshot()["compile_cache_misses"]


def test_zero_steady_state_recompiles_on_paged(model):
    eng = _engine(model)

    def round_():
        gs = [eng.submit(PROMPT, 12, None, None),
              eng.submit(np.asarray([[5, 6, 7, 8]]), 9, None, None,
                         sampling=SamplingSpec(seed=3, temperature=0.8,
                                               top_k=8)),
              eng.submit(P2, 5, None, None)]
        eng.run_until_idle()
        return gs

    round_()
    round_()
    warm = _captures(eng)
    assert warm > 0
    for _ in range(3):
        round_()
    assert _captures(eng) == warm, eng.sentinel.snapshot()


# -- lazy reservation (the reference's tests/test_kv_tiered.py) ------------


def test_greedy_lazy_matches_generate_and_grows(small_pair, model):
    eng = _engine(model, lazy=True, decode_window=4)
    g = eng.submit(PROMPT, 40, None, None)
    eng.run_until_idle()
    assert g.result().tolist() == _greedy(small_pair, PROMPT, 40)
    assert eng.slots.lazy_growths_total > 0
    assert eng.slots.lazy_pages_grown_total > 0
    assert eng.stats()["kv_pages_lazy_growths_total"] \
        == eng.slots.lazy_growths_total
    assert _all_free(eng)


def test_lazy_packs_more_residents_than_full_reservation(model):
    peaks = {}
    for lazy in (False, True):
        eng = _engine(model, kv_pages=10, lazy=lazy, decode_window=1)
        for i in range(4):
            eng.submit(np.asarray([[i + 1, i + 2, i + 3, i + 4]]), 40,
                       None, None)
        peak = 0
        for _ in range(6):
            eng.tick()
            peak = max(peak, eng.slots.active_slots)
        eng.run_until_idle()
        peaks[lazy] = peak
    assert peaks[True] > peaks[False]


def test_lazy_equals_full_reservation_byte_identity(model):
    assert _mixed_round(_engine(model, lazy=True)) == \
        _mixed_round(_engine(model))


def test_page_poison_on_grown_and_recycled_pages(small_pair, model):
    """Pages recycled through an exhaustion preempt and re-grown by the
    resumed stream carry only masked content."""
    want = _positional(small_pair, P2, 30, 11, temperature=1.0)
    eng = _engine(model, lazy=True, kv_pages=8, decode_window=1)
    a = eng.submit(PROMPT, 30, None, None)
    g = eng.submit(P2, 30, None, None,
                   sampling=SamplingSpec(seed=11, temperature=1.0))
    eng.run_until_idle()
    assert eng.kv_preempt_exhaustion_total >= 1
    assert eng.resumed_total >= 1
    assert g.result().tolist() == want
    assert a.result().tolist() == _greedy(small_pair, PROMPT, 30)
    assert _all_free(eng)


def test_exhaustion_evictee_is_barred_until_growth_lands(model):
    eng = _engine(model, lazy=True, kv_pages=8, decode_window=1,
                  n_slots=2)
    a = eng.submit(PROMPT, 30, None, None)
    b = eng.submit(P2, 44, None, None)
    barred = []
    for _ in range(500):
        eng.tick()
        barred = [s for s in eng.queue.snapshot()
                  if s.evicted_for is not None]
        if barred or (a.event.is_set() and b.event.is_set()):
            break
    assert barred, "no exhaustion evictee ever carried a bar"
    assert all(eng._stream_barred(s) for s in barred)
    eng.run_until_idle()
    assert a.error is None and b.error is None
    assert not any(s.evicted_for for g in (a, b) for s in g.streams)


def test_lazy_zero_steady_state_recompiles(model):
    eng = _engine(model, lazy=True, kv_pages=10, decode_window=2)

    def round_():
        gs = [eng.submit(np.asarray([[i + 1, i + 2, i + 3, i + 4]]), 28,
                         None, None) for i in range(3)]
        eng.run_until_idle()
        return gs

    round_()
    round_()
    warm = _captures(eng)
    round_()
    assert _captures(eng) == warm


def test_kv_lazy_requires_paged(model):
    with pytest.raises(ValueError, match="kv_lazy requires"):
        ModelServer(model, kv_lazy=True)
    with pytest.raises(ValueError, match="kv_lazy requires"):
        SchedulerPolicy(kv_lazy=True)


# -- the pool itself ---------------------------------------------------------


def test_pool_geometry_and_refusals(model):
    with pytest.raises(ValueError, match="kv_page_tokens must be >= 8"):
        PagedSlotKVManager(model, 2, page_tokens=4, max_position=64)
    mgr = PagedSlotKVManager(model, 2, page_tokens=8, max_position=64,
                             decode_window=8)
    assert mgr.n_pages == 16 and mgr.capacity_tokens == 128
    assert mgr.pages_needed(1) == 1 and mgr.pages_needed(17) == 3
    with pytest.raises(RuntimeError, match="before any insert"):
        mgr.step(1)
    for call in (lambda: mgr.materialize([0], 8),
                 lambda: mgr.spill_pages([0], 8),
                 lambda: mgr.step_spec(1, 2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()


def test_pin_unpin_reset_keep_the_accounting(model):
    """Pins hold a page past its slot's release; reset returns every
    page and starts a new epoch, whose accounting a stale unpin from
    the old epoch leaves alone."""
    eng = _engine(model)
    g = eng.submit(PROMPT, 12, None, None)
    eng.tick()
    mgr = eng.slots
    (slot, held), = mgr.slot_page_counts().items()
    ids = list(mgr._slot_pages[slot][0])
    epoch = mgr.pin(ids)
    eng.run_until_idle()
    assert g.error is None
    assert mgr.free_page_count() == mgr.n_pages - len(ids)
    mgr.unpin(ids, epoch=epoch)
    assert _all_free(eng)
    with pytest.raises(ValueError, match="pin of a free page"):
        mgr.pin(ids[:1])
    eng.submit(P2, 30, None, None)
    eng.tick()
    assert mgr.free_page_count() < mgr.n_pages
    mgr.pin(mgr._slot_pages[mgr.slot_page_counts().popitem()[0]][0])
    mgr.reset()
    assert _all_free(eng) and mgr.epoch == epoch + 1
    assert mgr.active_slots == 0 and mgr.slot_page_counts() == {}
    mgr.unpin(ids, epoch=epoch)             # a stale epoch: dropped
    assert _all_free(eng)
