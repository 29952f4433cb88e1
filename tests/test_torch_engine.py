"""The port's continuous-batching engine (``serving/engine.py``).

The schedules of the reference's ``tests/test_serving.py``
``TestContinuousBatching``, run on the port's ``DecodeEngine`` and
``ModelServer`` (``autostart=False`` where the reference drives
``tick()`` by hand), and one five-request schedule run on both engines:
the same tokens and the same admission, eviction and step counts.

gpt2-tiny in float32 with the reference's flax weights; greedy tokens
are held EQUAL to solo ``generate`` (float32 argmax).
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu.serving import DecodeEngine as JEngine
from polyaxon_tpu.serving import SchedulerPolicy as JPolicy
from polyaxon_tpu_torch.convert import gpt2_state_dict_from_jax
from polyaxon_tpu_torch.models import generate as TG
from polyaxon_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from polyaxon_tpu_torch.serving import (DecodeEngine, ModelServer,
                                        SchedulerPolicy, make_server)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny_pair():
    jmodel, variables = j_get_model("gpt2-tiny").init_params(
        batch_size=1, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, variables["params"])
    cfg = GPT2Config(**{**GPT2Config.tiny().__dict__,
                        "dtype": torch.float32})
    tmodel = GPT2Model(cfg, device="cpu")
    tmodel.load_state_dict(gpt2_state_dict_from_jax(params, cfg),
                           strict=True)
    return jmodel, variables, tmodel.eval()


@pytest.fixture(scope="module")
def model(tiny_pair):
    return tiny_pair[2]


def _solo(model, rows, new, eos=None):
    return TG.generate(model, np.asarray(rows), max_new_tokens=new,
                       eos_id=eos).tolist()


def _engine(model, n_slots=2, queue_depth=16, prefill_chunk=None,
            decode_window=1):
    """A manually-driven engine: decode_window=1 pins one decode step
    per tick, so step-count arithmetic is exact."""
    return DecodeEngine(model, autostart=False, policy=SchedulerPolicy(
        n_slots=n_slots, queue_depth=queue_depth,
        prefill_chunk=prefill_chunk, decode_window=decode_window))


def _rows(*toks):
    return np.asarray([list(toks)], np.int64)


def test_concurrent_mixed_shapes_match_solo(model):
    """Concurrent greedy requests with different prompt lengths and
    budgets share the pool; every response equals its solo output."""
    ms = ModelServer(model, max_batch=8, n_slots=4)
    reqs = [
        {"prompt": [3, 1, 4, 1], "max_new_tokens": 5},
        {"prompt": [2, 7, 1, 8, 2, 8], "max_new_tokens": 8},
        {"prompt": [9, 9], "max_new_tokens": 3},
        {"prompt": [[1, 2, 3], [4, 5, 6]], "max_new_tokens": 4},
        {"prompt": [5, 6, 7, 8, 9, 1, 2, 3], "max_new_tokens": 4,
         "prefill_chunk": 3},
    ]
    refs = []
    for r in reqs:
        rows = r["prompt"] if isinstance(r["prompt"][0], list) \
            else [r["prompt"]]
        refs.append(_solo(model, rows, r["max_new_tokens"]))
    results = [None] * len(reqs)

    def go(i):
        results[i] = ms.generate(dict(reqs[i]))

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(reqs))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for got, ref in zip(results, refs):
            assert got["tokens"] == ref
        stats = ms.engine.stats()
        # 6 streams through 4 slots, admitted at step boundaries
        assert stats["admitted_total"] == 6
        assert stats["evicted_total"] == 6
        assert stats["decode_steps_total"] >= 7  # longest budget
    finally:
        ms.close()


@pytest.mark.parametrize("n_slots", [2, 3])
def test_step_boundary_admission_preserves_output(model, n_slots):
    """A request submitted mid-decode joins at a step boundary and
    reproduces its solo output; the resident request is unaffected."""
    eng = _engine(model, n_slots=n_slots)
    a = eng.submit(_rows(3, 1, 4, 1), 8, None, None)
    for _ in range(3):          # prefill+admit A, decode 2 steps
        eng.tick()
    assert eng.slots.active_slots == 1
    mid = eng.decode_steps_total
    b = eng.submit(_rows(2, 7, 1, 8), 4, None, None)
    eng.run_until_idle()
    assert a.event.is_set() and b.event.is_set()
    assert eng.decode_steps_total > mid
    assert a.result().tolist() == _solo(model, [[3, 1, 4, 1]], 8)
    assert b.result().tolist() == _solo(model, [[2, 7, 1, 8]], 4)


def _eos_prompt(model):
    """A prompt and eos whose solo greedy run emits eos FIRST as its
    third new token: picked from the port's own solo tokens."""
    for seed in range(20):
        prompt = np.random.RandomState(seed).randint(0, 1024, 4).tolist()
        solo = _solo(model, [prompt], 6)[0]
        eos = solo[6]           # third generated token
        if eos not in solo[4:6]:
            return prompt, eos
    raise AssertionError("no prompt whose third token is new")


def test_eos_eviction_frees_capacity_same_step(model):
    """A slot hitting EOS is released within that decode step, and the
    freed capacity admits a queued request at the very next boundary."""
    eng = _engine(model, n_slots=1)
    prompt, eos = _eos_prompt(model)
    a = eng.submit(_rows(*prompt), 6, eos, None)
    b = eng.submit(_rows(9, 9, 2, 6), 3, None, None)
    eng.tick()                  # prefill+admit A, decode step 1
    assert eng.slots.free_slots == 0
    assert len(eng.queue) == 1  # B waits: no capacity
    eng.tick()                  # decode step 2: A emits eos
    assert eng.slots.free_slots == 1
    assert a.event.is_set()
    assert eng.evicted_total == 1
    eng.tick()                  # next boundary admits B
    assert eng.slots.free_slots == 0
    eng.run_until_idle()
    assert a.result().tolist() == _solo(model, [prompt], 6, eos=eos)
    assert b.result().tolist() == _solo(model, [[9, 9, 2, 6]], 3)


@pytest.mark.parametrize("chunk", [2, 3])
def test_chunked_prefill_never_starves_decodes(model, chunk):
    """While a long prompt prefills chunk by chunk, the resident batch
    advances one token at EVERY boundary."""
    eng = _engine(model, n_slots=2)
    a = eng.submit(_rows(3, 1, 4, 1), 10, None, None)
    eng.tick()                  # admit A
    stream_a = eng._resident[next(iter(eng._resident))]
    long_prompt = np.asarray([list(range(1, 11))], np.int64)
    b = eng.submit(long_prompt, 2, None, chunk)
    progress = []
    while b.t_first_prefill is None or len(eng.queue) > 0:
        before = len(stream_a.out)
        eng.tick()
        progress.append(len(stream_a.out) - before)
        assert len(progress) < 50
    assert progress and all(d == 1 for d in progress)
    eng.run_until_idle()
    assert b.result().tolist() == _solo(model, long_prompt, 2)
    assert a.result().tolist() == _solo(model, [[3, 1, 4, 1]], 10)


def test_prefill_works_ahead_while_slots_full(model):
    """With every slot busy a queued prompt still prefills (one chunk
    per boundary), so a freed slot admits an already-ready request."""
    eng = _engine(model, n_slots=1)
    a = eng.submit(_rows(3, 1, 4, 1), 8, None, None)
    eng.tick()                  # admit A: the pool is now full
    assert eng.slots.free_slots == 0
    long_prompt = np.asarray([list(range(1, 9))], np.int64)
    b = eng.submit(long_prompt, 2, None, 2)     # 4 chunks of 2
    for _ in range(4):
        eng.tick()
    assert eng.slots.free_slots == 0
    assert b.streams[0].pf_done
    assert len(eng.queue) == 1  # still queued, waiting on a slot
    eng.run_until_idle()
    assert b.result().tolist() == _solo(model, long_prompt, 2)
    assert a.result().tolist() == _solo(model, [[3, 1, 4, 1]], 8)


def _post(base, payload):
    req = urllib.request.Request(
        base + "/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_queue_full_is_429_with_retry_after(model):
    """Once the bounded admission queue is full, /generate sheds load
    with 429 + Retry-After; queued requests still complete."""
    ms = ModelServer(model, max_batch=8, n_slots=1, queue_depth=2)
    srv = make_server("127.0.0.1", 0, ms)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    results = {}

    def go(name):
        results[name] = _post(base, {"prompt": [1, 2, 3],
                                     "max_new_tokens": 4})

    try:
        threads = []
        with ms._lock:          # stall the engine: submits only queue
            for name in ("a", "b"):
                th = threading.Thread(target=go, args=(name,))
                th.start()
                threads.append(th)
            for _ in range(100):
                if len(ms.engine.queue) >= 2:
                    break
                threading.Event().wait(0.05)
            assert len(ms.engine.queue) == 2
            req = urllib.request.Request(
                base + "/generate",
                data=json.dumps({"prompt": [1, 2, 3],
                                 "max_new_tokens": 4}).encode(),
                headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=30)
            assert ei.value.code == 429
            assert int(ei.value.headers["Retry-After"]) >= 1
            assert "retry_after" in json.loads(ei.value.read())
        for th in threads:
            th.join(timeout=60)
        want = _solo(model, [[1, 2, 3]], 4)
        assert results["a"]["tokens"] == want
        assert results["b"]["tokens"] == want
        assert ms.engine.stats()["rejected_total"] == 1
        assert "ptpu_serving_rejected_total 1" in ms.metrics_text()
    finally:
        srv.shutdown()
        srv.server_close()
        ms.close()


@pytest.mark.parametrize("decode_window", [8, 16])
def test_windowed_decode_is_exact_and_fuses_dispatches(model,
                                                       decode_window):
    """With no admission pressure the engine fuses decode steps into
    windows; outputs stay equal to solo, including an eos that fires
    INSIDE a window."""
    eng = _engine(model, n_slots=4, decode_window=decode_window)
    prompt, eos = _eos_prompt(model)
    a = eng.submit(_rows(*prompt), 12, eos, None)
    b = eng.submit(_rows(2, 7, 1, 8), 12, None, None)
    ticks = 0
    while not (a.event.is_set() and b.event.is_set()):
        eng.tick()
        ticks += 1
        assert ticks < 50
    # B's 11 post-admission tokens took ~3 dispatches (8+2+1), not 11
    assert ticks <= 6
    assert eng.decode_dispatches_total <= 6
    assert a.result().tolist() == _solo(model, [prompt], 12, eos=eos)
    assert b.result().tolist() == _solo(model, [[2, 7, 1, 8]], 12)


def test_window_drops_to_single_steps_under_pressure(model):
    """A queued request with a free slot forces single steps, and the
    window never fuses past the earliest budget eviction."""
    eng = _engine(model, n_slots=2, decode_window=8)
    a = eng.submit(_rows(3, 1, 4, 1), 20, None, None)
    eng.tick()          # admit A (token 1) + one full window of 8
    assert len(a.streams[0].out) == 9
    assert eng._pick_window() == 8
    b = eng.submit(_rows(2, 7), 4, None, None)
    assert eng._pick_window() == 1
    eng.tick()          # admits B; window = min(rem) = 3 -> 2
    assert len(eng.queue) == 0
    assert len(b.streams[0].out) == 3
    assert eng._pick_window() == 1
    eng.tick()          # B completes exactly at the window end
    assert b.event.is_set()
    assert eng._pick_window() == 8      # A alone again, rem 8
    eng.run_until_idle()
    assert a.event.is_set()


def test_window_stays_single_step_while_queued_prefill_pending(model):
    """A queued prompt mid-chunked-prefill pins the window to 1 even
    with a full pool and no eos-capable resident."""
    eng = _engine(model, n_slots=1, decode_window=8)
    a = eng.submit(_rows(3, 1, 4, 1), 20, None, None)
    eng.tick()
    assert eng._pick_window() == 8
    b = eng.submit(np.asarray([[1, 2, 3, 4, 5, 6, 7, 8]], np.int64), 4,
                   None, 2)
    assert eng._pick_window() == 1
    for _ in range(3):
        eng.tick()
        assert eng._pick_window() == 1
    assert not b.streams[0].pf_done
    before = len(a.streams[0].out)
    eng.tick()
    assert b.streams[0].pf_done
    assert len(a.streams[0].out) - before > 1
    eng.run_until_idle()
    assert a.event.is_set() and b.event.is_set()


def test_response_carries_phase_breakdown(model):
    ms = ModelServer(model, max_batch=8, n_slots=2)
    try:
        out = ms.generate({"prompt": [1, 2, 3], "max_new_tokens": 4,
                           "timings": True})
        for f in ("queue_ms", "prefill_ms", "decode_ms", "ttft_ms"):
            assert f in out and out[f] >= 0.0
        assert out["timings"]["phases"]
    finally:
        ms.close()


# The shared schedule: (prompt, max_new_tokens, eos, prefill_chunk),
# submitted in this order to a 2-slot pool with 8-step windows.
SCHEDULE = [
    ([3, 1, 4, 1, 5, 9], 10, None, None),
    (None, 6, None, None),             # the eos request, below
    ([1, 4, 1, 4, 2, 1, 3, 5, 6, 2, 3], 7, None, 4),
    ([9, 9, 2], 12, None, None),
    ([6, 2, 8, 3, 1], 5, None, 2),
]


def test_shared_schedule_matches_reference_engine(tiny_pair):
    """Five requests through the reference engine and the port's: the
    same tokens, admissions, evictions and decode steps."""
    jmodel, variables, tmodel = tiny_pair
    sched = list(SCHEDULE)
    # Request 1 stops at an eos: the third new token of the port's
    # solo run, picked so it does not occur earlier.
    prompt, eos = _eos_prompt(tmodel)
    sched[1] = (prompt, 6, eos, None)
    jeng = JEngine(jmodel, variables, autostart=False, policy=JPolicy(
        n_slots=2, queue_depth=16, decode_window=8))
    teng = DecodeEngine(tmodel, autostart=False, policy=SchedulerPolicy(
        n_slots=2, queue_depth=16, decode_window=8))
    results = []
    for eng, dt in ((jeng, np.int32), (teng, np.int64)):
        groups = [eng.submit(np.asarray([p], dt), n, e, c)
                  for p, n, e, c in sched]
        eng.run_until_idle()
        stats = eng.stats()
        results.append(([g.result().tolist() for g in groups],
                        {k: stats[k] for k in
                         ("admitted_total", "evicted_total",
                          "decode_steps_total", "prefill_chunks_total",
                          "completed_total")}))
        eng.close()
    (jtoks, jstats), (ttoks, tstats) = results
    assert ttoks == jtoks
    assert tstats == jstats
    assert tstats["admitted_total"] == len(sched)
    for (p, n, e, _), got in zip(sched, ttoks):
        assert got == _solo(tmodel, [p], n, eos=e)


def test_unported_features_are_refused(model):
    from polyaxon_tpu_torch.serving import SamplingSpec

    eng = _engine(model)
    with pytest.raises(NotImplementedError, match="sampled decoding"):
        eng.submit(_rows(1, 2), 2, None, None,
                   sampling=SamplingSpec(0, 0.7))
    with pytest.raises(NotImplementedError, match="speculative"):
        eng.submit(_rows(1, 2), 2, None, None,
                   sampling=SamplingSpec(0, 0.0, spec_k=2))
    with pytest.raises(NotImplementedError, match="paged pool"):
        DecodeEngine(model, autostart=False,
                     policy=SchedulerPolicy(kv_paged=True))
    with pytest.raises(NotImplementedError, match="meshes"):
        DecodeEngine(model, autostart=False, mesh="tp=2")
    with pytest.raises(NotImplementedError, match="speculative"):
        DecodeEngine(model, autostart=False, draft_model=model)
