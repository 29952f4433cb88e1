"""Fault containment and supervised recovery in the port
(``serving/engine.py``'s step containment, ``serving/recovery.py``,
the server's fault sites), against the reference on gpt2-tiny and
llama-tiny with converted weights, float32.

The property chaos testing pins is DETERMINISM UNDER CHAOS: with a
seeded fault plan armed, every SURVIVING request's tokens equal the
fault-free run, which by the position-keyed RNG contract equals the
reference's solo ``generate`` / ``generate_positional``.  The same plan
runs through the reference's ``DecodeEngine`` and the port's, and both
must count the same retries and convictions.

Alongside: quarantine (the poisoned request alone fails, typed, 500
``poisoned_request`` over HTTP), escalation of an engine-level fault,
the breaker (shed fast, /healthz 503 ``engine_down``, a healthy engine
closes it again), a sticky CUDA error latching the engine down with no
restart loop, stale prefix pins dying with the pool, the prefix-store
degradation ladder, handler socket resets, zero new graph captures
after recovery, SLO preemption with token-identical resume, the
``serve`` flags of this slice, and a closed server freed without the
cycle collector.
"""

from __future__ import annotations

import gc
import json
import threading
import time
import urllib.error
import urllib.request
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from polyaxon_tpu.models import generate as JG
from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu.serving import DecodeEngine as JEngine
from polyaxon_tpu.serving import EngineSupervisor as JSupervisor
from polyaxon_tpu.serving import FaultPlan as JFaultPlan
from polyaxon_tpu.serving import RetryPolicy as JRetryPolicy
from polyaxon_tpu.serving.scheduler import SamplingSpec as JSpec
from polyaxon_tpu.serving.scheduler import SchedulerPolicy as JPolicy
from polyaxon_tpu_torch.cli import main as cli_main
from polyaxon_tpu_torch.convert import (gpt2_state_dict_from_jax,
                                        llama_state_dict_from_jax)
from polyaxon_tpu_torch.models.registry import get_model
from polyaxon_tpu_torch.serving import (CircuitBreaker, DecodeEngine,
                                        EngineSupervisor, ModelServer,
                                        RetryPolicy, SamplingSpec,
                                        SchedulerPolicy, ShedError,
                                        make_server)
from polyaxon_tpu_torch.serving.faults import FaultPlan
from polyaxon_tpu_torch.serving.recovery import DeviceLost, is_device_lost
from polyaxon_tpu_torch.serving.scheduler import (DeadlineExceeded,
                                                  PoisonedRequest)
from polyaxon_tpu_torch.serving.server import PagePins

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent

VICTIM = np.asarray([[9, 9, 2, 6]], np.int64)
PROBE = np.asarray([[3, 1, 4, 1]], np.int64)
CT1 = np.asarray([[2, 7, 1, 8]], np.int64)
CT2 = np.asarray([[5, 4, 4, 2]], np.int64)
SAMP = dict(seed=7, temperature=0.9, top_k=16, top_p=0.95)
CT2_SAMP = dict(seed=3, temperature=1.1, top_k=8)

# (rid, prompt, new, sampling kwargs or None): the shared request set.
REQUESTS = (("victim", VICTIM, 8, None), ("probe", PROBE, 8, SAMP),
            ("ct-greedy", CT1, 6, None), ("ct-sampled", CT2, 6, CT2_SAMP))


def _convert(name, jmodel, variables):
    tmodel = get_model(name).make_model(device="cpu", dtype=torch.float32)
    conv = llama_state_dict_from_jax if name.startswith("llama") \
        else gpt2_state_dict_from_jax
    tmodel.load_state_dict(conv(jax.tree.map(np.asarray,
                                             variables["params"]),
                                tmodel.cfg))
    return tmodel.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def pair():
    """(flax model, flax variables, port model): gpt2-tiny, float32."""
    jmodel = j_get_model("gpt2-tiny").make_model(dtype=jnp.float32)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    return jmodel, variables, _convert("gpt2-tiny", jmodel, variables)


@pytest.fixture(scope="module")
def llama_pair():
    jmodel = j_get_model("llama-tiny").make_model(dtype=jnp.float32)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    return jmodel, variables, _convert("llama-tiny", jmodel, variables)


def _solo(jmodel, variables, prompt, new, samp=None):
    p = jnp.asarray(prompt, jnp.int32)
    if samp is None:
        out = JG.generate(jmodel, variables, p, max_new_tokens=new)
    else:
        out = JG.generate_positional(jmodel, variables, p,
                                     max_new_tokens=new, **samp)
    return np.asarray(out).tolist()


@pytest.fixture(scope="module")
def refs(pair):
    """The reference's solo decode per rid: the one ground truth of
    every run, fault-free or chaotic, on either pool."""
    jmodel, variables, _ = pair
    return {rid: _solo(jmodel, variables, p, n, s)
            for rid, p, n, s in REQUESTS}


def _quick():
    return RetryPolicy(max_attempts=3, base_delay_s=0.001,
                       max_delay_s=0.01)


def _port_engine(model, *, faults=None, paged=False, supervise=True,
                 breaker=None, **policy):
    kw = dict(n_slots=4, decode_window=2, queue_depth=16)
    if paged:
        kw.update(kv_paged=True, kv_page_tokens=8)
    kw.update(policy)
    eng = DecodeEngine(
        model, policy=SchedulerPolicy(**kw),
        faults=FaultPlan.load(faults) if faults is not None else None,
        retry_policy=_quick())
    if supervise:
        EngineSupervisor(eng, backoff=RetryPolicy(
            max_attempts=0, base_delay_s=0.001, max_delay_s=0.02),
            breaker=breaker)
    return eng


def _jax_engine(pair, *, faults, paged=False):
    jmodel, variables, _ = pair
    kw = dict(n_slots=4, decode_window=2, queue_depth=16)
    if paged:
        kw.update(kv_paged=True, kv_page_tokens=8)
    eng = JEngine(jmodel, variables, policy=JPolicy(**kw),
                  faults=JFaultPlan.load(faults),
                  retry_policy=JRetryPolicy(max_attempts=3,
                                            base_delay_s=0.001,
                                            max_delay_s=0.01))
    JSupervisor(eng, backoff=JRetryPolicy(
        max_attempts=0, base_delay_s=0.001, max_delay_s=0.02))
    return eng


def _run(eng, spec_cls, schedule="burst"):
    """Submit the request set on a LIVE engine under one co-tenancy
    schedule and wait for every terminal event (a hung caller fails
    the wait)."""
    groups, fillers = {}, []

    def submit(i):
        rid, prompt, new, samp = REQUESTS[i]
        groups[rid] = eng.submit(
            prompt.astype(np.int32), new, None, None,
            sampling=spec_cls(**samp) if samp else None, rid=rid)

    submit(0)
    if schedule == "staggered":
        s0 = groups["victim"].streams[0]
        deadline = time.monotonic() + 60
        while len(s0.out) < 2 and not groups["victim"].event.is_set():
            assert time.monotonic() < deadline, "victim stalled"
            time.sleep(0.002)
    for i in (1, 2, 3):
        submit(i)
    if schedule == "starved":
        for j in range(2):
            fillers.append(eng.submit(
                np.asarray([[1 + j, 2, 3, 4]], np.int32), 6, None, None,
                rid=f"filler-{j}"))
    for rid, g in groups.items():
        assert g.event.wait(timeout=120), f"hung caller: {rid}"
    for g in fillers:
        assert g.event.wait(timeout=120), "hung filler"
    return groups


def _tokens(groups, skip=()):
    return {rid: g.result().tolist() for rid, g in groups.items()
            if rid not in skip}


# -- containment, same plan through both engines ---------------------------

PLANS = {
    "transient": {"seed": 2, "faults": [
        {"site": "step", "kind": "transient", "times": 2}]},
    "poisoned": {"seed": 4, "faults": [
        {"site": "step", "kind": "poisoned", "rid": "victim"}]},
}


@pytest.mark.parametrize("plan_name", list(PLANS))
def test_containment_matches_reference_engine(pair, refs, plan_name):
    """A transient step fault retries in place (2 retries, no
    conviction, no restart); a poisoned one is bisected down to the
    victim, which alone fails with PoisonedRequest while the innocents
    resume token-identically.  The reference's engine, under the same
    plan, counts the same and gives the same tokens."""
    results = []
    for eng, spec in ((_jax_engine(pair, faults=PLANS[plan_name]), JSpec),
                      (_port_engine(pair[2], faults=PLANS[plan_name]),
                       SamplingSpec)):
        try:
            groups = _run(eng, spec)
            st = eng.stats()
        finally:
            eng.close()
        poisoned = plan_name == "poisoned"
        if poisoned:
            assert type(groups["victim"].error).__name__ == \
                "PoisonedRequest"
            assert groups["victim"].status == "poisoned"
        for rid, toks in _tokens(groups, ("victim",) if poisoned
                                 else ()).items():
            assert toks == refs[rid], (rid, type(eng))
        results.append({k: st[k] for k in (
            "step_retries_total", "poisoned_total",
            "engine_crashes_total", "slots_active", "queue_len")})
    assert results[1] == results[0]
    if plan_name == "transient":
        assert results[1]["step_retries_total"] == 2
    else:
        assert results[1]["poisoned_total"] == 1


@pytest.mark.parametrize("victim", [0, 3, 7])
def test_quarantine_bisection_matches_reference_step_for_step(pair,
                                                              victim):
    """Eight requests in eight slots, ticked by hand, one of them
    poisoned: the port's bisection evicts, requeues and convicts
    exactly as the reference's does (the same requeue count, the same
    terminal statuses, the same tokens)."""
    jmodel, variables, tmodel = pair
    plan = {"seed": 1, "faults": [
        {"site": "step", "kind": "poisoned", "rid": f"r{victim}"}]}
    rng = np.random.RandomState(victim)
    prompts = [rng.randint(0, 1000, (1, n)).astype(np.int32)
               for n in rng.randint(5, 20, 8)]
    runs = []
    for eng in (JEngine(jmodel, variables, autostart=False,
                        policy=JPolicy(n_slots=8, decode_window=8),
                        faults=JFaultPlan.load(plan)),
                DecodeEngine(tmodel, autostart=False,
                             policy=SchedulerPolicy(n_slots=8,
                                                    decode_window=8),
                             faults=FaultPlan.load(plan))):
        groups = [eng.submit(p, 12, None, None, rid=f"r{i}")
                  for i, p in enumerate(prompts)]
        eng.run_until_idle()
        st = eng.stats()
        runs.append((st["requests_requeued_total"], st["poisoned_total"],
                     st["resumed_total"], [g.status for g in groups],
                     [g.result().tolist() for i, g in enumerate(groups)
                      if i != victim]))
        eng.close()
    assert runs[1] == runs[0]
    assert runs[1][3][victim] == "poisoned" and runs[1][1] == 1


@pytest.mark.parametrize("schedule", ["burst", "staggered", "starved"])
@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_engine_death_survivors_equal_fault_free(pair, refs, paged,
                                                 schedule):
    """The chaos case: one injected engine death mid-run.  The
    supervisor requeues everything and restarts the loop over the same
    pools; every request completes with the fault-free tokens and
    nothing leaks."""
    eng = _port_engine(pair[2], paged=paged, **(
        {"kv_pages": 12} if paged else {}), faults={
        "seed": 3, "faults": [
            {"site": "engine_death", "after": 3, "times": 1}]})
    try:
        groups = _run(eng, SamplingSpec, schedule)
        st = eng.stats()
        assert _tokens(groups) == refs
        assert st["engine_crashes_total"] == 1
        assert st["engine_restarts_total"] == 1
        assert st["slots_active"] == 0 and st["queue_len"] == 0
        if paged:
            assert eng.slots.free_page_count() == eng.slots.n_pages
    finally:
        eng.close()


def test_engine_death_on_llama_resumes_token_identical(llama_pair):
    """RoPE + GQA through the crash: residents requeue, re-prefill
    ``prompt ++ out[:-1]`` and resume at their absolute positions."""
    jmodel, variables, tmodel = llama_pair
    eng = _port_engine(tmodel, paged=True, faults={"seed": 1, "faults": [
        {"site": "engine_death", "after": 2, "times": 1}]})
    try:
        groups = _run(eng, SamplingSpec)
        assert eng.stats()["engine_restarts_total"] == 1
    finally:
        eng.close()
    for rid, prompt, new, samp in REQUESTS:
        assert groups[rid].result().tolist() == _solo(
            jmodel, variables, prompt, new, samp), rid


def test_zero_steady_state_captures_after_recovery(pair, refs):
    """Recovery resets the pools IN PLACE (host state only): after the
    crash cycle and its replay, the same traffic again adds no graph
    capture (the sentinel's misses stay put) and the stacked cache
    keeps its storage."""
    eng = _port_engine(pair[2], faults={"seed": 1, "faults": [
        {"site": "engine_death", "after": 2, "times": 1}]})
    try:
        assert _tokens(_run(eng, SamplingSpec)) == refs
        assert eng.stats()["engine_restarts_total"] == 1
        ptr = eng.slots._k.data_ptr()
        warm = eng.sentinel.snapshot()["compile_cache_misses"]
        assert _tokens(_run(eng, SamplingSpec)) == refs
        assert eng.sentinel.snapshot()["compile_cache_misses"] == warm
        assert eng.slots._k.data_ptr() == ptr
    finally:
        eng.close()


def test_engine_level_fault_escalates_not_serial_convictions(pair):
    """A fault failing EVERY dispatch tracks the engine: after at most
    two convictions the ladder escalates to the supervisor, the crash
    storm trips the breaker, and every caller reaches a typed terminal
    status — never a hang."""
    eng = _port_engine(
        pair[2], faults={"seed": 0, "faults": [
            {"site": "step", "kind": "transient"}]},
        breaker=CircuitBreaker(threshold=2, window_s=60.0,
                               cooldown_s=0.2))
    eng.retry_policy = RetryPolicy(max_attempts=1, base_delay_s=0.001,
                                   max_delay_s=0.002)
    try:
        groups = [eng.submit(np.asarray([[3 + i, 5, 7]], np.int32), 6,
                             None, None, rid=f"r{i}") for i in range(4)]
        for i, g in enumerate(groups):
            assert g.event.wait(timeout=120), f"hung caller r{i}"
        st = eng.stats()
    finally:
        eng.close()
    assert all(g.error is not None for g in groups)
    assert st["poisoned_total"] <= 2
    assert st["engine_crashes_total"] >= 1


def test_breaker_opens_sheds_and_recovers(pair, refs):
    """A crash storm trips the breaker: in-flight work sheds with
    ``engine_down``, new submits shed at the gate, and the cooldown's
    probe restart closes it again on a healthy engine."""
    eng = _port_engine(
        pair[2], faults={"seed": 0, "faults": [
            {"site": "engine_death", "times": 2}]},
        breaker=CircuitBreaker(threshold=2, window_s=60.0,
                               cooldown_s=0.8))
    try:
        g = eng.submit(PROBE.astype(np.int32), 8, None, None,
                       rid="storm-victim")
        assert g.event.wait(timeout=60), "hung during crash storm"
        assert isinstance(g.error, ShedError), g.error
        assert g.error.reason == "engine_down"
        assert eng.supervisor.breaker.state == CircuitBreaker.OPEN
        assert eng.down
        with pytest.raises(ShedError) as ei:
            eng.submit(PROBE.astype(np.int32), 4, None, None)
        assert ei.value.reason == "engine_down"
        deadline = time.monotonic() + 30
        while eng.down and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not eng.down, "breaker wedged a healthy engine"
        g2 = eng.submit(PROBE.astype(np.int32), 8, None, None,
                        sampling=SamplingSpec(**SAMP))
        assert g2.event.wait(timeout=60) and g2.error is None
        assert g2.result().tolist() == refs["probe"]
        assert eng.supervisor.breaker.state == CircuitBreaker.CLOSED
        assert eng.stats()["engine_crashes_total"] == 2
    finally:
        eng.close()


def test_sticky_device_error_latches_engine_down(pair):
    """A sticky CUDA error (the context is gone) is not retried,
    quarantined or restarted onto: the supervisor latches the breaker
    open, every request fails 503 ``engine_down``, and no restart loop
    spins."""
    eng = _port_engine(pair[2])

    def lost(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    assert is_device_lost(RuntimeError(
        "CUDA error: device-side assert triggered"))
    assert not is_device_lost(RuntimeError("CUDA out of memory"))
    eng.slots.step = lost
    try:
        g = eng.submit(PROBE.astype(np.int32), 8, None, None)
        assert g.event.wait(timeout=60)
        assert isinstance(g.error, ShedError)
        assert g.error.reason == "engine_down"
        time.sleep(0.3)
        st = eng.stats()
        assert eng.down and st["breaker_state"] == "open"
        assert st["engine_crashes_total"] == 1
        assert st["engine_restarts_total"] == 0
        assert st["poisoned_total"] == 0 and st["step_retries_total"] == 0
        with pytest.raises(ShedError):
            eng.submit(PROBE.astype(np.int32), 2, None, None)
        assert isinstance(DeviceLost("x"), RuntimeError)
    finally:
        eng.close()


def test_stale_prefix_pins_die_with_the_pool(pair):
    """Pins cross threads between a prefix lookup and the admission; a
    crash-recovery reset in between bumps the pool epoch, after which
    a stale unpin is a no-op and the admission gate drops a stale
    share by reference — the fresh accounting is never corrupted."""
    eng = DecodeEngine(pair[2], autostart=False, policy=SchedulerPolicy(
        n_slots=2, decode_window=1, kv_paged=True, kv_page_tokens=8,
        kv_pages=12))
    mgr = eng.slots
    ids = mgr.try_reserve(2)
    epoch = mgr.pin(ids)
    mgr.reset()
    assert mgr.epoch == epoch + 1
    mgr.unpin(ids, epoch=epoch)
    assert mgr.free_page_count() == mgr.n_pages
    g = eng.submit(PROBE, 4, None, None,
                   shared_pages=PagePins(tuple(ids), epoch))
    stream = g.streams[0]
    assert stream.kv_shared == tuple(ids) and stream.kv_epoch == epoch
    eng._validate_shared_epoch(stream)
    assert stream.kv_shared is None and stream.kv_epoch is None
    eng.run_until_idle()
    assert g.error is None
    ids2 = mgr.try_reserve(1)
    e2 = mgr.pin(ids2)
    mgr.unpin(ids2, epoch=e2)
    mgr.unpin(ids2)
    assert mgr.free_page_count() == mgr.n_pages
    eng.close()


# -- the server: degradation ladder, HTTP surfaces -------------------------


def test_prefix_store_error_degrades_not_fails(pair, refs):
    """A prefix-store failure disables the store with a counter; the
    request pays full prefill and succeeds, as on the reference."""
    jmodel, variables, tmodel = pair
    from polyaxon_tpu.serving import ModelServer as JServer

    plan = {"seed": 0, "faults": [{"site": "prefix_store", "times": 1}]}
    req = {"prompt": CT1[0].tolist(), "max_new_tokens": 6}
    results = []
    for ms in (JServer(jmodel, variables, model_name="tiny", n_slots=2,
                       fault_plan=plan),
               ModelServer(tmodel, model_name="tiny", n_slots=2,
                           fault_plan=plan)):
        try:
            r = ms.generate(dict(req))
            info = ms.info()
            r2 = ms.generate(dict(req))
            results.append((r["tokens"], r2["tokens"],
                            info["prefix_store_errors"],
                            info["prefix_enabled"]))
            text = ms.metrics_text()
        finally:
            ms.close()
    assert results[1] == results[0]
    assert results[1] == (refs["ct-greedy"], refs["ct-greedy"], 1, False)
    assert "ptpu_serving_prefix_store_errors_total 1" in text


def test_telemetry_faults_stay_isolated(pair, refs):
    """An injected telemetry failure is counted and dropped: the
    request path never notices."""
    eng = _port_engine(pair[2], faults={"seed": 0, "faults": [
        {"site": "telemetry", "times": 3}]})
    try:
        assert _tokens(_run(eng, SamplingSpec)) == refs
        assert eng.stats()["telemetry_errors_total"] == 3
    finally:
        eng.close()


def _start(ms):
    srv = make_server("127.0.0.1", 0, ms)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _post(base, payload, expect=200, path="/generate"):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == expect
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        assert e.code == expect, e.read()
        return json.loads(e.read())


def _get(base, path, expect=200):
    try:
        with urllib.request.urlopen(base + path, timeout=30) as r:
            assert r.status == expect
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        assert e.code == expect
        return json.loads(e.read())


def test_poisoned_request_maps_to_typed_500(pair, refs):
    """The conviction reaches the client as a 500 with ``reason:
    poisoned_request``, while a co-tenant completes normally."""
    ms = ModelServer(pair[2], model_name="tiny", n_slots=4,
                     decode_window=2, fault_plan={"seed": 0, "faults": [
                         {"site": "step", "kind": "poisoned",
                          "request_index": 0}]})
    ms.engine.retry_policy = _quick()
    srv, base = _start(ms)
    results = {}

    def go(name, payload, expect):
        results[name] = _post(base, payload, expect)

    try:
        t1 = threading.Thread(target=go, args=(
            "victim", {"prompt": VICTIM[0].tolist(),
                       "max_new_tokens": 8}, 500))
        t1.start()
        time.sleep(0.05)
        t2 = threading.Thread(target=go, args=(
            "neighbor", {"prompt": CT1[0].tolist(),
                         "max_new_tokens": 6}, 200))
        t2.start()
        t1.join(timeout=120)
        t2.join(timeout=120)
        assert results["victim"]["reason"] == "poisoned_request"
        assert results["neighbor"]["tokens"] == refs["ct-greedy"]
        assert ms.info()["poisoned_total"] == 1
    finally:
        srv.shutdown()
        srv.server_close()
        ms.close()


def test_healthz_503_engine_down_then_recovers(pair):
    """Breaker open: /healthz answers the one not-ready schema (503
    ``engine_down``); the probe restart flips it back to 200."""
    ms = ModelServer(pair[2], model_name="tiny", n_slots=2,
                     supervise=False, fault_plan={"seed": 0, "faults": [
                         {"site": "engine_death", "times": 1}]})
    sup = EngineSupervisor(
        ms.engine, backoff=RetryPolicy(max_attempts=0, base_delay_s=0.001,
                                       max_delay_s=0.01),
        breaker=CircuitBreaker(threshold=1, window_s=60.0,
                               cooldown_s=1.0))
    sup.add_recovery_hook(ms._on_engine_recovery)
    ms.supervisor = sup
    srv, base = _start(ms)
    try:
        out = _post(base, {"prompt": PROBE[0].tolist(),
                           "max_new_tokens": 2}, expect=503)
        assert out["reason"] == "engine_down"
        body = _get(base, "/healthz", expect=503)
        assert body["status"] == "unavailable"
        assert body["reason"] == "engine_down"
        assert body["supervisor"]["breaker"]["state"] == "open"
        deadline = time.monotonic() + 30
        while ms.engine.down and time.monotonic() < deadline:
            time.sleep(0.02)
        assert _get(base, "/healthz")["status"] == "ok"
        r = _post(base, {"prompt": PROBE[0].tolist(),
                         "max_new_tokens": 4})
        assert len(r["tokens"][0]) == PROBE.shape[1] + 4
        text = ms.metrics_text()
        assert "ptpu_serving_engine_crashes_total 1" in text
        assert "ptpu_serving_breaker_open 0" in text
    finally:
        srv.shutdown()
        srv.server_close()
        ms.close()


def test_socket_reset_drops_connection_not_server(pair, refs):
    """An injected handler-socket death drops ONE connection; the
    server keeps serving, no slot leaks, the counter advances."""
    ms = ModelServer(pair[2], model_name="tiny", n_slots=2,
                     fault_plan={"seed": 0, "faults": [
                         {"site": "socket_reset", "times": 1}]})
    srv, base = _start(ms)
    payload = {"prompt": CT1[0].tolist(), "max_new_tokens": 6}
    try:
        with pytest.raises(Exception):
            _post(base, payload)
        assert _post(base, payload)["tokens"] == refs["ct-greedy"]
        st = ms.engine.stats()
        assert st["faults_injected"].get("socket_reset") == 1
        assert st["slots_active"] == 0
        assert 'ptpu_serving_faults_injected_total{site="socket_reset"} 1' \
            in ms.metrics_text()
    finally:
        srv.shutdown()
        srv.server_close()
        ms.close()


def test_crash_recovery_sanitized_writes_report(pair, refs, tmp_path):
    """A supervised crash recovery with the lock sanitizer armed: no
    lock-order violation, the tokens of the fault-free run, and the
    observed lock graph written at close.  Then the static-vs-runtime
    cross-check, as the reference's sanitized smoke makes it: the
    continuous engine never nests the three wrapped locks, so one
    sanitized request through the legacy coalescer (which nests
    device_lock -> _stats_lock) keeps the check from being vacuous, and
    every observed edge must be in the port's static lock graph."""
    report = tmp_path / "locks.json"
    ms = ModelServer(pair[2], model_name="tiny", n_slots=2,
                     decode_window=2,
                     sanitize=True, sanitize_report=str(report),
                     kv_paged=True, kv_page_tokens=8,
                     fault_plan={"seed": 0, "faults": [
                         {"site": "engine_death", "after": 1,
                          "times": 1}]})
    try:
        ms.prefill_prompt({"prompt": CT1[0].tolist()[:3]})
        r = ms.generate({"prompt": CT1[0].tolist(), "max_new_tokens": 6})
        assert r["tokens"] == refs["ct-greedy"]
        assert ms.info()["engine_restarts_total"] == 1
        assert ms.info()["sanitizer"]["violations"] == []
    finally:
        ms.close()
    graph = json.loads(report.read_text())
    assert graph["violations"] == []
    assert graph["acquisitions"] > 0
    ms2 = ModelServer(pair[2], model_name="tiny", batching="coalesce",
                      sanitize=True)
    try:
        ms2.generate({"prompt": CT1[0].tolist(), "max_new_tokens": 4})
        assert ms2.sanitizer.stats()["violations"] == []
    finally:
        ms2.close()
    observed = set(graph["edges"]) | set(ms2.sanitizer.stats()["edges"])
    assert observed, "cross-check vacuous: no runtime edges observed"
    import os

    import polyaxon_tpu_torch
    from polyaxon_tpu_torch.analysis import lockgraph
    from polyaxon_tpu_torch.analysis.checker import iter_py_files

    pkg = os.path.dirname(os.path.abspath(polyaxon_tpu_torch.__file__))
    root = os.path.dirname(pkg)
    sources = {}
    for p in iter_py_files([pkg]):
        rel = os.path.relpath(os.path.abspath(p), root).replace(os.sep, "/")
        if lockgraph.in_program_scope(rel):
            sources[rel] = Path(p).read_text(encoding="utf-8")
    static = lockgraph.build_lock_graph(
        lockgraph.build_model(sources)).edge_names()
    missing = sorted(observed - static)
    assert not missing, (
        f"lock edges observed at runtime but absent from the static "
        f"graph (analyzer blind spot): {missing}; static: "
        f"{sorted(static)}")
    with pytest.raises(ValueError, match="sanitize_report"):
        ModelServer(pair[2], sanitize_report=str(report))


# -- SLO preemption ----------------------------------------------------------

OTHER = np.asarray([[7, 7, 3]], np.int64)


def _manual(model, **policy):
    return DecodeEngine(model, autostart=False, policy=SchedulerPolicy(
        n_slots=1, decode_window=1, **policy))


@pytest.mark.parametrize("mode", ["plain", "sampled"])
def test_preempt_and_resume_is_token_identical(pair, mode):
    """A batch request preempted mid-decode for an interactive one and
    resumed commits exactly the tokens of its uninterrupted run, as on
    the reference's engine under the same schedule; the interactive
    request matches its own solo run."""
    jmodel, variables, tmodel = pair
    samp = SAMP if mode == "sampled" else None
    want = _solo(jmodel, variables, PROBE, 14, samp)
    runs = []
    for eng, spec in ((JEngine(jmodel, variables, autostart=False,
                               policy=JPolicy(n_slots=1, decode_window=1,
                                              slo_ttft_s=0.0001)), JSpec),
                      (_manual(tmodel, slo_ttft_s=0.0001), SamplingSpec)):
        victim = eng.submit(PROBE.astype(np.int32), 14, None, None,
                            sampling=spec(**samp) if samp else None,
                            priority="batch")
        for _ in range(4):
            eng.tick()
        before = len(victim.streams[0].out)
        assert 2 <= before < 14, "preemption must land mid-decode"
        inter = eng.submit(OTHER.astype(np.int32), 3, None, None,
                           priority="interactive")
        eng.run_until_idle()
        runs.append((victim.result().tolist(), inter.result().tolist(),
                     eng.preempted_total, eng.resumed_total, before))
        eng.close()
    assert runs[1] == runs[0]
    assert runs[1][0] == want
    assert runs[1][1] == _solo(jmodel, variables, OTHER, 3)
    assert runs[1][2:4] == (1, 1)


@pytest.mark.parametrize("case", ["no_slo", "interactive_residents",
                                  "degraded_p99"])
def test_slo_arming(pair, case):
    """SLO arming, as on the reference: no preemption without an SLO;
    interactive residents are never preempted (the scheduler defers);
    a degraded recent TTFT p99 arms preemption even for a head still
    under half the target."""
    jmodel, variables, tmodel = pair
    counts = []
    for make in (lambda **kw: JEngine(jmodel, variables, autostart=False,
                                      policy=JPolicy(n_slots=1,
                                                     decode_window=1,
                                                     **kw)),
                 lambda **kw: _manual(tmodel, **kw)):
        slo = {"no_slo": {}, "interactive_residents":
               {"slo_ttft_s": 0.0001}, "degraded_p99":
               {"slo_ttft_s": 5.0}}[case]
        eng = make(**slo)
        if case == "degraded_p99":
            for _ in range(50):
                eng._ttft_recent.append(30.0)
        first = eng.submit(PROBE.astype(np.int32), 10, None, None,
                           priority="interactive"
                           if case == "interactive_residents"
                           else "batch")
        for _ in range(3):
            eng.tick()
        second = eng.submit(OTHER.astype(np.int32), 3, None, None,
                            priority="interactive")
        eng.run_until_idle()
        assert first.error is None and second.error is None
        counts.append((eng.preempted_total, first.result().tolist(),
                       second.result().tolist()))
        eng.close()
    assert counts[1] == counts[0]
    assert counts[1][0] == (1 if case == "degraded_p99" else 0)


# -- the serve flags, the example plan, the closed server -------------------


def test_example_fault_plan_loads():
    plan = FaultPlan.load(str(ROOT / "polyaxon_tpu_torch" / "examples"
                              / "fault_plan.json"))
    sites = {spec["site"] for spec in plan.describe()}
    assert {"step", "engine_death", "prefix_store"} <= sites
    JFaultPlan.load(str(ROOT / "polyaxon_tpu_torch" / "examples"
                        / "fault_plan.json"))


class _NoServe:
    server_address = ("127.0.0.1", 0)

    def serve_forever(self):
        pass

    def server_close(self):
        pass


def test_serve_flags_reach_the_server(monkeypatch):
    """``serve`` takes the reference's flags with its defaults: a
    prefix cache of 4 and a supervised engine unless told otherwise;
    --fault-plan, --slo-ttft-ms and the queue knobs reach the
    engine."""
    built = []

    def fake_make_server(host, port, ms):
        built.append(ms)
        return _NoServe()

    import polyaxon_tpu_torch.serving as serving_pkg

    monkeypatch.setattr(serving_pkg, "make_server", fake_make_server)
    plan = str(ROOT / "polyaxon_tpu_torch" / "examples"
               / "fault_plan.json")
    for args in ([], ["--fault-plan", plan, "--no-supervise",
                      "--slo-ttft-ms", "250", "--prefix-cache", "2",
                      "--default-priority", "batch",
                      "--batch-queue-depth", "5", "--queue-deadline-ms",
                      "900", "--batch-queue-deadline-ms", "1200",
                      "--trace-buffer", "0", "--no-forensics",
                      "--exemplar-k", "0"]):
        out = CliRunner().invoke(cli_main.cli, [
            "serve", "--model", "gpt2-tiny", "--cpu", *args])
        assert out.exit_code == 0, out.output
    default, tuned = built
    assert default.prefix_cache_size == 4
    assert default.supervisor is not None and default.faults is None
    assert default.forensics is not None
    assert tuned.prefix_cache_size == 2 and tuned.supervisor is None
    assert tuned.faults is not None
    pol = tuned.engine.policy
    assert pol.slo_ttft_s == 0.25 and pol.default_priority == "batch"
    assert pol.batch_queue_depth == 5
    assert pol.queue_deadline_s == 0.9
    assert pol.batch_queue_deadline_s == 1.2
    assert tuned.forensics is None and not tuned.telemetry.enabled


@pytest.mark.parametrize("flags,message", [
    (["--slo-ttft-ms", "0"], "--slo-ttft-ms must be >= 1"),
    (["--prefix-cache", "-1"], "--prefix-cache must be >= 0"),
    (["--sanitize-max-hold", "1"], "requires --sanitize"),
    (["--stall-timeout", "0"], "--stall-timeout must be > 0"),
])
def test_serve_rejects_bad_fault_flags(monkeypatch, flags, message):
    def refuse(*a, **kw):
        raise AssertionError("model built before flag validation")

    monkeypatch.setattr(cli_main, "_build_serving_model", refuse)
    out = CliRunner().invoke(cli_main.cli, [
        "serve", "--model", "gpt2-tiny", "--cpu", *flags])
    assert out.exit_code != 0 and message in out.output


def test_serve_rejects_a_bad_fault_plan(monkeypatch, tmp_path):
    bad = tmp_path / "plan.json"
    bad.write_text(json.dumps({"faults": [{"site": "nope"}]}))
    monkeypatch.setattr(cli_main, "_build_serving_model",
                        lambda *a, **kw: pytest.fail("model built"))
    out = CliRunner().invoke(cli_main.cli, [
        "serve", "--model", "gpt2-tiny", "--cpu", "--fault-plan",
        str(bad)])
    assert out.exit_code != 0 and "--fault-plan" in out.output


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_closed_server_is_freed_without_the_collector(paged, monkeypatch):
    """``close()`` breaks the server's reference cycles: with the cycle
    collector off from the server's birth, dropping a closed server
    (after a prefix store, a hit, a supervised crash recovery, an
    expired request, a poisoned one and a failed prefill) frees its
    engine, pools, supervisor and model at once."""
    gc.collect()
    gc.disable()
    try:
        model = get_model("gpt2-tiny").init_params(
            seed=0, device="cpu", dtype=torch.float32)
        ms = ModelServer(model, model_name="tiny", n_slots=2,
                         decode_window=2, kv_paged=paged,
                         kv_page_tokens=8,
                         fault_plan={"seed": 0, "faults": [
                             {"site": "engine_death", "after": 2,
                              "times": 1},
                             {"site": "step", "kind": "poisoned",
                              "request_index": 2}]})
        ms.prefill_prompt({"prompt": [1, 2, 3, 4, 5, 6, 7, 8, 9]})
        r = ms.generate({"prompt": [1, 2, 3, 4, 5, 6, 7, 8, 9, 10],
                         "max_new_tokens": 12})
        assert r["prefix_hit_len"] == 9
        assert ms.info()["engine_restarts_total"] == 1
        with pytest.raises(DeadlineExceeded):
            ms.generate({"prompt": [3, 4], "max_new_tokens": 40,
                         "deadline_ms": 1})
        with pytest.raises(PoisonedRequest):
            ms.generate({"prompt": [5, 6], "max_new_tokens": 4})
        from polyaxon_tpu_torch.models import generate as TG

        real_prefill = TG.prefill

        def oom(model, toks, **kw):
            if toks.shape[1] == 7:
                raise RuntimeError("out of memory (injected)")
            return real_prefill(model, toks, **kw)

        monkeypatch.setattr(TG, "prefill", oom)
        with pytest.raises(RuntimeError, match="out of memory"):
            ms.generate({"prompt": [7] * 7, "max_new_tokens": 4})
        monkeypatch.setattr(TG, "prefill", real_prefill)
        refs = [weakref.ref(o) for o in (
            ms, ms.engine, ms.engine.slots, ms.supervisor, ms.telemetry,
            model)]
        ms.close()
        del ms, model, r
        alive = [i for i, ref in enumerate(refs) if ref() is not None]
    finally:
        gc.enable()
    assert alive == [], alive
