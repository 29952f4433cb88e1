"""The fleet tier of the port — the host spill tier, the ``/prefix/*``
wire lanes, ``resume_tokens``, the replica router (``serving/router.py``)
and ``--role`` disaggregated prefill/decode — on small gpt2 fleets of
``LocalReplica``s, held against the JAX package's fleet with the same
converted float32 weights.  The reference's pins (its
``test_fleet_prefix.py``, ``test_disagg.py``, ``test_router.py``) on the
port:

- ROLES: validation, the ``/healthz`` and ``/info`` surfaces, a prefill
  replica's typed 400 on ``/generate``.
- TWO-STAGE SCHEDULE: a long prompt prefills on the prefill tier and
  decodes on a decode replica that admits its KV over the wire
  (``prefix_source == "wire_fetch"``, ``prefill_remote`` and
  ``kv_handoff`` in the router's timeline); tokens equal a monolithic
  server's and the JAX fleet's (greedy, sampled, speculative).
- DEGRADE LADDER: a dead prefill tier is a counted re-prefill; a dead or
  killed decode replica fails over to another DECODE replica; a replay
  with ``resume_tokens`` on another replica is token-identical.
- The wire fetch is bitwise a local hit and a re-prefill; its failures
  degrade to counted re-prefills; the drain handoff's successor serves
  without a re-prefill; the host tier spills and serves host hits.
- The ``/prefix/*`` and ``/fleet/*`` routes, their ``/metrics`` families
  and ``serve``/``route``'s flags have the reference's names.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import generate as JG
from polyaxon_tpu.models.gpt2 import GPT2Config as JConfig
from polyaxon_tpu.models.gpt2 import GPT2Model as JModel
from polyaxon_tpu.serving import LocalReplica as JLocalReplica
from polyaxon_tpu.serving import ModelServer as JServer
from polyaxon_tpu.serving import PrefixFetchPolicy as JPolicy
from polyaxon_tpu.serving import ReplicaRouter as JRouter
from polyaxon_tpu.serving.router import Replica as JReplica
from polyaxon_tpu_torch.convert import gpt2_state_dict_from_jax
from polyaxon_tpu_torch.models.registry import get_model
from polyaxon_tpu_torch.serving import (DecodeEngine, LocalReplica,
                                        ModelServer, PrefixFetchPolicy,
                                        ReplicaRouter, SamplingSpec,
                                        SchedulerPolicy,
                                        make_router_server)
from polyaxon_tpu_torch.serving.paged import pack_spilled
from polyaxon_tpu_torch.serving.router import Replica

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYS_LEN, USER_LEN, NEW = 24, 4, 4
SMALL = dict(vocab_size=32, hidden_size=32, num_layers=2, num_heads=2,
             max_position=64)


@pytest.fixture(scope="module")
def models():
    """(reference model, its variables, the port's model): the same
    float32 weights, converted."""
    cfg = dataclasses.replace(JConfig.tiny(), dtype=jnp.float32, **SMALL)
    jmodel = JModel(cfg=cfg)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 4), jnp.int32))
    tmodel = get_model("gpt2-tiny").make_model(
        device="cpu", dtype=torch.float32, **SMALL)
    tmodel.load_state_dict(gpt2_state_dict_from_jax(
        jax.tree.map(np.asarray, variables["params"]), tmodel.cfg))
    return jmodel, variables, tmodel.eval().requires_grad_(False)


def _kw(kw):
    kw.setdefault("prefix_cache", 8)
    kw.setdefault("kv_paged", True)
    kw.setdefault("kv_page_tokens", 8)
    kw.setdefault("kv_pages", 32)
    kw.setdefault("kv_host_spill_bytes", 1 << 20)
    kw.setdefault("prefix_fetch", True)
    return kw


def _factory(models, **kw):
    """A port ModelServer factory (the reference's fleet idiom).
    prefill_tok_per_s=1 prices a re-prefill so high that the cost gate
    keeps choosing the wire on the loopback."""
    model = models[2]
    kw = _kw(kw)
    if kw["prefix_fetch"]:
        kw.setdefault("prefix_fetch_policy",
                      PrefixFetchPolicy(min_tokens=1,
                                        prefill_tok_per_s=1.0))

    def make():
        return ModelServer(model, model_name="tiny", max_batch=4,
                           n_slots=2, queue_depth=16, decode_window=2,
                           draft_model=model, **kw)
    return make


def _j_factory(models, **kw):
    jmodel, variables, _ = models
    kw = _kw(kw)
    kw.setdefault("prefix_fetch_policy",
                  JPolicy(min_tokens=1, prefill_tok_per_s=1.0))

    def make():
        return JServer(jmodel, variables, model_name="tiny", max_batch=4,
                       n_slots=2, queue_depth=16, decode_window=2,
                       draft_model=jmodel, draft_variables=variables,
                       **kw)
    return make


def _spawn(models, roles, *, router_kw=None, jax_fleet=False):
    """A fleet with one replica per role; waits until the router's
    probes have learned every role."""
    make, local, router_cls = (_j_factory, JLocalReplica, JRouter) \
        if jax_fleet else (_factory, LocalReplica, ReplicaRouter)
    reps = [local(make(models, role=role), f"r{i}")
            for i, role in enumerate(roles)]
    kw = dict(probe_interval_s=0.1, probe_timeout_s=0.5,
              cooldown_s=0.2, request_timeout_s=60.0)
    kw.update(router_kw or {})
    router = router_cls(reps, **kw)
    if jax_fleet:
        from polyaxon_tpu.serving import make_router_server as j_mk

        srv = j_mk("127.0.0.1", 0, router)
    else:
        srv = make_router_server("127.0.0.1", 0, router)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    deadline = time.monotonic() + 10.0
    while [r.role for r in router.replicas] != list(roles):
        assert time.monotonic() < deadline, "roles never learned"
        time.sleep(0.02)
    return base, router, srv, reps


def _teardown(router, srv, reps):
    router.close()
    srv.shutdown()
    srv.server_close()
    for r in reps:
        r.close()


@pytest.fixture(scope="module")
def disagg_fleet(models):
    """One prefill replica, two decode replicas (the chip topology)."""
    fleet = _spawn(models, ["prefill", "decode", "decode"])
    yield fleet
    _teardown(*fleet[1:])


@pytest.fixture(scope="module")
def fleet(models):
    """Three monolithic paged replicas (wire fetch, resume)."""
    fleet = _spawn(models, ["both", "both", "both"])
    yield fleet
    _teardown(*fleet[1:])


@pytest.fixture(scope="module")
def mono(models):
    rep = LocalReplica(_factory(models), "mono")
    yield rep
    rep.close()


def _post(base, payload, timeout=120, path="/generate"):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(base, path, timeout=30):
    with urllib.request.urlopen(base + path, timeout=timeout) as r:
        body = r.read()
    return body.decode() if path.endswith("metrics") else json.loads(body)


def _prompt(seed, n=SYS_LEN + USER_LEN):
    return np.random.RandomState(seed).randint(0, 32, size=n).tolist()


def _hint(rep):
    return {"host": rep.host, "port": rep.port, "replica": rep.id}


MODES = [({}, "wire_fetch"),
         ({"temperature": 0.9, "top_k": 8, "seed": 11}, "wire_fetch"),
         # Speculative requests stay cold by design (the prefix path
         # gates on ``not speculative``): the decode side re-prefills.
         ({"speculative": True, "spec_k": 2}, "re_prefill")]


# -- roles -------------------------------------------------------------------


def test_role_validation(models):
    with pytest.raises(ValueError, match="role"):
        _factory(models, role="router")()
    with pytest.raises(ValueError, match="prefill"):
        _factory(models, role="prefill", kv_paged=False,
                 kv_host_spill_bytes=0, prefix_fetch=False)()
    with pytest.raises(ValueError, match="decode"):
        _factory(models, role="decode", prefix_fetch=False)()
    with pytest.raises(ValueError, match="kv_paged"):
        _factory(models, kv_paged=False, prefix_fetch=False)()
    with pytest.raises(ValueError, match="host spill"):
        _factory(models, kv_host_spill_bytes=0)()


def test_role_surfaces_and_prefill_rejects_generate(disagg_fleet):
    _, router, _, reps = disagg_fleet
    pre = reps[0]
    assert _get(pre.url, "/healthz")["role"] == "prefill"
    assert _get(pre.url, "/info")["role"] == "prefill"
    assert _get(reps[1].url, "/healthz")["role"] == "decode"
    assert {r["id"]: r["role"] for r in router.stats()["replicas"]} == {
        "r0": "prefill", "r1": "decode", "r2": "decode"}
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(pre.url, {"prompt": _prompt(1), "max_new_tokens": NEW})
    assert exc.value.code == 400
    assert "prefill" in json.loads(exc.value.read())["error"]
    out = _post(pre.url, {"prompt": _prompt(2)}, path="/prefill")
    assert out["cached_len"] == SYS_LEN + USER_LEN


# -- the two-stage schedule -----------------------------------------------


@pytest.fixture(scope="module")
def jax_disagg_tokens(models):
    """The JAX package's disaggregated fleet (prefill + decode) on the
    same weights: its tokens for every mode of MODES."""
    base, router, srv, reps = _spawn(models, ["prefill", "decode"],
                                     jax_fleet=True)
    try:
        out = {}
        for i, (mode_kw, _src) in enumerate(MODES):
            body = {"prompt": _prompt(400 + i), "max_new_tokens": NEW,
                    **mode_kw}
            resp = _post(base, body)
            out[i] = (resp["new_tokens"], resp["prefix_source"])
        return out
    finally:
        _teardown(router, srv, reps)


@pytest.mark.parametrize("i", range(len(MODES)),
                         ids=["greedy", "sampled", "spec"])
def test_disagg_tokens_equal_monolithic_and_reference(
        disagg_fleet, mono, jax_disagg_tokens, i):
    base, router, _, _ = disagg_fleet
    mode_kw, wired = MODES[i]
    body = {"prompt": _prompt(400 + i), "max_new_tokens": NEW, **mode_kw}
    n_pre = router.disagg_prefills_total
    resp = _post(base, dict(body))
    assert resp["prefix_source"] == wired
    assert router.disagg_prefills_total == n_pre + 1
    assert router.disagg_prefill_failed_total == 0
    assert resp["router"]["replica"] in ("r1", "r2")
    events = [e.get("event") for e in
              router.fleet_request(resp["request_id"])["timeline"]]
    assert "prefill_remote" in events
    if wired == "wire_fetch":
        assert resp["prefix_fetch_bytes"] > 0
        assert resp["prefix_fetch_s"] > 0
        assert "kv_handoff" in events
        assert router.replicas[0].wire_bytes_per_s is not None
    ref = _post(mono.url, dict(body))
    assert ref["prefix_source"] == "re_prefill"
    assert resp["new_tokens"] == ref["new_tokens"] \
        == jax_disagg_tokens[i][0]
    assert jax_disagg_tokens[i][1] == wired


def test_disagg_warm_prefix_skips_stage_one(disagg_fleet):
    base, router, _, _ = disagg_fleet
    body = {"prompt": _prompt(77), "max_new_tokens": NEW}
    first = _post(base, dict(body))
    assert first["prefix_source"] == "wire_fetch"
    n_pre = router.disagg_prefills_total
    second = _post(base, dict(body))
    assert second["prefix_source"] in ("local_hot", "local_spilled")
    assert second["router"]["replica"] == first["router"]["replica"]
    assert router.disagg_prefills_total == n_pre


# -- degrade ladder -------------------------------------------------------


def test_dead_prefill_degrades_to_decode_re_prefill(models):
    dead = Replica("http://127.0.0.1:9", "pre")
    dead.role = "prefill"
    live = LocalReplica(_factory(models, role="decode"), "dec")
    live.role = "decode"
    router = ReplicaRouter([dead, live], autostart=False,
                           request_timeout_s=60.0)
    try:
        code, resp = router.route_generate(
            {"prompt": _prompt(600), "max_new_tokens": NEW})
        assert code == 200
        assert resp["prefix_source"] == "re_prefill"
        assert resp["router"]["replica"] == "dec"
        assert router.disagg_prefills_total == 1
        assert router.disagg_prefill_failed_total == 1
    finally:
        router.close()
        live.close()


def test_dead_decode_fails_over_to_decode_never_prefill(models):
    pre = LocalReplica(_factory(models, role="prefill"), "pre")
    pre.role = "prefill"
    dead = Replica("http://127.0.0.1:9", "d0")
    dead.role = "decode"
    live = LocalReplica(_factory(models, role="decode"), "d1")
    live.role = "decode"
    router = ReplicaRouter([pre, dead, live], autostart=False,
                           request_timeout_s=60.0)
    live.inc_outstanding()      # bias the first pick to the dead one
    try:
        code, resp = router.route_generate(
            {"prompt": _prompt(601), "max_new_tokens": NEW})
        assert code == 200
        assert resp["router"]["replica"] == "d1"
        assert router.failovers_total == 1
        assert "pre" not in router.history.get(
            resp["request_id"])["replicas"]
    finally:
        router.close()
        pre.close()
        live.close()


def test_killed_decode_mid_request_fails_over_token_identical(
        models, mono):
    """A decode replica killed while it decodes a request: the router
    fails the request over to the other DECODE replica (never the
    prefill tier) and the tokens equal the uninterrupted run.  The
    router replays whole (its responses are not streamed, so it holds
    no partial output); the survivor also resumes the killed stream's
    committed tokens with ``resume_tokens``, token-identically."""
    base, router, srv, reps = _spawn(models, ["prefill", "decode",
                                              "decode"])
    body = {"prompt": _prompt(602, 20), "max_new_tokens": 40,
            "temperature": 0.9, "seed": 4}
    try:
        want = _post(mono.url, dict(body))["tokens"][0]
        got, committed = {}, {}

        def go():
            got["resp"] = _post(base, dict(body))

        t = threading.Thread(target=go)
        t.start()
        victim = None
        deadline = time.monotonic() + 60
        while victim is None and time.monotonic() < deadline:
            for rep in reps[1:]:
                streams = list(rep.ms.engine._resident.values())
                if streams and len(streams[0].out) >= 2:
                    committed["out"] = list(streams[0].out)
                    victim = rep
                    break
            time.sleep(0.001)
        assert victim is not None, "no decode replica took the request"
        victim.chaos_kill()
        t.join(timeout=120)
        resp = got["resp"]
        survivor = [r for r in reps[1:] if r is not victim][0]
        assert resp["tokens"][0] == want
        assert resp["router"]["replica"] == survivor.id
        assert router.failovers_total >= 1
        assert reps[0].id not in router.history.get(
            resp["request_id"])["replicas"]
        n = len(committed["out"])
        assert want[20:20 + n] == committed["out"]
        resumed = _post(survivor.url, {**body,
                                       "prompt": want[:20 + n],
                                       "resume_tokens": n})
        assert resumed["tokens"][0] == want
        assert resumed["new_tokens"][0] == want[20 + n:]
    finally:
        _teardown(router, srv, reps)


# -- cross-replica resume ------------------------------------------------


def _requests():
    return [("greedy", {"prompt": [5, 6, 7], "max_new_tokens": 8}),
            ("sampled", {"prompt": [3, 1, 4, 1], "max_new_tokens": 8,
                         "temperature": 0.9, "top_k": 16, "top_p": 0.95,
                         "seed": 7}),
            ("spec", {"prompt": [2, 7, 1, 8], "max_new_tokens": 8,
                      "speculative": True, "spec_k": 2}),
            ("spec-sampled", {"prompt": [9, 9, 2, 6],
                              "max_new_tokens": 8, "speculative": True,
                              "spec_k": 2, "temperature": 1.1,
                              "top_k": 8, "seed": 3})]


def _reference_tokens(models, req):
    jmodel, variables, _ = models
    p = jnp.asarray([req["prompt"]], jnp.int32)
    new = req["max_new_tokens"]
    if req.get("speculative") and req.get("temperature", 0.0):
        out = JG.generate_speculative(
            jmodel, variables, jmodel, variables, p, max_new_tokens=new,
            k=req["spec_k"], seed=req["seed"],
            temperature=req["temperature"], top_k=req.get("top_k"),
            top_p=req.get("top_p"))
    elif req.get("temperature", 0.0) == 0.0:
        out = JG.generate(jmodel, variables, p, max_new_tokens=new)
    else:
        out = JG.generate_positional(
            jmodel, variables, p, max_new_tokens=new, seed=req["seed"],
            temperature=req["temperature"], top_k=req.get("top_k"),
            top_p=req.get("top_p"))
    return np.asarray(out).tolist()


@pytest.mark.parametrize("name", ["greedy", "sampled", "spec",
                                  "spec-sampled"])
def test_cross_replica_resume_token_identical(fleet, models, name):
    """``prompt ++ tokens_so_far`` with ``resume_tokens`` on another
    replica: the reference's uninterrupted tokens, bitwise."""
    _, _, _, reps = fleet
    req = dict(dict(_requests())[name])
    want = _reference_tokens(models, req)
    p = len(req["prompt"])
    assert _post(reps[0].url, dict(req))["tokens"] == want
    for cut in (1, 3, req["max_new_tokens"] - 1):
        resumed = _post(reps[(cut + 1) % len(reps)].url, {
            **req, "prompt": want[0][:p + cut], "resume_tokens": cut})
        assert resumed["tokens"] == want, f"{name} resume at {cut}"
        assert resumed["new_tokens"][0] == want[0][p + cut:]


def test_resume_validation(fleet):
    url = fleet[3][0].url
    good = {"prompt": [5, 6, 7, 8], "max_new_tokens": 4}
    for bad in ({**good, "resume_tokens": 4},          # no prompt left
                {**good, "resume_tokens": -1},
                {**good, "resume_tokens": True},
                {"prompt": [5, 6, 7, 8], "max_new_tokens": 2,
                 "resume_tokens": 2},                  # no budget left
                {**good, "resume_tokens": 1, "num_beams": 2},
                {**good, "resume_tokens": 1, "eos_id": 8}):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url, bad)
        assert ei.value.code == 400, bad


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_engine_resume_tokens_on_both_pools(models, paged):
    """``DecodeEngine.submit(resume_tokens=)`` on a manual-tick engine:
    the uninterrupted sampled run, whatever the cut."""
    tmodel = models[2]
    prompt = np.asarray([_prompt(9, 6)])
    spec = SamplingSpec(5, 0.9, 8, None)
    policy = dict(n_slots=2, decode_window=2, kv_paged=paged,
                  kv_page_tokens=8)

    def run(rows, rt=0):
        eng = DecodeEngine(tmodel, policy=SchedulerPolicy(**policy),
                           autostart=False)
        g = eng.submit(rows, 10, None, None, sampling=spec,
                       resume_tokens=rt)
        while not g.event.is_set():
            eng.tick()
        return g.result()

    want = run(prompt)
    for cut in (1, 4, 9):
        got = run(want[:, :6 + cut], cut)
        np.testing.assert_array_equal(got, want, err_msg=cut)


# -- the wire lanes -------------------------------------------------------


@pytest.mark.parametrize("mode_kw", [{}, {"temperature": 0.9, "top_k": 8,
                                          "seed": 5}],
                         ids=["greedy", "sampled"])
def test_wire_fetch_bitwise_identity(fleet, mode_kw):
    holder, fetcher, fresh = fleet[3]
    seed = 100 + len(mode_kw)
    system = _prompt(seed, SYS_LEN)
    _post(holder.url, {"prompt": system}, path="/prefill")
    body = {"prompt": system + _prompt(seed + 50, USER_LEN),
            "max_new_tokens": NEW, **mode_kw}
    wired = _post(fetcher.url, {**body, "prefix_hint": _hint(holder)})
    assert wired["prefix_source"] == "wire_fetch"
    assert wired["prefix_hit_len"] == SYS_LEN
    local = _post(holder.url, dict(body))
    assert local["prefix_source"] in ("local_hot", "local_spilled")
    replayed = _post(fresh.url, dict(body))
    assert replayed["prefix_source"] == "re_prefill"
    assert wired["new_tokens"] == local["new_tokens"] \
        == replayed["new_tokens"]


def test_fetch_failure_degrades_to_typed_re_prefill(fleet):
    fetcher = fleet[3][1]
    pre = _get(fetcher.url, "/info")
    resp = _post(fetcher.url, {
        "prompt": _prompt(300), "max_new_tokens": NEW,
        "prefix_hint": {"host": "127.0.0.1", "port": 9}})
    assert resp["prefix_source"] == "re_prefill"
    assert len(resp["new_tokens"][0]) == NEW
    info = _get(fetcher.url, "/info")
    assert info["prefix_fetch_total"] > pre["prefix_fetch_total"]
    assert info["prefix_fetch_failed"].get("wire_error", 0) \
        > pre["prefix_fetch_failed"].get("wire_error", 0)
    blob = bytearray(pack_spilled(
        np.zeros((1, 8), np.int32),
        [None, torch.zeros(2, 1, 8, 2, 16), torch.zeros(2, 1, 8, 2, 16)],
        8, torch.zeros(1, 32)))
    blob[-1] ^= 0xFF
    req = urllib.request.Request(
        fetcher.url + "/prefix/ingest", data=bytes(blob),
        headers={"Content-Type": "application/octet-stream"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=30)
    assert ei.value.code == 400
    assert json.loads(ei.value.read())["reason"] == "payload_integrity"
    assert _get(fetcher.url, "/info")["prefix_ingest_rejected_total"] \
        == info["prefix_ingest_rejected_total"] + 1


def test_drain_handoff_successor_serves_without_re_prefill(models):
    base, router, srv, reps = _spawn(models, ["both", "both"])
    try:
        system = _prompt(400, SYS_LEN)
        _post(base, {"prompt": system}, path="/prefill")
        with urllib.request.urlopen(urllib.request.Request(
                base + "/fleet/restart", data=b"",
                headers={"Content-Type": "application/json"}),
                timeout=30) as r:
            assert r.status == 200
        deadline = time.monotonic() + 120.0
        while router.restart_state["in_progress"]:
            assert time.monotonic() < deadline, "restart wedged"
            time.sleep(0.05)
        assert router.restart_state["last_error"] is None
        st = router.stats()
        assert st["kv_fleet_handoffs_total"] >= 2
        assert st["kv_fleet_handoff_entries_total"] >= 1
        resp = _post(base, {"prompt": system + _prompt(401, USER_LEN),
                            "max_new_tokens": NEW})
        assert resp["prefix_source"] != "re_prefill"
        assert resp["prefix_hit_len"] == SYS_LEN
    finally:
        _teardown(router, srv, reps)


def test_rebalance_and_prefix_routes(models):
    """``GET /prefix/index``, ``POST /prefix/fetch|ingest|evict`` and the
    router's one-copy-somewhere rebalance over them."""
    base, router, srv, reps = _spawn(models, ["both", "both"])
    try:
        holder, fetcher = reps
        system = _prompt(500, SYS_LEN)
        _post(holder.url, {"prompt": system}, path="/prefill")
        miss = urllib.request.Request(
            holder.url + "/prefix/fetch",
            data=json.dumps({"prompt": _prompt(501, 8)}).encode())
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(miss, timeout=30)
        assert ei.value.code == 404
        with urllib.request.urlopen(urllib.request.Request(
                holder.url + "/prefix/fetch",
                data=json.dumps({"prompt": system}).encode()),
                timeout=30) as r:
            blob = r.read()
        with urllib.request.urlopen(urllib.request.Request(
                fetcher.url + "/prefix/ingest", data=blob),
                timeout=30) as r:
            assert json.loads(r.read())["stored"] is True
        idx = _get(fetcher.url, "/prefix/index")
        host = {e["key"] for e in idx["entries"] if e["tier"] == "host"}
        assert host and idx["host_bytes"] > 0
        assert {e["tier"] for e in _get(holder.url,
                                        "/prefix/index")["entries"]} \
            == {"device"}
        with urllib.request.urlopen(urllib.request.Request(
                base + "/fleet/prefix/rebalance", data=b""),
                timeout=30) as r:
            out = json.loads(r.read())
        assert out["duplicates"] >= 1 and out["evicted"] >= 1
        assert not host & {e["key"] for e in _get(
            fetcher.url, "/prefix/index")["entries"]}
        again = _post(holder.url, {
            "prompt": system + _prompt(502, USER_LEN),
            "max_new_tokens": NEW})
        assert again["prefix_source"] in ("local_hot", "local_spilled")
        evict = _post(fetcher.url, {"keys": ["nope"]},
                      path="/prefix/evict")
        assert evict == {**evict, "evicted": 0, "requested": 1}
    finally:
        _teardown(router, srv, reps)


# -- the host tier on one server -------------------------------------------


def test_host_tier_spills_and_serves_host_hits(models):
    """A pool too small for its prefixes: page pressure SPILLS them to
    host memory, a later request hits the host tier
    (``local_spilled``), promotes it back to pages, and decodes the
    tokens of the uncached server; host entries survive the recovery
    hook's flush of device-tier entries."""
    tmodel = models[2]
    ms = ModelServer(tmodel, n_slots=2, decode_window=2,
                     kv_paged=True, kv_page_tokens=8, kv_pages=10,
                     kv_host_spill_bytes=1 << 20, prefix_cache=8)
    cold = ModelServer(tmodel, n_slots=2, decode_window=2,
                       kv_paged=True, kv_page_tokens=8, kv_pages=10,
                       prefix_cache=0)
    try:
        systems = [_prompt(700 + i, SYS_LEN) for i in range(3)]
        for s in systems:
            ms.prefill_prompt({"prompt": s})
        # 3 x 3 pages stored of 10: a request needing 5 pages spills.
        body = {"prompt": _prompt(710, 30), "max_new_tokens": 8}
        assert ms.generate(dict(body))["new_tokens"] \
            == cold.generate(dict(body))["new_tokens"]
        info = ms.info()
        assert info["kv_host_spills_total"] >= 1
        assert info["kv_host_entries"] >= 1 and info["kv_host_spill_bytes"]
        hit = {"prompt": systems[0] + [1, 2], "max_new_tokens": 6,
               "temperature": 0.8, "seed": 3}
        warm = ms.generate(dict(hit))
        assert warm["prefix_source"] == "local_spilled"
        assert warm["prefix_hit_len"] == SYS_LEN
        assert warm["new_tokens"] == cold.generate(dict(hit))["new_tokens"]
        info = ms.info()
        assert info["kv_rematerialize_hits_total"] >= 1
        assert info["kv_promotions_total"] >= 1
        text = ms.metrics_text()
        assert "ptpu_serving_kv_host_spills_total " in text
        # The crash-recovery hook keeps host entries, drops device ones.
        with ms._prefix_lock:
            n_host = sum(type(p).__name__ == "_SpilledPrefix"
                         for _t, p in ms._prefix.entries())
        ms._on_engine_recovery()
        with ms._prefix_lock:
            kinds = {type(p).__name__ for _t, p in ms._prefix.entries()}
        assert len(ms._prefix) == n_host and kinds <= {"_SpilledPrefix"}
    finally:
        ms.close()
        cold.close()


# -- names match the reference ---------------------------------------------


def _families(text):
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


def test_metrics_families_and_stats_match_reference(models, fleet):
    """A paged server with the host tier renders the reference's
    ``/metrics`` families for the spill tier and the wire lanes, and the
    router's stats keys and families are the reference's."""
    def fleet_keys(names):
        return {k for k in names if k == "role" or "kv_host" in k
                or "prefix_" in k or "rematerialize" in k
                or "promotions" in k}

    jms = _j_factory(models, prefix_fetch=True)()
    try:
        want = fleet_keys(_families(jms.metrics_text()))
        want_info = fleet_keys(jms.info())
    finally:
        jms.engine.close()
    got = _families(_get(fleet[3][0].url, "/metrics"))
    assert want and want <= got, sorted(want - got)
    got_info = _get(fleet[3][0].url, "/info")
    assert want_info and want_info <= set(got_info), \
        sorted(want_info - set(got_info))
    ours = ReplicaRouter([Replica("http://127.0.0.1:1", "a")],
                         autostart=False)
    theirs = JRouter([JReplica("http://127.0.0.1:1", "a")],
                     autostart=False)
    try:
        assert set(ours.stats()) == set(theirs.stats())
        assert _families(ours.metrics_text()) \
            == _families(theirs.metrics_text())
    finally:
        ours.close()
        theirs.close()
    base = fleet[0]
    text = _get(base, "/fleet/metrics")
    for fam in ("ptpu_router_kv_fleet_wire_fetches_total",
                "ptpu_router_kv_fleet_handoffs_total",
                "ptpu_router_disagg_prefills_total"):
        assert f"# TYPE {fam} counter" in text, fam
    resp = _post(base, {"prompt": [1, 2, 3], "max_new_tokens": 2})
    rec = _get(base, f"/fleet/requests/{resp['request_id']}")
    assert rec["request_id"] == resp["request_id"] and rec["timeline"]


def _params(cmd):
    return {p.name: (p.opts, p.default) for p in cmd.params}


def test_cli_flags_match_reference():
    """``route`` has every option of the reference's, name for name and
    default for default; ``serve``'s spill, fetch, role, batching and
    profiling flags are served with the reference's defaults (no longer
    refused), and so is ``--mesh`` (the serving mesh)."""
    from click.testing import CliRunner

    from polyaxon_tpu.cli import main as jcli
    from polyaxon_tpu_torch.cli import main as tcli

    assert _params(tcli.route) == _params(jcli.route)
    flags = ("kv_host_spill_bytes", "prefix_fetch", "prefix_fetch_timeout",
             "prefix_fetch_min_tokens", "prefix_fetch_remat_ratio", "role",
             "batching", "trace_file", "profile_dir", "profile_every",
             "profile_steps")
    ours, theirs = _params(tcli.serve), _params(jcli.serve)
    for f in flags + ("mesh_arg",):
        assert ours[f] == theirs[f], f
    # Nothing of the reference's serve is refused any more.
    assert not hasattr(tcli, "_SERVE_NOT_PORTED")
    runner = CliRunner()
    for args, words in (
            (["--role", "prefill"], "--kv-paged"),
            (["--role", "decode"], "--prefix-fetch"),
            (["--prefix-fetch"], "--kv-host-spill-bytes"),
            (["--kv-host-spill-bytes", "64"], "--kv-paged"),
            (["--batching", "coalesce", "--kv-paged"],
             "--batching continuous")):
        res = runner.invoke(tcli.cli, ["serve", "--cpu", "--model",
                                       "gpt2-tiny", *args])
        assert res.exit_code != 0 and words in res.output, (args,
                                                            res.output)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_disaggregated_fleet_over_http():
    """``serve --cpu --role prefill`` + two ``--role decode`` replicas
    and ``route`` as processes: a long prompt goes through the wire
    lane and equals the monolithic ``generate``'s tokens.

    The decode replica's cost gate fetches only while the router's
    measured RTT to the holder stays under ``(1 - remat_ratio)`` of the
    prompt's estimated re-prefill (``n / 4000`` s).  A 40-token prompt
    at the default ratio put that bound at 7.4 ms against ~2-5 ms
    probes on an idle box, so a loaded one vetoed the fetch
    (``wire_slower``, a re-prefill).  A 120-token prompt at ratio 0
    puts it at 30 ms."""
    ports = [_free_port() for _ in range(4)]
    common = ["--cpu", "--model", "gpt2-tiny", "--kv-paged",
              "--kv-page-tokens", "16", "--kv-host-spill-bytes",
              str(1 << 24), "--n-slots", "2"]
    cmds = [["serve", *common, "--port", str(ports[0]), "--role",
             "prefill"]]
    cmds += [["serve", *common, "--port", str(p), "--role", "decode",
              "--prefix-fetch", "--prefix-fetch-min-tokens", "1",
              "--prefix-fetch-remat-ratio", "0"]
             for p in ports[1:3]]
    cmds.append(["route", "--port", str(ports[3]), "--probe-interval",
                 "0.1", *sum((["--replica", f"127.0.0.1:{p}"]
                              for p in ports[:3]), [])])
    env = {**os.environ, "OMP_NUM_THREADS": "2", "PYTHONPATH": ROOT}
    procs = [subprocess.Popen([sys.executable, "-m",
                               "polyaxon_tpu_torch.cli", *c], cwd=ROOT,
                              env=env, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE) for c in cmds]
    base = f"http://127.0.0.1:{ports[3]}"
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                st = _get(base, "/info")
                roles = sorted(r["role"] for r in st["replicas"])
                if roles == ["decode", "decode", "prefill"] \
                        and all(r["up"] for r in st["replicas"]):
                    break
            except (OSError, ValueError, KeyError):
                pass
            assert time.monotonic() < deadline and all(
                p.poll() is None for p in procs), [
                    p.stderr.read().decode()[-2000:] for p in procs
                    if p.poll() is not None]
            time.sleep(0.2)
        prompt = list(range(1, 121))
        resp = _post(base, {"prompt": prompt, "max_new_tokens": 6})
        assert resp["prefix_source"] == "wire_fetch", (
            resp["prefix_source"], _get(base, "/info")["replicas"],
            [_get(f"http://127.0.0.1:{p}", "/info").get(
                "prefix_fetch_failed") for p in ports[1:3]])
        out = subprocess.run(
            [sys.executable, "-m", "polyaxon_tpu_torch.cli", "generate",
             "--cpu", "--model", "gpt2-tiny", "--prompt",
             ",".join(map(str, prompt)), "--max-new-tokens", "6"],
            cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=120)
        assert json.loads(out.stdout.strip().splitlines()[-1])[
            "new_tokens"] == resp["new_tokens"]
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()


def test_device_syncs_wait_for_captures(monkeypatch):
    """Several servers' engines in one process: a device-wide
    synchronize (a handler's or an engine's ``_sync``) must never land
    inside another engine's CUDA-graph capture, which it would
    invalidate; it takes the lock every capture holds.  (The card showed
    the fault; here the lock is checked around a stand-in synchronize.)"""
    from polyaxon_tpu_torch.serving import slots

    held = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: held.append(
                            slots._CAPTURE_LOCK.locked()))
    slots.sync_device(torch.device("cpu"))
    assert held == []
    slots.sync_device(torch.device("cuda", 0))
    assert held == [True] and not slots._CAPTURE_LOCK.locked()
