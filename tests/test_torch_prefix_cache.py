"""The radix prefix cache in the port (``serving/radix.py``, the paged
pool's shared-prefix paths, the engine's prefix seeding, the server's
store and ``POST /prefill``), against the reference on gpt2-tiny and
llama-tiny with converted weights, float32.

- The same seeded traffic (a registered system prompt, greedy and
  sampled requests extending it, an exact repeat that hits its own
  store-back, a 2-row request on the solo hit path) through the
  reference's ``ModelServer`` and the port's, on both pools: equal
  tokens and equal hit counters, and equal to the port with the cache
  off.
- COPY-ON-WRITE: N hits of one stored prefix map its full pages
  read-only (refcount N+1 while resident), decode without changing
  their bytes, and match the reference's cold decode.
- Stored-but-idle prefixes yield their pages to live traffic; the
  radix index keys multi-row prompts by columns.
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
from click.testing import CliRunner

from polyaxon_tpu.models import generate as JG
from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu.serving import ModelServer as JServer
from polyaxon_tpu.serving.radix import RadixPrefixIndex as JRadix
from polyaxon_tpu_torch.cli import main as cli_main
from polyaxon_tpu_torch.convert import (gpt2_state_dict_from_jax,
                                        llama_state_dict_from_jax)
from polyaxon_tpu_torch.models import generate as TG
from polyaxon_tpu_torch.models.kv_cache import kv_cache_dims
from polyaxon_tpu_torch.models.registry import get_model
from polyaxon_tpu_torch.serving import (DecodeEngine, ModelServer,
                                        SchedulerPolicy, make_server)
from polyaxon_tpu_torch.serving import server as server_mod
from polyaxon_tpu_torch.serving.radix import RadixPrefixIndex

torch.set_num_threads(2)

MODELS = ("gpt2-tiny", "llama-tiny")
SAMP = dict(temperature=0.8, top_k=50, top_p=0.95)


def _pair(name):
    jmodel = j_get_model(name).make_model(dtype=jnp.float32)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    tmodel = get_model(name).make_model(device="cpu", dtype=torch.float32)
    conv = llama_state_dict_from_jax if name.startswith("llama") \
        else gpt2_state_dict_from_jax
    tmodel.load_state_dict(conv(jax.tree.map(np.asarray,
                                             variables["params"]),
                                tmodel.cfg))
    return jmodel, variables, tmodel.eval().requires_grad_(False)


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    return (request.param,) + _pair(request.param)


@pytest.fixture(scope="module")
def gpt2():
    return ("gpt2-tiny",) + _pair("gpt2-tiny")


def _toks(seed, n, vocab=512):
    return np.random.RandomState(seed).randint(1, vocab, n).tolist()


def _solo(jmodel, variables, rows, new, samp=None):
    p = jnp.asarray(rows, jnp.int32)
    if samp is None:
        out = JG.generate(jmodel, variables, p, max_new_tokens=new)
    else:
        out = JG.generate_positional(jmodel, variables, p,
                                     max_new_tokens=new, **samp)
    return np.asarray(out).tolist()


# -- the radix index is the reference's --------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_radix_copy_matches_reference(seed):
    """A seeded mix of stores (hot and cold), lookups, ancestor walks,
    payload swaps, removals and LRU pops gives the same answers from
    the port's copy of the index as from the reference's."""
    rng = np.random.RandomState(seed)
    ours, theirs = RadixPrefixIndex(4), JRadix(4)
    seen = []
    for step in range(120):
        b = 1 + (rng.rand() < 0.2)
        toks = rng.randint(0, 4, (b, rng.randint(1, 7))).astype(np.int32)
        if seen and rng.rand() < 0.5:       # extend a stored prompt
            base = seen[rng.randint(len(seen))]
            if base.shape[0] == b:
                toks = np.concatenate([base, toks], axis=1)
        op = rng.randint(6)
        if op == 0:
            hot = bool(rng.rand() < 0.7)
            got = [ix.store(toks, f"p{step}", hot=hot)
                   for ix in (ours, theirs)]
            seen.append(toks)
        elif op == 1:
            got = [ix.lookup(toks) for ix in (ours, theirs)]
        elif op == 2:
            got = [ix.longest_ancestor(toks) for ix in (ours, theirs)]
        elif op == 3 and seen:
            old = seen[rng.randint(len(seen))]
            got = [ix.set_payload(old, f"s{step}") for ix in (ours, theirs)]
        elif op == 4 and seen:
            old = seen[rng.randint(len(seen))]
            got = [ix.remove(old) for ix in (ours, theirs)]
        else:
            got = [ix.pop_lru() for ix in (ours, theirs)]

        def norm(x):
            if isinstance(x, tuple) and x and isinstance(x[0], np.ndarray):
                return (x[0].tolist(), x[1])
            if isinstance(x, list):
                return [norm(e) for e in x]
            return x

        assert norm(got[0]) == norm(got[1]), (step, op)
        assert len(ours) == len(theirs)
    assert [e[1] for e in ours.entries()] == \
        [e[1] for e in theirs.entries()]


def test_multi_row_prompts_radix_by_columns():
    ix = RadixPrefixIndex(8)
    m = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
    ix.store(m, "MR")
    hit = ix.lookup(np.asarray([[1, 2, 3, 9], [4, 5, 6, 9]], np.int32))
    assert hit is not None and hit[1] == "MR"
    assert ix.lookup(np.asarray([[1, 2, 3, 9], [4, 5, 0, 9]],
                                np.int32)) is None
    assert ix.lookup(np.asarray([[1, 2, 3, 9]], np.int32)) is None


# -- the paged pool's prefix paths -------------------------------------------


def test_materialize_is_the_stored_prefill(pair):
    """A prefill scattered into pool pages and materialized back is
    the contiguous cache it came from: [L, 1, max_position, H_kv, D]
    in the pool's dtype (a RoPE model's keys already rotated), index at
    the prefix length — and extending it gives the logits of the
    one-shot prefill of the longer prompt."""
    name, _, _, tmodel = pair
    eng = DecodeEngine(tmodel, autostart=False, policy=SchedulerPolicy(
        n_slots=2, kv_paged=True, kv_page_tokens=8))
    mgr = eng.slots
    sys_toks = torch.tensor([_toks(1, 20)])
    logits, cache = TG.prefill(tmodel, sys_toks)
    ids = mgr.try_reserve(mgr.pages_needed(20))
    mgr.scatter_cache(cache, ids)
    got = mgr.materialize(ids, 20)
    cfg = tmodel.cfg
    assert tuple(got.k.shape) == (cfg.num_layers, 1, cfg.max_position,
                                  *kv_cache_dims(cfg))
    assert got.k.dtype == cache.k.dtype and got.index == 20
    assert torch.equal(got.k, cache.k) and torch.equal(got.v, cache.v)
    suffix = torch.tensor([_toks(2, 5)])
    ext, _ = TG.prefill(tmodel, suffix, cache=got, position=20)
    full, _ = TG.prefill(tmodel, torch.cat([sys_toks, suffix], 1))
    torch.testing.assert_close(ext, full, rtol=1e-5, atol=1e-5)
    mgr.unpin(ids)
    assert mgr.free_page_count() == mgr.n_pages


@pytest.mark.parametrize("n_hits", [2, 3])
def test_shared_prefix_pages_map_copy_on_write(pair, n_hits, monkeypatch):
    """N streams seeded from one stored prefix SHARE its full pages
    read-only: refcount N+1 while resident (the entry's reference plus
    one per slot), no insert or step scatter ever targets them (their
    slices go to the trash page), their bytes are unchanged after the
    streams decoded, and each stream matches the reference's cold
    decode."""
    from polyaxon_tpu_torch.serving import paged as paged_mod

    name, jmodel, variables, tmodel = pair
    written = set()
    real_scatter = paged_mod.scatter_pages

    def recording_scatter(pool, pages, targets, axis):
        written.update(int(t) for t in targets.reshape(-1).tolist())
        real_scatter(pool, pages, targets, axis)

    monkeypatch.setattr(paged_mod, "scatter_pages", recording_scatter)
    eng = DecodeEngine(tmodel, autostart=False, policy=SchedulerPolicy(
        n_slots=4, decode_window=4, kv_paged=True, kv_page_tokens=8))
    mgr = eng.slots
    sys_toks = [_toks(3, 20)]
    queries = [sys_toks[0] + _toks(10 + i, 2 + i) for i in range(n_hits)]
    logits, cache = TG.prefill(tmodel, torch.tensor(sys_toks))
    n = mgr.pages_needed(20)                    # 3 pages of 8
    ids = mgr.try_reserve(n)
    mgr.scatter_cache(cache, ids)
    full = ids[:20 // mgr.page_tokens]          # 2 full pages
    written.clear()
    groups = []
    for q in queries:
        mgr.pin(full)
        groups.append(eng.submit(
            np.asarray([q]), 10, None, None,
            prefix=(20, logits, mgr.materialize(ids, 20)),
            shared_pages=tuple(full)))
    before = [(mgr._k[:, p].clone(), mgr._v[:, p].clone()) for p in full]
    while mgr.active_slots < n_hits:
        eng.tick()
    assert [int(mgr.refcounts[p]) for p in full] == [n_hits + 1] * 2
    assert mgr.page_stats()["kv_pages_shared"] == len(full)
    for slot in eng._resident:
        assert list(mgr.write_tables[slot, :2]) == [mgr.trash] * 2
        assert list(mgr.page_tables[slot, :2]) == full
    eng.run_until_idle()
    assert written and not written & set(full)
    assert mgr.trash in written
    for (k, v), p in zip(before, full):
        assert torch.equal(mgr._k[:, p], k) and torch.equal(mgr._v[:, p], v)
    for q, g in zip(queries, groups):
        assert g.result().tolist() == _solo(jmodel, variables, [q], 10)
    assert mgr.free_page_count() == mgr.n_pages - n
    mgr.unpin(ids)
    assert mgr.free_page_count() == mgr.n_pages


def test_clamped_dirty_window_never_writes_shared_pages(gpt2,
                                                        monkeypatch):
    """Full-length hits of a 24-token prefix (3 full pages) with 3 new
    tokens: the step's pad class is 4 pages, so its 2-page dirty window
    clamps back onto the last SHARED page — the write table sends that
    slice to the trash page, never to the shared page."""
    from polyaxon_tpu_torch.serving import paged as paged_mod

    name, jmodel, variables, tmodel = gpt2
    written = set()
    real_scatter = paged_mod.scatter_pages

    def recording_scatter(pool, pages, targets, axis):
        written.update(int(t) for t in targets.reshape(-1).tolist())
        real_scatter(pool, pages, targets, axis)

    monkeypatch.setattr(paged_mod, "scatter_pages", recording_scatter)
    eng = DecodeEngine(tmodel, autostart=False, policy=SchedulerPolicy(
        n_slots=2, decode_window=2, kv_paged=True, kv_page_tokens=8))
    mgr = eng.slots
    sys_toks = [_toks(4, 24)]
    logits, cache = TG.prefill(tmodel, torch.tensor(sys_toks))
    ids = mgr.try_reserve(3)
    mgr.scatter_cache(cache, ids)
    written.clear()
    groups = []
    for _ in range(2):
        mgr.pin(ids)
        groups.append(eng.submit(
            np.asarray(sys_toks), 3, None, None,
            prefix=(24, logits, mgr.materialize(ids, 24)),
            shared_pages=tuple(ids)))
    starts = []
    real_start = mgr._dirty_start

    def recording_start(P, n_dirty):
        d0 = real_start(P, n_dirty)
        starts.append((P, int(mgr.positions.max()) // 8, int(d0.max())))
        return d0

    mgr._dirty_start = recording_start
    eng.run_until_idle()
    # Position 24 is page 3, the window clamped to start at page 2.
    assert (4, 3, 2) in starts
    assert written and not written & set(ids)
    want = _solo(jmodel, variables, sys_toks, 3)
    assert [g.result().tolist() for g in groups] == [want, want]
    mgr.unpin(ids)
    assert mgr.free_page_count() == mgr.n_pages


# -- the server against the reference's ------------------------------------


def _traffic(name):
    """(path, body) requests: register a system prompt (1 and 2 rows),
    then greedy and sampled extensions, an exact repeat of one (a
    full-length hit on its store-back), a 2-row hit and a miss."""
    sys_p = _toks(5, 21)
    reqs = [("/prefill", {"prompt": sys_p}),
            ("/prefill", {"prompt": [sys_p, sys_p]})]
    for i in range(4):
        body = {"prompt": sys_p + _toks(20 + i, 3 + 2 * i),
                "max_new_tokens": 9}
        if i % 2:
            body.update(SAMP, seed=i)
        reqs.append(("/generate", body))
    reqs.append(("/generate", dict(reqs[3][1])))
    reqs.append(("/generate", {"prompt": [sys_p + [7, 8],
                                          sys_p + [9, 10]],
                               "max_new_tokens": 6, "seed": 5,
                               **SAMP}))
    reqs.append(("/generate", {"prompt": _toks(40, 6),
                               "max_new_tokens": 5}))
    return reqs


def _drive(ms, reqs):
    out = []
    for path, body in reqs:
        r = ms.prefill_prompt(dict(body)) if path == "/prefill" \
            else ms.generate(dict(body))
        out.append(r.get("tokens", r.get("cached_len")))
    info = ms.info()
    return out, {k: info[k] for k in ("prefix_hits", "prefix_hit_tokens",
                                      "prefix_entries")}


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_server_hits_equal_reference_server(pair, paged):
    """The same traffic through the reference's server and the port's
    (prefix_cache=4, 4 slots): equal tokens and hit counters; and the
    port with the cache off gives the same tokens."""
    name, jmodel, variables, tmodel = pair
    kw = dict(n_slots=4, max_batch=4, kv_paged=paged, kv_page_tokens=8)
    reqs = _traffic(name)
    runs = []
    for ms in (JServer(jmodel, variables, model_name=name, **kw),
               ModelServer(tmodel, model_name=name, **kw),
               ModelServer(tmodel, model_name=name, prefix_cache=0,
                           **kw)):
        try:
            if ms.prefix_cache_size:
                runs.append(_drive(ms, reqs))
            else:
                runs.append(_drive(ms, [r for r in reqs
                                        if r[0] == "/generate"]))
        finally:
            ms.close()
    (jtoks, jstats), (ttoks, tstats), (cold, _) = runs
    assert ttoks == jtoks
    assert tstats == jstats
    assert tstats["prefix_hits"] == 6
    assert [t for t in ttoks if isinstance(t, list)] == cold


def test_prefix_entries_yield_to_live_traffic(gpt2):
    """Page-pressure reclaim: stored entries holding most of a small
    pool are LRU-evicted when a live request needs their pages (the
    reference's behaviour, and its tokens)."""
    name, jmodel, variables, tmodel = gpt2
    kw = dict(n_slots=2, kv_paged=True, kv_page_tokens=8, kv_pages=6)
    got = []
    for ms in (JServer(jmodel, variables, model_name=name, **kw),
               ModelServer(tmodel, model_name=name, **kw)):
        try:
            ms.prefill_prompt({"prompt": list(range(1, 16))})
            ms.prefill_prompt({"prompt": list(range(20, 35))})
            assert ms.engine.slots.free_page_count() == 2
            r = ms.generate({"prompt": list(range(40, 48)),
                             "max_new_tokens": 30})
            got.append((r["tokens"], len(ms._prefix)))
        finally:
            ms.close()
    assert got[1] == got[0]
    assert got[1][1] < 2


def test_page_alloc_fault_on_a_hit_releases_its_pins(gpt2):
    """An injected page-allocation failure on a prefix hit's admission
    requeues the stream through the resume path and releases the pins
    it carried: the tokens are the cold ones and, once idle, only the
    store's own references remain."""
    name, jmodel, variables, tmodel = gpt2
    ms = ModelServer(tmodel, model_name=name, n_slots=2, kv_paged=True,
                     kv_page_tokens=8, fault_plan={"seed": 0, "faults": [
                         {"site": "page_alloc", "times": 1}]})
    sys_p = _toks(7, 17)
    try:
        ms.prefill_prompt({"prompt": sys_p})
        held = ms.engine.slots.n_pages - ms.engine.slots.free_page_count()
        r = ms.generate({"prompt": sys_p + [3, 4], "max_new_tokens": 7})
        assert r["tokens"] == _solo(jmodel, variables, [sys_p + [3, 4]], 7)
        assert ms.engine.stats()["requests_requeued_total"] == 1
        mgr = ms.engine.slots
        assert held == mgr.pages_needed(17)
        # Idle: every page reference left is a stored entry's own.
        assert int(mgr.refcounts[:mgr.n_pages].sum()) == sum(
            len(p.pages) for _, p in ms._prefix.entries())
    finally:
        ms.close()


# -- HTTP and the CLI ---------------------------------------------------------


def _start(ms):
    srv = make_server("127.0.0.1", 0, ms)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _post(base, payload, path="/generate", expect=200):
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


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_prefill_route_over_http(gpt2, paged):
    """POST /prefill registers a prefix (200, not 501) and a later
    /generate hits it; /info and /metrics count the hit."""
    name, jmodel, variables, tmodel = gpt2
    ms = ModelServer(tmodel, model_name=name, n_slots=2, kv_paged=paged,
                     kv_page_tokens=8)
    srv, base = _start(ms)
    sys_p = _toks(9, 16)
    try:
        out = _post(base, {"prompt": sys_p}, path="/prefill")
        assert out == {"cached_rows": 1, "cached_len": 16, "entries": 1,
                       "request_id": out["request_id"]}
        r = _post(base, {"prompt": sys_p + [5, 6], "max_new_tokens": 6,
                         "seed": 2, **SAMP})
        assert r["prefix_hit_len"] == 16
        assert r["prefix_source"] == "local_hot"
        assert r["tokens"] == _solo(jmodel, variables, [sys_p + [5, 6]],
                                    6, dict(SAMP, seed=2))
        with urllib.request.urlopen(base + "/metrics", timeout=30) as resp:
            text = resp.read().decode()
        assert "ptpu_serving_prefix_hits_total 1" in text
        assert "ptpu_serving_prefix_hit_tokens_total 16" in text
        _post(base, {"prompt": [True]}, path="/prefill", expect=400)
    finally:
        srv.shutdown()
        srv.server_close()
        ms.close()


def test_prefill_is_400_with_the_cache_off(gpt2):
    ms = ModelServer(gpt2[3], model_name="tiny", prefix_cache=0)
    try:
        with pytest.raises(ValueError, match="prefix cache is disabled"):
            ms.prefill_prompt({"prompt": [1, 2, 3]})
        r = ms.generate({"prompt": [1, 2, 3], "max_new_tokens": 2})
        assert "prefix_source" not in r
    finally:
        ms.close()


def test_serve_cli_prefix_cache(monkeypatch):
    """``serve --cpu --prefix-cache 4``: /prefill then a /generate that
    hits it, through the real handler."""
    seen = {}
    real = server_mod._ServingHTTPServer.serve_forever

    def serve_once(self):
        t = threading.Thread(target=real, args=(self,), daemon=True)
        t.start()
        base = f"http://127.0.0.1:{self.server_address[1]}"
        seen["prefill"] = _post(base, {"prompt": [4, 5, 6, 7]},
                                path="/prefill")
        seen["gen"] = _post(base, {"prompt": [4, 5, 6, 7, 8],
                                   "max_new_tokens": 4})
        self.shutdown()
        t.join(timeout=30)

    monkeypatch.setattr(server_mod._ServingHTTPServer, "serve_forever",
                        serve_once)
    out = CliRunner().invoke(cli_main.cli, [
        "serve", "--model", "gpt2-tiny", "--cpu", "--port", "0",
        "--prefix-cache", "4", "--kv-paged", "--kv-page-tokens", "8"])
    assert out.exit_code == 0, out.output
    assert seen["prefill"]["cached_len"] == 4
    assert seen["gen"]["prefix_hit_len"] == 4
    model = get_model("gpt2-tiny").init_params(seed=0, device="cpu")
    assert seen["gen"]["tokens"] == TG.generate(
        model, np.asarray([[4, 5, 6, 7, 8]]), max_new_tokens=4).tolist()


def test_default_server_keeps_a_prefix_cache_and_a_supervisor(gpt2):
    ms = ModelServer(gpt2[3])
    try:
        assert ms.prefix_cache_size == 4 and ms._prefix_enabled
        assert ms.supervisor is not None
        assert ms.engine.supervisor is ms.supervisor
        assert ms.info()["breaker_state"] == "closed"
    finally:
        ms.close()
