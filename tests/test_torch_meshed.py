"""The port's serving mesh (``polyaxon_tpu_torch/serving/meshed.py``)
against the reference's (``tests/test_meshed_engine.py``).

The defining contract, in test form: a ``tp=N`` engine is
TOKEN-BITWISE-IDENTICAL to the unmeshed engine — and to unmeshed solo
generation — per seed, for plain, sampled and speculative streams,
under co-tenancy and slot starvation, per mesh shape.  The port runs
its meshes on VIRTUAL devices (``["cpu"] * n``: one CPU named n times,
the counterpart of the conftest's 8 virtual host devices), float32,
two threads.  Every case of the reference's module has its case here,
at its sizes; then the port's meshed engine is held against the
reference's meshed engine on the same flax weights (converted by
``convert.*_state_dict_from_jax``), and the extra cases: Llama's GQA
split, the int8 cache and the ring, a meshed pool's spilled blob
byte-equal to an unmeshed pool's, the reference's refusal texts, and
the CLI.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models.gpt2 import GPT2Config as JGPT2Config
from polyaxon_tpu.models.gpt2 import GPT2Model as JGPT2Model
from polyaxon_tpu.serving import DecodeEngine as JEngine
from polyaxon_tpu.serving import SchedulerPolicy as JPolicy
from polyaxon_tpu.serving import meshed as jmeshed
from polyaxon_tpu.serving.scheduler import SamplingSpec as JSpec
from polyaxon_tpu_torch.convert import (gpt2_state_dict_from_jax,
                                        llama_state_dict_from_jax,
                                        moe_gpt_state_dict_from_jax)
from polyaxon_tpu_torch.models import generate as TG
from polyaxon_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from polyaxon_tpu_torch.models.kv_cache import ShardedKVCache
from polyaxon_tpu_torch.models.registry import get_model
from polyaxon_tpu_torch.serving import (DecodeEngine, MeshError,
                                        ModelServer, SamplingSpec,
                                        SchedulerPolicy, ServingMesh,
                                        parse_mesh)
from polyaxon_tpu_torch.serving.paged import (PagedSlotKVManager,
                                              pack_spilled)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = np.asarray([[3, 1, 4, 1]], np.int64)
P2 = np.asarray([[2, 7, 1, 8]], np.int64)
P3 = np.asarray([[5, 6, 7, 8]], np.int64)
SAMP = dict(seed=7, temperature=1.0, top_k=8)
SPEC = dict(seed=7, temperature=0.9, top_k=16, spec_k=3)


def _mesh(spec, n=8):
    """A serving mesh over ``n`` virtual CPU devices."""
    return ServingMesh(spec, devices=["cpu"] * n)


def _gpt2_pair(seed, **over):
    """(flax model, flax variables, port model): the reference test's
    small GPT-2 (4 heads, so tp 1/2/4 all divide), float32."""
    over = {"num_heads": 4, **over}
    cfg = dataclasses.replace(
        JGPT2Config.tiny(), vocab_size=32, hidden_size=32, num_layers=2,
        max_position=64, dtype=jnp.float32, **over)
    jmodel = JGPT2Model(cfg=cfg)
    variables = jmodel.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, 4), jnp.int32))
    tcfg = GPT2Config(vocab_size=32, hidden_size=32, num_layers=2,
                      num_heads=cfg.num_heads, max_position=64,
                      dtype=torch.float32)
    tmodel = GPT2Model(tcfg, device="cpu")
    tmodel.load_state_dict(gpt2_state_dict_from_jax(
        jax.tree.map(np.asarray, variables["params"]), tcfg), strict=True)
    return jmodel, variables, tmodel.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def small():
    return _gpt2_pair(0)


@pytest.fixture(scope="module")
def draft():
    return _gpt2_pair(99)


@pytest.fixture(scope="module")
def small_model(small):
    return small[2]


@pytest.fixture(scope="module")
def refs(small_model, draft):
    """UNMESHED solo references — the oracle every meshed engine run
    must equal bitwise."""
    m, d = small_model, draft[2]
    return {
        "plain": TG.generate(m, PROMPT, max_new_tokens=12).tolist(),
        "sampled": TG.generate_positional(
            m, PROMPT, max_new_tokens=12, **SAMP).tolist(),
        "spec": TG.generate_speculative(
            m, d, PROMPT, max_new_tokens=12, k=3, seed=7,
            temperature=0.9, top_k=16).tolist(),
    }


def _engine(model, dmodel=None, *, mesh, paged=False, **policy):
    kw = dict(n_slots=4, decode_window=8)
    if paged:
        kw.update(kv_paged=True, kv_page_tokens=8)
    kw.update(policy)
    return DecodeEngine(model, autostart=False,
                        policy=SchedulerPolicy(**kw),
                        mesh=None if mesh is None else _mesh(mesh),
                        draft_model=dmodel)


def _submit_all(eng, spec_cls=SamplingSpec):
    return {
        "plain": eng.submit(PROMPT, 12, None, None),
        "sampled": eng.submit(PROMPT, 12, None, None,
                              sampling=spec_cls(**SAMP)),
        "spec": eng.submit(PROMPT, 12, None, None,
                           sampling=spec_cls(**SPEC)),
    }


# -- determinism matrix: tp shape x mode x co-tenancy schedule -------------


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_matrix_meshed_equals_unmeshed_solo(tp, small_model, draft,
                                            refs):
    """Per mesh shape, plain/sampled/spec streams equal the UNMESHED
    solo references bitwise under three co-tenancy schedules: alone,
    admitted beside running co-tenants, and slot-starved."""
    model, mesh = small_model, f"tp={tp}"
    eng = _engine(model, draft[2], mesh=mesh)
    groups = _submit_all(eng)
    eng.run_until_idle()
    for kind, g in groups.items():
        assert g.result().tolist() == refs[kind], (tp, "alone", kind)

    eng = _engine(model, draft[2], mesh=mesh, n_slots=6)
    a = eng.submit(P2, 16, None, None)
    b = eng.submit(P3, 16, None, None,
                   sampling=SamplingSpec(seed=3, temperature=1.0))
    for _ in range(3):
        eng.tick()
    groups = _submit_all(eng)
    eng.run_until_idle()
    for kind, g in groups.items():
        assert g.result().tolist() == refs[kind], (tp, "cotenant", kind)
    assert a.result().tolist() == TG.generate(
        model, P2, max_new_tokens=16).tolist()
    assert b.result().tolist() == TG.generate_positional(
        model, P3, max_new_tokens=16, seed=3, temperature=1.0).tolist()

    eng = _engine(model, draft[2], mesh=mesh, n_slots=2)
    others = [eng.submit(np.asarray([[i, i + 1, 2, 3]]), 4 + i, None,
                         None) for i in range(2)]
    groups = _submit_all(eng)
    eng.run_until_idle()
    for kind, g in groups.items():
        assert g.result().tolist() == refs[kind], (tp, "starved", kind)
    assert all(o.error is None for o in others)


def test_meshed_engine_equals_unmeshed_engine(small_model):
    """Engine-vs-engine: one mixed co-tenancy run, identical responses
    meshed and unmeshed — the mesh changes placement, never tokens."""
    results = []
    for mesh in (None, "tp=2"):
        eng = _engine(small_model, mesh=mesh)
        groups = [
            eng.submit(PROMPT, 12, None, None),
            eng.submit(P3, 10, None, None,
                       sampling=SamplingSpec(seed=3, temperature=1.0)),
            eng.submit(np.asarray([[9, 8, 7, 6]]), 6, None, None),
        ]
        eng.run_until_idle()
        results.append([g.result().tolist() for g in groups])
    assert results[0] == results[1]


def test_kv_pool_actually_sharded(small_model):
    """The stacked KV pool really is split over tp (each shard holds
    heads/tp on its own device), and so are the column-parallel
    weights; both stay so after stepping."""
    eng = _engine(small_model, mesh="tp=4")
    g = eng.submit(PROMPT, 8, None, None)
    eng.run_until_idle()
    assert g.error is None
    pool = eng.slots._pool
    assert isinstance(pool, ShardedKVCache) and len(pool.shards) == 4
    for shard in pool.shards:
        assert [tuple(t.shape) for t in shard.leaves()] == \
            [(2, 4, 64, 1, 8)] * 2                # heads 4 / tp 4
    assert pool.devices == eng.mesh.devices[:4]
    sh = eng.model.groups[0].shards_of(eng.model.replicas[0].h[0])
    qkv = sh["qkv"]
    assert len(qkv.weights) == 4
    assert [tuple(w.value.shape) for w in qkv.weights] == [(24, 32)] * 4
    full = small_model.h[0].qkv.weight
    # Shard 1 holds the q, k and v rows of head 1 (the by-heads split).
    want = torch.cat([full[8:16], full[40:48], full[72:80]])
    assert torch.equal(qkv.weights[1].value, want)
    assert sh["fc1"] is not None and len(sh["fc1"].weights) == 4


def _weight_bytes(model, shardings, axis=None):
    """Bytes of ``model``'s weights that ``shardings`` splits over
    ``axis`` (None: those it keeps whole)."""
    named = dict(model.named_parameters())
    named.update(model.named_buffers())

    def on(n):
        if axis is None:
            return not shardings[n].dims
        return shardings[n].axis(axis) is not None

    return sum(t.numel() * t.element_size() for n, t in named.items()
               if on(n))


@pytest.mark.parametrize("kind,spec", [
    ("gpt2", "tp=2"), ("gpt2", "tp=4"), ("gpt2", "dp=2,tp=2"),
    ("moe", "tp=2,ep=2")])
def test_each_device_holds_only_its_weight_shards(kind, spec, small_model,
                                                  moe):
    """No device keeps a whole copy of a weight the mesh splits: the
    first device of each slot group holds the whole weights and its
    1/tp (1/ep) of the split ones, every other device only its shards."""
    model = small_model if kind == "gpt2" else moe[2]
    mesh = _mesh(spec)
    placed = mesh.place_params(model)
    sh = mesh.param_shardings(model)
    whole = _weight_bytes(model, sh)
    col, exp = _weight_bytes(model, sh, "tp"), _weight_bytes(model, sh, "ep")
    assert col and (exp or kind == "gpt2")
    want = [(whole if e == 0 and t == 0 else 0)
            + (col // mesh.tp if e == 0 else 0)
            + (exp // mesh.ep if t == 0 else 0)
            for g in range(mesh.dp) for e in range(mesh.ep)
            for t in range(mesh.tp)]
    assert placed.device_bytes() == want
    assert sum(want) == mesh.dp * (whole + col + exp)
    # The replica's split weights are shapes only.
    block = placed.replicas[0].h[0]
    assert block.qkv.weight.is_meta and not block.o_proj.weight.is_meta


@pytest.mark.parametrize("owner", ["place_params", "engine", "server"])
def test_placed_model_frees_whole_split_weights(owner, refs):
    """Once its owner drops the model, the whole column-parallel weights
    are gone: nothing the mesh placed refers to them, and the placed
    model still decodes the unmeshed tokens."""
    import gc
    import weakref

    model = _gpt2_pair(0)[2]
    gone = [weakref.ref(model.h[0].qkv.weight),
            weakref.ref(model.h[1].fc1.weight)]
    kept = weakref.ref(model.h[0].o_proj.weight)
    if owner == "place_params":
        held = _mesh("tp=2").place_params(model)
    elif owner == "engine":
        held = _engine(model, mesh="tp=2")
    else:
        held = ModelServer(model, model_name="t", n_slots=4,
                           prefix_cache=0, mesh=_mesh("tp=2", 2))
    del model
    gc.collect()
    try:
        assert [r() for r in gone] == [None, None]
        assert kept() is not None
        if owner == "place_params":
            got = TG.generate(held, PROMPT, max_new_tokens=12).tolist()
        elif owner == "engine":
            g = held.submit(PROMPT, 12, None, None)
            held.run_until_idle()
            got = g.result().tolist()
        else:
            out = held.generate({"prompt": PROMPT[0].tolist(),
                                 "max_new_tokens": 12})
            got = [PROMPT[0].tolist() + out["new_tokens"][0]]
        assert got == refs["plain"]
    finally:
        if owner == "server":
            held.close()


def test_dp_slot_parallel(small_model, refs):
    """dp splits the SLOT axis of the fixed-lane pool: per-slot math is
    untouched, tokens stay bitwise."""
    eng = _engine(small_model, mesh="dp=2,tp=2")
    g = eng.submit(PROMPT, 12, None, None)
    s = eng.submit(PROMPT, 12, None, None, sampling=SamplingSpec(**SAMP))
    eng.run_until_idle()
    assert g.result().tolist() == refs["plain"]
    assert s.result().tolist() == refs["sampled"]
    pool = eng.slots._pool
    assert pool.dp == 2 and pool.rows == 2 and len(pool.shards) == 4


# -- paged on mesh ----------------------------------------------------------


def test_paged_on_mesh_equals_fixed_and_solo(small_model, refs):
    eng = _engine(small_model, mesh="tp=2", paged=True)
    g = eng.submit(PROMPT, 12, None, None)
    s = eng.submit(PROMPT, 12, None, None, sampling=SamplingSpec(**SAMP))
    eng.run_until_idle()
    assert g.result().tolist() == refs["plain"]
    assert s.result().tolist() == refs["sampled"]
    assert eng.slots.free_page_count() == eng.slots.n_pages
    pools = eng.slots._pools
    assert len(pools) == 4          # (k, v) x 2 head shards
    assert all(p.shape[-2] == 2 for p in pools)


def test_paged_on_mesh_freed_page_poison(small_model):
    """Page poison on a mesh: decoding in RECYCLED pages (freed by a
    finished co-tenant) matches the fresh-pool run bitwise — stale
    bytes in any shard of a freed page are dead."""
    p2 = np.asarray([[9, 8, 7, 6]])
    samp = SamplingSpec(seed=11, temperature=1.0)
    eng = _engine(small_model, mesh="tp=2", paged=True, kv_pages=6)
    g = eng.submit(p2, 12, None, None, sampling=samp)
    eng.run_until_idle()
    want = g.result().tolist()
    eng = _engine(small_model, mesh="tp=2", paged=True, kv_pages=6)
    a = eng.submit(PROMPT, 30, None, None)      # touches most pages
    eng.run_until_idle()
    assert a.error is None and eng.slots.free_page_count() == 6
    g = eng.submit(p2, 12, None, None, sampling=samp)
    eng.run_until_idle()
    assert g.result().tolist() == want


# -- recompiles -------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
def test_zero_steady_state_recompiles_per_mesh_shape(tp, small_model):
    """Warm-twice-then-flat per mesh shape: same-shaped traffic on a
    warmed meshed engine adds ZERO captures (on the CPU: first eager
    runs) — mesh placement enters no step key."""
    def round_(eng):
        gs = [eng.submit(PROMPT, 10, None, None),
              eng.submit(P3, 7, None, None,
                         sampling=SamplingSpec(seed=3, temperature=0.8,
                                               top_k=8))]
        eng.run_until_idle()
        return gs

    eng = _engine(small_model, mesh=f"tp={tp}")
    round_(eng)
    round_(eng)
    warm = eng.sentinel.misses
    assert warm > 0
    for _ in range(3):
        round_(eng)
    assert eng.sentinel.misses == warm, eng.sentinel.snapshot()


# -- server surface ---------------------------------------------------------


class TestMeshedServer:
    def _server(self, model, **kw):
        args = dict(model_name="t", max_batch=2, n_slots=4,
                    prefix_cache=4, mesh=_mesh("tp=2", 2))
        args.update(kw)
        return ModelServer(model, **args)

    def test_warm_equals_cold_and_topology_exported(self, small_model):
        from polyaxon_tpu_torch.serving.telemetry import \
            parse_prometheus_text

        ms = self._server(small_model)
        try:
            sys_p = list(range(1, 21))
            body = {"prompt": sys_p + [25, 26], "max_new_tokens": 8,
                    "temperature": 0.9, "top_k": 8, "seed": 5}
            cold = ms.generate(dict(body))
            ms.prefill_prompt({"prompt": sys_p})
            warm = ms.generate(dict(body))
            assert warm["new_tokens"] == cold["new_tokens"]
            assert warm["prefix_hit_len"] == len(sys_p)
            # The stored prefix is a head-sharded cache.
            entries = ms._prefix.entries()
            assert entries and all(isinstance(payload[1], ShardedKVCache)
                                   for _, payload in entries)
            info = ms.info()
            assert info["mesh"]["axes"] == {"tp": 2}
            assert info["mesh_devices"] == 2
            assert info["step_device_seconds_total"] > 0
            assert ms.engine.build_debug_snapshot()["mesh"] == "tp=2"
            text = ms.metrics_text()
            assert "ptpu_serving_mesh_devices 2" in text
            assert 'ptpu_serving_mesh_axis_size{axis="tp"} 2' in text
            assert "ptpu_serving_step_device_seconds_total" in text
            parse_prometheus_text(text)
        finally:
            ms.close()

    def test_meshed_server_matches_unmeshed_server(self, small_model):
        want = None
        body = {"prompt": [3, 1, 4, 1, 5, 9], "max_new_tokens": 10,
                "temperature": 0.9, "top_k": 8, "seed": 5}
        for mesh in (None, _mesh("tp=2", 2)):
            ms = self._server(small_model, mesh=mesh, prefix_cache=0)
            try:
                got = ms.generate(dict(body))["new_tokens"]
            finally:
                ms.close()
            if want is None:
                want = got
            else:
                assert got == want

    def test_paged_server_on_mesh_shares_pages(self, small_model):
        ms = self._server(small_model, kv_paged=True, kv_page_tokens=8)
        try:
            sys_p = list(range(1, 21))
            ms.prefill_prompt({"prompt": sys_p})
            r = ms.generate({"prompt": sys_p + [25, 26],
                             "max_new_tokens": 8})
            assert r["prefix_hit_len"] == len(sys_p)
            info = ms.info()
            assert info["kv_paged"] is True
            assert info["mesh"]["axes"] == {"tp": 2}
        finally:
            ms.close()

    def test_trace_report_shows_mesh(self, small_model, tmp_path):
        ms = self._server(small_model, prefix_cache=0)
        try:
            ms.generate({"prompt": [1, 2, 3, 4], "max_new_tokens": 6})
            trace = tmp_path / "trace.json"
            trace.write_text(json.dumps(ms.telemetry.chrome_trace()))
        finally:
            ms.close()
        sys.path.insert(0, os.path.join(ROOT, "benchmarks"))
        try:
            import trace_report
        finally:
            sys.path.pop(0)
        eng = trace_report.engine_stats(
            trace_report.load_trace_events(str(trace)))
        assert eng["mesh"] == "tp=2"


# -- clean errors -----------------------------------------------------------


class TestCleanErrors:
    def test_indivisible_heads(self):
        model = _gpt2_pair(0, num_heads=2)[2]
        with pytest.raises(MeshError, match="num_heads=2.*tp=4"):
            _engine(model, mesh="tp=4")

    def test_indivisible_kv_heads_named_in_error(self):
        model = get_model("llama-tiny").init_params(
            seed=0, device="cpu", dtype=torch.float32)  # kv heads 2
        with pytest.raises(MeshError, match="num_kv_heads=2.*tp=4"):
            _engine(model, mesh="tp=4")

    def test_indivisible_slots_for_dp(self, small_model):
        with pytest.raises(MeshError, match="n_slots"):
            _engine(small_model, mesh="dp=2", n_slots=3)

    def test_paged_rejects_dp(self, small_model):
        with pytest.raises(ValueError, match="dp slot parallelism"):
            _engine(small_model, mesh="dp=2", paged=True)

    def test_parse_rejects_training_axes_and_typos(self):
        with pytest.raises(MeshError, match="training"):
            parse_mesh("fsdp=2")
        with pytest.raises(MeshError, match="AXIS=SIZE"):
            parse_mesh("tp4")
        with pytest.raises(MeshError):
            parse_mesh("warp=2")
        spec = parse_mesh("tp=2,ep=2")
        assert (spec.tp, spec.ep, spec.dp) == (2, 2, 1)

    def test_too_few_devices(self):
        with pytest.raises(MeshError, match="devices"):
            ServingMesh("tp=16", devices=["cpu"] * 8)
        # The default devices are the DISTINCT local ones: one CPU.
        with pytest.raises(MeshError,
                           match="needs 2 devices; only 1 available"):
            ServingMesh("tp=2", device_type="cpu")

    def test_server_mesh_requires_continuous(self, small_model):
        with pytest.raises(ValueError, match="mesh requires"):
            ModelServer(small_model, batching="coalesce",
                        mesh=_mesh("tp=2"))


# -- expert parallelism -----------------------------------------------------


def _moe_pair():
    from polyaxon_tpu.models.moe_gpt import MoEGPTConfig as JCfg
    from polyaxon_tpu.models.moe_gpt import MoEGPTModel as JModel
    from polyaxon_tpu_torch.models.moe_gpt import MoEGPTConfig, \
        MoEGPTModel

    over = dict(vocab_size=32, hidden_size=32, num_layers=2, num_heads=4,
                num_experts=4, max_position=64)
    jmodel = JModel(cfg=dataclasses.replace(JCfg.tiny(), dtype=jnp.float32,
                                            **over))
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 4), jnp.int32))
    tcfg = MoEGPTConfig(dtype=torch.float32, **over)
    tmodel = MoEGPTModel(tcfg, device="cpu", param_dtype=torch.float32)
    tmodel.load_state_dict(moe_gpt_state_dict_from_jax(
        jax.tree.map(np.asarray, variables["params"]), tcfg), strict=True)
    return jmodel, variables, tmodel.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def moe():
    return _moe_pair()


def test_moe_gpt_experts_over_ep(moe):
    """moe_gpt routes experts over the ep axis: expert weights are
    split, decode fetches the routed expert from its device, and tokens
    stay bitwise vs unmeshed."""
    model = moe[2]
    want_g = TG.generate(model, PROMPT, max_new_tokens=10).tolist()
    want_s = TG.generate_positional(model, PROMPT, max_new_tokens=10,
                                    **SAMP).tolist()
    eng = _engine(model, mesh="tp=2,ep=2")
    g = eng.submit(PROMPT, 10, None, None)
    s = eng.submit(PROMPT, 10, None, None, sampling=SamplingSpec(**SAMP))
    eng.run_until_idle()
    assert g.result().tolist() == want_g
    assert s.result().tolist() == want_s
    experts = eng.model.groups[0].shards_of(
        eng.model.replicas[0].h[0])["experts"]
    assert [tuple(w.shape) for w in experts.w1] == [(2, 32, 128)] * 2
    assert experts.devices == [eng.mesh.device_at(0, e, 0)
                               for e in range(2)]


# -- the port's meshed engine against the reference's ------------------------


def _ref_run(jmodel, variables, dvars, mesh, paged):
    kw = dict(n_slots=4, decode_window=8)
    if paged:
        kw.update(kv_paged=True, kv_page_tokens=8)
    extra = {} if dvars is None else dict(draft_model=jmodel,
                                          draft_variables=dvars)
    eng = JEngine(jmodel, variables, autostart=False,
                  policy=JPolicy(**kw), mesh=mesh, **extra)
    groups = _submit_all(eng, JSpec) if dvars is not None else {
        "plain": eng.submit(PROMPT, 10, None, None),
        "sampled": eng.submit(PROMPT, 10, None, None,
                              sampling=JSpec(**SAMP))}
    c = eng.submit(P3, 9, None, None,
                   sampling=JSpec(seed=3, temperature=1.0))
    eng.run_until_idle()
    return {**{k: np.asarray(g.result()).tolist()
               for k, g in groups.items()},
            "cotenant": np.asarray(c.result()).tolist()}


def _port_run(model, dmodel, mesh, paged):
    eng = _engine(model, dmodel, mesh=mesh, paged=paged)
    groups = _submit_all(eng) if dmodel is not None else {
        "plain": eng.submit(PROMPT, 10, None, None),
        "sampled": eng.submit(PROMPT, 10, None, None,
                              sampling=SamplingSpec(**SAMP))}
    c = eng.submit(P3, 9, None, None,
                   sampling=SamplingSpec(seed=3, temperature=1.0))
    eng.run_until_idle()
    return {**{k: g.result().tolist() for k, g in groups.items()},
            "cotenant": c.result().tolist()}


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_port_meshed_engine_equals_reference_meshed_engine(tp, paged,
                                                          small, draft):
    """The reference's meshed engine (its 8 virtual host devices) and
    the port's (virtual CPU devices) on the same flax weights: greedy,
    sampled and speculative streams and a sampled co-tenant give the
    same tokens."""
    jmodel, variables, tmodel = small
    want = _ref_run(jmodel, variables, draft[1], f"tp={tp}", paged)
    got = _port_run(tmodel, draft[2], f"tp={tp}", paged)
    assert got == want


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_moe_port_meshed_equals_reference_meshed(moe, paged):
    jmodel, variables, tmodel = moe
    want = _ref_run(jmodel, variables, None, "tp=2,ep=2", paged)
    got = _port_run(tmodel, None, "tp=2,ep=2", paged)
    assert got == want


# -- extra cases ------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_llama_gqa_tp2_shards_kv_heads(paged):
    """Llama-tiny (4 query heads, 2 KV heads) at tp=2: each shard holds
    one KV head and the two query heads sharing it (the repeat stays on
    the shard); tokens equal the reference's solo decode and the
    port's unmeshed solo decode."""
    from polyaxon_tpu.models import generate as JG
    from polyaxon_tpu.models.registry import get_model as j_get_model

    jmodel = j_get_model("llama-tiny").make_model(dtype=jnp.float32)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    model = get_model("llama-tiny").make_model(device="cpu",
                                               dtype=torch.float32)
    model.load_state_dict(llama_state_dict_from_jax(
        jax.tree.map(np.asarray, variables["params"]), model.cfg),
        strict=True)
    model.eval().requires_grad_(False)
    eng = _engine(model, mesh="tp=2", paged=paged)
    g = eng.submit(PROMPT, 12, None, None)
    s = eng.submit(PROMPT, 12, None, None, sampling=SamplingSpec(**SAMP))
    eng.run_until_idle()
    want = np.asarray(JG.generate(jmodel, variables,
                                  jnp.asarray(PROMPT, jnp.int32),
                                  max_new_tokens=12)).tolist()
    assert g.result().tolist() == want == TG.generate(
        model, PROMPT, max_new_tokens=12).tolist()
    assert s.result().tolist() == TG.generate_positional(
        model, PROMPT, max_new_tokens=12, **SAMP).tolist()
    leaves = eng.slots._pools if paged else eng.slots._pool.leaves()
    assert len(leaves) == 4 and all(t.shape[-2] == 1 for t in leaves)


@pytest.mark.parametrize("kind", ["int8", "ring"])
def test_int8_kv_and_ring_on_mesh(kind):
    """The int8 cache (its bf16 scale leaves split by heads beside the
    codes, both pools) and the ring (each shard its own position table,
    a session past max_position) decode on a tp=2 mesh exactly as
    unmeshed."""
    if kind == "int8":
        model = get_model("gpt2-tiny").init_params(
            seed=0, device="cpu", dtype=torch.float32, kv_cache_int8=True)
        pools, new = (False, True), 12
    else:
        model = get_model("mistral-tiny").init_params(
            seed=0, device="cpu", dtype=torch.float32,
            kv_cache_ring=True)
        pools, new = (False,), model.cfg.max_position + 20
    prompt = np.asarray([[5, 3, 9, 2, 7]])
    want_g = TG.generate(model, prompt, max_new_tokens=new).tolist()
    want_s = TG.generate_positional(model, prompt, max_new_tokens=new,
                                    **SAMP).tolist()
    for paged in pools:
        eng = _engine(model, mesh="tp=2", paged=paged, n_slots=2)
        g = eng.submit(prompt, new, None, None)
        s = eng.submit(prompt, new, None, None,
                       sampling=SamplingSpec(**SAMP))
        eng.run_until_idle()
        assert g.result().tolist() == want_g, (kind, paged)
        assert s.result().tolist() == want_s, (kind, paged)
        shards = None if paged else eng.slots._pool.shards
        if kind == "int8" and not paged:
            assert all(len(sh.leaves()) == 4 and sh.k.dtype == torch.int8
                       for sh in shards)
        if kind == "ring":
            assert all(sh.ring_pos.shape == (2, sh.capacity)
                       for sh in shards)


def test_meshed_spill_blob_is_byte_equal_to_unmeshed(small_model):
    """A prefix spilled from a tp=2 page pool packs to the same bytes as
    the same prefix spilled from an unmeshed pool (the shards travel
    concatenated along heads), and each pool rematerializes the other's
    blob into its own kind of cache, bitwise."""
    toks = np.arange(1, 13)[None]
    blobs, pools = [], []
    for mesh in (None, _mesh("tp=2", 2)):
        model = small_model if mesh is None \
            else mesh.place_params(small_model)
        logits, cache = TG.prefill(model, toks)
        mgr = PagedSlotKVManager(model, 2, page_tokens=8, max_position=64,
                                 mesh=mesh)
        ids = mgr.try_reserve(2)
        mgr.scatter_cache(cache, ids)
        host = mgr.spill_pages(ids, 12)
        blobs.append(pack_spilled(toks, host, 12, logits))
        pools.append((mgr, host, ids))
    assert blobs[0] == blobs[1]
    (plain, host0, ids0), (meshed, host1, ids1) = pools
    back = meshed.rematerialize(host0, 12)
    assert isinstance(back, ShardedKVCache)
    whole = plain.materialize(ids0, 12)
    merged = back.merge_heads(back.leaves())
    assert all(torch.equal(a, b) for a, b in zip(merged, whole.leaves()))
    assert all(torch.equal(a, b) for a, b in zip(
        plain.rematerialize(host1, 12).leaves(), whole.leaves()))


def test_refusal_texts_equal_the_reference(small):
    """parse_mesh's and validate_model's messages are the reference's
    text; too few devices drops only the reference's XLA hint."""
    for bad in ("fsdp=2", "tp4", "warp=2", "tp=x", "tp=-1", "tp=0",
                {"tp": "x"}, 3):
        with pytest.raises(MeshError) as ours:
            parse_mesh(bad)
        with pytest.raises(jmeshed.MeshError) as theirs:
            jmeshed.parse_mesh(bad)
        assert str(ours.value) == str(theirs.value), bad
    jsmall = _gpt2_pair(0, num_heads=2)
    for spec, n_slots, (jm, jv, tm) in (("tp=4", None, jsmall),
                                        ("ep=2", None, small),
                                        ("dp=2", 3, small)):
        with pytest.raises(MeshError) as ours:
            _mesh(spec).validate_model(tm, "model", n_slots=n_slots)
        with pytest.raises(jmeshed.MeshError) as theirs:
            jmeshed.ServingMesh(spec).validate_model(jm, "model",
                                                     n_slots=n_slots)
        assert str(ours.value) == str(theirs.value), spec
    with pytest.raises(MeshError) as ours:
        _mesh("tp=16")
    with pytest.raises(jmeshed.MeshError) as theirs:
        jmeshed.ServingMesh("tp=16")
    assert str(theirs.value).startswith(str(ours.value))
    assert _mesh("tp=2,ep=2").describe() == \
        jmeshed.ServingMesh("tp=2,ep=2").describe()
    assert _mesh("dp=2,tp=2").axes_str() == \
        jmeshed.ServingMesh("dp=2,tp=2").axes_str()


# -- the CLI ----------------------------------------------------------------


def test_cli_serve_mesh_tp1_serves(tmp_path):
    """``serve --cpu --mesh tp=1`` serves over HTTP: /generate answers
    the unmeshed server's tokens, /info carries the mesh block and
    /metrics its gauges."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2",
               HOME=str(tmp_path))
    proc = subprocess.Popen(
        [sys.executable, "-m", "polyaxon_tpu_torch.cli", "serve", "--cpu",
         "--model", "gpt2-tiny", "--port", "0", "--mesh", "tp=1",
         "--n-slots", "2"], cwd=str(tmp_path), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = ""
        deadline = time.monotonic() + 120
        while "serving" not in line and time.monotonic() < deadline:
            line = proc.stdout.readline()
            assert line or proc.poll() is None, "server exited"
        url = line.strip().rsplit(" ", 1)[-1]
        req = urllib.request.Request(
            url + "/generate", method="POST",
            data=json.dumps({"prompt": [1, 2, 3],
                             "max_new_tokens": 5}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            got = json.loads(r.read())["new_tokens"]
        with urllib.request.urlopen(url + "/info", timeout=30) as r:
            info = json.loads(r.read())
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            text = r.read().decode()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    model = get_model("gpt2-tiny").init_params(seed=0, device="cpu")
    want = TG.generate(model, [[1, 2, 3]], max_new_tokens=5)
    assert got == want[:, 3:].tolist()
    assert info["mesh"] == {"axes": {"tp": 1}, "devices": 1,
                            "layout": "exact"}
    assert "ptpu_serving_mesh_devices 1" in text
    assert 'ptpu_serving_mesh_axis_size{axis="tp"} 1' in text


def test_cli_serve_mesh_tp2_on_one_device_refuses():
    from click.testing import CliRunner

    from polyaxon_tpu_torch.cli import main as cli_main

    out = CliRunner().invoke(cli_main.cli, [
        "serve", "--model", "gpt2-tiny", "--cpu", "--mesh", "tp=2"])
    assert out.exit_code != 0
    assert "needs 2 devices; only 1 available" in out.output
    out = CliRunner().invoke(cli_main.cli, [
        "serve", "--model", "gpt2-tiny", "--cpu", "--mesh", "tp=2",
        "--batching", "coalesce"])
    assert out.exit_code != 0 and "--batching continuous" in out.output
