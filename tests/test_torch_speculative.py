"""Speculative decoding in the port (``models/generate.generate_speculative``)
held against the JAX package's.

The cases of the reference's ``tests/test_speculative.py``, each run
through both packages on the same flax weights (converted for the
port), float32: greedy (a self draft, an independent draft, a shallower
draft; eos; the max_position boundary; chunked prefill), the chain-keyed
``rng`` schedule and the position-keyed ``seed``/``keys`` schedule.
Tokens are held EQUAL.  The reference's int8 case waits for its
ROADMAP item (int8 weights and int8 KV); its marginal-distribution
checks become token equality with the reference on 64 iid rows.  The
shared per-row draws (``_spec_draft_row``, ``_spec_verify_row``) are
held against the reference's on random logits.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import generate as JG
from polyaxon_tpu.models.gpt2 import GPT2Config as JGPT2Config
from polyaxon_tpu.models.gpt2 import GPT2Model as JGPT2Model
from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu_torch import prng
from polyaxon_tpu_torch.convert import (gpt2_state_dict_from_jax,
                                        llama_state_dict_from_jax)
from polyaxon_tpu_torch.models import generate as TG
from polyaxon_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from polyaxon_tpu_torch.models.registry import get_model

torch.set_num_threads(2)

FAMILIES = ("gpt2-tiny", "llama-tiny", "mistral-tiny")


def _port(name, jmodel, variables):
    """The port's model of registry ``name`` (float32) holding the flax
    ``variables``, at the flax model's config."""
    params = jax.tree.map(np.asarray, variables["params"])
    jcfg = jmodel.cfg
    if name.startswith("gpt2"):
        cfg = GPT2Config(vocab_size=jcfg.vocab_size,
                         hidden_size=jcfg.hidden_size,
                         num_layers=jcfg.num_layers,
                         num_heads=jcfg.num_heads,
                         max_position=jcfg.max_position,
                         dtype=torch.float32)
        model = GPT2Model(cfg, device="cpu")
        model.load_state_dict(gpt2_state_dict_from_jax(params, cfg),
                              strict=True)
    else:
        model = get_model(name).make_model(
            device="cpu", dtype=torch.float32,
            num_layers=jcfg.num_layers)
        model.load_state_dict(llama_state_dict_from_jax(params, model.cfg),
                              strict=True)
    return model.eval().requires_grad_(False)


def _jax_model(name, seed=0, **over):
    jmodel = j_get_model(name).make_model(dtype=jnp.float32, **over)
    variables = jmodel.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, 8), jnp.int32))
    return jmodel, variables


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(name, target pair, draft pair): the draft is a 1-layer model of
    the same family from another seed (low, partial acceptance)."""
    name = request.param
    jt, vt = _jax_model(name)
    jd, vd = _jax_model(name, seed=7, num_layers=1)
    return name, (jt, vt, _port(name, jt, vt)), (jd, vd, _port(name, jd, vd))


def _prompt(vocab, b=2, p=8, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, p))


def _both(target, draft, prompt, **kw):
    """(reference tokens, port tokens) of one generate_speculative."""
    jt, vt, tt = target
    jd, vd, td = draft
    jkw = dict(kw)
    tkw = dict(kw)
    if "rng" in kw:
        jkw["rng"] = jax.random.PRNGKey(kw["rng"])
        tkw["rng"] = prng.PRNGKey(kw["rng"])
    want = np.asarray(JG.generate_speculative(
        jt, vt, jd, vd, jnp.asarray(prompt, jnp.int32), **jkw))
    got = TG.generate_speculative(tt, td, prompt, **tkw).numpy()
    return want, got


@pytest.mark.parametrize("draft_kind,k", [("self", 3), ("small", 4)])
def test_greedy_equals_reference_and_generate(family, draft_kind, k):
    """Greedy speculation changes the schedule, never the tokens: the
    port's output equals the reference's and its own greedy generate,
    with full acceptance (the target as its own draft) and with a
    mostly-missing 1-layer draft."""
    name, target, small = family
    draft = target if draft_kind == "self" else small
    prompt = _prompt(target[2].cfg.vocab_size)
    want, got = _both(target, draft, prompt, max_new_tokens=12, k=k)
    np.testing.assert_array_equal(got, want)
    plain = TG.generate(target[2], prompt, max_new_tokens=12).numpy()
    np.testing.assert_array_equal(got, plain)


def test_eos_chunk_and_boundary_equal_reference(family):
    """eos freezing (an eos the greedy stream emits), a chunked
    prefill, and a budget that ends exactly at max_position - (k - 1)."""
    name, target, draft = family
    tt = target[2]
    prompt = _prompt(tt.cfg.vocab_size, seed=1)
    plain = TG.generate(tt, prompt, max_new_tokens=10).numpy()
    eos = int(plain[0, 8 + 3])
    want, got = _both(target, draft, prompt, max_new_tokens=10, k=3,
                      eos_id=eos, prefill_chunk=3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, TG.generate(
        tt, prompt, max_new_tokens=10, eos_id=eos).numpy())
    cap = tt.cfg.max_position
    long = _prompt(tt.cfg.vocab_size, b=1, p=cap - 8 - 2, seed=2)
    want, got = _both(target, draft, long, max_new_tokens=8, k=3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("schedule", ["rng", "seed"])
def test_sampled_schedules_equal_reference(family, schedule):
    """Rejection speculative sampling under both schedules: the chain
    (``rng``) and the position-keyed (``seed``) one, top-k and top-p
    shaping on, draws the reference's tokens."""
    name, target, draft = family
    prompt = _prompt(target[2].cfg.vocab_size, seed=3)
    kw = dict(max_new_tokens=10, k=3, temperature=0.9, top_k=50,
              top_p=0.95)
    kw[schedule] = 7
    want, got = _both(target, draft, prompt, **kw)
    np.testing.assert_array_equal(got, want)


def _vocab32_pair(seed):
    cfg = dataclasses.replace(
        JGPT2Config.tiny(), vocab_size=32, hidden_size=32, num_layers=2,
        num_heads=2, max_position=64, dtype=jnp.float32)
    jmodel = JGPT2Model(cfg=cfg)
    variables = jmodel.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, 4), jnp.int32))
    return jmodel, variables, _port("gpt2", jmodel, variables)


@pytest.fixture(scope="module")
def vocab32():
    """The reference's TestSampledSpeculative pair: a 32-token vocab,
    the draft an independent init of the same config."""
    return _vocab32_pair(0), _vocab32_pair(99)


@pytest.mark.parametrize("schedule", ["rng", "seed"])
def test_top_k_1_equals_greedy_for_any_draft(vocab32, schedule):
    target, draft = vocab32
    prompt = np.asarray([[5, 6, 7, 8]])
    greedy = TG.generate_speculative(target[2], draft[2], prompt,
                                     max_new_tokens=10, k=3).numpy()
    want, got = _both(target, draft, prompt, max_new_tokens=10, k=3,
                      temperature=0.7, top_k=1, **{schedule: 3})
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, greedy)


@pytest.mark.parametrize("schedule,self_draft", [
    ("rng", True), ("rng", False), ("seed", False)])
def test_iid_rows_equal_reference(vocab32, schedule, self_draft):
    """The reference's marginal checks, as token equality: 64 iid rows
    of one prompt, full acceptance (self draft) and heavy rejection
    with residual resampling (independent draft)."""
    target, draft = vocab32
    prompt = np.tile(np.asarray([[3, 1, 4, 1]]), (64, 1))
    want, got = _both(target, target if self_draft else draft, prompt,
                      max_new_tokens=3, k=2, temperature=1.0,
                      **{schedule: 11})
    np.testing.assert_array_equal(got, want)
    assert len({tuple(r) for r in got[:, 4:]}) > 8   # rows differ


def test_seed_rows_are_independent_and_deterministic(vocab32):
    """Lockstep rounds equal per-row solo runs under the position-keyed
    schedule (every draw is keyed by seed, row, index and lane): the
    property that lets engine slots advance alone yet match the solo
    reference."""
    (_, _, tt), (_, _, td) = vocab32
    prompt = np.asarray([[1, 2, 3, 4], [9, 8, 7, 6]])
    kw = dict(max_new_tokens=8, k=3, temperature=0.9, top_k=16)
    both = TG.generate_speculative(tt, td, prompt, seed=7, **kw).numpy()
    keys = TG.sample_stream_keys(7, 2)
    for r in range(2):
        solo = TG.generate_speculative(tt, td, prompt[r:r + 1],
                                       keys=keys[r:r + 1], **kw).numpy()
        np.testing.assert_array_equal(both[r], solo[0])
    np.testing.assert_array_equal(
        both, TG.generate_speculative(tt, td, prompt, seed=7, **kw).numpy())
    assert not np.array_equal(both, TG.generate_speculative(
        tt, td, prompt, seed=8, **kw).numpy())


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("kw", [
    {"max_new_tokens": 0}, {"k": 0}, {"max_new_tokens": 64},
    {"temperature": 0.5}, {"temperature": 0.5, "rng": 0, "seed": 1},
    {"temperature": -1.0, "seed": 1}, {"top_p": 0.0},
    {"top_k": 33}], ids=["new0", "k0", "slack", "no_rng",
                         "rng_and_seed", "temperature", "top_p",
                         "top_k"])
def test_validation_messages_equal_reference(vocab32, kw):
    target, draft = vocab32
    kw = {"max_new_tokens": 4, "k": 2, **kw}
    jkw, tkw = dict(kw), dict(kw)
    if "rng" in kw:
        jkw["rng"] = jax.random.PRNGKey(0)
        tkw["rng"] = prng.PRNGKey(0)
    prompt = np.asarray([[1, 2]])
    want = _message(lambda: JG.generate_speculative(
        target[0], target[1], draft[0], draft[1],
        jnp.asarray(prompt, jnp.int32), **jkw))
    got = _message(lambda: TG.generate_speculative(
        target[2], draft[2], prompt, **tkw))
    assert got == want


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.0, 0, 0.0), (1.0, 0, 0.0), (0.8, 5, 0.9)])
def test_spec_row_draws_equal_reference(temperature, top_k, top_p):
    """The shared per-row draws on random logits (8 rows, K = 4, a
    64-token vocab): proposals, densities, commits and accept counts
    equal the reference's ``_spec_draft_row`` / ``_spec_verify_row``
    (vmapped over rows), with per-row ``k_eff`` caps."""
    rs = np.random.RandomState(5)
    b, k, v = 8, 4, 64
    d_logits = rs.randn(b, k, v).astype(np.float32) * 2
    t_logits = (d_logits + rs.randn(b, k, v).astype(np.float32)) * 1.5
    keys = np.asarray(JG.sample_stream_keys(3, b))
    idx0 = rs.randint(0, 20, b)
    k_eff = rs.randint(1, k + 1, b)
    jdraft = jax.vmap(jax.vmap(
        lambda l, bk, i: JG._spec_draft_row(l, bk, i, temperature, top_k,
                                            top_p),
        in_axes=(0, None, 0)), in_axes=(0, 0, 0))
    jd, jq = jdraft(jnp.asarray(d_logits), jnp.asarray(keys),
                    jnp.asarray(idx0[:, None] + np.arange(k)))
    tkeys = torch.as_tensor(keys.astype(np.int64))
    td, tq = TG._spec_draft_row(
        torch.as_tensor(d_logits), tkeys[:, None].expand(b, k, 2),
        torch.as_tensor(idx0[:, None] + np.arange(k)), temperature,
        top_k, top_p)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    jverify = jax.vmap(lambda tl, dt, qr, bk, i, ke: JG._spec_verify_row(
        tl, dt, qr, bk, i, temperature, top_k, top_p, ke))
    jo, jc, jm = jverify(jnp.asarray(t_logits), jd, jq, jnp.asarray(keys),
                         jnp.asarray(idx0), jnp.asarray(k_eff))
    to, tc, tm = TG._spec_verify_row(
        torch.as_tensor(t_logits), td, tq, tkeys, torch.as_tensor(idx0),
        temperature, top_k, top_p, torch.as_tensor(k_eff))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    rows = np.arange(k)[None, :] < np.asarray(jc)[:, None]
    np.testing.assert_array_equal(to.numpy()[rows], np.asarray(jo)[rows])
