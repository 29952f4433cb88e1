"""MoE-GPT (``models/moe_gpt.py``, ``parallel/moe.py``) against the flax
reference, float32 on both sides, the reference's weights carried across
by ``convert.moe_gpt_state_dict_from_jax``.

- ``top1_dispatch`` equals the reference's, with a capacity that drops
  tokens and one that drops none;
- the port's three FFN paths equal the reference's: the training path
  (by index) equals the one-hot einsums of ``_switch_ffn_dense``
  dropped tokens included, the decode path ``_switch_ffn_decode``, and
  the training path at a drop-free capacity ``_switch_ffn_prefill``;
- moe-gpt-tiny's logits and aux equal the reference's on the training
  forward, the cached decode and the chunked prefill; float32 gradients
  of ``_moe_lm_loss`` equal the reference's;
- ``generate`` tokens (greedy, sampled) and the engine's tokens on both
  pools equal the reference's;
- ``decode_flops_per_token(moe-gpt-small)`` equals the reference's.

Tolerances: outputs atol 1e-4 and rtol 1e-5 of float32 values; gradients
rtol 1e-5 with atol 1e-5 of the tensor's largest |grad| (sums in another
order); tokens equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import generate as JG
from polyaxon_tpu.models import moe_gpt as jmoe
from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu.parallel import moe as jpmoe
from polyaxon_tpu.serving import profiling as jprof
from polyaxon_tpu_torch.convert import moe_gpt_state_dict_from_jax
from polyaxon_tpu_torch.models import generate as TG
from polyaxon_tpu_torch.models import moe_gpt as tmoe
from polyaxon_tpu_torch.models.registry import get_model as t_get_model
from polyaxon_tpu_torch.parallel import moe as tpmoe
from polyaxon_tpu_torch.serving import (DecodeEngine, SamplingSpec,
                                        SchedulerPolicy)
from polyaxon_tpu_torch.serving import profiling as tprof

torch.set_num_threads(2)

SAMPLED = dict(seed=3, temperature=0.8, top_k=50, top_p=0.95)


def _close(got, want, atol=1e-4, rtol=1e-5, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.fixture(scope="module")
def pair():
    """(flax model, flax variables, port model), moe-gpt-tiny float32."""
    jmodel = j_get_model("moe-gpt-tiny").make_model(dtype=jnp.float32)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    tmodel = t_get_model("moe-gpt-tiny").make_model(
        device="cpu", dtype=torch.float32, param_dtype=torch.float32)
    tmodel.load_state_dict(moe_gpt_state_dict_from_jax(
        jax.tree.map(np.asarray, variables["params"]), tmodel.cfg),
        strict=True)
    return jmodel, variables, tmodel.eval()


def _ffn_inputs(t=96, d=16, e=4, f=32, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(t, d).astype(np.float32),
            rng.randn(d, e).astype(np.float32),
            (0.3 * rng.randn(e, d, f)).astype(np.float32),
            (0.3 * rng.randn(e, f, d)).astype(np.float32))


@pytest.mark.parametrize("capacity", [5, 96])
def test_top1_dispatch_equals_reference(capacity):
    logits = np.random.RandomState(1).randn(96, 4).astype(np.float32)
    want = jpmoe.top1_dispatch(jnp.asarray(logits), capacity)
    got = tpmoe.top1_dispatch(torch.as_tensor(logits), capacity)
    for g, w in zip(got, want):
        _close(g.numpy(), w, atol=1e-6)
    dropped = 96 - int(np.asarray(want[0]).sum())
    assert (dropped > 0) == (capacity == 5)


@pytest.mark.parametrize("capacity", [5, 20])
def test_train_ffn_by_index_equals_einsum_reference(capacity):
    """Capacity 5 of 96 tokens over 4 experts drops most tokens, 20
    drops some: both give the one-hot einsums' output and aux."""
    x, r, w1, w2 = _ffn_inputs()
    want_out, want_aux = jmoe._switch_ffn_dense(
        *map(jnp.asarray, (x, r, w1, w2)), capacity,
        jax.nn.gelu)
    got_out, got_aux = tmoe.switch_ffn_train(
        *map(torch.as_tensor, (x, r, w1, w2)), capacity)
    _close(got_out.numpy(), want_out)
    _close(got_aux.item(), float(want_aux), atol=1e-6)
    zero_rows = int((np.abs(np.asarray(want_out)).sum(-1) == 0).sum())
    assert zero_rows > 0
    assert int((got_out.abs().sum(-1) == 0).sum()) == zero_rows


@pytest.mark.parametrize("path", ["decode", "prefill"])
def test_serving_ffn_paths_equal_reference(path):
    x, r, w1, w2 = _ffn_inputs(t=24)
    ref = jmoe._switch_ffn_decode if path == "decode" \
        else jmoe._switch_ffn_prefill
    want, _ = ref(*map(jnp.asarray, (x, r, w1, w2)), jax.nn.gelu)
    args = tuple(map(torch.as_tensor, (x, r, w1, w2)))
    if path == "decode":
        got, aux = tmoe.switch_ffn_decode(*args)
        assert aux.item() == 0.0
    else:
        # The port's prefill chunk is the training path at a capacity of
        # the chunk's tokens: drop-free.
        got, _ = tmoe.switch_ffn_train(*args, capacity=x.shape[0])
    _close(got.numpy(), want)


def _tokens(seed, shape, vocab=1024):
    return np.random.RandomState(seed).randint(0, vocab, shape)


def test_training_forward_logits_and_aux(pair):
    jmodel, variables, tmodel = pair
    toks = _tokens(0, (4, 64))
    want_logits, want_aux = jax.jit(
        lambda v, t: jmodel.apply(v, t, train=True))(variables, toks)
    got_logits, got_aux = tmodel(torch.as_tensor(toks), train=True)
    _close(got_logits.detach().numpy(), want_logits)
    _close(got_aux.item(), float(want_aux), atol=1e-6)


@torch.no_grad()
def test_cached_decode_and_chunked_prefill(pair):
    """The prompt prefilled in chunks of 16 (the prefill path), then 5
    single-token steps (the decode path): last-position logits equal
    the reference's at every step."""
    jmodel, variables, tmodel = pair
    prompt = _tokens(1, (2, 40))
    new = _tokens(2, (2, 5))
    jcache = JG.init_cache(jmodel, 2)
    tcache = TG.init_cache(tmodel, 2)
    for start in range(0, 40, 16):
        chunk = prompt[:, start:start + 16]
        (jl, jaux), mut = jmodel.apply(
            {"params": variables["params"], "cache": jcache}, chunk,
            decode=True, decode_position=start, mutable=["cache"])
        jcache = mut["cache"]
        tl, taux = tmodel(torch.as_tensor(chunk), decode=True,
                          decode_position=start, cache=tcache)
        _close(tl.numpy(), jl, what=f"prefill chunk {start}")
        assert float(jaux) == taux.item() == 0.0
    for i in range(5):
        tok = new[:, i:i + 1]
        (jl, _), mut = jmodel.apply(
            {"params": variables["params"], "cache": jcache}, tok,
            decode=True, decode_position=40 + i, mutable=["cache"])
        jcache = mut["cache"]
        tl, _ = tmodel(torch.as_tensor(tok), decode=True,
                       decode_position=40 + i, cache=tcache)
        _close(tl.numpy(), jl, what=f"decode step {i}")


def test_loss_and_gradients_equal_reference(pair):
    jmodel, variables, tmodel = pair
    batch = {"inputs": _tokens(3, (4, 64))}
    jloss_fn = j_get_model("moe-gpt-tiny").loss_fn(jmodel)
    (jl, jaux), jgrads = jax.value_and_grad(
        lambda p: jloss_fn({"params": p}, batch, None), has_aux=True)(
            variables["params"])
    tmodel.train()
    try:
        tmodel.zero_grad(set_to_none=True)
        tl, taux = t_get_model("moe-gpt-tiny").loss_fn(tmodel)(batch)
        tl.backward()
        _close(tl.item(), float(jl), atol=1e-6)
        _close(taux["aux_loss"].item(), float(jaux["aux_loss"]),
               atol=1e-6)
        want = moe_gpt_state_dict_from_jax(
            jax.tree.map(np.asarray, jgrads), tmodel.cfg)
        for name, p in tmodel.named_parameters():
            w = want[name].numpy()
            _close(p.grad.numpy(), w, rtol=1e-5,
                   atol=1e-5 * max(float(np.abs(w).max()), 1e-12),
                   what=name)
    finally:
        tmodel.eval()
        tmodel.zero_grad(set_to_none=True)


@pytest.mark.parametrize("sampled", [False, True])
def test_generate_tokens_equal_reference(pair, sampled):
    jmodel, variables, tmodel = pair
    prompt = _tokens(4, (2, 9))
    kw = dict(temperature=0.8, top_k=50, top_p=0.95,
              rng=jax.random.PRNGKey(7)) if sampled else {}
    want = JG.generate(jmodel, variables, jnp.asarray(prompt),
                       max_new_tokens=12, **kw)
    if sampled:
        kw["rng"] = TG.prng.PRNGKey(7)
    got = TG.generate(tmodel, prompt, max_new_tokens=12, **kw)
    assert got.tolist() == np.asarray(want).tolist()


def _solo(pair, prompt, new, sampling=None):
    jmodel, variables, _ = pair
    p = jnp.asarray(prompt, jnp.int32)
    if sampling is None:
        out = JG.generate(jmodel, variables, p, max_new_tokens=new)
    else:
        out = JG.generate_positional(jmodel, variables, p,
                                     max_new_tokens=new, **sampling)
    return np.asarray(out).tolist()


@pytest.mark.parametrize("pool", ["fixed", "paged"])
def test_engine_equals_reference(pair, pool):
    """Greedy and sampled co-tenants with chunked prefill and a request
    admitted mid-run: each stream equals the reference's solo decode
    (the reference's server answers the same, ``[3, 1, 4, 1]`` greedy
    included)."""
    tmodel = pair[2]
    kw = dict(n_slots=2, decode_window=4, prefill_chunk=16)
    if pool == "paged":
        kw.update(kv_paged=True, kv_page_tokens=8)
    eng = DecodeEngine(tmodel, autostart=False,
                       policy=SchedulerPolicy(**kw))
    a = eng.submit(_tokens(5, (1, 36)), 20, None, None)
    b = eng.submit(_tokens(6, (1, 5)), 16, None, None,
                   sampling=SamplingSpec(**SAMPLED))
    for _ in range(3):
        eng.tick()
    c = eng.submit(np.array([[3, 1, 4, 1]]), 6, None, None)
    eng.run_until_idle()
    assert a.result().tolist() == _solo(pair, _tokens(5, (1, 36)), 20)
    assert b.result().tolist() == _solo(pair, _tokens(6, (1, 5)), 16,
                                        SAMPLED)
    assert c.result().tolist() == _solo(pair, [[3, 1, 4, 1]], 6)


def test_decode_flops_per_token_equals_reference():
    jcfg = j_get_model("moe-gpt-small").make_model().cfg
    tcfg = t_get_model("moe-gpt-small").make_model(device="meta").cfg
    for pos in (0, 100, 1023):
        assert tprof.decode_flops_per_token(tcfg, pos) == \
            jprof.decode_flops_per_token(jcfg, pos)
    # Exactly the reference's attributes: no head_dim / num_kv_heads
    # (their presence would send the estimate down the Llama branch).
    assert not hasattr(tcfg, "head_dim") and \
        not hasattr(tcfg, "num_kv_heads")


def test_moe_layer_refused_by_parallelism_item():
    """``moe_layer`` is ported (over a gang: ``test_torch_ep.py``).
    Meshless it is the dense path: the reference's ``_switch_ffn_dense``
    (output and aux within 1e-5) at a capacity that drops tokens, and the
    port's index path ``switch_ffn_train``."""
    from polyaxon_tpu.models.moe_gpt import _switch_ffn_dense
    from polyaxon_tpu_torch.models.moe_gpt import switch_ffn_train

    rs = np.random.RandomState(2)
    x = rs.randn(2, 12, 8).astype(np.float32)
    r = rs.randn(8, 4).astype(np.float32)
    w1 = (0.3 * rs.randn(4, 8, 16)).astype(np.float32)
    w2 = (0.3 * rs.randn(4, 16, 8)).astype(np.float32)
    out, aux = tpmoe.moe_layer(*map(torch.as_tensor, (x, r, w1, w2)), None,
                               capacity_factor=1.25)
    cap = int(1.25 * 24 / 4)
    want, want_aux = _switch_ffn_dense(jnp.asarray(x.reshape(24, 8)), r,
                                       w1, w2, cap, jax.nn.gelu)
    np.testing.assert_allclose(out.reshape(24, 8).numpy(),
                               np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    idx, idx_aux = switch_ffn_train(torch.as_tensor(x.reshape(24, 8)),
                                    *map(torch.as_tensor, (r, w1, w2)), cap)
    np.testing.assert_allclose(out.reshape(24, 8).numpy(), idx.numpy(),
                               rtol=0, atol=1e-6)
    assert float(idx_aux) == pytest.approx(float(aux), rel=1e-6)
