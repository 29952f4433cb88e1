"""int8 weights and the int8 KV cache of the port against the JAX
reference, float32, the reference's flax weights carried across with
``convert.py`` and quantized on both sides (``quantize_params`` at
``min_size=64``, so the tiny configs also quantize their stacked biases
and norm scales, as gpt2-medium and TinyLlama do at the default).  The
reference decodes from its ``dequantize_params`` of that tree (see
``make_pair``); ``test_torch_quant.py`` holds the port's dequantized
weights bitwise equal to it.

- After a prefill, the port's int8 K/V bytes and bf16 scales equal the
  reference's ``cached_key``/``cached_key_scale`` (and values).
- Tokens equal the reference's for ``--int8-weights``, ``--int8-kv``
  and both: solo greedy, position-keyed sampled, speculative (with an
  int8 draft) and beam search, on gpt2-tiny and llama-tiny.
- The continuous-batching engine on the fixed-lane and the paged pool
  (eager and lazy) equals the reference's solo decode for each mode.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import generate as JG
from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu.ops.quant import dequantize_params as j_dequantize
from polyaxon_tpu.ops.quant import quantize_params as j_quantize
from polyaxon_tpu_torch.convert import (gpt2_state_dict_from_jax,
                                        llama_state_dict_from_jax)
from polyaxon_tpu_torch.models import generate as TG
from polyaxon_tpu_torch.models.registry import get_model
from polyaxon_tpu_torch.ops.quant import quantize_params
from polyaxon_tpu_torch.serving import (DecodeEngine, SamplingSpec,
                                        SchedulerPolicy)

torch.set_num_threads(2)

MIN_SIZE = 64
MODES = {"weights": dict(int8_weights=True),
         "kv": dict(kv_cache_int8=True),
         "both": dict(int8_weights=True, kv_cache_int8=True)}
SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.95)
POOLS = {"fixed": {}, "paged": {"kv_paged": True, "kv_page_tokens": 8},
         "lazy": {"kv_paged": True, "kv_page_tokens": 8,
                  "kv_lazy": True}}


def make_pair(name, seed=0, int8_weights=False, min_size=MIN_SIZE,
              **over):
    """(flax model, flax variables, port model), float32, the config
    ``over``rides on both sides; ``int8_weights`` quantizes both."""
    jmodel = j_get_model(name).make_model(dtype=jnp.float32, **over)
    variables = jmodel.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, 8), jnp.int32))
    tmodel = get_model(name).make_model(device="cpu", dtype=torch.float32,
                                        **over)
    conv = gpt2_state_dict_from_jax if name.startswith("gpt2") \
        else llama_state_dict_from_jax
    tmodel.load_state_dict(conv(jax.tree.map(np.asarray,
                                             variables["params"]),
                                tmodel.cfg), strict=True)
    tmodel.eval().requires_grad_(False)
    if int8_weights:
        # The reference decodes from its own dequantize_params output:
        # the bf16 product q * scale it documents.  Fed the quantized
        # tree itself, its jitted steps keep that product in float32
        # (XLA's excess precision) while its eager prefill rounds it,
        # so the reference would disagree with itself.
        variables = {"params": j_dequantize(j_quantize(
            variables["params"], min_size=min_size))}
        quantize_params(tmodel, min_size=min_size)
    return jmodel, variables, tmodel


def vocab(name):
    return get_model(name).make_model(device="meta").cfg.vocab_size


def prompt(name, seed, shape):
    return np.random.RandomState(seed).randint(0, vocab(name), shape)


_PAIRS = {}


def cached_pair(name, mode, seed=0, **over):
    key = (name, mode, seed, tuple(sorted(over.items())))
    if key not in _PAIRS:
        _PAIRS[key] = make_pair(name, seed=seed, **MODES[mode], **over)
    return _PAIRS[key]


@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_prefill_cache_bytes_and_scales_equal_reference(name):
    """The int8 cache after a 13-token prefill (two chunks): the int8
    keys and values and their bf16 scales equal the reference's cache
    variables exactly (RoPE keys rotated before they quantize)."""
    jmodel, variables, tmodel = cached_pair(name, "kv")
    p = prompt(name, 3, (2, 13))
    _, jcache = JG._prefill(jmodel, variables, jnp.asarray(p), chunk=8)
    _, tcache = TG.prefill(tmodel, p, chunk=8)
    block = jcache["h"]["block"]
    if "attn" in block:
        block = block["attn"]
    for mine, ref in ((tcache.k, "cached_key"), (tcache.v, "cached_value"),
                      (tcache.k_scale, "cached_key_scale"),
                      (tcache.v_scale, "cached_value_scale")):
        want = np.asarray(block[ref])
        assert mine.dtype == (torch.int8 if "scale" not in ref
                              else torch.bfloat16)
        np.testing.assert_array_equal(
            mine.float().numpy(), want.astype(np.float32), err_msg=ref)
    assert tcache.index == 13


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_greedy_and_sampled_tokens_equal_reference(name, mode):
    """Greedy and position-keyed sampled tokens equal the reference's;
    the port's chunked prefill (4) gives the same tokens."""
    jmodel, variables, tmodel = cached_pair(name, mode)
    p = prompt(name, 1, (2, 9))
    want = np.asarray(JG.generate(jmodel, variables, jnp.asarray(p),
                                  max_new_tokens=12))
    for chunk in (None, 4):
        got = TG.generate(tmodel, p, max_new_tokens=12,
                          prefill_chunk=chunk)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=chunk)
    want = np.asarray(JG.generate_positional(
        jmodel, variables, jnp.asarray(p), max_new_tokens=12, seed=5,
        **SAMPLED))
    got = TG.generate_positional(tmodel, p, max_new_tokens=12, seed=5,
                                 **SAMPLED)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_speculative_with_int8_draft_equals_reference(name, mode):
    """The target and a 1-layer draft of the same family, both under
    the mode: greedy (the target's greedy tokens) and position-keyed
    sampled speculative decoding."""
    jt, vt, tt = cached_pair(name, mode)
    jd, vd, td = cached_pair(name, mode, seed=7, num_layers=1)
    p = prompt(name, 2, (1, 6))
    for kw in ({}, dict(seed=4, **SAMPLED)):
        want = np.asarray(JG.generate_speculative(
            jt, vt, jd, vd, jnp.asarray(p), max_new_tokens=10, k=3, **kw))
        got = TG.generate_speculative(tt, td, p, max_new_tokens=10, k=3,
                                      **kw)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(kw))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_beam_equals_reference(name, mode):
    """Beam search tiles and reorders the int8 cache's scales with its
    entries."""
    jmodel, variables, tmodel = cached_pair(name, mode)
    p = prompt(name, 4, (2, 7))
    want = np.asarray(JG.generate_beam(jmodel, variables, jnp.asarray(p),
                                       max_new_tokens=8, num_beams=3))
    got = TG.generate_beam(tmodel, p, max_new_tokens=8, num_beams=3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pool", sorted(POOLS))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_equals_reference_solo(mode, pool):
    """A greedy stream, a sampled one and a third admitted after three
    ticks, chunked prefill of 8, on llama-tiny: each equals the
    reference's solo decode under the same mode.  The pool holds int8
    entries and scales under ``kv``."""
    jmodel, variables, tmodel = cached_pair("llama-tiny", mode)
    eng = DecodeEngine(tmodel, autostart=False, policy=SchedulerPolicy(
        n_slots=2, decode_window=4, prefill_chunk=8, **POOLS[pool]))
    pa, pb, pc = (prompt("llama-tiny", s, (1, n))
                  for s, n in ((1, 20), (2, 5), (3, 11)))
    a = eng.submit(pa, 14, None, None)
    b = eng.submit(pb, 12, None, None, sampling=SamplingSpec(
        seed=3, **SAMPLED))
    for _ in range(3):
        eng.tick()
    c = eng.submit(pc, 9, None, None)
    eng.run_until_idle()
    for g, p, new, samp in ((a, pa, 14, None), (b, pb, 12, 3),
                            (c, pc, 9, None)):
        if samp is None:
            want = JG.generate(jmodel, variables, jnp.asarray(p),
                               max_new_tokens=new)
        else:
            want = JG.generate_positional(jmodel, variables,
                                          jnp.asarray(p),
                                          max_new_tokens=new, seed=samp,
                                          **SAMPLED)
        assert g.result().tolist() == np.asarray(want).tolist()


def test_engine_pools_hold_int8_entries_and_scales():
    """The fixed-lane pool stacks the int8 entries with their scales;
    the paged pool pages all four tensors at the same page ids."""
    _, _, tmodel = cached_pair("llama-tiny", "kv")
    for pool in ("fixed", "paged"):
        eng = DecodeEngine(tmodel, autostart=False, policy=SchedulerPolicy(
            n_slots=2, decode_window=2, **POOLS[pool]))
        eng.submit(prompt("llama-tiny", 1, (1, 6)), 3, None, None)
        eng.run_until_idle()
        leaves = eng.slots._pools if pool == "paged" \
            else eng.slots._pool.leaves()
        assert [t.dtype for t in leaves] == [torch.int8, torch.int8,
                                             torch.bfloat16,
                                             torch.bfloat16]
        assert leaves[2].shape[:-1] == leaves[0].shape[:-1]
        assert leaves[2].shape[-1] == 1
