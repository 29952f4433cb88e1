"""The port's slot-indexed decode and slot pool against the JAX reference.

gpt2-tiny in float32 on both sides, the port holding the reference's
flax weights (``convert.gpt2_state_dict_from_jax``).  Logits: the
slot-indexed [S]-row decode against S solo decodes of the port within
1e-5 (the same float32 arithmetic in another GEMM shape), and against
the reference's solo decode within 1e-4.  Tokens: EQUAL to the
reference's ``SlotKVManager.step`` (float32 greedy argmax).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import generate as JG
from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu.serving.slots import SlotKVManager as JSlots
from polyaxon_tpu_torch.convert import gpt2_state_dict_from_jax
from polyaxon_tpu_torch.models import generate as TG
from polyaxon_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from polyaxon_tpu_torch.models.kv_cache import KVCache
from polyaxon_tpu_torch.serving.slots import SlotKVManager

torch.set_num_threads(2)

# Three prompts whose decodes sit at positions 4, 9 and 17.
PROMPTS = [np.random.RandomState(s).randint(0, 1024, (1, n))
           for s, n in ((1, 4), (2, 9), (3, 17))]


@pytest.fixture(scope="module")
def tiny_pair():
    """(flax model, flax variables, port model): gpt2-tiny, float32,
    one set of weights."""
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
def port_prefills(tiny_pair):
    """The port's B=1 prefill of each prompt: (first token, cache)."""
    _, _, tmodel = tiny_pair
    out = []
    for p in PROMPTS:
        logits, cache = TG.prefill(tmodel, p)
        out.append((int(torch.argmax(logits[0])), cache))
    return out


def test_slot_decode_equals_solo_decodes(tiny_pair, port_prefills):
    """S = 3 rows at positions 4, 9, 17 in ONE slot-indexed forward
    against three B=1 decodes (port) and the reference's decodes."""
    jmodel, variables, tmodel = tiny_pair
    toks = torch.tensor([t for t, _ in port_prefills])
    positions = torch.tensor([p.shape[1] for p in PROMPTS])
    stacked = KVCache(
        torch.cat([c.k.clone() for _, c in port_prefills], dim=1),
        torch.cat([c.v.clone() for _, c in port_prefills], dim=1),
        positions=positions)
    with torch.no_grad():
        got = tmodel(toks[:, None], decode=True,
                     decode_position=positions, cache=stacked)[:, -1]
    assert stacked.index == 0  # a slot cache's index never advances
    for s, (tok, cache) in enumerate(port_prefills):
        pos = PROMPTS[s].shape[1]
        solo = KVCache(cache.k.clone(), cache.v.clone(), index=pos)
        with torch.no_grad():
            want = tmodel(torch.tensor([[tok]]), decode=True,
                          decode_position=pos, cache=solo)[0, -1]
        np.testing.assert_allclose(got[s].numpy(), want.numpy(),
                                   atol=1e-5, rtol=0)
        # The new K/V landed at the row's position, as the solo append.
        np.testing.assert_allclose(stacked.k[:, s].numpy(),
                                   solo.k[:, 0].numpy(), atol=1e-5, rtol=0)
        _, jcache = JG.prefill(jmodel, variables, PROMPTS[s])
        out, _ = jmodel.apply(
            {"params": JG._params(variables), "cache": jcache},
            np.asarray([[tok]]), decode=True, decode_position=pos,
            mutable=["cache"])
        jlog = JG.extract_logits(out)[0, -1]
        np.testing.assert_allclose(got[s].numpy(), np.asarray(jlog),
                                   atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def jax_slots(tiny_pair):
    """The reference pool with the same three prefills inserted into
    slots 0..2 of 4 (slot 3 idle)."""
    jmodel, variables, _ = tiny_pair
    mgr = JSlots(jmodel, variables, 4)
    for s, p in enumerate(PROMPTS):
        logits, cache = JG.prefill(jmodel, variables, p)
        mgr.insert(s, cache, int(np.argmax(np.asarray(logits)[0])),
                   p.shape[1])
        mgr.acquire()
    return mgr


@pytest.mark.parametrize("window", [1, 4])
def test_slot_step_equals_reference(window, tiny_pair, port_prefills,
                                    jax_slots):
    _, _, tmodel = tiny_pair
    mgr = SlotKVManager(tmodel, 4, max_window=8)
    for s, (tok, cache) in enumerate(port_prefills):
        assert mgr.acquire() == s
        mgr.insert(s, cache, tok, PROMPTS[s].shape[1])
    jstate = (jax_slots._stacked, jax_slots.tokens.copy(),
              jax_slots.positions.copy())
    try:
        want = jax_slots.step(window)
    finally:  # the next case steps the reference from the same state
        (jax_slots._stacked, jax_slots.tokens,
         jax_slots.positions) = jstate
    got = mgr.step(window)
    assert got.shape == (window, 4)
    np.testing.assert_array_equal(got[:, :3], np.asarray(want)[:, :3])
    # and each slot's tokens are its solo greedy continuation
    for s in range(3):
        solo = TG.generate(tmodel, PROMPTS[s], max_new_tokens=window + 1)
        assert got[:, s].tolist() == solo[0, -window:].tolist()


def test_idle_lanes_stay_at_position_zero(tiny_pair, port_prefills):
    _, _, tmodel = tiny_pair
    mgr = SlotKVManager(tmodel, 3, max_window=8)
    tok, cache = port_prefills[1]
    slot = mgr.acquire()
    mgr.insert(slot, cache, tok, PROMPTS[1].shape[1])
    for window in (4, 8, 2):
        mgr.step(window)
        assert mgr.positions[1:].tolist() == [0, 0]
        assert mgr.tokens[1:].tolist() == [0, 0]
    assert mgr.positions[0] == PROMPTS[1].shape[1] + 14
    # Idle lanes stepped from 0 each window: nothing past window - 1.
    idle_k = mgr._k[:, 1]
    assert idle_k[:, 8:].abs().sum() == 0
    assert mgr.free_slots == 2 and mgr.active_slots == 1
    mgr.release(slot)
    assert mgr.positions.tolist() == [0, 0, 0]
    with pytest.raises(ValueError, match="already free"):
        mgr.release(slot)


def test_insert_overwrites_a_used_lane(tiny_pair, port_prefills):
    """A lane that decoded one request takes the next wholesale: its
    keys and values equal the new prefill's, stale positions included,
    and it decodes the new request's solo tokens."""
    _, _, tmodel = tiny_pair
    mgr = SlotKVManager(tmodel, 2, max_window=8)
    (tok_a, cache_a), (tok_b, cache_b) = port_prefills[2], port_prefills[0]
    mgr.insert(1, cache_a, tok_a, PROMPTS[2].shape[1])
    mgr.step(8)
    assert mgr._k[:, 1, :PROMPTS[2].shape[1] + 8].abs().sum() > 0
    mgr.insert(1, cache_b, tok_b, PROMPTS[0].shape[1])
    k, v = mgr._k[:, 1], mgr._v[:, 1]
    assert torch.equal(k, cache_b.k[:, 0]) and torch.equal(v, cache_b.v[:, 0])
    got = mgr.step(4)[:, 1]
    solo = TG.generate(tmodel, PROMPTS[0], max_new_tokens=5)
    assert got.tolist() == solo[0, -4:].tolist()


def test_step_refusals(tiny_pair, port_prefills):
    _, _, tmodel = tiny_pair
    mgr = SlotKVManager(tmodel, 2, max_window=4)
    with pytest.raises(RuntimeError, match="before any insert"):
        mgr.step(1)
    tok, cache = port_prefills[0]
    mgr.insert(0, cache, tok, PROMPTS[0].shape[1])
    with pytest.raises(ValueError, match="window"):
        mgr.step(8)
    with pytest.raises(RuntimeError, match="CUDA graphs"):
        mgr.step(1, graph=True)
