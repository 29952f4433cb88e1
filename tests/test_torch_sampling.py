"""Sampled decoding of the port (``models/generate.py``) against the
reference's, on the same numpy-seeded inputs.

- The position-keyed shaping (``_shape_logits_positional``) keeps and
  masks exactly the lanes the reference's does, and the static
  sort/cumsum shaping (``_modified_logits``), with bit-identical kept
  values (float32).
- ``generate_positional`` (position-keyed) and sampled ``generate``
  (chain-keyed) give the reference's tokens on gpt2-mini in float32,
  under the TIE RULE: at the first differing token, the top-2 gap of
  the shaped logits plus the gumbel noise of that draw must be below
  1e-4 (``log`` differs by an ulp between libms), and it is printed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import generate as JG
from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu_torch import prng as P
from polyaxon_tpu_torch.convert import gpt2_state_dict_from_jax
from polyaxon_tpu_torch.models import generate as TG
from polyaxon_tpu_torch.models.gpt2 import GPT2Config, GPT2Model

torch.set_num_threads(2)

TIE_GAP = 1e-4
NEW = 12


@pytest.fixture(scope="module")
def mini_pair():
    jmodel, variables = j_get_model("gpt2-mini").init_params(batch_size=1)
    params = jax.tree.map(np.asarray, variables["params"])
    cfg = GPT2Config.mini()
    tmodel = GPT2Model(cfg, device="cpu")
    tmodel.load_state_dict(gpt2_state_dict_from_jax(params, cfg),
                           strict=True)
    return jmodel, variables, tmodel.eval()


@pytest.fixture(scope="module")
def prompt():
    return np.random.RandomState(0).randint(0, 4096, (2, 10))


def _shaping_cases():
    rng = np.random.RandomState(7)
    cases = []
    for _ in range(40):
        v = int(rng.choice([32, 257, 1024]))
        logits = (rng.randn(v) * rng.uniform(0.5, 3)).astype(np.float32)
        temp = float(rng.uniform(0.2, 2.0))
        tk = int(rng.choice([0, 1, 2, 5, v // 2, v]))
        tp = float(rng.choice([0.0, 0.3, 0.7, 0.95]))
        cases.append((logits, temp, tk, tp))
    return cases


def test_positional_shaping_masks_match_static():
    """The bitwise-search cutoffs select EXACTLY the lanes the static
    sort/cumsum shaping masks, with bit-identical kept values (the
    reference's own test, run on the port's shaping)."""
    for logits, temp, tk, tp in _shaping_cases():
        shaped, greedy = TG._shape_logits_positional(
            torch.from_numpy(logits), temp, tk, tp)
        ref = np.asarray(JG._modified_logits(
            jnp.asarray(logits), temp, tk if tk > 0 else None,
            tp if tp > 0.0 else None))
        got = shaped.numpy()
        got_mask, ref_mask = got <= -1e29, ref <= -1e29
        assert np.array_equal(got_mask, ref_mask), (len(logits), temp,
                                                    tk, tp)
        assert np.array_equal(got[~ref_mask], ref[~ref_mask])
        assert not bool(greedy)


def test_positional_shaping_equals_reference_batched():
    """The port's batched shaping (per-row parameters, as the slot
    step feeds them) equals the reference's per-row function, greedy
    flags included."""
    cases = [c for c in _shaping_cases() if len(c[0]) == 257][:8]
    logits = np.stack([c[0] for c in cases])
    temps = np.asarray([c[1] for c in cases], np.float32)
    temps[1] = 0.0                                 # a greedy row
    tks = np.asarray([c[2] for c in cases])
    tps = np.asarray([c[3] for c in cases], np.float32)
    shaped, greedy = TG._shape_logits_positional(
        torch.from_numpy(logits), torch.from_numpy(temps),
        torch.from_numpy(tks), torch.from_numpy(tps))
    want, want_greedy = jax.vmap(JG._shape_logits_positional)(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(tks),
        jnp.asarray(tps))
    assert greedy.tolist() == np.asarray(want_greedy).tolist()
    assert np.array_equal(shaped.numpy(), np.asarray(want))


def test_sortable_bits_order_and_values():
    x = np.asarray([-np.inf, -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, 1e30],
                   np.float32)
    got = TG._sortable_bits(torch.from_numpy(x)).numpy()
    want = np.asarray(JG._sortable_bits(jnp.asarray(x))).astype(np.int64)
    assert np.array_equal(got, want)
    assert np.all(np.diff(got[[0, 1, 2, 4, 5, 6, 7]]) > 0)


def test_sample_stream_keys_are_bitwise():
    for seed in (0, 3, 99):
        want = JG.sample_stream_keys(seed, 5)
        got = TG.sample_stream_keys(seed, 5)
        assert np.array_equal(np.asarray(want).astype(np.int64),
                              got.numpy())


def test_sample_positional_row_equals_reference():
    rng = np.random.RandomState(3)
    logits = (rng.randn(4, 4096) * 2).astype(np.float32)
    keys = JG.sample_stream_keys(5, 4)
    for index in (0, 1, 17):
        for t, k, p in ((0.8, 50, 0.95), (1.0, 0, 0.0), (0.0, 0, 0.0),
                        (1.3, 7, 0.0), (0.6, 0, 0.5)):
            want = JG._sample_positional(jnp.asarray(logits), keys,
                                         index, t, k, p)
            got = TG._sample_positional(
                torch.from_numpy(logits),
                torch.from_numpy(np.asarray(keys).astype(np.int64)),
                index, t, k, p)
            assert got.tolist() == np.asarray(want).tolist(), (index, t)


def _positional_gap(tmodel, prompt_row, solo, got, row, seed, kw):
    """(index, gap): the first new token where ``got`` leaves ``solo``
    and the top-2 gap of shaped logits + gumbel there (the tie rule)."""
    k = next(i for i, (a, b) in enumerate(zip(solo, got)) if a != b)
    toks = torch.tensor([list(prompt_row) + list(solo[:k])])
    logits, _ = TG.prefill(tmodel, toks)
    shaped, _ = TG._shape_logits_positional(
        logits[0], kw["temperature"], kw.get("top_k") or 0,
        kw.get("top_p") or 0.0)
    key = P.fold_in(TG.sample_stream_keys(seed, row + 1)[row], k)
    z = shaped + P.gumbel(key, shaped.shape)
    top = torch.topk(z, 2).values
    return k, float(top[0] - top[1])


SAMPLING = {
    "temperature": {"temperature": 0.8},
    "top_k_top_p": {"temperature": 0.8, "top_k": 50, "top_p": 0.95},
    "hot_nucleus": {"temperature": 1.3, "top_p": 0.5},
    "top_k": {"temperature": 1.0, "top_k": 5},
}


@pytest.mark.parametrize("name", sorted(SAMPLING))
def test_generate_positional_matches_reference(name, mini_pair, prompt):
    jmodel, variables, tmodel = mini_pair
    kw = SAMPLING[name]
    for seed in (0, 5):
        want = np.asarray(JG.generate_positional(
            jmodel, variables, prompt, max_new_tokens=NEW, seed=seed,
            **kw)).tolist()
        got = TG.generate_positional(tmodel, prompt, max_new_tokens=NEW,
                                     seed=seed, **kw).tolist()
        for r in range(prompt.shape[0]):
            if got[r] == want[r]:
                continue
            k, gap = _positional_gap(tmodel, prompt[r], want[r][10:],
                                     got[r][10:], r, seed, kw)
            print(f"tie rule: {name} seed {seed} row {r} token {k} "
                  f"gap {gap:.3e}")
            assert gap < TIE_GAP


@pytest.mark.parametrize("name", sorted(SAMPLING))
def test_generate_chain_matches_reference(name, mini_pair, prompt):
    """Sampled ``generate``: token i draws with the i-th key of the
    chain ``rng, key = split(rng)``; the noise is drawn in the logits'
    type.  Equal tokens in float32 (the chain shares one key across the
    batch, so a tie is reported by row and index)."""
    jmodel, variables, tmodel = mini_pair
    kw = SAMPLING[name]
    for seed in (0, 5):
        want = np.asarray(JG.generate(
            jmodel, variables, prompt, max_new_tokens=NEW,
            rng=jax.random.PRNGKey(seed), **kw)).tolist()
        got = TG.generate(tmodel, prompt, max_new_tokens=NEW,
                          rng=P.PRNGKey(seed), **kw).tolist()
        assert got == want, (name, seed)


def test_positional_split_and_eos_match(mini_pair, prompt):
    """``generate_positional`` == prefill + ``generate_continue_
    positional`` (token indices restart at 0 for the first new token),
    and an eos freezes a row as the reference's does."""
    jmodel, variables, tmodel = mini_pair
    kw = {"temperature": 0.9, "top_k": 40}
    full = TG.generate_positional(tmodel, prompt, max_new_tokens=NEW,
                                  seed=3, **kw)
    logits, cache = TG.prefill(tmodel, prompt)
    new = TG.generate_continue_positional(
        tmodel, cache, logits, prompt.shape[1], max_new_tokens=NEW,
        seed=3, **kw)
    assert full[:, prompt.shape[1]:].tolist() == new.tolist()
    eos = int(full[0, prompt.shape[1] + 3])
    want = np.asarray(JG.generate_positional(
        jmodel, variables, prompt, max_new_tokens=NEW, seed=3,
        eos_id=eos, **kw)).tolist()
    got = TG.generate_positional(tmodel, prompt, max_new_tokens=NEW,
                                 seed=3, eos_id=eos, **kw).tolist()
    assert got == want
    assert got[0][prompt.shape[1] + 3:] == [eos] * (NEW - 3)


def test_positional_temperature_zero_is_greedy(mini_pair, prompt):
    _, _, tmodel = mini_pair
    greedy = TG.generate(tmodel, prompt, max_new_tokens=6)
    assert torch.equal(TG.generate_positional(
        tmodel, prompt, max_new_tokens=6, temperature=0.0), greedy)


def _message(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("kw", [{"top_k": 5000}, {"top_p": 1.5},
                                {"temperature": -1.0},
                                {"max_new_tokens": 600}], ids=str)
def test_positional_validation_matches_reference(kw, mini_pair, prompt):
    jmodel, variables, tmodel = mini_pair
    args = {"max_new_tokens": 4, **kw}
    want = _message(lambda: JG.generate_positional(
        jmodel, variables, prompt, **args))
    got = _message(lambda: TG.generate_positional(tmodel, prompt, **args))
    assert got == want


def test_positional_eligible(mini_pair):
    _, _, tmodel = mini_pair
    assert TG.positional_eligible(tmodel, 0.7)
    assert not TG.positional_eligible(tmodel, 0.0)
