"""Beam search in the port (``models/generate.generate_beam``) held
against the JAX package's, float32, on gpt2-tiny, llama-tiny and
mistral-tiny with the flax weights carried across: tokens EQUAL for
``num_beams`` 1 (greedy search, also equal to ``generate``), 2 and 4,
``length_penalty`` 0, 1 and 2, an eos that finishes beams mid-search,
a chunked prefill, and the validation messages.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import generate as JG
from polyaxon_tpu_torch.models import generate as TG

from test_torch_speculative import FAMILIES, _jax_model, _port

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    name = request.param
    jmodel, variables = _jax_model(name)
    return jmodel, variables, _port(name, jmodel, variables)


def _both(pair, prompt, **kw):
    jmodel, variables, tmodel = pair
    want = np.asarray(JG.generate_beam(
        jmodel, variables, jnp.asarray(prompt, jnp.int32), **kw))
    got = TG.generate_beam(tmodel, prompt, **kw).numpy()
    return want, got


def _prompt(vocab, b=2, p=6, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, p))


@pytest.mark.parametrize("num_beams,length_penalty", [
    (1, 1.0), (2, 0.0), (4, 1.0), (4, 2.0)])
def test_beam_equals_reference(pair, num_beams, length_penalty):
    prompt = _prompt(pair[2].cfg.vocab_size)
    want, got = _both(pair, prompt, max_new_tokens=8,
                      num_beams=num_beams, length_penalty=length_penalty)
    np.testing.assert_array_equal(got, want)
    if num_beams == 1:
        np.testing.assert_array_equal(got, TG.generate(
            pair[2], prompt, max_new_tokens=8).numpy())


def test_beam_eos_and_chunked_prefill_equal_reference(pair):
    """An eos taken from the beams' own output finishes some beams
    mid-search (their scores freeze, they keep emitting eos); the
    prompt prefills in chunks of 4."""
    prompt = _prompt(pair[2].cfg.vocab_size, seed=1)
    free = TG.generate_beam(pair[2], prompt, max_new_tokens=8,
                            num_beams=4).numpy()
    eos = int(free[0, 6 + 2])
    want, got = _both(pair, prompt, max_new_tokens=8, num_beams=4,
                      eos_id=eos, prefill_chunk=4)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 6 + 2:] == eos).all()


@pytest.mark.parametrize("kw", [{"max_new_tokens": 0}, {"num_beams": 0},
                                {"max_new_tokens": None}],
                         ids=["new0", "beams0", "max_position"])
def test_beam_validation_messages_equal_reference(pair, kw):
    jmodel, variables, tmodel = pair
    kw = {"max_new_tokens": 4, "num_beams": 2, **kw}
    if kw["max_new_tokens"] is None:      # one past the cache's width
        kw["max_new_tokens"] = tmodel.cfg.max_position
    prompt = _prompt(tmodel.cfg.vocab_size, b=1)
    with pytest.raises(ValueError) as want:
        JG.generate_beam(jmodel, variables,
                         jnp.asarray(prompt, jnp.int32), **kw)
    with pytest.raises(ValueError) as got:
        TG.generate_beam(tmodel, prompt, **kw)
    assert str(got.value) == str(want.value)
