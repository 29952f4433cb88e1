"""The port's greedy generation and CLI against the JAX reference.

gpt2-mini (float32, as the reference defines it) with the reference's
flax weights carried across by ``convert.gpt2_state_dict_from_jax``.
Greedy tokens must be EQUAL: float32 on both sides, and the argmax of
a float32 row does not tie on these inputs.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from polyaxon_tpu.models import generate as JG
from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu_torch import default_device
from polyaxon_tpu_torch.cli.main import cli
from polyaxon_tpu_torch.convert import gpt2_state_dict_from_jax
from polyaxon_tpu_torch.models import generate as TG
from polyaxon_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from polyaxon_tpu_torch.models.registry import get_model as t_get_model

torch.set_num_threads(2)

PROMPT = np.random.RandomState(5).randint(0, 4096, (2, 12))
NEW = 8


@pytest.fixture(scope="module")
def mini_pair():
    """(flax model, flax variables, port model) sharing gpt2-mini's
    reference weights."""
    jmodel, variables = j_get_model("gpt2-mini").init_params(seed=0)
    params = jax.tree.map(np.asarray, variables["params"])
    cfg = GPT2Config.mini()
    tmodel = GPT2Model(cfg, device="cpu")
    tmodel.load_state_dict(gpt2_state_dict_from_jax(params, cfg),
                           strict=True)
    return jmodel, variables, tmodel.eval()


@pytest.fixture(scope="module")
def greedy_ref(mini_pair):
    """The reference's greedy tokens for PROMPT (one-shot prefill)."""
    jmodel, variables, _ = mini_pair
    return np.asarray(JG.generate(jmodel, variables, PROMPT,
                                  max_new_tokens=NEW))


@pytest.mark.parametrize("chunk", [None, 5, 12])
def test_greedy_generate_equals_reference(chunk, mini_pair, greedy_ref):
    jmodel, variables, tmodel = mini_pair
    want = greedy_ref if chunk is None else np.asarray(JG.generate(
        jmodel, variables, PROMPT, max_new_tokens=NEW, prefill_chunk=chunk))
    got = TG.generate(tmodel, PROMPT, max_new_tokens=NEW,
                      prefill_chunk=chunk)
    assert got.shape == (2, 12 + NEW) and got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_generate_with_eos_equals_reference(mini_pair, greedy_ref):
    """eos = row 0's third new token: row 0 freezes there (keeps emitting
    eos), row 1 runs on unless it meets the same id."""
    jmodel, variables, tmodel = mini_pair
    eos = int(greedy_ref[0, 12 + 2])
    want = np.asarray(JG.generate(jmodel, variables, PROMPT,
                                  max_new_tokens=NEW, eos_id=eos))
    got = TG.generate(tmodel, PROMPT, max_new_tokens=NEW, eos_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0, 12 + 2:] == eos).all()


def test_generate_equals_prefill_plus_continue(mini_pair, greedy_ref):
    _, _, tmodel = mini_pair
    logits, cache = TG.prefill(tmodel, PROMPT[:, :7])
    logits, cache = TG.prefill(tmodel, PROMPT[:, 7:], cache=cache,
                               position=7)
    new = TG.generate_continue(tmodel, cache, logits, 12,
                               max_new_tokens=NEW)
    np.testing.assert_array_equal(new.numpy(), greedy_ref[:, 12:])


def test_prefill_logits_match_reference(mini_pair):
    """Chunked prefill's last-position logits against the reference's
    one-shot prefill: float32, atol 1e-4 on logits of magnitude ~1."""
    jmodel, variables, tmodel = mini_pair
    want, _ = JG.prefill(jmodel, variables, PROMPT)
    got, cache = TG.prefill(tmodel, PROMPT, chunk=4)
    assert cache.index == 12
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def _message(fn):
    with pytest.raises((ValueError, NotImplementedError)) as info:
        fn()
    return str(info.value)


# name: generate keyword overrides that both packages refuse.
INVALID = {
    "top_p": {"top_p": 1.5},
    "top_k": {"top_k": 0},
    "top_k_vocab": {"top_k": 5000},
    "negative_new_tokens": {"max_new_tokens": -1},
    "prefill_chunk": {"prefill_chunk": 0},
    "max_position": {"max_new_tokens": 510},
}


@pytest.mark.parametrize("name", sorted(INVALID))
def test_validation_messages_match_reference(name, mini_pair):
    jmodel, variables, tmodel = mini_pair
    kw = {"max_new_tokens": NEW, **INVALID[name]}
    want = _message(lambda: JG.generate(jmodel, variables, PROMPT, **kw))
    got = _message(lambda: TG.generate(tmodel, PROMPT, **kw))
    assert got == want


def test_continue_and_temperature_messages(mini_pair):
    jmodel, variables, tmodel = mini_pair
    jl, jc = JG.prefill(jmodel, variables, PROMPT)
    tl, tc = TG.prefill(tmodel, PROMPT)
    for kw in ({"max_new_tokens": 0}, {"max_new_tokens": 501}):
        want = _message(lambda: JG.generate_continue(
            jmodel, variables, jc, jl, 12, **kw))
        got = _message(lambda: TG.generate_continue(tmodel, tc, tl, 12,
                                                    **kw))
        assert got == want
    with pytest.raises(ValueError) as info:
        JG._check_temperature(-0.5)
    assert _message(lambda: TG.generate(
        tmodel, PROMPT, max_new_tokens=2, temperature=-0.5)) == \
        str(info.value)
    # temperature > 0 samples: both packages draw from PRNGKey(0) by
    # default and give the same tokens (float32).
    want = JG.generate(jmodel, variables, PROMPT, max_new_tokens=2,
                       temperature=0.7)
    got = TG.generate(tmodel, PROMPT, max_new_tokens=2, temperature=0.7)
    assert got.tolist() == np.asarray(want).tolist()


def test_cli_generate_cpu():
    out = CliRunner().invoke(cli, [
        "generate", "--model", "gpt2-tiny", "--prompt", "1,2,3",
        "--max-new-tokens", "4", "--eos-id", "7", "--prefill-chunk", "2",
        "--cpu"])
    assert out.exit_code == 0, out.output
    rec = json.loads(out.output.strip().splitlines()[-1])
    assert rec["backend"] == "cpu" and rec["model"] == "gpt2-tiny"
    assert len(rec["tokens"]) == 1 and len(rec["tokens"][0]) == 7
    assert rec["tokens"][0][:3] == [1, 2, 3]
    assert rec["new_tokens"] == [rec["tokens"][0][3:]]
    assert rec["wall_s"] > 0 and rec["tok_per_sec"] > 0
    # The CLI decodes what the library decodes from the same seed.
    model = t_get_model("gpt2-tiny").init_params(seed=0, device="cpu")
    lib = TG.generate(model, [[1, 2, 3]], max_new_tokens=4, eos_id=7)
    assert rec["tokens"] == lib.tolist()


@pytest.mark.parametrize("flags", [["--int8-kv"],
                                   ["--spec-k", "3"], ["--beams", "2"],
                                   ["--int8-weights"], ["--kv-ring"],
                                   ["--draft-model", "gpt2-tiny"]])
def test_cli_refuses_flags_not_ported(flags):
    out = CliRunner().invoke(cli, [
        "generate", "--model", "gpt2-tiny", "--prompt", "1,2", "--cpu",
        *flags])
    assert out.exit_code != 0
    assert "not yet ported" in out.output and flags[0] in out.output


def test_entry_points_refuse_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_get_model("gpt2-tiny").init_params(seed=0)
    out = CliRunner().invoke(cli, ["generate", "--model", "gpt2-tiny",
                                   "--prompt", "1,2"])
    assert out.exit_code != 0 and "--cpu" in out.output
    assert default_device("cpu") == torch.device("cpu")
