"""The port's GPT-2 against the flax reference, with the reference's
weights carried across by ``convert.gpt2_state_dict_from_jax``.

gpt2-tiny in float32 (the reference's flax init, seeded), hidden 256 /
4 heads where the flash route needs head_dim 64.  Tolerance: atol 1e-4
on logits of magnitude ~1: float32 on both sides; LayerNorm variance is
E[x^2]-E[x]^2 in flax and two-pass in torch, and sums run in another
order.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models.gpt2 import GPT2Config as JConfig
from polyaxon_tpu.models.gpt2 import GPT2Model as JModel
from polyaxon_tpu_torch.convert import gpt2_state_dict_from_jax
from polyaxon_tpu_torch.models import generate as TG
from polyaxon_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from polyaxon_tpu_torch.ops import attention as tat

torch.set_num_threads(2)

ATOL = 1e-4


def _pair(scan_layers=True, **over):
    """(flax model, flax variables, numpy params, port model) sharing
    the reference's weights."""
    jcfg = dataclasses.replace(JConfig.tiny(), dtype=jnp.float32,
                               scan_layers=scan_layers, **over)
    tcfg = dataclasses.replace(GPT2Config.tiny(), dtype=torch.float32,
                               scan_layers=scan_layers, **over)
    jmodel = JModel(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    params = jax.tree.map(np.asarray, variables["params"])
    tmodel = GPT2Model(tcfg, device="cpu")
    tmodel.load_state_dict(gpt2_state_dict_from_jax(params, tcfg),
                           strict=True)
    return jmodel, variables, params, tmodel.eval()


@pytest.mark.parametrize("scan_layers", [True, False])
def test_converter_round_trip_is_exact(scan_layers):
    _, _, params, tmodel = _pair(scan_layers)
    sd = tmodel.state_dict()
    for i in range(tmodel.cfg.num_layers):
        layer = ({m: {n: a[i] for n, a in leaves.items()}
                  for m, leaves in params["h"]["block"].items()}
                 if scan_layers else params[f"h_{i}"])
        for mod in ("qkv", "o_proj", "fc1", "fc2"):
            np.testing.assert_array_equal(
                sd[f"h.{i}.{mod}.weight"].numpy().T, layer[mod]["kernel"])
            np.testing.assert_array_equal(
                sd[f"h.{i}.{mod}.bias"].numpy(), layer[mod]["bias"])
        for mod in ("ln1", "ln2"):
            np.testing.assert_array_equal(
                sd[f"h.{i}.{mod}.weight"].numpy(), layer[mod]["scale"])
            np.testing.assert_array_equal(
                sd[f"h.{i}.{mod}.bias"].numpy(), layer[mod]["bias"])
    for name, leaf in (("wte.weight", params["wte"]["embedding"]),
                       ("wpe.weight", params["wpe"]["embedding"]),
                       ("ln_f.weight", params["ln_f"]["scale"]),
                       ("ln_f.bias", params["ln_f"]["bias"])):
        np.testing.assert_array_equal(sd[name].numpy(), leaf)


def test_converter_refuses_wrong_depth():
    _, _, params, _ = _pair()
    cfg = dataclasses.replace(GPT2Config.tiny(), num_layers=3)
    with pytest.raises(ValueError, match="layers"):
        gpt2_state_dict_from_jax(params, cfg)


@pytest.mark.parametrize("seq,route", [(128, "flash"), (64, "plain")])
def test_full_forward_matches_reference(seq, route, monkeypatch):
    """S=128 with head_dim 64 is flash-eligible (both packages take their
    flash path: the reference in interpret mode); S=64 is not."""
    monkeypatch.setenv("POLYAXON_TPU_FLASH_INTERPRET", "1")
    calls = []
    real = tat.flash_attention
    monkeypatch.setattr(tat, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    jmodel, variables, _, tmodel = _pair(hidden_size=256)
    toks = np.random.RandomState(0).randint(0, 1024, (2, seq))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(toks)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(toks)).numpy()
    assert got.shape == (2, seq, 1024) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert len(calls) == (tmodel.cfg.num_layers if route == "flash" else 0)


def test_decode_steps_match_reference():
    """A 6-token prefill, then three single-token decode steps: logits at
    each step against the flax cache-collection decode."""
    jmodel, variables, _, tmodel = _pair()
    toks = np.random.RandomState(1).randint(0, 1024, (2, 9))
    from polyaxon_tpu.models.generate import init_cache as j_init_cache

    jcache = j_init_cache(jmodel, 2)
    tcache = TG.init_cache(tmodel, 2)
    pieces = [(0, 6), (6, 7), (7, 8), (8, 9)]
    for lo, hi in pieces:
        chunk = toks[:, lo:hi]
        out, mut = jmodel.apply({"params": variables["params"],
                                 "cache": jcache}, jnp.asarray(chunk),
                                decode=True, decode_position=lo,
                                mutable=["cache"])
        jcache = mut["cache"]
        with torch.no_grad():
            got = tmodel(torch.from_numpy(chunk), decode=True,
                         decode_position=lo, cache=tcache).numpy()
        np.testing.assert_allclose(got, np.asarray(out), atol=ATOL, rtol=0)
    assert tcache.index == 9


def test_decode_needs_position_and_cache():
    tmodel = GPT2Model(GPT2Config.tiny(), device="cpu")
    toks = torch.zeros((1, 1), dtype=torch.long)
    with pytest.raises(ValueError, match="decode_position"):
        tmodel(toks, decode=True)
    with pytest.raises(ValueError, match="KV cache"):
        tmodel(toks, decode=True, decode_position=0)


def test_configs_mirror_reference():
    for name in ("tiny", "mini", "small", "medium"):
        j, t = getattr(JConfig, name)(), getattr(GPT2Config, name)()
        for f in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                  "max_position", "layer_norm_eps", "scan_layers",
                  "remat", "kv_cache_int8"):
            assert getattr(j, f) == getattr(t, f), (name, f)
        assert str(jnp.dtype(j.dtype)) == str(t.dtype).split(".")[-1]
        assert j.intermediate_size == t.intermediate_size
