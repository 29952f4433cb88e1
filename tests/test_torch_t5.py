"""T5 (``models/t5.py``), seq2seq decoding (``models/generate.py``) and
span corruption (``data.py``) against the flax reference, float32 on
both sides, the reference's weights carried across by
``convert.t5_state_dict_from_jax``.

- the relative-position buckets equal the reference's;
- ``encode`` / ``decode`` logits equal, tied and untied, ReLU and
  gated-GELU, with and without an encoder padding mask; at ``d_kv`` 64
  and 128-token sides the cross-attention takes both packages' flash
  routes (the reference's Pallas kernels in interpret mode), and the
  logits and the loss's gradients still equal;
- a stepped, cached decode equals teacher forcing;
- ``generate_seq2seq`` tokens (greedy, sampled with the same key, with
  ``eos_id`` freezing) and ``generate_beam_seq2seq`` tokens equal the
  reference's;
- ``SpanCorruptionDataset`` batches equal the reference's byte for byte,
  and ``_seq2seq_loss`` with its masks equals the reference's;
- ``ModelServer`` routes a seq2seq model as the reference does (no
  engine, ``coalesce``, ``/info``, the ``kv_paged`` text), and a
  generate request is refused with the named reference fault.

Tolerances: logits atol 1e-4 / rtol 1e-5, gradients rtol 1e-5 with atol
1e-5 of the tensor's largest |grad|; tokens and batches equal.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polyaxon_tpu.ops.flash as jfl
from polyaxon_tpu import data as jdata
from polyaxon_tpu.models import generate as JG
from polyaxon_tpu.models import t5 as jt5
from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu_torch import data as tdata
from polyaxon_tpu_torch import prng
from polyaxon_tpu_torch.convert import t5_state_dict_from_jax
from polyaxon_tpu_torch.models import generate as TG
from polyaxon_tpu_torch.models import t5 as tt5
from polyaxon_tpu_torch.models.registry import get_model as t_get_model
from polyaxon_tpu_torch.ops import attention as tat

torch.set_num_threads(2)

KINDS = [("relu", True), ("gated-gelu", False)]
FLASH = dict(d_model=64, d_kv=64, num_heads=2)   # head dim 64


def _close(got, want, atol=1e-4, rtol=1e-5, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _pair(ff="relu", tie=True, t5_init=False, **over):
    """(flax model, flax variables, port model) of t5-tiny, float32.
    ``t5_init``: the query projections scaled by ``d_kv ** -0.5``, the
    factor T5's own initialization folds into them (HF's
    ``_init_weights``); flax's default leaves unscaled scores of std
    ~8, where any two float32 implementations' gradients differ by ~1e-4
    of the largest (each package is that far from a float64 run)."""
    jmodel = j_get_model("t5-tiny").make_model(
        dtype=jnp.float32, feed_forward=ff, tie_embeddings=tie, **over)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    if t5_init:
        factor = jmodel.cfg.d_kv ** -0.5
        variables = jax.tree_util.tree_map_with_path(
            lambda path, x: x * factor
            if "q_proj" in jax.tree_util.keystr(path) else x, variables)
    tmodel = t_get_model("t5-tiny").make_model(
        device="cpu", dtype=torch.float32, param_dtype=torch.float32,
        feed_forward=ff, tie_embeddings=tie, **over)
    tmodel.load_state_dict(t5_state_dict_from_jax(
        jax.tree.map(np.asarray, variables["params"]), tmodel.cfg),
        strict=True)
    return jmodel, variables, tmodel.eval()


@pytest.fixture(scope="module")
def tiny():
    return _pair()


def _tokens(seed, shape, vocab=512):
    return np.random.RandomState(seed).randint(2, vocab, shape)


def _mask(b, s, lens):
    m = np.ones((b, s), np.int32)
    for row, n in enumerate(lens):
        m[row, n:] = 0
    return m


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_position_buckets_equal_reference(bidirectional):
    rel = np.arange(-300, 301)[None, :] + np.arange(-3, 4)[:, None]
    for buckets, dist in ((32, 128), (8, 20)):
        want = jt5.relative_position_bucket(
            jnp.asarray(rel), bidirectional=bidirectional,
            num_buckets=buckets, max_distance=dist)
        got = tt5.relative_position_bucket(
            torch.as_tensor(rel), bidirectional=bidirectional,
            num_buckets=buckets, max_distance=dist)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("ff,tie", KINDS)
def test_encode_decode_logits_equal_reference(ff, tie, masked):
    jmodel, variables, tmodel = _pair(ff, tie)
    src, tgt = _tokens(0, (3, 20)), _tokens(1, (3, 9))
    mask = _mask(3, 20, [20, 13, 5]) if masked else None
    want_enc = jmodel.apply(variables, jnp.asarray(src), enc_mask=mask,
                            method="encode")
    want = jmodel.apply(variables, jnp.asarray(src), jnp.asarray(tgt),
                        enc_mask=mask)
    with torch.no_grad():
        m = None if mask is None else torch.as_tensor(mask)
        got_enc = tmodel.encode(torch.as_tensor(src), enc_mask=m)
        got = tmodel(torch.as_tensor(src), torch.as_tensor(tgt),
                     enc_mask=m)
    _close(got_enc.numpy(), want_enc, what="encoder output")
    _close(got.numpy(), want, what="logits")


@pytest.mark.parametrize("masked", [False, True])
def test_cross_attention_flash_route_equals_reference(masked, monkeypatch):
    """d_kv 64 with 128 encoder and decoder tokens: the cross-attention
    of both packages takes the flash route (non-causal, scale 1.0, the
    encoder's key padding as the kernel's key mask), the self-attention
    the plain one (it carries the bias).  The loss and every gradient
    equal the reference's (T5's query scaling, see ``_pair``)."""
    monkeypatch.setenv("POLYAXON_TPU_FLASH_INTERPRET", "1")
    monkeypatch.setattr(jfl, "BLOCK_Q", 128)
    monkeypatch.setattr(jfl, "BLOCK_KV", 128)
    calls = []
    real = tat.flash_attention
    monkeypatch.setattr(tat, "flash_attention", lambda *a, **kw: (
        calls.append(kw) or real(*a, **kw)))
    jmodel, variables, tmodel = _pair(t5_init=True, **FLASH)
    batch = {"inputs": _tokens(2, (2, 128)), "labels": _tokens(3, (2, 128))}
    if masked:
        batch["enc_mask"] = _mask(2, 128, [128, 77])
        batch["target_mask"] = _mask(2, 128, [100, 128])
    jloss = j_get_model("t5-tiny").loss_fn(jmodel)
    (jl, _), jgrads = jax.value_and_grad(
        lambda p: jloss({"params": p}, batch, None), has_aux=True)(
            variables["params"])
    tmodel.train()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tl, _ = t_get_model("t5-tiny").loss_fn(tmodel)(batch)
        tl.backward()
    finally:
        torch.set_num_threads(threads)
    assert len(calls) == tmodel.cfg.num_decoder_layers
    assert all(kw["scale"] == 1.0 and not kw["causal"] for kw in calls)
    assert all((kw["kv_mask"] is not None) == masked for kw in calls)
    _close(tl.item(), float(jl), atol=1e-5)
    want = t5_state_dict_from_jax(jax.tree.map(np.asarray, jgrads),
                                  tmodel.cfg)
    for name, p in tmodel.named_parameters():
        w = want[name].numpy()
        _close(p.grad.numpy(), w, rtol=1e-5,
               atol=1e-5 * max(float(np.abs(w).max()), 1e-12), what=name)


@pytest.mark.parametrize("int8", [False, True])
def test_stepped_decode_equals_teacher_forcing(tiny, int8):
    """The start token then the targets fed one step at a time through
    the cache: each step's logits equal the teacher-forced row (the int8
    cache within its rounding)."""
    _, _, tmodel = tiny
    if int8:
        tmodel = tt5.T5Model(dataclasses.replace(tmodel.cfg,
                                                 kv_cache_int8=True),
                             device="cpu", param_dtype=torch.float32)
        tmodel.load_state_dict(tiny[2].state_dict())
    src = torch.as_tensor(_tokens(4, (2, 16)))
    dec_in = tt5.shift_right(torch.as_tensor(_tokens(5, (2, 10))), 0)
    with torch.no_grad():
        enc = tmodel.encode(src)
        want = tmodel.decode(dec_in, enc)
        cache = tmodel.init_decode_cache(2)
        for t in range(10):
            got = tmodel.decode(dec_in[:, t:t + 1], enc, decode=True,
                                decode_position=t, cache=cache)
            _close(got[:, 0].numpy(), want[:, t].numpy(),
                   atol=5e-2 if int8 else 1e-4, what=f"step {t}")
    assert all(c is not None for c in cache.cross)


@pytest.mark.parametrize("mode", ["greedy", "sampled", "eos"])
def test_generate_seq2seq_tokens_equal_reference(tiny, mode):
    jmodel, variables, tmodel = tiny
    src = _tokens(6, (3, 14))
    mask = _mask(3, 14, [14, 9, 4])
    kw = {}
    if mode == "sampled":
        kw = dict(temperature=0.9, top_k=40, top_p=0.9)
    want = JG.generate_seq2seq(jmodel, variables, jnp.asarray(src),
                               max_new_tokens=12, enc_mask=mask,
                               rng=jax.random.PRNGKey(5), **kw)
    want = np.asarray(want)
    eos = None
    if mode == "eos":
        eos = int(want[0, 3])        # a token the greedy run emits
        want = np.asarray(JG.generate_seq2seq(
            jmodel, variables, jnp.asarray(src), max_new_tokens=12,
            enc_mask=mask, eos_id=eos))
        assert (want[0, 3:] == eos).all()
    got = TG.generate_seq2seq(tmodel, src, max_new_tokens=12,
                              enc_mask=mask, rng=prng.PRNGKey(5),
                              eos_id=eos, **kw)
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("beams", [1, 3])
def test_generate_beam_seq2seq_tokens_equal_reference(tiny, beams):
    jmodel, variables, tmodel = tiny
    src = _tokens(7, (2, 11))
    mask = _mask(2, 11, [11, 6])
    want = JG.generate_beam_seq2seq(jmodel, variables, jnp.asarray(src),
                                    max_new_tokens=8, num_beams=beams,
                                    enc_mask=mask, eos_id=5)
    got = TG.generate_beam_seq2seq(tmodel, src, max_new_tokens=8,
                                   num_beams=beams, enc_mask=mask,
                                   eos_id=5)
    assert got.tolist() == np.asarray(want).tolist()
    if beams == 1:
        greedy = TG.generate_seq2seq(tmodel, src, max_new_tokens=8,
                                     enc_mask=mask, eos_id=5)
        assert got.tolist() == greedy.tolist()


def _span_kwargs():
    return dict(batch_size=4, inputs_length=64, targets_length=32,
                vocab_size=512, seed=3)


def test_span_corruption_batches_equal_reference():
    tokens = np.random.RandomState(0).randint(2, 400, 5000).astype(np.int32)
    want = jdata.SpanCorruptionDataset(tokens, **_span_kwargs())
    got = tdata.SpanCorruptionDataset(tokens, **_span_kwargs())
    assert got.window_length == want.window_length
    for epoch in (0, 1):
        pairs = list(zip(got.epoch(epoch), want.epoch(epoch)))
        assert len(pairs) == want.steps_per_epoch
        for g, w in pairs:
            assert sorted(g) == sorted(w)
            for key in w:
                assert g[key].dtype == w[key].dtype
                assert g[key].tobytes() == w[key].tobytes(), key
    resumed = next(got.epochs(start_step=3))
    assert resumed["inputs"].tobytes() == \
        list(want.epoch(0))[3]["inputs"].tobytes()
    bad = tokens.copy()
    bad[::40] = 450
    with pytest.raises(ValueError, match="sentinel range"):
        list(tdata.SpanCorruptionDataset(bad, **_span_kwargs()).epoch(0))


def test_seq2seq_loss_with_masks_equals_reference(tiny):
    jmodel, variables, tmodel = tiny
    tokens = np.random.RandomState(1).randint(2, 400, 3000).astype(np.int32)
    batch = next(tdata.SpanCorruptionDataset(tokens, **_span_kwargs())
                 .epoch(0))
    want, _ = j_get_model("t5-tiny").loss_fn(jmodel)(variables, batch,
                                                     None)
    with torch.no_grad():
        got, aux = t_get_model("t5-tiny").loss_fn(tmodel)(batch)
    _close(got.item(), float(want), atol=1e-6)
    # The masks matter: without them the loss moves.
    bare = {"inputs": batch["inputs"], "labels": batch["labels"]}
    with torch.no_grad():
        unmasked, _ = t_get_model("t5-tiny").loss_fn(tmodel)(bare)
    assert abs(unmasked.item() - got.item()) > 1e-3


def test_server_routes_seq2seq_as_reference(tiny):
    from polyaxon_tpu.serving.server import ModelServer as JServer
    from polyaxon_tpu_torch.serving import ModelServer

    jmodel, variables, tmodel = tiny
    ref = JServer(jmodel, variables)
    ms = ModelServer(tmodel)
    try:
        assert ms.engine is None and ref.engine is None
        assert ms._coalescer is not None
        assert ms.batching == ref.batching == "coalesce"
        assert ms.info()["batching"] == ref.info()["batching"]
        assert ms._prefix_enabled is False
    finally:
        ms.close()
        ref.close()
    with pytest.raises(ValueError) as theirs:
        JServer(jmodel, variables, kv_paged=True)
    with pytest.raises(ValueError) as ours:
        ModelServer(tmodel, kv_paged=True)
    assert str(ours.value) == str(theirs.value)


def test_generate_request_refused_with_named_fault(tiny):
    """The reference fails such a request with a TypeError from inside
    its decoder-only program; the port refuses it up front, naming the
    fault's ROADMAP entry (a 501 over HTTP), and so does the CLI."""
    from click.testing import CliRunner

    from polyaxon_tpu_torch.cli import main as cli_main
    from polyaxon_tpu_torch.serving import ModelServer

    ms = ModelServer(tiny[2])
    try:
        with pytest.raises(NotImplementedError,
                           match="Queue 3: seq2seq generate requests"):
            ms.generate({"prompt": [3, 1, 4, 1], "max_new_tokens": 4})
    finally:
        ms.close()
    res = CliRunner().invoke(cli_main.cli, [
        "generate", "--cpu", "--model", "t5-tiny", "--prompt", "3,1,4,1",
        "--max-new-tokens", "4"])
    assert res.exit_code != 0
    assert "Queue 3: seq2seq generate requests" in res.output
