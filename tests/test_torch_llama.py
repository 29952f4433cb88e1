"""The port's Llama family (``models/llama.py``) against the flax
reference, with the reference's weights carried across by
``convert.llama_state_dict_from_jax``.

llama-tiny (GQA 4/2) and mistral-tiny (GQA 4/2, sliding window 31),
float32 on both sides (``dataclasses.replace(cfg, dtype=float32)`` on
the reference, ``dtype=torch.float32`` on the port); the flash route
needs head dim 64, so those cases widen the models to hidden 256 / 4
heads, and the reference runs its Pallas kernels in interpret mode.
Tolerances: logits atol 1e-4 (values of magnitude ~5; float32 on both
sides, sums in another order); tokens equal; gradients rtol 1e-4 and
atol 1e-4 of the tensor's largest |grad|; AdamW params 2e-6, with the
Adam step bound for elements whose gradient fell below 1e-7, as
``tests/test_torch_train.py`` holds GPT-2.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import polyaxon_tpu.ops.flash as jfl
from polyaxon_tpu.models import generate as JG
from polyaxon_tpu.models.llama import LlamaConfig as JConfig
from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu.train import make_optimizer as j_make_optimizer
from polyaxon_tpu_torch import train as ttrain
from polyaxon_tpu_torch.convert import llama_state_dict_from_jax
from polyaxon_tpu_torch.models import generate as TG
from polyaxon_tpu_torch.models import llama as tllama
from polyaxon_tpu_torch.models.llama import LlamaConfig
from polyaxon_tpu_torch.models.registry import get_model as t_get_model
from polyaxon_tpu_torch.ops import attention as tat
from polyaxon_tpu_torch.parallel import make_train_step

torch.set_num_threads(2)

ATOL = 1e-4
MODELS = ("llama-tiny", "mistral-tiny")
FLASH = dict(hidden_size=256, num_heads=4)  # head dim 64


def _pair(name, scan_layers=True, seq=8, **over):
    """(flax model, flax variables, numpy params, port model) from the
    two registries, float32, sharing the reference's weights."""
    jmodel = j_get_model(name).make_model(dtype=jnp.float32,
                                          scan_layers=scan_layers, **over)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, seq), jnp.int32))
    params = jax.tree.map(np.asarray, variables["params"])
    tmodel = t_get_model(name).make_model(device="cpu",
                                          dtype=torch.float32,
                                          scan_layers=scan_layers, **over)
    tmodel.load_state_dict(llama_state_dict_from_jax(params, tmodel.cfg),
                           strict=True)
    return jmodel, variables, params, tmodel.eval()


def _tokens(seed, shape, vocab=512):
    return np.random.RandomState(seed).randint(0, vocab, shape)


@pytest.mark.parametrize("scan_layers", [True, False])
def test_converter_round_trip_is_exact(scan_layers):
    _, _, params, tmodel = _pair("llama-tiny", scan_layers)
    sd = tmodel.state_dict()
    for i in range(tmodel.cfg.num_layers):
        layer = (jax.tree.map(lambda a: a[i], params["h"]["block"])
                 if scan_layers else params[f"h_{i}"])
        for mod in ("q_proj", "k_proj", "v_proj", "o_proj"):
            np.testing.assert_array_equal(
                sd[f"h.{i}.attn.{mod}.weight"].numpy().T,
                layer["attn"][mod]["kernel"])
        for mod in ("gate_proj", "up_proj", "down_proj"):
            np.testing.assert_array_equal(
                sd[f"h.{i}.{mod}.weight"].numpy().T, layer[mod]["kernel"])
        for mod in ("input_norm", "post_attn_norm"):
            np.testing.assert_array_equal(
                sd[f"h.{i}.{mod}.weight"].numpy(), layer[mod]["scale"])
    np.testing.assert_array_equal(sd["embed.weight"].numpy(),
                                  params["embed"]["embedding"])
    np.testing.assert_array_equal(sd["final_norm.weight"].numpy(),
                                  params["final_norm"]["scale"])
    np.testing.assert_array_equal(sd["lm_head.weight"].numpy().T,
                                  params["lm_head"]["kernel"])
    assert len(sd) == 9 * tmodel.cfg.num_layers + 3


def test_converter_refuses_wrong_depth():
    _, _, params, _ = _pair("llama-tiny")
    with pytest.raises(ValueError, match="layers"):
        llama_state_dict_from_jax(
            params, dataclasses.replace(LlamaConfig.tiny(), num_layers=3))


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("seq,route", [(128, "flash"), (100, "plain")])
def test_full_forward_matches_reference(name, scan_layers, seq, route,
                                        monkeypatch):
    """S=128 at head dim 64 takes both packages' flash paths (mistral-
    tiny's with the window); S=100 the plain path."""
    monkeypatch.setenv("POLYAXON_TPU_FLASH_INTERPRET", "1")
    calls = []
    real = tat.flash_attention
    monkeypatch.setattr(tat, "flash_attention",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    jmodel, variables, _, tmodel = _pair(name, scan_layers, **FLASH)
    toks = _tokens(0, (2, seq))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(toks)))
    # torch on the calling thread (the standing rule of the CPU
    # comparisons): on a loaded host an intra-op worker's exp has lost
    # precision in a process that had run XLA:CPU.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            got = tmodel(torch.from_numpy(toks)).numpy()
    finally:
        torch.set_num_threads(threads)
    assert got.shape == (2, seq, 512) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert len(calls) == (tmodel.cfg.num_layers if route == "flash" else 0)
    assert all(kw["window"] == tmodel.cfg.sliding_window for kw in calls)


def test_gqa_repeat_is_interleaved(monkeypatch):
    """8 query heads over 2 KV heads: each KV head serves 4 consecutive
    query heads ([h0 x 4, h1 x 4], jnp.repeat).  A tile ([h0, h1] x 4)
    is another model, and the comparison is sharp enough to see it."""
    over = dict(hidden_size=128, num_heads=8, num_kv_heads=2)
    jmodel, variables, _, tmodel = _pair("llama-tiny", **over)
    toks = _tokens(1, (2, 24))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(toks)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    real = torch.Tensor.repeat_interleave

    def tile(self, rep, dim=None, **kw):
        if dim == 2:
            return self.repeat(1, 1, rep, 1)
        return real(self, rep, dim=dim, **kw)

    monkeypatch.setattr(torch.Tensor, "repeat_interleave", tile)
    with torch.no_grad():
        tiled = tmodel(torch.from_numpy(toks)).numpy()
    assert np.abs(tiled - want).max() > 100 * ATOL


@pytest.mark.parametrize("name", MODELS)
def test_decode_matches_reference_and_full_forward(name):
    """A 40-token prefill, then single-token steps (mistral-tiny's
    window of 31 clips both): logits at each step against the flax
    cache-collection decode and against the port's full forward; the
    cache holds num_kv_heads heads."""
    jmodel, variables, _, tmodel = _pair(name)
    toks = _tokens(2, (2, 44))
    jcache = JG.init_cache(jmodel, 2)
    tcache = TG.init_cache(tmodel, 2)
    cfg = tmodel.cfg
    assert tuple(tcache.k.shape) == (cfg.num_layers, 2, cfg.max_position,
                                     cfg.num_kv_heads, cfg.head_dim)
    with torch.no_grad():
        full = tmodel(torch.from_numpy(toks)).numpy()
    for lo, hi in [(0, 40), (40, 41), (41, 42), (42, 43), (43, 44)]:
        chunk = toks[:, lo:hi]
        out, mut = jmodel.apply({"params": variables["params"],
                                 "cache": jcache}, jnp.asarray(chunk),
                                decode=True, decode_position=lo,
                                mutable=["cache"])
        jcache = mut["cache"]
        with torch.no_grad():
            got = tmodel(torch.from_numpy(chunk), decode=True,
                         cache=tcache).numpy()
        np.testing.assert_allclose(got, np.asarray(out), atol=ATOL, rtol=0)
        np.testing.assert_allclose(got, full[:, lo:hi], atol=ATOL, rtol=0)
    assert tcache.index == 44


@pytest.mark.parametrize("name", MODELS)
def test_greedy_generate_matches_reference(name):
    jmodel, variables, _, tmodel = _pair(name)
    prompt = _tokens(3, (2, 9))
    want = JG.generate(jmodel, variables, jnp.asarray(prompt, jnp.int32),
                       max_new_tokens=40)
    got = TG.generate(tmodel, prompt, max_new_tokens=40)
    assert got.tolist() == np.asarray(want).tolist()
    chunked = TG.generate(tmodel, prompt, max_new_tokens=40,
                          prefill_chunk=4)
    assert chunked.tolist() == got.tolist()


@pytest.mark.parametrize("name", MODELS)
def test_positional_sampled_matches_reference(name):
    jmodel, variables, _, tmodel = _pair(name)
    prompt = _tokens(4, (2, 6))
    kw = dict(max_new_tokens=36, seed=5, temperature=0.8, top_k=50,
              top_p=0.95)
    want = JG.generate_positional(jmodel, variables,
                                  jnp.asarray(prompt, jnp.int32), **kw)
    got = TG.generate_positional(tmodel, prompt, **kw)
    assert got.tolist() == np.asarray(want).tolist()


def test_window_receptive_field():
    """mistral-tiny (window 31, 2 layers): a changed token 0 reaches
    positions up to 2 x 31 = 62 and leaves every later position's logits
    exactly as they were, in the full forward and in decode; without
    the window it reaches them all."""
    _, _, _, tmodel = _pair("mistral-tiny")
    a = _tokens(5, (1, 80))
    b = a.copy()
    b[0, 0] = (a[0, 0] + 1) % 512
    with torch.no_grad():
        la, lb = (tmodel(torch.from_numpy(t)).numpy() for t in (a, b))
        moved = np.abs(la - lb).max(-1)[0]
        assert (moved[:63] > 0).all() and (moved[63:] == 0).all()
        steps = []
        for t in (a, b):
            cache = TG.init_cache(tmodel, 1)
            tmodel(torch.from_numpy(t[:, :70]), decode=True, cache=cache)
            steps.append(np.concatenate([tmodel(
                torch.from_numpy(t[:, i:i + 1]), decode=True,
                cache=cache).numpy() for i in range(70, 80)], axis=1))
        assert np.array_equal(steps[0], steps[1])
        np.testing.assert_allclose(steps[0], la[:, 70:], atol=ATOL, rtol=0)
    full = t_get_model("mistral-tiny").make_model(
        device="cpu", dtype=torch.float32, sliding_window=None)
    full.load_state_dict(tmodel.state_dict())
    with torch.no_grad():
        moved = np.abs(full(torch.from_numpy(a)).numpy()
                       - full(torch.from_numpy(b)).numpy()).max(-1)[0]
    assert (moved > 0).all()


def _assert_grads(tmodel, jgrads):
    want = llama_state_dict_from_jax(
        jax.tree.map(np.asarray, jgrads["params"]), tmodel.cfg)
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(
            got[name].numpy(), w, rtol=1e-4,
            atol=1e-4 * max(float(np.abs(w).max()), 1e-12), err_msg=name)


@pytest.mark.parametrize("name,remat", [("llama-tiny", False),
                                        ("llama-tiny", True),
                                        ("mistral-tiny", True)])
def test_loss_and_grads_match_reference(name, remat, monkeypatch):
    """The flash route at head dim 64, seq 128 (the reference's Pallas
    forward and backward in interpret mode, the port's plain versions);
    remat runs each layer's flash forward again in the backward."""
    monkeypatch.setenv("POLYAXON_TPU_FLASH_INTERPRET", "1")
    monkeypatch.setattr(jfl, "BLOCK_Q", 128)
    monkeypatch.setattr(jfl, "BLOCK_KV", 128)
    calls = []
    real = tat.flash_attention
    monkeypatch.setattr(tat, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    jmodel, variables, _, _ = _pair(name, remat=remat, **FLASH)
    tmodel = t_get_model(name).init_params(
        seed=1, device="cpu", train=True, dtype=torch.float32,
        remat=remat, **FLASH)
    tmodel.load_state_dict(llama_state_dict_from_jax(
        jax.tree.map(np.asarray, variables["params"]), tmodel.cfg))
    batch = {"inputs": _tokens(6, (2, 128))}
    with jax.default_matmul_precision("highest"):
        (jloss, jaux), jgrads = jax.value_and_grad(
            j_get_model(name).loss_fn(jmodel), has_aux=True)(
                variables, batch, None)
    loss, aux = t_get_model(name).loss_fn(tmodel)(batch)
    loss.backward()
    assert len(calls) == tmodel.cfg.num_layers * (2 if remat else 1)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(aux["perplexity"].item(),
                               float(jaux["perplexity"]), rtol=1e-4)
    _assert_grads(tmodel, jgrads)


def test_three_adamw_steps_match_optax():
    jmodel, variables, _, _ = _pair("llama-tiny")
    tmodel = t_get_model("llama-tiny").init_params(
        seed=1, device="cpu", train=True, dtype=torch.float32)
    tmodel.load_state_dict(llama_state_dict_from_jax(
        jax.tree.map(np.asarray, variables["params"]), tmodel.cfg))
    rng = np.random.RandomState(7)
    batches = [{"inputs": rng.randint(0, 512, (4, 64))} for _ in range(3)]
    loss_fn = j_get_model("llama-tiny").loss_fn(jmodel)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    opt = j_make_optimizer("adamw", 1e-3)
    params, opt_state = variables, opt.init(variables)
    step_fn = make_train_step(t_get_model("llama-tiny").loss_fn(tmodel),
                              ttrain.make_optimizer("adamw", 1e-3))
    state = step_fn.init_state(tmodel)
    small = {}
    for batch in batches:
        (jloss, _), grads = grad_fn(params, batch, None)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        state, m = step_fn(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jloss),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(optax.global_norm(grads)),
                                   rtol=1e-5)
        for n, p in tmodel.named_parameters():
            g = p.grad.abs().masked_fill(p.grad == 0, float("inf"))
            small[n] = g if n not in small else torch.minimum(small[n], g)
    want = llama_state_dict_from_jax(
        jax.tree.map(np.asarray, params["params"]), tmodel.cfg)
    tight = total = 0
    for name, p in tmodel.named_parameters():
        got, w = p.detach().numpy(), want[name].numpy()
        atol = np.full(got.shape, 2e-6, np.float32)
        atol[small[name].numpy() < 1e-7] = 2 * 3 * 1e-3
        tight += int((atol == 2e-6).sum())
        total += atol.size
        assert (np.abs(got - w) <= atol).all(), \
            f"{name}: max |d| {np.abs(got - w).max()}"
    assert tight >= 0.99 * total


def test_registry_mirrors_reference():
    fields = [f.name for f in dataclasses.fields(JConfig)]
    for name in ("tinyllama-1.1b", "mistral-tiny", "llama-tiny"):
        jspec, tspec = j_get_model(name), t_get_model(name)
        j = jspec.make_model().cfg
        t = tspec.make_model(device="meta").cfg
        for f in fields:
            if f != "dtype":
                assert getattr(j, f) == getattr(t, f), (name, f)
        assert str(jnp.dtype(j.dtype)) == str(t.dtype).split(".")[-1]
        assert j.head_dim == t.head_dim
        assert jspec.default_batch_size == tspec.default_batch_size
        np.testing.assert_array_equal(jspec.make_batch(2)["inputs"],
                                      tspec.make_batch(2)["inputs"])
    j, t = j_get_model("tinyllama-1.1b"), t_get_model("tinyllama-1.1b")
    assert t.train_flops(4) == j.train_flops(4)
    assert abs(t.train_flops(4) - 5.53e13) < 0.01e13
    cfg = t.make_model(device="meta").cfg
    assert t.attn_flops(4, cfg) == j.attn_flops(4, cfg)
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads,
            cfg.num_kv_heads, cfg.vocab_size, cfg.max_position,
            cfg.remat) == (2048, 22, 32, 4, 32000, 2048, True)
    over = t_get_model("tinyllama-1.1b").make_model(
        device="meta", sliding_window=511, num_layers=2).cfg
    assert (over.sliding_window, over.num_layers) == (511, 2)


def test_init_is_seeded_with_unit_norm_scales():
    spec = t_get_model("llama-tiny")
    a = spec.init_params(seed=3, device="cpu", train=True)
    b = spec.init_params(seed=3, device="cpu")
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        if "norm" in n:
            assert p.dtype == q.dtype == torch.float32
            assert bool((p == 1).all())
        else:
            assert q.dtype == torch.bfloat16
            assert torch.equal(p.to(torch.bfloat16), q)
            assert abs(p.std().item() * p.shape[-1] ** 0.5 - 1) < 0.1


@pytest.mark.parametrize("field,value,message", [
    ("kv_cache_int8", True, None),
    ("kv_cache_ring", True, None),
    ("remat_policy", "dots_saveable", "Named remat policies"),
])
def test_unported_options_refused_with_roadmap_names(field, value,
                                                     message):
    """Named remat policies are ported (``test_torch_remat.py``): the
    name builds, and a name the port does not implement is refused.
    ``kv_cache_int8`` and ``kv_cache_ring`` are ported: mistral-tiny
    built with either decodes the reference's tokens (float32, a
    40-token prompt past the window and, for the ring, past
    max_position 256)."""
    over = {field: value}
    if field == "remat_policy":
        over["remat"] = True
        t_get_model("mistral-tiny").make_model(device="cpu", **over)
        over[field] = value + "_everywhere"
        with pytest.raises(ValueError, match=message):
            t_get_model("mistral-tiny").make_model(device="cpu", **over)
        return
    jmodel = j_get_model("mistral-tiny").make_model(dtype=jnp.float32,
                                                    **over)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    tmodel = t_get_model("mistral-tiny").make_model(
        device="cpu", dtype=torch.float32, **over)
    tmodel.load_state_dict(llama_state_dict_from_jax(
        jax.tree.map(np.asarray, variables["params"]), tmodel.cfg))
    p = _tokens(11, (1, 40))
    new = 230 if field == "kv_cache_ring" else 200
    want = np.asarray(JG.generate(jmodel, variables, jnp.asarray(p),
                                  max_new_tokens=new))
    got = TG.generate(tmodel.eval(), p, max_new_tokens=new)
    np.testing.assert_array_equal(got.numpy(), want)


def test_longer_than_max_position_is_refused():
    _, _, _, tmodel = _pair("llama-tiny")
    with pytest.raises(ValueError, match="exceeds max_position"):
        tmodel(torch.zeros((1, 129), dtype=torch.long))
    with pytest.raises(ValueError, match="KV cache"):
        tmodel(torch.zeros((1, 1), dtype=torch.long), decode=True)


def test_tied_embeddings_attend_the_embedding():
    jmodel, variables, params, tmodel = _pair("llama-tiny",
                                              tie_embeddings=True)
    assert "lm_head" not in params and not hasattr(tmodel, "lm_head")
    toks = _tokens(7, (1, 16))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(toks)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert isinstance(tmodel, tllama.LlamaModel)
