"""The serving stack on the Llama family: llama-tiny (GQA 4/2) and
mistral-tiny (GQA 4/2, sliding window 31), float32, with the flax
reference's weights carried across.

- ``DecodeEngine`` on the fixed-lane and the paged pool (eager and
  lazy reservation): greedy and sampled co-tenants, chunked prefill and
  a request admitted mid-run, each EQUAL to the reference's solo
  ``generate`` / ``generate_positional`` (the pools' caches hold
  ``num_kv_heads`` heads; keys rotate at each row's device position);
  budgets run past mistral-tiny's window, so both pools clip it.
- ``serve --cpu --model llama-tiny`` (and mistral-tiny on the paged
  pool) answers /generate over HTTP with the library's tokens.
- ``train`` -> checkpoint -> ``serve --checkpoint`` / ``generate
  --checkpoint`` give the in-memory trained model's tokens.
- ``--kv-ring``, ``--int8-kv`` and ``--int8-weights`` on ``serve`` and
  ``generate`` decode the library's tokens.
"""

from __future__ import annotations

import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from polyaxon_tpu.models import generate as JG
from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu_torch import checkpoint as ckpt_mod
from polyaxon_tpu_torch import train
from polyaxon_tpu_torch.cli import main as cli_main
from polyaxon_tpu_torch.convert import llama_state_dict_from_jax
from polyaxon_tpu_torch.models import generate as TG
from polyaxon_tpu_torch.models.registry import get_model
from polyaxon_tpu_torch.serving import (DecodeEngine, SamplingSpec,
                                        SchedulerPolicy)
from polyaxon_tpu_torch.serving import server as server_mod

torch.set_num_threads(2)

MODELS = ("llama-tiny", "mistral-tiny")
SAMPLED = dict(seed=3, temperature=0.8, top_k=50, top_p=0.95)


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    """(name, flax model, flax variables, port model), float32."""
    name = request.param
    jmodel = j_get_model(name).make_model(dtype=jnp.float32)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    tmodel = get_model(name).make_model(device="cpu", dtype=torch.float32)
    tmodel.load_state_dict(llama_state_dict_from_jax(
        jax.tree.map(np.asarray, variables["params"]), tmodel.cfg))
    return name, jmodel, variables, tmodel.eval().requires_grad_(False)


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 512, (1, n))


def _solo(pair, prompt, new, sampling=None):
    _, jmodel, variables, _ = pair
    p = jnp.asarray(prompt, jnp.int32)
    if sampling is None:
        out = JG.generate(jmodel, variables, p, max_new_tokens=new)
    else:
        out = JG.generate_positional(jmodel, variables, p,
                                     max_new_tokens=new, **sampling)
    return np.asarray(out).tolist()


@pytest.mark.parametrize("pool", ["fixed", "paged", "lazy"])
def test_engine_equals_reference_solo(pair, pool):
    """Greedy and sampled co-tenants (a 36-token prompt decoding past
    mistral-tiny's window, a short sampled one, a third admitted after
    three ticks), chunked prefill of 16: every stream equals the
    reference's solo decode."""
    tmodel = pair[3]
    kw = dict(n_slots=2, decode_window=4, prefill_chunk=16)
    if pool != "fixed":
        kw.update(kv_paged=True, kv_page_tokens=8, kv_lazy=pool == "lazy")
    eng = DecodeEngine(tmodel, autostart=False,
                       policy=SchedulerPolicy(**kw))
    cache_heads = []
    a = eng.submit(_prompt(1, 36), 28, None, None)
    b = eng.submit(_prompt(2, 5), 30, None, None,
                   sampling=SamplingSpec(**SAMPLED))
    for _ in range(3):
        eng.tick()
    cache_heads.append(eng.slots._k.shape[-2])
    c = eng.submit(_prompt(3, 12), 10, None, None)
    eng.run_until_idle()
    assert a.result().tolist() == _solo(pair, _prompt(1, 36), 28)
    assert b.result().tolist() == _solo(pair, _prompt(2, 5), 30, SAMPLED)
    assert c.result().tolist() == _solo(pair, _prompt(3, 12), 10)
    assert cache_heads == [tmodel.cfg.num_kv_heads]


def test_paged_page_bytes_follow_kv_heads(pair):
    tmodel = pair[3]
    eng = DecodeEngine(tmodel, autostart=False, policy=SchedulerPolicy(
        n_slots=2, kv_paged=True, kv_page_tokens=8))
    g = eng.submit(_prompt(4, 9), 3, None, None)
    eng.run_until_idle()
    assert g.result().tolist() == _solo(pair, _prompt(4, 9), 3)
    cfg = tmodel.cfg
    assert tuple(eng.slots._k.shape[2:]) == (8, cfg.num_kv_heads,
                                             cfg.head_dim)


def _start_once(monkeypatch, requests):
    """Patch the CLI server to answer ``requests`` (path, body) once
    and stop; returns the answers."""
    seen = []
    real = server_mod._ServingHTTPServer.serve_forever

    def serve_once(self):
        t = threading.Thread(target=real, args=(self,), daemon=True)
        t.start()
        base = f"http://127.0.0.1:{self.server_address[1]}"
        for path, body in requests:
            if body is None:
                with urllib.request.urlopen(base + path, timeout=60) as r:
                    seen.append(json.loads(r.read()))
                continue
            req = urllib.request.Request(
                base + path, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                seen.append(json.loads(r.read()))
        self.shutdown()
        t.join(timeout=30)

    monkeypatch.setattr(server_mod._ServingHTTPServer, "serve_forever",
                        serve_once)
    return seen


@pytest.mark.parametrize("name,flags", [
    ("llama-tiny", []),
    ("mistral-tiny", ["--kv-paged", "--kv-page-tokens", "16"])])
def test_cli_serve_cpu_answers_over_http(monkeypatch, name, flags):
    prompt = _prompt(5, 40)[0].tolist()
    seen = _start_once(monkeypatch, [
        ("/generate", {"prompt": prompt, "max_new_tokens": 12}),
        ("/generate", {"prompt": prompt, "max_new_tokens": 12,
                       "temperature": 0.7, "seed": 2}),
        ("/info", None)])
    out = CliRunner().invoke(cli_main.cli, [
        "serve", "--model", name, "--cpu", "--port", "0", "--n-slots",
        "2", *flags])
    assert out.exit_code == 0, out.output
    model = get_model(name).init_params(seed=0, device="cpu")
    with torch.no_grad():
        assert seen[0]["tokens"] == TG.generate(
            model, [prompt], max_new_tokens=12).tolist()
        assert seen[1]["tokens"] == TG.generate_positional(
            model, [prompt], max_new_tokens=12, temperature=0.7,
            seed=2).tolist()
    cfg = model.cfg
    assert seen[2]["model"] == name
    assert seen[2]["config"] == {
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
        "num_layers": cfg.num_layers, "num_heads": cfg.num_heads,
        "max_position": cfg.max_position, "kv_cache_int8": False,
        "dtype": "bfloat16"}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train.main`` for 2 steps of llama-tiny on the CPU; returns the
    checkpoint dir and the in-memory trained model."""
    home = tmp_path_factory.mktemp("home")
    live = {}
    real_save = ckpt_mod.CheckpointManager.save

    def save(self, step, state):
        live["model"], live["dir"] = state["params"], self.directory
        return real_save(self, step, state)

    env = {"POLYAXON_TPU_HOME": str(home),
           "POLYAXON_TPU_RUN_UUID": "llama-ckpt-serving"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    ckpt_mod.CheckpointManager.save = save
    try:
        rc = train.main(["--cpu", "--model", "llama-tiny", "--steps", "2",
                         "--batch-size", "2", "--lr", "0.05"])
    finally:
        ckpt_mod.CheckpointManager.save = real_save
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert rc == 0
    model = live["model"].eval()
    fresh = get_model("llama-tiny").init_params(seed=0, device="cpu")
    assert not torch.equal(model.embed.weight.to(torch.bfloat16),
                           fresh.embed.weight), "training changed nothing"
    return live["dir"], model


def test_serve_checkpoint_equals_in_memory_model(trained, monkeypatch):
    ckpt_dir, model = trained
    seen = _start_once(monkeypatch, [
        ("/generate", {"prompt": [9, 8, 7], "max_new_tokens": 6})])
    out = CliRunner().invoke(cli_main.cli, [
        "serve", "--model", "llama-tiny", "--cpu", "--port", "0",
        "--n-slots", "2", "--checkpoint", ckpt_dir])
    assert out.exit_code == 0, out.output
    with torch.no_grad():
        want = TG.generate(model, [[9, 8, 7]], max_new_tokens=6)
    assert seen[0]["tokens"] == want.tolist()
    served = cli_main._build_serving_model("llama-tiny", 1, device="cpu",
                                           ckpt_dir=ckpt_dir)
    assert served.embed.weight.dtype == torch.bfloat16
    assert served.h[0].input_norm.weight.dtype == torch.float32


def test_generate_checkpoint_equals_in_memory_model(trained):
    ckpt_dir, model = trained
    out = CliRunner().invoke(cli_main.cli, [
        "generate", "--model", "llama-tiny", "--prompt", "5,6,7,8",
        "--max-new-tokens", "8", "--checkpoint", ckpt_dir, "--cpu",
        "--temperature", "0.9", "--top-k", "40", "--seed", "4"])
    assert out.exit_code == 0, out.output
    rec = json.loads(out.output.strip().splitlines()[-1])
    with torch.no_grad():
        want = TG.generate_positional(model, [[5, 6, 7, 8]],
                                      max_new_tokens=8, temperature=0.9,
                                      top_k=40, seed=4)
    assert rec["tokens"] == want.tolist()


@pytest.mark.parametrize("command,flag", [
    ("serve", "--kv-ring"), ("serve", "--int8-kv"),
    ("serve", "--int8-weights"), ("generate", "--kv-ring"),
    ("generate", "--int8-kv")])
def test_int8_and_ring_refused_with_roadmap_name(monkeypatch, command,
                                                 flag):
    """The int8 and ring flags are ported: on mistral-tiny ``serve``
    answers /generate and ``generate`` prints the library's tokens from
    the model the flag describes (the ring past max_position 256)."""
    from polyaxon_tpu_torch.ops.quant import quantize_params

    over = {"--kv-ring": {"kv_cache_ring": True},
            "--int8-kv": {"kv_cache_int8": True}}.get(flag, {})
    prompt = _prompt(6, 40)[0].tolist()
    new = 230 if flag == "--kv-ring" else 20
    model = get_model("mistral-tiny").init_params(seed=0, device="cpu",
                                                  **over)
    if flag == "--int8-weights":
        quantize_params(model)
    with torch.no_grad():
        want = TG.generate(model, [prompt], max_new_tokens=new).tolist()
    if command == "serve":
        seen = _start_once(monkeypatch, [
            ("/generate", {"prompt": prompt, "max_new_tokens": new})])
        extra = ["--port", "0", "--n-slots", "2"]
    else:
        extra = ["--prompt", ",".join(map(str, prompt)),
                 "--max-new-tokens", str(new)]
    out = CliRunner().invoke(cli_main.cli, [
        command, "--model", "mistral-tiny", "--cpu", *extra, flag])
    assert out.exit_code == 0, out.output
    got = seen[0] if command == "serve" \
        else json.loads(out.output.strip().splitlines()[-1])
    assert got["tokens"] == want
