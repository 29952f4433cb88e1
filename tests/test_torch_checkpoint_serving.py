"""Serving what was trained, sampled and paged requests over HTTP, and
two repairs of the port.

- ``generate --checkpoint`` and ``serve --checkpoint``: the checkpoint
  ``train.main`` writes on gpt2-tiny gives the tokens of the in-memory
  trained model (its float32 master weights, cast to the serving dtype
  at use), through the CLI and through ``/generate``.
- Sampled ``/generate`` equals the library's ``generate_positional``
  with the same seed; the CLI's sampled ``generate`` takes the same
  schedule; the ``--kv-*`` flags get the reference's checks; ``serve
  --cpu --kv-paged`` serves end to end.
- A request whose budget passes the cache width is refused at submit,
  on both pools, and its co-resident completes (it used to fail with
  the stray request's IndexError).
- ``POLYAXON_TPU_NO_FLASH`` sends attention to the plain path.
"""

from __future__ import annotations

import json
import os
import threading
import urllib.error
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
from polyaxon_tpu_torch.convert import gpt2_state_dict_from_jax
from polyaxon_tpu_torch.models import generate as TG
from polyaxon_tpu_torch.models.gpt2 import GPT2Config, GPT2Model
from polyaxon_tpu_torch.models.registry import get_model
from polyaxon_tpu_torch.ops import attention
from polyaxon_tpu_torch.serving import (DecodeEngine, ModelServer,
                                        SchedulerPolicy, make_server)
from polyaxon_tpu_torch.serving import server as server_mod

torch.set_num_threads(2)


def _start(ms):
    srv = make_server("127.0.0.1", 0, ms)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _post(base, payload, path="/generate", expect=200):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == expect
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        assert e.code == expect, e.read()
        return json.loads(e.read())


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return r.read().decode()


# -- serving a checkpoint -------------------------------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train.main`` for 2 steps of gpt2-tiny on the CPU, its
    checkpoints under a temporary home; returns (checkpoint dir, the
    in-memory trained model)."""
    home = tmp_path_factory.mktemp("home")
    live = {}
    real_save = ckpt_mod.CheckpointManager.save

    def save(self, step, state):
        live["model"] = state["params"]
        live["dir"] = self.directory
        return real_save(self, step, state)

    env = {"POLYAXON_TPU_HOME": str(home),
           "POLYAXON_TPU_RUN_UUID": "ckpt-serving"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    ckpt_mod.CheckpointManager.save = save
    try:
        rc = train.main(["--cpu", "--model", "gpt2-tiny", "--steps", "2",
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
    fresh = get_model("gpt2-tiny").init_params(seed=0, device="cpu")
    assert not torch.equal(model.wte.weight.to(fresh.wte.weight.dtype),
                           fresh.wte.weight), "training changed nothing"
    return live["dir"], model


def test_generate_checkpoint_equals_in_memory_model(trained):
    ckpt_dir, model = trained
    for extra, kw in (([], {}),
                      (["--temperature", "0.9", "--top-k", "40",
                        "--seed", "4"],
                       {"temperature": 0.9, "top_k": 40, "seed": 4})):
        out = CliRunner().invoke(cli_main.cli, [
            "generate", "--model", "gpt2-tiny", "--prompt", "5,6,7,8",
            "--max-new-tokens", "8", "--checkpoint", ckpt_dir, "--cpu",
            *extra])
        assert out.exit_code == 0, out.output
        rec = json.loads(out.output.strip().splitlines()[-1])
        with torch.no_grad():
            if kw:
                want = TG.generate_positional(model, [[5, 6, 7, 8]],
                                              max_new_tokens=8, **kw)
            else:
                want = TG.generate(model, [[5, 6, 7, 8]], max_new_tokens=8)
        assert rec["tokens"] == want.tolist()


def test_served_checkpoint_equals_in_memory_model(trained):
    ckpt_dir, model = trained
    served = cli_main._build_serving_model("gpt2-tiny", 1, device="cpu",
                                           ckpt_dir=ckpt_dir)
    assert served.wte.weight.dtype == served.cfg.dtype
    ms = ModelServer(served, model_name="gpt2-tiny", n_slots=2)
    srv, base = _start(ms)
    try:
        got = _post(base, {"prompt": [[1, 2, 3], [4, 5, 6]],
                           "max_new_tokens": 6})
        with torch.no_grad():
            want = TG.generate(model, [[1, 2, 3], [4, 5, 6]],
                               max_new_tokens=6)
        assert got["tokens"] == want.tolist()
    finally:
        srv.shutdown()
        srv.server_close()
        ms.close()


def test_cli_serve_checkpoint_equals_in_memory_model(trained,
                                                    monkeypatch):
    """``serve --cpu --checkpoint DIR`` answers /generate with the
    in-memory trained model's tokens."""
    ckpt_dir, model = trained
    seen = {}
    real = server_mod._ServingHTTPServer.serve_forever

    def serve_once(self):
        t = threading.Thread(target=real, args=(self,), daemon=True)
        t.start()
        base = f"http://127.0.0.1:{self.server_address[1]}"
        seen["gen"] = _post(base, {"prompt": [9, 8, 7],
                                   "max_new_tokens": 5})
        self.shutdown()
        t.join(timeout=30)

    monkeypatch.setattr(server_mod._ServingHTTPServer, "serve_forever",
                        serve_once)
    out = CliRunner().invoke(cli_main.cli, [
        "serve", "--model", "gpt2-tiny", "--cpu", "--port", "0",
        "--n-slots", "2", "--checkpoint", ckpt_dir])
    assert out.exit_code == 0, out.output
    with torch.no_grad():
        want = TG.generate(model, [[9, 8, 7]], max_new_tokens=5)
    assert seen["gen"]["tokens"] == want.tolist()


def test_checkpoint_without_params_is_a_clean_error(tmp_path):
    empty = tmp_path / "empty"
    out = CliRunner().invoke(cli_main.cli, [
        "generate", "--model", "gpt2-tiny", "--prompt", "1,2",
        "--checkpoint", str(empty), "--cpu"])
    assert out.exit_code != 0 and "No checkpoints under" in out.output
    mgr = ckpt_mod.CheckpointManager(str(tmp_path / "no_params"))
    mgr.save(1, {"step": 1})
    mgr.wait()
    out = CliRunner().invoke(cli_main.cli, [
        "generate", "--model", "gpt2-tiny", "--prompt", "1,2",
        "--checkpoint", mgr.directory, "--cpu"])
    assert out.exit_code != 0
    assert f"checkpoint under {mgr.directory} has no 'params'" in \
        out.output


# -- sampled and paged requests over HTTP -----------------------------------


@pytest.fixture(scope="module")
def tiny_f32():
    return get_model("gpt2-tiny").init_params(seed=0, device="cpu",
                                              dtype=torch.float32)


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_sampled_http_equals_library(tiny_f32, paged):
    ms = ModelServer(tiny_f32, model_name="gpt2-tiny", max_batch=4,
                     n_slots=4, kv_paged=paged, kv_page_tokens=16)
    srv, base = _start(ms)
    reqs = [{"prompt": [[3, 1, 4], [1, 5, 9]], "max_new_tokens": 10,
             "temperature": 0.8, "top_k": 50, "top_p": 0.95, "seed": 1},
            {"prompt": [2, 7, 1, 8], "max_new_tokens": 9},
            {"prompt": [6, 6, 6], "max_new_tokens": 12,
             "temperature": 1.2, "seed": 3}]
    out = [None] * len(reqs)

    def go(i):
        out[i] = _post(base, reqs[i])

    try:
        threads = [threading.Thread(target=go, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for req, resp in zip(reqs, out):
            rows = req["prompt"] if isinstance(req["prompt"][0], list) \
                else [req["prompt"]]
            if req.get("temperature"):
                want = TG.generate_positional(
                    tiny_f32, rows, max_new_tokens=req["max_new_tokens"],
                    seed=req["seed"], temperature=req["temperature"],
                    top_k=req.get("top_k"), top_p=req.get("top_p"))
            else:
                want = TG.generate(tiny_f32, rows,
                                   max_new_tokens=req["max_new_tokens"])
            assert resp["tokens"] == want.tolist()
        info = json.loads(_get(base, "/info"))
        assert info["routing"]["sampled"] == "engine"
        assert info["kv_paged"] is paged
        assert info["admitted_sampled_total"] == 3
        metrics = _get(base, "/metrics")
        assert "ptpu_serving_completed_sampled_total 2" in metrics
        assert ("ptpu_serving_kv_pages_free" in metrics) is paged
    finally:
        srv.shutdown()
        srv.server_close()
        ms.close()


def test_sampled_http_equals_reference():
    """One sampled /generate on gpt2-tiny with the reference's weights
    equals the reference's solo ``generate_positional``."""
    jmodel, variables = j_get_model("gpt2-tiny").init_params(
        batch_size=1, dtype=jnp.float32)
    cfg = GPT2Config(**{**GPT2Config.tiny().__dict__,
                        "dtype": torch.float32})
    tmodel = GPT2Model(cfg, device="cpu")
    tmodel.load_state_dict(gpt2_state_dict_from_jax(
        jax.tree.map(np.asarray, variables["params"]), cfg), strict=True)
    ms = ModelServer(tmodel.eval(), model_name="gpt2-tiny", n_slots=2)
    try:
        got = ms.generate({"prompt": [3, 1, 4, 1], "max_new_tokens": 12,
                           "temperature": 0.9, "top_k": 30, "seed": 6})
    finally:
        ms.close()
    want = JG.generate_positional(jmodel, variables,
                                  np.asarray([[3, 1, 4, 1]], np.int32),
                                  max_new_tokens=12, seed=6,
                                  temperature=0.9, top_k=30)
    assert got["tokens"] == np.asarray(want).tolist()


@pytest.mark.parametrize("body,message", [
    ({"temperature": -0.5}, "temperature must be >= 0"),
    ({"temperature": 0.8, "top_k": 0}, "top_k must be in [1, 1024]"),
    ({"temperature": 0.8, "top_p": 1.5}, "top_p must be in (0, 1]"),
    ({"temperature": 0.8, "seed": "x"}, "sampling params must be"),
    ({"temperature": 0.8, "seed": True}, "sampling params must be"),
])
def test_sampling_params_are_validated(tiny_f32, body, message):
    ms = ModelServer(tiny_f32, n_slots=2)
    try:
        with pytest.raises(ValueError) as e:
            ms.generate({"prompt": [1, 2], "max_new_tokens": 2, **body})
        assert message in str(e.value)
    finally:
        ms.close()


def test_http_kv_pages_shed_is_503(tiny_f32):
    ms = ModelServer(tiny_f32, n_slots=2, kv_paged=True,
                     kv_page_tokens=8, kv_pages=2)
    srv, base = _start(ms)
    try:
        out = _post(base, {"prompt": [1, 2, 3, 4], "max_new_tokens": 30},
                    expect=503)
        assert out["reason"] == "kv_pages"
    finally:
        srv.shutdown()
        srv.server_close()
        ms.close()


@pytest.mark.parametrize("flags,message", [
    (["--kv-page-tokens", "4"], "--kv-page-tokens must be >= 8"),
    (["--kv-paged", "--kv-pages", "0"], "--kv-pages must be >= 1"),
    (["--kv-lazy"], "--kv-lazy requires --kv-paged"),
    (["--kv-paged", "--kv-host-spill-bytes", "1024"],
     "--kv-host-spill-bytes (ROADMAP Queue 1: the spill tier"),
    (["--draft-model", "gpt2-tiny"],
     "--draft-model (ROADMAP Queue 1: beam and speculative decoding)"),
    (["--spec-k", "2"], "--spec-k (ROADMAP Queue 1: beam and"),
])
def test_cli_serve_kv_flags_checked_before_building(monkeypatch, flags,
                                                    message):
    def refuse(*a, **kw):
        raise AssertionError("model built before flag validation")

    monkeypatch.setattr(cli_main, "_build_serving_model", refuse)
    out = CliRunner().invoke(cli_main.cli, [
        "serve", "--model", "gpt2-tiny", "--cpu", *flags])
    assert out.exit_code != 0
    assert message in out.output


def test_cli_serve_cpu_kv_paged_serves(monkeypatch):
    """``serve --cpu --kv-paged --kv-lazy`` end to end: a greedy and a
    sampled /generate through the real handler over the paged pool."""
    seen = {}
    real = server_mod._ServingHTTPServer.serve_forever

    def serve_once(self):
        t = threading.Thread(target=real, args=(self,), daemon=True)
        t.start()
        base = f"http://127.0.0.1:{self.server_address[1]}"
        seen["greedy"] = _post(base, {"prompt": [1, 2, 3],
                                      "max_new_tokens": 5})
        seen["sampled"] = _post(base, {"prompt": [1, 2, 3],
                                       "max_new_tokens": 5,
                                       "temperature": 0.7, "seed": 2})
        seen["metrics"] = _get(base, "/metrics")
        self.shutdown()
        t.join(timeout=30)

    monkeypatch.setattr(server_mod._ServingHTTPServer, "serve_forever",
                        serve_once)
    out = CliRunner().invoke(cli_main.cli, [
        "serve", "--model", "gpt2-tiny", "--cpu", "--port", "0",
        "--n-slots", "2", "--kv-paged", "--kv-page-tokens", "16",
        "--kv-lazy"])
    assert out.exit_code == 0, out.output
    model = get_model("gpt2-tiny").init_params(seed=0, device="cpu")
    assert seen["greedy"]["tokens"] == TG.generate(
        model, [[1, 2, 3]], max_new_tokens=5).tolist()
    assert seen["sampled"]["tokens"] == TG.generate_positional(
        model, [[1, 2, 3]], max_new_tokens=5, temperature=0.7,
        seed=2).tolist()
    assert "ptpu_serving_kv_lazy 1" in seen["metrics"]


def test_cli_generate_sampled_routes_positional():
    out = CliRunner().invoke(cli_main.cli, [
        "generate", "--model", "gpt2-tiny", "--prompt", "1,2,3",
        "--max-new-tokens", "6", "--temperature", "0.8", "--top-p", "0.9",
        "--seed", "5", "--cpu"])
    assert out.exit_code == 0, out.output
    rec = json.loads(out.output.strip().splitlines()[-1])
    model = get_model("gpt2-tiny").init_params(seed=0, device="cpu")
    assert rec["tokens"] == TG.generate_positional(
        model, [[1, 2, 3]], max_new_tokens=6, temperature=0.8, top_p=0.9,
        seed=5).tolist()


# -- repairs -------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_over_wide_budget_refused_at_submit(tiny_f32, paged):
    """The schedule that crashed the engine: A fits, B's prompt + new
    tokens pass max_position (128).  B is refused at submit; A
    completes and equals solo."""
    policy = dict(n_slots=2, decode_window=1)
    if paged:
        policy.update(kv_paged=True, kv_page_tokens=16)
    eng = DecodeEngine(tiny_f32, autostart=False,
                       policy=SchedulerPolicy(**policy))
    a = eng.submit(np.asarray([[1, 2, 3]]), 20, None, None)
    b_prompt = np.random.RandomState(0).randint(0, 1024, (1, 125))
    with pytest.raises(ValueError, match="exceeds the model's "
                                         "max_position"):
        eng.submit(b_prompt, 10, None, None)
    eng.run_until_idle()
    assert a.error is None
    assert a.result().tolist() == TG.generate(
        tiny_f32, [[1, 2, 3]], max_new_tokens=20).tolist()


def test_no_flash_env_routes_to_plain_attention(monkeypatch):
    calls = []
    real = attention._torch_attention

    def spy(*a, **k):
        calls.append("plain")
        return real(*a, **k)

    def no_flash(*a, **k):
        raise AssertionError("flash taken with POLYAXON_TPU_NO_FLASH set")

    q = torch.randn(1, 128, 2, 64)
    monkeypatch.setattr(attention, "_torch_attention", spy)
    flash_out = attention.dot_product_attention(q, q, q, causal=True)
    assert calls == []                  # eligible: the flash route
    monkeypatch.setenv("POLYAXON_TPU_NO_FLASH", "1")
    monkeypatch.setattr(attention, "flash_attention", no_flash)
    out = attention.dot_product_attention(q, q, q, causal=True)
    assert calls == ["plain"]
    torch.testing.assert_close(out, flash_out, atol=1e-5, rtol=0)
