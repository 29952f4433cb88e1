"""The port's HTTP model server (``serving/server.py``) and ``serve`` CLI.

An in-process server on an ephemeral port over gpt2-tiny (float32, the
port's own seeded weights); requests go through real HTTP.  Every
greedy response equals the library's solo ``generate``.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from polyaxon_tpu_torch.cli import main as cli_main
from polyaxon_tpu_torch.models import generate as TG
from polyaxon_tpu_torch.models.registry import get_model
from polyaxon_tpu_torch.serving import ModelServer, make_server
from polyaxon_tpu_torch.serving import server as server_mod

torch.set_num_threads(2)


def _model():
    return get_model("gpt2-tiny").init_params(seed=0, device="cpu",
                                              dtype=torch.float32)


def _start(ms):
    srv = make_server("127.0.0.1", 0, ms)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def server():
    model = _model()
    ms = ModelServer(model, model_name="gpt2-tiny", max_batch=4)
    srv, base = _start(ms)
    yield base, model, ms
    srv.shutdown()
    srv.server_close()
    ms.close()


def _post(base, payload, path="/generate", expect=200):
    body = payload if isinstance(payload, bytes) \
        else json.dumps(payload).encode()
    req = urllib.request.Request(
        base + path, data=body,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == expect
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        assert e.code == expect, e.read()
        return json.loads(e.read())


def _get(base, path, expect=200):
    try:
        with urllib.request.urlopen(base + path, timeout=30) as r:
            assert r.status == expect
            body = r.read()
    except urllib.error.HTTPError as e:
        assert e.code == expect
        body = e.read()
    return body.decode()


def _solo(model, rows, new, eos=None):
    return TG.generate(model, np.asarray(rows), max_new_tokens=new,
                       eos_id=eos).tolist()


@pytest.mark.parametrize("path", ["/healthz", "/info", "/metrics",
                                  "/trace", "/debug/state", "/requests"])
def test_read_routes_answer(server, path):
    base, _, _ = server
    _post(base, {"prompt": [4, 4], "max_new_tokens": 2})
    body = _get(base, path)
    if path == "/metrics":
        for name in ("ptpu_serving_requests_total",
                     "ptpu_serving_queue_seconds_sum",
                     "ptpu_serving_prefill_seconds_sum",
                     "ptpu_serving_decode_seconds_sum",
                     "ptpu_serving_decode_steps_total",
                     "ptpu_serving_compile_cache_misses_total"):
            assert name in body
        return
    doc = json.loads(body)
    if path == "/healthz":
        assert doc["status"] == "ok" and doc["model"] == "gpt2-tiny"
    elif path == "/info":
        assert doc["config"]["vocab_size"] == 1024
        assert doc["backend"] == "cpu"
        assert doc["batching"] == "continuous"
        assert doc["routing"]["greedy"] == "engine"
    elif path == "/trace":
        names = {e["name"] for e in doc["traceEvents"]}
        assert {"queue", "prefill", "decode", "step"} <= names
    elif path == "/debug/state":
        assert doc["engine"]["n_slots"] == 8
    else:
        assert doc["requests"] and doc["requests"][0]["status"]


def test_generate_matches_library(server):
    base, model, _ = server
    out = _post(base, {"prompt": [5, 6, 7, 8], "max_new_tokens": 6,
                       "eos_id": 3})
    assert out["tokens"] == _solo(model, [[5, 6, 7, 8]], 6, eos=3)
    assert len(out["new_tokens"][0]) == 6
    rec = json.loads(_get(base, f"/requests/{out['request_id']}"))
    assert rec["status"] == "complete" and rec["kind"] == "greedy"


def test_concurrent_http_greedy_matches_solo(server):
    base, model, _ = server
    reqs = [([4, 4, 4, 4], 5), ([1, 2, 3], 7), ([9, 8, 7, 6, 5, 4], 4),
            ([[2, 3], [3, 2]], 6)]
    results = [None] * len(reqs)

    def go(i):
        prompt, new = reqs[i]
        results[i] = _post(base, {"prompt": prompt,
                                  "max_new_tokens": new})

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for (prompt, new), got in zip(reqs, results):
        rows = prompt if isinstance(prompt[0], list) else [prompt]
        assert got["tokens"] == _solo(model, rows, new)


BAD_BODIES = {
    "empty": {},
    "ragged": {"prompt": [[1, 2], [3]]},
    "zero_new": {"prompt": [1], "max_new_tokens": 0},
    "max_batch": {"prompt": [[1, 2]] * 10},
    "max_position": {"prompt": [1] * 120, "max_new_tokens": 50},
    "scalar_prompt": {"prompt": 5},
    "list_body": [1, 2],
    "list_top_k": {"prompt": [1, 2], "top_k": [5]},
    "bool_tokens": {"prompt": [True, False]},
    "null_new": {"prompt": [1, 2], "max_new_tokens": None},
    "chunk_zero": {"prompt": [1, 2], "prefill_chunk": 0},
    "beam_sampled": {"prompt": [1, 2], "num_beams": 2,
                     "temperature": 0.9},
    "bad_priority": {"prompt": [1, 2], "priority": "urgent"},
    "not_json": b"{not json",
}


@pytest.mark.parametrize("name", sorted(BAD_BODIES))
def test_malformed_bodies_are_400(server, name):
    base, _, _ = server
    out = _post(base, BAD_BODIES[name], expect=400)
    assert out["error"]
    if name == "max_batch":
        assert "max_batch" in out["error"]
    if name == "max_position":
        assert "max_position" in out["error"]
    if name == "bool_tokens":
        assert "integer token ids" in out["error"]


@pytest.mark.parametrize("field", ["max_new_tokens", "num_beams", "top_k",
                                   "seed", "temperature", "top_p"])
def test_boolean_scalar_params_are_400(server, field):
    base, _, _ = server
    assert "error" in _post(base, {"prompt": [1, 2], field: True},
                            expect=400)


@pytest.mark.parametrize("body,feature", [
    ({"temperature": 0.8, "top_p": 0.9, "seed": 7}, "sampled decoding"),
    ({"num_beams": 2}, "beam search"),
    ({"speculative": True}, "speculative decoding"),
    ({"spec_k": 3}, "speculative decoding"),
])
def test_unported_requests_are_501(server, body, feature):
    base, _, _ = server
    out = _post(base, {"prompt": [1, 2], "max_new_tokens": 2, **body},
                expect=501)
    assert feature in out["error"] and "not ported" in out["error"]
    assert out["reason"] == "not_ported"


@pytest.mark.parametrize("path", ["/prefill", "/prefix/fetch",
                                  "/profile/start", "/profile/stop"])
def test_unported_routes_are_501(server, path):
    base, _, _ = server
    out = _post(base, {"prompt": [1, 2]}, path=path, expect=501)
    assert "not ported" in out["error"]


def test_unknown_routes_are_404(server):
    base, _, _ = server
    assert "no route" in _get(base, "/nope", expect=404)
    assert "no route" in _post(base, {}, path="/nope", expect=404)["error"]


def test_drain_turns_readiness_off_and_finishes_in_flight():
    model = _model()
    ms = ModelServer(model, model_name="gpt2-tiny", n_slots=2)
    srv, base = _start(ms)
    result = {}

    def go():
        result["out"] = _post(base, {"prompt": [3, 1, 4],
                                     "max_new_tokens": 5})

    try:
        with ms._lock:              # stall the engine mid-request
            th = threading.Thread(target=go)
            th.start()
            for _ in range(100):
                if len(ms.engine.queue) >= 1:
                    break
                threading.Event().wait(0.05)
            assert len(ms.engine.queue) == 1
            drained = _post(base, {}, path="/drain")
            assert drained["draining"] is True
            health = json.loads(_get(base, "/healthz", expect=503))
            assert health["status"] == "unavailable"
            assert health["reason"] == "draining"
            shed = _post(base, {"prompt": [1, 2]}, expect=503)
            assert shed["reason"] == "draining"
        th.join(timeout=60)
        assert result["out"]["tokens"] == _solo(model, [[3, 1, 4]], 5)
        assert "ptpu_serving_drain_rejected_total 1" in ms.metrics_text()
    finally:
        srv.shutdown()
        srv.server_close()
        ms.close()


def test_cli_serve_cpu_serves(monkeypatch):
    """``serve --cpu`` builds the model and serves it: the patched
    serve_forever answers one /healthz and one /generate through the
    real handler, then returns."""
    seen = {}
    real = server_mod._ServingHTTPServer.serve_forever

    def serve_once(self):
        t = threading.Thread(target=real, args=(self,), daemon=True)
        t.start()
        base = f"http://127.0.0.1:{self.server_address[1]}"
        seen["health"] = json.loads(_get(base, "/healthz"))
        seen["gen"] = _post(base, {"prompt": [1, 2, 3],
                                   "max_new_tokens": 4})
        self.shutdown()
        t.join(timeout=30)

    monkeypatch.setattr(server_mod._ServingHTTPServer, "serve_forever",
                        serve_once)
    out = CliRunner().invoke(cli_main.cli, [
        "serve", "--model", "gpt2-tiny", "--cpu", "--port", "0",
        "--n-slots", "2", "--decode-window", "4"])
    assert out.exit_code == 0, out.output
    assert "serving gpt2-tiny on http://127.0.0.1:" in out.output
    assert seen["health"]["status"] == "ok"
    model = get_model("gpt2-tiny").init_params(seed=0, device="cpu")
    assert seen["gen"]["tokens"] == _solo(model, [[1, 2, 3]], 4)


@pytest.mark.parametrize("flags,message", [
    (["--n-slots", "0"], "--n-slots must be >= 1"),
    (["--decode-window", "0"], "--decode-window must be >= 1"),
    (["--prefill-chunk", "0"], "--prefill-chunk must be >= 1"),
    (["--request-timeout", "0"], "--request-timeout must be > 0"),
])
def test_cli_serve_rejects_bad_flags_before_building(monkeypatch, flags,
                                                     message):
    def refuse(*a, **kw):
        raise AssertionError("model built before flag validation")

    monkeypatch.setattr(cli_main, "_build_serving_model", refuse)
    out = CliRunner().invoke(cli_main.cli, [
        "serve", "--model", "gpt2-tiny", "--cpu", *flags])
    assert out.exit_code != 0
    assert message in out.output


def test_cli_serve_needs_cuda_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA card")
    out = CliRunner().invoke(cli_main.cli, [
        "serve", "--model", "gpt2-tiny", "--port", "0"])
    assert out.exit_code != 0 and "--cpu" in out.output
