"""The server's ``speculative`` and ``num_beams`` requests, and the CLI's
``--draft-model`` / ``--beams`` flags, held against the JAX package.

The same requests go through the reference's ``ModelServer`` and the
port's (gpt2-tiny, float32, the flax weights carried across; the draft
a 1-layer gpt2-tiny): greedy and sampled speculative requests in the
engine's spec slots on both pools, a spec_k over the cap and a budget
near max_position (both solo), beam search (solo), and the validation
400s.  Responses' tokens are held EQUAL.  Then ``/info`` routing, the
``ptpu_serving_spec_accept_rate`` family on ``/metrics``, and ``serve
--cpu --draft-model`` answering a speculative request over HTTP with
the library's tokens.
"""

from __future__ import annotations

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from polyaxon_tpu.serving import ModelServer as JServer
from polyaxon_tpu_torch.cli import main as cli_main
from polyaxon_tpu_torch.models import generate as TG
from polyaxon_tpu_torch.models.registry import get_model
from polyaxon_tpu_torch.serving import ModelServer
from polyaxon_tpu_torch.serving import server as server_mod

from test_torch_speculative import _jax_model, _port

torch.set_num_threads(2)

# (name, request): what both servers answer with the same tokens.
REQUESTS = [
    ("spec_greedy", {"prompt": [5, 6, 7, 8], "max_new_tokens": 12,
                     "speculative": True}),
    ("spec_sampled", {"prompt": [[1, 2, 3], [4, 5, 6]],
                      "max_new_tokens": 10, "speculative": True,
                      "spec_k": 2, "temperature": 0.9, "top_k": 40,
                      "seed": 3}),
    ("spec_over_cap", {"prompt": [9, 9, 2], "max_new_tokens": 8,
                       "speculative": True, "spec_k": 5,
                       "temperature": 0.7, "seed": 1}),
    ("near_capacity", {"prompt": [3] * 100, "max_new_tokens": 26}),
    ("plain_sampled", {"prompt": [7, 1], "max_new_tokens": 9,
                       "temperature": 1.0, "seed": 2}),
    ("beam", {"prompt": [[2, 4, 6], [1, 3, 5]], "max_new_tokens": 6,
              "num_beams": 3}),
]
BAD = {
    "spec_beam": {"speculative": True, "num_beams": 2},
    "spec_top_k_greedy": {"speculative": True, "top_k": 5},
    "spec_k_zero": {"speculative": True, "spec_k": 0},
    "spec_not_bool": {"speculative": "true"},
    "spec_slack": {"prompt": [1] * 100, "max_new_tokens": 26,
                   "speculative": True},
}


@pytest.fixture(scope="module")
def pair():
    jt, vt = _jax_model("gpt2-tiny")
    jd, vd = _jax_model("gpt2-tiny", seed=7, num_layers=1)
    return (jt, vt, _port("gpt2-tiny", jt, vt)), (jd, vd,
                                                  _port("gpt2-tiny", jd, vd))


def _servers(pair, **kw):
    (jt, vt, tt), (jd, vd, td) = pair
    kw = dict(n_slots=4, max_batch=4, spec_k=4, **kw)
    return (JServer(jt, vt, draft_model=jd, draft_variables=vd, **kw),
            ModelServer(tt, draft_model=td, **kw))


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
def test_responses_equal_reference_server(pair, paged):
    kw = dict(kv_paged=True, kv_page_tokens=8) if paged else {}
    runs = []
    for ms in _servers(pair, **kw):
        try:
            runs.append({name: ms.generate(dict(req))["tokens"]
                         for name, req in REQUESTS})
            stats = ms.info()
            runs[-1]["fallbacks"] = sorted(stats["solo_fallbacks"])
            runs[-1]["spec"] = (stats["admitted_spec_total"],
                                stats["completed_spec_total"])
        finally:
            ms.close()
    want, got = runs
    assert got == want
    assert got["fallbacks"] == ["near-capacity",
                                "speculative (spec_k over cap)"]
    # The engine answered the two in-cap spec requests: 3 rows
    # admitted, 2 requests completed.
    assert got["spec"] == (3, 2)


def test_spec_and_beam_equal_library(pair):
    (_, _, tt), (_, _, td) = pair
    ms = ModelServer(tt, draft_model=td, n_slots=4, spec_k=4)
    try:
        out = ms.generate({"prompt": [5, 6, 7, 8], "max_new_tokens": 12,
                           "speculative": True})
        assert out["tokens"] == TG.generate(tt, [[5, 6, 7, 8]],
                                            max_new_tokens=12).tolist()
        out = ms.generate(dict(REQUESTS[1][1]))
        assert out["tokens"] == TG.generate_speculative(
            tt, td, [[1, 2, 3], [4, 5, 6]], max_new_tokens=10, k=2,
            temperature=0.9, top_k=40, seed=3).tolist()
        out = ms.generate(dict(REQUESTS[-1][1]))
        assert out["tokens"] == TG.generate_beam(
            tt, [[2, 4, 6], [1, 3, 5]], max_new_tokens=6,
            num_beams=3).tolist()
        info = ms.info()
        assert info["routing"]["speculative"] == "engine"
        assert info["routing"]["beam"] == "solo"
        text = ms.metrics_text()
        assert "# TYPE ptpu_serving_spec_accept_rate histogram" in text
        # one observation per completed speculative row (1 + 2)
        assert "ptpu_serving_spec_accept_rate_count 3" in text
        assert "ptpu_serving_spec_rounds_total" in text
    finally:
        ms.close()


@pytest.mark.parametrize("name", sorted(BAD))
def test_bad_spec_requests_equal_reference_messages(pair, name):
    msgs = []
    for ms in _servers(pair):
        try:
            with pytest.raises(ValueError) as info:
                ms.generate({"prompt": [1, 2], "max_new_tokens": 4,
                             **BAD[name]})
            msgs.append(str(info.value))
        finally:
            ms.close()
    assert msgs[1] == msgs[0]


def test_no_draft_server_routes_and_refuses(pair):
    (_, _, tt), _ = pair
    ms = ModelServer(tt, n_slots=2)
    try:
        assert ms.info()["routing"]["speculative"] == \
            "unavailable (no draft model)"
        with pytest.raises(ValueError, match="no draft model"):
            ms.generate({"prompt": [1, 2], "speculative": True})
    finally:
        ms.close()


def test_cli_serve_draft_model_answers_speculative(monkeypatch):
    """``serve --cpu --model gpt2-tiny --draft-model gpt2-tiny --spec-k
    3``: a greedy and a sampled speculative /generate over HTTP equal
    the library's tokens with the same random-init weights."""
    seen = []
    real = server_mod._ServingHTTPServer.serve_forever
    bodies = [{"prompt": [1, 2, 3], "max_new_tokens": 8,
               "speculative": True},
              {"prompt": [4, 5], "max_new_tokens": 8, "speculative": True,
               "temperature": 0.8, "seed": 9}]

    def serve_once(self):
        t = threading.Thread(target=real, args=(self,), daemon=True)
        t.start()
        base = f"http://127.0.0.1:{self.server_address[1]}"
        for body in bodies:
            req = urllib.request.Request(
                base + "/generate", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                seen.append(json.loads(r.read()))
        self.shutdown()
        t.join(timeout=30)

    monkeypatch.setattr(server_mod._ServingHTTPServer, "serve_forever",
                        serve_once)
    out = CliRunner().invoke(cli_main.cli, [
        "serve", "--cpu", "--model", "gpt2-tiny", "--port", "0",
        "--draft-model", "gpt2-tiny", "--spec-k", "3"])
    assert out.exit_code == 0, out.output
    model = get_model("gpt2-tiny").init_params(seed=0, device="cpu")
    assert seen[0]["tokens"] == TG.generate(model, [[1, 2, 3]],
                                            max_new_tokens=8).tolist()
    assert seen[1]["tokens"] == TG.generate_speculative(
        model, model, [[4, 5]], max_new_tokens=8, k=3, temperature=0.8,
        seed=9).tolist()


def test_cli_generate_spec_flag_checks():
    for flags, msg in ((["--draft-checkpoint", "x"],
                        "--draft-checkpoint requires --draft-model"),
                       (["--draft-model", "gpt2-tiny", "--beams", "2"],
                        "cannot combine with beam search"),
                       (["--beams", "2", "--temperature", "0.5"],
                        "beam search is deterministic")):
        out = CliRunner().invoke(cli_main.cli, [
            "generate", "--cpu", "--model", "gpt2-tiny", "--prompt",
            "1,2", *flags])
        assert out.exit_code != 0 and msg in out.output
