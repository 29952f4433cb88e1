"""Serving int8 weights and the int8 KV cache: the port's ``ModelServer``
against the reference's on the same traffic, and the CLI.

- The prefix-cache traffic of ``test_torch_prefix_cache.py`` (a
  registered system prompt, greedy and sampled extensions, a repeat, a
  2-row hit, a miss) through the reference's server and the port's
  under ``--int8-kv`` and ``--int8-weights --int8-kv``, on both pools:
  equal tokens and hit counters, and equal to the port with the prefix
  cache off (a hit carries the int8 scales with the entries).
- ``generate`` and ``serve`` with ``--int8-weights --int8-kv`` decode
  the library's tokens (the weights quantized at the default
  ``min_size``), and ``/info`` reports both options.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from polyaxon_tpu.serving import ModelServer as JServer
from polyaxon_tpu_torch.cli import main as cli_main
from polyaxon_tpu_torch.models import generate as TG
from polyaxon_tpu_torch.models.registry import get_model
from polyaxon_tpu_torch.ops.quant import quantize_params
from polyaxon_tpu_torch.serving import ModelServer

from test_torch_int8_kv import MODES, make_pair
from test_torch_llama_serving import _start_once
from test_torch_prefix_cache import _drive, _traffic

torch.set_num_threads(2)


@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
@pytest.mark.parametrize("mode", ["kv", "both"])
@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_server_equals_reference_server(name, mode, paged):
    jmodel, variables, tmodel = make_pair(name, **MODES[mode])
    kw = dict(n_slots=4, max_batch=4, kv_paged=paged, kv_page_tokens=8)
    reqs = _traffic(name)
    runs = []
    for ms in (JServer(jmodel, variables, model_name=name, **kw),
               ModelServer(tmodel, model_name=name, **kw),
               ModelServer(tmodel, model_name=name, prefix_cache=0,
                           **kw)):
        try:
            runs.append(_drive(ms, reqs if ms.prefix_cache_size else
                               [r for r in reqs if r[0] == "/generate"]))
        finally:
            ms.close()
    (jtoks, jstats), (ttoks, tstats), (cold, _) = runs
    assert ttoks == jtoks
    assert tstats == jstats and tstats["prefix_hits"] == 6
    assert [t for t in ttoks if isinstance(t, list)] == cold


def _library(name, prompt, new, **over):
    model = get_model(name).init_params(seed=0, device="cpu", **over)
    quantize_params(model)
    with torch.no_grad():
        return TG.generate(model, prompt, max_new_tokens=new).tolist()


@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_cli_generate_and_serve_int8(monkeypatch, name):
    prompt = np.random.RandomState(3).randint(0, 512, 12).tolist()
    out = CliRunner().invoke(cli_main.cli, [
        "generate", "--model", name, "--cpu", "--int8-weights",
        "--int8-kv", "--prompt", ",".join(map(str, prompt)),
        "--max-new-tokens", "10"])
    assert out.exit_code == 0, out.output
    rec = json.loads(out.output)
    want = _library(name, [prompt], 10, kv_cache_int8=True)
    assert rec["tokens"] == want
    assert rec["int8_weights"] is True and rec["int8_kv"] is True
    seen = _start_once(monkeypatch, [
        ("/generate", {"prompt": prompt, "max_new_tokens": 10}),
        ("/info", None)])
    out = CliRunner().invoke(cli_main.cli, [
        "serve", "--model", name, "--cpu", "--port", "0", "--n-slots",
        "2", "--int8-weights", "--int8-kv", "--kv-paged",
        "--kv-page-tokens", "16"])
    assert out.exit_code == 0, out.output
    assert seen[0]["tokens"] == want
    assert seen[1]["int8_weights"] is True
    assert seen[1]["config"]["kv_cache_int8"] is True
