"""The port's legacy batching modes (``serving/legacy.py``,
``ModelServer(batching="coalesce" | "off")``) against the JAX package's
``ModelServer`` on gpt2-tiny with converted weights, float32.

- The same greedy requests of one prompt length, queued while the
  device lock is held so that one leader drains them all: equal tokens
  in both packages and in both modes, equal to solo ``generate``, and
  equal ``coalesced_batches`` / ``coalesced_requests`` counters.
- Multi-row greedy, sampled and beam requests decode solo in the
  engine-less modes with the reference's tokens (the sampled one the
  engine's too); ``/info``'s routing and counters are the reference's.
- The CLI and the constructor refuse the combinations the reference
  refuses (``--kv-paged`` or ``--profile-every`` without continuous
  batching), with the reference's words.
"""

from __future__ import annotations

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu.serving import ModelServer as JServer
from polyaxon_tpu_torch.cli import main as cli_main
from polyaxon_tpu_torch.convert import gpt2_state_dict_from_jax
from polyaxon_tpu_torch.models import generate as TG
from polyaxon_tpu_torch.models.registry import get_model
from polyaxon_tpu_torch.serving import BATCHING_MODES, ModelServer

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair():
    jmodel = j_get_model("gpt2-tiny").make_model(dtype=jnp.float32)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    tmodel = get_model("gpt2-tiny").make_model(device="cpu",
                                               dtype=torch.float32)
    tmodel.load_state_dict(gpt2_state_dict_from_jax(
        jax.tree.map(np.asarray, variables["params"]), tmodel.cfg))
    return jmodel, variables, tmodel.eval().requires_grad_(False)


def _reqs(n=4, p_len=6, seed=0):
    rng = np.random.RandomState(seed)
    return [{"prompt": rng.randint(1, 1000, p_len).tolist(),
             "max_new_tokens": 5 + i} for i in range(n)]


def _coalesced(ms, reqs, n_pending):
    """Every request from its own thread while the device lock is held,
    released once all of them are queued: one leader then drains the
    whole queue into ONE merged batch (deterministic in both
    packages)."""
    out = [None] * len(reqs)

    def go(i):
        out[i] = ms.generate(reqs[i])

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(reqs))]
    ms._lock.acquire()
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10
        while n_pending(ms) < len(reqs):
            assert time.monotonic() < deadline, "requests never queued"
            time.sleep(0.005)
    finally:
        ms._lock.release()
    for t in threads:
        t.join(timeout=60)
    return [r["new_tokens"] for r in out]


def _pending(ms):
    with ms._coalescer._pending_lock:
        return sum(len(q) for q in ms._coalescer._pending.values())


def _solo(tmodel, reqs):
    return [TG.generate(tmodel, [r["prompt"]],
                        max_new_tokens=r["max_new_tokens"])[
        :, len(r["prompt"]):].tolist() for r in reqs]


def test_coalesce_merges_like_the_reference(pair):
    jmodel, variables, tmodel = pair
    reqs = _reqs()
    ours = ModelServer(tmodel, model_name="gpt2-tiny", batching="coalesce",
                       max_batch=8)
    theirs = JServer(jmodel, variables, model_name="gpt2-tiny",
                     batching="coalesce", max_batch=8)
    try:
        got = _coalesced(ours, reqs, _pending)
        want = _coalesced(theirs, reqs, _pending)
        assert got == want == _solo(tmodel, reqs)
        for key in ("coalesced_batches", "coalesced_requests",
                    "requests", "batching", "routing"):
            assert ours.info()[key] == theirs.info()[key], key
        assert ours.coalesced_batches == 1
        assert ours.coalesced_requests == len(reqs)
    finally:
        ours.close()
        theirs.close()


@pytest.mark.parametrize("mode", ["coalesce", "off"])
def test_engine_less_modes_serve_every_request_kind(pair, mode):
    """Greedy (several rows), sampled and beam requests in the
    engine-less modes give the reference's tokens (the sampled one,
    decoded by the position-keyed solo program, the engine's too); no
    engine, no paged pool, the reference's /info."""
    jmodel, variables, tmodel = pair
    ours = ModelServer(tmodel, model_name="gpt2-tiny", batching=mode)
    theirs = JServer(jmodel, variables, model_name="gpt2-tiny",
                     batching=mode)
    engine = ModelServer(tmodel, model_name="gpt2-tiny", n_slots=2)
    samp = {"prompt": [5, 6, 7], "max_new_tokens": 6, "temperature": 0.8,
            "top_k": 50, "top_p": 0.95, "seed": 3}
    try:
        assert ours.engine is None and not ours.kv_paged
        for req in ({"prompt": [[1, 2, 3], [4, 5, 6]], "max_new_tokens": 5},
                    {"prompt": [9, 8, 7], "max_new_tokens": 4,
                     "num_beams": 2}, samp):
            got = ours.generate(dict(req))["tokens"]
            assert got == theirs.generate(dict(req))["tokens"]
            if req is samp:
                assert got == engine.generate(dict(req))["tokens"]
        for key in ("batching", "routing", "coalesced_batches",
                    "coalesced_requests", "kv_paged", "requests"):
            assert ours.info()[key] == theirs.info()[key], key
        with pytest.raises(ValueError, match="requires the continuous"):
            ours.generate({"prompt": [1, 2, 3], "resume_tokens": 1})
        assert ours.drain()["slots_active"] == 0
        assert "ptpu_serving_coalesced_batches_total" in \
            ours.metrics_text()
    finally:
        ours.close()
        theirs.close()
        engine.close()


def test_constructor_refusals_match_reference(pair, tmp_path):
    jmodel, variables, tmodel = pair
    assert BATCHING_MODES == ("continuous", "coalesce", "off")
    for kw in ({"batching": "coalesce", "kv_paged": True},
               {"batching": "bogus"},
               {"batching": "off", "stall_timeout_s": 1.0}):
        with pytest.raises(ValueError) as ours:
            ModelServer(tmodel, **kw)
        with pytest.raises(ValueError) as theirs:
            JServer(jmodel, variables, **kw)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="requires the continuous"):
        ModelServer(tmodel, batching="off", profile_every=2,
                    profile_dir=str(tmp_path))
    # The old boolean maps onto the modes it selected.
    ms = ModelServer(tmodel, coalesce=False)
    try:
        assert ms.batching == "off" and ms._coalescer is None
    finally:
        ms.close()


@pytest.mark.parametrize("flags", [
    ["--batching", "coalesce", "--kv-paged"],
    ["--batching", "off", "--profile-every", "4", "--profile-dir", "p"],
])
def test_cli_refuses_what_the_reference_refuses(flags):
    from polyaxon_tpu.cli.main import cli as jcli

    ours = CliRunner().invoke(cli_main.cli, [
        "serve", "--cpu", "--model", "gpt2-tiny", *flags])
    theirs = CliRunner().invoke(jcli, [
        "serve", "--model", "gpt2-tiny", *flags])
    assert ours.exit_code == theirs.exit_code == 1
    assert ours.output == theirs.output
    assert "--batching continuous" in ours.output
