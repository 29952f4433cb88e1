"""Sequence parallelism (ring and Ulysses attention over an ``sp``
gang): the port against the JAX reference on the CPU.

The reference runs as its own tests run it, ``ring_attention`` /
``ulysses_attention`` and its ``TrainStep`` under ``sequence_parallel``
on ``MeshSpec(sp=...)`` over the conftest's virtual host devices; the
port runs as real gloo processes (``run_gang`` of ``test_torch_gang.py``,
several configurations a launch), fed the same numpy-seeded inputs and
the reference's weights converted by ``convert.py``.  Flash routing
differs by package on the CPU: the reference's ``flash_eligible`` is
False there unless ``POLYAXON_TPU_FLASH_INTERPRET`` is set (its Pallas
kernels then run in interpret mode), the port's is True (its plain
versions stand in for the kernels).  So a flash-ring case runs the
reference under ``POLYAXON_TPU_FLASH_INTERPRET=1`` and a plain-ring case
runs both packages under ``POLYAXON_TPU_NO_FLASH=1``.

- (a) an ``sp:4`` gang against ``ring_attention`` /
  ``ulysses_attention``: the plain and the flash ring, causal and not, a
  4-d key-padding mask, windows of 64 and 300 at S = 512 (the flash
  ring's rotations counted against ``r_max``), Ulysses with a headed
  mask and with ``attn_fn`` of three and four arguments; the output and
  dq, dk, dv of a random cotangent within 1e-5 (float32) of the
  largest magnitude of each;
- (b) one ``sp:2`` launch, two AdamW steps of GPT-2 (ring on the flash
  branch, Ulysses on the plain one), windowed Llama (under remat, so the
  backward recomputes the ring), BERT with padding under remat
  (the flash ring's ``narrow_kv_mask``), MoE-GPT, T5 (biased
  self-attention local with the reference's warning, the unbiased
  cross-attention of equal lengths on the ring) and ViT (197 tokens'
  stand-in, 17: the local fallback) against the reference's
  ``TrainStep``: losses and ``grad_norm`` rtol 1e-5, parameters by
  ``test_torch_gang.py``'s Adam rule;
- (c) ``dp:2,sp:2`` and ``sp:2,tp:2`` GPT-2 in the same four-rank
  launch as (a) (the module's ``sp4_gang``); and ``train.main
  --strategy sp:2 --sp-mode ulysses`` of gpt2-mini as four ranks equal
  to one process;
- (d) one process: ``_sp_route``'s decisions and warnings, the
  refusals of ``ring_attention`` / ``ulysses_attention`` with the
  reference's messages, the route read at call time (a step built
  before activation takes it), a remat block's recompute on another
  thread taking its forward's route, a remat block keeping none of the
  ring's rotated blocks, and the pipeline refusals before any weight
  is built.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu.ops.attention import sequence_parallel as j_sequence_parallel
from polyaxon_tpu.parallel import MeshSpec, build_mesh
from polyaxon_tpu.parallel import make_train_step as j_make_train_step
from polyaxon_tpu.parallel.ring import ring_attention as j_ring
from polyaxon_tpu.parallel.ulysses import _plain_attention as j_plain
from polyaxon_tpu.parallel.ulysses import ulysses_attention as j_ulysses
from polyaxon_tpu.train import make_optimizer as j_make_optimizer
from polyaxon_tpu_torch import train as ttrain
from polyaxon_tpu_torch.models.registry import get_model as t_get_model
from polyaxon_tpu_torch.ops import attention as tattn
from polyaxon_tpu_torch.parallel import mesh as tmesh
from polyaxon_tpu_torch.parallel import strategies as tstrat
from test_torch_gang import ROOT, _assert_params, run_gang
from test_torch_tp import CONVERT, LR, _scale_q, gang_runs

torch.set_num_threads(2)

B, S, H, D = 2, 512, 4, 64


class _Logged(logging.Handler):
    """The messages the named loggers emit inside the block."""

    def __init__(self, *names):
        super().__init__(logging.WARNING)
        self.names, self.messages = names, []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def __enter__(self):
        for name in self.names:
            logging.getLogger(name).addHandler(self)
        return self.messages

    def __exit__(self, *exc):
        for name in self.names:
            logging.getLogger(name).removeHandler(self)


LOGGERS = ("polyaxon_tpu.ops.attention", "polyaxon_tpu_torch.ops.attention")

# Each case: (name, function, kwargs, env) -- "flash" runs the
# reference's kernels in interpret mode, "plain" both packages with the
# flash kill-switch.  ``mask``: "pad" a [B, 1, 1, S] key padding,
# "headed" a [B, H, S, S] mask; ``attn_fn``: "three" / "four" the
# plain inner attention (scale 0.1, non-causal) as a custom kernel.
ATTENTION_CASES = [
    ("ring_plain_causal", "ring", dict(causal=True), "plain"),
    ("ring_plain", "ring", dict(causal=False), "plain"),
    ("ring_flash_causal", "ring", dict(causal=True), "flash"),
    ("ring_flash", "ring", dict(causal=False), "flash"),
    ("ring_flash_pad", "ring", dict(causal=True, mask="pad"), "flash"),
    ("ring_plain_pad", "ring", dict(causal=False, mask="pad"), "plain"),
    ("ring_flash_window64", "ring", dict(causal=True, window=64), "flash"),
    ("ring_flash_window300", "ring", dict(causal=True, window=300),
     "flash"),
    ("ring_plain_window300", "ring", dict(causal=True, window=300),
     "plain"),
    ("ulysses_flash_causal", "ulysses", dict(causal=True), "flash"),
    ("ulysses_flash_window64", "ulysses", dict(causal=True, window=64),
     "flash"),
    ("ulysses_headed_mask", "ulysses", dict(causal=False, mask="headed"),
     "plain"),
    ("ulysses_attn_fn_three", "ulysses", dict(attn_fn="three"), "plain"),
    ("ulysses_attn_fn_four", "ulysses", dict(attn_fn="four",
                                             mask="pad"), "plain"),
]


def _attention_inputs(rng):
    q, k, v, do = (rng.standard_normal((B, S, H, D)).astype(np.float32)
                   for _ in range(4))
    lengths = np.array([300, 77])
    pad = (np.arange(S)[None, :] < lengths[:, None])[:, None, None, :]
    headed = rng.random((B, H, S, S)) > 0.2
    headed[0, 1, 5] = False              # a fully masked row
    return dict(q=q, k=k, v=v, do=do, pad=pad, headed=headed)


def _reference_attention(fn, kw, inputs, mesh):
    kw = dict(kw)
    if "mask" in kw:
        kw["mask"] = jnp.asarray(inputs[kw["mask"]])
    if kw.get("attn_fn") == "three":
        kw["attn_fn"] = lambda q, k, v: j_plain(q, k, v, causal=False,
                                                scale=0.1)
    elif kw.get("attn_fn") == "four":
        kw["attn_fn"] = lambda q, k, v, m: j_plain(q, k, v, m,
                                                   causal=False, scale=0.1)
    f = j_ring if fn == "ring" else j_ulysses

    @jax.jit
    def forward_backward(q, k, v, do):
        o, vjp = jax.vjp(lambda q, k, v: f(q, k, v, mesh, **kw), q, k, v)
        return (o,) + vjp(do)

    return tuple(np.asarray(a) for a in forward_backward(
        *(jnp.asarray(inputs[n]) for n in ("q", "k", "v", "do"))))


def _close(got, want, what):
    """Within 1e-5 of the largest magnitude of ``want`` (float32)."""
    got = np.asarray(got, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * scale, f"{what}: max |d| {err} (scale {scale})"


@pytest.fixture(scope="module")
def sp4_gang(tmp_path_factory):
    """The four-rank launch that (a) and (c) share: the attention cases
    (one run of ``SP_WORKER``) and ``dp:2,sp:2`` / ``sp:2,tp:2`` GPT-2
    tiny.  Returns the attention inputs, each rank's attention results,
    and the training runs' outputs with the reference's results."""
    tmp = tmp_path_factory.mktemp("sp4")
    inputs = _attention_inputs(np.random.default_rng(0))
    cases = []
    for name, fn, kw, env in ATTENTION_CASES:
        data = tmp / f"{name}.npz"
        arrays = {n: inputs[n] for n in ("q", "k", "v", "do")}
        if "mask" in kw:
            arrays["mask"] = inputs[kw["mask"]]
        np.savez(data, **arrays)
        cases.append(dict(name=name, fn=fn, kw=kw, env=env, data=str(data)))
    runs, refs = [dict(cases=cases, out=str(tmp / "attention"))], []
    with pytest.MonkeyPatch.context() as mp:
        for tag, strategy in (("dpsp", {"dp": 2, "sp": 2}),
                              ("sptp", {"dp": 1, "sp": 2, "tp": 2})):
            r, w = _sp_runs(tmp, [SP4_CASE], strategy, mp, tag)
            runs += r
            refs += w
    outs = gang_runs(tmp, runs, 4, worker=SP_WORKER, timeout=150.0)
    return {"inputs": inputs, "attention": outs[0], "runs": outs[1:],
            "refs": refs}


def test_ring_and_ulysses_attention_equal_the_references(sp4_gang,
                                                         monkeypatch):
    """(a) Every case of ``ATTENTION_CASES`` on an ``sp:4`` gang: each
    rank's output and dq, dk, dv equal the reference's; the flash ring
    rotates ``r_max = min(sp - 1, ceil(window / block))`` times with a
    window, sp - 1 without."""
    inputs, ranks = sp4_gang["inputs"], sp4_gang["attention"]
    mesh = build_mesh(MeshSpec(dp=1, sp=4), devices=jax.devices()[:4])
    want = {}
    for name, fn, kw, env in ATTENTION_CASES:
        _flash_env(env, monkeypatch)
        want[name] = _reference_attention(fn, kw, inputs, mesh)
    s_blk = S // 4
    for name, fn, kw, env in ATTENTION_CASES:
        for r, rank in enumerate(ranks):
            got = rank[name]
            for key, w in zip(("o", "dq", "dk", "dv"), want[name]):
                _close(got[key].numpy(), w, f"{name} rank {r} {key}")
            window = kw.get("window")
            turns = 0 if fn == "ulysses" else 3 if window is None or \
                env == "plain" else min(3, -(-window // s_blk))
            assert got["rotations"] == turns, (name, got["rotations"])
    assert ranks[0]["ring_flash_window64"]["rotations"] == 1
    assert ranks[0]["ring_flash_window300"]["rotations"] == 3


# Each run: the port model from converted weights, the strategy over the
# gang under ``sequence_parallel``, AdamW steps on this rank's rows;
# saved: the metrics, the gathered final parameters, the attention
# routes taken and the sequence-parallel warnings logged.  A run with
# ``cases`` instead runs ``ATTENTION_CASES`` on an ``sp:4`` mesh: each
# case's output, dq, dk, dv and the flash ring's forward rotations.
SP_WORKER = r"""
import json, logging, os, sys
import numpy as np, torch
torch.set_num_threads(1)
from polyaxon_tpu_torch.models.registry import get_model
from polyaxon_tpu_torch.ops.attention import _torch_attention, sequence_parallel
from polyaxon_tpu_torch.parallel import (MeshSpec, build_mesh,
    make_train_step, ring, ulysses)
from polyaxon_tpu_torch.parallel.bootstrap import initialize_from_env
from polyaxon_tpu_torch.parallel.strategies import gather_shard
from polyaxon_tpu_torch.train import make_optimizer

rotations = [0]
real_permute = ring.ring_permute

def hop(*a, **k):
    if k.get("shift", 1) == 1:      # the forward's hops, not the reverse
        rotations[0] += 1
    return real_permute(*a, **k)

ring.ring_permute = hop
attn_fns = {
    "three": lambda q, k, v: _torch_attention(q, k, v, None, False, 0.1),
    "four": lambda q, k, v, m: _torch_attention(q, k, v, m, False, 0.1)}

def attention(run):
    mesh = build_mesh(MeshSpec(dp=1, sp=4), device="cpu")
    out = {}
    for case in run["cases"]:
        if case["env"] == "plain":
            os.environ["POLYAXON_TPU_NO_FLASH"] = "1"
        else:
            os.environ.pop("POLYAXON_TPU_NO_FLASH", None)
        data = np.load(case["data"])
        q, k, v = (torch.tensor(data[n], requires_grad=True)
                   for n in ("q", "k", "v"))
        kw = dict(case["kw"])
        if "mask" in kw:
            kw["mask"] = torch.as_tensor(data["mask"])
        if "attn_fn" in kw:
            kw["attn_fn"] = attn_fns[kw["attn_fn"]]
        fn = ring.ring_attention if case["fn"] == "ring" else \
            ulysses.ulysses_attention
        rotations[0] = 0
        o = fn(q, k, v, mesh, **kw)
        turns = rotations[0]
        o.backward(torch.as_tensor(data["do"]))
        out[case["name"]] = {"o": o.detach(), "dq": q.grad, "dk": k.grad,
                             "dv": v.grad, "rotations": turns}
    torch.save(out, f"{run['out']}.{topo.process_id}.pt")

warnings, routes = [], {"ring": 0, "ulysses": 0}

class Keep(logging.Handler):
    def emit(self, record):
        warnings.append(record.getMessage())

logging.getLogger("polyaxon_tpu_torch.ops.attention").addHandler(Keep())
for mod, name in ((ring, "ring_attention"), (ulysses, "ulysses_attention")):
    def counted(*a, _real=getattr(mod, name), _key=name.split("_")[0], **k):
        routes[_key] += 1
        return _real(*a, **k)
    setattr(mod, name, counted)

def padded_loss(model):
    # BERT's logits over a key-padded batch: token cross-entropy.
    def loss(batch, rng=None):
        x = batch["inputs"]
        logits = model(x, attention_mask=batch["attention_mask"],
                       train=True)
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]).float(),
            x.reshape(-1).long()), {}
    return loss

topo = initialize_from_env(device="cpu")
for run in json.load(open(sys.argv[1])):
    if "cases" in run:
        attention(run)
        continue
    if run["no_flash"]:
        os.environ["POLYAXON_TPU_NO_FLASH"] = "1"
    else:
        os.environ.pop("POLYAXON_TPU_NO_FLASH", None)
    spec = get_model(run["model"])
    model = spec.init_params(seed=1, device="cpu", train=True,
                             dtype=torch.float32, **run["over"])
    model.load_state_dict(torch.load(run["weights"]), strict=True)
    mesh = build_mesh(MeshSpec.from_dict(run["strategy"]), device="cpu")
    loss_fn = padded_loss(model) if run["padded"] else spec.loss_fn(model)
    warnings.clear()
    routes.update(ring=0, ulysses=0)
    # Built before activation: the eager step reads the route per call.
    step = make_train_step(loss_fn, make_optimizer("adamw", run["lr"]),
                           mesh)
    state = step.init_state(model)
    batch = dict(np.load(run["batch"]))
    local = {k: torch.as_tensor(step.batch_sharding.shard(v))
             for k, v in batch.items()}
    metrics = []
    with sequence_parallel(mesh, run["sp_mode"]):
        for i in range(run["steps"]):
            state, m = step(state, local)
            metrics.append({k: float(v) for k, v in m.items()})
    full = {n: gather_shard(model, n, t) if n in step.shards else t
            for n, t in model.state_dict().items()}
    torch.save({"metrics": metrics, "state": full, "routes": dict(routes),
                "warnings": sorted(set(warnings))},
               f"{run['out']}.{topo.process_id}.pt")
print("ok", flush=True)
"""

# name, sp mode, model overrides, tokens a row, flash ("flash": the
# reference in interpret mode; else both packages on the plain path),
# the attention route each rank must take.  GPT-2 and BERT at one head
# of 64 and 256 tokens put the ring's 128-token blocks on the flash
# branch; the others' 16-wide heads take the plain one.
SP2 = [
    ("gpt2-tiny", "ring", {"num_heads": 1, "max_position": 256}, 256,
     "flash", "ring"),
    ("gpt2-tiny", "ulysses", {}, 64, "plain", "ulysses"),
    ("llama-tiny", "ring", {"sliding_window": 20, "remat": True}, 64,
     "plain", "ring"),
    ("bert-tiny", "ring", {"num_heads": 1, "max_position": 256,
                           "remat": True}, 256, "flash", "ring"),
    ("moe-gpt-tiny", "ring", {}, 64, "plain", "ring"),
    ("t5-tiny", "ring", {}, 64, "plain", "ring"),
    ("vit-tiny", "ulysses", {}, None, "plain", None),
]


# (c)'s GPT-2 case, on ``dp:2,sp:2`` and on ``sp:2,tp:2``.
SP4_CASE = ("gpt2-tiny", "ring", {}, 64, "plain", "ring")


def _sp_case(name, over, seq, rows=4):
    """(flax model, variables, port state dict, numpy batch) in float32
    with the config ``over``rides; ``seq`` tokens a row (random), BERT's
    rows key-padded to 256, 200, 130 and 77 tokens."""
    jspec = j_get_model(name)
    jmodel = jspec.make_model(dtype=jnp.float32, **over)
    batch = dict(jspec.make_batch(rows))
    if seq is not None:
        vocab = jmodel.cfg.vocab_size
        batch["inputs"] = np.random.RandomState(3).randint(
            0, vocab, (rows, seq))
    if name == "bert-tiny":
        batch["attention_mask"] = (np.arange(seq)[None, :] < np.array(
            [256, 200, 130, 77])[:, None]).astype(np.int32)
    variables = jmodel.init(jax.random.PRNGKey(0), batch["inputs"])
    params = jax.tree.map(np.asarray, variables["params"])
    if name == "t5-tiny":
        params = _scale_q(params, 16 ** -0.5)
        variables = {"params": params}
    cfg = t_get_model(name).make_model(device="meta", **over).cfg
    return jmodel, variables, CONVERT[name](params, cfg), batch


def _j_padded_loss(model):
    def loss(params, batch, rng):
        x = batch["inputs"]
        logits = model.apply(params, x,
                             attention_mask=batch["attention_mask"],
                             train=True)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        return -jnp.take_along_axis(logp, x[..., None], -1).mean(), {}
    return loss


def _sp_reference(name, jmodel, variables, batch, steps, mode, *, dp=1,
                  sp=2, tp=1, padded=False):
    """The reference's TrainStep (AdamW) on ``MeshSpec(dp, sp, tp)``
    under ``sequence_parallel``; (metrics, params, sp warnings)."""
    mesh = build_mesh(MeshSpec(dp=dp, sp=sp, tp=tp),
                      devices=jax.devices()[:dp * sp * tp])
    loss = _j_padded_loss(jmodel) if padded else \
        j_get_model(name).loss_fn(jmodel)
    with jax.default_matmul_precision("highest"), \
            j_sequence_parallel(mesh, mode, force=True), \
            _Logged(LOGGERS[0]) as logged:
        step = j_make_train_step(loss, j_make_optimizer("adamw", LR),
                                 mesh, donate=False)
        state = step.init_state(variables)
        metrics = []
        for _ in range(steps):
            state, m = step(state, batch, None)
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree.map(np.asarray, state["params"]), \
        sorted(set(logged))


def _sp_check(name, out, want_m, want_p, over, keys=("loss", "grad_norm")):
    cfg = t_get_model(name).make_model(device="meta", **over).cfg
    want_sd = CONVERT[name](want_p["params"], cfg)
    for rank in out:
        for g, w in zip(rank["metrics"], want_m, strict=True):
            for k in keys:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                           err_msg=f"{name} {k}")
        _assert_params(rank["state"], {k: v for k, v in want_sd.items()
                                       if k in rank["state"]},
                       adam_lr=LR, steps=len(want_m))


def _sp_runs(tmp_path, cases, strategy, monkeypatch, tag=""):
    """The port's runs of ``cases`` and the reference's results."""
    runs, refs = [], []
    for i, (name, mode, over, seq, env, _) in enumerate(cases):
        jmodel, variables, sd, batch = _sp_case(name, over, seq)
        weights, data = (tmp_path / f"w{tag}{i}.pt",
                         tmp_path / f"b{tag}{i}.npz")
        torch.save(sd, weights)
        np.savez(data, **batch)
        runs.append(dict(model=name, over=over, weights=str(weights),
                         batch=str(data), strategy=strategy, lr=LR,
                         steps=2, sp_mode=mode, no_flash=env == "plain",
                         padded=name == "bert-tiny",
                         out=str(tmp_path / f"r{tag}{i}")))
        _flash_env(env, monkeypatch)
        refs.append(_sp_reference(name, jmodel, variables, batch, 2, mode,
                                  padded=name == "bert-tiny",
                                  **{a: strategy.get(a, 1)
                                     for a in ("dp", "sp", "tp")}))
    monkeypatch.delenv("POLYAXON_TPU_FLASH_INTERPRET", raising=False)
    monkeypatch.delenv("POLYAXON_TPU_NO_FLASH", raising=False)
    return runs, refs


def _flash_env(env, monkeypatch):
    if env == "plain":
        monkeypatch.delenv("POLYAXON_TPU_FLASH_INTERPRET", raising=False)
        monkeypatch.setenv("POLYAXON_TPU_NO_FLASH", "1")
    else:
        monkeypatch.delenv("POLYAXON_TPU_NO_FLASH", raising=False)
        monkeypatch.setenv("POLYAXON_TPU_FLASH_INTERPRET", "1")


def test_sp2_gang_trains_the_zoo_as_the_reference(tmp_path, monkeypatch):
    """(b) Two AdamW steps of each ``SP2`` case on ``sp:2``: the losses,
    ``grad_norm`` and parameters of every rank equal the reference's;
    every layer's attention takes the case's route (T5: the decoder's
    cross-attention, two layers a forward, on the ring; its biased
    self-attention local, with the reference's warning; ViT's 17 tokens
    local, with its warning)."""
    runs, refs = _sp_runs(tmp_path, SP2, {"dp": 1, "sp": 2}, monkeypatch)
    outs = gang_runs(tmp_path, runs, 2, worker=SP_WORKER, timeout=150.0)
    for (name, mode, over, seq, env, route), out, (want_m, want_p, logged) \
            in zip(SP2, outs, refs):
        _sp_check(name, out, want_m, want_p, over)
        for rank in out:
            # Two steps, two layers each, run again by remat's
            # recompute; T5's cross-attention only.
            expect = {"ring": 0, "ulysses": 0}
            if route is not None:
                expect[route] = 2 * 2 * (2 if over.get("remat") else 1)
            assert rank["routes"] == expect, (name, rank["routes"])
            assert rank["warnings"] == logged, (name, rank["warnings"],
                                                logged)
        if name == "t5-tiny":
            assert logged == ["sequence_parallel: additive attention bias "
                              "is not supported by the ring/Ulysses "
                              "schedules; falling back to local attention "
                              "for this call"]
        elif name == "vit-tiny":
            assert logged == ["sequence_parallel: seq 17 not divisible by "
                              "sp 2; falling back to local attention"]
        else:
            assert logged == [], (name, logged)


def test_dp_sp_and_sp_tp_gangs_train_as_the_reference(tmp_path, sp4_gang,
                                                      monkeypatch):
    """(c) GPT-2 tiny on four ranks, ``dp:2,sp:2`` and ``sp:2,tp:2`` (the
    ring over each tp rank's 2 local heads), equal to the reference's;
    then ``python -m polyaxon_tpu_torch.train --cpu
    --model gpt2-mini --strategy sp:2 --sp-mode ulysses`` as four ranks
    (dp 2 x sp 2) logs the one-process run's losses and checkpoints its
    parameters (the Adam rule)."""
    from polyaxon_tpu_torch.checkpoint import CheckpointManager
    from test_torch_gang_run import TRAIN, _losses, _same_losses

    for out, (want_m, want_p, _) in zip(sp4_gang["runs"], sp4_gang["refs"],
                                        strict=True):
        _sp_check("gpt2-tiny", out, want_m, want_p, {})
        for rank in out:
            assert rank["routes"] == {"ring": 2 * 2, "ulysses": 0}

    monkeypatch.setenv("POLYAXON_TPU_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    for name in ("POLYAXON_TPU_RUN_UUID", "PTPU_STRATEGY"):
        monkeypatch.delenv(name, raising=False)
    args = ["--model", "gpt2-mini", "--steps", "2", "--log-every", "1",
            "--batch-size", "4"]
    (tmp_path / "gang").mkdir()
    (tmp_path / "one").mkdir()
    gang = run_gang(TRAIN + args + ["--strategy", "sp:2", "--sp-mode",
                                    "ulysses"], 4, tmp_path / "gang")
    one = subprocess.run(
        TRAIN + args, cwd=str(tmp_path / "one"), capture_output=True,
        text=True, timeout=120, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert one.returncode == 0, one.stdout[-3000:] + one.stderr[-3000:]
    want = _losses(one.stdout)
    for out in gang:
        _same_losses(_losses(out), want)
    g = CheckpointManager(str(tmp_path / "gang" / "checkpoints")).restore()
    w = CheckpointManager(str(tmp_path / "one" / "checkpoints")).restore()
    assert g["step"] == w["step"] == 2
    _assert_params(g["params"], w["params"], adam_lr=1e-3, steps=2)


class _FakeMesh:
    """What the route reads of a mesh: its axis sizes."""

    def __init__(self, **axes):
        self.shape = dict({a: 1 for a in tmesh.AXIS_ORDER}, **axes)


# q, k, mask shapes ([B, S, H, D] / [B, ...]) and the sp mode: seq
# indivisible, q and k apart, a 3-d mask, a mask that does not broadcast,
# Ulysses over heads or mask heads that do not divide sp (to the ring),
# and the cases that stay sequence-parallel.
ROUTES = [
    ((2, 30, 4, 8), (2, 30, 4, 8), None, "ring"),
    ((2, 32, 4, 8), (2, 64, 4, 8), None, "ring"),
    ((2, 32, 4, 8), (2, 32, 4, 8), (2, 32, 32), "ring"),
    ((2, 32, 4, 8), (2, 32, 4, 8), (2, 1, 16, 32), "ring"),
    ((2, 32, 3, 8), (2, 32, 3, 8), None, "ulysses"),
    ((2, 32, 4, 8), (2, 32, 4, 8), (2, 3, 32, 32), "ulysses"),
    ((2, 32, 4, 8), (2, 32, 4, 8), (2, 1, 1, 32), "ulysses"),
    ((2, 32, 4, 8), (2, 32, 4, 8), (2, 4, 32, 32), "ring"),
    ((2, 32, 4, 8), (2, 32, 4, 8), None, "ulysses"),
]


def test_sp_route_decisions_and_warnings_are_the_references():
    """(d) ``_sp_route`` on ``ROUTES`` at sp 2: the same decision (local,
    ring or Ulysses) and the same warning text as the reference's; no
    route without an active context, and none over an sp axis of 1."""
    from polyaxon_tpu.ops import attention as jattn

    for q, k, mask, mode in ROUTES:
        got = []
        for mod, arr in ((jattn, np.zeros), (tattn, torch.zeros)):
            with _Logged(*LOGGERS) as logged, mod.sequence_parallel(
                    _FakeMesh(sp=2), mode, force=True):
                route = mod._sp_route(arr(q), arr(k), arr(k),
                                      None if mask is None else arr(mask),
                                      True, None)
            got.append((None if route is None else route[1], logged))
        assert got[0] == got[1], (q, k, mask, mode, got)
    assert got[1] == ("ulysses", [])
    assert tattn._sp_route(torch.zeros(q), torch.zeros(k), None, None,
                           True, None) is None
    with tattn.sequence_parallel(_FakeMesh(sp=1), "ring"):
        assert getattr(tattn._SP_STATE, "ctx", None) is None
    with pytest.raises(ValueError, match="unknown sequence-parallel mode "
                       "'zigzag'"):
        tattn.activate_sequence_parallel(_FakeMesh(sp=2), "zigzag")


# fn, q heads, kwargs (``mask``: its shape), for each refusal.
MESSAGES = [
    ("ring", 4, dict(causal=False, window=8)),
    ("ring", 4, dict(window=0)),
    ("ring", 4, dict(mask=(2, 32))),
    ("ulysses", 3, {}),
    ("ulysses", 4, dict(mask=(2, 32, 32))),
    ("ulysses", 4, dict(mask=(2, 3, 32, 32))),
    ("ulysses", 4, dict(causal=False, window=8)),
    ("ulysses", 4, dict(window=0)),
    ("ulysses", 4, dict(window=8, attn_fn="three")),
]


@pytest.mark.parametrize("fn,heads,kw", MESSAGES)
def test_attention_refusals_carry_the_references_messages(fn, heads, kw):
    """``ring_attention`` and ``ulysses_attention`` refuse what the
    reference's refuse, before any collective, with its message."""
    from polyaxon_tpu_torch.parallel import ring, ulysses

    mesh = build_mesh(MeshSpec(dp=1, sp=2), devices=jax.devices()[:2])
    got = []
    for mod, arr, f, m in (
            ("j", jnp.zeros, j_ring if fn == "ring" else j_ulysses, mesh),
            ("t", torch.zeros, ring.ring_attention if fn == "ring"
             else ulysses.ulysses_attention, _FakeMesh(sp=2))):
        args = dict(kw)
        if "mask" in args:
            args["mask"] = arr(args["mask"], dtype=bool if mod == "j"
                               else torch.bool)
        if "attn_fn" in args:
            args["attn_fn"] = lambda q, k, v: q
        with pytest.raises(ValueError) as e:
            f(*(arr((2, 32, heads, 8)) for _ in range(3)), m, **args)
        got.append(str(e.value))
    assert got[0] == got[1], got


def test_biased_attention_stays_local_with_the_references_warning():
    """A bias under an active context: the local result and the
    reference's warning."""
    from polyaxon_tpu.ops import attention as jattn

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 32, 2, 8, generator=g) for _ in range(3))
    bias = torch.randn(1, 2, 32, 32, generator=g)
    want = tattn.dot_product_attention(q, k, v, bias=bias, causal=True)
    logs = []
    for mod, args in ((tattn, (q, k, v)), (jattn, tuple(
            jnp.asarray(t.numpy()) for t in (q, k, v)))):
        with _Logged(*LOGGERS) as logged, mod.sequence_parallel(
                _FakeMesh(sp=2), "ring", force=True):
            b = bias if mod is tattn else jnp.asarray(bias.numpy())
            out = mod.dot_product_attention(*args, bias=b, causal=True)
        logs.append(logged)
    assert logs[0] == logs[1] and len(logs[0]) == 1, logs
    np.testing.assert_allclose(np.asarray(out), want.numpy(), atol=1e-5)


def test_a_step_built_before_activation_takes_the_sp_route(monkeypatch):
    """The port reads the route at each call (the reference refuses to
    activate while compiled steps exist, their traces keeping local
    attention): a GPT-2 tiny ``TrainStep`` built and stepped before
    activation routes every layer's attention through the ring once
    activated, and leaves it again after."""
    from polyaxon_tpu_torch.parallel import make_train_step, ring

    calls = []

    def recorded(q, k, v, mesh, **kw):
        calls.append(tuple(q.shape))
        return tattn._torch_attention(q, k, v, kw.get("mask"),
                                      kw["causal"], q.shape[-1] ** -0.5)

    monkeypatch.setattr(ring, "ring_attention", recorded)
    spec = t_get_model("gpt2-tiny")
    model = spec.init_params(seed=0, device="cpu", train=True,
                             dtype=torch.float32)
    step = make_train_step(spec.loss_fn(model),
                           ttrain.make_optimizer("adamw", 1e-3))
    state = step.init_state(model)
    batch = {"inputs": torch.as_tensor(spec.make_batch(2)["inputs"])}
    state, _ = step(state, batch)
    assert calls == []
    with tattn.sequence_parallel(_FakeMesh(sp=2), "ring"):
        state, m = step(state, batch)
    assert calls == [(2, 64, 4, 16)] * 2 and np.isfinite(float(m["loss"]))
    step(state, batch)
    assert len(calls) == 2


def test_remat_recompute_takes_the_forwards_route_on_another_thread(
        monkeypatch):
    """A recomputed (remat) block's forward runs again in the backward,
    which for a CUDA tensor runs on the autograd engine's device thread,
    where this thread's sequence-parallel context is not set: the
    recompute must take the route its forward took.  Llama tiny under
    remat, the forward under the context, the backward on another
    thread: the ring (recorded, computing the local result) runs in the
    forward and again in the recompute, and the gradients equal a
    forward and backward with no context at all."""
    import threading

    from polyaxon_tpu_torch.parallel import ring

    calls = []

    def recorded(q, k, v, mesh, **kw):
        calls.append(threading.current_thread().name)
        return tattn._torch_attention(q, k, v, kw.get("mask"),
                                      kw["causal"], q.shape[-1] ** -0.5)

    monkeypatch.setattr(ring, "ring_attention", recorded)
    monkeypatch.setenv("POLYAXON_TPU_NO_FLASH", "1")
    spec = t_get_model("llama-tiny")
    x = torch.as_tensor(spec.make_batch(2)["inputs"])
    grads = []
    for sp in (True, False):
        model = spec.init_params(seed=0, device="cpu", train=True,
                                 dtype=torch.float32, remat=True)
        with tattn.sequence_parallel(_FakeMesh(sp=2 if sp else 1), "ring"):
            loss = model(x).float().square().mean()
        worker = threading.Thread(target=loss.backward, name="backward")
        worker.start()
        worker.join()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    assert calls == ["MainThread"] * 2 + ["backward"] * 2, calls
    for n, g in grads[0].items():
        torch.testing.assert_close(g, grads[1][n], rtol=0, atol=0)


@pytest.mark.parametrize("no_flash", ["", "1"], ids=["flash", "plain"])
def test_a_remat_block_keeps_none_of_the_rings_blocks(no_flash,
                                                      monkeypatch):
    """The ring's node keeps its local graph's tensors through its own
    ``save_for_backward``: under a recomputed (remat) block, nothing of
    the ring's K/V blocks outlives the forward, and the output and the
    gradients equal the unrecomputed ring's bitwise (one rank, the flash
    and the plain body, causal with a window); unrecomputed, the flash
    body keeps its block for the backward."""
    import gc

    from torch.multiprocessing.reductions import StorageWeakRef
    from torch.utils.checkpoint import checkpoint

    from polyaxon_tpu_torch.parallel import ring

    monkeypatch.setenv("POLYAXON_TPU_NO_FLASH", no_flash)
    kept = []
    rotate = ring._rotate

    def recorded(*a, **k):
        blocks = rotate(*a, **k)
        kept.extend(StorageWeakRef(b.untyped_storage()) for b in blocks)
        return blocks

    monkeypatch.setattr(ring, "_rotate", recorded)
    mesh = tmesh.build_mesh(tmesh.MeshSpec(dp=1, sp=1), device="cpu")
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 256, 2, 64, generator=g, requires_grad=True)
               for _ in range(3))
    do = torch.randn(2, 256, 2, 64, generator=g)

    def attend(q, k, v):
        return ring.ring_attention(q, k, v, mesh, causal=True, window=100)

    got = []
    for remat in (False, True):
        kept.clear()
        o = checkpoint(attend, q, k, v, use_reentrant=False) if remat \
            else attend(q, k, v)
        gc.collect()
        alive = [not ref.expired() for ref in kept]
        assert alive == [not remat and not no_flash], (remat, alive)
        o.backward(do)
        got.append([o.detach()] + [t.grad.clone() for t in (q, k, v)])
        for t in (q, k, v):
            t.grad = None
    for a, b in zip(*got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("strategy,match", [
    ("pp:2,sp:2,fsdp:2", "strategy combines pp>1 with sp>1, which is "
                         "not supported: pipeline stages compose with "
                         "dp/fsdp"),
    ("pp:2,ep:2", "strategy combines pp>1 with ep>1, which is not "
                  "supported: pipeline stages compose with dp/fsdp"),
    ("pp:2,sp:2", "strategy combines pp>1 with sp>1, which is not "
                  "supported: pipeline stages compose with dp/fsdp"),
], ids=[  # the cases' earlier ids
    r"pp:2,fsdp:2-Parallelism and meshes, item \(d\)",
    "pp:2,ep:2-strategy combines pp>1 with ep>1, which is not supported: "
    "pipeline stages compose with dp/fsdp",
    "pp:2,sp:2-strategy combines pp>1 with sp>1, which is not supported: "
    "pipeline stages compose with dp/fsdp"])
def test_unported_sp_compositions_refused_before_weights(strategy, match,
                                                         monkeypatch):
    """sp composes with fsdp and ep (``test_torch_compose.py``), a
    pipeline with fsdp (``test_torch_pipeline.py``); a pipeline beside
    ep or sp (fsdp beside them too) is refused by the reference's
    message, before the process group, the mesh or any weight; the
    train step refuses the same meshes with the same rule
    (``strategies.pipeline_refusal``)."""
    from polyaxon_tpu_torch.models import registry
    from polyaxon_tpu_torch.parallel import bootstrap

    def refuse(*a, **k):
        raise AssertionError("built before the refusal")

    monkeypatch.setattr(registry, "get_model", refuse)
    monkeypatch.setattr(bootstrap, "initialize_from_env", refuse)
    with pytest.raises(SystemExit, match=match):
        ttrain.main(["--cpu", "--model", "gpt2-tiny", "--strategy",
                     strategy, "--sp-mode", "ulysses"])
    axes = ttrain.parse_strategy(strategy)
    mesh = _FakeMesh(**{a: 2 for a in axes})
    with pytest.raises(NotImplementedError, match=match):
        tstrat.check_mesh(mesh)
