"""Gangs of the port's processes against the JAX reference, on the CPU.

The reference runs as its own tests run it, on the conftest's virtual
host devices in this process; the port runs as real gloo processes
(``torch.distributed``, started by ``parallel.bootstrap`` from the
PTPU_* block), fed the same numpy-seeded batches and the reference's
weights converted by ``convert.py``.  Every gang has its own deadline: a
fresh free port, ``PTPU_INIT_TIMEOUT`` 60 s for the group, a subprocess
timeout of 120 s, and a kill of the leftovers.

- A ``dp:2`` gang's 3 SGD steps on gpt2-tiny give the reference's
  ``TrainStep`` losses and final parameters on ``MeshSpec(dp=2)``, and a
  one-process port run's on the same global batch.
- A ``dp:2`` and a ``dp:1, fsdp:2`` gang do the same with Adam; the fsdp
  gang shards exactly the placement function's parameters.
- Under ``dp:2`` bert-tiny's MLM loss and ``masked_tokens`` equal the
  reference's (the mask drawn over the global batch, its count global)
  and resnet50-tiny's loss and batch-norm running averages equal the
  reference's ``dp=2`` step.
- The three two-rank training tests above share one launch (the
  module's ``dp_gang``), each checking its own runs.
- A four-rank (dp 2 x fsdp 2) gang holds each collective to its
  definition (values and gradients), ``hierarchical_all_reduce`` to the
  flat all-reduce, the health probe to "4 devices healthy", and the
  sharded eval to the one-process accuracy on digits.

Tolerances (float32 on both sides): losses rtol 1e-5; running averages
1e-5 of the tensor's largest value; SGD parameters
atol 1e-5 against the reference, 1e-6 against one process (the
gradient mean of two halves rounds apart from the full batch's); Adam
parameters 2e-6 for at least 99% of elements and Adam's step bound
(2 lr a step) for the rest: Adam's update lr * m / (sqrt(v) + eps) turns
a rounding difference of a gradient near eps into an update difference
of about lr (the QKV bias's key slice, zero in exact arithmetic,
``tests/test_torch_train.py``).
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu.parallel import MeshSpec, build_mesh
from polyaxon_tpu.parallel import make_train_step as j_make_train_step
from polyaxon_tpu.parallel.strategies import make_param_shardings
from polyaxon_tpu.train import make_optimizer as j_make_optimizer
from polyaxon_tpu_torch import prng
from polyaxon_tpu_torch import train as ttrain
from polyaxon_tpu_torch.convert import gpt2_state_dict_from_jax
from polyaxon_tpu_torch.models.registry import get_model as t_get_model
from polyaxon_tpu_torch.parallel import make_train_step
from test_torch_zoo import _close, _pair, _port_sd

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def gang_env(n: int, rank: int, port: int, **extra) -> dict:
    """The PTPU_* block of rank ``rank`` of an ``n``-process gang on this
    host, with the test deadlines."""
    env = dict(os.environ)
    for key in ("POLYAXON_TPU_RUN_UUID", "POLYAXON_TPU_HOST",
                "PTPU_STRATEGY"):
        env.pop(key, None)
    env.update({
        "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
        "PTPU_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
        "PTPU_NUM_PROCESSES": str(n), "PTPU_PROCESS_ID": str(rank),
        "PTPU_INIT_TIMEOUT": "60", "PTPU_SLICE_HEALTH_TIMEOUT": "30"})
    env.update(extra)
    return env


def run_gang(argv, n: int, cwd, *, env=None, timeout: float = 120.0):
    """Start ``argv`` as an ``n``-process gang, wait for it, kill what is
    left at the deadline, and return each rank's output; every rank
    must exit 0."""
    port = free_port()
    procs = [subprocess.Popen(
        argv, cwd=str(cwd), env=gang_env(n, r, port, **(env or {})),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True) for r in range(n)]
    outs = [""] * n
    deadline = time.monotonic() + timeout
    try:
        for r, proc in enumerate(procs):
            outs[r], _ = proc.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    for r, proc in enumerate(procs):
        assert proc.returncode == 0, \
            f"rank {r} exited {proc.returncode}:\n{outs[r][-4000:]}"
    return outs


# One worker script for every training gang: each run of the JSON
# config builds the port model from the converted weights, lays the
# strategy over the gang, takes the steps on this rank's rows of the
# global batch and saves the metrics and the full final state.
TRAIN_WORKER = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from polyaxon_tpu_torch import prng
from polyaxon_tpu_torch.models.registry import get_model
from polyaxon_tpu_torch.parallel import MeshSpec, build_mesh, make_train_step
from polyaxon_tpu_torch.parallel.bootstrap import initialize_from_env
from polyaxon_tpu_torch.train import make_optimizer
from torch.distributed.checkpoint.state_dict import (
    StateDictOptions, get_model_state_dict)

topo = initialize_from_env(device="cpu")
for run in json.load(open(sys.argv[1])):
    spec = get_model(run["model"])
    model = spec.init_params(seed=1, device="cpu", train=True,
                             dtype=torch.float32, **run.get("over", {}))
    model.load_state_dict(torch.load(run["weights"]), strict=True)
    mesh = build_mesh(MeshSpec.from_dict(run["strategy"]), device="cpu")
    step = make_train_step(spec.loss_fn(model),
                           make_optimizer(run["optimizer"], run["lr"]),
                           mesh, fsdp_min_size=run.get("fsdp_min_size",
                                                       2 ** 16))
    state = step.init_state(model)
    batch = dict(np.load(run["batch"]))
    local = {k: torch.as_tensor(step.batch_sharding.shard(v))
             for k, v in batch.items()}
    metrics = []
    for i in range(run["steps"]):
        rng = None if run.get("rng") is None else \
            prng.fold_in(prng.PRNGKey(run["rng"]), i)
        state, m = step(state, local, rng)
        metrics.append({k: float(v) for k, v in m.items()})
    full = get_model_state_dict(model, options=StateDictOptions(
        full_state_dict=True))
    sharded = sorted(n for n, p in model.named_parameters()
                     if type(p).__name__ == "DTensor")
    torch.save({"metrics": metrics, "state": full, "sharded": sharded,
                "placements": step.placements, "rows": len(
                    next(iter(local.values())))},
               f"{run['out']}.{topo.process_id}.pt")
print("ok", flush=True)
"""


def _gang_runs(tmp_path, runs, n=2):
    cfg = tmp_path / "runs.json"
    cfg.write_text(json.dumps(runs))
    script = tmp_path / "worker.py"
    script.write_text(TRAIN_WORKER)
    outs = run_gang([sys.executable, str(script), str(cfg)], n, tmp_path)
    assert all(o.strip().endswith("ok") for o in outs), outs
    return [[torch.load(f"{run['out']}.{r}.pt", weights_only=False)
             for r in range(n)] for run in runs]


def _gpt2(tmp_path, rows=4, seq=32):
    """(flax model, variables, port model, numpy batch, weights file,
    batch file): gpt2-tiny in float32 through both registries."""
    jspec = j_get_model("gpt2-tiny")
    jmodel = jspec.make_model(dtype=jnp.float32)
    tokens = np.random.RandomState(0).randint(0, 1024, (rows, seq))
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    tmodel = t_get_model("gpt2-tiny").init_params(
        seed=1, device="cpu", train=True, dtype=torch.float32)
    sd = gpt2_state_dict_from_jax(jax.tree.map(np.asarray,
                                               variables["params"]),
                                  tmodel.cfg)
    tmodel.load_state_dict(sd, strict=True)
    return _files(tmp_path, "gpt2", jmodel, variables, tmodel,
                  {"inputs": tokens}, sd)


def _files(tmp_path, tag, jmodel, variables, tmodel, batch, sd=None):
    weights, data = tmp_path / f"{tag}.pt", tmp_path / f"{tag}.npz"
    torch.save(sd if sd is not None else tmodel.state_dict(), weights)
    np.savez(data, **batch)
    return jmodel, variables, tmodel, batch, str(weights), str(data)


def _reference(name, jmodel, variables, batch, opt, steps, *, dp=2,
               fsdp=1, rng=None):
    """The reference's TrainStep on ``MeshSpec(dp, fsdp)`` over the
    conftest's virtual devices: (metrics a step, final variables)."""
    mesh = build_mesh(MeshSpec(dp=dp, fsdp=fsdp),
                      devices=jax.devices()[:dp * fsdp])
    with jax.default_matmul_precision("highest"):
        step = j_make_train_step(j_get_model(name).loss_fn(jmodel), opt,
                                 mesh, donate=False)
        state = step.init_state(variables)
        metrics = []
        for i in range(steps):
            key = None if rng is None else \
                jax.random.fold_in(jax.random.PRNGKey(rng), i)
            state, m = step(state, batch, key)
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree.map(np.asarray, state["params"])


def _one_process(tmodel, name, batch, opt_name, lr, steps, rng=None):
    step = make_train_step(t_get_model(name).loss_fn(tmodel),
                           ttrain.make_optimizer(opt_name, lr))
    state = step.init_state(tmodel)
    metrics = []
    for i in range(steps):
        key = None if rng is None else prng.fold_in(prng.PRNGKey(rng), i)
        state, m = step(state, {k: torch.as_tensor(v)
                                for k, v in batch.items()}, key)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, {k: v.detach().clone()
                     for k, v in tmodel.state_dict().items()}


def _assert_metrics(got, want, keys=None, rtol=1e-5):
    for g, w in zip(got, want, strict=True):
        for k in keys or w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=k)


def _assert_params(got, want, *, atol=None, adam_lr=None, steps=3):
    """Every parameter within ``atol``; for Adam, 2e-6 for at least 99%
    of the elements and 2 lr a step for all."""
    tight = total = 0
    for name, w in want.items():
        g = got[name].float().numpy()
        w = np.asarray(w, np.float32)
        d = np.abs(g - w)
        if adam_lr is None:
            assert d.max() <= atol, f"{name}: max |d| {d.max()}"
            continue
        assert d.max() <= 2 * adam_lr * steps, f"{name}: {d.max()}"
        tight += int((d <= 2e-6).sum())
        total += d.size
    if adam_lr is not None:
        assert tight >= 0.99 * total, (tight, total)


MLM_BN = (("bert-tiny", "adamw"), ("resnet50-tiny", "sgd"))


@pytest.fixture(scope="module")
def dp_gang(tmp_path_factory):
    """The two-rank training runs of the three tests below, in one
    launch: gpt2-tiny's ``dp:2`` SGD, its ``dp:2`` and ``dp:1, fsdp:2``
    Adam, bert-tiny's and resnet50-tiny's ``dp:2`` steps.  Each test
    rebuilds its own (deterministic) inputs for the references; the gang
    outputs by run tag."""
    tmp = tmp_path_factory.mktemp("dp_gang")
    *_, weights, data = _gpt2(tmp)
    gpt2 = dict(model="gpt2-tiny", weights=weights, batch=data)
    runs = {"sgd": dict(gpt2, strategy={"dp": 2}, optimizer="sgd",
                        lr=1e-2, steps=3)}
    for tag, strategy in (("dp", {"dp": 2}), ("fsdp", {"dp": 1, "fsdp": 2})):
        runs[tag] = dict(gpt2, strategy=strategy, optimizer="adam", lr=1e-3,
                         steps=3, fsdp_min_size=2 ** 12)
    for name, opt in MLM_BN:
        jmodel, variables, tmodel, batch = _pair(name, batch_size=8)
        *_, weights, data = _files(tmp, name, jmodel, variables, tmodel,
                                   batch)
        runs[name] = dict(model=name, weights=weights, batch=data,
                          strategy={"dp": 2}, optimizer=opt, lr=1e-3,
                          steps=2, rng=5)
    for tag, run in runs.items():
        run["out"] = str(tmp / tag)
    return dict(zip(runs, _gang_runs(tmp, list(runs.values()))))


def test_dp_gang_sgd_equals_reference_and_one_process(tmp_path, dp_gang):
    jmodel, variables, tmodel, batch, weights, data = _gpt2(tmp_path)
    out = dp_gang["sgd"]
    want_m, want_p = _reference("gpt2-tiny", jmodel, variables, batch,
                                j_make_optimizer("sgd", 1e-2), 3)
    one_m, one_p = _one_process(tmodel, "gpt2-tiny", batch, "sgd", 1e-2, 3)
    assert [r["rows"] for r in out] == [2, 2]
    for rank in out:
        _assert_metrics(rank["metrics"], want_m, ("loss", "grad_norm",
                                                  "perplexity"))
        _assert_metrics(rank["metrics"], one_m)
        _assert_params(rank["state"], gpt2_state_dict_from_jax(
            want_p["params"], tmodel.cfg), atol=1e-5)
        _assert_params(rank["state"], one_p, atol=1e-6)
    assert out[0]["sharded"] == []
    assert out[0]["metrics"][-1]["loss"] < out[0]["metrics"][0]["loss"]


def test_dp_and_fsdp_gangs_with_adam(tmp_path, dp_gang):
    """``dp:2`` and ``dp:1, fsdp:2`` with Adam against the reference's
    steps and one process; the fsdp gang (``fsdp_min_size`` 2**12, so
    every block's weights shard) shards exactly the leaves the
    placement marks, and they are the reference's sharded leaves."""
    jmodel, variables, tmodel, batch, weights, data = _gpt2(tmp_path)
    dp_out, fsdp_out = dp_gang["dp"], dp_gang["fsdp"]
    want_m, want_p = _reference("gpt2-tiny", jmodel, variables, batch,
                                j_make_optimizer("adam", 1e-3), 3)
    one_m, one_p = _one_process(tmodel, "gpt2-tiny", batch, "adam",
                                1e-3, 3)
    want_sd = gpt2_state_dict_from_jax(want_p["params"], tmodel.cfg)
    for rank in dp_out + fsdp_out:
        _assert_metrics(rank["metrics"], want_m, ("loss", "grad_norm",
                                                  "perplexity"))
        _assert_metrics(rank["metrics"], one_m)
        _assert_params(rank["state"], want_sd, adam_lr=1e-3)
        _assert_params(rank["state"], one_p, adam_lr=1e-3)
    placements = fsdp_out[0]["placements"]
    sharded = sorted(n for n, d in placements.items() if d is not None)
    assert fsdp_out[0]["sharded"] == sharded and len(sharded) >= 8
    assert dp_out[0]["sharded"] == []
    # The reference shards the same leaves at this size.
    ref = build_mesh(MeshSpec(dp=1, fsdp=2), devices=jax.devices()[:2])
    spec = make_param_shardings(variables["params"], ref,
                                fsdp_min_size=2 ** 12)
    flags = gpt2_state_dict_from_jax(jax.tree.map(
        lambda leaf, sh: np.full(np.shape(leaf), float(any(
            a is not None for a in sh.spec)), np.float32),
        variables["params"], spec), tmodel.cfg)
    assert sharded == sorted(n for n, f in flags.items() if f.all())


def test_mlm_and_batch_norm_under_dp_equal_reference(dp_gang):
    """bert-tiny's MLM step (mask bits over the global batch, a global
    count) and resnet50-tiny's (global batch statistics) under ``dp:2``
    against the reference's ``dp=2`` TrainStep."""
    for name, opt in MLM_BN:
        jmodel, variables, tmodel, batch = _pair(name, batch_size=8)
        want_m, want_v = _reference(
            name, jmodel, variables, batch, j_make_optimizer(opt, 1e-3), 2,
            rng=5)
        want_sd = _port_sd(name, want_v, tmodel.cfg)
        for rank in dp_gang[name]:
            _assert_metrics(rank["metrics"], want_m)
            if name == "bert-tiny":
                assert [m["masked_tokens"] for m in rank["metrics"]] == \
                    [m["masked_tokens"] for m in want_m]
                continue
            running = [k for k in want_sd if "running" in k]
            assert len(running) == 2 * 17
            for k in running:     # 1e-5 of the tensor's largest |value|
                _close(rank["state"][k].numpy(), want_sd[k].numpy(), 1e-5, k)
            _assert_params(rank["state"], {k: v for k, v in want_sd.items()
                                           if "running" not in k},
                           atol=1e-5)


COLLECTIVES_WORKER = r"""
import numpy as np, torch
torch.set_num_threads(1)
from polyaxon_tpu_torch import data
from polyaxon_tpu_torch.models.registry import get_model
from polyaxon_tpu_torch.parallel import (MeshSpec, ambient_mesh,
    build_mesh, check_slice_health, collectives as c, initialize_from_env)
from polyaxon_tpu_torch.parallel.mesh import data_sharding
from polyaxon_tpu_torch.train import make_eval_fn

topo = initialize_from_env(device="cpu")
assert initialize_from_env(device="cpu") == topo     # idempotent
health = check_slice_health(timeout_s=30)
assert health.ok and health.detail == "4 devices healthy", health
mesh = build_mesh(MeshSpec(dp=2, fsdp=2), device="cpu")
ambient = ambient_mesh(mesh)      # the collectives' default mesh
ambient.__enter__()
dp, fs = mesh.coordinate("dp"), mesh.coordinate("fsdp")
x = torch.as_tensor(np.random.RandomState(0).rand(32, 16), dtype=torch.float32)
blocks = x.chunk(4)                  # rank r holds block dp * 2 + fsdp
sh = data_sharding(mesh)
assert (sh.index, sh.count) == (dp * 2 + fs, 4)
mine = sh.shard(x).clone()
total = sum(blocks)
close = lambda a, b: torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)

# Values against their definitions.
close(c.all_reduce(mine, ("dp", "fsdp")), total)
close(c.all_reduce_mean(mine, ("dp", "fsdp")), total / 4)
close(c.all_reduce(mine, "fsdp"), blocks[dp * 2] + blocks[dp * 2 + 1])
close(c.hierarchical_all_reduce(mine), total)
pair = [blocks[dp * 2], blocks[dp * 2 + 1]]        # my fsdp group
close(c.all_gather(mine, "fsdp", gather_dim=1), torch.cat(pair, 1))
close(c.reduce_scatter(mine, "fsdp"), (pair[0] + pair[1]).chunk(2)[fs])
close(c.ring_permute(mine, "fsdp", shift=1), pair[(fs - 1) % 2])
col = [blocks[fs], blocks[2 + fs]]                  # my dp group
close(c.all_to_all(mine, "dp", split_dim=1, concat_dim=0),
      torch.cat([b.chunk(2, 1)[dp] for b in col], 0))

# Gradients: each rank's loss is sum(y^2) of the all-reduced value, so
# the gradient of the gang's total loss reaching every block is
# 4 * 2y, through the flat and the hierarchical schedule alike.
def grad(fn):
    t = mine.clone().requires_grad_(True)
    (fn(t) ** 2).sum().backward()
    return t.grad
close(grad(lambda t: c.hierarchical_all_reduce(t)), 8 * total)
close(grad(lambda t: c.all_reduce(t, ("dp", "fsdp"))), 8 * total)
# Linear losses sum(out * w): the cotangent each block receives is the
# sum of the weights its values meet on every rank.
w = torch.arange(16 * 16, dtype=torch.float32).reshape(16, 16) / 256
def lin(fn, weight):
    t = mine.clone().requires_grad_(True)
    (fn(t) * weight).sum().backward()
    return t.grad
close(lin(lambda t: c.all_gather(t, "fsdp"), w), 2 * w[8 * fs:8 * fs + 8])
close(lin(lambda t: c.reduce_scatter(t, "fsdp"), w[:4]),
      torch.cat([w[:4], w[:4]]))
close(lin(lambda t: c.ring_permute(t, "fsdp"), w[:8]), w[:8])
close(lin(lambda t: c.all_to_all(t, "dp", split_dim=1, concat_dim=0),
          w[:, :8]), torch.cat([w[8 * dp:8 * dp + 8, :8]] * 2, 1))

ambient.__exit__(None, None, None)
assert torch.equal(c.all_reduce(mine, "dp"), mine)   # no mesh: identity
close(c.all_reduce(mine, ("dp", "fsdp"), mesh=mesh), total)

# The sharded eval equals one process's, the last batch padded.
spec = get_model("mlp")
ds = data.digits_dataset(50, split="eval", seed=0)
model = spec.init_params(seed=3, device="cpu",
                         **spec.input_overrides(ds.sample(2)["inputs"]))
got = make_eval_fn(model, mesh)(ds)
want = make_eval_fn(model)(ds)
assert got == want and 0 < got < 1, (got, want)
print("ok", got, flush=True)
"""


def test_collectives_health_and_eval_on_four_ranks(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(COLLECTIVES_WORKER)
    outs = run_gang([sys.executable, str(script)], 4, tmp_path)
    assert len({o.strip().splitlines()[-1] for o in outs}) == 1, outs
    from polyaxon_tpu_torch import data

    ds = data.digits_dataset(50, split="eval", seed=0)
    n = sum(len(b["labels"]) for b in ds.epoch(0))
    assert n % 4, "the last eval batch must need padding"
