"""Tensor parallelism in training: the port's gangs against the JAX
reference on the CPU.

The reference runs as its own tests run it, its ``TrainStep`` on
``MeshSpec(dp, tp)`` over the conftest's virtual host devices (GSPMD
places each parameter by ``TP_RULES`` and inserts the row-parallel
sums); the port runs as real gloo processes (``run_gang`` of
``test_torch_gang.py``, with its deadlines), fed the same numpy-seeded
batches and the reference's weights converted by ``convert.py``.

- Placements: for every family's tiny config at tp 2 and at ep 2, the
  port's (axis, dim) of each parameter is the reference's
  ``make_param_shardings`` spec of its leaf, carried to the port's name
  and layout by the converter (each leaf counts along its sharded dim,
  so the transposition shows).  No gang.
- The four region operators on a two-rank gang, forward and backward
  against their definitions, and ``collectives.all_reduce`` scaling a
  replicated gradient by tp where ``reduce_from_region`` does not.
- Two AdamW steps of GPT-2 tiny on ``tp:2`` and ``dp:2,tp:2``, Llama
  tiny (GQA, 2 KV heads), BERT tiny (MLM), ViT tiny, T5 tiny and the
  MLP (column outputs gathered, row inputs split) on ``tp:2``: the
  loss and ``grad_norm`` of each step equal the reference's (rtol
  1e-5), and the parameters after the steps equal its within 2e-6 for at least 99% of the elements and Adam's step bound
  (2 lr a step) for all (``test_torch_gang.py``'s Adam rule: a rounding
  difference of a gradient near eps moves Adam by about lr).  The
  gradients of the tp-replicated parameters agree across the tp ranks
  (atol 1e-6 of their largest magnitude).
- A ``tp:2`` gang's collective checkpoint restores in one process to
  the gathered parameters (exactly), and that model's greedy tokens
  equal the gang's model gathered into one process.
- ``train.main`` as a ``dp:2,tp:2`` gang of four processes (gpt2-mini,
  float32) logs the one-process run's losses and checkpoints its
  parameters (the Adam rule above).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

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
from polyaxon_tpu_torch import convert
from polyaxon_tpu_torch.models.registry import get_model as t_get_model
from polyaxon_tpu_torch.parallel import mesh as tmesh
from polyaxon_tpu_torch.parallel import strategies as tstrat
from test_torch_gang import ROOT, _assert_params, run_gang

torch.set_num_threads(2)

CONVERT = {
    "gpt2-tiny": convert.gpt2_state_dict_from_jax,
    "llama-tiny": convert.llama_state_dict_from_jax,
    "bert-tiny": convert.bert_state_dict_from_jax,
    "moe-gpt-tiny": convert.moe_gpt_state_dict_from_jax,
    "t5-tiny": convert.t5_state_dict_from_jax,
    "vit-tiny": convert.vit_state_dict_from_jax,
    "resnet50-tiny": convert.resnet_state_dict_from_jax,
    "convnet": convert.convnet_state_dict_from_jax,
    "mlp": convert.mlp_state_dict_from_jax,
}

LR = 1e-3


def _port_mesh(**axes) -> tmesh.Mesh:
    sizes = {a: axes.get(a, 1) for a in tmesh.AXIS_ORDER}
    n = int(np.prod(list(sizes.values())))
    return tmesh.Mesh(sizes, np.arange(n).reshape(
        [sizes[a] for a in tmesh.AXIS_ORDER]), torch.device("cpu"))


@pytest.mark.parametrize("axis", ["tp", "ep"])
@pytest.mark.parametrize("name", sorted(CONVERT))
def test_placements_equal_the_references_specs(name, axis):
    """Each flax leaf counts 1, 2, ... along the dim the reference
    places on ``axis`` (0 where it is replicated there); through the
    converter each port parameter must count along exactly the port
    dim of its placement."""
    jspec = j_get_model(name)
    jmodel = jspec.make_model(dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda x: jmodel.init(jax.random.PRNGKey(0), x),
        jspec.make_batch(2)["inputs"])
    ref = build_mesh(MeshSpec(dp=1, **{axis: 2}), devices=jax.devices()[:2])
    shard = make_param_shardings(shapes["params"], ref)

    def counted(leaf, sh):
        spec = tuple(sh.spec) + (None,) * (len(leaf.shape) - len(sh.spec))
        for i, entry in enumerate(spec):
            names = entry if isinstance(entry, tuple) else (entry,)
            if axis in names:
                shape = [1] * len(leaf.shape)
                shape[i] = leaf.shape[i]
                return np.broadcast_to(np.arange(
                    1, leaf.shape[i] + 1, dtype=np.float32).reshape(shape),
                    leaf.shape).copy()
        return np.zeros(leaf.shape, np.float32)

    flags = jax.tree.map(counted, shapes["params"], shard)
    model = t_get_model(name).make_model(device="cpu",
                                         param_dtype=torch.float32)
    args = (flags, model.cfg)
    if "batch_stats" in shapes:
        args += (jax.tree.map(lambda l: np.zeros(l.shape, np.float32),
                              shapes["batch_stats"]),)
    want = CONVERT[name](*args)
    got = tstrat.make_tensor_placements(model, _port_mesh(**{axis: 2}))
    assert tstrat.make_param_placements(model, _port_mesh(**{axis: 2})) \
        == {n: None if p is None else p[1] for n, p in got.items()}
    checked = placed = 0
    for pname, pl in got.items():
        if pname == "type_embed.weight":
            # A port-only leaf (flax creates bert's only when a call
            # passes token_type_ids); the rule places it as an embed.
            assert pl == ("tp", 0) if axis == "tp" else pl is None
            continue
        w = want[pname].float()
        varying = [d for d in range(w.dim())
                   if w.shape[d] > 1 and not bool(
                       (w == w.select(d, 0).unsqueeze(d)).all())]
        if pl is None:
            assert not bool(w.any()), f"{pname}: reference places it"
        else:
            assert pl[0] == axis and varying == [pl[1]], (pname, pl,
                                                         varying)
            placed += 1
        checked += 1
    assert checked >= len(got) - 1
    if name in ("gpt2-tiny", "llama-tiny", "bert-tiny", "t5-tiny",
                "vit-tiny") and axis == "tp":
        assert placed >= 8
    if name == "moe-gpt-tiny" and axis == "ep":
        assert placed == 2 * 2          # experts_w1/w2 of both layers


REGION_WORKER = r"""
import torch
torch.set_num_threads(1)
from polyaxon_tpu_torch.parallel import (MeshSpec, build_mesh,
    collectives as c, initialize_from_env)

initialize_from_env(device="cpu")
mesh = build_mesh(MeshSpec(dp=1, tp=2), device="cpu")
r = mesh.coordinate("tp")
x = torch.arange(12, dtype=torch.float32).reshape(3, 4) + 10 * r
w = torch.arange(12, dtype=torch.float32).reshape(3, 4) / 7 + r
eq = lambda a, b: torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
both = [torch.arange(12, dtype=torch.float32).reshape(3, 4) + 10 * i
        for i in range(2)]
wboth = [torch.arange(12, dtype=torch.float32).reshape(3, 4) / 7 + i
         for i in range(2)]

def grad(fn, t, weight):
    t = t.clone().requires_grad_(True)
    (fn(t) * weight).sum().backward()
    return t.detach(), t.grad

# copy_to_region: identity forward, all-reduce backward.
y, g = grad(lambda t: c.copy_to_region(t, "tp", mesh=mesh), x, w)
eq(c.copy_to_region(x, "tp", mesh=mesh), x); eq(g, wboth[0] + wboth[1])
# reduce_from_region: all-reduce forward, identity backward.
eq(c.reduce_from_region(x, "tp", mesh=mesh), both[0] + both[1])
_, g = grad(lambda t: c.reduce_from_region(t, "tp", mesh=mesh), x, w)
eq(g, w)
# ... where all_reduce's backward sums the (equal) cotangents: tp x.
_, g = grad(lambda t: c.all_reduce(t, "tp", mesh=mesh), x, wboth[0])
eq(g, 2 * wboth[0])
_, g = grad(lambda t: c.reduce_from_region(t, "tp", mesh=mesh), x,
            wboth[0])
eq(g, wboth[0])
# split_to_region: my block forward, all-gather backward.
eq(c.split_to_region(x, "tp", dim=1, mesh=mesh), x[:, 2 * r:2 * r + 2])
_, g = grad(lambda t: c.split_to_region(t, "tp", dim=1, mesh=mesh), x,
            w[:, :2])
eq(g, torch.cat([wboth[0][:, :2], wboth[1][:, :2]], 1))
# gather_from_region: all-gather forward, my block backward.
eq(c.gather_from_region(x, "tp", dim=0, mesh=mesh), torch.cat(both, 0))
_, g = grad(lambda t: c.gather_from_region(t, "tp", dim=0, mesh=mesh), x,
            torch.cat([w, w + 1], 0))
eq(g, w + r)
# Size-1 axes are the identity.
for fn in (c.copy_to_region, c.reduce_from_region):
    assert fn(x, "ep", mesh=mesh) is x
assert c.split_to_region(x, "dp", dim=0, mesh=mesh) is x
print("ok", flush=True)
"""


def test_region_operators_forward_and_backward(tmp_path):
    script = tmp_path / "regions.py"
    script.write_text(REGION_WORKER)
    outs = run_gang([sys.executable, str(script)], 2, tmp_path)
    assert all(o.strip().endswith("ok") for o in outs), outs


# Each run: the port model from converted weights, the strategy over
# the gang, AdamW steps on this rank's rows; saved: the metrics, the
# gathered final parameters, the first step's gradients of the
# parameters replicated over tp, and (``ckpt``) a collective checkpoint.
TP_WORKER = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from polyaxon_tpu_torch import prng
from polyaxon_tpu_torch.checkpoint import CheckpointManager
from polyaxon_tpu_torch.models.registry import get_model
from polyaxon_tpu_torch.parallel import MeshSpec, build_mesh, make_train_step
from polyaxon_tpu_torch.parallel.bootstrap import initialize_from_env
from polyaxon_tpu_torch.parallel.strategies import gather_shard
from polyaxon_tpu_torch.train import make_optimizer

topo = initialize_from_env(device="cpu")
for run in json.load(open(sys.argv[1])):
    spec = get_model(run["model"])
    model = spec.init_params(seed=1, device="cpu", train=True,
                             dtype=torch.float32, **run.get("over", {}))
    model.load_state_dict(torch.load(run["weights"]), strict=True)
    mesh = build_mesh(MeshSpec.from_dict(run["strategy"]), device="cpu")
    step = make_train_step(spec.loss_fn(model),
                           make_optimizer("adamw", run["lr"]), mesh)
    state = step.init_state(model)
    batch = dict(np.load(run["batch"]))
    local = {k: torch.as_tensor(step.batch_sharding.shard(v))
             for k, v in batch.items()}
    metrics, grads = [], {}
    for i in range(run["steps"]):
        rng = None if run.get("rng") is None else \
            prng.fold_in(prng.PRNGKey(run["rng"]), i)
        state, m = step(state, local, rng)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()
                     if n not in step.shards and p.grad is not None}
    full = {n: gather_shard(model, n, t) if n in step.shards else t
            for n, t in model.state_dict().items()}
    if run.get("ckpt"):
        ckpt = CheckpointManager(run["ckpt"])
        ckpt.save(state["step"], state)
        ckpt.wait()
    torch.save({"metrics": metrics, "state": full, "grads": grads,
                "shards": step.shards,
                "coord": {a: mesh.coordinate(a) for a in ("tp", "ep")}},
               f"{run['out']}.{topo.process_id}.pt")
print("ok", flush=True)
"""


def gang_runs(tmp_path, runs, n, worker=TP_WORKER, timeout=120.0):
    cfg = tmp_path / f"runs{n}.json"
    cfg.write_text(json.dumps(runs))
    script = tmp_path / f"worker{n}.py"
    script.write_text(worker)
    outs = run_gang([sys.executable, str(script), str(cfg)], n, tmp_path,
                    timeout=timeout)
    assert all(o.strip().endswith("ok") for o in outs), outs
    return [[torch.load(f"{run['out']}.{r}.pt", weights_only=False)
             for r in range(n)] for run in runs]


def _case(name, rows=4, seq=None):
    """(flax model, variables, port state dict, numpy batch) of a tiny
    model in float32: the flax init, the registry's batch (tokens cut to
    ``seq``), the weights converted."""
    jspec = j_get_model(name)
    jmodel = jspec.make_model(dtype=jnp.float32)
    batch = dict(jspec.make_batch(rows))
    if seq is not None:
        batch = {k: v[:, :seq] if v.ndim == 2 else v
                 for k, v in batch.items()}
    variables = jmodel.init(jax.random.PRNGKey(0), batch["inputs"])
    if name == "t5-tiny":
        # T5's own init scales q by d_kv ** -0.5 (unscaled scores of std
        # ~8 round float32 gradients apart: test_torch_t5.py).
        variables = {"params": _scale_q(jax.tree.map(
            np.array, variables["params"]), 16 ** -0.5)}
    cfg = t_get_model(name).make_model(device="meta").cfg
    sd = CONVERT[name](jax.tree.map(np.asarray, variables["params"]), cfg)
    return jmodel, variables, sd, batch


def _scale_q(tree, factor):
    if isinstance(tree, dict):
        return {k: ({**v, "kernel": v["kernel"] * factor}
                    if k == "q_proj" else _scale_q(v, factor))
                for k, v in tree.items()}
    return tree


def _reference(name, jmodel, variables, batch, steps, *, dp=1, tp=2,
               ep=1, rng=None):
    """The reference's TrainStep (AdamW) on ``MeshSpec(dp, tp, ep)``."""
    mesh = build_mesh(MeshSpec(dp=dp, tp=tp, ep=ep),
                      devices=jax.devices()[:dp * tp * ep])
    with jax.default_matmul_precision("highest"):
        step = j_make_train_step(j_get_model(name).loss_fn(jmodel),
                                 j_make_optimizer("adamw", LR), mesh,
                                 donate=False)
        state = step.init_state(variables)
        metrics = []
        for i in range(steps):
            key = None if rng is None else \
                jax.random.fold_in(jax.random.PRNGKey(rng), i)
            state, m = step(state, batch, key)
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree.map(np.asarray, state["params"])


def _check(name, out, want_m, want_p, cfg, axis="tp",
           keys=("loss", "grad_norm")):
    """Every rank's metrics and gathered parameters against the
    reference's; the first step's gradients of the parameters not
    sharded agree across the ranks of ``axis``."""
    want_sd = CONVERT[name](want_p["params"], cfg)
    for rank in out:
        for g, w in zip(rank["metrics"], want_m, strict=True):
            for k in keys:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                           err_msg=f"{name} {k}")
        _assert_params(rank["state"], {k: v for k, v in want_sd.items()
                                       if k in rank["state"]},
                       adam_lr=LR, steps=len(want_m))
    assert out[0]["shards"], f"{name}: nothing was sharded"
    by_rank = {}
    for rank in out:
        by_rank.setdefault(rank["coord"][axis], rank)
    a, b = by_rank[0]["grads"], by_rank[1]["grads"]
    assert a.keys() == b.keys() and a
    for k in a:
        scale = max(float(a[k].abs().max()), 1e-12)
        assert float((a[k] - b[k]).abs().max()) <= 1e-6 * scale, k


# The MLP declares no TP_REGIONS: its column layers gather their
# outputs and its row layers split their inputs.
TP2 = [("gpt2-tiny", 32, None), ("llama-tiny", 32, None),
       ("bert-tiny", None, 5), ("vit-tiny", None, None),
       ("t5-tiny", 32, None), ("mlp", None, None)]


def test_tp2_gang_trains_the_zoo_as_the_reference(tmp_path):
    """GPT-2, Llama (GQA), BERT (MLM), ViT, T5 tiny and the MLP on
    ``tp:2``, and GPT-2 tiny's collective checkpoint."""
    runs, refs = [], {}
    for name, seq, rng in TP2:
        jmodel, variables, sd, batch = _case(name, seq=seq)
        weights, data = tmp_path / f"{name}.pt", tmp_path / f"{name}.npz"
        torch.save(sd, weights)
        np.savez(data, **batch)
        runs.append(dict(model=name, weights=str(weights), batch=str(data),
                         strategy={"dp": 1, "tp": 2}, lr=LR, steps=2,
                         rng=rng, out=str(tmp_path / name),
                         ckpt=str(tmp_path / "ckpt")
                         if name == "gpt2-tiny" else None))
        refs[name] = _reference(name, jmodel, variables, batch, 2, rng=rng)
    outs = gang_runs(tmp_path, runs, 2)
    for (name, _, _), out in zip(TP2, outs):
        cfg = t_get_model(name).make_model(device="meta").cfg
        _check(name, out, *refs[name], cfg)
    _checkpoint_restores_in_one_process(tmp_path / "ckpt",
                                        outs[0][0]["state"])


def _checkpoint_restores_in_one_process(directory, gathered):
    from polyaxon_tpu_torch.checkpoint import CheckpointManager
    from polyaxon_tpu_torch.models.generate import generate

    saved = CheckpointManager(str(directory)).restore()
    assert saved["step"] == 2
    assert saved["params"].keys() == gathered.keys()
    for k, v in gathered.items():
        assert torch.equal(saved["params"][k], v), k
    spec = t_get_model("gpt2-tiny")
    models = []
    for sd in (saved["params"], gathered):
        m = spec.make_model(device="cpu", param_dtype=torch.float32)
        m.load_state_dict(sd)
        models.append(m.eval().requires_grad_(False))
    # The optimizer state is the one-process layout: one group.
    assert len(saved["opt_state"]["param_groups"]) == 1
    w = saved["params"]["h.0.qkv.weight"]
    assert saved["opt_state"]["state"][0]["exp_avg"].shape == \
        saved["params"]["wte.weight"].shape and w.shape == (192, 64)
    prompt = torch.tensor([[3, 1, 4, 1, 5]])
    toks = [generate(m, prompt, max_new_tokens=6).tolist() for m in models]
    assert toks[0] == toks[1]


def test_dp2_tp2_gang_trains_gpt2_as_the_reference(tmp_path):
    jmodel, variables, sd, batch = _case("gpt2-tiny", seq=32)
    weights, data = tmp_path / "w.pt", tmp_path / "b.npz"
    torch.save(sd, weights)
    np.savez(data, **batch)
    out = gang_runs(tmp_path, [dict(
        model="gpt2-tiny", weights=str(weights), batch=str(data),
        strategy={"dp": 2, "tp": 2}, lr=LR, steps=2,
        out=str(tmp_path / "g"))], 4)[0]
    want = _reference("gpt2-tiny", jmodel, variables, batch, 2, dp=2)
    cfg = t_get_model("gpt2-tiny").make_model(device="meta").cfg
    _check("gpt2-tiny", out, *want, cfg)
    assert sorted(r["coord"]["tp"] for r in out) == [0, 0, 1, 1]


@pytest.mark.parametrize("name,axes,match", [
    ("gpt2-tiny", {"tp": 3}, r"num_heads=4\) is not divisible by mesh tp=3"),
    ("llama-tiny", {"tp": 4}, r"num_kv_heads=2\) is not divisible by "
                              r"mesh tp=4"),
    ("moe-gpt-tiny", {"ep": 3}, "num experts 4 must be divisible by ep "
                                "axis size 3"),
])
def test_model_axes_refused_before_weights(name, axes, match):
    """Heads, KV heads and experts against tp / ep, on a meta model (no
    weight built); the divisible cases pass."""
    cfg = t_get_model(name).make_model(device="meta").cfg
    with pytest.raises(tmesh.MeshError, match=match):
        tstrat.check_model_axes(cfg, _port_mesh(**axes))
    tstrat.check_model_axes(cfg, _port_mesh(tp=2))
    tstrat.check_model_axes(cfg, _port_mesh(ep=2))


def test_moe_layer_and_pipeline_messages_are_the_references():
    """``moe_layer``'s two divisibility errors and ``train``'s pp x ep /
    sp refusal carry the reference's texts."""
    import types

    from polyaxon_tpu.parallel.moe import moe_layer as j_moe_layer
    from polyaxon_tpu_torch import train as ttrain
    from polyaxon_tpu_torch.parallel.moe import moe_layer

    def errors(x_shape, experts, ep):
        x = np.zeros(x_shape, np.float32)
        r = np.zeros((x_shape[-1], experts), np.float32)
        w = np.zeros((experts, x_shape[-1], 4), np.float32)
        jmesh = build_mesh(MeshSpec(dp=1, ep=ep), devices=jax.devices()[:ep])
        fake = types.SimpleNamespace(is_distributed=True,
                                     shape={"dp": 1, "fsdp": 1, "ep": ep})
        got = []
        for fn, args in ((j_moe_layer, (x, r, w, w.transpose(0, 2, 1),
                                        jmesh)),
                         (moe_layer, tuple(map(torch.as_tensor, (
                             x, r, w, w.transpose(0, 2, 1)))) + (fake,))):
            with pytest.raises(ValueError) as e:
                fn(*args)
            got.append(str(e.value))
        return got

    a, b = errors((1, 6, 8), 4, 3)         # experts do not divide
    assert a == b == "num experts 4 must be divisible by ep axis size 3"
    a, b = errors((1, 7, 8), 6, 3)         # the sequence does not
    assert a == b == "sequence length 7 must be divisible by ep axis size 3"
    for bad in ("ep", "sp"):
        with pytest.raises(SystemExit, match=f"strategy combines pp>1 with "
                           f"{bad}>1, which is not supported: pipeline "
                           f"stages compose with dp/fsdp"):
            ttrain.main(["--cpu", "--strategy", f"pp:2,{bad}:2"])


def test_train_main_tp_gang_equals_one_process(tmp_path, monkeypatch):
    """``python -m polyaxon_tpu_torch.train --cpu --model gpt2-mini
    --strategy dp:2,tp:2`` as a four-rank gloo gang: every rank logs the
    one-process run's losses (4 printed digits) and the chief's
    checkpoint, the one-process layout, holds its parameters (Adam's
    rule) and the same optimizer-state shapes."""
    from polyaxon_tpu_torch.checkpoint import CheckpointManager
    from test_torch_gang_run import TRAIN, _losses, _same_losses

    monkeypatch.setenv("POLYAXON_TPU_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    for name in ("POLYAXON_TPU_RUN_UUID", "PTPU_STRATEGY"):
        monkeypatch.delenv(name, raising=False)
    # gpt2-mini computes in float32 (gpt2-tiny in bf16, whose
    # row-parallel partial sums round apart by a bf16 ulp).
    args = ["--model", "gpt2-mini", "--steps", "2", "--log-every", "1",
            "--batch-size", "4"]
    (tmp_path / "gang").mkdir()
    (tmp_path / "one").mkdir()
    outs = run_gang(TRAIN + args + ["--strategy", "dp:2,tp:2"], 4,
                    tmp_path / "gang")
    one = subprocess.run(TRAIN + args, cwd=str(tmp_path / "one"),
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert one.returncode == 0, one.stdout[-3000:] + one.stderr[-3000:]
    want = _losses(one.stdout)
    for out in outs:
        _same_losses(_losses(out), want)
    gang = CheckpointManager(str(tmp_path / "gang" / "checkpoints"))
    solo = CheckpointManager(str(tmp_path / "one" / "checkpoints"))
    g, w = gang.restore(), solo.restore()
    assert g["step"] == w["step"] == 2
    _assert_params(g["params"], w["params"], adam_lr=1e-3, steps=2)
    assert {i: {k: tuple(v.shape) for k, v in st.items()}
            for i, st in g["opt_state"]["state"].items()} == \
        {i: {k: tuple(v.shape) for k, v in st.items()}
         for i, st in w["opt_state"]["state"].items()}
