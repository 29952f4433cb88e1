"""Composed training meshes: fsdp beside tp / ep, sp beside ep and sp
beside fsdp, the port's four-rank gloo gangs against the JAX reference
on the CPU.

The reference runs as its own dry run runs it (``__graft_entry__``'s
legs 1 and 2): its ``TrainStep`` on ``MeshSpec(dp, fsdp, tp)`` /
``(fsdp, ep)`` / ``(sp, ep)`` / ``(sp, fsdp)`` over the conftest's
virtual host devices (under ``sequence_parallel`` where sp is above 1),
and leg 2's toy loss (ring attention into ``moe_layer``, one SGD step);
the port runs as four real gloo processes (``run_gang`` of
``test_torch_gang.py``), ONE launch for every training run of the
module (``compose_gang``, started beside the reference's steps), fed the
same numpy-seeded batches and the reference's weights converted by
``convert.py``.

- Placements: for every family at ``fsdp:2,tp:2`` and ``fsdp:2,ep:2``
  (``fsdp_min_size`` 2**16 and 2**10), the port's tensor dim and fsdp
  dim of each parameter are the reference's ``make_param_shardings``
  spec of its leaf, carried to the port's name and layout by the
  converter, the joint ``("tp", "fsdp")`` vocab dim and the
  divisibility drop included.  No gang.
- Leg 1: GPT-2 (gpt2-mini, 2 layers), Llama (GQA) and T5 at
  ``dp:1,fsdp:2,tp:2``; MoE-GPT at ``fsdp:2,ep:2``; two AdamW steps:
  losses and ``grad_norm`` rtol 1e-5, parameters by Adam's rule
  (``test_torch_gang.py``).  Every rank's storage of a leaf is 1/tp,
  1/fsdp or 1/(tp * fsdp) of it as the placements say: nothing left
  replicated.
- Leg 2: the toy loss at ``sp:2,ep:2`` equals the reference's ``step2``;
  MoE-GPT at ``sp:2,ep:2`` on the ring equals the reference's
  ``TrainStep``.
- sp beside fsdp: GPT-2 on the flash ring and windowed Llama under
  remat (plain ring) at ``sp:2,fsdp:2``.
- The ``dp:1,fsdp:2,tp:2`` gang's collective checkpoint restores into a
  fresh composed state on every rank (each rank's shards), and in one
  process to the gang's parameters with equal greedy tokens.
- ``train.main --cpu --model gpt2-mini --strategy dp:1,fsdp:2,tp:2`` as
  four ranks logs the one-process run's losses and checkpoints its
  parameters.
"""

from __future__ import annotations

import os
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu.ops.attention import sequence_parallel as j_sequence_parallel
from polyaxon_tpu.parallel import MeshSpec, build_mesh
from polyaxon_tpu.parallel import make_train_step as j_make_train_step
from polyaxon_tpu.parallel.strategies import make_param_shardings
from polyaxon_tpu.train import make_optimizer as j_make_optimizer
from polyaxon_tpu_torch.models.registry import get_model as t_get_model
from polyaxon_tpu_torch.parallel import mesh as tmesh
from polyaxon_tpu_torch.parallel import strategies as tstrat
from test_torch_gang import ROOT, _assert_params, run_gang
from test_torch_tp import CONVERT, LR, _port_mesh, _scale_q

torch.set_num_threads(2)


@pytest.mark.parametrize("axis", ["tp", "ep"])
@pytest.mark.parametrize("name", sorted(CONVERT))
def test_placements_equal_the_references_specs(name, axis):
    """Each flax leaf counts 1, 2, ... along the dim the reference
    places an axis on (0 where it does not); through the converter each
    port parameter must count along exactly the port dim of its
    placement on that axis.  fsdp on a scanned leaf's layer axis shows
    as a constant per block: the port leaves it replicated."""
    jspec = j_get_model(name)
    jmodel = jspec.make_model(dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda x: jmodel.init(jax.random.PRNGKey(0), x),
        jspec.make_batch(2)["inputs"])
    ref = build_mesh(MeshSpec(dp=1, fsdp=2, **{axis: 2}),
                     devices=jax.devices()[:4])
    model = t_get_model(name).make_model(device="cpu",
                                         param_dtype=torch.float32)
    mesh = _port_mesh(fsdp=2, **{axis: 2})
    for min_size in (2 ** 16, 2 ** 10):
        shard = make_param_shardings(shapes["params"], ref,
                                     fsdp_min_size=min_size)
        got = tstrat.make_placements(model, mesh, fsdp_min_size=min_size)
        assert {n: t for n, (t, _) in got.items()} == \
            tstrat.make_tensor_placements(model, mesh)
        counts = {a: 0 for a in (axis, "fsdp", "both", "layer")}
        for on in (axis, "fsdp"):
            want = _counted(name, shapes, shard, model, on)
            for pname, (tensor, fsdp) in got.items():
                if pname == "type_embed.weight":
                    # A port-only leaf (flax creates bert's only when a
                    # call passes token_type_ids).
                    continue
                dim = (tensor[1] if tensor and tensor[0] == on else None) \
                    if on != "fsdp" else fsdp
                w = want[pname].float()
                varying = [d for d in range(w.dim())
                           if w.shape[d] > 1 and not bool(
                               (w == w.select(d, 0).unsqueeze(d)).all())]
                if dim is not None:
                    assert varying == [dim], (pname, on, dim, varying)
                    counts[on] += 1
                elif on == "fsdp" and bool(w.any()):
                    # The reference's fsdp on the layer axis: one count
                    # a block, constant within it.
                    assert varying == [] and bool((w != 0).all()), pname
                    counts["layer"] += 1
                else:
                    assert not bool(w.any()), (pname, on, "reference "
                                               "places it")
                counts["both"] += int(on == "fsdp" and dim is not None
                                      and tensor is not None)
        if min_size == 2 ** 10 and name != "mlp":
            assert counts["fsdp"] > 0, (name, counts)
        if axis == "tp" and name in ("gpt2-tiny", "llama-tiny", "t5-tiny",
                                     "bert-tiny", "vit-tiny"):
            assert counts["tp"] >= 8 and (min_size == 2 ** 16 or
                                          counts["both"] >= 4), counts
        if name == "moe-gpt-tiny" and axis == "ep":
            # experts_w1/w2 of both layers on ep and fsdp.
            assert counts["ep"] == 4 and counts["both"] == 4, counts


def _counted(name, shapes, shard, model, on):
    """The converted state dict of flags counting along the dim the
    reference places ``on`` (0 elsewhere)."""
    def counted(leaf, sh):
        spec = tuple(sh.spec) + (None,) * (len(leaf.shape) - len(sh.spec))
        for i, entry in enumerate(spec):
            names = entry if isinstance(entry, tuple) else (entry,)
            if on in names:
                shape = [1] * len(leaf.shape)
                shape[i] = leaf.shape[i]
                return np.broadcast_to(np.arange(
                    1, leaf.shape[i] + 1, dtype=np.float32).reshape(shape),
                    leaf.shape).copy()
        return np.zeros(leaf.shape, np.float32)

    args = (jax.tree.map(counted, shapes["params"], shard), model.cfg)
    if "batch_stats" in shapes:
        args += (jax.tree.map(lambda l: np.zeros(l.shape, np.float32),
                              shapes["batch_stats"]),)
    return CONVERT[name](*args)


def test_gpt2s_vocab_divides_by_neither_axis():
    """GPT-2's 50257-row table: the joint ``("tp", "fsdp")`` dim drops
    both axes from the right, as the reference's fix-up does; 4096 rows
    keep both, 2050 keep tp alone."""
    drop = tstrat._drop_indivisible
    sizes = {"tp": 2, "fsdp": 2}
    for rows, want in ((50257, None), (4096, ("tp", "fsdp")),
                       (2050, "tp")):
        assert drop((("tp", "fsdp"), None), (rows, 1024), sizes) == \
            (want, None)
    model = t_get_model("gpt2-medium").make_model(device="meta")
    got = tstrat.make_placements(model, _port_mesh(fsdp=2, tp=2))
    assert got["wte.weight"] == (None, None)
    assert got["h.0.qkv.weight"] == (("tp", 0), 1)
    assert got["h.0.o_proj.weight"] == (("tp", 1), 0)
    # The stacked [24, 4096] bias: fsdp on its own dim (the reference
    # places no tp there).
    assert got["h.0.fc1.bias"] == (None, 0)


# Each run: the port model from converted weights, the strategy over
# the gang (sp runs under ``sequence_parallel``), AdamW steps on this
# rank's rows; saved: the metrics, the gathered final state, each
# parameter's local element count, the attention routes, and (``ckpt``)
# a collective checkpoint restored into a fresh composed state.  A
# ``toy`` run is leg 2's loss, one SGD step.
COMPOSE_WORKER = r"""
import json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
from polyaxon_tpu_torch.checkpoint import CheckpointManager
from polyaxon_tpu_torch.models.registry import get_model
from polyaxon_tpu_torch.ops.attention import sequence_parallel
from polyaxon_tpu_torch.parallel import MeshSpec, build_mesh, make_train_step, ring
from polyaxon_tpu_torch.parallel.bootstrap import initialize_from_env
from polyaxon_tpu_torch.parallel.collectives import gather_from_region
from polyaxon_tpu_torch.parallel.moe import moe_layer
from polyaxon_tpu_torch.parallel.strategies import gather_full, local_block
from polyaxon_tpu_torch.train import make_optimizer

routes = [0]
real_ring = ring.ring_attention

def counted(*a, **k):
    routes[0] += 1
    return real_ring(*a, **k)

ring.ring_attention = counted

def toy(run):
    # Leg 2 of the reference's dry run: ring attention, then moe_layer.
    mesh = build_mesh(MeshSpec.from_dict(run["strategy"]), device="cpu")
    data = np.load(run["toy"])
    ep, r = mesh.shape["ep"], mesh.coordinate("ep")
    p = {k: torch.tensor(data[k]) for k in ("wq", "wk", "wv", "router")}
    for k in ("w1", "w2"):
        p[k] = torch.tensor(data[k]).chunk(ep, 0)[r].clone()
    for t in p.values():
        t.requires_grad_(True)
    x = torch.tensor(data["x"])
    B, S, DM = x.shape
    H = 2
    q, k, v = ((x @ p[n]).reshape(B, S, H, DM // H) for n in ("wq", "wk", "wv"))
    a = ring.ring_attention(q, k, v, mesh, causal=True).reshape(B, S, DM)
    y, aux = moe_layer(a, p["router"], p["w1"], p["w2"], mesh)
    loss = (y ** 2).mean() + 0.01 * aux
    loss.backward()
    torch.distributed.all_reduce(p["router"].grad, group=mesh.group("ep"))
    out = {}
    with torch.no_grad():
        for n, t in p.items():
            new = t - run["lr"] * t.grad
            if n in ("w1", "w2"):
                new = gather_from_region(new, "ep", dim=0, mesh=mesh)
            out[n] = new
    return {"loss": float(loss), "params": out}

def build(run, mesh):
    spec = get_model(run["model"])
    model = spec.init_params(seed=1, device="cpu", train=True,
                             dtype=torch.float32, **run["over"])
    model.load_state_dict(torch.load(run["weights"]), strict=True)
    step = make_train_step(spec.loss_fn(model),
                           make_optimizer("adamw", run["lr"]), mesh,
                           fsdp_min_size=run["min_size"])
    return model, step, step.init_state(model)

def full_state(model, state):
    params = {n: gather_full(model, n, t)
              for n, t in model.state_dict().items()}
    names = {id(p): n for n, p in model.named_parameters()}
    opt = state["opt_state"]
    moments = {names[id(p)]: gather_full(model, names[id(p)],
                                         opt.state[p]["exp_avg"])
               for g in opt.param_groups for p in g["params"]}
    return params, moments

topo = initialize_from_env(device="cpu")
for run in json.load(open(sys.argv[1])):
    if run["no_flash"]:
        os.environ["POLYAXON_TPU_NO_FLASH"] = "1"
    else:
        os.environ.pop("POLYAXON_TPU_NO_FLASH", None)
    if run.get("toy"):
        torch.save(toy(run), f"{run['out']}.{topo.process_id}.pt")
        continue
    mesh = build_mesh(MeshSpec.from_dict(run["strategy"]), device="cpu")
    model, step, state = build(run, mesh)
    storage = {n: [local_block(p).numel(), type(p).__name__ == "DTensor"]
               for n, p in model.named_parameters()}
    batch = dict(np.load(run["batch"]))
    local = {k: torch.as_tensor(step.batch_sharding.shard(v))
             for k, v in batch.items()}
    metrics = []
    routes[0] = 0
    for i in range(run["steps"]):
        if run["sp_mode"]:
            with sequence_parallel(mesh, run["sp_mode"]):
                state, m = step(state, local)
        else:
            state, m = step(state, local)
        metrics.append({k: float(v) for k, v in m.items()})
    full, moments = full_state(model, state)
    res = {"metrics": metrics, "state": full, "storage": storage,
           "routes": routes[0], "shards": step.shards,
           "coord": {a: mesh.coordinate(a) for a in ("fsdp", "tp", "ep")}}
    if run.get("ckpt"):
        ckpt = CheckpointManager(run["ckpt"])
        ckpt.save(state["step"], state)
        ckpt.wait()
        model2, step2, state2 = build(run, mesh)
        state2 = ckpt.restore(template=state2)
        res["restored"] = full_state(model2, state2)
        res["moments"] = moments
    torch.save(res, f"{run['out']}.{topo.process_id}.pt")
print("ok", flush=True)
"""

FSDP_TP = {"dp": 1, "fsdp": 2, "tp": 2}
# name, strategy, config overrides, tokens a row, fsdp_min_size, sp mode,
# flash ("flash": the reference in interpret mode; "plain": both
# packages on the plain path).  Llama and T5 tiny hold no leaf of 2**16
# elements: at 2**10 fsdp shards their matmul leaves.
RUNS = [
    ("gpt2-mini", FSDP_TP, {"num_layers": 2}, 32, 2 ** 16, None, "plain"),
    ("llama-tiny", FSDP_TP, {}, 32, 2 ** 10, None, "plain"),
    ("t5-tiny", FSDP_TP, {}, 32, 2 ** 10, None, "plain"),
    ("moe-gpt-tiny", {"fsdp": 2, "ep": 2}, {}, 32, 2 ** 16, None, "plain"),
    ("moe-gpt-tiny", {"dp": 1, "sp": 2, "ep": 2}, {}, 64, 2 ** 16, "ring",
     "plain"),
    ("gpt2-tiny", {"sp": 2, "fsdp": 2},
     {"num_heads": 1, "max_position": 256}, 256, 2 ** 10, "ring", "flash"),
    ("llama-tiny", {"sp": 2, "fsdp": 2},
     {"sliding_window": 20, "remat": True}, 64, 2 ** 10, "ring", "plain"),
]
IDS = ["gpt2 fsdp tp", "llama fsdp tp", "t5 fsdp tp", "moe fsdp ep",
       "moe sp ep", "gpt2 sp fsdp flash ring", "llama sp fsdp remat ring"]


def _case(name, over, seq, rows=4):
    """(flax model, variables, port state dict, numpy batch) in float32
    with the config ``over``rides and ``seq`` random tokens a row."""
    jspec = j_get_model(name)
    jmodel = jspec.make_model(dtype=jnp.float32, **over)
    batch = dict(jspec.make_batch(rows))
    batch = {k: v[:, :seq] if v.ndim == 2 else v for k, v in batch.items()}
    if name != "t5-tiny":
        batch["inputs"] = np.random.RandomState(3).randint(
            0, jmodel.cfg.vocab_size, (rows, seq))
    variables = jmodel.init(jax.random.PRNGKey(0), batch["inputs"])
    params = jax.tree.map(np.asarray, variables["params"])
    if name == "t5-tiny":
        params = _scale_q(params, 16 ** -0.5)
    cfg = t_get_model(name).make_model(device="meta", **over).cfg
    return jmodel, {"params": params}, _convert(name)(params, cfg), batch


def _convert(name):
    """The family's converter (gpt2-mini is GPT-2's)."""
    return CONVERT[name.replace("-mini", "-tiny")]


def _reference(name, jmodel, variables, batch, strategy, min_size,
               sp_mode, steps=2):
    """The reference's TrainStep (AdamW) on ``strategy`` over four
    virtual devices (under ``sequence_parallel`` with an sp mode), its
    parameters laid out at ``min_size``."""
    import contextlib

    mesh = build_mesh(MeshSpec(**dict({"dp": 1}, **strategy)),
                      devices=jax.devices()[:4])
    sp = j_sequence_parallel(mesh, sp_mode, force=True) if sp_mode \
        else contextlib.nullcontext()
    with jax.default_matmul_precision("highest"), sp:
        step = j_make_train_step(
            j_get_model(name).loss_fn(jmodel),
            j_make_optimizer("adamw", LR), mesh, donate=False,
            param_shardings=make_param_shardings(
                variables, mesh, fsdp_min_size=min_size))
        state = step.init_state(variables)
        metrics = []
        for _ in range(steps):
            state, m = step(state, batch, None)
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.tree.map(np.asarray, state["params"])


# Leg 2's sizes at sp 2 x ep 2 (``__graft_entry__.dryrun_multichip``).
TOY = dict(B=2, S=16, H=2, D=8, E=4, F=16)
TOY_LR = 1e-3


def _toy_reference(data):
    """The reference's leg 2 ``step2``: (loss, updated params)."""
    from polyaxon_tpu.parallel import moe_layer, ring_attention

    mesh2 = build_mesh(MeshSpec(dp=-1, sp=2, ep=2),
                       devices=jax.devices()[:4])
    B, S, H, D = (TOY[k] for k in "BSHD")
    p2 = {k: jnp.asarray(data[k]) for k in ("wq", "wk", "wv", "router",
                                            "w1", "w2")}

    def loss2(p, x):
        q = (x @ p["wq"]).reshape(B, S, H, D)
        k = (x @ p["wk"]).reshape(B, S, H, D)
        v = (x @ p["wv"]).reshape(B, S, H, D)
        a = ring_attention(q, k, v, mesh2, causal=True)
        y = a.reshape(B, S, H * D)
        y, aux = moe_layer(y, p["router"], p["w1"], p["w2"], mesh2)
        return (y ** 2).mean() + 0.01 * aux

    @jax.jit
    def step2(p, x):
        l, g = jax.value_and_grad(loss2)(p, x)
        return l, jax.tree.map(lambda w, gw: w - TOY_LR * gw, p, g)

    with mesh2, jax.default_matmul_precision("highest"):
        l2, p2 = step2(p2, jnp.asarray(data["x"]))
    return float(l2), {k: np.asarray(v) for k, v in p2.items()}


def _toy_data():
    B, S, H, D, E, F = (TOY[k] for k in "BSHDEF")
    DM = H * D
    rng = np.random.RandomState(0)
    data = {n: (rng.randn(DM, DM) * 0.02).astype(np.float32)
            for n in ("wq", "wk", "wv")}
    data["router"] = (rng.randn(DM, E) * 0.02).astype(np.float32)
    data["w1"] = (rng.randn(E, DM, F) * 0.02).astype(np.float32)
    data["w2"] = (rng.randn(E, F, DM) * 0.02).astype(np.float32)
    data["x"] = rng.randn(B, S, DM).astype(np.float32)
    return data


@pytest.fixture(scope="module")
def compose_gang(tmp_path_factory):
    """One four-rank launch of every run (``RUNS`` and the toy), started
    beside the reference's steps.  Returns each run's per-rank outputs
    with the reference's results."""
    from test_torch_tp import gang_runs

    tmp = tmp_path_factory.mktemp("compose")
    runs, cases = [], []
    for i, (name, strategy, over, seq, min_size, mode, flash) in \
            enumerate(RUNS):
        jmodel, variables, sd, batch = _case(name, over, seq)
        weights, data = tmp / f"w{i}.pt", tmp / f"b{i}.npz"
        torch.save(sd, weights)
        np.savez(data, **batch)
        runs.append(dict(model=name, over=over, weights=str(weights),
                         batch=str(data), strategy=strategy, lr=LR,
                         steps=2, min_size=min_size, sp_mode=mode,
                         no_flash=flash == "plain", out=str(tmp / f"r{i}"),
                         ckpt=str(tmp / "ckpt") if i == 0 else None))
        cases.append((jmodel, variables, batch))
    toy = _toy_data()
    np.savez(tmp / "toy.npz", **toy)
    runs.append(dict(toy=str(tmp / "toy.npz"), lr=TOY_LR, no_flash=False,
                     strategy={"dp": 1, "sp": 2, "ep": 2},
                     out=str(tmp / "toy")))
    result = {}

    def launch():
        try:
            result["outs"] = gang_runs(tmp, runs, 4, worker=COMPOSE_WORKER,
                                       timeout=240.0)
        except BaseException as e:      # re-raised in the main thread
            result["error"] = e

    thread = threading.Thread(target=launch)
    thread.start()
    refs = []
    with pytest.MonkeyPatch.context() as mp:
        for (name, strategy, over, seq, min_size, mode, flash), \
                (jmodel, variables, batch) in zip(RUNS, cases):
            if flash == "plain":
                mp.delenv("POLYAXON_TPU_FLASH_INTERPRET", raising=False)
                mp.setenv("POLYAXON_TPU_NO_FLASH", "1")
            else:
                mp.delenv("POLYAXON_TPU_NO_FLASH", raising=False)
                mp.setenv("POLYAXON_TPU_FLASH_INTERPRET", "1")
            refs.append(_reference(name, jmodel, variables, batch,
                                   strategy, min_size, mode))
    toy_ref = _toy_reference(toy)
    thread.join()
    if "error" in result:
        raise result["error"]
    return {"runs": result["outs"][:-1], "refs": refs,
            "toy": result["outs"][-1], "toy_ref": toy_ref,
            "ckpt": tmp / "ckpt"}


def _storage_is_split(name, over, out, strategy, min_size):
    """Every rank holds 1/(tp * fsdp) of each leaf both axes shard,
    1/fsdp or 1/tp (ep) of each one axis shards, the whole of the
    rest, and the placements' fsdp leaves are FSDP's DTensors."""
    model = t_get_model(name).make_model(device="meta", **over)
    sizes = dict({a: 1 for a in tmesh.AXIS_ORDER}, **strategy)
    placed = tstrat.make_placements(model, _port_mesh(**sizes),
                                    fsdp_min_size=min_size)
    full = {n: p.numel() for n, p in model.named_parameters()}
    both = 0
    for rank in out:
        for pname, (tensor, fsdp) in placed.items():
            # The shards the rank holds: the placements' tensor axis,
            # and a column layer's bias beside its weight.
            shard = rank["shards"].get(pname)
            assert tensor is None or shard == tensor, (pname, shard)
            parts = (sizes[shard[0]] if shard else 1) * \
                (sizes["fsdp"] if fsdp is not None else 1)
            local, dtensor = rank["storage"][pname]
            assert local * parts == full[pname], (name, pname, local)
            assert dtensor == (fsdp is not None), (name, pname)
            both += int(shard is not None and fsdp is not None)
    return both // len(out)


@pytest.mark.parametrize("i", range(len(RUNS)), ids=IDS)
def test_composed_gang_trains_as_the_reference(compose_gang, i):
    """Two AdamW steps of ``RUNS[i]`` on four ranks: every rank's losses,
    ``grad_norm`` (and MoE's ``aux_loss``) within rtol 1e-5 of the
    reference's, its gathered parameters by Adam's rule; its storage
    split as the placements say; an sp run's attention on the ring in
    every layer."""
    name, strategy, over, seq, min_size, mode, _ = RUNS[i]
    out = compose_gang["runs"][i]
    want_m, want_p = compose_gang["refs"][i]
    cfg = t_get_model(name).make_model(device="meta", **over).cfg
    want_sd = _convert(name)(want_p["params"], cfg)
    keys = ("loss", "grad_norm") + (("aux_loss",) if "moe" in name else ())
    for rank in out:
        for g, w in zip(rank["metrics"], want_m, strict=True):
            for k in keys:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5,
                                           err_msg=f"{IDS[i]} {k}")
        _assert_params(rank["state"], {k: v for k, v in want_sd.items()
                                       if k in rank["state"]},
                       adam_lr=LR, steps=len(want_m))
    both = _storage_is_split(name, over, out, strategy, min_size)
    if "fsdp" in strategy and ("tp" in strategy or "ep" in strategy):
        assert both >= 4, (IDS[i], both)
    if mode:
        layers = 2 * (2 if over.get("remat") else 1)
        assert [r["routes"] for r in out] == [2 * layers] * 4, IDS[i]


def test_leg2_toy_loss_equals_the_references_step(compose_gang):
    """Ring attention into ``moe_layer`` over ``sp:2,ep:2``: the loss and
    every parameter after one SGD step equal the reference's leg 2
    ``step2`` (float32, 1e-5 of each tensor's largest magnitude)."""
    want_l, want_p = compose_gang["toy_ref"]
    for rank in compose_gang["toy"]:
        np.testing.assert_allclose(rank["loss"], want_l, rtol=1e-5)
        for k, w in want_p.items():
            g = rank["params"][k].numpy()
            assert g.shape == w.shape, k
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=k)


def test_composed_checkpoint_restores_on_both_axes_and_in_one_process(
        compose_gang):
    """The ``dp:1,fsdp:2,tp:2`` gang's collective checkpoint: restored
    into a fresh composed state, every rank's shards gather back to the
    saved parameters and Adam moments; restored in one process, the
    one-process layout (one optimizer group, the whole tensors) equals
    the gang's parameters, and its greedy tokens equal those of the
    gang's parameters."""
    from polyaxon_tpu_torch.checkpoint import CheckpointManager
    from polyaxon_tpu_torch.models.generate import generate

    out = compose_gang["runs"][0]
    for rank in out:
        params, moments = rank["restored"]
        for k, v in rank["state"].items():
            assert torch.equal(params[k], v), k
        assert moments.keys() == rank["moments"].keys()
        for k, v in rank["moments"].items():
            assert torch.equal(moments[k], v), k
    gathered = out[0]["state"]
    saved = CheckpointManager(str(compose_gang["ckpt"])).restore()
    assert saved["step"] == 2 and saved["params"].keys() == gathered.keys()
    for k, v in gathered.items():
        assert torch.equal(saved["params"][k], v), k
    assert len(saved["opt_state"]["param_groups"]) == 1
    names = [n for n, _ in t_get_model("gpt2-mini").make_model(
        device="meta", num_layers=2).named_parameters()]
    for i, n in enumerate(names):
        assert saved["opt_state"]["state"][i]["exp_avg"].shape == \
            saved["params"][n].shape, n
        assert torch.equal(saved["opt_state"]["state"][i]["exp_avg"],
                           out[0]["moments"][n]), n
    spec = t_get_model("gpt2-mini")
    models = []
    for sd in (saved["params"], gathered):
        m = spec.make_model(device="cpu", num_layers=2)
        m.load_state_dict(sd)
        models.append(m.eval().requires_grad_(False))
    prompt = torch.tensor([[3, 1, 4, 1, 5]])
    toks = [generate(m, prompt, max_new_tokens=6).tolist() for m in models]
    assert toks[0] == toks[1]


def test_train_main_composed_gang_equals_one_process(tmp_path,
                                                     monkeypatch):
    """``python -m polyaxon_tpu_torch.train --cpu --model gpt2-mini
    --strategy dp:1,fsdp:2,tp:2`` as four ranks: every rank logs the
    one-process run's losses (4 printed digits) and the chief's
    checkpoint, the one-process layout, holds its parameters (Adam's
    rule) and the same optimizer-state shapes."""
    from polyaxon_tpu_torch.checkpoint import CheckpointManager
    from test_torch_gang_run import TRAIN, _losses, _same_losses

    monkeypatch.setenv("POLYAXON_TPU_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    for name in ("POLYAXON_TPU_RUN_UUID", "PTPU_STRATEGY"):
        monkeypatch.delenv(name, raising=False)
    args = ["--model", "gpt2-mini", "--steps", "2", "--log-every", "1",
            "--batch-size", "4"]
    (tmp_path / "gang").mkdir()
    (tmp_path / "one").mkdir()
    one = subprocess.Popen(TRAIN + args, cwd=str(tmp_path / "one"),
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True,
                           env=dict(os.environ, OMP_NUM_THREADS="2"))
    try:
        outs = run_gang(TRAIN + args + ["--strategy", "dp:1,fsdp:2,tp:2"],
                        4, tmp_path / "gang")
        stdout, _ = one.communicate(timeout=120)
    finally:
        if one.poll() is None:
            one.kill()
            one.wait()
    assert one.returncode == 0, stdout[-3000:]
    want = _losses(stdout)
    for out in outs:
        _same_losses(_losses(out), want)
    g = CheckpointManager(str(tmp_path / "gang" / "checkpoints")).restore()
    w = CheckpointManager(str(tmp_path / "one" / "checkpoints")).restore()
    assert g["step"] == w["step"] == 2
    _assert_params(g["params"], w["params"], adam_lr=1e-3, steps=2)
    assert {i: {k: tuple(v.shape) for k, v in st.items()}
            for i, st in g["opt_state"]["state"].items()} == \
        {i: {k: tuple(v.shape) for k, v in st.items()}
         for i, st in w["opt_state"]["state"].items()}
