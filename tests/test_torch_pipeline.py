"""Pipeline parallelism in training: the port's GPipe and 1F1B schedules
over a pp gang against the JAX reference on the CPU.

The reference runs as its tests and its dry run run it (``TestPipeline``
and ``Test1F1B`` of ``tests/test_parallel.py``, ``tests/test_pp_tp.py``,
``__graft_entry__.dryrun_multichip``'s legs 3-6): its single-device
loss and gradients, its ``pipeline_apply`` and its own pipelined losses
over the conftest's virtual devices (dp x pp under jit, pp x tp eagerly);
the port runs as four real gloo processes, ONE launch for every run of
the module (``pp_gang``, started beside the reference's work), fed the
same numpy-seeded tokens and the reference's weights converted by
``convert.py``.  Attention is the plain path on both sides.

- Leg 3: ``pipeline_apply`` on the tanh stages of ``TestPipeline``
  (pp 4, 4 microbatches): the output and the gradients of its mean
  square against the reference's ``pipeline_apply`` (rtol / atol 1e-5);
  the microbatch ``ValueError``.
- Legs 4-6 and ``Test1F1B``: GPipe and 1F1B losses and every gradient
  of GPT-2 and Llama (vocab 256, hidden 64, 4 layers, 4 heads, Llama 2
  KV heads) in float32 at ``dp:2,pp:2``, ``pp:4``, ``pp:2,fsdp:2`` and
  ``pp:2,tp:2`` (Llama under remat too) against the reference's
  single-device value, and against its own pipelined loss where that
  runs on the CPU (``test_pp_tp.py``'s tolerances: loss atol 2e-5,
  gradients atol 3e-4 of each tensor's largest magnitude).
- The pp rule: ``make_stage_placements`` against the reference's
  ``infer_param_spec`` on the GPT-2 and Llama trees.  No gang.
- Each rank stores its stage's blocks only (and their optimizer state),
  split over fsdp / tp as the placements say; the pp ranks of one data
  coordinate read the same rows.
- The ``pp:2,fsdp:2`` gang's checkpoint restores into a fresh pp gang
  and into one process.
- ``train.main --strategy pp:2,dp:2`` as four ranks logs the
  one-process run's losses for three steps.
"""

from __future__ import annotations

import os
import subprocess
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from polyaxon_tpu.models.gpt2 import GPT2Block
from polyaxon_tpu.models.llama import LlamaBlock
from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu.parallel import MeshSpec, build_mesh
from polyaxon_tpu.parallel.pipeline import pipeline_apply as j_pipeline_apply
from polyaxon_tpu.parallel.pipeline import (pipelined_lm_loss as j_gpipe,
                                            pipelined_lm_loss_1f1b as j_1f1b)
from polyaxon_tpu.parallel.strategies import make_param_shardings
from polyaxon_tpu_torch import train as ttrain
from polyaxon_tpu_torch.models.registry import get_model as t_get_model
from polyaxon_tpu_torch.parallel import mesh as tmesh
from polyaxon_tpu_torch.parallel import pipeline as tpipe
from polyaxon_tpu_torch.parallel import strategies as tstrat
from test_torch_gang import ROOT, _assert_params, run_gang
from test_torch_tp import CONVERT, LR, _port_mesh, gang_runs

torch.set_num_threads(2)

# The reference tests' decoders: vocab 256, 4 layers, 64 positions.
OVER = {"vocab_size": 256, "num_layers": 4, "max_position": 64}
ROWS, SEQ = 16, 32

# Each run of the gang: the port model from converted weights, the
# pipelined loss of ``schedule`` in a train step over ``strategy`` whose
# AdamW records the reduced gradients it steps with; saved: the metrics,
# the gathered first gradients and final parameters, each parameter's
# local element count, the optimizer state's names, the rank's rows and
# coordinates, and (``ckpt``) a collective checkpoint restored into a
# fresh pp state.  An ``apply`` run is leg 3's pipeline.
WORKER = r"""
import json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
os.environ["POLYAXON_TPU_NO_FLASH"] = "1"
from polyaxon_tpu_torch.checkpoint import CheckpointManager
from polyaxon_tpu_torch.models.registry import get_model
from polyaxon_tpu_torch.parallel import (MeshSpec, build_mesh,
                                         make_train_step, pipeline_apply)
from polyaxon_tpu_torch.parallel.bootstrap import initialize_from_env
from polyaxon_tpu_torch.parallel.pipeline import (pipelined_lm_loss,
                                                  pipelined_lm_loss_1f1b)
from polyaxon_tpu_torch.parallel.strategies import gather_full, local_block

class Capture(torch.optim.AdamW):
    def step(self, closure=None):
        if not hasattr(self, "first"):
            self.first = {id(p): p.grad.detach().clone()
                          for g in self.param_groups for p in g["params"]}
        return super().step(closure)

def full(model, of):
    # name -> whole tensor of what ``of(param)`` gives, every parameter
    # of the one-process model (None where another stage holds it).
    local = dict(model.named_parameters())
    return {n: gather_full(model, n, of(local[n]) if n in local else None)
            for n in model.pipeline_layout.params}

def apply(run, mesh):
    d = np.load(run["data"])
    w, b = (torch.tensor(d[k], requires_grad=True) for k in ("w", "b"))
    x = torch.tensor(d["x"])
    y = pipeline_apply(lambda i, p, h: torch.tanh(h @ p[0] + p[1]),
                       (w, b), x, mesh, n_micro=4)
    loss = (y ** 2).mean()
    loss.backward()
    group = mesh.group("pp")
    for t in (w, b):
        torch.distributed.all_reduce(t.grad, group=group)
    return {"y": y.detach(), "loss": float(loss), "w": w.grad, "b": b.grad}

def build(run, mesh):
    spec = get_model(run["model"])
    model = spec.init_params(seed=1, device="cpu", train=True,
                             dtype=torch.float32, **run["over"])
    model.load_state_dict(torch.load(run["weights"]), strict=True)
    loss = (pipelined_lm_loss if run["schedule"] == "gpipe"
            else pipelined_lm_loss_1f1b)(model, mesh)
    step = make_train_step(
        loss, lambda p: Capture(p, lr=run["lr"], weight_decay=0.01), mesh,
        fsdp_min_size=run["min_size"])
    return model, step, step.init_state(model)

topo = initialize_from_env(device="cpu")
for run in json.load(open(sys.argv[1])):
    mesh = build_mesh(MeshSpec.from_dict(run["strategy"]), device="cpu")
    if run.get("data"):
        torch.save(apply(run, mesh), f"{run['out']}.{topo.process_id}.pt")
        continue
    model, step, state = build(run, mesh)
    tokens = np.load(run["batch"])
    local = {"inputs": torch.as_tensor(step.batch_sharding.shard(tokens))}
    metrics = []
    for _ in range(run["steps"]):
        state, m = step(state, local)
        metrics.append({k: float(v) for k, v in m.items()})
    opt = state["opt_state"]
    names = {id(p): n for n, p in model.named_parameters()}
    res = {"metrics": metrics,
           "grads": full(model, lambda p: opt.first[id(p)]),
           "params": full(model, lambda p: p),
           "storage": {n: local_block(p).numel()
                       for n, p in model.named_parameters()},
           "opt_names": sorted(names[id(p)] for p in opt.state),
           "shards": step.shards, "rows": local["inputs"],
           "coord": {a: mesh.coordinate(a)
                     for a in ("dp", "fsdp", "pp", "tp")}}
    if run.get("ckpt"):
        res["moments"] = full(model, lambda p: opt.state[p]["exp_avg"])
        ckpt = CheckpointManager(run["ckpt"])
        ckpt.save(state["step"], state)
        ckpt.wait()
        model2, _, state2 = build(run, mesh)
        state2 = ckpt.restore(template=state2)
        res["restored"] = (
            full(model2, lambda p: p),
            full(model2, lambda p: state2["opt_state"].state[p]["exp_avg"]))
    torch.save(res, f"{run['out']}.{topo.process_id}.pt")
print("ok", flush=True)
"""

DP_PP, FSDP_PP, TP_PP = {"dp": 2, "pp": 2}, {"pp": 2, "fsdp": 2}, \
    {"pp": 2, "tp": 2}
# name, strategy, schedule, config overrides, fsdp_min_size, the
# reference's own pipelined loss to compare with ("jit" at dp x pp,
# "eager" at pp x tp, as its tests run them).  Tiny GPT-2 and Llama hold
# no leaf of 2**16 elements: at 2**10 fsdp shards their matmul leaves.
RUNS = [
    ("gpt2-tiny", DP_PP, "gpipe", {}, 2 ** 16, "jit"),
    ("gpt2-tiny", DP_PP, "1f1b", {}, 2 ** 16, "jit"),
    ("gpt2-tiny", {"pp": 4}, "1f1b", {}, 2 ** 16, None),
    ("gpt2-tiny", FSDP_PP, "1f1b", {}, 2 ** 10, None),
    ("llama-tiny", DP_PP, "gpipe", {}, 2 ** 16, "jit"),
    ("llama-tiny", DP_PP, "1f1b", {"remat": True}, 2 ** 16, "jit"),
    ("llama-tiny", {"pp": 4}, "gpipe", {"remat": True}, 2 ** 16, None),
    ("llama-tiny", FSDP_PP, "gpipe", {}, 2 ** 10, None),
    ("llama-tiny", TP_PP, "gpipe", {}, 2 ** 16, None),
    ("llama-tiny", TP_PP, "1f1b", {}, 2 ** 16, "eager"),
]
IDS = ["gpt2 gpipe dp pp", "gpt2 1f1b dp pp", "gpt2 1f1b pp4",
       "gpt2 1f1b pp fsdp", "llama gpipe dp pp", "llama 1f1b dp pp remat",
       "llama gpipe pp4 remat", "llama gpipe pp fsdp", "llama gpipe pp tp",
       "llama 1f1b pp tp"]
CKPT_RUN = 3


def _case(name, over):
    """(flax model, variables, port state dict, numpy tokens) in float32."""
    jmodel = j_get_model(name).make_model(dtype=jnp.float32, **OVER, **over)
    tokens = np.random.RandomState(0).randint(0, OVER["vocab_size"],
                                              (ROWS, SEQ))
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    params = jax.tree.map(np.asarray, variables["params"])
    cfg = t_get_model(name).make_model(device="meta", **OVER, **over).cfg
    return jmodel, {"params": params}, CONVERT[name](params, cfg), tokens


def _reference(name, jmodel, variables, tokens, schedule, own, singles):
    """(loss, grads) of the reference's single-device loss (one a model,
    kept in ``singles``: remat changes no value), and of its own
    pipelined loss (``own``: "jit" at dp 2 x pp 2, "eager" at pp 2 x tp
    2 as ``test_pp_tp.py`` runs it), or None."""
    batch = {"inputs": jnp.asarray(tokens)}

    def ref_loss(p, b):
        logits = jmodel.apply(p, b["inputs"], train=True)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], b["inputs"][:, 1:]).mean()

    with jax.default_matmul_precision("highest"):
        if name not in singles:
            singles[name] = jax.jit(jax.value_and_grad(ref_loss))(
                variables, batch)
        single = singles[name]
        if own is None:
            return single, None
        spec = MeshSpec(dp=2, pp=2) if own == "jit" else MeshSpec(pp=2,
                                                                   tp=2)
        mesh = build_mesh(spec, devices=jax.devices()[:4])
        block = (GPT2Block if name.startswith("gpt2") else LlamaBlock)(
            jmodel.cfg)
        loss = (j_gpipe if schedule == "gpipe" else j_1f1b)(jmodel, block,
                                                           mesh)
        grad = jax.value_and_grad(loss, has_aux=True)
        if own == "jit":
            grad = jax.jit(grad)
        (l, _), g = grad(variables, batch, None)
    return single, (l, g)


# Leg 3: TestPipeline.test_matches_sequential's stages and input.
def _apply_data():
    rng = np.random.default_rng(4)
    return {"w": (rng.normal(size=(4, 16, 16)) * 0.1).astype(np.float32),
            "b": (rng.normal(size=(4, 16)) * 0.1).astype(np.float32),
            "x": rng.normal(size=(8, 16)).astype(np.float32)}


def _apply_reference(data):
    """The reference's pipeline_apply at dp 2 x pp 4 (its test's mesh):
    the output, the mean square and its gradients, and the sequential
    stages' output."""
    mesh = build_mesh(MeshSpec(dp=2, pp=4), devices=jax.devices()[:8])
    w, b, x = (jnp.asarray(data[k]) for k in ("w", "b", "x"))

    def stage_fn(i, p, h):
        return jnp.tanh(h @ p[0] + p[1])

    def loss(w, b):
        y = j_pipeline_apply(stage_fn, (w, b), x, mesh, n_micro=4)
        return (y ** 2).mean(), y

    with jax.default_matmul_precision("highest"):
        (l, y), (gw, gb) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(w, b)
    seq = x
    for i in range(4):
        seq = jnp.tanh(seq @ w[i] + b[i])
    return {"y": np.asarray(y), "loss": float(l), "w": np.asarray(gw),
            "b": np.asarray(gb), "sequential": np.asarray(seq)}


@pytest.fixture(scope="module")
def pp_gang(tmp_path_factory):
    """One four-rank launch of every run (``RUNS`` and leg 3), started
    beside the reference's work.  Returns each run's per-rank outputs
    with the reference's results."""
    tmp = tmp_path_factory.mktemp("pipeline")
    runs, cases = [], []
    for i, (name, strategy, schedule, over, min_size, _) in enumerate(RUNS):
        jmodel, variables, sd, tokens = _case(name, over)
        weights, batch = tmp / f"w{i}.pt", tmp / f"b{i}.npy"
        torch.save(sd, weights)
        np.save(batch, tokens)
        runs.append(dict(model=name, over=dict(OVER, **over),
                         weights=str(weights), batch=str(batch),
                         strategy=strategy, schedule=schedule, lr=LR,
                         steps=2, min_size=min_size, out=str(tmp / f"r{i}"),
                         ckpt=str(tmp / "ckpt") if i == CKPT_RUN else None))
        cases.append((jmodel, variables, tokens))
    data = _apply_data()
    np.savez(tmp / "apply.npz", **data)
    runs.append(dict(data=str(tmp / "apply.npz"), strategy={"pp": 4},
                     out=str(tmp / "apply")))
    result = {}

    def launch():
        try:
            result["outs"] = gang_runs(tmp, runs, 4, worker=WORKER,
                                       timeout=240.0)
        except BaseException as e:      # re-raised in the main thread
            result["error"] = e

    thread = threading.Thread(target=launch)
    thread.start()
    refs, singles = [], {}
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("POLYAXON_TPU_FLASH_INTERPRET", raising=False)
        mp.setenv("POLYAXON_TPU_NO_FLASH", "1")
        for (name, _, schedule, _, _, own), (jmodel, variables, tokens) \
                in zip(RUNS, cases):
            refs.append(_reference(name, jmodel, variables, tokens,
                                   schedule, own, singles))
    apply_ref = _apply_reference(data)
    thread.join()
    if "error" in result:
        raise result["error"]
    return {"runs": result["outs"][:-1], "refs": refs,
            "apply": result["outs"][-1], "apply_ref": apply_ref,
            "ckpt": tmp / "ckpt"}


def _port_grads(name, over, grads):
    cfg = t_get_model(name).make_model(device="meta", **OVER, **over).cfg
    return CONVERT[name](jax.tree.map(np.asarray, grads["params"]), cfg)


def test_leg3_pipeline_apply_equals_the_references(pp_gang):
    """``pipeline_apply`` of four tanh stages over pp 4, four
    microbatches: every rank's output equals the reference's
    ``pipeline_apply`` and the sequential stages (rtol / atol 1e-5), and
    the gradients of its mean square (the stacked parameters' summed
    over pp) the reference's."""
    want = pp_gang["apply_ref"]
    np.testing.assert_allclose(want["y"], want["sequential"], rtol=1e-5,
                               atol=1e-5)
    for rank in pp_gang["apply"]:
        np.testing.assert_allclose(rank["y"].numpy(), want["y"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(rank["loss"], want["loss"], rtol=1e-5)
        for k in ("w", "b"):
            np.testing.assert_allclose(rank[k].numpy(), want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_pipeline_apply_batch_divisibility():
    """The reference's ``ValueError`` when the rows do not split into
    the microbatches (``TestPipeline.test_batch_divisibility``)."""
    with pytest.raises(ValueError, match="Batch 6 must divide into 4 "
                                         "microbatches"):
        tpipe.pipeline_apply(lambda i, p, x: x, torch.zeros(8, 1),
                             torch.zeros(6, 4), None, n_micro=4)


@pytest.mark.parametrize("i", range(len(RUNS)), ids=IDS)
def test_pipelined_loss_and_grads_equal_the_references(pp_gang, i):
    """The first step's loss and every gathered gradient on every rank
    against the reference's single-device value, and against its own
    pipelined loss where that runs here (loss atol 2e-5, each gradient
    atol 3e-4 of its largest magnitude); the second step's loss follows
    the AdamW update (finite, below the first)."""
    name, _, schedule, over, _, own = RUNS[i]
    (l1, g1), pipelined = pp_gang["refs"][i]
    wants = [(float(l1), _port_grads(name, over, g1), "single device")]
    if pipelined is not None:
        wants.append((float(pipelined[0]),
                      _port_grads(name, over, pipelined[1]),
                      f"reference {schedule} ({own})"))
    for rank in pp_gang["runs"][i]:
        loss = rank["metrics"][0]["loss"]
        assert np.isfinite(rank["metrics"][1]["loss"]) and \
            rank["metrics"][1]["loss"] < loss, rank["metrics"]
        for want_l, want_g, label in wants:
            np.testing.assert_allclose(loss, want_l, atol=2e-5,
                                       err_msg=f"{IDS[i]} vs {label}")
            assert rank["grads"].keys() == want_g.keys()
            for k, w in want_g.items():
                w = np.asarray(w, np.float32)
                np.testing.assert_allclose(
                    rank["grads"][k].numpy(), w, rtol=0,
                    atol=3e-4 * (np.abs(w).max() + 1e-8),
                    err_msg=f"{IDS[i]} {k} vs {label}")


def test_each_rank_stores_only_its_stage(pp_gang):
    """Every rank holds the blocks of its stage (block i on pp rank
    ``i // (4 / pp)``), the embedding, the final norm and the head, each
    split over fsdp / tp as ``make_placements`` says, and optimizer
    state for exactly what it holds."""
    for i, (name, strategy, _, over, min_size, _) in enumerate(RUNS):
        model = t_get_model(name).make_model(device="meta", **OVER, **over)
        sizes = dict({a: 1 for a in tmesh.AXIS_ORDER}, **strategy)
        placed = tstrat.make_placements(model, _port_mesh(**sizes),
                                        fsdp_min_size=min_size)
        full = {n: p.numel() for n, p in model.named_parameters()}
        per = OVER["num_layers"] // strategy["pp"]
        for rank in pp_gang["runs"][i]:
            stage = rank["coord"]["pp"]
            held = {n for n in full if not n.startswith("h.") or
                    stage * per <= int(n.split(".")[1]) < (stage + 1) * per}
            assert set(rank["storage"]) == held, IDS[i]
            assert rank["opt_names"] == sorted(held), IDS[i]
            for pname in held:
                tensor, fsdp = placed[pname]
                shard = rank["shards"].get(pname)
                assert tensor is None or shard == tensor, (pname, shard)
                parts = (sizes[shard[0]] if shard else 1) * \
                    (sizes["fsdp"] if fsdp is not None else 1)
                assert rank["storage"][pname] * parts == full[pname], \
                    (IDS[i], pname)


def test_pp_ranks_of_a_data_coordinate_read_the_same_rows(pp_gang):
    """Rows are sharded over dp and fsdp only: the pp (and tp) ranks of
    one data coordinate hold the same rows, and the data coordinates'
    rows in order are the global batch."""
    for i, (_, strategy, _, _, _, _) in enumerate(RUNS):
        tokens = np.random.RandomState(0).randint(0, OVER["vocab_size"],
                                                  (ROWS, SEQ))
        by_data = {}
        for rank in pp_gang["runs"][i]:
            key = (rank["coord"]["dp"], rank["coord"]["fsdp"])
            rows = rank["rows"].numpy()
            if key in by_data:
                assert np.array_equal(by_data[key], rows), IDS[i]
            by_data[key] = rows
        assert np.array_equal(np.concatenate(
            [by_data[k] for k in sorted(by_data)]), tokens), IDS[i]


def test_pp_checkpoint_restores_into_a_pp_gang_and_one_process(pp_gang):
    """The ``pp:2,fsdp:2`` gang's collective checkpoint: restored into a
    fresh pp state, every rank's stage gathers back to the saved
    parameters and Adam moments; restored in one process, the
    one-process layout (one optimizer group, every block's state) holds
    the gang's parameters, and a one-process AdamW loads it."""
    from polyaxon_tpu_torch.checkpoint import CheckpointManager

    out = pp_gang["runs"][CKPT_RUN]
    for rank in out:
        params, moments = rank["restored"]
        for k, v in rank["params"].items():
            assert torch.equal(params[k], v), k
        for k, v in rank["moments"].items():
            assert torch.equal(moments[k], v), k
    saved = CheckpointManager(str(pp_gang["ckpt"])).restore()
    model = t_get_model("gpt2-tiny").make_model(
        device="cpu", param_dtype=torch.float32, dtype=torch.float32,
        **OVER)
    names = [n for n, _ in model.named_parameters()]
    assert saved["step"] == 2 and list(saved["params"]) == \
        list(model.state_dict())
    for n in names:
        assert torch.equal(saved["params"][n], out[0]["params"][n]), n
    assert saved["opt_state"]["param_groups"][0]["params"] == \
        list(range(len(names)))
    for i, n in enumerate(names):
        assert torch.equal(saved["opt_state"]["state"][i]["exp_avg"],
                           out[0]["moments"][n]), n
    model.load_state_dict(saved["params"])
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=0.01)
    opt.load_state_dict(saved["opt_state"])
    assert len(opt.state) == len(names)


def test_pp_rule_equals_the_references_infer_param_spec():
    """The reference's ``make_param_shardings`` on a ``pp:2`` mesh puts
    pp on the layer axis of every stacked block leaf of GPT-2 and Llama
    and nowhere else; through the converter, the port's
    ``make_stage_placements`` holds exactly those parameters on a pp
    rank, block i on ``i // 2``, and ``infer_param_spec`` with ``pp``
    gives the reference's spec of each stacked leaf."""
    from polyaxon_tpu.parallel.strategies import \
        infer_param_spec as j_infer_param_spec

    ref = build_mesh(MeshSpec(dp=1, pp=2), devices=jax.devices()[:2])
    mesh = _port_mesh(pp=2)
    for name in ("gpt2-tiny", "llama-tiny"):
        jmodel = j_get_model(name).make_model(dtype=jnp.float32, **OVER)
        shapes = jax.eval_shape(
            lambda x: jmodel.init(jax.random.PRNGKey(0), x),
            jnp.zeros((2, 8), jnp.int32))["params"]
        shard = make_param_shardings(shapes, ref)
        flags = jax.tree.map(
            lambda leaf, sh: np.full(leaf.shape, float(
                len(sh.spec) > 0 and sh.spec[0] == "pp"), np.float32),
            shapes, shard)
        model = t_get_model(name).make_model(device="meta", **OVER)
        want = CONVERT[name](flags, model.cfg)
        got = tstrat.make_stage_placements(model, mesh)
        assert got.keys() == {n for n, _ in model.named_parameters()}
        stacked = 0
        for pname, owner in got.items():
            on_pp = bool(want[pname].all())
            assert on_pp == bool(want[pname].any()), pname
            assert (owner is not None) == on_pp, (name, pname)
            if on_pp:
                assert owner == int(pname.split(".")[1]) // 2, pname
                stacked += 1
        assert stacked == sum(n.startswith("h.") for n in got)
        for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            j_spec = tuple(j_infer_param_spec(path, leaf, pp=True))
            t_spec = tstrat.infer_param_spec(key, leaf.shape, pp=True)
            assert t_spec == j_spec + (None,) * (len(t_spec) - len(j_spec)), \
                key


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_one_stage_pipelined_loss_equals_the_models_loss(schedule):
    """With no pp axis (no mesh) the pipelined loss is the model's next-
    token loss over 2 microbatches: loss and every gradient of the
    registry's loss, a Llama under remat (float32, 2e-6 / 1e-5 of each
    gradient's largest magnitude)."""
    spec = t_get_model("llama-tiny")
    tokens = torch.as_tensor(np.random.RandomState(2).randint(0, 512,
                                                              (4, 24)))
    got = []
    for pipelined in (True, False):
        model = spec.init_params(seed=3, device="cpu", train=True,
                                 dtype=torch.float32, remat=True)
        loss_fn = (tpipe.pipelined_lm_loss if schedule == "gpipe" else
                   tpipe.pipelined_lm_loss_1f1b)(model, None) \
            if pipelined else spec.loss_fn(model)
        loss, aux = loss_fn({"inputs": tokens})
        loss.backward()
        got.append((loss.item(), aux["perplexity"].item(),
                    {n: p.grad for n, p in model.named_parameters()}))
    (l, ppl, g), (wl, wppl, wg) = got
    assert abs(l - wl) <= 2e-6 and abs(ppl - wppl) <= 1e-5 * wppl
    for k, w in wg.items():
        torch.testing.assert_close(g[k], w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()))


def test_pipeline_refusals_are_the_references():
    """The reference's messages: pp that does not divide the layers, a
    batch that does not split into the microbatches, a model outside the
    scanned GPT-2 and Llama families and an unknown ``pp_schedule``
    under ``train``; 1f1b is the default schedule and gpipe selects
    GPipe."""
    model = t_get_model("gpt2-tiny").make_model(device="cpu", num_layers=4)
    with pytest.raises(ValueError, match="pp=3 must divide num_layers=4"):
        tpipe.pipelined_lm_loss_1f1b(model, _port_mesh(pp=3))
    loss = tpipe.pipelined_lm_loss(model, None)
    with pytest.raises(ValueError, match="batch 3 must divide into 2 "
                                         "microbatches"):
        loss({"inputs": torch.zeros(3, 8, dtype=torch.long)})
    args = SimpleNamespace(model="bert-tiny")
    mesh = _port_mesh(pp=2)
    with pytest.raises(SystemExit, match="strategy pp>1 supports the "
                       "scanned GPT-2 and Llama families, not bert-tiny"):
        ttrain._pipeline_loss(args, {"pp": 2}, t_get_model("bert-tiny"),
                              mesh)
    args.model = "llama-tiny"
    with pytest.raises(SystemExit, match="pp_schedule must be '1f1b' or "
                                         "'gpipe', got 'zb'"):
        ttrain._pipeline_loss(args, {"pp": 2, "pp_schedule": "zb"},
                              t_get_model("llama-tiny"), mesh)
    assert ttrain._pipeline_loss(args, {"pp": 2}, t_get_model(
        "llama-tiny"), mesh) is tpipe.pipelined_lm_loss_1f1b
    assert ttrain._pipeline_loss(args, {"pp": 2, "pp_schedule": "GPipe"},
                                 t_get_model("llama-tiny"), mesh) is \
        tpipe.pipelined_lm_loss
    assert ttrain._pipeline_loss(args, {}, t_get_model("llama-tiny"),
                                 _port_mesh()) is None


def test_train_main_pp_gang_equals_one_process(tmp_path, monkeypatch):
    """``python -m polyaxon_tpu_torch.train --cpu --model gpt2-mini
    --strategy pp:2,dp:2`` (1F1B) as four ranks: three steps whose
    losses every rank logs as the one-process run does (the reference's
    ``matching_dp_only`` tests), and the chief's checkpoint, the
    one-process layout, holds its parameters (Adam's rule)."""
    from polyaxon_tpu_torch.checkpoint import CheckpointManager
    from test_torch_gang_run import TRAIN, _losses, _same_losses

    monkeypatch.setenv("POLYAXON_TPU_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    for name in ("POLYAXON_TPU_RUN_UUID", "PTPU_STRATEGY"):
        monkeypatch.delenv(name, raising=False)
    args = ["--model", "gpt2-mini", "--steps", "3", "--log-every", "1",
            "--batch-size", "8"]
    (tmp_path / "gang").mkdir()
    (tmp_path / "one").mkdir()
    one = subprocess.Popen(TRAIN + args, cwd=str(tmp_path / "one"),
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True,
                           env=dict(os.environ, OMP_NUM_THREADS="2"))
    try:
        outs = run_gang(TRAIN + args + ["--strategy", "pp:2,dp:2"], 4,
                        tmp_path / "gang")
        stdout, _ = one.communicate(timeout=120)
    finally:
        if one.poll() is None:
            one.kill()
            one.wait()
    assert one.returncode == 0, stdout[-3000:]
    want = _losses(stdout)
    assert len(want) == 3
    for out in outs:
        assert "batch 8," in out
        _same_losses(_losses(out), want)
    g = CheckpointManager(str(tmp_path / "gang" / "checkpoints")).restore()
    w = CheckpointManager(str(tmp_path / "one" / "checkpoints")).restore()
    assert g["step"] == w["step"] == 3
    _assert_params(g["params"], w["params"], adam_lr=1e-3, steps=3)
