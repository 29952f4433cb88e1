"""The port's training path against the JAX reference, on the CPU.

- GPT-2 loss and every gradient against ``jax.value_and_grad`` of the
  reference registry's ``loss_fn``, on the reference's flax params
  carried across by ``convert.gpt2_state_dict_from_jax`` (the same name
  mapping applied to the gradient tree).  The model is flash-eligible
  (hidden 128, 2 heads of 64, 2 layers, seq 128, float32): the reference
  runs its Pallas kernels in interpret mode, the port its plain versions.
  Tolerance: rtol 1e-4, and atol 1e-4 of the tensor's largest |grad|
  (float32 on both sides; sums run in another order).
- Three AdamW and three SGD steps against optax's ``update`` + ``p + u``;
  ``grad_accum=2`` against the reference's scan semantics.  Tolerance on
  params 2e-6 (updates of lr 1e-3 from gradients that agree to 1e-6
  relative).  Adam's update lr * m / (sqrt(v) + eps) turns a rounding
  difference d of a gradient near eps = 1e-8 into an update difference
  of about lr * d / eps, so elements whose gradient fell below 1e-7 at
  some step (the key slice of each QKV bias, whose gradient is zero in
  exact arithmetic, and a few cancellations) are held to Adam's step
  bound, 2 lr a step, instead; at least 99% get the tight check.
- The datasets' batches equal ``polyaxon_tpu.data``'s for the same seed,
  epoch and ``start_step``.
- A run stopped at a checkpoint and resumed ends with the same params
  and optimizer state as an unbroken run.
- ``train.main`` on the CPU, and its refusals of what is not ported.
"""

from __future__ import annotations

import dataclasses
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import polyaxon_tpu.data as jdata
import polyaxon_tpu.ops.flash as jfl
from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu.train import make_optimizer as j_make_optimizer
from polyaxon_tpu_torch import checkpoint as tckpt
from polyaxon_tpu_torch import data as tdata
from polyaxon_tpu_torch import train as ttrain
from polyaxon_tpu_torch.convert import gpt2_state_dict_from_jax
from polyaxon_tpu_torch.models.kv_cache import kv_cache_dims
from polyaxon_tpu_torch.models.registry import get_model as t_get_model
from polyaxon_tpu_torch.ops import attention as tat
from polyaxon_tpu_torch.parallel import make_train_step

torch.set_num_threads(2)

FLASH_MODEL = dict(hidden_size=128, num_heads=2)  # gpt2-tiny, head dim 64


def _pair(seq, remat=False, **over):
    """(flax model, flax variables, port model with the same weights,
    numpy batch) from gpt2-tiny through both registries, float32."""
    jspec, tspec = j_get_model("gpt2-tiny"), t_get_model("gpt2-tiny")
    jmodel = jspec.make_model(dtype=jnp.float32, remat=remat, **over)
    tokens = np.random.RandomState(0).randint(0, 1024, (2, seq))
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    tmodel = tspec.init_params(seed=1, device="cpu", train=True,
                               dtype=torch.float32, remat=remat, **over)
    params = jax.tree.map(np.asarray, variables["params"])
    tmodel.load_state_dict(gpt2_state_dict_from_jax(params, tmodel.cfg),
                           strict=True)
    return jmodel, variables, tmodel, {"inputs": tokens}


def _assert_grads(tmodel, jgrads):
    want = gpt2_state_dict_from_jax(
        jax.tree.map(np.asarray, jgrads["params"]), tmodel.cfg)
    got = {n: p.grad for n, p in tmodel.named_parameters()}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(
            got[name].numpy(), w, rtol=1e-4,
            atol=1e-4 * max(float(np.abs(w).max()), 1e-12), err_msg=name)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(remat, monkeypatch):
    monkeypatch.setenv("POLYAXON_TPU_FLASH_INTERPRET", "1")
    monkeypatch.setattr(jfl, "BLOCK_Q", 128)
    monkeypatch.setattr(jfl, "BLOCK_KV", 128)
    calls = []
    real = tat.flash_attention
    monkeypatch.setattr(tat, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    jmodel, variables, tmodel, batch = _pair(128, remat=remat,
                                             **FLASH_MODEL)
    with jax.default_matmul_precision("highest"):
        (jloss, jaux), jgrads = jax.value_and_grad(
            j_get_model("gpt2-tiny").loss_fn(jmodel), has_aux=True)(
                variables, batch, None)
    loss, aux = t_get_model("gpt2-tiny").loss_fn(tmodel)(batch)
    loss.backward()
    # The flash route; remat runs each block's forward again in the
    # backward.
    assert len(calls) == tmodel.cfg.num_layers * (2 if remat else 1)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(aux["perplexity"].item(),
                               float(jaux["perplexity"]), rtol=1e-4)
    _assert_grads(tmodel, jgrads)


def test_named_remat_policy_is_refused():
    """The named policies are ported (``test_torch_remat.py``); a name
    the port does not implement is refused."""
    t_get_model("gpt2-tiny").init_params(
        device="cpu", train=True, remat=True, remat_policy="dots_saveable")
    with pytest.raises(ValueError, match="remat policies"):
        t_get_model("gpt2-tiny").init_params(
            device="cpu", train=True, remat=True,
            remat_policy="save_only_these_names")


def _reference_steps(jmodel, variables, batches, optimizer, accum=1):
    """The reference's TrainStep math on one device: value_and_grad,
    micro-batch averaging as its scan does, optax update, p + u."""
    loss_fn = j_get_model("gpt2-tiny").loss_fn(jmodel)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    params = variables
    opt_state = optimizer.init(params)
    metrics = []
    for batch in batches:
        micro = [{k: v.reshape((accum, -1) + v.shape[1:])[i]
                  for k, v in batch.items()} for i in range(accum)]
        outs = [grad_fn(params, mb, None) for mb in micro]
        loss = sum(o[0][0] for o in outs) / accum
        aux = {k: sum(o[0][1][k] for o in outs) / accum
               for k in outs[0][0][1]}
        grads = jax.tree.map(lambda *g: sum(g) / accum,
                             *[o[1] for o in outs])
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        metrics.append({"loss": float(loss),
                        "grad_norm": float(optax.global_norm(grads)),
                        **{k: float(v) for k, v in aux.items()}})
    return params, metrics


def _port_steps(tmodel, batches, optimizer_name, accum=1):
    """(metrics of each step, {name: the smallest nonzero |grad| of each
    element over the steps})."""
    step_fn = make_train_step(t_get_model("gpt2-tiny").loss_fn(tmodel),
                              ttrain.make_optimizer(optimizer_name, 1e-3),
                              grad_accum=accum)
    state = step_fn.init_state(tmodel)
    metrics, small = [], {}
    for batch in batches:
        state, m = step_fn(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        for n, p in tmodel.named_parameters():
            # An exact zero (a position no batch reaches) is no rounding
            # noise: both sides leave the element to weight decay alone.
            g = p.grad.abs().masked_fill(p.grad == 0, float("inf"))
            small[n] = g if n not in small else torch.minimum(small[n], g)
    assert state["step"] == len(batches)
    return metrics, small


def _batches(n, rows=4, seq=64):
    rng = np.random.RandomState(7)
    return [{"inputs": rng.randint(0, 1024, (rows, seq))} for _ in range(n)]


def _assert_params(tmodel, jparams, small=None, steps=3, lr=1e-3):
    """Params equal within 2e-6; with ``small`` (Adam), elements whose
    gradient fell below 1e-7 are held to Adam's step bound instead."""
    want = gpt2_state_dict_from_jax(
        jax.tree.map(np.asarray, jparams["params"]), tmodel.cfg)
    tight = total = 0
    for name, p in tmodel.named_parameters():
        got, w = p.detach().numpy(), want[name].numpy()
        atol = np.full(got.shape, 2e-6, np.float32)
        if small is not None:
            atol[small[name].numpy() < 1e-7] = 2 * steps * lr
            if name.endswith("qkv.bias"):  # the key slice: zero gradient
                h = tmodel.cfg.hidden_size
                atol[h:2 * h] = 2 * steps * lr
        tight += int((atol == 2e-6).sum())
        total += atol.size
        assert (np.abs(got - w) <= atol).all(), \
            f"{name}: max |d| {np.abs(got - w).max()}"
    assert tight >= 0.99 * total


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_three_optimizer_steps_match_optax(optimizer):
    jmodel, variables, tmodel, _ = _pair(64)
    batches = _batches(3)
    jparams, jmetrics = _reference_steps(
        jmodel, variables, batches, j_make_optimizer(optimizer, 1e-3))
    metrics, small = _port_steps(tmodel, batches, optimizer)
    for got, want in zip(metrics, jmetrics):
        for key in ("loss", "grad_norm", "perplexity"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5)
    _assert_params(tmodel, jparams, small if optimizer == "adamw" else None)


def test_grad_accum_matches_reference_scan():
    jmodel, variables, tmodel, _ = _pair(64)
    batches = _batches(1, rows=8)
    jparams, jmetrics = _reference_steps(
        jmodel, variables, batches, j_make_optimizer("adamw", 1e-3),
        accum=2)
    metrics, small = _port_steps(tmodel, batches, "adamw", accum=2)
    for key in ("loss", "grad_norm", "perplexity"):
        np.testing.assert_allclose(metrics[0][key], jmetrics[0][key],
                                   rtol=1e-5)
    _assert_params(tmodel, jparams, small, steps=1)


def test_master_weights_compute_like_serving():
    """train=True holds float32 parameters and casts each at its use, so
    a bf16 model computes exactly what the bf16 serving copy (the same
    init rounded once) computes; an AdamW step then moves the float32
    master weights by far less than one bf16 ulp."""
    spec = t_get_model("gpt2-tiny")
    serve = spec.init_params(seed=3, device="cpu")
    train = spec.init_params(seed=3, device="cpu", train=True)
    assert all(p.dtype == (torch.float32 if ".ln" in n or "ln_f" in n
                           else torch.bfloat16)
               for n, p in serve.named_parameters())  # LayerNorms: f32
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in train.parameters())
    tokens = torch.from_numpy(np.random.RandomState(0).randint(0, 1024,
                                                               (2, 64)))
    with torch.no_grad():
        assert torch.equal(serve(tokens), train(tokens))
    before = train.h[0].fc1.weight.detach().clone()
    step_fn = make_train_step(spec.loss_fn(train),
                              ttrain.make_optimizer("adamw", 1e-5))
    step_fn(step_fn.init_state(train), {"inputs": tokens})
    moved = (train.h[0].fc1.weight.detach() - before).abs()
    assert 0 < moved.max().item() < 2e-5
    assert not torch.equal(train.h[0].fc1.weight.detach(), before)


def test_one_device_only():
    """With no process group a mesh is this process's one device: axis
    sizes naming more raise the reference's ``MeshError``; a tp axis
    above 1 on a gang is refused by the parallelism item
    (``test_torch_mesh.py``)."""
    from polyaxon_tpu_torch.parallel.mesh import MeshError

    spec = t_get_model("gpt2-tiny")
    step = make_train_step(spec.loss_fn, ttrain.make_optimizer("sgd", 1e-3),
                           {"dp": -1, "tp": 1})
    assert not step.distributed and step.mesh.shape["dp"] == 1
    from polyaxon_tpu.parallel.mesh import MeshSpec as JMeshSpec

    with pytest.raises(ValueError) as want:
        JMeshSpec(dp=2).resolve(1)
    with pytest.raises(MeshError) as got:
        make_train_step(spec.loss_fn, ttrain.make_optimizer("sgd", 1e-3),
                        {"dp": 2})
    assert str(got.value) == str(want.value)


# name: (dataset builder taking the data module, start_step)
def _synthetic(mod, spec_getter):
    return mod.synthetic_dataset(spec_getter("gpt2-tiny"), 4, seed=3)


def _array(mod, _):
    rng = np.random.RandomState(11)
    return mod.ArrayDataset({"inputs": rng.randint(0, 50, (37, 5)),
                             "labels": rng.randint(0, 3, (37,))}, 8,
                            seed=5)


def _windows(mod, _):
    tokens = np.random.RandomState(12).randint(0, 1000, 3000)
    return mod.TokenWindowDataset(tokens, 4, 32, seed=6)


DATASETS = {"synthetic": _synthetic, "array": _array, "windows": _windows}


@pytest.mark.parametrize("start_step", [0, 3, 70])
@pytest.mark.parametrize("kind", sorted(DATASETS))
def test_batches_match_reference(kind, start_step):
    j = DATASETS[kind](jdata, j_get_model)
    t = DATASETS[kind](tdata, t_get_model)
    assert t.steps_per_epoch == j.steps_per_epoch
    jb = j.epochs(None, start_step=start_step)
    tb = t.epochs(None, start_step=start_step)
    for _ in range(5):
        a, b = next(jb), next(tb)
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])


def test_prefetch_yields_the_stream_as_tensors():
    ds = _windows(tdata, None)
    want = list(ds.epoch(0))
    got = list(tdata.prefetch_to_device(iter(want), "cpu", depth=2))
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert isinstance(g["inputs"], torch.Tensor)
        np.testing.assert_array_equal(g["inputs"].numpy(), w["inputs"])


def _final_state(home):
    ckpt = tckpt.CheckpointManager(
        str(home / "runs" / "r" / "artifacts" / "outputs" / "checkpoints"))
    return ckpt.latest_step(), ckpt.restore()


def test_resumed_run_matches_unbroken_run(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("POLYAXON_TPU_RUN_UUID", "r")
    args = ["--cpu", "--model", "gpt2-tiny", "--log-every", "1",
            "--batch-size", "4"]
    monkeypatch.setenv("POLYAXON_TPU_HOME", str(tmp_path / "a"))
    assert ttrain.main(args + ["--steps", "4"]) == 0
    monkeypatch.setenv("POLYAXON_TPU_HOME", str(tmp_path / "b"))
    assert ttrain.main(args + ["--steps", "2"]) == 0
    assert ttrain.main(args + ["--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert "resuming from checkpoint step 2" in out
    step_a, a = _final_state(tmp_path / "a")
    step_b, b = _final_state(tmp_path / "b")
    assert step_a == step_b == 4 and a["step"] == b["step"] == 4
    for name, t in a["params"].items():
        torch.testing.assert_close(b["params"][name], t, rtol=0, atol=0)
    for idx, st in a["opt_state"]["state"].items():
        for key, t in st.items():
            torch.testing.assert_close(b["opt_state"]["state"][idx][key], t,
                                       rtol=0, atol=0)


def test_checkpoints_keep_the_newest_and_skip_repeats(tmp_path):
    model = torch.nn.Linear(2, 2)
    ckpt = tckpt.CheckpointManager(str(tmp_path))
    for step in range(1, 6):
        assert ckpt.save(step, {"params": model, "step": step})
    assert not ckpt.save(5, {"params": model, "step": 5})
    ckpt.wait()
    assert ckpt.all_steps() == [3, 4, 5]
    assert not any(".tmp" in p.name for p in tmp_path.iterdir())
    with torch.no_grad():
        model.weight.zero_()
    state, step = ckpt.restore_or_init({"params": model, "step": 0})
    assert step == 5 and state["step"] == 5
    assert state["params"] is model and model.weight.abs().sum() > 0


def test_preemption_hook_is_cooperative(tmp_path):
    import os
    import signal

    ckpt = tckpt.CheckpointManager(str(tmp_path))
    old = signal.getsignal(signal.SIGTERM)
    try:
        ckpt.install_preemption_hook()
        os.kill(os.getpid(), signal.SIGTERM)
        assert ckpt.preempt_requested
    finally:
        signal.signal(signal.SIGTERM, old)


def test_default_checkpoint_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("POLYAXON_TPU_HOME", str(tmp_path))
    monkeypatch.delenv("POLYAXON_TPU_RUN_UUID", raising=False)
    monkeypatch.chdir(tmp_path)
    assert tckpt.default_checkpoint_dir() == str(tmp_path / "checkpoints")
    assert tckpt.default_checkpoint_dir("u1") == str(
        tmp_path / "runs" / "u1" / "artifacts" / "outputs" / "checkpoints")


def test_train_main_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("POLYAXON_TPU_RUN_UUID", raising=False)
    assert ttrain.main(["--cpu", "--model", "gpt2-tiny", "--steps", "3",
                        "--log-every", "1", "--target-metric",
                        "loss<=0"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step ")]
    assert [ln.split()[1] for ln in lines] == ["1/3", "2/3", "3/3"]
    for ln in lines:
        loss = float(re.search(r"loss=(\S+)", ln).group(1))
        assert math.isfinite(loss) and loss > 0
        assert "tok_per_sec_per_chip=" in ln and "grad_norm=" in ln
    assert (tmp_path / "checkpoints" / "3" / "state.pt").exists()


@pytest.mark.parametrize("flags,slice_name", [
    (["--strategy", "dp:2"], "do not divide device count 1"),
    (["--strategy", "pp:2,fsdp:2"], "do not divide device count 1"),
    (["--model", "mlp", "--init-hf", "weights.pt"],
     "--init-hf supports the"),
    (["--model", "t5-tiny", "--dataset", "span-corruption"],
     "span-corruption requires --data-dir"),
    (["--dataset", "span-corruption", "--data-dir", "."],
     "requires a seq2seq"),
    (["--model", "moe-gpt-tiny", "--strategy", "pp:2,fsdp:2,ep:2"],
     "strategy combines pp>1 with ep>1, which is not supported"),
], ids=["flags0-parallelism slice", "flags1-parallelism slice",
        "flags2-import_hf", "flags3-zoo slice", "flags4-zoo",
        "flags5-zoo slice"])
def test_train_refuses_what_is_not_ported(flags, slice_name, tmp_path,
                                          monkeypatch):
    """``--init-hf`` (BERT, GPT-2, the Llama family, ViT, T5), the
    digits dataset, ``--eval-every``, T5 with span corruption and
    MoE-GPT are ported (``test_torch_import_hf.py``,
    ``test_torch_eval.py``, ``test_torch_t5.py``, ``test_torch_moe.py``),
    and so are the dp, fsdp, tp and ep axes over a gang
    (``test_torch_mesh.py``, ``test_torch_gang.py``,
    ``test_torch_tp.py``, ``test_torch_ep.py``, sp,
    ``test_torch_sp.py``, and their compositions,
    ``test_torch_compose.py``, pp, ``test_torch_pipeline.py``); what
    stays refused: a pipeline axis beside ep (MoE-GPT's
    ``pp:2,fsdp:2,ep:2``) by the reference's message, ``--init-hf`` of a
    family with no loader, and span corruption
    without a data directory or on a decoder-only model, with the
    reference's messages.  ``dp:2`` and ``pp:2,fsdp:2`` in one process
    with no gang raise the reference's own ``MeshError``.  The ids are
    the cases' earlier ones."""
    from polyaxon_tpu_torch.parallel.mesh import MeshError

    monkeypatch.chdir(tmp_path)
    with pytest.raises((SystemExit, MeshError), match=slice_name):
        ttrain.main(["--cpu", "--model", "gpt2-tiny", "--steps", "1",
                     *flags])


def test_target_metric_and_strategy_parsing_match_reference():
    from polyaxon_tpu import train as jtrain

    for spec in ("loss=0.5", "accuracy=0.9", "ppl<=3", "acc>=0.1", "x"):
        assert ttrain.parse_target_metric(spec) == \
            jtrain.parse_target_metric(spec)
    for raw in ('{"dp": 1}', "dp:1,tp:1", "dp=-1", ""):
        assert ttrain.parse_strategy(raw) == jtrain.parse_strategy(raw)


def test_flop_models_match_reference():
    for name in ("gpt2-medium", "gpt2-small"):
        j, t = j_get_model(name), t_get_model(name)
        assert t.train_flops(8) == j.train_flops(8)
        assert t.attn_flops(8, t.make_model(device="meta").cfg) == \
            j.attn_flops(8, j.make_model().cfg)
        assert t.default_batch_size == j.default_batch_size
        np.testing.assert_array_equal(t.make_batch(2)["inputs"],
                                      j.make_batch(2)["inputs"])


def test_registry_overrides_patch_config_fields():
    model = t_get_model("gpt2-tiny").make_model(device="meta",
                                                **FLASH_MODEL)
    assert dataclasses.asdict(model.cfg)["hidden_size"] == 128
    assert kv_cache_dims(model.cfg)[1] == 64


def test_train_main_profile_and_checkpoint_every(tmp_path, monkeypatch,
                                                 capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("POLYAXON_TPU_RUN_UUID", raising=False)
    assert ttrain.main(["--cpu", "--model", "gpt2-tiny", "--steps", "3",
                        "--profile-at", "1", "--profile-steps", "1",
                        "--checkpoint-every", "2", "--batch-size",
                        "2"]) == 0
    assert "profile trace written" in capsys.readouterr().out
    assert (tmp_path / "profile" / "trace_step2.json").exists()
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) \
        == ["2", "3"]


def test_train_main_preemption_saves_and_exits(tmp_path, monkeypatch,
                                               capsys):
    """A SIGTERM during the first step: the loop saves step 1 and
    stops."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("POLYAXON_TPU_RUN_UUID", raising=False)

    def preempted(self):
        self.preempt_requested = True

    monkeypatch.setattr(tckpt.CheckpointManager, "install_preemption_hook",
                        preempted)
    assert ttrain.main(["--cpu", "--model", "gpt2-tiny", "--steps", "5",
                        "--batch-size", "2"]) == 0
    assert "preempted: checkpoint flushed" in capsys.readouterr().out
    assert [p.name for p in (tmp_path / "checkpoints").iterdir()] == ["1"]
