"""One optimizer step of the port's training zoo against the reference's
``TrainStep``, on the CPU, in float32 (the flax params redrawn and
carried across as in ``test_torch_zoo.py``):

- One AdamW step through the reference's ``TrainStep`` on a one-device
  mesh against the port's: loss and aux (rtol 1e-5), every gradient
  (rtol 1e-4, atol 1e-4 of the tensor's largest |grad|), the updated
  params (2e-6; Adam's step bound 2 lr where a gradient is within 1e-4
  of the tensor's largest |grad| of zero, where the sign of Adam's first
  step is rounding; at least three quarters get the tight check, BERT's
  tied embedding rows being the loosest) and the batch-norm running
  averages (1e-5), with ``grad_accum`` 2 too (the reference averages the
  micro-batches' new averages; each micro-batch draws its MLM mask from
  ``fold_in(rng, i)``).
- A resumed ResNet run continues the same running averages; a step
  advances them once.
"""

from __future__ import annotations

import jax
import numpy as np
import optax
import pytest
import torch

from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu.parallel import MeshSpec, build_mesh
from polyaxon_tpu.parallel import make_train_step as j_make_train_step
from polyaxon_tpu_torch import checkpoint as tckpt
from polyaxon_tpu_torch import prng
from polyaxon_tpu_torch import train as ttrain
from polyaxon_tpu_torch.models.layers import batch_stats
from polyaxon_tpu_torch.models.registry import get_model as t_get_model
from polyaxon_tpu_torch.parallel import make_train_step
from test_torch_zoo import _close, _np, _pair, _port_sd

torch.set_num_threads(2)


def _j_step(name, jmodel, variables, batch, rng, accum):
    mesh = build_mesh(MeshSpec.from_dict({"dp": 1}),
                      devices=jax.devices()[:1])
    step = j_make_train_step(j_get_model(name).loss_fn(jmodel),
                             optax.adamw(1e-3, weight_decay=0.01), mesh,
                             grad_accum=accum, donate=False)
    state = step.init_state(variables)
    new_state, metrics = step(state, batch, rng)
    return _np(new_state["params"]), {k: float(v)
                                      for k, v in metrics.items()}


STEP = [("mlp", 1), ("convnet", 1), ("resnet50-tiny", 1),
        ("resnet50-tiny", 2), ("bert-tiny", 1), ("bert-tiny", 2)]


@pytest.mark.parametrize("name,accum", STEP,
                         ids=[f"{n}-accum{a}" for n, a in STEP])
def test_one_adamw_step_equals_reference_train_step(name, accum):
    jmodel, variables, tmodel, batch = _pair(name, batch_size=8)
    jrng = jax.random.PRNGKey(5)
    with jax.default_matmul_precision("highest"):
        if accum == 1:
            (jloss, _), jgrads = jax.jit(jax.value_and_grad(
                j_get_model(name).loss_fn(jmodel), has_aux=True))(
                    variables, batch, jrng)
        jparams, jmetrics = _j_step(name, jmodel, variables, batch, jrng,
                                    accum)
    step_fn = make_train_step(t_get_model(name).loss_fn(tmodel),
                              ttrain.make_optimizer("adamw", 1e-3),
                              grad_accum=accum)
    state = step_fn.init_state(tmodel)
    state, metrics = step_fn(state, batch, prng.PRNGKey(5))
    metrics = {k: float(v) for k, v in metrics.items()}
    assert sorted(metrics) == sorted(jmetrics)      # no BN state in them
    for key, want in jmetrics.items():
        np.testing.assert_allclose(metrics[key], want, rtol=1e-5,
                                   err_msg=key)
    # Adam's first step is about lr * sign(grad): where a gradient is
    # within the gradient tolerance of zero, its sign is rounding.
    # An exact zero (a dead ReLU) is no rounding: both sides leave the
    # element to weight decay alone.
    small = {n: (p.grad.abs() <= 1e-4 * p.grad.abs().max())
             & (p.grad != 0)
             for n, p in tmodel.named_parameters() if p.grad is not None}
    if accum == 1:
        want_g = _port_sd(name, {"params": jgrads["params"]}, tmodel.cfg)
        for n, p in tmodel.named_parameters():
            if p.grad is None:      # bert's type_embed: no flax leaf
                assert n not in want_g or not np.abs(
                    want_g[n].numpy()).any()
                continue
            np.testing.assert_allclose(p.grad.numpy(), want_g[n].numpy(),
                                       rtol=1e-4, atol=1e-4 * float(
                                           np.abs(want_g[n].numpy()).max()
                                           or 1e-12), err_msg=n)
    want_p = _port_sd(name, jparams, tmodel.cfg)
    tight = total = 0
    for n, t in tmodel.state_dict().items():
        if n not in want_p:
            continue
        got, w = t.numpy(), want_p[n].numpy()
        if "running" in n:
            _close(got, w, 1e-5, n)
            continue
        atol = np.full(got.shape, 2e-6, np.float32)
        if n in small:
            atol[small[n].numpy()] = 2e-3
        tight += int((atol == 2e-6).sum())
        total += atol.size
        assert (np.abs(got - w) <= atol).all(), \
            f"{n}: max |d| {np.abs(got - w).max()}"
    assert tight >= 0.75 * total


def test_resumed_resnet_run_continues_the_running_averages(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("POLYAXON_TPU_RUN_UUID", "r")
    args = ["--cpu", "--model", "resnet50-tiny", "--log-every", "1",
            "--batch-size", "4"]

    def final(home):
        ckpt = tckpt.CheckpointManager(str(
            home / "runs" / "r" / "artifacts" / "outputs" / "checkpoints"))
        return ckpt.restore()["params"]

    monkeypatch.setenv("POLYAXON_TPU_HOME", str(tmp_path / "a"))
    assert ttrain.main(args + ["--steps", "4"]) == 0
    monkeypatch.setenv("POLYAXON_TPU_HOME", str(tmp_path / "b"))
    assert ttrain.main(args + ["--steps", "2"]) == 0
    mid = final(tmp_path / "b")
    assert ttrain.main(args + ["--steps", "4"]) == 0
    a, b = final(tmp_path / "a"), final(tmp_path / "b")
    running = [k for k in a if "running" in k]
    assert len(running) == 2 * 17
    assert any(not torch.equal(mid[k], b[k]) for k in running)
    for key, t in a.items():
        torch.testing.assert_close(b[key], t, rtol=0, atol=0)


def test_bn_running_averages_advance_once_a_step():
    """One step moves every running average once (and a step of the
    MLP, which has none, leaves no state behind)."""
    spec = t_get_model("resnet50-tiny")
    model = spec.init_params(seed=0, device="cpu", train=True,
                             dtype=torch.float32)
    before = [b.clone() for b in batch_stats(model)]
    step_fn = make_train_step(spec.loss_fn(model),
                              ttrain.make_optimizer("sgd", 0.0))
    batch = spec.make_batch(4)
    step_fn(step_fn.init_state(model), batch)
    after = [b.clone() for b in batch_stats(model)]
    with torch.no_grad():
        x = torch.as_tensor(batch["inputs"]).permute(0, 3, 1, 2)
        y = model.stem_conv(x).float()
    m = model.stem_bn.momentum
    torch.testing.assert_close(after[0], m * before[0]
                               + (1 - m) * y.mean((0, 2, 3)))
    torch.testing.assert_close(after[1], m * before[1]
                               + (1 - m) * y.var((0, 2, 3),
                                                 unbiased=False))
    assert all(not torch.equal(a, b) for a, b in zip(before, after))
