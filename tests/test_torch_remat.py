"""Named remat policies (``models/layers.py``), on the CPU in float32:

- Under each of ``nothing_saveable``, ``everything_saveable``,
  ``dots_saveable`` and ``dots_with_no_batch_dims_saveable`` (and
  ``None``, whole-block remat), ``gpt2-tiny`` and ``llama-tiny`` give the
  loss and every gradient of the model without remat (rtol 1e-6, atol
  1e-6 of the tensor's largest |grad|: recomputation repeats the same
  float32 ops), and the JAX package's ``jax.checkpoint_policies`` member
  of that name gives the reference's gradients on the same params
  (``test_torch_train.py``'s bound).
- What each policy saves: the matmuls the backward recomputes, counted
  at the dispatcher (dense ``mm`` / ``addmm``, attention's batched
  ``bmm``), are those its jax policy does not save.
- Any other name is refused, naming itself.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu_torch.convert import (gpt2_state_dict_from_jax,
                                        llama_state_dict_from_jax)
from polyaxon_tpu_torch.models.layers import REMAT_POLICIES
from polyaxon_tpu_torch.models.registry import get_model as t_get_model

torch.set_num_threads(2)

MODELS = {"gpt2-tiny": gpt2_state_dict_from_jax,
          "llama-tiny": llama_state_dict_from_jax}
POLICIES = (None,) + REMAT_POLICIES


def _model(name, policy, remat=True):
    return t_get_model(name).init_params(
        seed=2, device="cpu", train=True, dtype=torch.float32,
        remat=remat, remat_policy=policy)


def _grads(model, batch):
    model.zero_grad(set_to_none=True)
    loss, _ = t_get_model(model_name(model)).loss_fn(model)(batch)
    loss.backward()
    return loss.item(), {n: p.grad.clone()
                         for n, p in model.named_parameters()}


def model_name(model):
    return "gpt2-tiny" if hasattr(model, "wte") else "llama-tiny"


def _batch(name):
    return {"inputs": t_get_model(name).make_batch(2)["inputs"][:, :32]}


@pytest.mark.parametrize("policy", POLICIES, ids=str)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_policy_grads_equal_no_remat(name, policy):
    batch = _batch(name)
    base_loss, base = _grads(_model(name, None, remat=False), batch)
    loss, got = _grads(_model(name, policy), batch)
    assert loss == pytest.approx(base_loss, rel=1e-6)
    for n, g in base.items():
        torch.testing.assert_close(
            got[n], g, rtol=1e-6, atol=1e-6 * g.abs().max().item(),
            msg=n)


@pytest.mark.parametrize("policy", ["dots_saveable",
                                    "dots_with_no_batch_dims_saveable"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_policy_grads_equal_reference(name, policy):
    jmodel = j_get_model(name).make_model(dtype=jnp.float32, remat=True,
                                          remat_policy=policy)
    tokens = _batch(name)["inputs"]
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), tokens)
    with jax.default_matmul_precision("highest"):
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            j_get_model(name).loss_fn(jmodel), has_aux=True))(
                variables, {"inputs": tokens}, None)
    model = _model(name, policy)
    params = jax.tree.map(np.asarray, variables["params"])
    model.load_state_dict(MODELS[name](params, model.cfg))
    loss, got = _grads(model, {"inputs": tokens})
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-4)
    want = MODELS[name](jax.tree.map(np.asarray, jgrads["params"]),
                        model.cfg)
    for n, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(
            got[n].numpy(), w, rtol=1e-4,
            atol=1e-4 * max(float(np.abs(w).max()), 1e-12), err_msg=n)


class _CountDots(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {"dense": 0, "batched": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        aten = torch.ops.aten
        if func in (aten.mm.default, aten.addmm.default):
            self.counts["dense"] += 1
        elif func in (aten.bmm.default, aten.baddbmm.default):
            self.counts["batched"] += 1
        return func(*args, **(kwargs or {}))


def _backward_dots(name, policy, remat=True):
    model = _model(name, policy, remat=remat)
    loss, _ = t_get_model(name).loss_fn(model)(_batch(name))
    with _CountDots() as mode:
        loss.backward()
    return mode.counts


@pytest.mark.parametrize("name", sorted(MODELS))
def test_policies_save_what_jax_saves(name):
    """Recomputed matmuls = the backward's matmuls minus no-remat's."""
    base = _backward_dots(name, None, remat=False)
    extra = {}
    for policy in POLICIES:
        counts = _backward_dots(name, policy)
        extra[policy] = {k: counts[k] - base[k] for k in counts}
    layers = t_get_model(name).make_model(device="meta").cfg.num_layers
    full = extra[None]
    assert full["dense"] > 0 and full["batched"] == 2 * layers
    assert extra["nothing_saveable"] == full
    assert extra["everything_saveable"] == {"dense": 0, "batched": 0}
    assert extra["dots_saveable"] == {"dense": 0, "batched": 0}
    assert extra["dots_with_no_batch_dims_saveable"] == {
        "dense": 0, "batched": 2 * layers}


@pytest.mark.parametrize("bad", ["save_anything_except_these_names",
                                 "dots_savable", "offload_dot_with_no_"
                                 "batch_dims"])
def test_unknown_policy_refused_naming_itself(bad):
    with pytest.raises(ValueError, match=bad):
        _model("gpt2-tiny", bad)
    with pytest.raises(ValueError, match="remat policies"):
        t_get_model("llama-tiny").make_model(device="meta", remat=True,
                                             remat_policy=bad)
