"""ViT (``models/vit.py``) against the flax reference, float32 on both
sides, the reference's weights carried across by
``convert.vit_state_dict_from_jax`` (redrawn from a numpy seed, so the
zero-initialized CLS token and the zero biases carry real values).

- logits, tanh and exact GELU, equal the reference's (atol 1e-5 of the
  largest logit);
- the classifier loss's float32 gradients equal the reference's (rtol
  1e-5 with atol 1e-5 of the tensor's largest |grad|), with and without
  remat;
- ``flash_eligible`` refuses ViT-B/16's 197 tokens and vit-tiny's 17 in
  both packages, so ViT's attention takes the plain path and launches
  no kernel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu.ops import flash as jflash
from polyaxon_tpu_torch.convert import vit_state_dict_from_jax
from polyaxon_tpu_torch.models.registry import get_model as t_get_model
from polyaxon_tpu_torch.ops import attention as tat
from polyaxon_tpu_torch.ops import flash as tflash

torch.set_num_threads(2)


def _redraw(tree, seed=11):
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.asarray(x)
        r = 0.3 * rng.standard_normal(x.shape)
        if "scale" in jax.tree_util.keystr(path):
            r = 1.0 + r
        return r.astype(x.dtype)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _pair(**over):
    jmodel = j_get_model("vit-tiny").make_model(dtype=jnp.float32, **over)
    batch = j_get_model("vit-tiny").make_batch(4)
    variables = _redraw(jmodel.init(jax.random.PRNGKey(0),
                                    batch["inputs"]))
    tmodel = t_get_model("vit-tiny").make_model(
        device="cpu", dtype=torch.float32, param_dtype=torch.float32,
        **over)
    tmodel.load_state_dict(vit_state_dict_from_jax(
        jax.tree.map(np.asarray, variables["params"]), tmodel.cfg),
        strict=True)
    return jmodel, variables, tmodel, batch


def _close(got, want, rel, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0, err_msg=what,
        atol=rel * max(float(np.abs(want).max()), 1e-12))


@pytest.mark.parametrize("approx", [True, False])
def test_logits_equal_reference(approx):
    jmodel, variables, tmodel, batch = _pair(gelu_approximate=approx)
    want = jax.jit(jmodel.apply)(variables, batch["inputs"])
    with torch.no_grad():
        got = tmodel(torch.as_tensor(batch["inputs"])).numpy()
    assert got.shape == (4, 10)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_equal_reference(remat):
    jmodel, variables, tmodel, batch = _pair(remat=remat)
    jloss = j_get_model("vit-tiny").loss_fn(jmodel)
    (jl, jaux), jgrads = jax.value_and_grad(
        lambda p: jloss({"params": p}, batch, None), has_aux=True)(
            variables["params"])
    tmodel.train()
    tl, taux = t_get_model("vit-tiny").loss_fn(tmodel)(batch)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    assert taux["accuracy"].item() == float(jaux["accuracy"])
    want = vit_state_dict_from_jax(jax.tree.map(np.asarray, jgrads),
                                   tmodel.cfg)
    for name, p in tmodel.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), w, rtol=1e-5, err_msg=name,
            atol=1e-5 * max(float(np.abs(w).max()), 1e-12))


def test_flash_eligible_refuses_vit_sequences(monkeypatch):
    """197 (ViT-B/16) and 17 (vit-tiny) tokens: refused by both
    packages' predicate; the port's forward launches no flash call."""
    # The reference's predicate as it routes on a TPU (interpret mode
    # stands for the backend), where 256 tokens would take the kernel.
    monkeypatch.setenv("POLYAXON_TPU_FLASH_INTERPRET", "1")
    assert tflash.flash_eligible(256, 256, 64)
    assert jflash.flash_eligible(256, 256, 64)
    for s in (197, 17):
        assert not tflash.flash_eligible(s, s, 64)
        assert not jflash.flash_eligible(s, s, 64)
    for name in ("vit-base", "vit-tiny"):
        cfg = t_get_model(name).make_model(device="meta").cfg
        assert cfg.num_patches + 1 in (197, 17)
    calls = []
    monkeypatch.setattr(tat, "flash_attention",
                        lambda *a, **kw: calls.append(1))
    _, _, tmodel, batch = _pair()
    with torch.no_grad():
        tmodel(torch.as_tensor(batch["inputs"]))
    assert calls == []
