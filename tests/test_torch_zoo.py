"""The port's training zoo against the JAX package, on the CPU: the MLP,
the ConvNet, ResNet (``resnet50-tiny``, both stems) and BERT
(``bert-tiny``), in float32, on the reference's flax params carried
across by ``convert.*_state_dict_from_jax``.

- Forward logits, train and eval mode, equal within 1e-5 of the logits'
  largest magnitude (5e-5 for ResNet's train mode, whose batch
  statistics are sums over the batch in another order).  The flax params
  are redrawn from a numpy seed first, so no batch-norm scale is zero
  (flax starts ``bn3`` at zero) and every shape trap shows: flax's
  asymmetric SAME padding at stride 2, the max pool's -inf padding, the
  biased running variance.  BERT with and without a padded
  ``attention_mask``.
- BERT's MLM mask bits equal ``jax.random.bernoulli``'s.
- The registry's flop models, batches, init and refusals by ROADMAP item.

One optimizer step of each model against the reference's ``TrainStep``
is in ``test_torch_zoo_train.py``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu_torch import convert, prng
from polyaxon_tpu_torch import train as ttrain
from polyaxon_tpu_torch.models.registry import get_model as t_get_model

torch.set_num_threads(2)

CONVERT = {"mlp": convert.mlp_state_dict_from_jax,
           "convnet": convert.convnet_state_dict_from_jax,
           "resnet50-tiny": convert.resnet_state_dict_from_jax,
           "bert-tiny": convert.bert_state_dict_from_jax}


def _redraw(tree, seed):
    """Every leaf redrawn: normal * 0.3, scales around 1 and variances
    in [0.5, inf), so batch norms neither zero a branch nor divide by
    ~0."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.asarray(x)
        name = jax.tree_util.keystr(path)
        r = 0.3 * rng.standard_normal(x.shape)
        if "'var'" in name:
            r = 0.5 + np.abs(r)
        elif "scale" in name:
            r = 1.0 + r
        return r.astype(x.dtype)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_sd(name, variables, cfg):
    params = _np(variables["params"])
    if "batch_stats" in variables:
        return CONVERT[name](params, cfg, _np(variables["batch_stats"]))
    return CONVERT[name](params, cfg)


@functools.lru_cache(maxsize=None)
def _flax(name, batch_size, over):
    jmodel = j_get_model(name).make_model(dtype=jnp.float32, **dict(over))
    batch = j_get_model(name).make_batch(batch_size)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                     batch["inputs"])
    return jmodel, _redraw(dict(variables), 11), batch


def _pair(name, batch_size=4, **over):
    """(flax model, redrawn flax variables, port model with the same
    weights, the registry's numpy batch), float32."""
    tspec = t_get_model(name)
    jmodel, variables, batch = _flax(name, batch_size,
                                     tuple(sorted(over.items())))
    tmodel = tspec.init_params(seed=1, device="cpu", train=True,
                               dtype=torch.float32, **over)
    tmodel.load_state_dict(_port_sd(name, variables, tmodel.cfg),
                           strict=True)
    return jmodel, variables, tmodel, batch


def _close(got, want, rel, what):
    want = np.asarray(want)
    assert np.isfinite(want).all(), what
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0, equal_nan=False,
        atol=rel * max(float(np.abs(want).max()), 1e-12), err_msg=what)


FORWARD = [("mlp", {}), ("convnet", {}), ("resnet50-tiny", {}),
           ("resnet50-tiny", {"stem": "space_to_depth"}),
           ("bert-tiny", {})]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name,over", FORWARD,
                         ids=[f"{n}-{o.get('stem', 'default')}"
                              for n, o in FORWARD])
def test_forward_logits_equal_reference(name, over, train):
    jmodel, variables, tmodel, batch = _pair(name, **over)
    x = batch["inputs"]
    if "batch_stats" in variables:
        out = jax.jit(lambda v, x: jmodel.apply(
            v, x, train=train,
            mutable=["batch_stats"] if train else False))(variables, x)
        want, new = out if train else (out, None)
    else:
        want = jax.jit(lambda v, x: jmodel.apply(v, x, train=train))(
            variables, x)
        new = None
    got = tmodel(torch.as_tensor(x), train=train).detach().numpy()
    _close(got, want, 5e-5 if new is not None else 1e-5, name)
    if new is not None:
        # Train mode advanced the running averages as flax's merge does.
        sd = _port_sd(name, {"params": variables["params"],
                             "batch_stats": new["batch_stats"]}, tmodel.cfg)
        for key, t in tmodel.state_dict().items():
            if "running" in key:
                _close(t.numpy(), sd[key].numpy(), 1e-5, key)


@pytest.mark.parametrize("masked", [False, True])
def test_bert_logits_with_attention_mask(masked):
    jmodel, variables, tmodel, batch = _pair("bert-tiny")
    x = batch["inputs"]
    mask = None
    if masked:
        mask = np.ones(x.shape, np.int32)
        mask[1, 40:] = 0
        mask[3, 7:] = 0
    want = jax.jit(lambda v, x, m: jmodel.apply(v, x, attention_mask=m))(
        variables, x, mask)
    got = tmodel(torch.as_tensor(x), attention_mask=None if mask is None
                 else torch.as_tensor(mask)).detach().numpy()
    _close(got, want, 1e-5, f"masked={masked}")


def test_padding_is_flax_same_not_symmetric():
    """The traps are live: torch's symmetric padding at the stride-2
    convolutions and the max pool moves ResNet's logits."""
    from polyaxon_tpu_torch.models import layers

    jmodel, variables, tmodel, batch = _pair("resnet50-tiny")
    want = np.asarray(jax.jit(jmodel.apply)(variables, batch["inputs"]))
    assert layers._same_pads(224, 7, 2) == (2, 3)
    assert layers._same_pads(112, 3, 2) == (0, 1)
    assert layers._same_pads(32, 3, 1) == (1, 1)
    symmetric = lambda n, k, s: ((k - 1) // 2, (k - 1) // 2)  # noqa: E731
    real = layers._same_pads
    try:
        layers._same_pads = symmetric
        import polyaxon_tpu_torch.models.resnet as tres
        tres._same_pads = symmetric
        got = tmodel(torch.as_tensor(batch["inputs"])).detach().numpy()
    finally:
        layers._same_pads = real
        tres._same_pads = real
    assert np.abs(got - want).max() > 1e-2


def test_mlm_mask_bits_equal_jax_bernoulli():
    for seed in (0, 5, 123456789):
        for shape in ((8, 64), (32, 512), (3, 7)):
            want = np.asarray(jax.random.bernoulli(
                jax.random.PRNGKey(seed), 0.15, shape))
            got = prng.bernoulli(prng.PRNGKey(seed), 0.15, shape).numpy()
            np.testing.assert_array_equal(got, want)
    key = jax.random.fold_in(jax.random.PRNGKey(2), 1)
    np.testing.assert_array_equal(
        prng.bernoulli(prng.fold_in(prng.PRNGKey(2), 1), 0.15,
                       (4, 64)).numpy(),
        np.asarray(jax.random.bernoulli(key, 0.15, (4, 64))))


@pytest.mark.parametrize("name", ["mlp", "convnet", "resnet50",
                                  "resnet50-tiny", "bert-base",
                                  "bert-tiny"])
def test_registry_entries_match_reference(name):
    j, t = j_get_model(name), t_get_model(name)
    assert t.default_batch_size == j.default_batch_size
    a, b = t.make_batch(3), j.make_batch(3)
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    assert (t.train_flops is None) == (j.train_flops is None)
    if j.train_flops is not None:
        assert t.train_flops(8) == j.train_flops(8)
    if j.attn_flops is not None:
        assert t.attn_flops(8, t.make_model(device="meta").cfg) == \
            j.attn_flops(8, j.make_model().cfg)


def test_init_follows_flax_defaults():
    """lecun-normal kernels by fan-in, zero biases, unit scales and
    ``bn3`` at zero (its residual branch starts as the identity)."""
    model = t_get_model("resnet50-tiny").init_params(seed=0, device="cpu")
    block = model.stage1_block1
    assert not block.bn3.weight.any() and bool((block.bn1.weight == 1).all())
    fan_in = block.conv2.weight[0].numel()
    assert abs(block.conv2.weight.std().item() * fan_in ** 0.5 - 1) < 0.15
    assert not model.head.bias.any()


@pytest.mark.parametrize("argv,item", [
    (["--model", "t5-tiny"], "The rest of the zoo"),
    (["--model", "vit-tiny"], "The rest of the zoo"),
    (["--model", "moe-gpt-small"], "The rest of the zoo"),
    (["--model", "bert-tiny", "--dataset", "span-corruption"],
     "The rest of the zoo"),
    (["--model", "vit-tiny", "--init-hf", "w.pt"], "The rest of the zoo"),
    (["--model", "t5-small", "--init-hf", "w.pt"], "The rest of the zoo"),
    (["--model", "resnet50-tiny", "--strategy", "dp:2"],
     "Parallelism and meshes"),
])
def test_unported_refused_by_roadmap_item(argv, item, tmp_path,
                                          monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match=item):
        ttrain.main(["--cpu", "--steps", "1", *argv])
    if len(argv) == 2 and item == "The rest of the zoo":
        with pytest.raises(KeyError, match=item):
            t_get_model(argv[1])


ZOO_EXAMPLES = {"mnist.yaml": "polyaxon_tpu_torch.models.train_mnist",
                "convnet_hyperband.yaml": "polyaxon_tpu_torch.train",
                "resnet50_job.yaml": "polyaxon_tpu_torch.train",
                "bert_job.yaml": "polyaxon_tpu_torch.train",
                "bert_finetune.yaml": "polyaxon_tpu_torch.train"}


@pytest.mark.parametrize("example", sorted(ZOO_EXAMPLES))
def test_zoo_examples_are_single_card_jobs(example):
    """Each zoo example compiles as a ``job`` running the port's entry
    point (the reference's tfjob / pytorchjob gangs need meshes)."""
    from pathlib import Path

    from polyaxon_tpu_torch.polyaxonfile import check_polyaxonfile

    path = Path(ttrain.__file__).parent / "examples" / example
    params = {"weights": "w.pt"} if "finetune" in example else None
    run = check_polyaxonfile([str(path)], params=params).component.run
    assert run.kind == "job"
    assert run.container.command == ["python", "-m", ZOO_EXAMPLES[example]]


@pytest.mark.parametrize("example", ["resnet50_job.yaml", "bert_job.yaml"])
def test_gang_kinds_refused_by_roadmap_item(example, monkeypatch,
                                            tmp_path):
    """The reference's tfjob / pytorchjob gangs of these examples run one
    process per replica with a PTPU_* topology of several processes:
    each one refuses by the parallelism item."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PTPU_NUM_PROCESSES", "4")
    model = "resnet50-tiny" if "resnet" in example else "bert-tiny"
    with pytest.raises(SystemExit, match="Parallelism and meshes"):
        ttrain.main(["--cpu", "--model", model, "--steps", "1"])
