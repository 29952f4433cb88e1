"""Weight-only int8 quantization of the port (``ops/quant.py``) against
the JAX reference's ``polyaxon_tpu/ops/quant.py``.

- ``symmetric_int8``: codes and scales bitwise equal on random inputs
  with zero channels and exact half-way ties.
- ``quantize_params`` on the reference's weights (converted, float32):
  the same leaves quantize, and every ``q`` and scale is bitwise the
  reference's, at ``min_size`` 4096 and 64 (64 makes the tiny configs
  quantize their stacked biases and norm scales, what gpt2-medium and
  TinyLlama do at full width); the dequantized weights are bitwise the
  reference's ``dequantize_params``; ``quantized_bytes`` agrees.
- The full-width leaf list (gpt2-medium, tinyllama-1.1b) from shapes
  alone: the port's model on ``meta`` against ``jax.eval_shape`` of the
  reference's ``quantize_params``.
- Quantized weights live as int8 buffers with no resident copy, and
  ``dequantize_params`` / re-quantizing behave.
- ``convert.py`` carries the reference's quantized tree itself across
  (``QuantizedTensor`` leaves duck-typed, or ``{"q", "scale"}``
  mappings): the same buffers as quantizing the port's model.
"""

from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu.ops import quant as JQ
from polyaxon_tpu_torch import convert
from polyaxon_tpu_torch.convert import (gpt2_state_dict_from_jax,
                                        llama_state_dict_from_jax)
from polyaxon_tpu_torch.models.registry import get_model
from polyaxon_tpu_torch.ops import quant as Q

torch.set_num_threads(2)

FAMILIES = ("gpt2-tiny", "llama-tiny", "mistral-tiny")


def _is_qt(x):
    return isinstance(x, JQ.QuantizedTensor)


def _ref_quantized(tree):
    """keystr -> QuantizedTensor of the reference's quantized tree."""
    return {jax.tree_util.keystr(p): leaf for p, leaf in
            jax.tree_util.tree_leaves_with_path(tree, is_leaf=_is_qt)
            if _is_qt(leaf)}


@pytest.fixture(scope="module", params=FAMILIES)
def pair(request):
    """(name, flax params, port model) float32 on the same weights."""
    name = request.param
    jmodel = j_get_model(name).make_model(dtype=jnp.float32)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    tmodel = get_model(name).make_model(device="cpu", dtype=torch.float32)
    conv = gpt2_state_dict_from_jax if name.startswith("gpt2") \
        else llama_state_dict_from_jax
    tmodel.load_state_dict(conv(jax.tree.map(np.asarray, params),
                                tmodel.cfg), strict=True)
    return name, params, tmodel.eval().requires_grad_(False)


def _flax_layout(leaf, tensors):
    """The port's per-layer tensors of ``leaf`` stacked back into the
    reference's layout."""
    out = [t.t() if tr and t.ndim == 2 else t
           for t, (_, _, tr) in zip(tensors, leaf.members)]
    return torch.stack(out) if leaf.stacked else out[0]


def test_symmetric_int8_bitwise_equal_reference():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 40, 17) * rng.uniform(0.01, 5, (3, 1, 17))) \
        .astype(np.float32)
    x[:, :, 3] = 0.0                         # an all-zero channel
    x[0, 0, 5], x[0, 1, 5] = 127.0, 0.5      # an exact half-way tie
    x[1, 2, 6], x[1, 3, 6] = -127.0, 2.5
    for axes in ((1,), (0, 1), (-1,)):
        jq, js = JQ.symmetric_int8(jnp.asarray(x), axes)
        tq, ts = Q.symmetric_int8(torch.from_numpy(x), axes)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(
            ts.float().numpy(), np.asarray(js).astype(np.float32))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16


@pytest.mark.parametrize("min_size", [4096, 64])
def test_quantize_params_bitwise_equal_reference(pair, min_size):
    name, params, tmodel = pair
    ref = _ref_quantized(JQ.quantize_params(params, min_size=min_size))
    model = Q.quantize_params(copy.deepcopy(tmodel), min_size=min_size)
    plan = {g.path: g for g in Q.quant_plan(model, min_size=min_size)}
    assert sorted(p for p, g in plan.items() if g.scale_shape) \
        == sorted(ref), name
    deq = jax.tree.map(np.asarray, JQ.dequantize_params(
        JQ.quantize_params(params, min_size=min_size)))
    for path, qt in ref.items():
        leaf = plan[path]
        q = _flax_layout(leaf, [Q._raw(m, a) for m, a, _ in leaf.members])
        np.testing.assert_array_equal(q.numpy(), np.asarray(qt.q),
                                      err_msg=path)
        scales = [Q._dequantizer(m, a).scale for m, a, _ in leaf.members]
        scale = _flax_layout(leaf, scales)
        if leaf.stacked and qt.scale.shape[0] == 1:
            # One scale shared by every layer: the same tensor.
            assert all(s is scales[0] for s in scales)
            scale = scale[:1] if scale.ndim == len(qt.scale.shape) \
                else scales[0][None]
        assert tuple(scale.shape) == tuple(qt.scale.shape), path
        np.testing.assert_array_equal(
            scale.float().numpy(), np.asarray(qt.scale).astype(np.float32),
            err_msg=path)
        # The weight the model reads: the reference's dequantize.
        w = _flax_layout(leaf, [getattr(m, a) for m, a, _ in leaf.members])
        want = deq
        for key in path[2:-2].split("']['"):
            want = want[key]
        np.testing.assert_array_equal(
            w.float().numpy(), np.asarray(want).astype(np.float32),
            err_msg=path)
    assert Q.quantized_bytes(model) == JQ.quantized_bytes(
        JQ.quantize_params(params, min_size=min_size))


@pytest.mark.parametrize("name", ["gpt2-medium", "tinyllama-1.1b"])
def test_full_width_leaf_list_matches_reference(name):
    """Shapes only.  At full width the stacked biases and norm scales
    cross 4096 elements and quantize with one scale per channel shared
    by every layer (gpt2-medium's ln1/scale [24, 1024] -> [1, 1024],
    TinyLlama's input_norm/scale [22, 2048] -> [1, 2048])."""
    jmodel = j_get_model(name).make_model()
    shapes = jax.eval_shape(lambda: JQ.quantize_params(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]))
    ref = {path: tuple(qt.scale.shape)
           for path, qt in _ref_quantized(shapes).items()}
    plan = Q.quant_plan(get_model(name).make_model(device="meta"))
    mine = {g.path: g.scale_shape for g in plan if g.scale_shape}
    assert mine == ref
    every = {jax.tree_util.keystr(p): tuple(leaf.q.shape if _is_qt(leaf)
                                            else leaf.shape)
             for p, leaf in jax.tree_util.tree_leaves_with_path(
                 shapes, is_leaf=_is_qt)}
    assert {g.path: g.shape for g in plan} == every
    norm = "['h']['block']['ln1']['scale']" if name == "gpt2-medium" \
        else "['h']['block']['input_norm']['scale']"
    assert mine[norm][0] == 1 and len(mine[norm]) == 2


def test_int8_weights_are_buffers_with_no_resident_copy(pair):
    """The int8 codes replace the parameters (buffers under the
    parametrization); reading ``.weight`` computes the dequantized
    weight each time, in the parameter's type.  Quantizing again
    changes nothing; ``dequantize_params`` leaves plain weights equal
    to what was read."""
    _, _, tmodel = pair
    model = Q.quantize_params(copy.deepcopy(tmodel), min_size=64)
    assert Q.has_quantized(model) and not Q.has_quantized(tmodel)
    lin = model.h[0].fc1 if hasattr(model.h[0], "fc1") \
        else model.h[0].gate_proj
    assert "weight" not in lin._parameters
    assert lin.parametrizations.weight.original.dtype == torch.int8
    assert lin.weight.dtype == torch.float32
    assert not any(p.dtype == torch.float32 and p.ndim == 2
                   for p in model.parameters())
    before = {n: b.clone() for n, b in model.named_buffers()}
    Q.quantize_params(model, min_size=64)
    assert all(torch.equal(before[n], b) for n, b in model.named_buffers())
    read = lin.weight.clone()
    Q.dequantize_params(model)
    assert not Q.has_quantized(model)
    assert torch.equal(lin.weight, read)
    assert model.device.type == "cpu"


@pytest.mark.parametrize("min_size", [4096, 64])
def test_convert_carries_a_quantized_tree(pair, min_size):
    """The reference's quantized tree (numpy leaves, its
    ``QuantizedTensor`` objects kept, or each turned into a ``{"q",
    "scale"}`` mapping) converted and loaded gives the buffers of the
    port's own ``quantize_params``, bitwise, a stacked leaf's shared
    scale one tensor again."""
    name, params, tmodel = pair
    conv = gpt2_state_dict_from_jax if name.startswith("gpt2") \
        else llama_state_dict_from_jax
    want = Q.quantize_params(copy.deepcopy(tmodel), min_size=min_size)
    qtree = jax.tree.map(np.asarray,
                         JQ.quantize_params(params, min_size=min_size))
    as_dicts = jax.tree.map(
        lambda x: {"q": x.q, "scale": x.scale} if _is_qt(x) else x,
        qtree, is_leaf=_is_qt)
    for tree in (qtree, as_dicts):
        got = get_model(name).make_model(device="cpu", dtype=torch.float32)
        convert.load_state_dict(got, conv(tree, got.cfg))
        mine = dict(got.named_buffers())
        assert sorted(mine) == sorted(n for n, _ in want.named_buffers())
        for n, b in want.named_buffers():
            assert mine[n].dtype == b.dtype and torch.equal(mine[n], b), n
        assert Q.quantized_bytes(got) == Q.quantized_bytes(want)
        assert all(torch.equal(p, q) for p, q in zip(got.parameters(),
                                                     want.parameters()))
