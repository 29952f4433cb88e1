"""Carry flax GPT-2 and Llama-family weights across to the port.

The caller turns the flax param tree into numpy
(``jax.tree.map(np.asarray, variables["params"])``); this module never
imports JAX.  Both flax layouts are read: the scanned stack
(``h/block/<leaf>`` with a leading [num_layers] axis) and the unrolled
one (``h_{i}/<leaf>``).

A tree the reference's ``quantize_params`` made carries its int8 leaves
across too: a leaf with ``.q`` and ``.scale`` (its ``QuantizedTensor``,
duck-typed) or a ``{"q", "scale"}`` mapping becomes a
:class:`QuantizedWeight` in the port's layout, per layer for a stacked
leaf (a scale reduced over the layer axis is ONE tensor shared by every
layer), and :func:`load_state_dict` attaches it
(``ops.quant.attach_quantized``).
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, NamedTuple

import numpy as np
import torch

from .ops.quant import attach_quantized

_GPT2_DENSE = ("qkv", "o_proj", "fc1", "fc2")
_GPT2_NORMS = ("ln1", "ln2")
_LLAMA_DENSE = ("attn/q_proj", "attn/k_proj", "attn/v_proj", "attn/o_proj",
                "gate_proj", "up_proj", "down_proj")
_LLAMA_NORMS = ("input_norm", "post_attn_norm")


class QuantizedWeight(NamedTuple):
    """A quantized leaf carried across: int8 codes and their bf16
    scale, in the port's layout."""
    q: torch.Tensor
    scale: torch.Tensor


def _quantized(x) -> bool:
    if isinstance(x, Mapping):
        return set(x) == {"q", "scale"}
    return hasattr(x, "q") and hasattr(x, "scale")


class _QLeaf(NamedTuple):
    """One layer's quantized leaf (numpy), ``shared`` naming the stacked
    scale it shares with the other layers (None: its own)."""
    q: np.ndarray
    scale: np.ndarray
    shared: object = None


def _as_qleaf(x) -> _QLeaf:
    q, scale = (x["q"], x["scale"]) if isinstance(x, Mapping) \
        else (x.q, x.scale)
    return _QLeaf(np.asarray(q), np.asarray(scale))


def _t(x, transpose: bool = False, scales=None):
    """A leaf as a torch tensor (``transpose``: a Dense kernel), or a
    quantized one as a :class:`QuantizedWeight`; ``scales`` maps each
    shared stacked scale to its one tensor."""
    if _quantized(x):
        x = x if isinstance(x, _QLeaf) else _as_qleaf(x)
        q = x.q.T if transpose else x.q
        scale = x.scale.T if transpose else x.scale
        if x.shared is None:
            return QuantizedWeight(_t(q), _t(scale))
        if x.shared not in scales:
            scales[x.shared] = _t(scale)
        return QuantizedWeight(_t(q), scales[x.shared])
    x = np.array(np.asarray(x).T if transpose else x, copy=True)
    if x.dtype.name == "bfloat16":
        # numpy keeps bf16 (a quantized leaf's scale) as ml_dtypes'
        # type, which torch does not read: carry its 16 bits over.
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _first_leaf(tree):
    while isinstance(tree, Mapping) and not _quantized(tree):
        tree = next(iter(tree.values()))
    return _as_qleaf(tree).q if _quantized(tree) else tree


def _index(tree: Mapping, i: int) -> dict:
    """Layer ``i`` of a stacked tree: every leaf's row ``i``; a quantized
    leaf's codes' row ``i`` with its scale's row ``i``, or the one scale
    reduced over the layers (``[1, ...]``), shared."""
    out = {}
    for k, v in tree.items():
        if _quantized(v):
            leaf = _as_qleaf(v)
            if leaf.scale.shape[0] > 1:
                out[k] = _QLeaf(leaf.q[i], leaf.scale[i])
            else:
                out[k] = _QLeaf(leaf.q[i], leaf.scale[0],
                                shared=id(_scale_of(v)))
        elif isinstance(v, Mapping):
            out[k] = _index(v, i)
        else:
            out[k] = np.asarray(v)[i]
    return out


def _scale_of(x):
    return x["scale"] if isinstance(x, Mapping) else x.scale


def _layer_trees(params: Mapping, num_layers: int) -> Iterator[Mapping]:
    """Yield each layer's param tree, from either layout."""
    if "h" in params:
        stacked = params["h"]["block"]
        depth = len(np.asarray(_first_leaf(stacked)))
        if depth != num_layers:
            raise ValueError(f"params stack {depth} layers; cfg has "
                             f"{num_layers}")
        for i in range(num_layers):
            yield _index(stacked, i)
    elif "h_0" in params:
        depth = sum(1 for key in params if key.startswith("h_"))
        if depth != num_layers:
            raise ValueError(f"params hold {depth} layers; cfg has "
                             f"{num_layers}")
        for i in range(num_layers):
            yield params[f"h_{i}"]
    else:
        raise ValueError("params hold neither a scanned 'h' stack nor "
                         "unrolled 'h_{i}' blocks")


def _at(tree: Mapping, path: str):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def gpt2_state_dict_from_jax(params: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """The flax GPT-2 param tree (numpy leaves) -> the port's state dict.

    Dense ``kernel [in, out]`` becomes ``Linear.weight [out, in]``;
    LayerNorm ``scale`` becomes ``weight``; embeddings keep their
    ``[rows, hidden]`` shape.  Values are copied exactly (float32, as
    flax stores them); ``load_state_dict`` casts to the model's dtype.
    The same mapping carries a flax gradient tree onto the port's
    parameter names.  Quantized leaves become :class:`QuantizedWeight`
    entries (load them with :func:`load_state_dict`)."""
    scales: dict = {}
    sd: Dict[str, torch.Tensor] = {
        "wte.weight": _t(params["wte"]["embedding"], scales=scales),
        "wpe.weight": _t(params["wpe"]["embedding"], scales=scales),
        "ln_f.weight": _t(params["ln_f"]["scale"], scales=scales),
        "ln_f.bias": _t(params["ln_f"]["bias"], scales=scales),
    }
    for i, layer in enumerate(_layer_trees(params, cfg.num_layers)):
        for mod in _GPT2_DENSE:
            sd[f"h.{i}.{mod}.weight"] = _t(layer[mod]["kernel"], True,
                                           scales)
            sd[f"h.{i}.{mod}.bias"] = _t(layer[mod]["bias"], scales=scales)
        for mod in _GPT2_NORMS:
            sd[f"h.{i}.{mod}.weight"] = _t(layer[mod]["scale"],
                                           scales=scales)
            sd[f"h.{i}.{mod}.bias"] = _t(layer[mod]["bias"], scales=scales)
    return sd


def llama_state_dict_from_jax(params: Mapping,
                              cfg) -> Dict[str, torch.Tensor]:
    """The flax Llama-family param tree (numpy leaves) -> the port's
    state dict: bias-free Dense ``kernel [in, out]`` -> ``weight [out,
    in]``, RMSNorm ``scale`` -> ``weight``, ``embed/embedding`` ->
    ``embed.weight``, ``lm_head/kernel`` -> ``lm_head.weight`` (absent
    with ``tie_embeddings``).  Exact float32 copies; the same mapping
    carries a flax gradient tree onto the port's parameter names.
    Quantized leaves become :class:`QuantizedWeight` entries."""
    scales: dict = {}
    sd: Dict[str, torch.Tensor] = {
        "embed.weight": _t(params["embed"]["embedding"], scales=scales),
        "final_norm.weight": _t(params["final_norm"]["scale"],
                                scales=scales),
    }
    if "lm_head" in params:
        sd["lm_head.weight"] = _t(params["lm_head"]["kernel"], True, scales)
    for i, layer in enumerate(_layer_trees(params, cfg.num_layers)):
        for path in _LLAMA_DENSE:
            sd[f"h.{i}.{path.replace('/', '.')}.weight"] = _t(
                _at(layer, path)["kernel"], True, scales)
        for mod in _LLAMA_NORMS:
            sd[f"h.{i}.{mod}.weight"] = _t(layer[mod]["scale"],
                                           scales=scales)
    return sd


def load_state_dict(model: torch.nn.Module, sd: Mapping) -> None:
    """Load a converted state dict into ``model`` (strict): plain
    tensors through ``model.load_state_dict``, each
    :class:`QuantizedWeight` attached to its module as int8 codes read
    through the dequantizing parametrization."""
    quantized = {k: v for k, v in sd.items()
                 if isinstance(v, QuantizedWeight)}
    plain = {k: v for k, v in sd.items() if k not in quantized}
    missing, unexpected = model.load_state_dict(plain, strict=False)
    if unexpected or set(missing) != set(quantized):
        raise KeyError(f"state dict does not match the model: missing "
                       f"{sorted(set(missing) - set(quantized))}, "
                       f"unexpected {sorted(unexpected)}")
    for name, w in quantized.items():
        path, attr = name.rsplit(".", 1)
        attach_quantized(model.get_submodule(path), attr, w.q, w.scale)
