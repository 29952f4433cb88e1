"""Carry flax GPT-2 and Llama-family weights across to the port.

The caller turns the flax param tree into numpy
(``jax.tree.map(np.asarray, variables["params"])``); this module never
imports JAX.  Both flax layouts are read: the scanned stack
(``h/block/<leaf>`` with a leading [num_layers] axis) and the unrolled
one (``h_{i}/<leaf>``).
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping

import numpy as np
import torch

_GPT2_DENSE = ("qkv", "o_proj", "fc1", "fc2")
_GPT2_NORMS = ("ln1", "ln2")
_LLAMA_DENSE = ("attn/q_proj", "attn/k_proj", "attn/v_proj", "attn/o_proj",
                "gate_proj", "up_proj", "down_proj")
_LLAMA_NORMS = ("input_norm", "post_attn_norm")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _first_leaf(tree):
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return tree


def _index(tree: Mapping, i: int) -> dict:
    """Layer ``i`` of a stacked tree: every leaf's row ``i``."""
    return {k: _index(v, i) if isinstance(v, Mapping) else np.asarray(v)[i]
            for k, v in tree.items()}


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
    parameter names."""
    sd: Dict[str, torch.Tensor] = {
        "wte.weight": _t(params["wte"]["embedding"]),
        "wpe.weight": _t(params["wpe"]["embedding"]),
        "ln_f.weight": _t(params["ln_f"]["scale"]),
        "ln_f.bias": _t(params["ln_f"]["bias"]),
    }
    for i, layer in enumerate(_layer_trees(params, cfg.num_layers)):
        for mod in _GPT2_DENSE:
            sd[f"h.{i}.{mod}.weight"] = _t(np.asarray(layer[mod]["kernel"]).T)
            sd[f"h.{i}.{mod}.bias"] = _t(layer[mod]["bias"])
        for mod in _GPT2_NORMS:
            sd[f"h.{i}.{mod}.weight"] = _t(layer[mod]["scale"])
            sd[f"h.{i}.{mod}.bias"] = _t(layer[mod]["bias"])
    return sd


def llama_state_dict_from_jax(params: Mapping,
                              cfg) -> Dict[str, torch.Tensor]:
    """The flax Llama-family param tree (numpy leaves) -> the port's
    state dict: bias-free Dense ``kernel [in, out]`` -> ``weight [out,
    in]``, RMSNorm ``scale`` -> ``weight``, ``embed/embedding`` ->
    ``embed.weight``, ``lm_head/kernel`` -> ``lm_head.weight`` (absent
    with ``tie_embeddings``).  Exact float32 copies; the same mapping
    carries a flax gradient tree onto the port's parameter names."""
    sd: Dict[str, torch.Tensor] = {
        "embed.weight": _t(params["embed"]["embedding"]),
        "final_norm.weight": _t(params["final_norm"]["scale"]),
    }
    if "lm_head" in params:
        sd["lm_head.weight"] = _t(np.asarray(params["lm_head"]["kernel"]).T)
    for i, layer in enumerate(_layer_trees(params, cfg.num_layers)):
        for path in _LLAMA_DENSE:
            sd[f"h.{i}.{path.replace('/', '.')}.weight"] = _t(
                np.asarray(_at(layer, path)["kernel"]).T)
        for mod in _LLAMA_NORMS:
            sd[f"h.{i}.{mod}.weight"] = _t(layer[mod]["scale"])
    return sd
