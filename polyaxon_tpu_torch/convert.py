"""Carry flax GPT-2 weights across to the port.

The caller turns the flax param tree into numpy
(``jax.tree.map(np.asarray, variables["params"])``); this module never
imports JAX.  Both flax layouts are read: the scanned stack
(``h/block/<leaf>`` with a leading [num_layers] axis) and the unrolled
one (``h_{i}/<leaf>``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_DENSE = ("qkv", "o_proj", "fc1", "fc2")
_NORMS = ("ln1", "ln2")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _layer_trees(params: Mapping, num_layers: int):
    """Yield each layer's {leaf_module: {name: array}} tree."""
    if "h" in params:
        stacked = params["h"]["block"]
        depth = len(np.asarray(stacked["qkv"]["kernel"]))
        if depth != num_layers:
            raise ValueError(f"params stack {depth} layers; cfg has "
                             f"{num_layers}")
        for i in range(num_layers):
            yield {mod: {name: np.asarray(a)[i] for name, a in leaves.items()}
                   for mod, leaves in stacked.items()}
    elif "h_0" in params:
        depth = sum(1 for key in params if key.startswith("h_"))
        if depth != num_layers:
            raise ValueError(f"params hold {depth} layers; cfg has "
                             f"{num_layers}")
        for i in range(num_layers):
            yield params[f"h_{i}"]
    else:
        raise ValueError("GPT-2 params hold neither a scanned 'h' stack "
                         "nor unrolled 'h_{i}' blocks")


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
        for mod in _DENSE:
            sd[f"h.{i}.{mod}.weight"] = _t(np.asarray(layer[mod]["kernel"]).T)
            sd[f"h.{i}.{mod}.bias"] = _t(layer[mod]["bias"])
        for mod in _NORMS:
            sd[f"h.{i}.{mod}.weight"] = _t(layer[mod]["scale"])
            sd[f"h.{i}.{mod}.bias"] = _t(layer[mod]["bias"])
    return sd
