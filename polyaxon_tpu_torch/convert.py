"""Carry flax weights across to the port: GPT-2, the Llama family,
BERT, the MLP, the ConvNet, ResNet (its ``batch_stats`` onto the
batch norms' running buffers), MoE-GPT, T5 and ViT.

The caller turns the flax param tree into numpy
(``jax.tree.map(np.asarray, variables["params"])``); this module never
imports JAX.  Both flax layouts of a layer stack are read: the scanned
one (``h/block/<leaf>``, BERT's ``layers/layer/<leaf>``, with a leading
[num_layers] axis) and the unrolled one (``h_{i}/<leaf>``,
``layer_{i}/<leaf>``).  Dense kernels ``[in, out]`` become
``weight [out, in]``, convolution kernels HWIO become OIHW, norm
``scale`` becomes ``weight``.

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


def _layer_trees(params: Mapping, num_layers: int, stack=("h", "block"),
                 unrolled: str = "h_") -> Iterator[Mapping]:
    """Yield each layer's param tree, from either layout: the scanned
    ``params[stack[0]][stack[1]]`` or the unrolled
    ``params[f"{unrolled}{i}"]``."""
    outer, inner = stack
    if outer in params:
        stacked = params[outer][inner]
        depth = len(np.asarray(_first_leaf(stacked)))
        if depth != num_layers:
            raise ValueError(f"params stack {depth} layers; cfg has "
                             f"{num_layers}")
        for i in range(num_layers):
            yield _index(stacked, i)
    elif f"{unrolled}0" in params:
        depth = sum(1 for key in params if key.startswith(unrolled)
                    and key[len(unrolled):].isdigit())
        if depth != num_layers:
            raise ValueError(f"params hold {depth} layers; cfg has "
                             f"{num_layers}")
        for i in range(num_layers):
            yield params[f"{unrolled}{i}"]
    else:
        raise ValueError(f"params hold neither a scanned {outer!r} stack "
                         f"nor unrolled '{unrolled}{{i}}' layers")


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


def _dense(sd: dict, name: str, tree: Mapping, bias: bool = True) -> None:
    sd[f"{name}.weight"] = _t(tree["kernel"], True)
    if bias:
        sd[f"{name}.bias"] = _t(tree["bias"])


def _norm(sd: dict, name: str, tree: Mapping) -> None:
    sd[f"{name}.weight"] = _t(tree["scale"])
    sd[f"{name}.bias"] = _t(tree["bias"])


def _conv(sd: dict, name: str, tree: Mapping) -> None:
    sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
        np.asarray(tree["kernel"]).transpose(3, 2, 0, 1)))
    if "bias" in tree:
        sd[f"{name}.bias"] = _t(tree["bias"])


def mlp_state_dict_from_jax(params: Mapping,
                            cfg) -> Dict[str, torch.Tensor]:
    """The flax MLP param tree -> the port's state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(len(cfg.features)):
        _dense(sd, f"fc{i + 1}", params[f"fc{i + 1}"])
    _dense(sd, "head", params["head"])
    return sd


def convnet_state_dict_from_jax(params: Mapping,
                                cfg) -> Dict[str, torch.Tensor]:
    """The flax ConvNet param tree -> the port's state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(len(cfg.widths)):
        for j in range(2):
            name = f"block{i + 1}_conv{j + 1}"
            _conv(sd, name, params[name])
    _dense(sd, "fc1", params["fc1"])
    _dense(sd, "head", params["head"])
    return sd


def resnet_state_dict_from_jax(params: Mapping, cfg,
                               batch_stats: Mapping = None
                               ) -> Dict[str, torch.Tensor]:
    """The flax ResNet tree -> the port's state dict: ``params`` (or a
    gradient tree) onto the parameters and, given, ``batch_stats``
    (``mean``, ``var``) onto each batch norm's ``running_mean`` and
    ``running_var``."""
    sd: Dict[str, torch.Tensor] = {}

    def norm(name, path):
        _norm(sd, name, _at(params, path))
        if batch_stats is not None:
            stats = _at(batch_stats, path)
            sd[f"{name}.running_mean"] = _t(stats["mean"])
            sd[f"{name}.running_var"] = _t(stats["var"])

    _conv(sd, "stem_conv", params["stem_conv"])
    norm("stem_bn", "stem_bn")
    for i, count in enumerate(cfg.stage_sizes):
        for j in range(count):
            block = f"stage{i + 1}_block{j + 1}"
            pairs = [("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3")]
            if "proj_conv" in params[block]:
                pairs.append(("proj_conv", "proj_bn"))
            for conv, bn in pairs:
                _conv(sd, f"{block}.{conv}", params[block][conv])
                norm(f"{block}.{bn}", f"{block}/{bn}")
    _dense(sd, "head", params["head"])
    return sd


def bert_state_dict_from_jax(params: Mapping,
                             cfg) -> Dict[str, torch.Tensor]:
    """The flax BERT param tree -> the port's state dict, from the
    scanned ``layers/layer`` stack or unrolled ``layer_{i}`` layers.  A
    tree without ``type_embed`` (flax creates it only when a call passes
    ``token_type_ids``) carries zeros there."""
    sd: Dict[str, torch.Tensor] = {
        "embed.weight": _t(params["embed"]["embedding"]),
        "pos_embed.weight": _t(params["pos_embed"]["embedding"]),
        "type_embed.weight": _t(params["type_embed"]["embedding"])
        if "type_embed" in params else
        torch.zeros(cfg.type_vocab_size, cfg.hidden_size),
        "mlm_bias": _t(params["mlm_bias"]),
    }
    _norm(sd, "ln_embed", params["ln_embed"])
    _dense(sd, "mlm_dense", params["mlm_dense"])
    _norm(sd, "mlm_ln", params["mlm_ln"])
    for i, layer in enumerate(_layer_trees(
            params, cfg.num_layers, ("layers", "layer"), "layer_")):
        for path in ("attn/qkv", "attn/o_proj", "fc1", "fc2"):
            _dense(sd, f"layers.{i}.{path.replace('/', '.')}",
                   _at(layer, path))
        for mod in ("ln_attn", "ln_mlp"):
            _norm(sd, f"layers.{i}.{mod}", layer[mod])
    return sd


def moe_gpt_state_dict_from_jax(params: Mapping,
                                cfg) -> Dict[str, torch.Tensor]:
    """The flax MoE-GPT param tree -> the port's state dict: GPT-2's
    attention, norms and embeddings, and each layer's ``moe`` router
    ``[d, E]`` and experts ``[E, d, f]`` / ``[E, f, d]`` as they are
    (the port keeps the reference's layout)."""
    sd: Dict[str, torch.Tensor] = {
        "wte.weight": _t(params["wte"]["embedding"]),
        "wpe.weight": _t(params["wpe"]["embedding"]),
    }
    _norm(sd, "ln_f", params["ln_f"])
    for i, layer in enumerate(_layer_trees(params, cfg.num_layers)):
        for mod in ("qkv", "o_proj"):
            _dense(sd, f"h.{i}.{mod}", layer[mod])
        for mod in _GPT2_NORMS:
            _norm(sd, f"h.{i}.{mod}", layer[mod])
        for leaf in ("router", "experts_w1", "experts_w2"):
            sd[f"h.{i}.moe.{leaf}"] = _t(layer["moe"][leaf])
    return sd


_T5_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")


def t5_state_dict_from_jax(params: Mapping,
                           cfg) -> Dict[str, torch.Tensor]:
    """The flax T5 param tree -> the port's state dict, from the scanned
    ``enc/block`` and ``dec/block`` stacks or unrolled ``enc_{i}`` /
    ``dec_{i}`` blocks: bias-free Dense kernels transposed, RMSNorm
    ``scale`` -> ``weight``, the two bias tables, and ``lm_head`` when
    the config is untied."""
    sd: Dict[str, torch.Tensor] = {
        "embed.weight": _t(params["embed"]["embedding"]),
        "enc_rel.rel_bias.weight":
            _t(params["enc_rel"]["rel_bias"]["embedding"]),
        "dec_rel.rel_bias.weight":
            _t(params["dec_rel"]["rel_bias"]["embedding"]),
        "enc_norm.weight": _t(params["enc_norm"]["scale"]),
        "dec_norm.weight": _t(params["dec_norm"]["scale"]),
    }
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = _t(params["lm_head"]["kernel"], True)
    ff = ("wi_0", "wi_1", "wo") if cfg.feed_forward == "gated-gelu" \
        else ("wi", "wo")
    for stack, depth, attns, norms in (
            ("enc", cfg.num_layers, ("attn",), ("ln_self", "ln_ff")),
            ("dec", cfg.num_decoder_layers, ("attn", "cross"),
             ("ln_self", "ln_cross", "ln_ff"))):
        for i, layer in enumerate(_layer_trees(params, depth,
                                               (stack, "block"),
                                               f"{stack}_")):
            for attn in attns:
                for proj in _T5_ATTN:
                    _dense(sd, f"{stack}.{i}.{attn}.{proj}",
                           layer[attn][proj], bias=False)
            for mod in ff:
                _dense(sd, f"{stack}.{i}.{mod}", layer[mod], bias=False)
            for mod in norms:
                sd[f"{stack}.{i}.{mod}.weight"] = _t(layer[mod]["scale"])
    return sd


def vit_state_dict_from_jax(params: Mapping,
                            cfg) -> Dict[str, torch.Tensor]:
    """The flax ViT param tree -> the port's state dict (the patch
    convolution's HWIO kernel as OIHW)."""
    sd: Dict[str, torch.Tensor] = {
        "cls": _t(params["cls"]),
        "pos_embed": _t(params["pos_embed"]),
    }
    _conv(sd, "patch_embed", params["patch_embed"])
    _norm(sd, "ln_f", params["ln_f"])
    _dense(sd, "head", params["head"])
    for i, layer in enumerate(_layer_trees(params, cfg.num_layers)):
        for mod in _GPT2_DENSE:
            _dense(sd, f"h.{i}.{mod}", layer[mod])
        for mod in _GPT2_NORMS:
            _norm(sd, f"h.{i}.{mod}", layer[mod])
    return sd


# The unrolled flax name of each layer list the converters read
# (``_layer_trees``' ``unrolled`` argument): port ``h.{i}`` is flax
# ``h_{i}``, BERT's ``layers.{i}`` is ``layer_{i}``, T5's ``enc.{i}`` /
# ``dec.{i}`` are ``enc_{i}`` / ``dec_{i}``.
_UNROLLED = {"h": "h_", "layers": "layer_", "enc": "enc_", "dec": "dec_"}


def _leaf_kind(module: torch.nn.Module, attr: str) -> tuple:
    """(flax leaf name, kind) of ``module``'s parameter ``attr``, as the
    converters rename them: a dense ``weight`` is the ``kernel``
    (transposed), a convolution's the ``kernel`` (HWIO), a table's the
    ``embedding``, a norm's ``weight`` its ``scale``; anything else
    keeps its name."""
    kind = type(module).__name__
    if attr == "weight":
        if isinstance(module, torch.nn.Embedding) or "Embedding" in kind:
            return "embedding", "embedding"
        if "Norm" in kind:
            return "scale", "norm"
        if kind == "Conv":
            return "kernel", "conv"
        if isinstance(module, torch.nn.Linear) or "Dense" in kind:
            return "kernel", "dense"
    return attr, "param"


def reference_paths(model: torch.nn.Module) -> Dict[str, tuple]:
    """name -> (the reference's param path, leaf kind) for every
    parameter of ``model``: the inverse of the converters' renaming
    (port names follow the flax tree; the layer lists are unrolled, as
    ``_UNROLLED`` names them; leaves as :func:`_leaf_kind` renames
    them).  ``h.3.qkv.weight`` -> ``("h_3/qkv/kernel", "dense")``."""
    out = {}
    for name, _ in model.named_parameters():
        mod_name, _, attr = name.rpartition(".")
        module = model.get_submodule(mod_name) if mod_name else model
        leaf, kind = _leaf_kind(module, attr)
        parts = mod_name.split(".") if mod_name else []
        path, i = [], 0
        while i < len(parts):
            if parts[i] in _UNROLLED and i + 1 < len(parts) and \
                    parts[i + 1].isdigit():
                path.append(f"{_UNROLLED[parts[i]]}{parts[i + 1]}")
                i += 2
            else:
                path.append(parts[i])
                i += 1
        out[name] = ("/".join(path + [leaf]), kind)
    return out


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
