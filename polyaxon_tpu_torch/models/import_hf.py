"""HuggingFace checkpoint interop (both directions) for the port's zoo.

Port of ``polyaxon_tpu/models/import_hf.py``'s GPT-2, Llama and BERT
halves.  An HF ``state_dict`` maps onto the port's parameter names
(``load_hf_*``, whose output :func:`convert.load_state_dict` loads) and
back (``export_hf_*``, torch tensors an HF model loads with
``load_state_dict(..., strict=False)``: HF's non-parameter buffers are
not emitted).  Parity is held in ``tests/test_torch_import_hf.py``
against ``transformers``' own forward pass on the same tokens, in both
directions.

Each architecture has ONE per-layer table driving import and export, so
the two directions cannot drift; BERT's three ``attention.self``
Linears fuse into the port's ``qkv`` (query, key, value order, the
models' split).  Layouts: GPT-2 stores Conv1D weights ``[in, out]``
(transposed onto the port's ``[out, in]`` Linear weights); Llama and
BERT store torch Linear ``[out, in]`` (taken as they are).  Every
tensor is checked against the shape the config gives it, and a mismatch
raises naming the HF tensor.  ViT's ``attention.attention`` Linears fuse
into ``qkv`` as BERT's do, and its patch convolution is OIHW in both;
T5's two relative-bias tables live on block 0 of each HF stack (shared
across layers, the port's one table a stack), a v1.0 checkpoint ties
``lm_head`` to ``shared`` and a v1.1 one unties it.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

# Per-layer tables: (hf name under the layer, port name under the
# layer, kind).  kind: "ln" (weight + bias), "rms" (weight), "conv1d"
# (HF [in, out] transposed, with bias), "linear" (torch [out, in], no
# bias), "linear_b" (with bias).
_GPT2_LAYERS: Tuple[Tuple[str, str, str], ...] = (
    ("ln_1", "ln1", "ln"),
    ("attn.c_attn", "qkv", "conv1d"),
    ("attn.c_proj", "o_proj", "conv1d"),
    ("ln_2", "ln2", "ln"),
    ("mlp.c_fc", "fc1", "conv1d"),
    ("mlp.c_proj", "fc2", "conv1d"),
)

_LLAMA_LAYERS: Tuple[Tuple[str, str, str], ...] = (
    ("input_layernorm", "input_norm", "rms"),
    ("self_attn.q_proj", "attn.q_proj", "linear"),
    ("self_attn.k_proj", "attn.k_proj", "linear"),
    ("self_attn.v_proj", "attn.v_proj", "linear"),
    ("self_attn.o_proj", "attn.o_proj", "linear"),
    ("post_attention_layernorm", "post_attn_norm", "rms"),
    ("mlp.gate_proj", "gate_proj", "linear"),
    ("mlp.up_proj", "up_proj", "linear"),
    ("mlp.down_proj", "down_proj", "linear"),
)

# BERT per-layer tensors other than attention.self (fused qkv below).
_BERT_LAYERS: Tuple[Tuple[str, str, str], ...] = (
    ("attention.output.dense", "attn.o_proj", "linear_b"),
    ("attention.output.LayerNorm", "ln_attn", "ln"),
    ("intermediate.dense", "fc1", "linear_b"),
    ("output.dense", "fc2", "linear_b"),
    ("output.LayerNorm", "ln_mlp", "ln"),
)

# kind -> (suffix, transposed)
_KIND_LEAVES = {
    "ln": (("weight", False), ("bias", False)),
    "rms": (("weight", False),),
    "conv1d": (("weight", True), ("bias", False)),
    "linear": (("weight", False),),
    "linear_b": (("weight", False), ("bias", False)),
}

_QKV = ("query", "key", "value")


def _t(x) -> torch.Tensor:
    """A checkpoint leaf (tensor or array) as a float32 CPU tensor."""
    return torch.as_tensor(x).detach().to("cpu", torch.float32)


def _layer_pairs(table, hf_fmt: str, port_fmt: str, n: int):
    """(hf name, port name, transposed) of every leaf of every layer."""
    for i in range(n):
        for hf, ours, kind in table:
            for suffix, transposed in _KIND_LEAVES[kind]:
                yield (f"{hf_fmt.format(i=i)}.{hf}.{suffix}",
                       f"{port_fmt.format(i=i)}.{ours}.{suffix}",
                       transposed)


def _load(sd: Mapping, pairs) -> Dict[str, Tuple[str, torch.Tensor]]:
    """{port name: (hf name, tensor)} over ``pairs``."""
    return {ours: (hf, _t(sd[hf]).T if transposed else _t(sd[hf]))
            for hf, ours, transposed in pairs}


def _checked(model_cls, cfg, loaded: Dict[str, Tuple[str, torch.Tensor]]
             ) -> Dict[str, torch.Tensor]:
    """The port's state dict, each tensor checked against the shape
    ``cfg`` gives it (a meta-device model: no memory)."""
    want = model_cls(cfg, device="meta",
                     param_dtype=torch.float32).state_dict()
    out = {}
    for ours, (hf, t) in loaded.items():
        if ours not in want:
            raise KeyError(f"{hf}: no parameter {ours!r} in the "
                           f"{model_cls.__name__} of {cfg}")
        if tuple(t.shape) != tuple(want[ours].shape):
            width = getattr(cfg, "hidden_size", None) or cfg.d_model
            raise ValueError(
                f"{hf}: shape {tuple(t.shape)} does not match "
                f"{ours} {tuple(want[ours].shape)} of the config "
                f"(hidden {width}, {cfg.num_layers} layers)")
        out[ours] = t.contiguous()
    return out


def _export(sd: Mapping[str, torch.Tensor], pairs) -> Dict[str,
                                                          torch.Tensor]:
    return {hf: (sd[ours].T if transposed else sd[ours]).contiguous()
            for hf, ours, transposed in pairs}


def _state(model_or_sd) -> Dict[str, torch.Tensor]:
    sd = model_or_sd.state_dict() if hasattr(model_or_sd, "state_dict") \
        else model_or_sd
    return {k: v.detach().to("cpu", torch.float32) for k, v in sd.items()}


def _strip(state_dict: Mapping, prefix: str) -> Dict[str, object]:
    return {k.removeprefix(prefix): v for k, v in state_dict.items()}


# -- GPT-2 ---------------------------------------------------------------

def _gpt2_pairs(cfg, hf_prefix: str = ""):
    yield from ((f"{hf_prefix}{hf}", ours, False) for hf, ours in (
        ("wte.weight", "wte.weight"), ("wpe.weight", "wpe.weight"),
        ("ln_f.weight", "ln_f.weight"), ("ln_f.bias", "ln_f.bias")))
    yield from _layer_pairs(_GPT2_LAYERS, hf_prefix + "h.{i}", "h.{i}",
                            cfg.num_layers)


def load_hf_gpt2(state_dict: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """HF ``GPT2LMHeadModel.state_dict()`` -> the port's GPT-2 state
    dict (``lm_head`` is tied to ``wte`` in both)."""
    from .gpt2 import GPT2Model

    sd = _strip(state_dict, "transformer.")
    return _checked(GPT2Model, cfg, _load(sd, _gpt2_pairs(cfg)))


def export_hf_gpt2(model_or_sd, cfg) -> Dict[str, torch.Tensor]:
    """The port's GPT-2 -> an HF ``GPT2LMHeadModel`` state dict."""
    sd = _state(model_or_sd)
    out = _export(sd, _gpt2_pairs(cfg, "transformer."))
    out["lm_head.weight"] = sd["wte.weight"]  # tied
    return out


# -- Llama ---------------------------------------------------------------

def _llama_pairs(cfg, hf_prefix: str = ""):
    yield (f"{hf_prefix}embed_tokens.weight", "embed.weight", False)
    yield (f"{hf_prefix}norm.weight", "final_norm.weight", False)
    yield from _layer_pairs(_LLAMA_LAYERS, hf_prefix + "layers.{i}",
                            "h.{i}", cfg.num_layers)


def load_hf_llama(state_dict: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """HF ``LlamaForCausalLM`` (or ``MistralForCausalLM``) state dict ->
    the port's Llama-family state dict.  A tied checkpoint (no
    ``lm_head.weight``) gives an untied config its embedding as the
    head; a tied config refuses a checkpoint whose head differs from
    its embedding."""
    from .llama import LlamaModel

    sd = _strip(state_dict, "model.")
    loaded = _load(sd, _llama_pairs(cfg))
    embed = loaded["embed.weight"][1]
    head = state_dict.get("lm_head.weight")
    if not cfg.tie_embeddings:
        loaded["lm_head.weight"] = ("lm_head.weight", embed.clone()) \
            if head is None else ("lm_head.weight", _t(head))
    elif head is not None and (tuple(head.shape) != tuple(embed.shape)
                               or not torch.equal(_t(head), embed)):
        raise ValueError(
            "cfg.tie_embeddings=True but the checkpoint has an untied "
            "lm_head.weight; load with tie_embeddings=False")
    return _checked(LlamaModel, cfg, loaded)


def export_hf_llama(model_or_sd, cfg) -> Dict[str, torch.Tensor]:
    """The port's Llama-family model -> an HF ``LlamaForCausalLM`` state
    dict (a tied model emits its embedding as ``lm_head.weight``; pair
    it with ``tie_word_embeddings=True``)."""
    sd = _state(model_or_sd)
    out = _export(sd, _llama_pairs(cfg, "model."))
    out["lm_head.weight"] = sd["embed.weight"] if cfg.tie_embeddings \
        else sd["lm_head.weight"]
    return out


# -- BERT ----------------------------------------------------------------

def _bert_pairs(cfg, hf_prefix: str = ""):
    emb = f"{hf_prefix}embeddings"
    yield from ((hf, ours, False) for hf, ours in (
        (f"{emb}.word_embeddings.weight", "embed.weight"),
        (f"{emb}.position_embeddings.weight", "pos_embed.weight"),
        (f"{emb}.token_type_embeddings.weight", "type_embed.weight"),
        (f"{emb}.LayerNorm.weight", "ln_embed.weight"),
        (f"{emb}.LayerNorm.bias", "ln_embed.bias"),
        ("cls.predictions.transform.dense.weight", "mlm_dense.weight"),
        ("cls.predictions.transform.dense.bias", "mlm_dense.bias"),
        ("cls.predictions.transform.LayerNorm.weight", "mlm_ln.weight"),
        ("cls.predictions.transform.LayerNorm.bias", "mlm_ln.bias"),
        ("cls.predictions.bias", "mlm_bias")))
    yield from _layer_pairs(_BERT_LAYERS, hf_prefix + "encoder.layer.{i}",
                            "layers.{i}", cfg.num_layers)


def load_hf_bert(state_dict: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """HF ``BertForMaskedLM.state_dict()`` -> the port's BERT state
    dict: the three ``attention.self.{query,key,value}`` Linears
    concatenate into the fused ``qkv``; the MLM head maps
    ``cls.predictions.transform`` onto ``mlm_dense`` / ``mlm_ln`` and
    the decoder's standalone bias onto ``mlm_bias``.  An untied decoder
    weight is refused (the port decodes through the embedding).  Build
    the model with ``gelu_approximate=False`` (HF's exact GELU)."""
    from .bert import BertModel

    sd = _strip(state_dict, "bert.")
    loaded = _load(sd, _bert_pairs(cfg))
    dec = state_dict.get("cls.predictions.decoder.weight")
    embed = loaded["embed.weight"][1]
    if dec is not None and (tuple(dec.shape) != tuple(embed.shape)
                            or not torch.equal(_t(dec), embed)):
        raise ValueError(
            "checkpoint has an untied cls.predictions.decoder.weight "
            "(differs from word_embeddings); BertModel only supports the "
            "tied MLM decoder")
    for i in range(cfg.num_layers):
        pre = f"encoder.layer.{i}.attention.self"
        for suffix in ("weight", "bias"):
            loaded[f"layers.{i}.attn.qkv.{suffix}"] = (
                f"{pre}.{{query,key,value}}.{suffix}",
                torch.cat([_t(sd[f"{pre}.{p}.{suffix}"]) for p in _QKV]))
    return _checked(BertModel, cfg, loaded)


def export_hf_bert(model_or_sd, cfg) -> Dict[str, torch.Tensor]:
    """The port's BERT -> an HF ``BertForMaskedLM`` state dict (the
    fused ``qkv`` split back into query / key / value; the tied decoder
    weight emitted beside its bias)."""
    sd = _state(model_or_sd)
    out = _export(sd, _bert_pairs(cfg, "bert."))
    out["cls.predictions.decoder.weight"] = sd["embed.weight"]
    out["cls.predictions.decoder.bias"] = sd["mlm_bias"]
    h = cfg.hidden_size
    for i in range(cfg.num_layers):
        pre = f"bert.encoder.layer.{i}.attention.self"
        for suffix in ("weight", "bias"):
            parts = sd[f"layers.{i}.attn.qkv.{suffix}"].split(h)
            for name, part in zip(_QKV, parts):
                out[f"{pre}.{name}.{suffix}"] = part.contiguous()
    return out


# -- ViT -----------------------------------------------------------------

# ViT per-layer tensors other than attention.attention (fused qkv below).
_VIT_LAYERS: Tuple[Tuple[str, str, str], ...] = (
    ("layernorm_before", "ln1", "ln"),
    ("attention.output.dense", "o_proj", "linear_b"),
    ("layernorm_after", "ln2", "ln"),
    ("intermediate.dense", "fc1", "linear_b"),
    ("output.dense", "fc2", "linear_b"),
)


def _vit_pairs(cfg, hf_prefix: str = ""):
    emb = f"{hf_prefix}embeddings"
    yield from ((hf, ours, False) for hf, ours in (
        (f"{emb}.cls_token", "cls"),
        (f"{emb}.position_embeddings", "pos_embed"),
        (f"{emb}.patch_embeddings.projection.weight",
         "patch_embed.weight"),
        (f"{emb}.patch_embeddings.projection.bias", "patch_embed.bias"),
        (f"{hf_prefix}layernorm.weight", "ln_f.weight"),
        (f"{hf_prefix}layernorm.bias", "ln_f.bias"),
        ("classifier.weight", "head.weight"),
        ("classifier.bias", "head.bias")))
    yield from _layer_pairs(_VIT_LAYERS, hf_prefix + "encoder.layer.{i}",
                            "h.{i}", cfg.num_layers)


def load_hf_vit(state_dict: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """HF ``ViTForImageClassification.state_dict()`` -> the port's ViT
    state dict: the three ``attention.attention.{query,key,value}``
    Linears concatenate into ``qkv``.  HF feeds NCHW pixels; the port
    takes NHWC images, as the reference.  Build the model with
    ``gelu_approximate=False`` (HF's exact GELU)."""
    from .vit import ViTModel

    sd = _strip(state_dict, "vit.")
    loaded = _load(sd, _vit_pairs(cfg))
    for i in range(cfg.num_layers):
        pre = f"encoder.layer.{i}.attention.attention"
        for suffix in ("weight", "bias"):
            loaded[f"h.{i}.qkv.{suffix}"] = (
                f"{pre}.{{query,key,value}}.{suffix}",
                torch.cat([_t(sd[f"{pre}.{p}.{suffix}"]) for p in _QKV]))
    return _checked(ViTModel, cfg, loaded)


def export_hf_vit(model_or_sd, cfg) -> Dict[str, torch.Tensor]:
    """The port's ViT -> an HF ``ViTForImageClassification`` state
    dict (``qkv`` split back into query / key / value)."""
    sd = _state(model_or_sd)
    out = _export(sd, _vit_pairs(cfg, "vit."))
    h = cfg.hidden_size
    for i in range(cfg.num_layers):
        pre = f"vit.encoder.layer.{i}.attention.attention"
        for suffix in ("weight", "bias"):
            parts = sd[f"h.{i}.qkv.{suffix}"].split(h)
            for name, part in zip(_QKV, parts):
                out[f"{pre}.{name}.{suffix}"] = part.contiguous()
    return out


# -- T5 ------------------------------------------------------------------

def _t5_layer_tables(cfg):
    """Per-layer tables of the T5 encoder and decoder blocks (the FF
    names follow ``feed_forward``)."""
    ff = (("DenseReluDense.wi_0", "wi_0", "linear"),
          ("DenseReluDense.wi_1", "wi_1", "linear")) \
        if cfg.feed_forward == "gated-gelu" else \
        (("DenseReluDense.wi", "wi", "linear"),)
    ff += (("DenseReluDense.wo", "wo", "linear"),)

    def attn(hf, ours):
        return tuple((f"{hf}.{p}", f"{ours}.{p}_proj", "linear")
                     for p in ("q", "k", "v", "o"))

    enc = (("layer.0.layer_norm", "ln_self", "rms"),
           *attn("layer.0.SelfAttention", "attn"),
           ("layer.1.layer_norm", "ln_ff", "rms"),
           *((f"layer.1.{h}", o, k) for h, o, k in ff))
    dec = (("layer.0.layer_norm", "ln_self", "rms"),
           *attn("layer.0.SelfAttention", "attn"),
           ("layer.1.layer_norm", "ln_cross", "rms"),
           *attn("layer.1.EncDecAttention", "cross"),
           ("layer.2.layer_norm", "ln_ff", "rms"),
           *((f"layer.2.{h}", o, k) for h, o, k in ff))
    return enc, dec


_T5_REL = "block.0.layer.0.SelfAttention.relative_attention_bias.weight"


def _t5_pairs(cfg):
    enc, dec = _t5_layer_tables(cfg)
    yield from ((hf, ours, False) for hf, ours in (
        ("shared.weight", "embed.weight"),
        (f"encoder.{_T5_REL}", "enc_rel.rel_bias.weight"),
        (f"decoder.{_T5_REL}", "dec_rel.rel_bias.weight"),
        ("encoder.final_layer_norm.weight", "enc_norm.weight"),
        ("decoder.final_layer_norm.weight", "dec_norm.weight")))
    yield from _layer_pairs(enc, "encoder.block.{i}", "enc.{i}",
                            cfg.num_layers)
    yield from _layer_pairs(dec, "decoder.block.{i}", "dec.{i}",
                            cfg.num_decoder_layers)


def load_hf_t5(state_dict: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """HF ``T5ForConditionalGeneration.state_dict()`` -> the port's T5
    state dict.  A tied config (v1.0) refuses a checkpoint whose
    ``lm_head.weight`` differs from ``shared``: decoding through the
    scaled, tied embedding instead would change every logit.  An untied
    config (v1.1) takes ``lm_head.weight`` and refuses a checkpoint
    without one: T5's tied path also scales the hidden state by
    ``d_model ** -0.5``, so the embedding is no stand-in for it."""
    from .t5 import T5Model

    loaded = _load(state_dict, _t5_pairs(cfg))
    embed = loaded["embed.weight"][1]
    head = state_dict.get("lm_head.weight")
    if cfg.tie_embeddings:
        if head is not None and (tuple(head.shape) != tuple(embed.shape)
                                 or not torch.equal(_t(head), embed)):
            raise ValueError(
                "checkpoint has an untied lm_head.weight but "
                "cfg.tie_embeddings=True; build the model with "
                "tie_embeddings=False to keep the checkpoint's head")
    else:
        if head is None:
            raise ValueError(
                "checkpoint has no lm_head.weight (a tied v1.0 "
                "checkpoint); load with cfg.tie_embeddings=True")
        loaded["lm_head.weight"] = ("lm_head.weight", _t(head))
    return _checked(T5Model, cfg, loaded)


def export_hf_t5(model_or_sd, cfg) -> Dict[str, torch.Tensor]:
    """The port's T5 -> an HF ``T5ForConditionalGeneration`` state dict
    (the shared / encoder / decoder embedding aliases all emitted; a
    tied model's embedding as ``lm_head.weight``)."""
    sd = _state(model_or_sd)
    out = _export(sd, _t5_pairs(cfg))
    out["encoder.embed_tokens.weight"] = sd["embed.weight"]
    out["decoder.embed_tokens.weight"] = sd["embed.weight"]
    out["lm_head.weight"] = sd["embed.weight"] if cfg.tie_embeddings \
        else sd["lm_head.weight"]
    return out
