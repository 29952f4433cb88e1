"""Model registry: name -> (constructor, loss, synthetic batch).

Port of ``polyaxon_tpu/models/registry.py``: the GPT-2, Llama-family,
MLP, ConvNet, ResNet-50 and BERT entries, with the same constructors,
synthetic batches (numpy ``RandomState(0)``, so both packages draw the
same tokens and images), losses (LM, classifier with accuracy, MLM with
the reference's mask bits through ``prng.bernoulli``) and analytic FLOP
models, and the rest of the reference's zoo: MoE-GPT (the LM loss plus
``aux_weight`` times the switch load-balance loss), T5 (the
teacher-forced seq2seq loss, with the span-corruption batches'
``enc_mask`` and ``target_mask``) and ViT (the classifier loss).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import default_device, prng
from ..parallel.collectives import (data_all_reduce, data_all_reduce_mean,
                                    data_shard)
from .bert import BertConfig, BertModel
from .convnet import ConvNet, ConvNetConfig
from .gpt2 import GPT2Config, GPT2Model
from .layers import BatchNorm
from .llama import LlamaConfig, LlamaModel
from .mlp import MLP, MLPConfig
from .moe_gpt import MoEGPTConfig, MoEGPTModel
from .resnet import ResNet, ResNetConfig
from .t5 import T5Config, T5Model, shift_right
from .vit import ViTConfig, ViTModel


def softmax_xent(logits, labels):
    """Mean softmax cross-entropy over integer labels, in f32."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                           labels.reshape(-1).long())


def _cfg_model(model_cls, base_cfg):
    """make_model for config-bearing models: keyword overrides patch
    CONFIG FIELDS (``dataclasses.replace``), the serving options
    (``kv_cache_int8``, ``kv_cache_ring``, ``kv_cache_ring_slack``)
    like any other, so a family without the field raises TypeError;
    ``device`` and ``param_dtype`` go to the constructor."""
    def make(device=None, param_dtype=None, **kw):
        cfg = dataclasses.replace(base_cfg, **kw) if kw else base_cfg
        return model_cls(cfg, device=device, param_dtype=param_dtype)
    return make


def _init_weights(model: torch.nn.Module,
                  generator: torch.Generator) -> None:
    """Random init of a zoo model from a seeded CPU generator, so the
    weights are the same on every device.  Scales follow flax's
    defaults: dense and convolution kernels lecun-normal (std
    1/sqrt(fan_in), fan_in = every axis but the output one), embeddings
    std 1/sqrt(hidden), zero biases, unit norm scales (the
    one-dimensional weights), and a zero scale on the batch norms that
    start their residual branch as the identity (ResNet's ``bn3``).  A
    parameter carrying ``init_std`` (the reference's explicit
    initializers: MoE's ``normal(0.02)``, ViT's zero CLS token) is drawn
    with that standard deviation.  The numbers differ from flax's; tests
    that compare with the reference convert its params instead."""
    zero = {f"{name}.weight" for name, m in model.named_modules()
            if isinstance(m, BatchNorm) and m.zero_scale}
    for name, p in model.named_parameters():
        std = getattr(p, "init_std", None)
        if std is not None:
            w = torch.randn(p.shape, generator=generator) * std
        elif name.endswith("bias") or name in zero:
            w = torch.zeros(p.shape)
        elif p.ndim == 1:
            w = torch.ones(p.shape)
        else:
            w = torch.randn(p.shape, generator=generator) \
                * (p[0].numel()) ** -0.5
        p.data.copy_(w.to(p.dtype))


def _image_batch(batch_size: int, hw: int, classes: int,
                 channels: int = 3) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(0)
    return {
        "inputs": rng.rand(batch_size, hw, hw, channels).astype("float32"),
        "labels": rng.randint(0, classes, size=(batch_size,)),
    }


def _token_batch(batch_size: int, seq: int,
                 vocab: int) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(0)
    return {"inputs": rng.randint(0, vocab, size=(batch_size, seq))}


def _lm_loss(model):
    """model -> loss(batch, rng=None) -> (loss, {"perplexity"}):
    next-token cross-entropy, the logits shifted by one.  The model holds
    the parameters; ``rng`` is unused (the decoders have no dropout)."""
    def loss(batch, rng=None):
        tokens = torch.as_tensor(batch["inputs"], device=model.device)
        logits = model(tokens, train=True)
        # A mean over this rank's rows.  Every data rank holds as many
        # rows of the same length, so the mean of the ranks' means (the
        # train step's metric, and its mean of their gradients) is the
        # global batch's mean: no global sum is needed here.  The
        # perplexity is of that global mean.
        l = softmax_xent(logits[:, :-1], tokens[:, 1:])
        return l, {"perplexity": torch.exp(
            data_all_reduce_mean(l.detach()))}
    return loss


def _classifier_loss(model):
    """model -> loss(batch, rng=None) -> (loss, {"accuracy"}): softmax
    cross-entropy over the labels, in train mode (batch norms normalize
    by the batch and advance their running averages in place: the
    reference's ``batch_stats`` merge; they never reach the aux)."""
    def loss(batch, rng=None):
        x = torch.as_tensor(batch["inputs"], device=model.device)
        y = torch.as_tensor(batch["labels"], device=model.device).long()
        logits = model(x, train=True)
        acc = (logits.detach().argmax(-1) == y).float().mean()
        return softmax_xent(logits, y), {"accuracy": acc}
    return loss


def _moe_lm_loss(model):
    """The LM loss plus ``aux_weight`` times the switch load-balance
    loss (the model returns ``(logits, aux)``): (loss, {"perplexity" of
    the LM term, "aux_loss"})."""
    aux_weight = model.cfg.aux_weight

    def loss(batch, rng=None):
        tokens = torch.as_tensor(batch["inputs"], device=model.device)
        logits, aux = model(tokens, train=True)
        lm = softmax_xent(logits[:, :-1], tokens[:, 1:])
        return lm + aux_weight * aux, {
            "perplexity": torch.exp(data_all_reduce_mean(lm.detach())),
            "aux_loss": aux.detach()}
    return loss


def _seq2seq_loss(model):
    """Teacher-forced seq2seq cross-entropy: the decoder reads the
    shift-right of ``labels`` (``inputs`` when the batch has none, the
    synthetic batch's self-target).  ``enc_mask`` hides encoder padding;
    ``target_mask`` drops padded targets from the mean: the global
    batch's, its masked sum and count all-reduced over the data axes of
    a data-parallel mesh."""
    def loss(batch, rng=None):
        dev = model.device
        src = torch.as_tensor(batch["inputs"], device=dev)
        tgt = torch.as_tensor(batch.get("labels", batch["inputs"]),
                              device=dev).long()
        enc_mask = batch.get("enc_mask")
        if enc_mask is not None:
            enc_mask = torch.as_tensor(enc_mask, device=dev)
        logits = model(src, shift_right(tgt, model.cfg.pad_id),
                       enc_mask=enc_mask, train=True)
        mask = batch.get("target_mask")
        if mask is None:
            # A mean over equal shards: global as the ranks' mean.
            l = softmax_xent(logits, tgt)
            global_l = data_all_reduce_mean(l.detach())
        else:
            mask = torch.as_tensor(mask, device=dev).bool()
            per_tok = F.cross_entropy(
                logits.reshape(-1, logits.shape[-1]), tgt.reshape(-1),
                reduction="none").view(tgt.shape)
            l = data_all_reduce(torch.where(mask, per_tok, 0.0).sum()) / \
                data_all_reduce(mask.sum()).clamp_min(1)
            global_l = l.detach()
        return l, {"perplexity": torch.exp(global_l)}
    return loss


def _mlm_loss(model, mask_rate: float = 0.15, mask_id: int = 0):
    """model -> loss(batch, rng) -> (loss, {"masked_tokens"}): the
    reference's MLM objective.  ``bernoulli(rng, 0.15)`` picks the
    masked positions bit for bit as ``jax.random.bernoulli`` (key
    ``PRNGKey(0)`` without an rng), they read ``mask_id``, and the loss
    is the cross-entropy at the masked positions over their count.

    Over a data-parallel mesh (the train step's ambient mesh) the batch
    is this rank's rows of the global batch: the bits are drawn over the
    GLOBAL batch's shape and the rank keeps its rows, so they are the
    reference's bit for bit, and the masked sum and the count
    (``masked_tokens``) are all-reduced over the data axes: every rank's
    loss is the global one."""
    def loss(batch, rng=None):
        tokens = torch.as_tensor(batch["inputs"], device=model.device)
        key = rng if rng is not None else prng.PRNGKey(0)
        index, count = data_shard()
        rows = tokens.shape[0]
        mask = prng.bernoulli(key.to(tokens.device), mask_rate,
                              (rows * count,) + tuple(tokens.shape[1:]))
        mask = mask[index * rows:(index + 1) * rows]
        logits = model(torch.where(mask, mask_id, tokens), train=True)
        per_tok = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                  tokens.reshape(-1).long(),
                                  reduction="none").view(tokens.shape)
        count = data_all_reduce(mask.sum())
        l = data_all_reduce(torch.where(mask, per_tok, 0.0).sum()) / \
            count.clamp_min(1)
        return l, {"masked_tokens": count.detach()}
    return loss


def _transformer_train_flops(batch: int, *, layers: int, hidden: int,
                             seq: int, head_params: int,
                             intermediate: Optional[int] = None,
                             extra_matmul_params: int = 0,
                             causal: bool = False) -> float:
    """Standard analytic train FLOPs (fwd + 2x bwd) for a transformer:
    6 * N_matmul * tokens plus 12 * layers * tokens * seq * hidden of
    attention, halved for causal models (the needed lower triangle)."""
    inter = 4 * hidden if intermediate is None else intermediate
    n_matmul = layers * (4 * hidden * hidden + 2 * hidden * inter) \
        + head_params + extra_matmul_params
    tokens = batch * seq
    dense = 6.0 * n_matmul * tokens
    attn = 12.0 * layers * tokens * seq * hidden
    if causal:
        attn /= 2.0
    return dense + attn


def _attn_only_flops(*, seq: int, causal: bool):
    """The attention term of _transformer_train_flops alone, as
    ``f(batch, cfg)`` of the model actually measured."""
    def flops(b: int, cfg) -> float:
        attn = (12.0 * cfg.num_layers * (b * seq) * seq
                * cfg.hidden_size)
        return attn / 2.0 if causal else attn
    return flops


def _gpt2_train_flops(cfg: GPT2Config, seq: int):
    return lambda b: _transformer_train_flops(
        b, layers=cfg.num_layers, hidden=cfg.hidden_size, seq=seq,
        head_params=cfg.hidden_size * cfg.vocab_size, causal=True)


def _bert_train_flops(cfg: BertConfig, seq: int):
    return lambda b: _transformer_train_flops(
        b, layers=cfg.num_layers, hidden=cfg.hidden_size, seq=seq,
        head_params=cfg.hidden_size * cfg.vocab_size,
        intermediate=cfg.intermediate_size)


def _moe_train_flops(cfg: MoEGPTConfig, seq: int):
    # Top-1 switch routing: each token runs ONE expert MLP + the router.
    return lambda b: _transformer_train_flops(
        b, layers=cfg.num_layers, hidden=cfg.hidden_size, seq=seq,
        head_params=cfg.hidden_size * cfg.vocab_size,
        extra_matmul_params=cfg.num_layers * cfg.hidden_size
        * cfg.num_experts,
        causal=True)


def _t5_train_flops(cfg: T5Config, seq: int):
    """Encoder + decoder + cross-attention closed form: the attention
    term is 12 * L * tokens * S * inner_dim, halved for the causal
    decoder self-attention; cross-attention is full."""
    d, inner, ff = cfg.d_model, cfg.inner_dim, cfg.d_ff
    ff_mats = 3 if cfg.feed_forward == "gated-gelu" else 2
    enc_layer = 4 * d * inner + ff_mats * d * ff
    dec_layer = 8 * d * inner + ff_mats * d * ff
    n_matmul = (cfg.num_layers * enc_layer
                + cfg.num_decoder_layers * dec_layer
                + d * cfg.vocab_size)

    def flops(b: int) -> float:
        tokens = b * seq
        dense = 6.0 * n_matmul * tokens
        attn = 12.0 * tokens * seq * inner * (
            cfg.num_layers                       # encoder, bidirectional
            + cfg.num_decoder_layers / 2.0       # decoder self, causal
            + cfg.num_decoder_layers)            # cross, full
        return dense + attn
    return flops


def _vit_train_flops(cfg: ViTConfig):
    patches = cfg.num_patches + 1  # + [CLS]
    patch_dim = cfg.patch_size * cfg.patch_size * 3
    return lambda b: _transformer_train_flops(
        b, layers=cfg.num_layers, hidden=cfg.hidden_size, seq=patches,
        head_params=cfg.hidden_size * cfg.num_classes,
        intermediate=cfg.intermediate_size,
        extra_matmul_params=patch_dim * cfg.hidden_size)


# ResNet-50 at 224x224: ~4.1 GMACs fwd (8.2 GFLOPs); training ~= 3x fwd
# (the reference's count).
_RESNET50_TRAIN_FLOPS_PER_IMG = 3 * 8.2e9


def _llama_train_flops(cfg: LlamaConfig, seq: int):
    # SwiGLU = 3 MLP matmuls (gate/up/down); GQA shrinks only the k/v
    # projections; attention score/PV FLOPs follow the QUERY head count.
    h, hd = cfg.hidden_size, cfg.head_dim
    per_layer = (2 * h * h                       # q_proj + o_proj
                 + 2 * h * cfg.num_kv_heads * hd  # k_proj + v_proj
                 + 3 * h * cfg.intermediate_size)
    n_matmul = cfg.num_layers * per_layer + h * cfg.vocab_size

    def flops(b: int) -> float:
        tokens = b * seq
        return (6.0 * n_matmul * tokens
                + 12.0 * cfg.num_layers * tokens * seq * h / 2.0)
    return flops


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    make_model: Callable[..., Any]
    make_batch: Callable[[int], Dict[str, np.ndarray]]
    loss_fn: Callable[[Any], Callable]  # model -> loss(batch, rng)
    default_batch_size: int = 32
    # Analytic train-step FLOPs (fwd + bwd) as a function of batch size:
    # the MFU numerator.
    train_flops: Optional[Callable[[int], float]] = None
    # The attention part of train_flops, as f(batch, cfg).
    attn_flops: Optional[Callable[[int, Any], float]] = None
    # Config overrides a data sample's inputs imply (the classifiers'
    # input width or channels: digits are 8x8x1 where the synthetic
    # batch is 28x28x1), as f(inputs).  flax infers them at init.
    input_overrides: Optional[Callable[[Any], Dict[str, Any]]] = None

    def init_params(self, batch_size: int = 2, seed: int = 0,
                    device=None, train: bool = False, **overrides):
        """A randomly initialised model, seeded, on ``device`` (cuda
        unless asked otherwise).  ``train=False``: parameters in the
        config's dtype, eval mode, no gradients (serving).
        ``train=True``: float32 master parameters, each cast to the
        config's dtype at its use, with gradients, in train mode.
        ``batch_size`` is kept for the reference's signature: torch
        modules need no example batch to build."""
        del batch_size
        model = self.make_model(device=default_device(device),
                                param_dtype=torch.float32 if train
                                else None, **overrides)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            _init_weights(model, gen)
        if train:
            return model.train()
        return model.eval().requires_grad_(False)


def _gpt2_spec(name: str, cfg: GPT2Config, seq: int, flops: bool):
    return ModelSpec(
        name=name,
        make_model=_cfg_model(GPT2Model, cfg),
        make_batch=lambda b: _token_batch(b, seq, cfg.vocab_size),
        loss_fn=_lm_loss,
        default_batch_size=8,
        train_flops=_gpt2_train_flops(cfg, seq) if flops else None,
        attn_flops=_attn_only_flops(seq=seq, causal=True) if flops
        else None)


def _llama_spec(name: str, cfg: LlamaConfig, seq: int, batch: int,
                flops: bool):
    return ModelSpec(
        name=name,
        make_model=_cfg_model(LlamaModel, cfg),
        make_batch=lambda b: _token_batch(b, seq, cfg.vocab_size),
        loss_fn=_lm_loss,
        default_batch_size=batch,
        train_flops=_llama_train_flops(cfg, seq) if flops else None,
        attn_flops=_attn_only_flops(seq=seq, causal=True) if flops
        else None)


def _image_spec(name: str, model_cls, cfg, hw: int, classes: int,
                batch: int, channels: int = 3, flops=None,
                overrides=None):
    return ModelSpec(
        name=name,
        make_model=_cfg_model(model_cls, cfg),
        make_batch=lambda b: _image_batch(b, hw, classes, channels),
        loss_fn=_classifier_loss,
        default_batch_size=batch,
        train_flops=flops,
        input_overrides=overrides or (
            lambda x: {"in_channels": int(x.shape[-1])}))


def _bert_spec(name: str, cfg: BertConfig, seq: int, batch: int,
               flops: bool):
    return ModelSpec(
        name=name,
        make_model=_cfg_model(BertModel, cfg),
        make_batch=lambda b: _token_batch(b, seq, cfg.vocab_size),
        loss_fn=_mlm_loss,
        default_batch_size=batch,
        train_flops=_bert_train_flops(cfg, seq) if flops else None,
        attn_flops=_attn_only_flops(seq=seq, causal=False) if flops
        else None)


def _token_spec(name: str, model_cls, cfg, seq: int, batch: int, loss,
                flops=None):
    return ModelSpec(
        name=name,
        make_model=_cfg_model(model_cls, cfg),
        make_batch=lambda b: _token_batch(b, seq, cfg.vocab_size),
        loss_fn=loss,
        default_batch_size=batch,
        train_flops=flops)


_REGISTRY: Dict[str, ModelSpec] = {
    spec.name: spec for spec in (
        _image_spec("mlp", MLP, MLPConfig(), 28, 10, 64, channels=1,
                    overrides=lambda x: {
                        "in_features": int(np.prod(x.shape[1:]))}),
        _image_spec("convnet", ConvNet, ConvNetConfig(), 32, 10, 128),
        _image_spec("resnet50", ResNet, ResNetConfig(), 224, 1000, 128,
                    flops=lambda b: b * _RESNET50_TRAIN_FLOPS_PER_IMG),
        # CI-sized stand-in, same code path.
        _image_spec("resnet50-tiny", ResNet, ResNetConfig(
            stage_sizes=(1, 1, 1, 1), width=8, num_classes=10), 32, 10, 8),
        _bert_spec("bert-base", BertConfig.base(), 512, 32, True),
        _bert_spec("bert-tiny", BertConfig.tiny(), 64, 8, False),
        _gpt2_spec("gpt2-medium", GPT2Config.medium(), 1024, True),
        _gpt2_spec("gpt2-small", GPT2Config.small(), 1024, True),
        _gpt2_spec("gpt2-mini", GPT2Config.mini(), 256, False),
        _gpt2_spec("gpt2-tiny", GPT2Config.tiny(), 64, False),
        _llama_spec("tinyllama-1.1b", LlamaConfig.tinyllama(), 2048, 4,
                    True),
        # Llama + sliding-window local attention + GQA.
        _llama_spec("mistral-tiny", LlamaConfig(
            vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, max_position=256,
            sliding_window=31), 128, 8, False),
        _llama_spec("llama-tiny", LlamaConfig.tiny(), 64, 8, False),
        _token_spec("t5-small", T5Model, T5Config.small(), 512, 16,
                    _seq2seq_loss, _t5_train_flops(T5Config.small(), 512)),
        _token_spec("t5-tiny", T5Model, T5Config.tiny(), 64, 8,
                    _seq2seq_loss),
        _image_spec("vit-base", ViTModel, ViTConfig.base(), 224, 1000, 64,
                    flops=_vit_train_flops(ViTConfig.base()),
                    overrides=lambda x: {}),
        _image_spec("vit-tiny", ViTModel, ViTConfig.tiny(), 32, 10, 8,
                    overrides=lambda x: {}),
        _token_spec("moe-gpt-small", MoEGPTModel, MoEGPTConfig.small(),
                    1024, 8, _moe_lm_loss,
                    _moe_train_flops(MoEGPTConfig.small(), 1024)),
        _token_spec("moe-gpt-tiny", MoEGPTModel, MoEGPTConfig.tiny(), 64,
                    8, _moe_lm_loss))
}


def get_model(name: str) -> ModelSpec:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_models():
    return sorted(_REGISTRY)
