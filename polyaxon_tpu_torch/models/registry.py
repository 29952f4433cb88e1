"""Model registry: name -> (constructor, loss, synthetic batch).

Port of ``polyaxon_tpu/models/registry.py``'s GPT-2 entries: the same
constructors, synthetic batches (numpy ``RandomState(0)``, so both
packages draw the same tokens), LM loss and analytic FLOP models.  The
rest of the zoo comes with a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import default_device
from .gpt2 import GPT2Config, GPT2Model


def softmax_xent(logits, labels):
    """Mean softmax cross-entropy over integer labels, in f32."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(),
                           labels.reshape(-1).long())


def _cfg_model(model_cls, base_cfg):
    """make_model for config-bearing models: keyword overrides patch
    CONFIG FIELDS (``dataclasses.replace``); ``device`` and
    ``param_dtype`` go to the constructor."""
    def make(device=None, param_dtype=None, **kw):
        cfg = dataclasses.replace(base_cfg, **kw) if kw else base_cfg
        return model_cls(cfg, device=device, param_dtype=param_dtype)
    return make


def _init_gpt2(model: GPT2Model, generator: torch.Generator) -> None:
    """Random init from a seeded CPU generator, so the weights are the
    same on every device.  Scales follow flax's defaults: Dense kernels
    lecun-normal (std 1/sqrt(fan_in)), embeddings std 1/sqrt(hidden),
    zero biases, unit LayerNorm scales.  The numbers differ from flax's;
    tests that compare with the reference convert its params instead."""
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            std = 0.0
        elif ".ln" in name or name.startswith("ln_f"):
            std = None
        else:
            std = p.shape[-1] ** -0.5
        if std is None:
            w = torch.ones(p.shape)
        elif std == 0.0:
            w = torch.zeros(p.shape)
        else:
            w = torch.randn(p.shape, generator=generator) * std
        p.data.copy_(w.to(p.dtype))


def _token_batch(batch_size: int, seq: int,
                 vocab: int) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(0)
    return {"inputs": rng.randint(0, vocab, size=(batch_size, seq))}


def _lm_loss(model):
    """model -> loss(batch, rng=None) -> (loss, {"perplexity"}):
    next-token cross-entropy, the logits shifted by one.  The model holds
    the parameters; ``rng`` is unused (GPT-2 has no dropout)."""
    def loss(batch, rng=None):
        tokens = torch.as_tensor(batch["inputs"], device=model.device)
        logits = model(tokens, train=True)
        l = softmax_xent(logits[:, :-1], tokens[:, 1:])
        return l, {"perplexity": torch.exp(l.detach())}
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
            _init_gpt2(model, gen)
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


_REGISTRY: Dict[str, ModelSpec] = {
    spec.name: spec for spec in (
        _gpt2_spec("gpt2-medium", GPT2Config.medium(), 1024, True),
        _gpt2_spec("gpt2-small", GPT2Config.small(), 1024, True),
        _gpt2_spec("gpt2-mini", GPT2Config.mini(), 256, False),
        _gpt2_spec("gpt2-tiny", GPT2Config.tiny(), 64, False))
}


def get_model(name: str) -> ModelSpec:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
