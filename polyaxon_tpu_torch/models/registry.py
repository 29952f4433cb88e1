"""Model registry: name -> constructor.

Port of ``polyaxon_tpu/models/registry.py``'s GPT-2 entries.  The rest
of the zoo, the loss functions and the analytic FLOP models come with
later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from .. import default_device
from .gpt2 import GPT2Config, GPT2Model


def _cfg_model(model_cls, base_cfg):
    """make_model for config-bearing models: keyword overrides patch
    CONFIG FIELDS (``dataclasses.replace``); ``device`` goes to the
    constructor."""
    def make(device=None, **kw):
        cfg = dataclasses.replace(base_cfg, **kw) if kw else base_cfg
        return model_cls(cfg, device=device)
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


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    make_model: Callable[..., Any]

    def init_params(self, batch_size: int = 2, seed: int = 0,
                    device=None, **overrides):
        """A randomly initialised model, seeded, on ``device`` (cuda
        unless asked otherwise), in eval mode and without gradients
        (this slice serves; training comes later).  ``batch_size`` is
        kept for the reference's signature: torch modules need no
        example batch to build."""
        del batch_size
        model = self.make_model(device=default_device(device), **overrides)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            _init_gpt2(model, gen)
        return model.eval().requires_grad_(False)


_REGISTRY: Dict[str, ModelSpec] = {
    name: ModelSpec(name, _cfg_model(GPT2Model, cfg))
    for name, cfg in (("gpt2-medium", GPT2Config.medium()),
                      ("gpt2-small", GPT2Config.small()),
                      ("gpt2-mini", GPT2Config.mini()),
                      ("gpt2-tiny", GPT2Config.tiny()))
}


def get_model(name: str) -> ModelSpec:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]
