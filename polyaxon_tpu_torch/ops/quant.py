"""Weight-only int8 quantization for the serving path.

Port of ``polyaxon_tpu/ops/quant.py``.  A weight is stored as int8 plus
a bf16 scale per channel; the decode step reads the int8 bytes and
dequantizes at the point of use.  The reference keeps that pair as a
pytree leaf the decode step dequantizes inside its jitted body; here the
pair sits on the module itself through ``torch.nn.utils.parametrize``:
the int8 tensor replaces the parameter as a buffer
(``parametrizations.<name>.original``), the scale is a buffer of the
:class:`Dequantize` parametrization, and every read of ``module.weight``
(or ``.bias``) computes ``q.to(bf16) * scale`` there and then — inside
the step, and inside its CUDA graph on the card.  No module changes and
no resident bf16 copy: the dense layers, the embeddings (the lookup and
GPT-2's tied head read the same ``wte``) and the norms all read their
weights through the attribute, as before.

Eligibility and scale axes follow the reference's SCANNED param layout
(``scan_layers=True``, the default of both configs), where one leaf
stacks a parameter of every layer, ``[num_layers] + shape``:

- a leaf quantizes iff its stacked rank is >= 2 and it holds at least
  ``min_size`` elements, so at full width the stacked biases and norm
  scales quantize too (GPT-2 medium's ``ln1/scale`` is [24, 1024]) with
  ONE scale per channel shared by every layer;
- the max-abs reduces over every flax axis but the last (the output
  channel of ``x @ kernel``), and for rank >= 3 also keeps the first
  (per-layer scales for stacked kernels ``[L, in, out]``);
- the port's ``nn.Linear`` weights are ``[out, in]``, so a kernel's
  scale is ``[out, 1]`` per layer; embeddings ``[rows, hidden]`` get
  ``[1, hidden]``; Llama's ``lm_head`` (flax ``[hidden, vocab]``) one
  scale per vocabulary entry.

:func:`quant_plan` computes that leaf list from shapes alone (a model
on the ``meta`` device will do); :func:`quantize_params` applies it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn.utils import parametrize

__all__ = ["Dequantize", "QuantLeaf", "symmetric_int8", "quant_plan",
           "quantize_params", "dequantize_params", "has_quantized",
           "quantized_bytes"]


def symmetric_int8(x: torch.Tensor, dims: Sequence[int],
                   scale_dtype=torch.bfloat16):
    """The shared symmetric-int8 core (weights here, the int8 KV cache
    in ``models/kv_cache.py``), in the reference's exact order: the
    max-abs over ``dims`` (kept) in float32, ``scale = amax / 127`` (1
    where the max is 0), ``q = clip(round(x / scale), -127, 127)`` with
    the float32 scale, and only then the stored scale cast to
    ``scale_dtype``.  ``torch.round`` is half-to-even, like
    ``jnp.round``."""
    x32 = x.float()
    amax = x32.abs().amax(dim=tuple(dims), keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale.to(scale_dtype)


def _scale_axes(ndim: int) -> Tuple[int, ...]:
    """The reference's reduction axes in the FLAX layout: all but the
    last, and for rank >= 3 all but the first and the last."""
    if ndim >= 3:
        return tuple(range(1, ndim - 1))
    return tuple(range(ndim - 1))


class Dequantize(nn.Module):
    """The parametrization of a quantized weight: ``original`` is the
    int8 tensor, ``scale`` (a buffer, broadcastable to it) the bf16
    per-channel scale.  The product is taken in the scale's type (bf16,
    ``QuantizedTensor.dequantize`` with ``dtype=None``) and then cast to
    the type the parameter had, which the module casts on as before."""

    def __init__(self, scale: torch.Tensor, dtype: torch.dtype):
        super().__init__()
        self.register_buffer("scale", scale)
        self.dtype = dtype

    def forward(self, q):
        return (q.to(self.scale.dtype) * self.scale).to(self.dtype)


@dataclasses.dataclass
class QuantLeaf:
    """One leaf of the reference's param tree: its keystr ``path``, its
    shape there (``shape``, stacked over layers when ``stacked``), and
    the port's tensors holding it, ``members`` = (module, attribute,
    transposed) per layer (one entry when not stacked).  ``scale_shape``
    is the reference's scale for an eligible leaf, else None."""
    path: str
    shape: Tuple[int, ...]
    stacked: bool
    members: List[Tuple[nn.Module, str, bool]]
    scale_shape: Optional[Tuple[int, ...]] = None


def _flax_leaf(module: nn.Module, attr: str) -> Tuple[str, bool]:
    """(flax leaf name, transposed) of ``module.<attr>``."""
    if isinstance(module, nn.Embedding):
        return "embedding", False
    if isinstance(module, nn.Linear):
        return ("kernel", True) if attr == "weight" else ("bias", False)
    # LayerNorm and RMSNorm: weight -> scale.
    return ("scale", False) if attr == "weight" else ("bias", False)


def _raw(module: nn.Module, attr: str) -> torch.Tensor:
    """The stored tensor of ``module.<attr>``: the int8 original of a
    quantized one (reading the attribute itself would dequantize)."""
    if parametrize.is_parametrized(module, attr):
        return getattr(module.parametrizations, attr).original
    return getattr(module, attr)


def _leaf_tensors(model: nn.Module):
    """(module path, module, attribute) of every weight and bias, in
    module order, quantized ones included."""
    for mname, mod in model.named_modules():
        for attr in ("weight", "bias"):
            if attr in mod._parameters and mod._parameters[attr] is not None:
                yield mname, mod, attr
            elif parametrize.is_parametrized(mod, attr):
                yield mname, mod, attr


def quant_plan(model: nn.Module, *, min_size: int = 4096,
               predicate: Optional[Callable] = None) -> List[QuantLeaf]:
    """The reference's leaf list for ``model`` (GPT-2 or the Llama
    family), with the scale shape of every leaf ``quantize_params``
    would quantize.  Shapes only: a model on ``meta`` will do.

    The layer stack ``h.{i}`` maps to the scanned ``h/block`` leaves
    (``cfg.scan_layers``, the default) or to ``h_{i}``.
    ``predicate(path, shape) -> bool`` further restricts (``path`` is the
    reference's keystr, ``shape`` the leaf's stacked flax shape)."""
    scanned = getattr(getattr(model, "cfg", None), "scan_layers", True)
    groups: Dict[str, QuantLeaf] = {}
    for mname, mod, attr in _leaf_tensors(model):
        parts = mname.split(".")
        leaf, transposed = _flax_leaf(mod, attr)
        shape = tuple(_raw(mod, attr).shape)
        if transposed:
            shape = shape[::-1]
        stacked = False
        if parts[0] == "h" and len(parts) > 1:
            keys = (["h", "block"] if scanned else [f"h_{parts[1]}"]) \
                + parts[2:]
            stacked = scanned
        else:
            keys = parts
        path = "".join(f"[{k!r}]" for k in keys + [leaf])
        g = groups.get(path)
        if g is None:
            g = groups[path] = QuantLeaf(path, shape, stacked, [])
        g.members.append((mod, attr, transposed))
    plan = list(groups.values())
    for g in plan:
        if g.stacked:
            g.shape = (len(g.members),) + g.shape
        t = _raw(*g.members[0][:2])
        if len(g.shape) < 2 or math.prod(g.shape) < min_size:
            continue
        if not (t.dtype.is_floating_point or t.dtype == torch.int8):
            continue
        if predicate is not None and not predicate(g.path, g.shape):
            continue
        axes = _scale_axes(len(g.shape))
        g.scale_shape = tuple(1 if i in axes else n
                              for i, n in enumerate(g.shape))
    return plan


def _to_torch(x: torch.Tensor, transposed: bool) -> torch.Tensor:
    return x.t().contiguous() if transposed and x.ndim == 2 else x


def quantize_params(model: nn.Module, *, min_size: int = 4096,
                    dtype=torch.bfloat16,
                    predicate: Optional[Callable] = None) -> nn.Module:
    """Quantize ``model``'s eligible weights in place (see
    :func:`quant_plan`) and return it.  Each leaf is quantized in the
    flax layout (layers stacked, kernels ``[in, out]``) so ``q`` and the
    scales are bitwise the reference's, then split back onto the port's
    per-layer tensors: a stacked kernel's member gets its own
    ``[out, 1]`` rows, a stacked bias or norm scale the ONE ``[C]`` scale
    shared by every layer (the same tensor).  Idempotent: an already
    quantized leaf stays as it is.  ``dtype`` is the scales' type."""
    for g in quant_plan(model, min_size=min_size, predicate=predicate):
        if g.scale_shape is None:
            continue
        if any(parametrize.is_parametrized(m, a) for m, a, _ in g.members):
            continue
        with torch.no_grad():
            parts = [_to_torch(getattr(m, a).detach(), t)
                     for m, a, t in g.members]
            x = torch.stack(parts) if g.stacked else parts[0]
            q, scale = symmetric_int8(x, _scale_axes(x.ndim),
                                      scale_dtype=dtype)
        del parts, x
        # A scale reduced over the layer axis is ONE tensor, every
        # layer's buffer (quantized_bytes counts it once).
        shared = scale[0] if g.stacked else scale
        for i, (mod, attr, transposed) in enumerate(g.members):
            qi = q[i] if g.stacked else q
            si = scale[i] if g.stacked and scale.shape[0] > 1 else shared
            attach_quantized(mod, attr, _to_torch(qi, transposed),
                             _to_torch(si, transposed))
    return model


def attach_quantized(module: nn.Module, attr: str, q: torch.Tensor,
                     scale: torch.Tensor) -> None:
    """Replace ``module.<attr>`` by the int8 codes ``q`` (a buffer, on
    the parameter's device) read through a :class:`Dequantize` of
    ``scale``, in the torch layout of the parameter; the weight read
    keeps the parameter's type."""
    orig = getattr(module, attr)
    dev = orig.device
    delattr(module, attr)
    module.register_buffer(attr, q.to(dev))
    parametrize.register_parametrization(
        module, attr, Dequantize(scale.to(dev), orig.dtype), unsafe=True)


def dequantize_params(model: nn.Module) -> nn.Module:
    """Undo :func:`quantize_params` in place: every quantized weight
    becomes a plain (dequantized) tensor again.  A model with no
    quantized leaves is returned untouched."""
    for mod in list(model.modules()):
        for attr in ("weight", "bias"):
            if _dequantizer(mod, attr) is None:
                continue
            w = getattr(mod, attr).detach()
            parametrize.remove_parametrizations(
                mod, attr, leave_parametrized=False)
            delattr(mod, attr)
            mod.register_parameter(attr, nn.Parameter(
                w, requires_grad=False))
    return model


def _dequantizer(mod: nn.Module, attr: str) -> Optional[Dequantize]:
    if not parametrize.is_parametrized(mod, attr):
        return None
    for p in getattr(mod.parametrizations, attr):
        if isinstance(p, Dequantize):
            return p
    return None


def has_quantized(model: nn.Module) -> bool:
    return any(_dequantizer(m, a) is not None
               for _, m, a in _leaf_tensors(model))


def quantized_bytes(model: nn.Module) -> Tuple[int, int]:
    """``(bytes_as_stored, bytes_if_bf16)`` over every weight and bias:
    a quantized leaf counts its int8 bytes and its scale's (a scale
    shared by the layers of a stacked leaf once, as the reference
    stores it); ``bytes_if_bf16`` counts every element at 2 bytes."""
    stored = full = 0
    seen = set()
    for _, mod, attr in _leaf_tensors(model):
        dq = _dequantizer(mod, attr)
        t = _raw(mod, attr)
        stored += t.numel() * t.element_size()
        full += t.numel() * 2
        if dq is not None and id(dq.scale) not in seen:
            seen.add(id(dq.scale))
            stored += dq.scale.numel() * dq.scale.element_size()
    return stored, full
