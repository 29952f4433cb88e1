"""Pieces the zoo shares: the dense layer holding its parameters in one
type and computing in another (an int8 weight and bias dequantize at
this read, ``ops/quant.py``), its column- and row-parallel counterparts
and the vocab-parallel table of a training mesh's tensor axis (each
holding its rank's shard as a plain parameter and calling the region
operators of ``parallel/collectives.py`` itself), flax's convolution
and batch norm over channels-last NCHW tensors, the layer stack (remat
in training, the cache in decode), and the named remat policies.

Remat policies: ``remat_policy`` names a ``jax.checkpoint_policies``
member the repo uses.  Each block runs under ``torch.utils.checkpoint``
with a selective-checkpoint policy that keeps the outputs the jax
policy saves and recomputes the rest in the backward:

- ``None`` / ``nothing_saveable``: save nothing (whole-block remat);
- ``dots_saveable``: every matmul's output (``mm``, ``addmm``, and the
  batched ``bmm`` / ``baddbmm`` of the plain attention);
- ``dots_with_no_batch_dims_saveable``: the matmuls with no batch dims,
  the dense layers' ``mm`` / ``addmm``; attention's batched products are
  recomputed;
- ``everything_saveable``: every output, which is no remat at all.

The flash kernel is not a matmul to either policy (an opaque custom call
to XLA, a ctypes launch here): it runs again in the backward.  Any other
name is refused.
"""

from __future__ import annotations

import contextlib
import functools
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .kv_cache import KVCache


class Dense(nn.Linear):
    """``nn.Linear`` holding its parameters in ``param_dtype`` and
    computing in ``dtype`` (flax ``Dense(dtype=...)``, ``use_bias``
    as ``bias``).  Quantized by ``ops.quant.quantize_params``, its
    ``weight`` and ``bias`` are int8 buffers read through their
    dequantizing parametrization."""

    def __init__(self, n_in: int, n_out: int, dtype, param_dtype, device,
                 bias: bool = True):
        super().__init__(n_in, n_out, bias=bias, dtype=param_dtype,
                         device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt),
                        None if self.bias is None else self.bias.to(dt))


class ColumnParallelDense(nn.Module):
    """A :class:`Dense` split over a training mesh's tensor axis by its
    OUTPUT columns (the reference's ``P(None, "tp")`` kernel): this
    rank holds rows ``rows`` of the ``[out, in]`` weight and of the
    bias as plain parameters.  Its input enters the tensor region
    (``copy_to_region``: the cotangent is summed over the axis); its
    output stays split, or, with ``gather_output``, is gathered back
    (``gather_from_region``).  ``all_rows`` holds every rank's rows (a
    checkpoint puts the shards back in place)."""

    def __init__(self, dense: "Dense", all_rows: Sequence[torch.Tensor],
                 mesh, axis: str, gather_output: bool = False):
        super().__init__()
        rank = mesh.coordinate(axis)
        rows = all_rows[rank].to(dense.weight.device)
        self.compute_dtype = dense.compute_dtype
        self.in_features = dense.in_features
        self.out_features = len(rows)
        self.weight = nn.Parameter(dense.weight.detach()[rows].clone())
        self.bias = None if dense.bias is None else \
            nn.Parameter(dense.bias.detach()[rows].clone())
        self.all_rows = [r.cpu() for r in all_rows]
        self.tensor_mesh, self.axis = mesh, axis
        self.gather_output = gather_output
        self.sharded_params = {"weight": (axis, 0)}
        if self.bias is not None:
            self.sharded_params["bias"] = (axis, 0)

    def forward(self, x):
        from ..parallel.collectives import (copy_to_region,
                                            gather_from_region)

        dt = self.compute_dtype
        x = copy_to_region(x, self.axis, mesh=self.tensor_mesh)
        y = F.linear(x.to(dt), self.weight.to(dt),
                     None if self.bias is None else self.bias.to(dt))
        if self.gather_output:
            y = gather_from_region(y, self.axis, dim=-1, mesh=self.tensor_mesh)
        return y

    def split(self, x, dim: int):
        """This rank's block of a replicated ``x`` along ``dim`` (a
        per-head tensor beside the split heads), differentiably."""
        from ..parallel.collectives import split_to_region

        return split_to_region(x, self.axis, dim=dim, mesh=self.tensor_mesh)


class RowParallelDense(nn.Module):
    """A :class:`Dense` split over a training mesh's tensor axis by its
    INPUT dim (the reference's ``P("tp", None)`` kernel): this rank
    holds its contiguous block of the weight's columns; the bias stays
    whole.  The partial products are summed over the axis
    (``reduce_from_region``) and the bias is added after the sum, once.
    ``split_input``: the input arrives whole and this rank takes its
    block (a model whose column outputs are gathered)."""

    def __init__(self, dense: "Dense", mesh, axis: str,
                 split_input: bool = False):
        super().__init__()
        n, rank = mesh.shape[axis], mesh.coordinate(axis)
        cols = dense.in_features // n
        self.compute_dtype = dense.compute_dtype
        self.in_features, self.out_features = cols, dense.out_features
        self.weight = nn.Parameter(
            dense.weight.detach()[:, rank * cols:(rank + 1) * cols].clone())
        self.bias = None if dense.bias is None else \
            nn.Parameter(dense.bias.detach().clone())
        self.tensor_mesh, self.axis = mesh, axis
        self.split_input = split_input
        self.sharded_params = {"weight": (axis, 1)}

    def forward(self, x):
        from ..parallel.collectives import reduce_from_region, \
            split_to_region

        dt = self.compute_dtype
        if self.split_input:
            x = split_to_region(x, self.axis, dim=-1, mesh=self.tensor_mesh)
        y = reduce_from_region(F.linear(x.to(dt), self.weight.to(dt)),
                               self.axis, mesh=self.tensor_mesh)
        return y if self.bias is None else y + self.bias.to(dt)


class VocabParallelEmbedding(nn.Module):
    """An embedding table split over a training mesh's tensor axis by
    rows (the reference's vocab dim over ``("tp", "fsdp")``): this rank
    holds rows ``[start, start + rows)``.  A lookup reads the ids this
    rank holds, zeros the others and sums over the axis (one non-zero
    term per id: exact); a tied head projects onto this rank's rows and
    gathers the logits."""

    def __init__(self, emb: nn.Embedding, mesh, axis: str):
        super().__init__()
        n, rank = mesh.shape[axis], mesh.coordinate(axis)
        rows = emb.num_embeddings // n
        self.start = rank * rows
        self.num_embeddings, self.embedding_dim = rows, emb.embedding_dim
        self.weight = nn.Parameter(
            emb.weight.detach()[self.start:self.start + rows].clone())
        self.tensor_mesh, self.axis = mesh, axis
        self.sharded_params = {"weight": (axis, 0)}

    def lookup(self, ids, dtype):
        from ..parallel.collectives import reduce_from_region

        local = ids - self.start
        held = (local >= 0) & (local < self.num_embeddings)
        out = F.embedding(local.clamp(0, self.num_embeddings - 1),
                          self.weight.to(dtype))
        out = torch.where(held[..., None], out, torch.zeros_like(out))
        return reduce_from_region(out, self.axis, mesh=self.tensor_mesh)

    def logits(self, x, dtype):
        from ..parallel.collectives import copy_to_region, \
            gather_from_region

        x = copy_to_region(x, self.axis, mesh=self.tensor_mesh)
        return gather_from_region(F.linear(x, self.weight.to(dtype)),
                                  self.axis, dim=-1, mesh=self.tensor_mesh)


def embed(table: nn.Module, ids, dtype) -> torch.Tensor:
    """``table``'s rows for ``ids`` in ``dtype`` (a split table's
    lookup over its axis)."""
    if isinstance(table, VocabParallelEmbedding):
        return table.lookup(ids, dtype)
    return F.embedding(ids, table.weight.to(dtype))


def tied_logits(x, table: nn.Module, dtype) -> torch.Tensor:
    """``x`` projected onto ``table``'s rows in ``dtype`` (a tied head;
    a split table's logits gathered over its axis)."""
    if isinstance(table, VocabParallelEmbedding):
        return table.logits(x, dtype)
    return F.linear(x, table.weight.to(dtype))


class _RowShard:
    """Rows ``idx`` of one of a Dense's tensors (``weight`` [out, in] or
    ``bias`` [out]) on ``device``.  A quantized tensor keeps its int8
    codes and its per-channel scale's rows, and dequantizes at each
    read as the whole tensor does (``ops/quant.Dequantize``): the
    scales are per output channel, so the rows read bitwise what the
    whole tensor's read holds there."""

    def __init__(self, module: nn.Module, attr: str, idx: torch.Tensor,
                 device):
        from ..ops.quant import Dequantize, _dequantizer

        deq = _dequantizer(module, attr)
        if deq is None:
            t = getattr(module, attr).detach()
            self.value = t[idx.to(t.device)].to(device)
            self.deq = None
            return
        q = getattr(module.parametrizations, attr).original
        scale = deq.scale
        if scale.shape[0] == q.shape[0]:
            scale = scale[idx.to(scale.device)]
        self.value = q[idx.to(q.device)].to(device)
        self.deq = Dequantize(scale.to(device), deq.dtype)

    def read(self) -> torch.Tensor:
        return self.value if self.deq is None else self.deq(self.value)


class ColumnShards:
    """A :class:`Dense`'s OUTPUT columns split over devices, the serving
    mesh's column-parallel placement (``serving/meshed.py``): shard
    ``r`` holds rows ``rows[r]`` of the ``[out, in]`` weight and of the
    bias, over the FULL contraction dim, on ``devices[r]``.
    ``shard(r, x)`` is the layer's own product restricted to those
    columns (the same ``F.linear`` in the same compute dtype), so each
    output element keeps the whole product's accumulation order — the
    exact layout's premise, which the card's column-split probe
    measures (``chip_smoke.py``)."""

    axis = "tp"

    def __init__(self, dense: "Dense", rows: Sequence[torch.Tensor],
                 devices: Sequence[torch.device]):
        self.compute_dtype = dense.compute_dtype
        self.devices = list(devices)
        self.weights = [_RowShard(dense, "weight", idx, d)
                        for idx, d in zip(rows, self.devices)]
        self.biases = [None if dense.bias is None
                       else _RowShard(dense, "bias", idx, d)
                       for idx, d in zip(rows, self.devices)]

    def held(self) -> List[List[torch.Tensor]]:
        """The tensors each shard holds on its device."""
        return [[t for p in (w, b) if p is not None
                 for t in (p.value, *([] if p.deq is None
                                      else [p.deq.scale]))]
                for w, b in zip(self.weights, self.biases)]

    def shard(self, r: int, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = self.biases[r]
        return F.linear(x.to(self.devices[r]).to(dt),
                        self.weights[r].read().to(dt),
                        None if b is None else b.read().to(dt))


def contiguous_rows(n: int, parts: int) -> List[torch.Tensor]:
    """``parts`` contiguous, equal blocks of ``range(n)``."""
    m = n // parts
    return [torch.arange(r * m, (r + 1) * m) for r in range(parts)]


def f32_param(shape, device, std: float) -> nn.Parameter:
    """A float32 parameter whatever the model's ``param_dtype`` (the
    reference declares it float32), drawn by the registry's
    ``_init_weights`` with standard deviation ``std`` (0: zeros), the
    reference's explicit initializer."""
    p = nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))
    p.init_std = std
    return p


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA "SAME" padding of one spatial dim: the total that makes
    ``ceil(size / s)`` outputs, low = total // 2, high = the rest (so a
    stride-2 window on an even size pads (0, 1), not torch's (1, 1))."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def pad_hw(x, pads: Sequence[Tuple[int, int]], value: float = 0.0):
    """Pad an NCHW tensor's H and W by ``((hl, hh), (wl, wh))``, done on
    its NHWC view so a channels-last tensor stays channels-last."""
    (hl, hh), (wl, wh) = pads
    return F.pad(x.permute(0, 2, 3, 1), (0, 0, wl, wh, hl, hh),
                 value=value).permute(0, 3, 1, 2)


class Conv(nn.Module):
    """flax ``nn.Conv`` over NCHW tensors (channels-last in memory):
    an OIHW kernel held in ``param_dtype`` (flax's HWIO, transposed),
    input, kernel and bias cast to ``dtype``.  ``padding``: "SAME" as
    flax pads it (asymmetric pads through :func:`pad_hw`), or explicit
    ``((hl, hh), (wl, wh))``."""

    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int = 1,
                 *, dtype, param_dtype, device, bias: bool = True,
                 padding="SAME"):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            c_out, c_in, kernel, kernel, dtype=param_dtype, device=device))
        self.bias = nn.Parameter(torch.empty(
            c_out, dtype=param_dtype, device=device)) if bias else None

    def forward(self, x):
        dt = self.compute_dtype
        pads = self.padding if self.padding != "SAME" else tuple(
            _same_pads(n, self.kernel, self.stride) for n in x.shape[-2:])
        x = x.to(dt)
        if all(lo == hi for lo, hi in pads):
            padding = tuple(lo for lo, _ in pads)
        else:
            x, padding = pad_hw(x, pads), 0
        w = self.weight.to(dt, memory_format=torch.channels_last)
        return F.conv2d(x, w, None if self.bias is None
                        else self.bias.to(dt), self.stride, padding)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=eps, dtype=dtype)``
    over the channel axis of an NCHW tensor.  Train mode normalizes by
    the batch statistics, in float32 with flax's fast variance
    (``mean(x^2) - mean^2``, biased), and advances the running averages
    with them: ``ra = 0.9 ra + 0.1 batch`` (torch's ``momentum=0.1``,
    but the BIASED variance, where ``F.batch_norm`` would keep the
    unbiased one).  Eval mode normalizes by the running averages.  The
    scale and bias are float32 (``scale_init`` zeros when
    ``zero_scale``); the output is ``dtype``."""

    def __init__(self, channels: int, *, device, dtype=torch.float32,
                 momentum: float = 0.9, eps: float = 1e-5,
                 zero_scale: bool = False):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.zero_scale = zero_scale
        f32 = dict(dtype=torch.float32, device=device)
        self.weight = nn.Parameter(torch.ones(channels, **f32))
        self.bias = nn.Parameter(torch.zeros(channels, **f32))
        self.register_buffer("running_mean", torch.zeros(channels, **f32))
        self.register_buffer("running_var", torch.ones(channels, **f32))

    def forward(self, x, train: bool):
        x = x.float()
        if train:
            mean, var = self._batch_moments(x)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean, alpha=1 - m)
                self.running_var.mul_(m).add_(var, alpha=1 - m)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(self.dtype)

    @staticmethod
    def _batch_moments(x):
        """The batch's channel mean and biased variance.  Over a data
        parallel mesh (the ambient mesh of the train step) they are the
        GLOBAL batch's, as the reference's mean over a batch-sharded
        axis is: each rank's sum and sum of squares are all-reduced over
        the data axes (differentiably) before ``mean(x^2) - mean^2``, so
        the running averages agree on every rank."""
        from ..parallel.collectives import data_all_reduce, data_shard

        count = data_shard()[1]
        if count == 1:
            mean = x.mean((0, 2, 3))
            return mean, torch.clamp_min(x.square().mean((0, 2, 3))
                                         - mean.square(), 0.0)
        n = x.numel() // x.shape[1] * count
        sums = data_all_reduce(torch.stack(
            [x.sum((0, 2, 3)), x.square().sum((0, 2, 3))])) / n
        return sums[0], torch.clamp_min(sums[1] - sums[0].square(), 0.0)


def batch_stats(model: nn.Module) -> list:
    """The batch norms' running averages: the model state a training
    forward advances (flax's ``batch_stats`` collection)."""
    return [b for m in model.modules() if isinstance(m, BatchNorm)
            for b in (m.running_mean, m.running_var)]


REMAT_POLICIES = ("nothing_saveable", "everything_saveable",
                  "dots_saveable", "dots_with_no_batch_dims_saveable")


def check_remat_policy(cfg) -> None:
    """Refuse a ``remat_policy`` name that is not one of
    :data:`REMAT_POLICIES`, naming it."""
    name = getattr(cfg, "remat_policy", None)
    if name is not None and name not in REMAT_POLICIES:
        raise ValueError(
            f"remat_policy={name!r}: Named remat policies the port "
            f"implements are {list(REMAT_POLICIES)}")


@functools.lru_cache(maxsize=None)
def _saved_ops(name: str) -> frozenset:
    aten = torch.ops.aten
    dense = {aten.mm.default, aten.addmm.default}
    if name == "dots_with_no_batch_dims_saveable":
        return frozenset(dense)
    return frozenset(dense | {aten.bmm.default, aten.baddbmm.default})


def _policy_context(name: str):
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    saved = _saved_ops(name)

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved \
            else CheckpointPolicy.PREFER_RECOMPUTE

    return create_selective_checkpoint_contexts(policy)


@contextlib.contextmanager
def _entered(*contexts):
    with contextlib.ExitStack() as stack:
        for ctx in contexts:
            stack.enter_context(ctx)
        yield


def _remat_context(policy: Optional[str]):
    """checkpoint's (forward, recompute) contexts: the named policy's,
    and for the recompute the forward's sequence-parallel route (the
    recompute may run on another thread, the autograd engine's)."""
    from ..ops.attention import (current_sequence_parallel,
                                 restored_sequence_parallel)

    fwd, rec = (contextlib.nullcontext(), contextlib.nullcontext()) \
        if policy in (None, "nothing_saveable") else _policy_context(policy)
    return fwd, _entered(rec, restored_sequence_parallel(
        current_sequence_parallel()))


def remat_call(block: nn.Module, policy: Optional[str], *args):
    """``block(*args)`` recomputed in the backward as ``policy`` (a
    :data:`REMAT_POLICIES` name or None) says, under the attention route
    its forward took."""
    if policy == "everything_saveable":
        return block(*args)
    return checkpoint(block, *args, use_reentrant=False,
                      context_fn=functools.partial(_remat_context, policy))


def model_device(model: nn.Module) -> torch.device:
    """The device a model's weights live on, read without touching a
    quantized weight (reading one dequantizes it)."""
    for t in model.parameters():
        return t.device
    return next(model.buffers()).device


def run_stack(blocks: nn.ModuleList, cfg, x,
              cache: Optional[KVCache] = None):
    """The layer stack: each block in turn, recomputed in the backward
    under ``cfg.remat`` as ``cfg.remat_policy`` says (training), or
    appending to ``cache`` (decode),
    whose index then advances by the chunk's length."""
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    for i, block in enumerate(blocks):
        if remat:
            x = remat_call(block, cfg.remat_policy, x)
        else:
            x = block(x, None if cache is None else cache.layer(i))
    if cache is not None:
        # The index (a slot cache's positions are its owner's) and the
        # ring table advance once per forward.
        cache.advance(x.shape[1])
    return x
