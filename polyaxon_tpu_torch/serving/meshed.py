"""Mesh placement for the serving engine — the EXACT tensor-parallel
serving layout.

Port of ``polyaxon_tpu/serving/meshed.py``.  The decode engine is
mesh-native when the server passes a ``ServingMesh``: one process owns
``dp * tp * ep`` local devices, the model's weights are PLACED over
them (:meth:`ServingMesh.place_params`, a :class:`MeshedModel`), and
the slot-stacked KV cache (fixed-lane pool, paged page pool, and the
draft pools) is split over ``tp`` by HEADS — the memory that scales
with slots x context, and the bandwidth the decode step streams every
token.  The reference places arrays under ``NamedSharding`` and lets
XLA's partitioner run the program; here each shard is a tensor on its
device and the models' exact forward (``models/gpt2.py``,
``llama.py``, ``moe_gpt.py``) runs it shard by shard.

Layout contract — REDUCTION-FREE by construction: no sum crosses a
device, so meshed serving is TOKEN-BITWISE-IDENTICAL to the unmeshed
engine per seed on the CPU.  On CUDA the shards' products and their
attention over fewer heads may take other kernels than the whole's:
on the H100, float32 meshed tokens equal unmeshed ones at the sizes
measured (held under the 1e-4 tie rule, which no request needed), and
bf16 ones are not bitwise (``PERF.md``; ``chip_smoke.py``'s
column-split probe):

- COLUMN-PARALLEL weights split their OUTPUT columns over ``tp``
  (q/k/v/qkv projections, gate/up/fc1 MLP inputs): each device
  computes its own output columns over the FULL contraction dim
  (``models/layers.ColumnShards``).  GPT-2's fused ``qkv`` splits BY
  HEADS (each device the q, k and v columns of its own heads), and a
  GQA model's device ``r`` holds KV heads ``[r * kv / tp, (r + 1) * kv
  / tp)`` with the q heads that share them.
- The KV cache splits over HEADS: per-head attention (scores, softmax,
  values) touches only that head's data — no cross-device math.
- ROW-PARALLEL weights (o_proj/down_proj/fc2), embeddings, norms and
  the LM head stay whole, on each slot group's primary device (a
  replica of the model's module tree that holds only these: its split
  weights are ``meta`` tensors, so no device keeps a whole copy of what
  the mesh shards, :meth:`ServingMesh.place_replica`), and the
  models' ``constrain`` sites concatenate the column shards' outputs
  there under the exact mesh (``parallel.constraints.exact_mesh``):
  the gather that replaces Megatron's psum moves bytes, and sums never
  reassociate.
- MoE experts (``[E, in, out]``) split the EXPERT dim over ``ep``:
  a decode token runs its routed expert on the device that holds it, a
  prefill chunk's buckets run on their experts' devices
  (``models/moe_gpt.ExpertShards``); per-expert math untouched.
- The slot axis splits over ``dp`` (fixed-lane pools only): each slot
  group steps its own slots with whole weights.

Devices: slot group ``g``'s devices are ``devices[g * ep * tp:(g + 1)
* ep * tp]`` laid out ``(ep, tp)`` (the reference's axis order, tp
innermost); its tensor shards sit on the devices of expert row 0 and
its expert shards on those of tensor column 0, so each shard is held
and computed once (where the reference replicates tensor shards over
``ep``).  An explicit ``devices=`` list may name one device more than
once: VIRTUAL devices, the counterpart of the reference's
``--xla_force_host_platform_device_count``, which the tests and the
card's smoke phase use to run ``tp=4`` on one CPU or one GPU.  A copy
between two virtual devices of one physical device is a no-op.

Divisibility of what the mesh CLAIMS to shard is a STARTUP error, not
a silent replicate: a model whose KV head count doesn't divide ``tp``
(or expert count ``ep``, or slot count ``dp``) refuses to serve meshed
with a message naming the offending pair.  The one deliberate
replicate is a COLUMN-PARALLEL MLP weight whose output width does not
divide ``tp`` (e.g. an odd ``intermediate_size``): that weight stays
whole — the row-parallel weights' placement, bitwise-identical either
way — and the KV/attention sharding the startup checks guarantee is
unaffected.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from ..parallel import constraints as _constraints
from ..parallel.mesh import MeshError, MeshSpec

__all__ = ["ServingMesh", "MeshedModel", "parse_mesh", "MeshError"]

# Axes the serving engine speaks.  fsdp/pp/sp are training-stack
# strategies (gradient sharding, stage pipelining) with no serving
# semantics here — requesting them is a usage error, not a no-op.
SERVING_AXES = ("dp", "tp", "ep")

# Column-parallel weights: output dim split, contraction dim whole —
# the reduction-free subset of tensor parallelism, by the port's
# parameter names (``h.0.qkv.weight``, ``h.0.attn.q_proj.weight``).
# Row-parallel names (o_proj/down_proj/fc2/wo) are deliberately ABSENT:
# splitting their input dim would sum partial products across devices,
# which reorders float accumulation and breaks the bitwise contract.
_COL_PARALLEL = re.compile(
    r"(q_proj|k_proj|v_proj|qkv|query|key|value"
    r"|fc1|wi|up_proj|gate_proj|intermediate)[^.]*\.(weight|bias)$")
_EP_PARALLEL = re.compile(r"experts_w[12]$")

# Cache leaves that carry a HEADS axis at ndim-2 (``KVCache.leaves``:
# [layers, B, positions, heads, feat] keys and values and the int8
# scales; a paged pool only splits the position axis, so heads stays at
# ndim-2 in every storage discipline).
_KV_LEAVES = ("k", "v", "k_scale", "v_scale")


def parse_mesh(arg) -> MeshSpec:
    """``"tp=4"`` / ``"tp=2,ep=2"`` / dict / MeshSpec -> a serving
    MeshSpec (absent axes default to 1 — never -1 fill: a serving
    mesh uses exactly the devices it asks for)."""
    if isinstance(arg, MeshSpec):
        spec = arg
    else:
        if isinstance(arg, str):
            sizes: Dict[str, int] = {}
            for part in arg.split(","):
                part = part.strip()
                if not part:
                    continue
                if "=" not in part:
                    raise MeshError(
                        f"mesh axis {part!r} must be AXIS=SIZE "
                        f"(e.g. tp=4)")
                k, _, v = part.partition("=")
                try:
                    sizes[k.strip()] = int(v)
                except ValueError:
                    raise MeshError(
                        f"mesh axis size {v!r} is not an integer")
        elif isinstance(arg, dict):
            try:
                sizes = {k: int(v) for k, v in arg.items()}
            except (TypeError, ValueError):
                raise MeshError(
                    f"mesh axis sizes must be integers; got {arg!r}")
        else:
            raise MeshError(
                f"mesh must be a spec string (tp=4), a dict, or a "
                f"MeshSpec; got {type(arg).__name__}")
        unknown = set(sizes) - set(SERVING_AXES)
        if unknown:
            raise MeshError(
                f"serving mesh supports axes {SERVING_AXES}; got "
                f"{sorted(unknown)} (fsdp/pp/sp are training "
                f"strategies)")
        for axis in SERVING_AXES:
            sizes.setdefault(axis, 1)
        spec = MeshSpec.from_dict(sizes)
    for axis in ("fsdp", "pp", "sp"):
        if getattr(spec, axis) not in (1,):
            raise MeshError(
                f"serving mesh supports axes {SERVING_AXES}; "
                f"{axis}={getattr(spec, axis)} is a training "
                f"strategy")
    for axis in SERVING_AXES:
        size = getattr(spec, axis)
        if size == -1:
            raise MeshError(
                f"serving mesh sizes must be explicit; {axis}=-1 "
                f"(fill) is a training-spec convention")
        if size < 1:
            raise MeshError(f"mesh axis {axis} must be >= 1; got "
                            f"{size}")
    return spec


def local_devices(device_type: str = "cuda") -> List[torch.device]:
    """The distinct local devices of ``device_type``: every CUDA card,
    or the one CPU."""
    if device_type == "cpu":
        return [torch.device("cpu")]
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [torch.device("cuda", i) for i in range(n)]


def _concrete(d) -> torch.device:
    """``d`` with its index (``cuda`` -> ``cuda:<current>``), so that a
    shard's device and the model's compare equal."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


@dataclass(frozen=True)
class Sharding:
    """Where a tensor lives on the mesh (the port's ``NamedSharding``):
    ``dims`` maps a tensor dim to the mesh axis it is split over
    (``{}``: whole, on the slot group's primary device)."""
    dims: Dict[int, str]

    def axis(self, name: str) -> Optional[int]:
        """The tensor dim split over mesh axis ``name``, or None."""
        for d, a in self.dims.items():
            if a == name:
                return d
        return None


class MeshGroup:
    """One slot group's devices and the shards placed on them: what a
    placed model publishes as the serving-exact mesh for each forward
    (``parallel.constraints.exact_mesh``).  ``shards_of(block)`` is a
    block's placement; :meth:`gather` is the exact ``constrain``."""

    def __init__(self, tp_devices: Sequence[torch.device],
                 ep_devices: Sequence[torch.device]):
        self.tp_devices = list(tp_devices)
        self.ep_devices = list(ep_devices)
        self.primary = self.tp_devices[0]
        self._shards: Dict[int, Any] = {}

    @property
    def tp(self) -> int:
        return len(self.tp_devices)

    def register(self, block, shards) -> None:
        self._shards[id(block)] = (block, shards)

    def shards_of(self, block):
        held = self._shards.get(id(block))
        if held is None or held[0] is not block:
            raise MeshError(
                f"{type(block).__name__} has no placement on this serving "
                f"mesh (run the model placed by ServingMesh.place_params)")
        return held[1]

    def gather(self, x):
        """Replicate ``x`` on the primary device: column shards (a list)
        concatenated along the last dim, a tensor moved."""
        if isinstance(x, (list, tuple)):
            parts = [p.to(self.primary) for p in x]
            return parts[0] if len(parts) == 1 else torch.cat(parts, -1)
        return x.to(self.primary)

    def place_input(self, x):
        """A step operand (this group's rows) on the primary device;
        anything but a tensor as it is."""
        return x.to(self.primary) if isinstance(x, torch.Tensor) else x

    def place_rows(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The slot groups' rows, concatenated on this group's primary
        device (dim 0)."""
        return torch.cat([p.to(self.primary) for p in parts])


class _Placer:
    """What a block's ``place_exact`` asks for its weights: column
    shards over the group's tp devices, expert shards over its ep
    devices — each only where :meth:`ServingMesh.param_shardings` says
    the weight is split."""

    def __init__(self, group: MeshGroup, shardings: Dict[str, Sharding],
                 prefix: str):
        self.group, self.shardings, self.prefix = group, shardings, prefix
        self.tp = group.tp

    def _split(self, name: str, axis: str) -> bool:
        sh = self.shardings.get(self.prefix + name)
        return sh is not None and sh.axis(axis) is not None

    def columns(self, name: str, dense, rows=None):
        """``dense``'s column shards (``rows``: the weight rows of each
        shard, default contiguous blocks), or None when whole."""
        from ..models.layers import ColumnShards, contiguous_rows

        if not self._split(f"{name}.weight", "tp"):
            return None
        if rows is None:
            rows = contiguous_rows(dense.out_features, self.tp)
        return ColumnShards(dense, rows, self.group.tp_devices)

    def experts(self, name: str, w1, w2):
        """The experts split over ep, or None when whole."""
        from ..models.moe_gpt import ExpertShards

        if not (self._split(f"{name}.experts_w1", "ep")
                and self._split(f"{name}.experts_w2", "ep")):
            return None
        return ExpertShards(w1, w2, self.group)


def _named_weights(model):
    """``(name, tensor)`` for every parameter and buffer of ``model``,
    a quantized weight's int8 codes under the weight's own name
    (``h.0.qkv.weight``) as well as under their parametrization's."""
    for mod_name, mod in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        for attr, t in list(mod._parameters.items()) \
                + list(mod._buffers.items()):
            if t is not None:
                yield prefix + attr, t
        for attr, plist in getattr(mod, "parametrizations", {}).items():
            yield prefix + attr, plist.original


def _shard_objects(shards):
    """The shard holders (``ColumnShards``, ``ExpertShards``) in a
    block's placement: a dict of them, or of such dicts, or None."""
    for v in shards.values():
        if isinstance(v, dict):
            yield from _shard_objects(v)
        elif v is not None:
            yield v


class ServingMesh:
    """One mesh + the serving placement rules over it.

    Built once at server startup over the FIRST ``dp * tp * ep``
    devices of ``devices`` (default: the distinct local devices of
    ``device_type``, ``cuda:0...`` or the one CPU; an explicit list may
    repeat a device, module docstring)."""

    def __init__(self, spec, devices: Optional[Sequence] = None,
                 device_type: str = "cuda"):
        self.spec = parse_mesh(spec)
        self.dp = self.spec.dp
        self.tp = self.spec.tp
        self.ep = self.spec.ep
        self.n_devices = self.dp * self.tp * self.ep
        if devices is None:
            devices = local_devices(device_type)
        devices = [_concrete(d) for d in devices]
        if len(devices) < self.n_devices:
            raise MeshError(
                f"mesh {self.describe()['axes']} needs "
                f"{self.n_devices} devices; only {len(devices)} "
                f"available")
        self.devices = devices[:self.n_devices]

    # -- introspection ---------------------------------------------------

    def describe(self) -> Dict[str, Any]:
        """The /info ``mesh`` block: active axes, sizes, device count."""
        return {
            "axes": {a: getattr(self, a) for a in SERVING_AXES
                     if getattr(self, a) > 1} or {"tp": 1},
            "devices": self.n_devices,
            "layout": "exact",
        }

    def axes_str(self) -> str:
        return ",".join(f"{a}={getattr(self, a)}"
                        for a in SERVING_AXES
                        if getattr(self, a) > 1) or "tp=1"

    @property
    def physical_devices(self) -> List[torch.device]:
        """The distinct devices behind the (possibly virtual) ones."""
        seen: List[torch.device] = []
        for d in self.devices:
            if d not in seen:
                seen.append(d)
        return seen

    @property
    def graphable(self) -> bool:
        """Whether a step can be one CUDA graph: every shard on one
        physical device (a graph captures one device's stream)."""
        return len(self.physical_devices) == 1

    def device_at(self, dp: int = 0, ep: int = 0, tp: int = 0
                  ) -> torch.device:
        return self.devices[(dp * self.ep + ep) * self.tp + tp]

    def group(self, g: int) -> MeshGroup:
        """A fresh (unplaced) view of slot group ``g``'s devices."""
        return MeshGroup([self.device_at(g, 0, t) for t in range(self.tp)],
                         [self.device_at(g, e, 0) for e in range(self.ep)])

    # -- context -----------------------------------------------------------

    def exact(self, group: Optional[MeshGroup] = None):
        """Context manager publishing slot group 0 (or ``group``) as the
        serving-exact mesh (``parallel.constraints.exact_mesh``).  A
        :class:`MeshedModel` enters its own group's context on every
        forward, so the engine's steps, prefill and the server's solo
        programs run under it with no wrapper at their call sites."""
        return _constraints.exact_mesh(group or self.group(0))

    # -- model validation ------------------------------------------------

    def validate_model(self, model, role: str = "model",
                       n_slots: Optional[int] = None) -> None:
        """Startup divisibility checks, with clean errors naming the
        offending (count, axis-size) pair."""
        cfg = getattr(model, "cfg", None)
        if self.tp > 1:
            heads = getattr(cfg, "num_kv_heads", None)
            label = "num_kv_heads"
            if heads is None:
                heads = getattr(cfg, "num_heads", None)
                label = "num_heads"
            if heads is None:
                raise MeshError(
                    f"mesh tp={self.tp}: the {role} has no head "
                    f"count (cfg.num_heads) to shard the KV cache "
                    f"over")
            if heads % self.tp:
                raise MeshError(
                    f"the {role}'s KV head count ({label}={heads}) "
                    f"is not divisible by mesh tp={self.tp}; pick a "
                    f"tp that divides it (sharding that silently "
                    f"replicates would fake the mesh win)")
        if self.ep > 1:
            experts = getattr(cfg, "num_experts", None)
            if experts is None:
                raise MeshError(
                    f"mesh ep={self.ep}: the {role} has no experts "
                    f"(cfg.num_experts) to shard")
            if experts % self.ep:
                raise MeshError(
                    f"the {role}'s expert count ({experts}) is not "
                    f"divisible by mesh ep={self.ep}")
        if self.dp > 1 and n_slots is not None and n_slots % self.dp:
            raise MeshError(
                f"n_slots ({n_slots}) is not divisible by mesh "
                f"dp={self.dp} (dp shards the slot axis)")
        blocks = getattr(model, "h", None)
        if not blocks or not all(hasattr(b, "place_exact")
                                 for b in blocks):
            raise MeshError(
                f"the {role} ({type(model).__name__}) has no exact "
                f"serving layout (the decoder-only GPT-2, Llama and "
                f"MoE-GPT families serve on a mesh)")

    # -- param placement -------------------------------------------------

    def param_shardings(self, model) -> Dict[str, Sharding]:
        """The :class:`Sharding` of every named weight of ``model``
        (its ``[out, in]`` dense weights and biases, a quantized one's
        included, and its raw parameters): column-parallel weights over
        tp along the output dim (0), expert tensors over ep along the
        expert dim (0), everything else whole.  A column weight whose
        output dim doesn't divide tp stays whole (module docstring: the
        attention/KV dims are guaranteed divisible by
        validate_model; MLP widths are best-effort)."""
        shapes = {name: t.shape for name, t in _named_weights(model)}
        out: Dict[str, Sharding] = {}
        for name, shape in shapes.items():
            nd = len(shape)
            if self.ep > 1 and _EP_PARALLEL.search(name) and nd >= 1 \
                    and shape[0] % self.ep == 0:
                out[name] = Sharding({0: "ep"})
            elif self.tp > 1 and _COL_PARALLEL.search(name) \
                    and nd >= 1 and shape[0] % self.tp == 0:
                out[name] = Sharding({0: "tp"})
            else:
                out[name] = Sharding({})
        return out

    def place_replica(self, model, group: MeshGroup,
                      shardings: Dict[str, Sharding]):
        """A copy of ``model``'s module tree holding the weights the mesh
        keeps whole on ``group``'s primary device (``model``'s own
        tensors where they lie there, or on a virtual twin of it; else
        copies moved there), and ``meta`` tensors of the same shapes in
        place of the weights ``shardings`` splits: those live only in
        the blocks' shards, so the replica holds no whole copy of them
        and the whole ones go with ``model`` once its owner drops it."""
        import copy

        split = {id(t) for name, t in _named_weights(model)
                 if shardings[name].dims}
        dev = group.primary
        memo: Dict[int, Any] = {}
        for t in list(model.parameters()) + list(model.buffers()):
            if id(t) in split:
                new = torch.empty_like(t, device="meta")
            elif t.device == dev:
                new = t
            else:
                new = t.detach().to(dev)
            if isinstance(t, nn.Parameter) and new is not t:
                new = nn.Parameter(new, requires_grad=t.requires_grad)
            memo[id(t)] = new
        return copy.deepcopy(model, memo)

    def place_params(self, model) -> "MeshedModel":
        """``model`` placed over the mesh: a :class:`MeshedModel` whose
        every block holds its column and expert shards on their
        devices.  ``model`` itself is left as it was."""
        return MeshedModel(self, model)

    # -- KV cache placement ----------------------------------------------

    def cache_leaf_sharding(self, key: str, leaf) -> Sharding:
        """The :class:`Sharding` of one cache leaf (``key``: its
        ``KVCache`` field name): heads (ndim-2) over tp for the KV
        leaves, everything else whole.  A slot pool's rows split over
        dp at birth (:meth:`stacked_pool`)."""
        shape = tuple(getattr(leaf, "shape", ()))
        nd = len(shape)
        if self.tp > 1 and key in _KV_LEAVES and nd >= 2 \
                and shape[nd - 2] % self.tp == 0:
            return Sharding({nd - 2: "tp"})
        return Sharding({})

    def place_cache(self, cache):
        """An unsharded B-row ``KVCache`` -> its ``ShardedKVCache`` over
        slot group 0's tp devices: each leaf split as
        :meth:`cache_leaf_sharding` says and copied to its device (a
        ``meta`` cache gives ``meta`` shards, a template), the ring
        table copied to each."""
        from ..models.kv_cache import KVCache, ShardedKVCache

        leaves = cache.leaves()
        axes = [self.cache_leaf_sharding(n, t).axis("tp")
                for n, t in zip(_KV_LEAVES, leaves)]
        if self.tp > 1 and None in axes:
            raise MeshError(
                f"cache leaf of shape {tuple(leaves[0].shape)} does "
                f"not divide over mesh {self.axes_str()}")

        def on(t, dev):
            if t.is_meta:
                return torch.empty(t.shape, dtype=t.dtype, device="meta")
            return torch.empty(t.shape, dtype=t.dtype,
                               device=dev).copy_(t)

        shards, devices = [], []
        for r in range(self.tp):
            dev = self.device_at(0, 0, r)
            parts = [t if a is None else t.chunk(self.tp, dim=a)[r]
                     for t, a in zip(leaves, axes)]
            ring = cache.ring_pos
            shards.append(KVCache.from_leaves(
                [on(t, dev) for t in parts], index=cache.index,
                ring_pos=None if ring is None else on(ring, dev)))
            devices.append(dev)
        return ShardedKVCache(shards, self.tp, devices)

    def stacked_pool(self, cache, n_slots: int):
        """The zeroed slot pool of a B=1 sharded cache's kind, allocated
        per device at birth: ``n_slots / dp`` rows of each slot group's
        head shards on their devices (ring tables of -1)."""
        from ..models.kv_cache import ShardedKVCache

        n = n_slots // self.dp
        shards, devices = [], []
        for g in range(self.dp):
            for r in range(self.tp):
                dev = self.device_at(g, 0, r)
                shards.append(cache.shards[r].stacked(n, device=dev))
                devices.append(dev)
        return ShardedKVCache(shards, self.tp, devices)


class MeshedModel:
    """A decoder placed on a :class:`ServingMesh`: the callable the
    engine, the pools and the server's solo programs run in place of
    the model.  Each slot group has a replica on its primary device
    holding the weights the mesh keeps whole (:meth:`ServingMesh.
    place_replica`), and its blocks' shards (``place_exact``, made from
    ``model``'s own weights).  The placed model keeps no reference to
    ``model``: once its owner drops it, no device holds a whole copy of
    a split weight (:meth:`device_bytes`).  Every forward runs under
    its group's exact mesh, and a slot cache split over ``dp`` runs
    group by group, rows concatenated on group 0's primary device."""

    def __init__(self, mesh: ServingMesh, model):
        self.mesh = mesh
        self.cfg = model.cfg
        shardings = mesh.param_shardings(model)
        self.groups: List[MeshGroup] = []
        self.replicas = []
        with torch.no_grad():
            for g in range(mesh.dp):
                group = mesh.group(g)
                replica = mesh.place_replica(model, group, shardings)
                for i, (block, whole) in enumerate(zip(replica.h,
                                                       model.h)):
                    group.register(block, whole.place_exact(
                        _Placer(group, shardings, f"h.{i}.")))
                self.groups.append(group)
                self.replicas.append(replica)

    @property
    def device(self) -> torch.device:
        return self.groups[0].primary

    def device_bytes(self) -> List[int]:
        """The weight bytes held on each of the mesh's devices (virtual
        ones counted apart, in :meth:`ServingMesh.device_at` order): a
        replica's on its group's primary device, a column shard's and
        an expert shard's on theirs."""
        mesh = self.mesh
        held = [0] * mesh.n_devices

        def add(slot, tensors):
            held[slot] += sum(t.numel() * t.element_size()
                              for t in tensors if not t.is_meta)

        for g, (group, replica) in enumerate(zip(self.groups,
                                                 self.replicas)):
            add(g * mesh.ep * mesh.tp, list(replica.parameters())
                + list(replica.buffers()))
            for block in replica.h:
                for shards in _shard_objects(group.shards_of(block)):
                    per = shards.held()
                    for r, tensors in enumerate(per):
                        e, t = (r, 0) if shards.axis == "ep" else (0, r)
                        add((g * mesh.ep + e) * mesh.tp + t, tensors)
        return held

    def init_cache(self, batch_size: int):
        """A zeroed B-row decode cache split over the tp devices of
        slot group 0 (``generate.init_cache`` of the model, placed)."""
        from ..models.generate import init_cache

        return self.mesh.place_cache(init_cache(self.replicas[0],
                                                batch_size))

    def forward(self, input_ids, *, train: bool = False,
                decode: bool = False, decode_position=None,
                last_only: bool = False, cache=None):
        """The model's forward over the mesh (same arguments and
        outputs).  A decode step's ``cache`` is a ``ShardedKVCache``
        (:meth:`init_cache`, or a pool's)."""
        from ..models.kv_cache import ShardedKVCache

        del train
        if decode and not isinstance(cache, ShardedKVCache):
            raise MeshError(
                "a meshed model decodes into a head-sharded cache "
                "(MeshedModel.init_cache or a meshed slot pool); got "
                f"{type(cache).__name__}")
        kw = dict(decode=decode, last_only=last_only)
        if cache is None or cache.dp == 1:
            with _constraints.exact_mesh(self.groups[0]):
                return self.replicas[0](input_ids,
                                        decode_position=decode_position,
                                        cache=cache, **kw)
        n = cache.rows
        outs = []
        for g, (group, replica) in enumerate(zip(self.groups,
                                                 self.replicas)):
            rows = slice(g * n, (g + 1) * n)
            pos = decode_position[rows] \
                if isinstance(decode_position, torch.Tensor) \
                else decode_position
            with _constraints.exact_mesh(group):
                outs.append(replica(group.place_input(input_ids[rows]),
                                    decode_position=group.place_input(pos),
                                    cache=cache.group(g), **kw))
        home = self.groups[0]
        if isinstance(outs[0], tuple):
            return (home.place_rows([o[0] for o in outs]),
                    home.place_rows([o[1][None] for o in outs]).mean())
        return home.place_rows(outs)

    __call__ = forward

