"""Paged KV memory for the continuous-batching engine.

Port of ``polyaxon_tpu/serving/paged.py``'s :class:`PagedSlotKVManager`
(block-table paging with eager or lazy reservation).  The fixed-lane
pool (slots.py) gives every resident a full ``max_position`` lane; here
the keys and values live in a POOL of fixed-size pages ([L, pages,
page_tokens, H, D] each), and every slot owns a PAGE TABLE of page ids:

- a step GATHERS every slot's pages into a position-contiguous view
  (``models/kv_cache.gather_pages``, one [L, S, P * page_tokens, H, D]
  slot cache, P the pow2 pad class of the widest resident table), runs
  the SAME greedy or sampled decode body as the fixed-lane pool, and
  SCATTERS back only the window's dirty pages — once per window;
- page tables and the dirty-window starts are device buffers copied in
  before each replay, and the gathered view sits at one fixed address,
  so a window is one CUDA graph per (window, sampled, P): page traffic
  never enters a graph key (zero captures after warm-up per class).

Safety argument, the fixed-lane one on pages: a slot's view is
position-contiguous (page i covers positions [i*pt, (i+1)*pt)), so the
absolute-position masking of ``append_kv_slots`` holds verbatim.  Idle
slots step on their own SCRATCH page (one per slot, parked at position
0) and a short slot's pad entries point at its scratch page: garbage
by definition, masked by position, and never a page a live slot
owns.  Dirty windows only ever cover pages the slot owns or its own
scratch page.

RESERVATION (two modes): FULL (default) reserves a request's whole
budget (prompt + new tokens) at admission, so a resident always
finishes; a request that can never fit the pool is shed at submit and
one that does not fit now waits admit-ready.  LAZY (``lazy=True``,
``--kv-lazy``) reserves the prompt plus one dispatch span and GROWS
tables at step boundaries (:meth:`grow_slot`); the engine owns the new
failure mode, mid-decode exhaustion, by preempting through its
token-identical resume path.

Locking: page refcounts and the free list change only under
``_page_lock``; slot tables and decode state are engine-thread-only.

SHARED PREFIX PAGES (copy-on-write): a stored prefix's full pages are
mapped read-only into every slot that hits it (``insert(...,
shared_pages=)``; one reference per mapping).  Every write aimed at a
shared page — the insert's scatter of the slot's contiguous prefill,
and the step's dirty-window scatter — is redirected to the TRASH page
(``_write_targets`` and the per-slot WRITE table the step scatters
through), so a page with refcount > 1 is never rewritten.
``materialize`` gathers stored pages back into a contiguous B=1 cache,
what a prefix hit extends with its suffix.

SPECULATIVE rounds (``step_spec``): with a draft model the pool holds a
DRAFT page pool of the same page geometry, and a slot's draft pages
carry the same ids as its target pages, so one table gathers both
views and one write table scatters both (``insert(...,
draft_cache=)``).  Every reservation and the table width carry the spec
slack (a round's verify writes up to ``spec_k_cap`` positions past the
last committed token), and the dirty window of a spec dispatch covers
``window * K + 1`` positions.

An int8 cache pages its bf16 scales beside its keys and values: every
cache tensor (``KVCache.leaves``) has its own page pool with the same
page ids, so one table gathers, scatters, copies-on-write and
materializes them all.  A ring cache is already O(window) and stays on
the fixed-lane pool (the engine refuses ``kv_paged`` for it).

HOST TIER and WIRE FORMAT: ``spill_pages`` gathers a stored prefix's
pages to host tensors (trimmed to its page-aligned span) and
``rematerialize`` puts them back as the contiguous B=1 cache
``materialize`` returns, bitwise.  ``pack_spilled``/``unpack_spilled``
turn one such entry into a checksummed byte string and back: the
reference's format byte for byte (its JSON header, dtype names and
buffer order), so a blob crosses between the two packages.  The leaves
travel in the reference's flax order — ``cache_index`` (written as
``null``), ``cached_key``, ``cached_key_scale``, ``cached_value``,
``cached_value_scale`` — not in ``KVCache.leaves``' order; bf16 tensors
go out as the raw bytes of their 16-bit view and come back through
``numpy.uint16``, with no bf16 numpy type.

On a SERVING MESH (``serving/meshed.py``) the page pools are allocated
per device from the first (head-sharded) cache: each tp shard's leaves
get their own pools of ``H / tp`` heads on its device, under the same
page ids, so one table gathers, scatters and materializes every shard
(the tables and the dirty starts are copied to each shard's device, a
no-op for virtual devices).  The host tier and the wire pack the
shards CONCATENATED along the heads axis, so a meshed pool's spilled
blob is byte-equal to an unmeshed pool's, and either pool
rematerializes the other's.  ``dp`` is refused: pages migrate between
slots, so the page axis has no stable slot-group decomposition.
"""

from __future__ import annotations

import json
import struct
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.kv_cache import gather_pages, paged_pool_shape, scatter_pages
from .slots import StepPool, alloc_decode_state, host_copy

__all__ = ["PagedSlotKVManager", "PageExhausted", "WirePayloadError",
           "pack_spilled", "unpack_spilled"]


class PageExhausted(RuntimeError):
    """Page reservation failed.  Engine admission is gated on
    ``can_admit`` so this is a defensive error, not a control path."""


class WirePayloadError(ValueError):
    """A serialized spill payload failed integrity verification
    (truncated body, checksum mismatch, malformed header).  Callers
    on the fetch path treat this as a typed MISS — fall back to
    re-prefill, never admit bytes that don't verify."""


# -- wire serialization (fleet prefix cache) -----------------------------
#
# A host-tier prefix entry references no device state, so the same
# buffers land in any replica's pool.  Layout: a 4-byte big-endian
# header length, a JSON header (prompt tokens, leaf shapes and dtype
# names, the logits' shape and dtype, the body's crc32), then the raw
# C-order buffers concatenated, logits first.

_WIRE_VERSION = 1

# Dtype names on the wire (numpy's ``dtype.name``, as the reference
# writes them) and back.  bfloat16 has no numpy type here: its bytes are
# those of the tensor's int16 view.
_WIRE_DTYPES = {torch.float32: "float32", torch.float16: "float16",
                torch.bfloat16: "bfloat16", torch.int8: "int8",
                torch.int32: "int32", torch.int64: "int64",
                torch.uint8: "uint8"}
_FROM_WIRE = {v: k for k, v in _WIRE_DTYPES.items()}


def _wire_buffer(a) -> Tuple[List[int], str, bytes]:
    """(shape, dtype name, C-order bytes) of a tensor (or array): wire
    encoding of a host-tier entry, off the decode step."""
    t = host_copy(torch.as_tensor(a)).contiguous()
    name = _WIRE_DTYPES.get(t.dtype)
    if name is None:
        raise ValueError(f"no wire dtype for {t.dtype}")
    raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    # raw is on the host already (host_copy).  # ptpu: ignore[HOST-SYNC]
    return list(t.shape), name, raw.numpy().tobytes()


def _wire_nbytes(meta) -> int:
    """Bytes of one declared buffer; a malformed declaration (not a
    dict, an unknown dtype, a shape of anything but non-negative ints)
    raises :class:`WirePayloadError`."""
    if not isinstance(meta, dict) or meta.get("dtype") not in _FROM_WIRE \
            or not isinstance(meta.get("shape"), list) \
            or not all(isinstance(d, int) and not isinstance(d, bool)
                       and d >= 0 for d in meta["shape"]):
        raise WirePayloadError(f"malformed buffer declaration {meta!r}")
    n = torch.empty((), dtype=_FROM_WIRE[meta["dtype"]]).element_size()
    for d in meta["shape"]:
        n *= d
    return n


def pack_spilled(toks, leaves: Sequence[Optional[object]],
                 n_tokens: int, logits) -> bytes:
    """Serialize one host-tier prefix entry for the wire: ``leaves``
    in the reference's order (``spill_pages``' output; None for an
    index leaf)."""
    toks = np.ascontiguousarray(np.asarray(toks, np.int32))
    shape, name, raw = _wire_buffer(logits)
    parts = [raw]
    logits_meta = {"shape": shape, "dtype": name}
    leaf_meta = []
    for h in leaves:
        if h is None:
            leaf_meta.append(None)
            continue
        shape, name, raw = _wire_buffer(h)
        leaf_meta.append({"shape": shape, "dtype": name})
        parts.append(raw)
    body = b"".join(parts)
    header = json.dumps({
        "v": _WIRE_VERSION,
        "n_tokens": int(n_tokens),
        # A numpy array, no tensor.  # ptpu: ignore[HOST-SYNC]
        "prompt": toks.tolist(),
        "logits": logits_meta,
        "leaves": leaf_meta,
        "crc32": zlib.crc32(body) & 0xFFFFFFFF,
    }).encode()
    return struct.pack(">I", len(header)) + header + body


def unpack_spilled(blob: bytes):
    """Parse and VERIFY a :func:`pack_spilled` byte string; returns
    ``(toks, leaves, n_tokens, logits)`` (an int32 array, host tensors).
    Raises :class:`WirePayloadError` on any truncation, checksum
    mismatch or malformed header — never a partially decoded payload."""
    if len(blob) < 4:
        raise WirePayloadError("payload shorter than its own "
                               "header-length field")
    (hlen,) = struct.unpack(">I", blob[:4])
    if len(blob) < 4 + hlen:
        raise WirePayloadError("payload truncated inside the header")
    try:
        header = json.loads(blob[4:4 + hlen].decode())
        version = header["v"]
        n_tokens = int(header["n_tokens"])
        prompt = header["prompt"]
        logits_meta = header["logits"]
        leaf_meta = header["leaves"]
        crc_want = int(header["crc32"])
    except (ValueError, KeyError, TypeError, UnicodeDecodeError):
        raise WirePayloadError("malformed wire header")
    if version != _WIRE_VERSION:
        raise WirePayloadError(
            f"wire version {version!r} != {_WIRE_VERSION} "
            f"(mixed-version fleet; refetch or re-prefill)")
    body = blob[4 + hlen:]
    if (zlib.crc32(body) & 0xFFFFFFFF) != crc_want:
        raise WirePayloadError("payload checksum mismatch")
    off = 0

    def _take(meta):
        """The host tensor of one declared buffer, decoded under the
        checksum verified above (a copy: the blob may go)."""
        nonlocal off
        n = _wire_nbytes(meta)
        if off + n > len(body):
            raise WirePayloadError("payload truncated inside a "
                                   "buffer (header/body disagree)")
        raw, name = body[off:off + n], meta["dtype"]
        off += n
        if name == "bfloat16":
            a = np.frombuffer(raw, np.uint16).reshape(meta["shape"])
            return torch.from_numpy(a.copy()).view(torch.bfloat16)
        return torch.from_numpy(np.frombuffer(raw, np.dtype(name))
                                .reshape(meta["shape"]).copy())

    if not isinstance(leaf_meta, list):
        raise WirePayloadError("malformed wire header")
    logits = _take(logits_meta)
    leaves: List[Optional[torch.Tensor]] = []
    for m in leaf_meta:
        leaves.append(None if m is None else _take(m))
    if off != len(body):
        raise WirePayloadError(
            f"payload has {len(body) - off} trailing bytes past the "
            f"declared buffers")
    try:
        toks = np.asarray(prompt, np.int32)
    except (TypeError, ValueError, OverflowError):
        raise WirePayloadError("malformed prompt in the wire header")
    if toks.ndim != 2 or toks.shape[1] != n_tokens:
        raise WirePayloadError(
            "prompt/n_tokens disagree in the wire header")
    return toks, leaves, n_tokens, logits


def to_wire_order(leaves: Sequence[torch.Tensor]) -> list:
    """``KVCache.leaves`` order (k, v[, k_scale, v_scale]) to the
    reference's flattened flax order: the ``cache_index`` leaf (None),
    ``cached_key``, ``cached_key_scale``, ``cached_value``,
    ``cached_value_scale`` — the sorted keys of its cache dict."""
    if len(leaves) == 4:
        k, v, ks, vs = leaves
        return [None, k, ks, v, vs]
    k, v = leaves
    return [None, k, v]


def from_wire_order(leaves: Sequence[Optional[torch.Tensor]]) -> list:
    """The inverse of :func:`to_wire_order`."""
    body = [h for h in leaves if h is not None]
    if len(body) == 4:
        k, ks, v, vs = body
        return [k, v, ks, vs]
    if len(body) != 2:
        raise WirePayloadError(
            f"expected 2 or 4 cache buffers, got {len(body)}")
    return body


def _pow2ceil(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class PagedSlotKVManager(StepPool):
    """Fixed pool of ``n_slots`` decode slots over a PAGED KV pool.

    The engine-facing surface of :class:`slots.SlotKVManager`
    (acquire/release/insert/step and the host decode state), plus the
    page accounting the engine's admission gate rides on
    (``pages_needed`` / ``admit_tokens`` / ``can_admit`` /
    ``grow_slot`` / ``page_stats``)."""

    paged = True

    def __init__(self, model, n_slots: int, *, page_tokens: int = 64,
                 n_pages: Optional[int] = None, max_position: int,
                 decode_window: int = 8, lazy: bool = False,
                 sentinel=None, max_window: Optional[int] = None,
                 draft_model=None, spec_k_cap: int = 4, mesh=None):
        if mesh is not None and mesh.dp > 1:
            from .meshed import MeshError

            raise MeshError(
                "paged KV does not support dp slot parallelism "
                "(pages migrate between slots, so the page axis has "
                "no stable dp decomposition); use tp/ep, or the "
                "fixed-lane manager for dp")
        if page_tokens < 8:
            raise ValueError(
                f"kv_page_tokens must be >= 8; got {page_tokens}")
        if max_position < 1:
            raise ValueError(
                f"paged KV needs the model's max_position; got "
                f"{max_position}")
        super().__init__(model, n_slots, sentinel=sentinel,
                         max_window=max_window or decode_window,
                         draft_model=draft_model, spec_k_cap=spec_k_cap,
                         mesh=mesh)
        self.page_tokens = int(page_tokens)
        self.max_position = int(max_position)
        pt = self.page_tokens
        self.max_pages_slot = -(-self.max_position // pt)
        # Default pool = the fixed-lane footprint (n_slots full-width
        # lanes), so `kv_paged=True` alone changes layout, not budget.
        self.n_pages = int(n_pages) if n_pages is not None \
            else self.n_slots * self.max_pages_slot
        if self.n_pages < 1:
            raise ValueError(f"kv_pages must be >= 1; got {n_pages}")
        # One scratch page per slot, after the real pages, and one
        # TRASH page: the redirected target of writes that must not
        # land on a shared page.  All garbage, masked by position.
        self.scratch0 = self.n_pages
        self.trash = self.n_pages + self.n_slots
        self.total_pages = self.n_pages + self.n_slots + 1
        # The widest span one dispatch writes: its window plus the token
        # it feeds, and with a draft model a spec window's rounds
        # (each commits up to spec_k_cap tokens and verifies
        # spec_k_cap + 1 wide).  It is also what a lazy admission
        # reserves past the prompt.
        spec = int(spec_k_cap) if draft_model is not None else 1
        self._span_cap = max(1, int(decode_window)) * spec + 1
        self._n_dirty_cap = self._n_dirty(self._span_cap)
        # Table width: the largest reservation (max_position plus the
        # spec slack) and the dirty-window margin, so d0 + n_dirty
        # always lands inside the table.
        self._need_cap = self.pages_needed(
            self.max_position
            + (int(spec_k_cap) if draft_model is not None else 0))
        self.table_width = _pow2ceil(self._need_cap + self._n_dirty_cap)

        # -- page accounting (under _page_lock) ------------------------
        self._page_lock = threading.Lock()
        with self._page_lock:
            self.refcounts = np.zeros((self.total_pages,), np.int64)
            self.refcounts[self.n_pages:] = 1  # scratch pages pinned
            self._free_pages: List[int] = list(range(self.n_pages))
            # Pool generation: page ids mean something within one epoch.
            self.epoch = 0

        # -- slot state (engine thread only) ---------------------------
        self.page_tables = np.empty((self.n_slots, self.table_width),
                                    np.int64)
        # The WRITE twin of each table: shared pages redirect to the
        # trash page, so the step's dirty scatter never rewrites them.
        self.write_tables = np.empty_like(self.page_tables)
        for s in range(self.n_slots):
            self._park_tables(s)
        self._slot_pages: List[Optional[Tuple[List[int], int]]] = \
            [None] * self.n_slots           # (page ids, n shared)
        self._slot_need = np.zeros((self.n_slots,), np.int64)
        self.lazy = bool(lazy)
        self._slot_budget = np.zeros((self.n_slots,), np.int64)
        self.lazy_growths_total = 0
        self.lazy_pages_grown_total = 0

        # -- device pools (made on the first insert) -------------------
        # One page pool and one flat gathered-view buffer per cache
        # tensor (KVCache.leaves: keys, values, an int8 cache's scales),
        # and the draft's.
        self._pools: Optional[List[torch.Tensor]] = None
        self._views: Optional[List[torch.Tensor]] = None
        self._dpools: Optional[List[torch.Tensor]] = None
        self._dviews: Optional[List[torch.Tensor]] = None
        # A cache of the pools' kind (a head-sharded one on a mesh):
        # what gathered views and materialized prefixes are rebuilt as.
        self._like = None
        self._dlike = None
        # First-touch shaping is double-checked under this lock: two
        # wire admissions racing a fresh replica's unshaped pool
        # (``ensure_shaped``) must not both allocate — the loser's pool
        # would replace one the winner already wrote pages into.
        self._shape_lock = threading.Lock()

    @property
    def _k(self) -> Optional[torch.Tensor]:
        return None if self._pools is None else self._pools[0]

    @property
    def _v(self) -> Optional[torch.Tensor]:
        return None if self._pools is None else self._pools[1]

    @property
    def _dk(self) -> Optional[torch.Tensor]:
        return None if self._dpools is None else self._dpools[0]

    @property
    def _dv(self) -> Optional[torch.Tensor]:
        return None if self._dpools is None else self._dpools[1]

    # -- page accounting ------------------------------------------------

    def pages_needed(self, tokens: int) -> int:
        return max(1, -(-int(tokens) // self.page_tokens))

    def admit_tokens(self, cur_tokens: int, total_tokens: int) -> int:
        """Tokens a new admission must have pages for UP FRONT: the
        full reservation (default), or — lazy — the request's current
        length plus one dispatch span (the rest grows at step
        boundaries, :meth:`grow_slot`)."""
        if not self.lazy:
            return int(total_tokens)
        return min(int(total_tokens), int(cur_tokens) + self._span_cap)

    @property
    def capacity_tokens(self) -> int:
        return self.n_pages * self.page_tokens

    def free_page_count(self) -> int:
        with self._page_lock:
            return len(self._free_pages)

    def can_admit(self, tokens: int, shared_pages: int = 0) -> bool:
        """Enough free pages for a ``tokens``-long reservation, of
        which ``shared_pages`` leading pages are already mapped?"""
        need = self.pages_needed(tokens) - int(shared_pages)
        with self._page_lock:
            return len(self._free_pages) >= need

    def pin(self, ids: Sequence[int]) -> int:
        """Take one reference on each page; returns the pool epoch the
        pins were taken under."""
        with self._page_lock:
            for i in ids:
                if self.refcounts[i] < 1:
                    raise ValueError(
                        f"pin of a free page {i} (stale page id — "
                        f"the entry holding it was already freed)")
                self.refcounts[i] += 1
            return self.epoch

    def unpin(self, ids: Sequence[int],
              epoch: Optional[int] = None) -> None:
        """Drop one reference per page; pages reaching zero return to
        the free list.  Pins from another ``epoch`` are dropped by
        reference."""
        with self._page_lock:
            if epoch is not None and epoch != self.epoch:
                return
            for i in ids:
                if self.refcounts[i] < 1:
                    raise ValueError(f"unpin of a free page {i}")
                self.refcounts[i] -= 1
                if self.refcounts[i] == 0:
                    self._free_pages.append(i)

    def try_reserve(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` free pages (refcount 0 -> 1), or None if fewer
        are free."""
        return self.reserve_with_epoch(n)[0]

    def reserve_with_epoch(self, n: int
                           ) -> Tuple[Optional[List[int]], int]:
        """``try_reserve`` plus the pool epoch, read in one lock hold."""
        with self._page_lock:
            if n <= 0:
                return [], self.epoch
            if len(self._free_pages) < n:
                return None, self.epoch
            ids = [self._free_pages.pop() for _ in range(n)]
            for i in ids:
                self.refcounts[i] = 1
            return ids, self.epoch

    def page_stats(self) -> Dict[str, int]:
        with self._page_lock:
            free = len(self._free_pages)
            shared = int(np.sum(self.refcounts[:self.n_pages] > 1))
        resident = int(sum(len(p[0]) for p in self._slot_pages
                           if p is not None))
        return {
            "kv_pages": self.n_pages,
            "kv_page_tokens": self.page_tokens,
            "kv_pages_free": free,
            "kv_pages_resident": resident,
            "kv_pages_shared": shared,
            "kv_lazy": self.lazy,
            "kv_pages_lazy_growths_total": self.lazy_growths_total,
            "kv_pages_lazy_grown_total": self.lazy_pages_grown_total,
        }

    def slot_page_counts(self) -> Dict[int, int]:
        """Mapped pool pages per RESIDENT slot (``/debug/state``)."""
        return {slot: len(held[0])
                for slot, held in enumerate(self._slot_pages)
                if held is not None}

    # -- slot accounting ------------------------------------------------

    def _park_tables(self, slot: int) -> None:
        self.page_tables[slot, :] = self.scratch0 + slot
        self.write_tables[slot, :] = self.scratch0 + slot

    def reset(self) -> None:
        """Crash-recovery rebuild: drop every page reference and slot
        (the pool returns to all-free, a new epoch).  Host state only:
        the page pools, the gathered views and the step buffers keep
        their addresses, which is what the captured graphs replay
        against (stale content is masked by position and rewritten by
        the next insert)."""
        with self._page_lock:
            self.refcounts[:] = 0
            self.refcounts[self.n_pages:] = 1
            self._free_pages = list(range(self.n_pages))
            self.epoch += 1
        self._free = list(range(self.n_slots))
        for s in range(self.n_slots):
            self._park_tables(s)
        self._slot_pages = [None] * self.n_slots
        self._slot_need[:] = 0
        self._slot_budget[:] = 0
        alloc_decode_state(self)

    def release(self, slot: int) -> None:
        """Evict: park the slot (the fixed-lane contract) AND return its
        pages, one reference each."""
        super().release(slot)
        held = self._slot_pages[slot]
        if held is not None:
            self._slot_pages[slot] = None
            self.unpin(held[0])
        self._park_tables(slot)
        self._slot_need[slot] = 0
        self._slot_budget[slot] = 0

    # -- pools ----------------------------------------------------------

    def _pad_class(self, n_pages: int) -> int:
        return min(self.table_width, _pow2ceil(max(1, n_pages)))

    def _alloc_pool(self, cache, device=None):
        """Page pools of a model's prefilled cache (each leaf [L, 1,
        cap, H, X]): [L, pages + scratch + trash, pt, H, X] per leaf, and
        the flat gathered-view buffers (the widest class's size: every
        class views its prefix, so each has one fixed address).  Only
        the leaves' shapes and dtypes are read, so a ``meta`` template
        works with ``device`` given.  A head-sharded cache (a mesh)
        gets each shard's pools on the shard's own device, whatever
        ``device`` says."""
        from ..models.kv_cache import ShardedKVCache

        p_max = self._pad_class(max(self._need_cap, self._n_dirty_cap))
        leaves = cache.leaves()
        devs = cache.leaf_devices() if isinstance(cache, ShardedKVCache) \
            else [t.device if device is None else device for t in leaves]
        pools, views = [], []
        for t, dev in zip(leaves, devs):
            leaf = t[:, 0].shape                    # [L, cap, H, X]
            shape = paged_pool_shape(leaf, 1, self.total_pages,
                                     self.page_tokens)
            n = leaf[0] * self.n_slots * p_max * self.page_tokens \
                * int(np.prod(leaf[2:]))
            pools.append(torch.zeros(shape, dtype=t.dtype, device=dev))
            views.append(torch.zeros(n, dtype=t.dtype, device=dev))
        return pools, views

    def _ensure_pool(self, cache, device=None) -> None:
        """Allocate the page pools from the FIRST prefilled cache (or a
        template), with the page tables' device twins and the static
        step buffers.  Double-checked under ``_shape_lock``, and the
        pools are published last: a reader that sees them sees every
        buffer."""
        if self._pools is not None:
            return
        with self._shape_lock:
            if self._pools is not None:     # lost the race: done
                return
            cache = self._placed(cache)
            pools, views = self._alloc_pool(cache, device)
            self._like = self._skeleton(cache)
            dev = pools[0].device
            self._table_buf = torch.zeros(
                (self.n_slots, self.table_width), dtype=torch.long,
                device=dev)
            self._wtable_buf = torch.zeros_like(self._table_buf)
            self._d0_buf = torch.zeros(self.n_slots, dtype=torch.long,
                                       device=dev)
            self._alloc_step_buffers(dev)
            self._views = views
            self._pools = pools

    @property
    def shaped(self) -> bool:
        """Whether the page pools exist yet (made by the first page
        write, or by :meth:`ensure_shaped`)."""
        return self._pools is not None

    def ensure_shaped(self, template, device=None) -> None:
        """Shape the pools from a template cache WITHOUT a page write —
        the cold pool's way in for a wire-fetched or handed-off entry
        that arrives before this replica's first prefill.  Only shapes
        and dtypes are read (a ``meta`` template with ``device``).  Safe
        under concurrent first touch: exactly one caller allocates."""
        self._ensure_pool(template, device)

    def _ensure_draft_pool(self, cache) -> None:
        """The DRAFT's page pools, the same page geometry as the
        target's (one table addresses both), from the first draft
        prefill."""
        if self._dpools is not None:
            return
        with self._shape_lock:
            if self._dpools is None:
                cache = self._placed(cache)
                dpools, self._dviews = self._alloc_pool(cache)
                self._dlike = self._skeleton(cache)
                self._dpools = dpools

    def _placed(self, cache):
        """``cache`` split over the mesh (an unsharded template, e.g. the
        server's ``meta`` one, placed by ``ServingMesh.place_cache``);
        as it is off a mesh or when already split."""
        from ..models.kv_cache import ShardedKVCache

        if self.mesh is None or isinstance(cache, ShardedKVCache):
            return cache
        return self.mesh.place_cache(cache)

    @staticmethod
    def _skeleton(cache):
        """A cache of ``cache``'s kind and sharding holding no storage:
        what views and materialized prefixes are rebuilt from."""
        return cache.with_leaves(
            [torch.empty(0, device="meta") for _ in cache.leaves()],
            index=0, positions=None)

    def _view_buffers(self, P: int, draft: bool = False):
        """The gather targets of class ``P``, one per cache tensor:
        contiguous prefixes of the flat view buffers, [L, S * P, pt, H,
        X]."""
        pools, flats = (self._dpools, self._dviews) if draft \
            else (self._pools, self._views)
        out = []
        for pool, flat in zip(pools, flats):
            L, _, pt, h, x = pool.shape
            shape = (L, self.n_slots * P, pt, h, x)
            out.append(flat[:int(np.prod(shape))].view(shape))
        return out

    # -- insert / prefix-store scatter -------------------------------------

    def _write_targets(self, ids: Sequence[int], n_shared: int
                       ) -> np.ndarray:
        """Scatter targets for a cache write over pages ``ids``: the
        first ``n_shared`` (already populated, shared: never rewrite a
        page with refcount > 1) redirect to the trash page."""
        tg = np.asarray(ids, np.int64).copy()
        tg[:n_shared] = self.trash
        return tg

    def scatter_cache(self, cache, ids: Sequence[int],
                      n_shared: int = 0, *, draft: bool = False) -> None:
        """Write a contiguous B=1 cache's first ``len(ids)`` pages into
        pool pages ``ids`` (eager, outside any graph); the first
        ``n_shared`` already hold the same content and go to the trash
        page instead.  ``draft``: into the draft's pools.  Device work:
        callers hold the device lock."""
        if draft:
            self._ensure_draft_pool(cache)
            pools = self._dpools
        else:
            self._ensure_pool(cache)
            pools = self._pools
        n = len(ids)
        pt = self.page_tokens
        tg = self._write_targets(ids, n_shared)
        with torch.no_grad():
            for pool, src in zip(pools, cache.leaves()):
                targets = torch.as_tensor(tg, device=pool.device)
                leaf = src[:, 0, :n * pt]            # [L, <=n*pt, H, D]
                if leaf.shape[1] < n * pt:
                    pad = leaf.new_zeros((leaf.shape[0], n * pt
                                          - leaf.shape[1]) + leaf.shape[2:])
                    leaf = torch.cat([leaf, pad], dim=1)
                pages = leaf.reshape((leaf.shape[0], n, pt)
                                     + leaf.shape[2:])
                scatter_pages(pool, pages, targets, 1)

    def insert(self, slot: int, cache, first_token: int,
               position: int, *, base_key=None, next_index: int = 1,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 0.0, draft_cache=None, spec_k: int = 0,
               total_tokens: Optional[int] = None,
               shared_pages: Sequence[int] = ()) -> None:
        """Admit a prefilled request: reserve its pages, build its
        table, scatter the prefilled cache into its PRIVATE pages
        (shared prefix pages are mapped, not rewritten) and arm the
        slot's decode state (the fixed-lane insert's contract).

        ``total_tokens`` is the request's whole KV budget (prompt + new
        tokens).  FULL mode reserves all of it; LAZY mode reserves
        ``admit_tokens`` and records the budget as the growth cap.
        ``shared_pages`` are pinned prefix-page ids whose references
        this call TAKES OWNERSHIP of (released with the rest at slot
        release, or here on failure).  A speculative stream's
        ``draft_cache`` goes into the draft pool at the same page
        ids."""
        if total_tokens is None:
            total_tokens = self.max_position
        n_total = self.pages_needed(total_tokens)
        n_need = self.pages_needed(self.admit_tokens(
            position + 1, total_tokens)) if self.lazy else n_total
        shared = [int(i) for i in shared_pages]
        if len(shared) > n_need:        # defensive: over-wide prefix
            self.unpin(shared[n_need:])
            shared = shared[:n_need]
        priv = self.try_reserve(n_need - len(shared))
        if priv is None:
            self.unpin(shared)
            raise PageExhausted(
                f"admission needs {n_need - len(shared)} free pages "
                f"(have {self.free_page_count()}): engine admission "
                f"gate out of sync")
        ids = shared + priv
        try:
            self.scatter_cache(cache, ids, n_shared=len(shared))
            if draft_cache is not None:
                self.scatter_cache(draft_cache, ids, n_shared=len(shared),
                                   draft=True)
        except BaseException:
            self.unpin(ids)
            raise
        self._park_tables(slot)
        self.page_tables[slot, :len(ids)] = np.asarray(ids, np.int64)
        self.write_tables[slot, :len(ids)] = self._write_targets(
            ids, len(shared))
        self._slot_pages[slot] = (ids, len(shared))
        self._slot_need[slot] = n_need
        self._slot_budget[slot] = n_total
        self._arm(slot, first_token, position, base_key, next_index,
                  temperature, top_k, top_p, spec_k)

    # -- lazy growth (engine thread, step boundaries) --------------------

    def grow_need(self, slot: int, tokens: int) -> int:
        """Pages a ``grow_slot(slot, tokens)`` would still reserve."""
        held = self._slot_pages[slot]
        if held is None:
            raise ValueError(f"grow_need of a free slot {slot}")
        want = min(self.pages_needed(tokens),
                   int(self._slot_budget[slot]))
        return max(0, want - len(held[0]))

    def grow_slot(self, slot: int, tokens: int) -> Optional[int]:
        """LAZY growth at a step boundary: extend ``slot``'s table to
        hold ``tokens`` positions, capped at its budget.  Returns the
        pages grown (0 = wide enough), or None on POOL EXHAUSTION (the
        engine's preempt path owns what happens next).  Fresh pages
        hold garbage until the step writes them, masked by position."""
        held = self._slot_pages[slot]
        if held is None:
            raise ValueError(f"grow of a free slot {slot}")
        ids, _n_shared = held
        want = min(self.pages_needed(tokens),
                   int(self._slot_budget[slot]))
        delta = want - len(ids)
        if delta <= 0:
            return 0
        fresh, _epoch = self.reserve_with_epoch(delta)
        if fresh is None:
            return None
        start = len(ids)
        ids.extend(fresh)
        self.page_tables[slot, start:start + delta] = \
            np.asarray(fresh, np.int64)
        self.write_tables[slot, start:start + delta] = \
            np.asarray(fresh, np.int64)
        self._slot_need[slot] = len(ids)
        self.lazy_growths_total += 1
        self.lazy_pages_grown_total += delta
        return delta

    # -- prefix materialization -------------------------------------------

    def materialize(self, ids: Sequence[int], n_tokens: int):
        """Gather stored prefix pages into a CONTIGUOUS B=1 cache of
        the model's full width: ``[L, 1, max_position, H_kv, D]`` keys
        and values in the pool's dtype (a RoPE model's keys already
        rotated; an int8 cache's scales beside them), index
        ``n_tokens`` — the cache ``prefill`` extends with a hit's
        suffix.  Fresh tensors: extending them never touches the pool.
        Device work: callers hold the device lock and a pin on every
        page in ``ids``."""
        if self._pools is None:
            raise RuntimeError("materialize() before any page write")
        pt = self.page_tokens
        width = min(len(ids) * pt, self.max_position)
        out = []
        with torch.no_grad():
            for pool in self._pools:
                table = torch.as_tensor(list(ids), dtype=torch.long,
                                        device=pool.device)
                L, _, _, h, x = pool.shape
                full = pool.new_zeros((L, 1, self.max_position, h, x))
                full[:, 0, :width] = gather_pages(pool, table, 1)[:, :width]
                out.append(full)
        return self._like.with_leaves(out, index=int(n_tokens),
                                      positions=None)

    # -- host-RAM tier (prefix-store spill / rematerialize) ---------------
    #
    # The device<->host transfers of page-pool payloads: an entry evicted
    # under page pressure spills here instead of being dropped, and a
    # later hit comes back through ``rematerialize``.  Both are device
    # work done under the device lock and off the step path (reclaim and
    # a hit's admission, never inside a step or a graph capture).

    def spill_pages(self, ids: Sequence[int], n_tokens: int
                    ) -> List[Optional[torch.Tensor]]:
        """Gather stored prefix pages into HOST tensors, trimmed to the
        entry's page-aligned span (``len(ids) * page_tokens`` positions,
        at most ``max_position``): ``[L, 1, width, H, X]`` per cache
        tensor, in the reference's wire order (:func:`to_wire_order`,
        None for its index leaf) — exactly ``materialize``'s leaves cut
        to that width.  Callers hold the device lock and a pin on every
        page in ``ids``."""
        if self._pools is None:
            raise RuntimeError("spill_pages() before any page write")
        width = min(len(ids) * self.page_tokens, self.max_position)
        host = []
        with torch.no_grad():
            for pool in self._pools:
                table = torch.as_tensor(list(ids), dtype=torch.long,
                                        device=pool.device)
                v = gather_pages(pool, table, 1)[:, :width]
                host.append(host_copy(v.unsqueeze(1)))
        if self._sharded:
            host = self._like.merge_heads(host)
        return to_wire_order(host)

    @property
    def _sharded(self) -> bool:
        """Whether the pools are a mesh's head shards."""
        from ..models.kv_cache import ShardedKVCache

        return isinstance(self._like, ShardedKVCache)

    def rematerialize(self, host_leaves: Sequence[Optional[torch.Tensor]],
                      n_tokens: int):
        """Host-tier hit: put spilled leaves (wire order) back into a
        CONTIGUOUS B=1 cache of the model's full width on the pool's
        device — bitwise what :meth:`materialize` returns for the same
        content (zeros past the spilled span), the int8 codes and bf16
        scales included, so every consumer of a hit is reused unchanged.
        Callers hold the device lock."""
        if self._pools is None:
            raise RuntimeError("rematerialize() before the pool was "
                               "shaped (ensure_shaped)")
        leaves = from_wire_order(host_leaves)
        if self._sharded:
            if len(leaves) * self._like.tp != len(self._pools):
                raise WirePayloadError(
                    f"payload has {len(leaves)} cache buffers; this "
                    f"pool pages {len(self._pools) // self._like.tp}")
            leaves = self._like.split_heads(leaves)
        if len(leaves) != len(self._pools):
            raise WirePayloadError(
                f"payload has {len(leaves)} cache buffers; this pool "
                f"pages {len(self._pools)}")
        out = []
        with torch.no_grad():
            for pool, h in zip(self._pools, leaves):
                L, _, _, hh, x = pool.shape
                if h.dim() != 5 or h.shape[0] != L or h.shape[1] != 1 \
                        or tuple(h.shape[3:]) != (hh, x):
                    raise WirePayloadError(
                        f"payload buffer {tuple(h.shape)} does not fit "
                        f"this pool's [{L}, 1, positions, {hh}, {x}]")
                full = pool.new_zeros((L, 1, self.max_position, hh, x))
                w = min(h.shape[2], self.max_position)
                full[:, :, :w] = h[:, :, :w].to(pool.device).to(pool.dtype)
                out.append(full)
        return self._like.with_leaves(out, index=int(n_tokens),
                                      positions=None)

    # -- decode steps ----------------------------------------------------

    def _resident_pad(self) -> int:
        """Pad class of this dispatch's tables: pow2 of the widest
        resident reservation (at least the dirty-window width), so the
        gathered view tracks the resident mix."""
        need = int(self._slot_need.max()) if self.n_slots else 1
        return self._pad_class(max(need, self._n_dirty_cap))

    def _n_dirty(self, span: int) -> int:
        pt = self.page_tokens
        return (span - 1 + pt - 1) // pt + 1

    def _dirty_start(self, P: int, n_dirty: int) -> np.ndarray:
        """Per-slot first dirty page, CLAMPED so the fixed-width dirty
        slice fits the table (a shifted window rewrites pages the slot
        owns with their own content)."""
        d0 = self.positions // self.page_tokens
        return np.clip(d0, 0, max(0, P - n_dirty)).astype(np.int64)

    def _load_state(self) -> None:
        super()._load_state()
        # The page TABLES (an int index per slot), not page payloads.
        # ptpu: ignore[TIER-XFER]
        self._table_buf.copy_(torch.from_numpy(self.page_tables))
        self._wtable_buf.copy_(torch.from_numpy(self.write_tables))
        self._d0_buf.copy_(torch.from_numpy(self._d0_host))

    def _gather(self, P: int, draft: bool = False):
        """The slot cache of class ``P``: every slot's pages gathered
        through its table into the fixed view buffers (each shard's
        through its device's copy of the tables on a mesh)."""
        tables = self._table_buf[:, :P]
        pools = self._dpools if draft else self._pools
        like = self._dlike if draft else self._like
        return like.with_leaves(
            [gather_pages(pool, tables.to(pool.device), 1, out=view)
             for pool, view in zip(pools, self._view_buffers(P, draft))],
            index=0, positions=self._dpos_buf if draft else self._pos_buf)

    def _scatter_dirty(self, P: int, n_dirty: int,
                       draft: bool = False) -> None:
        """Scatter each slot's ``n_dirty`` pages from its dirty start
        back through the WRITE tables (a shared page's slice goes to
        the trash page)."""
        S = self.n_slots
        dev = self._table_buf.device
        local = self._d0_buf[:, None] + torch.arange(
            n_dirty, device=dev)                    # [S, n_dirty]
        targets = self._wtable_buf[:, :P].gather(1, local).reshape(-1)
        rows = (torch.arange(S, device=dev)[:, None] * P
                + local).reshape(-1)
        pools = self._dpools if draft else self._pools
        for pool, view in zip(pools, self._view_buffers(P, draft)):
            dev = pool.device
            scatter_pages(pool, torch.index_select(view, 1, rows.to(dev)),
                          targets.to(dev), 1)

    def _body(self, window: int, sampled: bool, P: int) -> None:
        """Gather views, the shared decode body, scatter dirty pages."""
        self._run_window(self._gather(P), window, sampled)
        self._scatter_dirty(P, self._n_dirty(window))

    def _step_key(self, window: int, sampled: bool) -> tuple:
        return (window, sampled, self._resident_pad())

    def step(self, window: int = 1, sampled: bool = False, *,
             graph: Optional[bool] = None) -> np.ndarray:
        """``window`` fused decode steps across the whole pool, the
        paged twin of ``SlotKVManager.step``: one CUDA graph per
        (window, sampled, pad class)."""
        if self._pools is None:
            raise RuntimeError("step() before any insert()")
        self._check_window(window)
        key = self._step_key(window, sampled)
        P = key[2]
        self._d0_host = self._dirty_start(P, self._n_dirty(window))
        return self._dispatch(
            key, lambda: self._body(window, sampled, P), graph=graph,
            on_card=self._pools[0].device.type == "cuda")

    def _spec_body(self, window: int, K: int, sampled: bool,
                   P: int) -> None:
        """Both pools gathered through the same tables, the shared
        speculative body, both scattered over ``window * K + 1``
        positions."""
        self._run_spec_window(self._gather(P), self._gather(P, True),
                              window, K, sampled)
        n_dirty = self._n_dirty(window * K + 1)
        self._scatter_dirty(P, n_dirty)
        self._scatter_dirty(P, n_dirty, draft=True)

    def step_spec(self, window: int, K: int, sampled: bool = False, *,
                  graph: Optional[bool] = None):
        """``window`` fused SPECULATIVE rounds, the paged twin of
        ``SlotKVManager.step_spec``: one CUDA graph per (window, "spec",
        K, sampled, pad class).  The rollback stays a positions rewind
        on the gathered views: pages are reserved with the spec slack,
        so a rejection never touches the page accounting."""
        if self._pools is None or self._dpools is None:
            raise RuntimeError("step_spec() before a speculative "
                               "insert()")
        self._check_spec(window, K)
        P = self._resident_pad()
        self._d0_host = self._dirty_start(P, self._n_dirty(window * K + 1))
        return self._dispatch_spec(
            (window, "spec", K, sampled, P),
            lambda: self._spec_body(window, K, sampled, P), window=window,
            K=K, graph=graph, on_card=self._pools[0].device.type == "cuda")
