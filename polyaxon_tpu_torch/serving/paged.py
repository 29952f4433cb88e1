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

Not ported yet, and refused by name: the host spill tier and its wire
format (``pack_spilled``/``unpack_spilled``, ``spill_pages``,
``rematerialize``), the shared-prefix device paths (``scatter_cache``
of a stored prefix, ``materialize``), the speculative ``step_spec`` and
meshes (ROADMAP Queue 1).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.kv_cache import gather_pages, paged_pool_shape, scatter_pages
from .slots import StepPool, alloc_decode_state

__all__ = ["PagedSlotKVManager", "PageExhausted", "WirePayloadError"]


class PageExhausted(RuntimeError):
    """Page reservation failed.  Engine admission is gated on
    ``can_admit`` so this is a defensive error, not a control path."""


class WirePayloadError(ValueError):
    """A serialized spill payload failed integrity verification
    (truncated body, checksum mismatch, malformed header).  Callers
    on the fetch path treat this as a typed MISS — fall back to
    re-prefill, never admit bytes that don't verify."""


def _pow2ceil(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch backend yet (ROADMAP "
        f"Queue 1: {item})")


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
                 sentinel=None, max_window: Optional[int] = None):
        if page_tokens < 8:
            raise ValueError(
                f"kv_page_tokens must be >= 8; got {page_tokens}")
        if max_position < 1:
            raise ValueError(
                f"paged KV needs the model's max_position; got "
                f"{max_position}")
        super().__init__(model, n_slots, sentinel=sentinel,
                         max_window=max_window or decode_window)
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
        # One scratch page per slot, after the real pages.
        self.scratch0 = self.n_pages
        self.total_pages = self.n_pages + self.n_slots
        # The widest span one dispatch writes (no speculative rounds in
        # this port yet): its window, plus the token it feeds.  It is
        # also what a lazy admission reserves past the prompt.
        self._span_cap = max(1, int(decode_window)) + 1
        self._n_dirty_cap = self._n_dirty(self._span_cap)
        need_cap = self.max_pages_slot
        self.table_width = _pow2ceil(need_cap + self._n_dirty_cap)

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
        for s in range(self.n_slots):
            self.page_tables[s, :] = self.scratch0 + s
        self._slot_pages: List[Optional[Tuple[List[int], int]]] = \
            [None] * self.n_slots           # (page ids, n shared)
        self._slot_need = np.zeros((self.n_slots,), np.int64)
        self.lazy = bool(lazy)
        self._slot_budget = np.zeros((self.n_slots,), np.int64)
        self.lazy_growths_total = 0
        self.lazy_pages_grown_total = 0

        # -- device pools (made on the first insert) -------------------
        self._k: Optional[torch.Tensor] = None
        self._v: Optional[torch.Tensor] = None
        self._view_k: Optional[torch.Tensor] = None
        self._view_v: Optional[torch.Tensor] = None

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

    def reset(self) -> None:
        """Drop every page reference and slot (the pool returns to
        all-free, a new epoch); the captured graphs are kept."""
        with self._page_lock:
            self.refcounts[:] = 0
            self.refcounts[self.n_pages:] = 1
            self._free_pages = list(range(self.n_pages))
            self.epoch += 1
        self._free = list(range(self.n_slots))
        for s in range(self.n_slots):
            self.page_tables[s, :] = self.scratch0 + s
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
        self.page_tables[slot, :] = self.scratch0 + slot
        self._slot_need[slot] = 0
        self._slot_budget[slot] = 0

    # -- pools ----------------------------------------------------------

    def _pad_class(self, n_pages: int) -> int:
        return min(self.table_width, _pow2ceil(max(1, n_pages)))

    def _ensure_pool(self, cache) -> None:
        """Allocate the page pools from the FIRST prefilled cache
        ([L, 1, cap, H, D]): [L, pages + scratch, pt, H, D]
        keys and values, the gathered-view buffer (one flat buffer, the
        widest class's size: every class views its prefix, so each has
        one fixed address) and the static step buffers."""
        if self._k is not None:
            return
        leaf = cache.k[:, 0].shape                  # [L, cap, H, D]
        shape = paged_pool_shape(leaf, 1, self.total_pages,
                                 self.page_tokens)
        dev = cache.k.device
        self._k = torch.zeros(shape, dtype=cache.k.dtype, device=dev)
        self._v = torch.zeros(shape, dtype=cache.v.dtype, device=dev)
        p_max = self._pad_class(max(self.max_pages_slot,
                                    self._n_dirty_cap))
        n = leaf[0] * self.n_slots * p_max * self.page_tokens \
            * int(np.prod(leaf[2:]))
        self._view_k = torch.zeros(n, dtype=cache.k.dtype, device=dev)
        self._view_v = torch.zeros(n, dtype=cache.v.dtype, device=dev)
        self._table_buf = torch.zeros(
            (self.n_slots, self.table_width), dtype=torch.long,
            device=dev)
        self._d0_buf = torch.zeros(self.n_slots, dtype=torch.long,
                                   device=dev)
        self._alloc_step_buffers(dev)

    def _view_buffers(self, P: int):
        """The gather targets of class ``P``: contiguous prefixes of
        the flat view buffers, [L, S * P, pt, H, D]."""
        L, _, pt, h, d = self._k.shape
        shape = (L, self.n_slots * P, pt, h, d)
        n = int(np.prod(shape))
        return self._view_k[:n].view(shape), self._view_v[:n].view(shape)

    # -- insert -----------------------------------------------------------

    def _scatter_cache(self, cache, ids: List[int]) -> None:
        """Write a contiguous B=1 cache's first ``len(ids)`` pages into
        pool pages ``ids`` (eager, outside any graph)."""
        n = len(ids)
        pt = self.page_tokens
        targets = torch.as_tensor(ids, dtype=torch.long,
                                  device=self._k.device)
        for pool, src in ((self._k, cache.k), (self._v, cache.v)):
            leaf = src[:, 0, :n * pt]                # [L, <=n*pt, H, D]
            if leaf.shape[1] < n * pt:
                pad = leaf.new_zeros((leaf.shape[0], n * pt
                                      - leaf.shape[1]) + leaf.shape[2:])
                leaf = torch.cat([leaf, pad], dim=1)
            pages = leaf.reshape((leaf.shape[0], n, pt) + leaf.shape[2:])
            scatter_pages(pool, pages, targets, 1)

    def insert(self, slot: int, cache, first_token: int,
               position: int, *, base_key=None, next_index: int = 1,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 0.0,
               total_tokens: Optional[int] = None) -> None:
        """Admit a prefilled request: reserve its pages, build its
        table, scatter the prefilled cache into them and arm the slot's
        decode state (the fixed-lane insert's contract).

        ``total_tokens`` is the request's whole KV budget (prompt + new
        tokens).  FULL mode reserves all of it; LAZY mode reserves
        ``admit_tokens`` and records the budget as the growth cap."""
        if total_tokens is None:
            total_tokens = self.max_position
        self._ensure_pool(cache)
        n_total = self.pages_needed(total_tokens)
        n_need = self.pages_needed(self.admit_tokens(
            position + 1, total_tokens)) if self.lazy else n_total
        ids = self.try_reserve(n_need)
        if ids is None:
            raise PageExhausted(
                f"admission needs {n_need} free pages (have "
                f"{self.free_page_count()}): engine admission gate out "
                f"of sync")
        try:
            with torch.no_grad():
                self._scatter_cache(cache, ids)
        except BaseException:
            self.unpin(ids)
            raise
        self.page_tables[slot, :] = self.scratch0 + slot
        self.page_tables[slot, :len(ids)] = np.asarray(ids, np.int64)
        self._slot_pages[slot] = (ids, 0)
        self._slot_need[slot] = n_need
        self._slot_budget[slot] = n_total
        self._arm(slot, first_token, position, base_key, next_index,
                  temperature, top_k, top_p)

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
        self._slot_need[slot] = len(ids)
        self.lazy_growths_total += 1
        self.lazy_pages_grown_total += delta
        return delta

    # -- refused by name ---------------------------------------------------

    def materialize(self, ids, n_tokens):
        raise _not_ported("materializing stored prefix pages",
                          "the radix prefix cache")

    def spill_pages(self, ids, n_tokens):
        raise _not_ported("the host spill tier",
                          "the spill tier and its wire format")

    def rematerialize(self, host_leaves, n_tokens):
        raise _not_ported("the host spill tier",
                          "the spill tier and its wire format")

    def step_spec(self, window: int, K: int):
        raise _not_ported("the speculative step",
                          "beam and speculative decoding")

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
        self._table_buf.copy_(torch.from_numpy(self.page_tables))
        self._d0_buf.copy_(torch.from_numpy(self._d0_host))

    def _body(self, window: int, sampled: bool, P: int) -> None:
        """Gather views, the shared decode body, scatter dirty pages."""
        from ..models.kv_cache import KVCache

        S = self.n_slots
        tables = self._table_buf[:, :P]
        vk, vv = self._view_buffers(P)
        cache = KVCache(gather_pages(self._k, tables, 1, out=vk),
                        gather_pages(self._v, tables, 1, out=vv),
                        positions=self._pos_buf)
        self._run_window(cache, window, sampled)
        n_dirty = self._n_dirty(window)
        local = self._d0_buf[:, None] + torch.arange(
            n_dirty, device=tables.device)           # [S, n_dirty]
        targets = tables.gather(1, local).reshape(-1)
        rows = (torch.arange(S, device=tables.device)[:, None] * P
                + local).reshape(-1)
        for pool, view in ((self._k, vk), (self._v, vv)):
            scatter_pages(pool, torch.index_select(view, 1, rows),
                          targets, 1)

    def _step_key(self, window: int, sampled: bool) -> tuple:
        return (window, sampled, self._resident_pad())

    def step(self, window: int = 1, sampled: bool = False, *,
             graph: Optional[bool] = None) -> np.ndarray:
        """``window`` fused decode steps across the whole pool, the
        paged twin of ``SlotKVManager.step``: one CUDA graph per
        (window, sampled, pad class)."""
        if self._k is None:
            raise RuntimeError("step() before any insert()")
        self._check_window(window)
        key = self._step_key(window, sampled)
        P = key[2]
        self._d0_host = self._dirty_start(P, self._n_dirty(window))
        return self._dispatch(
            key, lambda: self._body(window, sampled, P), graph=graph,
            on_card=self._k.device.type == "cuda")
