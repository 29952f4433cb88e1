"""Slot-indexed KV memory for the continuous-batching engine.

Port of ``polyaxon_tpu/serving/slots.py``'s fixed-lane pool (greedy
step).  The reference stacks S per-request caches on a slot axis and
steps them with ``lax.scan`` over a ``vmap`` of a B=1 decode, each slot
at its own ``cache_index``.  Here the pool is ONE [S]-row cache
(``models/kv_cache.KVCache`` with per-row ``positions``) and a step is
a batched decode of ``tokens[:, None]`` at ``positions``: the per-row
scatter writes each slot's K/V at its own position, the [S, 1, 1, cap]
mask admits each row's own prefix, and ``wpe`` is gathered per row.

A WINDOW of W fused decode steps (W a power of two up to the engine's
``decode_window``) runs W times: forward, argmax over the vocab, the
write into ``outs[w]``, the feedback into ``tokens`` and ``positions +=
1``.  On the card each window is one CUDA graph over static buffers
(the stacked cache, ``tokens``, ``positions`` and ``outs``, whose
addresses never change): captured on first use (a counted MISS),
replayed after (a HIT), so a window costs one replay and one host sync
whatever W is.  On a CPU tensor the same body runs eagerly.  A failed
capture raises: nothing falls back to the eager loop on the card.

Idle slots still step (the batch shape is fixed): they sit at position
0, decode garbage into their own lane (never past ``cap``), and the
next ``insert`` overwrites the lane wholesale; the engine masks their
tokens by occupancy.

The sampled step body, the speculative step and the paged pool come
with their own slices of the port; asking for them raises.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

# The profiler marker every decode dispatch carries (the reference's
# ``analysis/xprof.py`` STEP_MARKER): trace readers anchor step
# boundaries on it.
STEP_MARKER = "ptpu_step"


def step_annotation():
    """``torch.profiler`` range around ONE decode dispatch AND its host
    sync: the sync must sit inside, or the range would span only the
    enqueue and clip the step's device time.  With no profiler active
    it costs next to nothing."""
    return torch.profiler.record_function(STEP_MARKER)


class SlotKVManager:
    """Fixed pool of ``n_slots`` decode slots over one model.

    Owns the stacked cache ([L, S, cap, H, D] keys and values, made on
    the first insert), the free-slot list, the static step buffers and
    one CUDA graph per window.  Device work only — request bookkeeping
    lives in engine.py/scheduler.py."""

    def __init__(self, model, n_slots: int, sentinel=None,
                 max_window: int = 8):
        self.model = model
        self.max_window = int(max_window)
        # Recompile sentinel (analysis/recompile.py): a window's graph
        # capture (its first eager run on the CPU) is a MISS, a replay
        # a HIT — after warm-up the count of captures must stay put.
        self.sentinel = sentinel
        self.n_slots = int(n_slots)
        self._k: Optional[torch.Tensor] = None
        self._v: Optional[torch.Tensor] = None
        self._free = list(range(self.n_slots))
        self._graphs: Dict[int, torch.cuda.CUDAGraph] = {}
        self._built: set = set()       # windows run at least once
        # Host-side per-slot decode state the step consumes: feedback
        # token and absolute position per slot.
        self.tokens = np.zeros((self.n_slots,), np.int64)
        self.positions = np.zeros((self.n_slots,), np.int64)
        # Wall time of the LAST step's device section (copy-in, replay
        # and host sync, inside the device lock).
        self.last_step_device_s = 0.0

    @property
    def device(self) -> torch.device:
        return self.model.device

    # -- slot accounting ------------------------------------------------

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def active_slots(self) -> int:
        return self.n_slots - len(self._free)

    def acquire(self) -> Optional[int]:
        return self._free.pop(0) if self._free else None

    def release(self, slot: int) -> None:
        """Evict: the slot is reusable the SAME step.  Its stale KV is
        unreachable until the next insert overwrites the lane; the slot
        parks at position 0 so its idle stepping stays in range."""
        if slot in self._free:
            raise ValueError(f"slot {slot} already free")
        self._free.append(slot)
        self._free.sort()
        self.tokens[slot] = 0
        self.positions[slot] = 0

    # -- device state ---------------------------------------------------

    def _ensure_stacked(self, cache) -> None:
        """Allocate the pool from the FIRST prefilled cache's shape:
        [L, 1, cap, H, D] -> [L, S, cap, H, D] keys and values, plus the
        static step buffers (their addresses are what the graphs
        replay against, so they are made once)."""
        if self._k is not None:
            return
        shape = list(cache.k.shape)
        shape[1] = self.n_slots
        dev = cache.k.device
        self._k = torch.zeros(shape, dtype=cache.k.dtype, device=dev)
        self._v = torch.zeros(shape, dtype=cache.v.dtype, device=dev)
        self._tok_buf = torch.zeros(self.n_slots, dtype=torch.long,
                                    device=dev)
        self._pos_buf = torch.zeros(self.n_slots, dtype=torch.long,
                                    device=dev)
        self._outs = torch.zeros((self.max_window, self.n_slots),
                                 dtype=torch.long, device=dev)

    def insert(self, slot: int, cache, first_token: int,
               position: int) -> None:
        """Admit a prefilled request into ``slot`` at a step boundary:
        copy its B=1 cache ([L, 1, cap, H, D]) into lane ``slot``
        wholesale (outside any graph) and arm the slot's decode state
        (``first_token`` at ``position`` is the next step's input, the
        sample-first contract of solo generate)."""
        self._ensure_stacked(cache)
        with torch.no_grad():
            self._k[:, slot].copy_(cache.k[:, 0])
            self._v[:, slot].copy_(cache.v[:, 0])
        self.tokens[slot] = first_token
        self.positions[slot] = position

    # -- the step ---------------------------------------------------------

    def _body(self, window: int) -> None:
        """``window`` fused decode steps over the static buffers."""
        from ..models.generate import extract_logits
        from ..models.kv_cache import KVCache

        cache = KVCache(self._k, self._v, positions=self._pos_buf)
        for w in range(window):
            out = self.model(self._tok_buf[:, None], decode=True,
                             decode_position=self._pos_buf, cache=cache)
            nxt = torch.argmax(extract_logits(out)[:, -1], dim=-1)
            self._outs[w].copy_(nxt)
            self._tok_buf.copy_(nxt)
            self._pos_buf.add_(1)

    def _load_state(self) -> None:
        self._tok_buf.copy_(torch.from_numpy(self.tokens))
        self._pos_buf.copy_(torch.from_numpy(self.positions))

    def _capture(self, window: int) -> "torch.cuda.CUDAGraph":
        """Warm the body up on a side stream (the live state: the warm-
        up writes exactly what the replay rewrites), then capture it.
        ``thread_local``: HTTP handler threads may make CUDA calls while
        the engine thread captures, and the global mode would abort."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), torch.no_grad():
            self._body(window)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(
                graph, capture_error_mode="thread_local"):
            self._body(window)
        return graph

    def step(self, window: int = 1, sampled: bool = False, *,
             graph: Optional[bool] = None) -> np.ndarray:
        """``window`` fused decode steps across the whole pool; returns
        the next tokens [window, S] (garbage for idle slots — the
        caller masks by occupancy).  ``graph`` (default: on a CUDA
        pool) replays the window's CUDA graph; ``graph=False`` on the
        card runs the same body eagerly, for comparing the two."""
        if sampled:
            raise NotImplementedError(
                "the sampled step body is not ported yet (ROADMAP "
                "Queue 1: sampled decoding)")
        if self._k is None:
            raise RuntimeError("step() before any insert()")
        if not 1 <= window <= self.max_window:
            raise ValueError(f"window must be in [1, {self.max_window}];"
                             f" got {window}")
        on_card = self._k.device.type == "cuda"
        if graph is None:
            graph = on_card
        if graph and not on_card:
            raise RuntimeError("CUDA graphs need a pool on a CUDA device")
        key = window if graph else ("eager", window)
        fresh = key not in self._built
        if self.sentinel is not None and (graph or not on_card):
            if fresh:
                self.sentinel.miss("slot_step", key)
            else:
                self.sentinel.hit("slot_step", key)
        t0 = time.perf_counter()
        with step_annotation(), torch.no_grad():
            if graph:
                g = self._graphs.get(window)
                if g is None:
                    self._load_state()
                    g = self._graphs[window] = self._capture(window)
                self._load_state()
                g.replay()
            else:
                self._load_state()
                self._body(window)
            outs = self._outs[:window].cpu().numpy().copy()
        self._built.add(key)
        self.last_step_device_s = time.perf_counter() - t0
        # Arm the next step: every slot feeds back its own last token
        # at the next position; idle slots re-park at 0, so their dead
        # stepping stays bounded by one window.
        self.tokens = outs[-1].copy()
        self.positions = self.positions + window
        if self._free:
            idle = np.asarray(self._free, np.int64)
            self.tokens[idle] = 0
            self.positions[idle] = 0
        return outs
