"""Slot-indexed KV memory for the continuous-batching engine.

Port of ``polyaxon_tpu/serving/slots.py``'s fixed-lane pool (greedy
and sampled steps).  The reference stacks S per-request caches on a
slot axis and steps them with ``lax.scan`` over a ``vmap`` of a B=1
decode, each slot at its own ``cache_index``.  Here the pool is ONE
[S]-row cache (``models/kv_cache.KVCache`` with per-row ``positions``)
and a step is a batched decode of ``tokens[:, None]`` at
``positions``: the per-row scatter writes each slot's K/V at its own
position, the [S, 1, 1, cap] mask admits each row's own prefix, and
``wpe`` is gathered per row.

A WINDOW of W fused decode steps (W a power of two up to the engine's
``decode_window``) runs W times: forward, token choice, the write into
``outs[w]``, the feedback into ``tokens`` and ``positions += 1``.  Two
bodies choose the token: the GREEDY body takes the argmax over the
vocab; the SAMPLED body, selected whenever a resident samples, draws
every slot through the shared position-keyed sampler
(``models/generate._sample_positional_row``) with the slot's own base
key, next token index, temperature, top-k and top-p (the index
advances inside the window), and greedy co-tenants take its argmax
lane.  On the card each (window, body) is one CUDA graph over static
buffers (the stacked cache, the per-slot state and ``outs``, whose
addresses never change; all graphs share one memory pool): captured
on first use (a counted MISS), replayed after (a HIT), so a window
costs one replay and one host sync whatever W is.  On a CPU tensor the
same body runs eagerly.  A failed capture raises: nothing falls back to
the eager loop on the card.

Idle slots still step (the batch shape is fixed): they sit at position
0, decode garbage into their own lane (never past ``cap``), and the
next ``insert`` overwrites the lane wholesale; the engine masks their
tokens by occupancy.

The paged pool (``serving/paged.py``) runs the same bodies over a
gathered view of its pages.  The speculative step comes with its own
slice of the port.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

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


def alloc_decode_state(mgr) -> None:
    """(Re)allocate the host-side per-slot decode state the step
    consumes: feedback token and absolute position, and the sampled
    body's operands (base key, next token index, temperature, top-k,
    top-p: inert zeros for greedy and idle slots).  One helper for both
    pools, so a field added here reaches both."""
    n = mgr.n_slots
    mgr.tokens = np.zeros((n,), np.int64)
    mgr.positions = np.zeros((n,), np.int64)
    mgr.keys = np.zeros((n, 2), np.int64)
    mgr.next_index = np.zeros((n,), np.int64)
    mgr.temps = np.zeros((n,), np.float32)
    mgr.top_ks = np.zeros((n,), np.int64)
    mgr.top_ps = np.zeros((n,), np.float32)


class StepPool:
    """What both slot pools share: slot accounting, the host decode
    state, its static device twins, the decode bodies and one CUDA
    graph per step key.  Subclasses own the KV storage: ``_cache_for``
    builds the slot cache a step decodes into (``_prepare``/``_finish``
    wrap the body, e.g. the paged pool's gather and scatter)."""

    paged = False

    def __init__(self, model, n_slots: int, sentinel=None,
                 max_window: int = 8):
        self.model = model
        self.max_window = int(max_window)
        # Recompile sentinel (analysis/recompile.py): a step key's graph
        # capture (its first eager run on the CPU) is a MISS, a replay
        # a HIT — after warm-up the count of captures must stay put.
        self.sentinel = sentinel
        self.n_slots = int(n_slots)
        self._free = list(range(self.n_slots))
        self._graphs: Dict[tuple, torch.cuda.CUDAGraph] = {}
        self._built: set = set()       # step keys run at least once
        self._graph_pool = None        # one memory pool for all graphs
        self._bufs = False
        alloc_decode_state(self)
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
        """Evict: the slot is reusable the SAME step.  It parks at
        position 0 with zeroed sampling state, so its idle stepping
        stays in range and takes the cheap greedy lane."""
        if slot in self._free:
            raise ValueError(f"slot {slot} already free")
        self._free.append(slot)
        self._free.sort()
        self.tokens[slot] = 0
        self.positions[slot] = 0
        self.keys[slot] = 0
        self.next_index[slot] = 0
        self.temps[slot] = 0.0
        self.top_ks[slot] = 0
        self.top_ps[slot] = 0.0

    def _arm(self, slot: int, first_token: int, position: int,
             base_key, next_index: int, temperature: float, top_k: int,
             top_p: float) -> None:
        self.tokens[slot] = first_token
        self.positions[slot] = position
        self.keys[slot] = 0 if base_key is None \
            else np.asarray(base_key, np.int64)
        self.next_index[slot] = next_index
        self.temps[slot] = temperature
        self.top_ks[slot] = top_k
        self.top_ps[slot] = top_p

    # -- static step buffers ----------------------------------------------

    def _alloc_step_buffers(self, dev) -> None:
        """The device twins of the host decode state, and ``outs``:
        their addresses are what the graphs replay against, so they are
        made once."""
        n = self.n_slots
        self._tok_buf = torch.zeros(n, dtype=torch.long, device=dev)
        self._pos_buf = torch.zeros(n, dtype=torch.long, device=dev)
        self._key_buf = torch.zeros((n, 2), dtype=torch.long, device=dev)
        self._idx_buf = torch.zeros(n, dtype=torch.long, device=dev)
        self._temp_buf = torch.zeros(n, dtype=torch.float32, device=dev)
        self._topk_buf = torch.zeros(n, dtype=torch.long, device=dev)
        self._topp_buf = torch.zeros(n, dtype=torch.float32, device=dev)
        self._outs = torch.zeros((self.max_window, n), dtype=torch.long,
                                 device=dev)
        self._bufs = True

    def _load_state(self) -> None:
        for buf, host in ((self._tok_buf, self.tokens),
                          (self._pos_buf, self.positions),
                          (self._key_buf, self.keys),
                          (self._idx_buf, self.next_index),
                          (self._temp_buf, self.temps),
                          (self._topk_buf, self.top_ks),
                          (self._topp_buf, self.top_ps)):
            buf.copy_(torch.from_numpy(host))

    # -- the step ---------------------------------------------------------

    def _run_window(self, cache, window: int, sampled: bool) -> None:
        """``window`` fused decode steps into ``cache`` over the static
        buffers: the greedy body (argmax) or the sampled one."""
        from ..models.generate import _sample_positional_row, \
            extract_logits

        for w in range(window):
            out = self.model(self._tok_buf[:, None], decode=True,
                             decode_position=self._pos_buf, cache=cache)
            logits = extract_logits(out)[:, -1]
            if sampled:
                nxt = _sample_positional_row(
                    logits, self._key_buf, self._idx_buf, self._temp_buf,
                    self._topk_buf, self._topp_buf)
                self._idx_buf.add_(1)
            else:
                nxt = torch.argmax(logits, dim=-1)
            self._outs[w].copy_(nxt)
            self._tok_buf.copy_(nxt)
            self._pos_buf.add_(1)

    def _capture(self, body: Callable[[], None]
                 ) -> "torch.cuda.CUDAGraph":
        """Warm ``body`` up on a side stream (the live state: the warm-
        up writes exactly what the replay rewrites), then capture it
        into the pool's shared graph memory.  ``thread_local``: HTTP
        handler threads may make CUDA calls while the engine thread
        captures, and the global mode would abort."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), torch.no_grad():
            body()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(
                graph, pool=self._graph_pool,
                capture_error_mode="thread_local"):
            body()
        return graph

    def _step_key(self, window: int, sampled: bool) -> tuple:
        return (window, sampled)

    def _dispatch(self, key: tuple, body: Callable[[], None], *,
                  graph: Optional[bool], on_card: bool) -> np.ndarray:
        """One window through the graph of ``key`` (captured on first
        use) or eagerly; returns ``outs`` on the host."""
        if graph is None:
            graph = on_card
        if graph and not on_card:
            raise RuntimeError("CUDA graphs need a pool on a CUDA device")
        built_key = key if graph else ("eager",) + key
        fresh = built_key not in self._built
        if self.sentinel is not None and (graph or not on_card):
            if fresh:
                self.sentinel.miss("slot_step", key)
            else:
                self.sentinel.hit("slot_step", key)
        window = key[0]
        t0 = time.perf_counter()
        with step_annotation(), torch.no_grad():
            if graph:
                g = self._graphs.get(key)
                if g is None:
                    self._load_state()
                    g = self._graphs[key] = self._capture(body)
                self._load_state()
                g.replay()
            else:
                self._load_state()
                body()
            outs = self._outs[:window].cpu().numpy().copy()
        self._built.add(built_key)
        self.last_step_device_s = time.perf_counter() - t0
        # Arm the next step: every slot feeds back its own last token
        # at the next position and token index; idle slots re-park at
        # 0, so their dead stepping stays bounded by one window.
        self.tokens = outs[-1].copy()
        self.positions = self.positions + window
        self.next_index = self.next_index + window
        if self._free:
            idle = np.asarray(self._free, np.int64)
            self.tokens[idle] = 0
            self.positions[idle] = 0
            self.next_index[idle] = 0
        return outs

    def _check_window(self, window: int) -> None:
        if not 1 <= window <= self.max_window:
            raise ValueError(f"window must be in [1, {self.max_window}];"
                             f" got {window}")


class SlotKVManager(StepPool):
    """Fixed pool of ``n_slots`` decode slots over one model.

    Owns the stacked cache ([L, S, cap, H, D] keys and values, made on
    the first insert), the free-slot list, the static step buffers and
    one CUDA graph per (window, body).  Device work only — request
    bookkeeping lives in engine.py/scheduler.py."""

    def __init__(self, model, n_slots: int, sentinel=None,
                 max_window: int = 8):
        super().__init__(model, n_slots, sentinel=sentinel,
                         max_window=max_window)
        self._k: Optional[torch.Tensor] = None
        self._v: Optional[torch.Tensor] = None

    # -- device state ---------------------------------------------------

    def _ensure_stacked(self, cache) -> None:
        """Allocate the pool from the FIRST prefilled cache's shape:
        [L, 1, cap, H, D] -> [L, S, cap, H, D] keys and values, plus the
        static step buffers."""
        if self._k is not None:
            return
        shape = list(cache.k.shape)
        shape[1] = self.n_slots
        dev = cache.k.device
        self._k = torch.zeros(shape, dtype=cache.k.dtype, device=dev)
        self._v = torch.zeros(shape, dtype=cache.v.dtype, device=dev)
        self._alloc_step_buffers(dev)

    def insert(self, slot: int, cache, first_token: int,
               position: int, *, base_key=None, next_index: int = 1,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 0.0) -> None:
        """Admit a prefilled request into ``slot`` at a step boundary:
        copy its B=1 cache ([L, 1, cap, H, D]) into lane ``slot``
        wholesale (outside any graph) and arm the slot's decode state
        (``first_token`` at ``position`` is the next step's input, the
        sample-first contract of solo generate).  Sampled streams also
        arm ``base_key`` (``fold_in(PRNGKey(seed), row)``, two words)
        and ``next_index`` (the token index the next step draws);
        greedy streams keep temperature 0, the argmax lane."""
        self._ensure_stacked(cache)
        with torch.no_grad():
            self._k[:, slot].copy_(cache.k[:, 0])
            self._v[:, slot].copy_(cache.v[:, 0])
        self._arm(slot, first_token, position, base_key, next_index,
                  temperature, top_k, top_p)

    # -- the step ---------------------------------------------------------

    def _body(self, window: int, sampled: bool = False) -> None:
        """``window`` fused decode steps over the static buffers."""
        from ..models.kv_cache import KVCache

        self._run_window(KVCache(self._k, self._v,
                                 positions=self._pos_buf),
                         window, sampled)

    def step(self, window: int = 1, sampled: bool = False, *,
             graph: Optional[bool] = None) -> np.ndarray:
        """``window`` fused decode steps across the whole pool; returns
        the next tokens [window, S] (garbage for idle slots — the
        caller masks by occupancy).  ``sampled`` selects the sampled
        body (the engine sets it when any resident samples).  ``graph``
        (default: on a CUDA pool) replays the CUDA graph of (window,
        sampled); ``graph=False`` on the card runs the same body
        eagerly, for comparing the two."""
        if self._k is None:
            raise RuntimeError("step() before any insert()")
        self._check_window(window)
        return self._dispatch(
            self._step_key(window, sampled),
            lambda: self._body(window, sampled), graph=graph,
            on_card=self._k.device.type == "cuda")
