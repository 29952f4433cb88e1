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
tokens by occupancy.  On a ring cache an idle row's table still holds
its last request's positions; none precedes position 0, so the ring's
older-than-the-chunk test masks them all and the idle row attends to
its own tokens alone.

The pool holds whatever the model's cache holds (``generate.init_cache``
builds it from the config): int8 entries with their bf16 scales, which
every body dequantizes as the model reads them, and a ring's per-row
position table, which the body advances on the device.

SPECULATIVE rounds ride the same pool: a second stacked cache (the
DRAFT model's, same slots) sits beside the target's, and the spec body
runs ``window`` rounds, each drafting K tokens per slot (K one-token
draft forwards at the slot's positions ``pos .. pos + K - 1``),
verifying them with ONE K + 1-wide target forward per slot (the
multi-token slot append), and committing a per-slot prefix of ``c``
tokens: the greedy lane's exact match, or the position-keyed
rejection-sampling lane shared with ``generate_speculative``'s seed
mode (``models/generate._spec_draft_row`` / ``_spec_verify_row``).
``c``, the gather of ``out[c - 1]`` as the next feed and ``positions
+= c`` all stay on the device: rejection is a per-slot positions
rewind (stale entries are masked by absolute position), and the host
reads the window's tokens, commits and accepts once, after the
replay.  Slots with ``spec_k == 0`` commit exactly one token a round,
drawn from the verify chunk's first logits row through the shared
positional sampler (the plain bodies' token).  Each (window, "spec",
K, sampled) is one CUDA graph; the greedy-only variant skips the
sampling lanes' shaping and draws.

The paged pool (``serving/paged.py``) runs the same bodies over a
gathered view of its pages (the draft's pages through the same
tables).

On a SERVING MESH (``serving/meshed.py``: ``mesh=``, the model a
``MeshedModel``) each pool is allocated per device at birth
(``ServingMesh.stacked_pool``): a ``ShardedKVCache`` whose shard ``g *
tp + r`` holds heads ``r`` of slot group ``g``'s rows on its device,
and the bodies run unchanged over it — the placed model steps each
group's rows on its shards.  When every shard sits on one physical
device (virtual devices: the card's case) each (window, body) keeps
its one CUDA graph, and steady state captures nothing new.  When the
shards span several physical devices the step runs EAGERLY: a CUDA
graph captures the work of one device's stream, and the mesh's step
is several devices' work, so that is the only schedule there — chosen
from the mesh before anything runs, not a fallback on error.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

# The profiler marker every decode dispatch carries (the reference's
# ``analysis/xprof.py`` STEP_MARKER): trace readers anchor step
# boundaries on it.
STEP_MARKER = "ptpu_step"


# One CUDA-graph capture at a time in the process (StepPool._capture),
# and no device-wide synchronize during one (sync_device).
_CAPTURE_LOCK = threading.Lock()


def sync_device(dev) -> None:
    """Wait for all work queued on ``dev`` (a no-op off the card).  A
    device-wide synchronize that lands inside a capture on another
    thread invalidates that capture (several servers' engines in one
    process: each holds only its own device lock), so it waits for
    ``_CAPTURE_LOCK``, which every capture holds."""
    if dev.type != "cuda":
        return
    with _CAPTURE_LOCK:
        # The sanctioned fence itself.  # ptpu: ignore[HOST-SYNC]
        torch.cuda.synchronize(dev)


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host, detached, in storage of its own (the device
    buffer may be rewritten while the caller keeps it).  The serving
    stack's sanctioned device->host fetch, the reference's
    ``jax.device_get``: it waits for the card, so it is spelled by name
    where a step's outputs come home: the checker's LOCK-HOLD and
    HOST-SYNC count it as the fence it is, and SNAPSHOT-LOCK still
    flags it under the snapshot board's lock."""
    t = t.detach()
    if t.device.type == "cpu":
        return t.clone()
    return t.cpu()  # ptpu: ignore[HOST-SYNC]


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
    # Draft length of a SPECULATIVE slot (0: a plain slot).
    mgr.spec_ks = np.zeros((n,), np.int64)


class StepPool:
    """What both slot pools share: slot accounting, the host decode
    state, its static device twins, the decode bodies and one CUDA
    graph per step key.  Subclasses own the KV storage: ``_cache_for``
    builds the slot cache a step decodes into (``_prepare``/``_finish``
    wrap the body, e.g. the paged pool's gather and scatter)."""

    paged = False

    def __init__(self, model, n_slots: int, sentinel=None,
                 max_window: int = 8, draft_model=None,
                 spec_k_cap: int = 4, mesh=None):
        self.model = model
        # The serving mesh the pool is split over (None: one device).
        self.mesh = mesh
        self.max_window = int(max_window)
        # The draft model of SPECULATIVE slots (None: plain pool), and
        # the widest draft length a spec round may take.
        self.draft_model = draft_model
        self.spec_k_cap = int(spec_k_cap)
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
        self.spec_ks[slot] = 0

    def _arm(self, slot: int, first_token: int, position: int,
             base_key, next_index: int, temperature: float, top_k: int,
             top_p: float, spec_k: int = 0) -> None:
        self.tokens[slot] = first_token
        self.positions[slot] = position
        self.keys[slot] = 0 if base_key is None \
            else np.asarray(base_key, np.int64)
        self.next_index[slot] = next_index
        self.temps[slot] = temperature
        self.top_ks[slot] = top_k
        self.top_ps[slot] = top_p
        self.spec_ks[slot] = spec_k

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
        # The speculative body's operands and outputs: draft lengths,
        # the draft's positions inside a round, and per round the
        # K-wide token window, the commit and the accept counts.
        self._sk_buf = torch.zeros(n, dtype=torch.long, device=dev)
        self._dpos_buf = torch.zeros(n, dtype=torch.long, device=dev)
        kw = (self.max_window, n)
        self._spec_outs = torch.zeros(kw + (self.spec_k_cap,),
                                      dtype=torch.long, device=dev)
        self._commits = torch.zeros(kw, dtype=torch.long, device=dev)
        self._accepts = torch.zeros(kw, dtype=torch.long, device=dev)
        self._bufs = True

    def _load_state(self) -> None:
        for buf, host in ((self._tok_buf, self.tokens),
                          (self._pos_buf, self.positions),
                          (self._key_buf, self.keys),
                          (self._idx_buf, self.next_index),
                          (self._temp_buf, self.temps),
                          (self._topk_buf, self.top_ks),
                          (self._topp_buf, self.top_ps),
                          (self._sk_buf, self.spec_ks)):
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

    def _run_spec_window(self, cache, dcache, window: int, K: int,
                         sampled: bool) -> None:
        """``window`` speculative rounds over the static buffers:
        ``cache`` is the target's slot cache and ``dcache`` the draft's,
        whose positions (``_dpos_buf``) restart at each round's slot
        positions.  Round w writes its K-wide tokens, commits and
        accepts at ``[w]``; every count stays on the device."""
        from ..models.generate import (_sample_positional_row,
                                       _spec_draft_row, _spec_verify_row,
                                       extract_logits)

        lanes = torch.arange(K, device=self._tok_buf.device)
        is_spec = self._sk_buf > 0
        k_eff = self._sk_buf.clamp(1, K)
        samp = (self._key_buf, self._idx_buf, self._temp_buf,
                self._topk_buf, self._topp_buf)
        for w in range(window):
            self._dpos_buf.copy_(self._pos_buf)
            tok, d_toks, q_rows = self._tok_buf, [], []
            for j in range(K):
                out = self.draft_model(tok[:, None], decode=True,
                                       decode_position=self._dpos_buf,
                                       cache=dcache)
                logits = extract_logits(out)[:, -1]
                if sampled:
                    tok, q = _spec_draft_row(
                        logits, self._key_buf, self._idx_buf + j,
                        *samp[2:])
                    q_rows.append(q)
                else:
                    tok = torch.argmax(logits, dim=-1)
                d_toks.append(tok)
                self._dpos_buf.add_(1)
            d_toks = torch.stack(d_toks, dim=1)              # [S, K]
            chunk = torch.cat([self._tok_buf[:, None], d_toks], dim=1)
            t_all = extract_logits(self.model(
                chunk, decode=True, decode_position=self._pos_buf,
                cache=cache))                                # [S, K+1, V]
            if sampled:
                out_toks, c, m = _spec_verify_row(
                    t_all[:, :K], d_toks, torch.stack(q_rows, dim=1),
                    self._key_buf, self._idx_buf, *samp[2:], k_eff)
                plain = _sample_positional_row(t_all[:, 0], *samp)
            else:
                # The greedy lane alone: exact match, then the target's
                # argmax as the correction.
                t_arg = torch.argmax(t_all[:, :K], dim=-1)
                accept = (d_toks == t_arg) & (lanes < k_eff[:, None])
                m = torch.cumprod(accept.long(), dim=1).sum(1)
                c = torch.minimum(m + 1, k_eff)
                out_toks = torch.where(lanes < m[:, None], d_toks, t_arg)
                plain = torch.argmax(t_all[:, 0], dim=-1)
            # Plain lanes commit one token: the plain bodies' token.
            c = torch.where(is_spec, c, 1)
            m = torch.where(is_spec, m, 0)
            out_toks = torch.where(is_spec[:, None], out_toks,
                                   torch.where(lanes == 0, plain[:, None],
                                               0))
            self._spec_outs[w, :, :K].copy_(out_toks)
            self._commits[w].copy_(c)
            self._accepts[w].copy_(m)
            self._tok_buf.copy_(out_toks.gather(1, (c - 1)[:, None])[:, 0])
            self._pos_buf.add_(c)
            self._idx_buf.add_(c)

    def _capture_state(self) -> list:
        """The tensors a capture's warm-up must leave as it found them:
        none here (the subclass with a ring names its cache)."""
        return []

    def _run_restoring(self, body: Callable[[], None]) -> None:
        """Run ``body``, then put back every ``_capture_state`` tensor."""
        state = self._capture_state()
        saved = [t.clone() for t in state]
        body()
        for t, s in zip(state, saved):
            t.copy_(s)

    def _capture(self, body: Callable[[], None]
                 ) -> "torch.cuda.CUDAGraph":
        """Warm ``body`` up on a side stream (the live state: on a plain
        or int8 cache the warm-up writes exactly what the replay
        rewrites; a ring's is restored after it), then capture it into
        the pool's shared graph memory.  ``thread_local``: HTTP handler
        threads may make CUDA calls while the engine thread captures,
        and the global mode would abort.  Captures are also serialized
        across every pool in the process (``_CAPTURE_LOCK``): several
        servers' engines in one process (a ``LocalReplica`` fleet) would
        otherwise capture at once, and one capture's set-up (the device
        sync and allocator flush ``torch.cuda.graph`` does on entry)
        must not land inside another's capture."""
        with _CAPTURE_LOCK:
            return self._capture_locked(body)

    def _capture_locked(self, body: Callable[[], None]
                        ) -> "torch.cuda.CUDAGraph":
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), torch.no_grad():
            self._run_restoring(body)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.no_grad(), torch.cuda.graph(
                graph, pool=self._graph_pool,
                capture_error_mode="thread_local"):
            body()
        return graph

    def _step_key(self, window: int, sampled: bool) -> tuple:
        return (window, sampled)

    def _replay(self, key: tuple, body: Callable[[], None], fetch, *,
                graph: Optional[bool], on_card: bool):
        """Run ``body`` through the graph of ``key`` (captured on first
        use) or eagerly, and return ``fetch()`` (the host copy of its
        outputs: the one sync of the window)."""
        graphable = self.mesh is None or self.mesh.graphable
        if graph is None:
            graph = on_card and graphable
        if graph and not on_card:
            raise RuntimeError("CUDA graphs need a pool on a CUDA device")
        if graph and not graphable:
            raise RuntimeError(
                f"a CUDA graph captures one device's stream; this pool's "
                f"mesh spans {len(self.mesh.physical_devices)} devices")
        built_key = key if graph else ("eager",) + key
        fresh = built_key not in self._built
        if self.sentinel is not None and (graph or not on_card):
            if fresh:
                self.sentinel.miss("slot_step", key)
            else:
                self.sentinel.hit("slot_step", key)
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
            out = fetch()
        self._built.add(built_key)
        # fetch() waits for the card (host_copy): the delta is honest.
        # ptpu: ignore[TIME-TRUTH]
        self.last_step_device_s = time.perf_counter() - t0
        return out

    def _advance(self, last_tokens: np.ndarray, adv) -> None:
        """Arm the next step: every slot feeds back its own last token
        at its next position and token index; idle slots re-park at 0,
        so their dead stepping stays bounded by one window."""
        self.tokens = np.asarray(last_tokens, np.int64).copy()
        self.positions = self.positions + adv
        self.next_index = self.next_index + adv
        if self._free:
            idle = np.asarray(self._free, np.int64)
            self.tokens[idle] = 0
            self.positions[idle] = 0
            self.next_index[idle] = 0

    def _dispatch(self, key: tuple, body: Callable[[], None], *,
                  graph: Optional[bool], on_card: bool) -> np.ndarray:
        """One plain window; returns ``outs`` [window, S] on the host."""
        window = key[0]
        outs = self._replay(
            key, body, lambda: host_copy(self._outs[:window]).numpy(),
            graph=graph, on_card=on_card)
        self._advance(outs[-1], window)
        return outs

    def _dispatch_spec(self, key: tuple, body: Callable[[], None], *,
                       window: int, K: int, graph: Optional[bool],
                       on_card: bool):
        """One speculative window; returns ``(tokens [window, S, K],
        commits [window, S], accepts [window, S])`` on the host."""
        def fetch():
            return tuple(host_copy(t).numpy() for t in (
                self._spec_outs[:window, :, :K], self._commits[:window],
                self._accepts[:window]))

        toks, cs, ms = self._replay(key, body, fetch, graph=graph,
                                    on_card=on_card)
        rows = np.arange(self.n_slots)
        self._advance(toks[-1, rows, cs[-1] - 1], cs.sum(axis=0))
        return toks, cs, ms

    def _check_spec(self, window: int, K: int) -> None:
        self._check_window(window)
        if self.draft_model is None:
            raise RuntimeError(
                "speculative step without a draft model (construct the "
                "slot pool with draft_model)")
        if not 1 <= K <= self.spec_k_cap:
            raise ValueError(f"spec K must be in [1, {self.spec_k_cap}];"
                             f" got {K}")

    def _check_window(self, window: int) -> None:
        if not 1 <= window <= self.max_window:
            raise ValueError(f"window must be in [1, {self.max_window}];"
                             f" got {window}")


class SlotKVManager(StepPool):
    """Fixed pool of ``n_slots`` decode slots over one model.

    Owns the stacked cache (``models/kv_cache.KVCache`` with [L, S, cap,
    H, D] keys and values, an int8 cache's [L, S, cap, H, 1] scales, a
    ring cache's [S, cap] position table; made on the first insert), with
    ``draft_model`` the draft's stacked cache too (made on the first
    speculative insert), the free-slot list, the static step buffers and
    one CUDA graph per step key.  A ring model's lane is its ring:
    ``window + 1 + slack`` positions whatever the session's length.
    Device work only — request bookkeeping lives in
    engine.py/scheduler.py."""

    def __init__(self, model, n_slots: int, sentinel=None,
                 max_window: int = 8, draft_model=None,
                 spec_k_cap: int = 4, mesh=None):
        super().__init__(model, n_slots, sentinel=sentinel,
                         max_window=max_window, draft_model=draft_model,
                         spec_k_cap=spec_k_cap, mesh=mesh)
        self._pool = None           # the stacked cache (no positions)
        self._dpool = None          # the draft's

    @staticmethod
    def _leaf(pool, i: int) -> Optional[torch.Tensor]:
        """Leaf ``i`` of ``pool`` (keys 0, values 1; a sharded pool's
        first shard's)."""
        return None if pool is None else pool.leaves()[i]

    @property
    def _k(self) -> Optional[torch.Tensor]:
        return self._leaf(self._pool, 0)

    @property
    def _v(self) -> Optional[torch.Tensor]:
        return self._leaf(self._pool, 1)

    @property
    def _dk(self) -> Optional[torch.Tensor]:
        return self._leaf(self._dpool, 0)

    @property
    def _dv(self) -> Optional[torch.Tensor]:
        return self._leaf(self._dpool, 1)

    def reset(self) -> None:
        """Crash-recovery rebuild (recovery.EngineSupervisor): every
        slot free, every slot's decode state parked — host state only.
        The stacked caches and the step buffers keep their addresses,
        which is what the captured graphs replay against: stale lanes
        are masked by position until the next insert overwrites them
        wholesale, so a supervised restart captures nothing new."""
        self._free = list(range(self.n_slots))
        alloc_decode_state(self)

    # -- device state ---------------------------------------------------

    def _stacked_like(self, cache):
        """A B=1 cache -> the zeroed [L, S, ...] stacked pool of the
        same kind (a ring table of -1: no slot written); on a mesh,
        allocated per device at birth (``ServingMesh.stacked_pool``)."""
        if self.mesh is not None:
            return self.mesh.stacked_pool(cache, self.n_slots)
        return cache.stacked(self.n_slots)

    def _ensure_stacked(self, cache) -> None:
        """Allocate the pool from the FIRST prefilled cache's shape,
        plus the static step buffers."""
        if self._pool is not None:
            return
        self._pool = self._stacked_like(cache)
        self._alloc_step_buffers(cache.device)

    def _ensure_draft_stacked(self, cache) -> None:
        if self._dpool is None:
            self._dpool = self._stacked_like(cache)

    def _capture_state(self) -> list:
        """A ring's entries and position tables, the draft's too: a
        window writes each row's ring at ``position % cap`` ahead of
        the position the replay starts from, overwriting entries still
        inside the window there (a plain cache only writes past it)."""
        return [t for pool in (self._pool, self._dpool)
                if pool is not None for t in pool.ring_tensors()]

    def insert(self, slot: int, cache, first_token: int,
               position: int, *, base_key=None, next_index: int = 1,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 0.0, draft_cache=None,
               spec_k: int = 0) -> None:
        """Admit a prefilled request into ``slot`` at a step boundary:
        copy its B=1 cache (every [L, 1, cap, ...] tensor, and a ring's
        position table) into lane ``slot`` wholesale (outside any graph)
        and arm the slot's decode state (``first_token`` at
        ``position`` is the next step's input, the sample-first
        contract of solo generate).  Sampled streams also arm
        ``base_key`` (``fold_in(PRNGKey(seed), row)``, two words) and
        ``next_index`` (the token index the next step draws); greedy
        streams keep temperature 0, the argmax lane.  Speculative
        streams pass ``draft_cache`` (the draft's prefill of the same
        prompt) and ``spec_k`` > 0."""
        self._ensure_stacked(cache)
        with torch.no_grad():
            self._pool.copy_lane(slot, cache)
            if draft_cache is not None:
                self._ensure_draft_stacked(draft_cache)
                self._dpool.copy_lane(slot, draft_cache)
        self._arm(slot, first_token, position, base_key, next_index,
                  temperature, top_k, top_p, spec_k)

    # -- the step ---------------------------------------------------------

    def _body(self, window: int, sampled: bool = False) -> None:
        """``window`` fused decode steps over the static buffers."""
        self._run_window(self._pool.at_positions(self._pos_buf), window,
                         sampled)

    def step(self, window: int = 1, sampled: bool = False, *,
             graph: Optional[bool] = None) -> np.ndarray:
        """``window`` fused decode steps across the whole pool; returns
        the next tokens [window, S] (garbage for idle slots — the
        caller masks by occupancy).  ``sampled`` selects the sampled
        body (the engine sets it when any resident samples).  ``graph``
        (default: on a CUDA pool) replays the CUDA graph of (window,
        sampled); ``graph=False`` on the card runs the same body
        eagerly, for comparing the two."""
        if self._pool is None:
            raise RuntimeError("step() before any insert()")
        self._check_window(window)
        return self._dispatch(
            self._step_key(window, sampled),
            lambda: self._body(window, sampled), graph=graph,
            on_card=self._pool.device.type == "cuda")

    def _spec_body(self, window: int, K: int, sampled: bool) -> None:
        self._run_spec_window(self._pool.at_positions(self._pos_buf),
                              self._dpool.at_positions(self._dpos_buf),
                              window, K, sampled)

    def step_spec(self, window: int, K: int, sampled: bool = False, *,
                  graph: Optional[bool] = None):
        """``window`` fused SPECULATIVE rounds across the whole pool.
        Returns ``(tokens [window, S, K], commits [window, S], accepts
        [window, S])``: round w commits ``tokens[w, s, :commits[w, s]]``
        for slot s (1 for a plain slot, garbage for an idle one — the
        caller masks by occupancy), and ``accepts`` counts the accepted
        draft tokens.  ``K`` is the round's draft width, the largest
        resident ``spec_k``; a slot with a smaller one commits at most
        its own.  ``sampled`` selects the body with the sampling lanes
        (any resident samples).  One CUDA graph per (window, "spec", K,
        sampled)."""
        if self._pool is None or self._dpool is None:
            raise RuntimeError("step_spec() before a speculative "
                               "insert()")
        self._check_spec(window, K)
        return self._dispatch_spec(
            (window, "spec", K, sampled),
            lambda: self._spec_body(window, K, sampled), window=window,
            K=K, graph=graph, on_card=self._pool.device.type == "cuda")
