"""Model server: the port's decode stack behind HTTP.

Port of ``polyaxon_tpu/serving/server.py``.  With ``batching=
"continuous"`` (the default) every request, greedy or sampled, becomes
per-row decode streams through the continuous-batching engine
(engine.py) over the fixed-lane slot pool (slots.py) or, with
``kv_paged``, the paged pool (paged.py), and the front-end sheds load
with 429 + Retry-After once the bounded admission queue fills.
``batching="coalesce"`` selects the legacy whole-request coalescer
(legacy.py: plain greedy requests of one prompt length merge into one
solo ``generate`` batch; every other request decodes solo) and
``batching="off"`` serializes every request on the solo programs —
the measured A/B baselines of the engine; neither has an engine, so
``kv_paged``, ``profile_every`` and ``stall_timeout_s`` need
``continuous``.  One process, stdlib HTTP.
The model may hold int8 weights (``ops/quant.py``) and an int8 or ring
KV cache (its config): a ring model's requests skip the
``max_position`` budget (its sessions stream past it), and a
speculative one on it needs ``kv_cache_ring_slack >= spec_k - 1``.

PREFIX CACHE (``prefix_cache`` entries, default 4; 0 disables): ``POST
/prefill`` stores a prompt's prefill in a radix index (radix.py), and a
later request whose prompt starts with a stored entry prefills only
its suffix.  Single-row hits ride the engine seeded with the stored
prefill; on the paged pool the entry's pages live in the page pool
and every hit maps its full pages read-only (copy-on-write: N hits
hold one copy).  Multi-row hits decode on the solo split path.  The
store is an optimization: a failing lookup or store disables it with
a counter (``prefix_store_errors``), never the request.

FAULT CONTAINMENT: ``fault_plan`` arms the seeded fault-injection
harness (faults.py) across the engine, the prefix store and the
handler's response write; ``supervise`` (default on) attaches the
``EngineSupervisor``: an engine crash requeues everything for
token-identical resume and restarts the loop (the recovery hook
flushes the paged prefix index, whose pages died with the pool), and a
crash storm opens the breaker (``/healthz`` 503 ``engine_down``).

Endpoints:

- ``GET  /healthz``  -> ``{"status": "ok", ...}`` (readiness; 503
  ``{"status": "unavailable", "reason": "draining" | "engine_down"}``
  after /drain, or while the engine is down)
- ``GET  /info``     -> model name, config summary, engine counters
- ``GET  /metrics``  -> Prometheus text: counters, phase summaries,
  latency histograms (telemetry.py), engine gauges
- ``GET  /trace``    -> Chrome trace-event JSON of the telemetry ring
- ``GET  /anomalies`` -> the anomaly sentry's findings and baselines
  (400 with forensics off)
- ``GET  /debug/exemplars`` -> every latency histogram's per-bucket
  request-ID exemplars
- ``GET  /requests[?status=&limit=]``, ``GET /requests/<id>`` -> the
  terminal-record retention ring (debug.py)
- ``GET  /debug/state`` -> the engine's latest step-boundary snapshot
- ``POST /generate`` -> ``{"prompt": [ids] | [[ids], ...],
  "max_new_tokens": N, "temperature": t, "top_k": k, "top_p": p,
  "seed": s, "eos_id": e, "num_beams": B, "speculative": bool,
  "spec_k": K, "prefill_chunk": C, "priority": p, "deadline_ms": d,
  "timings": bool}`` -> tokens + timing
- ``POST /prefill``  -> ``{"prompt": ..., "prefill_chunk": C}``:
  register a prefix -> ``{"cached_rows", "cached_len", "entries"}``
- ``POST /drain``    -> stop admission, finish in-flight work
- ``POST /profile/start|stop`` -> the single-flight torch.profiler trace
  into ``profile_dir`` (400 without one, 409 on a conflict)
- ``GET  /profile/report`` -> the flight recorder's latest records

``temperature > 0`` samples under the position-keyed contract (row r's
i-th token draws with ``fold_in(fold_in(PRNGKey(seed), r), i)``), so a
response equals solo ``generate_positional`` with the same seed — cold
or from a prefix hit.  ``"speculative": true`` (a server built with a
``draft_model``) decodes in the engine's speculative slots: greedy by
default, equal to greedy decoding, and with temperature rejection
speculative sampling under the position-keyed schedule, equal to solo
``generate_speculative``'s seed mode; ``spec_k`` (default and cap: the
server's ``spec_k``) is the draft length.  A ``spec_k`` over the cap,
and on a draft-capable server any request within ``spec_k - 1`` tokens
of ``max_position``, decodes on the SOLO path instead (counted and
reported under ``/info`` ``solo_fallbacks``), as does every
``num_beams > 1`` request (``generate_beam``): solo programs hold the
device lock for their whole decode.  A request for what the port does
not serve gets a 501 naming the missing feature, never another
route's answer.  Validation errors are the reference's 400s.

PROFILING: ``profile_dir`` enables ``POST /profile/start|stop``, a
single-flight ``torch.profiler`` trace written under it (400 without
it, 409 on a second start); ``profile_every`` N arms the FLIGHT
RECORDER (profiling.py): every N decode dispatches it profiles
``profile_steps`` of them, attributes the trace's kernels, memcpys and
memsets (analysis/xprof.py) and publishes the shares — ``GET
/profile/report``, ``/metrics`` gauges, the ``/info`` ``profiling``
block.

HOST TIER (``kv_host_spill_bytes`` > 0, paged only): page-pressure
eviction SPILLS a stored prefix to host tensors (``spill_pages``)
instead of dropping it, within a byte budget (coldest host entries go
first); a later hit rematerializes it (``source="host"``,
``prefix_source: "local_spilled"``) and promotes it back to pages when
the pool has room.  Host entries survive a crash-recovery pool rebuild.

FLEET PREFIX TIER (paged servers): ``POST /prefix/fetch`` serves a stored
entry as a checksummed wire blob (paged.py's format), ``/prefix/ingest``
stores one as a host entry, ``/prefix/handoff`` pushes this replica's
entries to a successor (a drain), ``/prefix/evict`` drops named host
entries, ``GET /prefix/index`` lists them.  With ``prefix_fetch`` a
local miss carrying a router ``prefix_hint`` fetches the holder's entry
when :class:`PrefixFetchPolicy` says the wire beats a re-prefill
(``prefix_source: "wire_fetch"``); every failure is a counted
re-prefill.  ``role``: ``both`` (monolithic), ``prefill`` (``/prefill``
and the wire lanes only; ``/generate`` is a 400) or ``decode`` (admits
handed-off prefills over the fetch lane).  ``resume_tokens: N`` replays a
request whose trailing N prompt tokens are a prior attempt's output;
the engine resumes it token-identically (a router's failover).

Device discipline: every CUDA call runs under ``device_lock`` (a
FairLock): the engine thread's, and the prefix paths' on handler
threads (``/prefill``, a hit's materialize, a store's page scatter, the
multi-row solo decode), each of which synchronizes the device before
it lets the lock go.
"""

from __future__ import annotations

import collections
import copy
import json
import select
import socket
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..models.generate import _is_ring
from ..ops.quant import has_quantized
from ._lru import lru_get
from .debug import (RequestHistory, StallWatchdog, events_to_dicts,
                    new_request_id, sanitize_request_id)
from .engine import DecodeEngine
from .faults import FaultPlan, SocketReset
from .forensics import ForensicsCore, compute_ledger
from .paged import WirePayloadError, pack_spilled, unpack_spilled
from .radix import RadixPrefixIndex
from .recovery import EngineSupervisor
from .scheduler import (DeadlineExceeded, PRIORITIES, PoisonedRequest,
                        QueueFullError, RequestCancelled, SamplingSpec,
                        SchedulerPolicy, ShedError)
from .slots import host_copy, sync_device
from .legacy import RequestCoalescer
from .telemetry import (ProfileSession, Telemetry, render_compile_cache,
                        render_histogram)

_span_dicts = events_to_dicts

# Disaggregated-serving roles: "both" = monolithic (the default),
# "prefill" = prompt prefill and wire export only (rejects /generate),
# "decode" = full serving that admits handed-off prefills over the
# wire-fetch lane.
ROLES = ("prefill", "decode", "both")
BATCHING_MODES = ("continuous", "coalesce", "off")


def _nbytes(t) -> int:
    """Bytes of a host tensor (0 for an index leaf's None)."""
    return 0 if t is None else t.numel() * t.element_size()


class _PagedPrefix:
    """Radix payload of a PAGE-BACKED prefix entry: the stored prompt's
    KV lives in the engine's page pool (one reference per page held by
    this entry; pages shared with an ancestor entry are referenced,
    never copied); ``logits`` are the last-position prefill logits."""

    __slots__ = ("pages", "n_tokens", "logits")

    def __init__(self, pages, n_tokens: int, logits):
        self.pages = tuple(int(p) for p in pages)
        self.n_tokens = int(n_tokens)
        self.logits = logits


class _SpilledPrefix:
    """Radix payload of a HOST-TIER prefix entry (``kv_host_spill_
    bytes``): the stored prompt's KV in host memory — one tensor per
    paged cache tensor in the wire order (``spill_pages``), gathered
    when page pressure evicted the entry from the pool — instead of
    dropped.  A hit rematerializes it (``rematerialize``) and promotes it
    back to pages when it can.  Host tensors reference no device state,
    so spilled entries survive a crash-recovery pool rebuild."""

    __slots__ = ("leaves", "n_tokens", "logits", "nbytes")

    def __init__(self, leaves, n_tokens: int, logits):
        self.leaves = list(leaves)
        self.n_tokens = int(n_tokens)
        self.logits = logits            # host copy
        self.nbytes = sum(_nbytes(a) for a in self.leaves) \
            + _nbytes(logits)


PrefixHit = collections.namedtuple(
    "PrefixHit", ["p_cached", "logits", "cache", "pins", "source"],
    defaults=("device",))
"""One prefix-cache lookup result: ``p_cached`` tokens of stored
prefill, the stored last-position ``logits``, a PRIVATE contiguous
``cache`` holding them (a clone of a fixed-lane entry, or gathered from
the pool's pages: the hit extends it in place), and ``pins`` — pinned
FULL-page ids the engine maps read-only into the admitted slot (empty
for contiguous entries).  The caller owns the pins until
``engine.submit(shared_pages=pins)`` returns; every other outcome must
unpin them.  ``source`` is the tier that served the hit (``"device"``
or ``"host"``)."""


class PrefixFetchPolicy:
    """The wire-fetch cost curve: fetch a spilled prefix from a holder
    replica only when the expected wire cost beats a local re-prefill::

        rtt + nbytes / wire_bytes_per_s + remat_ratio * reprefill
            < reprefill,   where reprefill = n_tokens / prefill_tok_per_s

    plus two hard gates — a minimum match length and a byte ceiling.
    The client evaluates it before dialing (``nbytes=0``) and again on
    the holder's Content-Length before reading the body.  The defaults
    are the reference's."""

    def __init__(self, *, min_tokens: int = 16,
                 max_bytes: int = 1 << 30,
                 wire_bytes_per_s: float = 1e9,
                 rtt_s: float = 2e-3,
                 prefill_tok_per_s: float = 4e3,
                 remat_ratio: float = 0.26):
        if min_tokens < 1:
            raise ValueError(
                f"min_tokens must be >= 1; got {min_tokens}")
        if max_bytes < 1:
            raise ValueError(
                f"max_bytes must be >= 1; got {max_bytes}")
        if wire_bytes_per_s <= 0 or prefill_tok_per_s <= 0:
            raise ValueError(
                "wire_bytes_per_s and prefill_tok_per_s must be > 0")
        if rtt_s < 0 or not 0.0 <= remat_ratio < 1.0:
            raise ValueError(
                "need rtt_s >= 0 and 0 <= remat_ratio < 1")
        self.min_tokens = int(min_tokens)
        self.max_bytes = int(max_bytes)
        self.wire_bytes_per_s = float(wire_bytes_per_s)
        self.rtt_s = float(rtt_s)
        self.prefill_tok_per_s = float(prefill_tok_per_s)
        self.remat_ratio = float(remat_ratio)

    def should_fetch(self, n_tokens: int, nbytes: int, *,
                     wire_bytes_per_s: Optional[float] = None,
                     rtt_s: Optional[float] = None
                     ) -> Tuple[bool, str]:
        """``(ok, reason)``: ``reason`` is the typed veto (the
        ``prefix_fetch_failed_total{reason=}`` label) or ``"ok"``.
        ``wire_bytes_per_s``/``rtt_s`` override the constants for one
        evaluation (the router's measured link estimates)."""
        if n_tokens < self.min_tokens:
            return False, "below_min_tokens"
        if nbytes > self.max_bytes:
            return False, "over_max_bytes"
        bw = self.wire_bytes_per_s if wire_bytes_per_s is None \
            or wire_bytes_per_s <= 0 else float(wire_bytes_per_s)
        rtt = self.rtt_s if rtt_s is None or rtt_s < 0 \
            else float(rtt_s)
        reprefill_s = n_tokens / self.prefill_tok_per_s
        wire_s = (rtt + nbytes / bw
                  + self.remat_ratio * reprefill_s)
        if wire_s >= reprefill_s:
            return False, "wire_slower"
        return True, "ok"

    def describe(self) -> Dict[str, Any]:
        return {"min_tokens": self.min_tokens,
                "max_bytes": self.max_bytes,
                "wire_bytes_per_s": self.wire_bytes_per_s,
                "rtt_s": self.rtt_s,
                "prefill_tok_per_s": self.prefill_tok_per_s,
                "remat_ratio": self.remat_ratio}


class PagePins(tuple):
    """Pinned page ids + the pool EPOCH they were pinned under.  A
    crash-recovery rebuild between the lookup and the admission bumps
    the epoch, which is how every consumer recognizes the ids as dead
    and drops them by reference."""

    epoch: Optional[int] = None

    def __new__(cls, ids, epoch):
        self = super().__new__(cls, ids)
        self.epoch = epoch
        return self


def _detached(err: BaseException) -> BaseException:
    """A copy of ``err`` to raise where a request group keeps ``err``:
    the raised copy's traceback holds the group and the server through
    its frames, and the original would close that into a cycle."""
    try:
        return copy.copy(err)
    except Exception:
        return err


def _int_param(v):
    """int() that refuses booleans: int(True) == 1 would silently
    accept {"num_beams": true} / {"prefill_chunk": true}."""
    if isinstance(v, bool):
        raise ValueError("expected an integer, got a boolean")
    return int(v)


def _parse_prompt_rows(req, max_batch: int):
    """/generate prompt validation: returns the row-wrapped token lists
    (one shared length, ints-not-bools, batch-capped)."""
    if not isinstance(req, dict):
        raise ValueError("request body must be a JSON object")
    rows = req.get("prompt")
    if rows is None:
        raise ValueError("missing 'prompt'")
    if not isinstance(rows, list):
        raise ValueError("'prompt' must be a list of token ids "
                         "or a list of rows")
    if rows and not isinstance(rows[0], list):
        rows = [rows]
    if not rows or not rows[0]:
        raise ValueError("prompt must contain at least one token")
    if len(rows) > max_batch:
        raise ValueError(f"batch {len(rows)} exceeds max_batch "
                         f"{max_batch}")
    if len({len(r) for r in rows}) != 1:
        # No silent padding: the decode path has no attention
        # mask, so padded positions would be attended to.
        raise ValueError(
            "all prompt rows must share one length (the decode "
            "path has no pad mask; bucket lengths client-side)")
    if any(not all(isinstance(t, int) and not isinstance(t, bool)
                   for t in r) for r in rows):
        # bool is an int subclass: [true, false] must not silently
        # decode as tokens [1, 0].
        raise ValueError("prompt rows must be integer token ids")
    return rows


class FairLock:
    """``threading.Lock`` with FIFO-ish handoff — a turnstile guards
    entry, so a releasing thread that immediately re-acquires (the
    engine's step loop does exactly this, every boundary) queues BEHIND
    threads already waiting instead of barging past them: acquire the
    door, then the inner lock, release the door once inside."""

    def __init__(self):
        self._door = threading.Lock()
        self._inner = threading.Lock()
        self._waiting = 0

    def acquire(self, blocking: bool = True,
                timeout: float = -1) -> bool:
        if not blocking:
            if not self._door.acquire(False):
                return False
            try:
                return self._inner.acquire(False)
            finally:
                self._door.release()
        # Advisory waiter count (GIL-coarse, no extra lock): the
        # engine's window-fuse decision polls it to drop to
        # single-step granularity while external device work waits.
        self._waiting += 1
        try:
            if timeout is None or timeout < 0:
                with self._door:
                    return self._inner.acquire()
            deadline = time.monotonic() + timeout
            if not self._door.acquire(True, timeout):
                return False
            try:
                rem = max(0.0, deadline - time.monotonic())
                return self._inner.acquire(True, rem)
            finally:
                self._door.release()
        finally:
            self._waiting -= 1

    def waiters(self) -> int:
        """Threads currently blocked in :meth:`acquire`."""
        return self._waiting

    def release(self) -> None:
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


class ModelServer:
    """Wraps one model; owns the device lock, the continuous-batching
    engine, its supervisor, the prefix store, telemetry and the
    request-history ring."""

    def __init__(self, model, *, model_name: str = "model",
                 max_batch: int = 8, batching: Optional[str] = None,
                 coalesce: Optional[bool] = None,
                 n_slots: int = 8, queue_depth: int = 64,
                 prefill_chunk: Optional[int] = None,
                 decode_window: int = 8,
                 kv_paged: bool = False, kv_page_tokens: int = 64,
                 kv_pages: Optional[int] = None,
                 kv_lazy: bool = False,
                 kv_host_spill_bytes: int = 0,
                 prefix_fetch: bool = False,
                 prefix_fetch_policy: Optional[PrefixFetchPolicy] = None,
                 prefix_fetch_timeout_s: float = 5.0,
                 role: str = "both",
                 default_priority: str = "interactive",
                 batch_queue_depth: Optional[int] = None,
                 queue_deadline_s: Optional[float] = None,
                 batch_queue_deadline_s: Optional[float] = None,
                 slo_ttft_s: Optional[float] = None,
                 request_timeout_s: Optional[float] = 600.0,
                 prefix_cache: int = 4,
                 trace_buffer: int = 4096,
                 profile_dir: Optional[str] = None,
                 profile_every: int = 0,
                 profile_steps: int = 8,
                 access_log: bool = False,
                 sanitize: bool = False,
                 sanitize_max_hold_s: Optional[float] = None,
                 sanitize_report: Optional[str] = None,
                 request_history: int = 256,
                 stall_timeout_s: Optional[float] = None,
                 stall_dir: str = ".",
                 stall_queue_factor: float = 4.0,
                 forensics: bool = True,
                 exemplar_k: int = 4,
                 forensics_dir: Optional[str] = None,
                 sentry_window: int = 64,
                 sentry_baseline_windows: int = 4,
                 fault_plan=None,
                 supervise: bool = True,
                 draft_model=None, spec_k: int = 4,
                 mesh=None,
                 info: Optional[Dict[str, Any]] = None):
        # Batching policy: "continuous" (engine, default), "coalesce"
        # (legacy baseline), "off" (serialize — the A/B floor).  The
        # old boolean kwarg maps onto the modes it used to select.
        if batching is None:
            batching = ("coalesce" if coalesce else "off") \
                if coalesce is not None else "continuous"
        if batching not in BATCHING_MODES:
            raise ValueError(f"batching must be one of "
                             f"{BATCHING_MODES}; got {batching!r}")
        from ..models.generate import check_lm_head

        check_lm_head(model)    # before any engine or program is built
        seq2seq = hasattr(model, "encode")
        if batching == "continuous" and seq2seq:
            # The slot engine is decoder-only: a seq2seq model falls back
            # to the coalescer, and /info reports the mode that runs.
            batching = "coalesce"
        if kv_paged and batching != "continuous":
            # Paged KV is the engine's storage discipline — there is
            # nothing to page in the coalesce/off solo paths.
            raise ValueError(
                "kv_paged requires the continuous-batching engine "
                f"(batching={batching!r}"
                + (" — seq2seq models fall back to coalesce)"
                   if seq2seq else ")"))
        if profile_every < 0:
            raise ValueError(f"profile_every must be >= 0; got "
                             f"{profile_every}")
        if profile_every and not profile_dir:
            raise ValueError(
                "profile_every needs profile_dir (the flight "
                "recorder writes torch.profiler windows there)")
        if profile_every and batching != "continuous":
            raise ValueError(
                "profile_every requires the continuous-batching "
                f"engine (batching={batching!r}) — the recorder "
                "windows decode-step boundaries")
        if stall_timeout_s is not None and batching != "continuous":
            raise ValueError(
                "stall_timeout_s requires the continuous-batching "
                f"engine (batching={batching!r}) — the watchdog "
                "monitors decode-step boundaries")
        if kv_lazy and not kv_paged:
            raise ValueError(
                "kv_lazy requires kv_paged (lazy growth is a page-"
                "reservation policy; fixed lanes have no pages)")
        if kv_host_spill_bytes < 0:
            raise ValueError(
                f"kv_host_spill_bytes must be >= 0; got "
                f"{kv_host_spill_bytes}")
        if kv_host_spill_bytes and not kv_paged:
            raise ValueError(
                "kv_host_spill_bytes requires kv_paged (the host "
                "tier spills page-pool payloads; legacy prefix "
                "entries already own independent caches)")
        if prefix_fetch and not (kv_paged and kv_host_spill_bytes):
            raise ValueError(
                "prefix_fetch requires kv_paged AND a host spill "
                "budget (--kv-host-spill-bytes): wire-fetched "
                "payloads are host-tier entries — they enter through "
                "the spill machinery and count against its budget")
        if prefix_fetch_timeout_s <= 0:
            raise ValueError(
                f"prefix_fetch_timeout_s must be > 0; got "
                f"{prefix_fetch_timeout_s}")
        if role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}; "
                             f"got {role!r}")
        if role == "prefill" and not (kv_paged and kv_host_spill_bytes):
            raise ValueError(
                "role='prefill' requires kv_paged AND a host spill "
                "budget (--kv-host-spill-bytes): a prefill tier's "
                "only product is admit-ready KV state served over "
                "the /prefix/fetch wire lane, which packs from the "
                "paged pool and the host tier")
        if role == "decode" and not prefix_fetch:
            raise ValueError(
                "role='decode' requires prefix_fetch: a decode tier "
                "admits handed-off prefills through the wire-fetch "
                "lane (it still re-prefills locally, counted, when "
                "a fetch degrades)")
        self.role = role
        if default_priority not in PRIORITIES:
            raise ValueError(
                f"default_priority must be one of {PRIORITIES}; "
                f"got {default_priority!r}")
        if request_timeout_s is not None and request_timeout_s <= 0:
            raise ValueError(f"request_timeout_s must be > 0; got "
                             f"{request_timeout_s}")
        if prefix_cache < 0:
            raise ValueError(f"prefix_cache must be >= 0; got "
                             f"{prefix_cache}")
        from ..models.generate import _check_spec_k

        _check_spec_k(spec_k)
        # The speculative draft: requests opt in with {"speculative":
        # true}.  ``spec_k`` is the default draft length AND the
        # engine's cap (a wider request decodes solo).
        self.draft_model = draft_model
        self.spec_k_default = int(spec_k)
        # Solo programs (beam search, speculative requests off the
        # engine): cached callables keyed by request shape, one LRU.
        self._fns: "collections.OrderedDict" = collections.OrderedDict()
        self._fn_cap = 16
        # Request kinds that fell back to the solo path, with the
        # reason logged once per kind and a count (/info).
        self.solo_fallbacks: Dict[str, Dict[str, Any]] = {}
        # Fault injection, disarmed by default: a FaultPlan, a plan
        # dict or a JSON path arms the seeded harness across the
        # engine's sites, the prefix store and the response write.
        self.faults = FaultPlan.load(fault_plan) \
            if fault_plan is not None else None
        self.kv_paged = bool(kv_paged)
        self.kv_lazy = bool(kv_lazy)
        self.model = model
        self.batching = batching
        # Serving mesh ("tp=4" / MeshSpec / ServingMesh): the models are
        # validated and PLACED here, before the engine, so every program
        # — engine steps, prefill, the solo fallbacks — runs the placed
        # weights (serving/meshed.py: the exact layout, no sum across
        # devices; its module docstring states what equality it keeps
        # on the CPU and on CUDA).  The server owns the models: the
        # placed ones hold no whole copy of a split weight.
        self.mesh = None
        if mesh is not None:
            from .meshed import MeshError, ServingMesh

            if self.batching != "continuous":
                # MeshError (a ValueError) so the CLI's usage-error
                # surface catches it: the seq2seq fallback above can
                # flip batching after the CLI's own check passed.
                raise MeshError(
                    "mesh requires the continuous-batching engine "
                    f"(batching={self.batching!r}"
                    + (" — seq2seq models fall back to coalesce)"
                       if seq2seq else ")"))
            self.mesh = mesh if isinstance(mesh, ServingMesh) \
                else ServingMesh(mesh, device_type=model.device.type)
            self.mesh.validate_model(model, "model", n_slots=n_slots)
            if draft_model is not None:
                self.mesh.validate_model(draft_model, "draft model")
                self.draft_model = draft_model = \
                    self.mesh.place_params(draft_model)
            self.model = model = self.mesh.place_params(model)
        self.model_name = model_name
        self.max_batch = int(max_batch)
        self.extra_info = info or {}
        # trace_buffer=0 disables span recording; the latency
        # histograms stay live (they are the /metrics surface).
        self.telemetry = Telemetry(
            buffer=trace_buffer,
            exemplar_k=int(exemplar_k) if forensics else 0)
        from ..analysis.recompile import RecompileSentinel

        self.recompile = RecompileSentinel(telemetry=self.telemetry)
        # Lock-order sanitizer (analysis/locksan.py), opt-in: wraps the
        # serving locks in recording proxies that raise on an inverted
        # acquisition order (and, with ``sanitize_max_hold_s``, on
        # device-lock holds past the limit).
        self.sanitizer = None
        if sanitize:
            from ..analysis.locksan import LockSanitizer

            self.sanitizer = LockSanitizer(
                max_hold_s={"device_lock": sanitize_max_hold_s}
                if sanitize_max_hold_s is not None else None)
        self.sanitize_report = sanitize_report
        if sanitize_report is not None and self.sanitizer is None:
            raise ValueError("sanitize_report requires sanitize=True")
        self.access_log = bool(access_log)
        self._access_log_file = sys.stderr
        self.default_priority = default_priority
        self.request_timeout_s = request_timeout_s
        self.draining = False
        self.drain_rejected = 0
        self._lock = FairLock() if self.sanitizer is None \
            else self.sanitizer.wrap("device_lock", FairLock())
        self.requests = 0
        # Continuous-batching engine; the coalesce/off baselines run
        # without one (solo programs under the device lock).
        self.engine: Optional[DecodeEngine] = None
        if self.batching == "continuous":
            self.engine = DecodeEngine(
                model,
                policy=SchedulerPolicy(
                    n_slots=n_slots, queue_depth=queue_depth,
                    prefill_chunk=prefill_chunk,
                    decode_window=decode_window,
                    default_priority=default_priority,
                    batch_queue_depth=batch_queue_depth,
                    queue_deadline_s=queue_deadline_s,
                    batch_queue_deadline_s=batch_queue_deadline_s,
                    slo_ttft_s=slo_ttft_s, kv_paged=kv_paged,
                    kv_page_tokens=kv_page_tokens, kv_pages=kv_pages,
                    kv_lazy=kv_lazy, spec_k_cap=self.spec_k_default),
                device_lock=self._lock,
                telemetry=self.telemetry,
                sentinel=self.recompile,
                draft_model=draft_model,
                mesh=self.mesh,
                faults=self.faults)
        self._coalescer = RequestCoalescer(self) \
            if self.batching == "coalesce" else None
        self.coalesced_batches = 0
        self.coalesced_requests = 0
        # /metrics counters under _stats_lock — never the device lock.
        self._stats_lock = threading.Lock() if self.sanitizer is None \
            else self.sanitizer.wrap("_stats_lock")
        self.errors = 0
        self._lat_sum = 0.0
        self._lat_count = 0
        self._tokens_out = 0
        self._queue_s_sum = 0.0
        self._prefill_s_sum = 0.0
        self._decode_s_sum = 0.0
        self._breakdown_count = 0
        # PREFIX CACHE: stored prefills in a radix index, LRU-bounded.
        # Contiguous entries hold their own B=1 cache; on the paged
        # pool single-row entries hold POOL PAGES (an extension entry
        # shares its ancestor's page-aligned pages).  The degradation
        # ladder may flip _prefix_enabled off at runtime; recovery
        # restores the configured state, never more.
        self.prefix_cache_size = int(prefix_cache)
        # seq2seq: an encoder input is no decoder prefix.
        self._prefix_enabled = self.prefix_cache_size > 0 and not seq2seq
        self._prefix_configured = self._prefix_enabled
        self._prefix = RadixPrefixIndex(max(1, self.prefix_cache_size))
        self._prefix_lock = threading.Lock() \
            if self.sanitizer is None \
            else self.sanitizer.wrap("_prefix_lock")
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self._prefix_store_skips = 0
        self._prefix_store_errors = 0
        # HOST-RAM SPILL TIER: a byte budget > 0 makes page-pressure
        # eviction demote a paged entry to host tensors instead of
        # dropping it.  Counters under _stats_lock; _spill_stats() is
        # the one dict /metrics and /info render.
        self.kv_host_spill_bytes = int(kv_host_spill_bytes)
        self._host_bytes = 0
        self._host_entries = 0
        self._host_spills_total = 0
        self._host_dropped_total = 0    # budget evictions + oversize
        self._remat_hits_total = 0
        self._remat_bytes_total = 0
        self._promotions_total = 0
        # FLEET PREFIX TIER: ``prefix_fetch`` arms the client half (a
        # miss with a router ``prefix_hint`` fetches the holder's entry,
        # gated by the policy); the serving half (/prefix/*) is mounted
        # on every paged server.  Every failure degrades to a counted
        # re-prefill, never a request failure.
        self.prefix_fetch = bool(prefix_fetch)
        self.prefix_fetch_timeout_s = float(prefix_fetch_timeout_s)
        self.fetch_policy = prefix_fetch_policy \
            if prefix_fetch_policy is not None else PrefixFetchPolicy()
        self._fetch_attempts_total = 0
        self._fetch_hits_total = 0
        self._fetch_bytes_total = 0
        self._fetch_failed: Dict[str, int] = {}
        self._ingest_total = 0
        self._ingest_rejected_total = 0
        self._handoff_entries_total = 0
        self._handoff_bytes_total = 0
        self._handoff_failed_total = 0
        self._evict_hints_total = 0
        if self.kv_paged:
            # Page-pressure relief: stored-but-idle prefix entries are
            # evicted (spilled to the host tier first when it is on)
            # when live traffic needs their pages.
            self.engine.page_reclaim = self._reclaim_prefix_pages
        self.history = RequestHistory(request_history)
        if self.engine is not None:
            self.engine.history = self.history
        # Per-request phase ledgers behind the per-phase /metrics
        # families and the anomaly sentry (serving/forensics.py);
        # forensics=False removes the layer.
        self.forensics: Optional[ForensicsCore] = None
        if forensics:
            self.forensics = ForensicsCore(
                window=sentry_window,
                baseline_windows=sentry_baseline_windows,
                out_dir=forensics_dir,
                snapshot_fn=(lambda: self.engine.build_debug_snapshot(
                    forced=True)) if self.engine is not None else None,
                trace_tail_fn=lambda: self.telemetry.events()[-256:],
                record_fn=self.history.get)
            if self.engine is not None:
                self.engine.forensics = self.forensics
        # Stall watchdog (opt-in): a one-shot diagnostic bundle when
        # work exists but no step boundary completes.
        self.watchdog = None
        if stall_timeout_s is not None:
            self.watchdog = StallWatchdog(
                self.engine, self.telemetry,
                timeout_s=stall_timeout_s, out_dir=stall_dir,
                queue_factor=stall_queue_factor,
                extra_state=self._watchdog_extra_state)
            self.watchdog.start()
        # Engine supervisor (default on): a crash requeues everything
        # for token-identical resume and restarts the loop over the
        # same pools; a crash storm opens the breaker.
        self.supervisor = None
        if supervise and self.engine is not None:
            self.supervisor = EngineSupervisor(self.engine)
            self.supervisor.add_recovery_hook(self._on_engine_recovery)
        # POST /profile/start|stop (single-flight torch.profiler
        # wrap); None keeps the endpoints disabled — profiling writes
        # traces to disk, so it is an explicit operator opt-in.  With
        # an engine, profiler transitions run on its loop thread, the
        # thread whose ops a trace must record.
        self.profiler = ProfileSession(
            profile_dir, runner=self.engine.run_on_loop
            if self.engine is not None else None) \
            if profile_dir else None
        # FLIGHT RECORDER (serving/profiling.py), off by default.
        self.recorder = None
        if profile_every:
            from .profiling import (FlightRecorder,
                                    decode_flops_per_token,
                                    detect_peak_flops)

            cfg = getattr(model, "cfg", None)
            peak = detect_peak_flops(model.device)
            try:
                # Primes the profiler: raises when it cannot start.
                self.recorder = FlightRecorder(
                    self.profiler, every=profile_every,
                    steps=profile_steps, telemetry=self.telemetry,
                    flops_fn=(lambda pos: decode_flops_per_token(
                        cfg, pos)) if cfg is not None else None,
                    peak_flops=peak["peak_flops"],
                    peak_flops_source=peak["peak_flops_source"],
                    n_devices=1 if self.mesh is None
                    else len(self.mesh.physical_devices),
                    position_probe=self.engine.mean_resident_position)
            except BaseException:
                self.close()
                raise
            self.engine.recorder = self.recorder

    def close(self) -> None:
        """Stop the watchdog and the engine loop (with it the
        supervisor, which recovers on the loop thread), write the
        sanitizer report, and break the server's reference cycles so a
        dropped server frees its engine, pools and model at once, not
        whenever the cycle collector runs.  Idempotent."""
        if self.watchdog is not None:
            self.watchdog.close()
        # The recorder, then the profiler, BEFORE the engine: a trace
        # started on the engine's loop thread is stopped there.
        if self.recorder is not None:
            self.recorder.close()
        if self.profiler is not None:
            self.profiler.close()
        if self.engine is not None:
            self.engine.close()
        if self.sanitizer is not None \
                and self.sanitize_report is not None:
            with open(self.sanitize_report, "w",
                      encoding="utf-8") as fh:
                json.dump(self.sanitizer.stats(), fh, indent=1,
                          sort_keys=True)
                fh.write("\n")
        eng = self.engine
        if self.supervisor is not None:
            self.supervisor._recovery_hooks.clear()
            self.supervisor.engine = None
        if self.watchdog is not None:
            self.watchdog.extra_state = None
            self.watchdog.engine = None
        if self.forensics is not None:
            sentry = self.forensics.sentry
            sentry.snapshot_fn = sentry.trace_tail_fn = None
            sentry.record_fn = None
        if eng is not None:
            eng.page_reclaim = None
            eng.recorder = None
            eng._suspects.clear()
            eng._exhaust_bars.clear()

    # -- request lifecycle ----------------------------------------------

    def drain(self) -> Dict[str, Any]:
        """POST /drain: stop admitting (new requests shed with 503
        ``draining``), let in-flight work finish, and turn /healthz
        readiness off.  Idempotent; returns the in-flight snapshot."""
        self.draining = True
        if self.engine is not None:
            self.engine.drain()
        return self.drain_status()

    def drain_status(self) -> Dict[str, Any]:
        es = self.engine.stats() if self.engine is not None else {}
        return {"draining": self.draining,
                "drain_rejected": self.drain_rejected,
                "slots_active": es.get("slots_active", 0),
                "queue_len": es.get("queue_len", 0)}

    def debug_state(self) -> Dict[str, Any]:
        """``GET /debug/state``: the snapshot the engine published at
        its most recent step boundary (never the device lock)."""
        now = time.perf_counter()
        out: Dict[str, Any] = {
            "model": self.model_name,
            "batching": self.batching,
            "draining": self.draining,
            "history": self.history.stats(),
        }
        if self.engine is not None:
            snap = self.engine.debug_board.latest()
            if snap is not None:
                snap["age_s"] = round(max(0.0, now - snap["t"]), 3)
                del snap["t"]
            out["engine"] = snap
        if self.watchdog is not None:
            out["watchdog"] = self.watchdog.status()
        if self.sanitizer is not None:
            out["sanitizer"] = self.sanitizer.stats()
        return out

    def _watchdog_extra_state(self) -> Dict[str, Any]:
        """Server-level state folded into a stall bundle."""
        return {
            "draining": self.draining,
            "requests": self.requests,
            "errors": self.errors,
            "history": self.history.stats(),
            "prefix_enabled": self._prefix_enabled,
            "prefix_store_errors": self._prefix_store_errors,
            **({"sanitizer": self.sanitizer.stats()}
               if self.sanitizer is not None else {}),
        }

    def record_front(self, rid: Optional[str], path: str,
                     status: int, req, resp) -> None:
        """Minimal front-end history record for a request the ENGINE
        never recorded (validation 400s, sheds, 501s)."""
        if rid is None or not self.history.enabled:
            return
        front_status = {200: "complete", 429: "shed", 503: "shed",
                        504: "expired", 499: "cancelled"}.get(
                            int(status), "failed")
        rec: Dict[str, Any] = {
            "request_id": rid, "t": round(time.time(), 3),
            "path": path, "http_status": int(status),
            "status": front_status}
        if isinstance(req, dict):
            rec["kind"] = self._request_kind(req, path)
        if isinstance(resp, dict):
            if resp.get("error"):
                rec["error"] = str(resp["error"])[:300]
            if resp.get("reason"):
                rec["reason"] = resp["reason"]
            if "wall_s" in resp:
                rec["wall_s"] = resp["wall_s"]
        self.history.record_front(rec)

    def _check_not_draining(self) -> None:
        if self.draining:
            with self._stats_lock:
                self.drain_rejected += 1
            raise ShedError(
                "server is draining: finishing in-flight requests, "
                "admitting none", reason="draining")

    def _wait_group(self, group, cancel_check=None) -> None:
        """Bounded wait for an engine group: a client disconnect
        (499), the request's deadline (504) or ``request_timeout_s``
        (503 ``request_timeout``) cancel it at the engine's next
        boundary and raise here."""
        cap = None
        if self.request_timeout_s is not None:
            cap = group.t_submit + self.request_timeout_s
        while not group.event.wait(0.1):
            now = time.perf_counter()
            if cancel_check is not None and cancel_check():
                err = RequestCancelled(
                    "client disconnected; request cancelled")
                self.engine.cancel(group, err)
                raise _detached(err)
            if group.deadline is not None and now > group.deadline:
                err = DeadlineExceeded(
                    f"deadline exceeded after "
                    f"{now - group.t_submit:.3f}s "
                    f"({group.status_phase()})")
                self.engine.cancel(group, err)
                raise _detached(err)
            if cap is not None and now > cap:
                err = ShedError(
                    f"request exceeded the server request timeout "
                    f"({self.request_timeout_s}s) without reaching a "
                    f"terminal state; shedding the waiter",
                    reason="request_timeout")
                self.engine.cancel(group, err)
                raise _detached(err)
        if group.error is not None:
            raise _detached(group.error)

    def log_access(self, method: str, path: str, status: int,
                   req, resp, dt: float,
                   rid: Optional[str] = None) -> None:
        """One structured JSON line per request on stderr (--access-
        log)."""
        if not self.access_log:
            return
        rec: Dict[str, Any] = {
            "t": round(time.time(), 3), "method": method,
            "path": path, "status": int(status),
            "ms": round(1e3 * dt, 3)}
        if rid is not None:
            rec["request_id"] = rid
        if isinstance(resp, dict):
            for k in ("slot", "preempts", "resumes"):
                if k in resp:
                    rec[k] = resp[k]
        if isinstance(req, dict):
            rec["kind"] = self._request_kind(req, path)
            rows = req.get("prompt")
            if isinstance(rows, list) and rows:
                rec["rows"] = len(rows) \
                    if isinstance(rows[0], list) else 1
        if isinstance(resp, dict):
            if status == 200 and "new_tokens" in resp:
                rec["new_tokens"] = sum(
                    len(r) for r in resp["new_tokens"]
                    if isinstance(r, list))
            err = resp.get("error")
            if err:
                rec["error"] = str(err)[:200]
        try:
            print(json.dumps(rec), file=self._access_log_file,
                  flush=True)
        except Exception:
            pass  # logging must never fail a request

    @staticmethod
    def _request_kind(req: Dict[str, Any], path: str = "/generate"
                      ) -> str:
        if path == "/prefill":
            return "prefill"
        if req.get("speculative") is True:
            return "speculative"
        beams = req.get("num_beams")
        if isinstance(beams, int) and not isinstance(beams, bool) \
                and beams > 1:
            return "beam"
        temp = req.get("temperature", 0)
        if isinstance(temp, (int, float)) \
                and not isinstance(temp, bool) and temp > 0:
            return "sampled"
        return "greedy"

    def _note_breakdown(self, queue_s: float, prefill_s: float,
                        decode_s: float) -> None:
        with self._stats_lock:
            self._queue_s_sum += queue_s
            self._prefill_s_sum += prefill_s
            self._decode_s_sum += decode_s
            self._breakdown_count += 1

    def _note_fallback(self, kind: str, reason: str) -> None:
        """A request class fell back to the solo path: count it under
        its kind and log the reason once per kind (``/info``
        ``solo_fallbacks``)."""
        with self._stats_lock:
            fb = self.solo_fallbacks.get(kind)
            first = fb is None
            if first:
                self.solo_fallbacks[kind] = {"reason": reason,
                                             "count": 1}
            else:
                fb["count"] += 1
        if first:
            print(f"# serving: {kind} requests take the solo path — "
                  f"{reason}", file=sys.stderr)

    def _fn(self, key):
        """The solo program of ``key`` = (kind, rows, prompt length,
        new, temperature, top_k, top_p, eos, beams or spec_k, chunk):
        a callable ``fn(toks, seed)`` in the server's LRU (a miss is
        counted by the recompile sentinel, as the reference counts a
        compile)."""
        from .. import prng
        from ..models import generate as G

        def build():
            kind, _b, _p, new, temp, top_k, top_p, eos, width, \
                chunk = key
            if kind == "beam":
                return lambda toks, seed: G.generate_beam(
                    self.model, toks, max_new_tokens=new,
                    num_beams=width, eos_id=eos, prefill_chunk=chunk)
            if kind in ("spec", "spec_pos"):
                # spec_pos: sampled speculative under the position-
                # keyed schedule, the engine's spec slots' reference.
                return lambda toks, seed: G.generate_speculative(
                    self.model, self.draft_model, toks,
                    max_new_tokens=new, k=width, eos_id=eos,
                    prefill_chunk=chunk, temperature=temp, top_k=top_k,
                    top_p=top_p,
                    seed=seed if kind == "spec_pos" else None)
            if kind == "sample_pos":
                return lambda toks, seed: G.generate_positional(
                    self.model, toks, max_new_tokens=new, seed=seed,
                    temperature=temp, top_k=top_k or 0,
                    top_p=top_p or 0.0, eos_id=eos, prefill_chunk=chunk)
            return lambda toks, seed: G.generate(
                self.model, toks, max_new_tokens=new, temperature=temp,
                top_k=top_k, top_p=top_p, eos_id=eos,
                rng=prng.PRNGKey(seed, device=self.model.device),
                prefill_chunk=chunk)

        return lru_get(self._fns, key, self._fn_cap, build,
                       sentinel=self.recompile, kind=f"server:{key[0]}")

    def _generate_solo(self, key, toks: np.ndarray, seed: int,
                       deadline=None):
        """One solo program under the device lock (its whole decode).
        Returns ``(tokens, (queue_s, prefill_s, decode_s))``; prefill
        is fused into the decode, as the reference reports it."""
        import torch

        t_lock = time.perf_counter()
        with self._lock:
            queue_s = time.perf_counter() - t_lock
            if deadline is not None and time.perf_counter() > deadline:
                raise DeadlineExceeded(
                    f"deadline exceeded after {queue_s:.3f}s waiting "
                    f"for the device (solo path)")
            rows = torch.as_tensor(toks, device=self.model.device)
            out = host_copy(self._fn(key)(rows, seed)).numpy()
            self._sync()
        return out, (queue_s, 0.0,
                     time.perf_counter() - t_lock - queue_s)

    # -- device sections on handler threads ------------------------------

    def _sync(self) -> None:
        """End a handler thread's device section: everything it queued
        completes before the device lock goes to the engine's graph
        replays (one stream order, whichever thread issued); never
        inside another server's capture (``slots.sync_device``)."""
        sync_device(self.model.device)

    # -- prefix cache: degradation ladder and recovery -------------------

    def _note_prefix_error(self, where: str) -> None:
        """One prefix-store failure: count it and DISABLE the store
        (lookups miss, stores skip) — requests keep flowing without
        prefix reuse instead of failing on a broken cache."""
        with self._stats_lock:
            self._prefix_store_errors += 1
            first = self._prefix_enabled
            self._prefix_enabled = False
        if first:
            print(f"# serving: prefix store DISABLED after an error in "
                  f"{where} — requests continue without prefix reuse "
                  f"(counted in /info prefix_store_errors)",
                  file=sys.stderr)

    def _prefix_lookup_safe(self, toks: np.ndarray
                            ) -> Optional[PrefixHit]:
        """Contained lookup: an error (injected at the ``prefix_store``
        site, or real) degrades to a MISS and disables the store."""
        if not self._prefix_enabled:
            return None
        try:
            if self.faults is not None:
                self.faults.check("prefix_store")
            return self._prefix_lookup(toks)
        except Exception:
            self._note_prefix_error("lookup")
            return None

    def _prefix_store_safe(self, toks, logits, cache, *,
                           hot: bool = True) -> None:
        """Contained store: a failing store never fails the request
        whose prefill it was caching."""
        if not self._prefix_enabled:
            return
        try:
            if self.faults is not None:
                self.faults.check("prefix_store")
            self._prefix_store(toks, logits, cache, hot=hot)
        except Exception:
            self._note_prefix_error("store")

    def _on_engine_recovery(self) -> None:
        """EngineSupervisor hook, after the pool reset and before the
        loop restart: PAGED entries name pages of the pool generation
        that just died, so the index is flushed BY REFERENCE (no
        unpins into the fresh accounting).  Contiguous entries own
        their caches and survive, and so do HOST-TIER entries (host
        tensors, no device state), re-stored coldest first.  A store the
        crash window disabled comes back to its configured state."""
        if self.kv_paged:
            displaced = []
            with self._prefix_lock:
                keep = [(t, p) for t, p in self._prefix.entries()
                        if isinstance(p, _SpilledPrefix)]
                self._prefix = RadixPrefixIndex(
                    max(1, self.prefix_cache_size))
                for t, p in keep:
                    displaced += self._prefix.store(t, p)
            if displaced:
                self._free_displaced(displaced)
        if self._prefix_configured:
            with self._stats_lock:
                self._prefix_enabled = True
        if self.recorder is not None:
            # Profiler transitions run on the thread that started the
            # trace: this dying loop thread.  A stop already handed to
            # the loop runs here, then the open window ends.
            self.engine._run_loop_calls()
            self.recorder.on_engine_restart()

    # -- prefix cache: lookup / store --------------------------------------

    def _prefix_lookup(self, toks: np.ndarray) -> Optional[PrefixHit]:
        """Longest stored entry whose prompt prefixes ``toks`` (same
        batch width), as a PRIVATE contiguous cache: a clone of a
        contiguous entry, or a paged entry's pages gathered under the
        device lock.  Paged entries are pinned under the prefix lock
        (an eviction cannot free them mid-flight) and returned with
        their pinned FULL-page ids (:class:`PrefixHit`)."""
        mgr = self.engine.slots if self.kv_paged else None
        with self._prefix_lock:
            # The index keys int32 columns by their bytes.
            hit = self._prefix.lookup(np.asarray(toks, np.int32))
            if hit is None:
                return None
            ent_toks, payload = hit
            pc = ent_toks.shape[1]
            spilled = isinstance(payload, _SpilledPrefix)
            paged = isinstance(payload, _PagedPrefix)
            if paged:
                # Lock order: _prefix_lock > _page_lock.
                pin_epoch = mgr.pin(payload.pages)
        if spilled:
            # Host-tier hit: the payload (immutable host tensors) is
            # safe outside the lock; rematerialize and promote there.
            return self._rematerialize_hit(ent_toks, payload, pc)
        if not paged:
            logits, cache = payload
            with self._lock:
                cache = cache.clone()
                self._sync()
            return PrefixHit(pc, logits, cache, ())
        try:
            with self._lock:
                if mgr.epoch != pin_epoch:
                    # Pool rebuilt since the pin (recovery resets under
                    # this same lock): the ids are dead — a miss.
                    return None
                cache = mgr.materialize(payload.pages, pc)
                self._sync()
        except BaseException:
            if mgr.epoch != pin_epoch:
                return None
            mgr.unpin(payload.pages, epoch=pin_epoch)
            raise
        # Pins stay only on the FULL pages (the shareable ones; the
        # partial tail rides the materialized cache and is rewritten
        # privately by the admitted slot).
        n_full = pc // mgr.page_tokens
        pins = PagePins(payload.pages[:n_full], pin_epoch)
        if payload.pages[n_full:]:
            mgr.unpin(payload.pages[n_full:], epoch=pin_epoch)
        return PrefixHit(pc, payload.logits, cache, pins)

    def _cache_template(self):
        """A ``meta``-device B=1 cache of the model's full width: the
        shapes and dtypes ``init_cache`` gives, nothing allocated —
        what a cold pool is shaped from (``ensure_shaped``)."""
        import torch

        from ..models.kv_cache import KVCache, kv_cache_dims

        cfg = self.model.cfg
        shape = (cfg.num_layers, 1, cfg.max_position,
                 *kv_cache_dims(cfg))
        int8 = bool(getattr(cfg, "kv_cache_int8", False))
        dt = torch.int8 if int8 else cfg.dtype

        def meta(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")

        scales = {n: meta(shape[:-1] + (1,), torch.bfloat16)
                  for n in ("k_scale", "v_scale")} if int8 else {}
        return KVCache(meta(shape, dt), meta(shape, dt), **scales)

    def _rematerialize_hit(self, ent_toks, payload: "_SpilledPrefix",
                           pc: int) -> PrefixHit:
        """HOST-TIER hit: put the spilled tensors back into a contiguous
        cache (``rematerialize``) and opportunistically PROMOTE the entry
        back to pool pages, so later hits and co-resident slots share
        them copy-on-write again.  Promotion is best-effort: a tight
        pool serves the hit from the contiguous cache alone.  Runs on a
        handler thread with no lock held; errors reach
        ``_prefix_lookup_safe``'s degradation ladder."""
        mgr = self.engine.slots
        with self._lock:
            if not mgr.shaped:
                # Cold pool: the entry came over the wire before this
                # replica's first prefill shaped the pool.
                mgr.ensure_shaped(self._cache_template(),
                                  self.model.device)
            cache = mgr.rematerialize(payload.leaves, pc)
            logits = payload.logits.to(self.model.device)
            self._sync()
        with self._stats_lock:
            self._remat_hits_total += 1
            self._remat_bytes_total += payload.nbytes
        pins = ()
        ids, ep = mgr.reserve_with_epoch(mgr.pages_needed(pc))
        if ids:
            promoted = False
            try:
                with self._lock:
                    # Epoch re-check inside the device lock (recovery
                    # resets the pool under it).
                    if mgr.epoch == ep:
                        mgr.scatter_cache(cache, ids)
                        self._sync()
                        promoted = True
            except Exception:
                promoted = False    # promotion is an optimization
            promoted_entry = False
            if promoted:
                new_payload = _PagedPrefix(ids, pc, logits)
                with self._prefix_lock:
                    if self._prefix.set_payload(ent_toks, new_payload,
                                                expect=payload):
                        # This hit maps the promoted FULL pages
                        # read-only, like a device-tier hit.
                        n_full = pc // mgr.page_tokens
                        pin_epoch = mgr.pin(ids[:n_full]) \
                            if n_full else ep
                        pins = PagePins(ids[:n_full], pin_epoch)
                        promoted_entry = True
                if promoted_entry:
                    with self._stats_lock:
                        self._host_bytes -= payload.nbytes
                        self._host_entries -= 1
                        self._promotions_total += 1
            if not promoted_entry:
                # Entry changed under us, or the scatter failed:
                # abandon the promotion.
                mgr.unpin(ids, epoch=ep)
        return PrefixHit(pc, logits, cache, pins, source="host")

    def _unpin_prefix(self, pins) -> None:
        if pins:
            self.engine.slots.unpin(pins,
                                    epoch=getattr(pins, "epoch", None))

    def _free_displaced(self, displaced) -> None:
        """Release payloads the index displaced (overwrites and LRU
        evictions): paged entries drop their page references — pages
        shared with a child entry or a resident slot stay alive under
        the remaining refcounts — and host entries leave the spill
        byte accounting."""
        for _toks, payload in displaced:
            if isinstance(payload, _PagedPrefix):
                self.engine.slots.unpin(payload.pages)
            elif isinstance(payload, _SpilledPrefix):
                with self._stats_lock:
                    self._host_bytes -= payload.nbytes
                    self._host_entries -= 1
                    self._host_dropped_total += 1

    def _spill_entry(self, toks, payload) -> bool:
        """Demote one device-tier entry to the HOST tier: pin its pages,
        gather them to host tensors (``spill_pages``, under the device
        lock), swap the entry's payload in place and release its page
        references — the pages free while the content survives in host
        memory.  Returns False when the entry must be dropped instead
        (spill failed or over budget)."""
        mgr = self.engine.slots
        with self._prefix_lock:
            # Identity-guarded presence check, then pin under the lock.
            if not self._prefix.set_payload(toks, payload,
                                            expect=payload):
                return True     # someone else dealt with it
            pin_epoch = mgr.pin(payload.pages)
        try:
            with self._lock:
                if mgr.epoch != pin_epoch:
                    # Pool rebuilt: pins and pages are dead by
                    # reference; the recovery flush owns the index.
                    return True
                host = mgr.spill_pages(payload.pages, payload.n_tokens)
                logits_host = host_copy(payload.logits)
        except Exception:
            mgr.unpin(payload.pages, epoch=pin_epoch)
            return False
        spilled = _SpilledPrefix(host, payload.n_tokens, logits_host)
        if spilled.nbytes > self.kv_host_spill_bytes:
            mgr.unpin(payload.pages, epoch=pin_epoch)
            with self._stats_lock:
                self._host_dropped_total += 1
            return False
        with self._prefix_lock:
            swapped = self._prefix.set_payload(toks, spilled,
                                               expect=payload)
        mgr.unpin(payload.pages, epoch=pin_epoch)   # the gather pin
        if not swapped:
            return True         # entry changed meanwhile
        # The ENTRY's own page references go now that its payload lives
        # on the host.
        mgr.unpin(payload.pages, epoch=pin_epoch)
        with self._stats_lock:
            self._host_bytes += spilled.nbytes
            self._host_entries += 1
            self._host_spills_total += 1
        self._enforce_spill_budget()
        return True

    def _enforce_spill_budget(self) -> None:
        """Drop the COLDEST host-tier entries until the spill bytes fit
        the budget (the radix recency order is the host tier's LRU)."""
        while True:
            with self._stats_lock:
                if self._host_bytes <= self.kv_host_spill_bytes:
                    return
            with self._prefix_lock:
                victim = None
                for t, p in self._prefix.entries():   # coldest first
                    if isinstance(p, _SpilledPrefix):
                        victim = (t, p)
                        break
                if victim is None:
                    return      # accounting drift guard
                self._prefix.remove(victim[0])
            self._free_displaced([victim])

    def _reclaim_prefix_pages(self, n_pages_needed: int) -> bool:
        """The engine's page-pressure hook: free device pages until
        ``n_pages_needed`` are free or no page-holding entry is left —
        stored-but-idle prefixes never starve live traffic.  With the
        host tier on, evicted entries SPILL to host memory instead of
        being dropped."""
        mgr = self.engine.slots
        while mgr.free_page_count() < n_pages_needed:
            with self._prefix_lock:
                victim = None
                for t, p in self._prefix.entries():   # coldest first
                    if isinstance(p, _PagedPrefix):
                        victim = (t, p)
                        break
            if victim is None:
                return False
            toks, payload = victim
            if self.kv_host_spill_bytes > 0 \
                    and self._spill_entry(toks, payload):
                continue
            # Drop path (spill off, failed or over budget), guarded by
            # payload identity: a concurrent overwrite's payload must
            # not be dropped on the old one's verdict.
            with self._prefix_lock:
                if self._prefix.set_payload(toks, payload,
                                            expect=payload):
                    self._prefix.remove(toks)
                else:
                    continue    # entry changed: re-evaluate
            self._free_displaced([(toks, payload)])
        return True

    def _prefix_store(self, toks: np.ndarray, logits, cache, *,
                      hot: bool = True) -> None:
        """Store a prompt's prefill for reuse.  Callers must NOT hold
        the device lock (the paged path scatters pages under it).

        Contiguous entries keep ``cache`` (nobody writes it after: a
        hit clones).  Paged entries (single-row, paged engine) write
        it into POOL PAGES, sharing every page-aligned page of the
        deepest stored ancestor instead of re-storing it.  ``hot=False``
        (a per-request store-back) enters the index's cold ring, so
        one-shot suffixes cycle among themselves instead of flushing a
        registered system prompt."""
        toks = np.asarray(toks, np.int32)
        p_len = toks.shape[1]
        paged = self.kv_paged and toks.shape[0] == 1
        mgr = self.engine.slots if self.kv_paged else None
        shared = ()
        pin_epoch = None
        with self._prefix_lock:
            anc = self._prefix.longest_ancestor(toks)
            if anc is not None and anc[0].shape[1] >= p_len:
                return     # exact prompt already stored
            if not self._prefix.accepts(hot):
                return     # would be displaced in the same call
            if paged and anc is not None \
                    and isinstance(anc[1], _PagedPrefix):
                n_share = min(anc[0].shape[1] // mgr.page_tokens,
                              mgr.pages_needed(p_len))
                shared = tuple(anc[1].pages[:n_share])
                pin_epoch = mgr.pin(shared)
        if not paged:
            with self._prefix_lock:
                displaced = self._prefix.store(toks, (logits, cache),
                                               hot=hot)
            self._free_displaced(displaced)
            return
        if pin_epoch is None:
            pin_epoch = mgr.epoch
        n_pages = mgr.pages_needed(p_len)
        fresh, reserve_epoch = None, pin_epoch
        for _ in range(8):      # bounded: a reserve/consume race must
            #                     not spin this store forever
            fresh, reserve_epoch = mgr.reserve_with_epoch(
                n_pages - len(shared))
            if fresh is not None:
                break
            if not self._reclaim_prefix_pages(n_pages - len(shared)):
                break
        if fresh is None or reserve_epoch != pin_epoch:
            # Pool too tight (live traffic owns the pages), or rebuilt
            # since the ancestor pins: skip — the cache is an
            # optimization, never back-pressure.
            mgr.unpin(shared, epoch=pin_epoch)
            if fresh:
                mgr.unpin(fresh, epoch=reserve_epoch)
            with self._stats_lock:
                self._prefix_store_skips += 1
            return
        ids = list(shared) + fresh
        try:
            with self._lock:
                # Epoch re-check INSIDE the device lock: recovery
                # resets the pool under it, so a dead-generation
                # scatter cannot interleave.
                if mgr.epoch != pin_epoch:
                    return
                mgr.scatter_cache(cache, ids, n_shared=len(shared))
                self._sync()
        except BaseException:
            mgr.unpin(shared, epoch=pin_epoch)
            mgr.unpin(fresh, epoch=reserve_epoch)
            raise
        payload = _PagedPrefix(ids, p_len, logits)
        with self._prefix_lock:
            if mgr.epoch != pin_epoch:
                return     # rebuilt after the scatter: ids are dead
            displaced = self._prefix.store(toks, payload, hot=hot)
        self._free_displaced(displaced)

    def _store_stream_prefix(self, stream) -> None:
        """Engine ``on_prefilled`` hook of prefix-seeded streams: store
        the extended prompt's prefill back (cold), so an exact repeat
        hits at full length.  Runs on the engine thread before the
        stream's cache moves into the slot pool."""
        self._prefix_store_safe(np.asarray(stream.toks), stream.logits,
                                stream.cache, hot=False)

    # -- fleet prefix tier (wire fetch / ingest / handoff) -----------------

    @staticmethod
    def _prefix_key(toks: np.ndarray) -> str:
        """Stable cross-replica identity of one stored prompt: every
        replica (and the router's rebalance pass) derives the same key
        from the same tokens."""
        import hashlib

        toks = np.ascontiguousarray(np.asarray(toks, np.int32))
        return hashlib.sha1(
            b"%d|%d|" % toks.shape + toks.tobytes()).hexdigest()

    def _note_fetch_failed(self, reason: str) -> None:
        with self._stats_lock:
            self._fetch_failed[reason] = \
                self._fetch_failed.get(reason, 0) + 1

    def _pack_entry_wire(self, ent_toks, payload) -> Optional[bytes]:
        """Serialize ONE radix entry for the wire.  Host-tier entries
        pack directly; device-tier entries are gathered READ-ONLY (pin,
        ``spill_pages`` under the device lock, unpin: the entry keeps
        its pages — serving a peer must not demote the holder's copy).
        None when the entry vanished or the gather failed (a miss)."""
        if isinstance(payload, _SpilledPrefix):
            return pack_spilled(ent_toks, payload.leaves,
                                payload.n_tokens, payload.logits)
        if not isinstance(payload, _PagedPrefix):
            return None     # contiguous entries stay local
        mgr = self.engine.slots
        with self._prefix_lock:
            if not self._prefix.set_payload(ent_toks, payload,
                                            expect=payload):
                return None
            pin_epoch = mgr.pin(payload.pages)
        try:
            with self._lock:
                if mgr.epoch != pin_epoch:
                    return None
                host = mgr.spill_pages(payload.pages, payload.n_tokens)
                logits_host = host_copy(payload.logits)
        except Exception:
            return None
        finally:
            mgr.unpin(payload.pages, epoch=pin_epoch)
        return pack_spilled(ent_toks, host, payload.n_tokens, logits_host)

    def prefix_wire_payload(self, req: Dict[str, Any]
                            ) -> Optional[bytes]:
        """POST /prefix/fetch: the longest stored entry that prefixes
        the peer's prompt, serialized for the wire (None: the handler's
        404).  Served while DRAINING too — that is when peers ask."""
        if not self.kv_paged:
            raise ValueError(
                "prefix wire fetch requires a paged engine "
                "(kv_paged)")
        rows = _parse_prompt_rows(req, self.max_batch)
        toks = np.asarray(rows, np.int32)
        with self._prefix_lock:
            # lookup, not longest_ancestor: a fleet hit refreshes the
            # entry's recency here too.
            hit = self._prefix.lookup(toks)
        if hit is None:
            return None
        return self._pack_entry_wire(hit[0], hit[1])

    def prefix_ingest(self, blob: bytes, *,
                      hot: bool = True) -> Dict[str, Any]:
        """POST /prefix/ingest: verify and store one wire payload as a
        HOST-TIER entry (a drain handoff's push, or a prefetch).  A
        checksum mismatch raises :class:`WirePayloadError` (400) and
        nothing partial is admitted; stored entries count against the
        spill budget like locally spilled ones."""
        if not self.kv_paged or self.kv_host_spill_bytes <= 0:
            with self._stats_lock:
                self._ingest_rejected_total += 1
            raise ValueError(
                "prefix ingest requires a paged engine with a host "
                "spill budget (--kv-host-spill-bytes)")
        if not self._prefix_enabled:
            with self._stats_lock:
                self._ingest_rejected_total += 1
            raise ValueError(
                "prefix cache is disabled on this server")
        try:
            toks, leaves, n_tokens, logits = unpack_spilled(blob)
        except WirePayloadError:
            with self._stats_lock:
                self._ingest_rejected_total += 1
            raise
        spilled = _SpilledPrefix(leaves, n_tokens, logits)
        if spilled.nbytes > self.kv_host_spill_bytes:
            with self._stats_lock:
                self._ingest_rejected_total += 1
            return {"stored": False, "reason": "over_budget",
                    "nbytes": spilled.nbytes,
                    "budget": self.kv_host_spill_bytes}
        with self._prefix_lock:
            anc = self._prefix.longest_ancestor(toks)
            if anc is not None and anc[0].shape[1] >= n_tokens:
                return {"stored": False, "reason": "already_stored"}
            if not self._prefix.accepts(hot):
                with self._stats_lock:
                    self._ingest_rejected_total += 1
                return {"stored": False, "reason": "at_capacity"}
            displaced = self._prefix.store(toks, spilled, hot=hot)
        self._free_displaced(displaced)
        with self._stats_lock:
            self._host_bytes += spilled.nbytes
            self._host_entries += 1
            self._ingest_total += 1
        self._enforce_spill_budget()
        return {"stored": True, "n_tokens": int(n_tokens),
                "nbytes": spilled.nbytes}

    def prefix_index(self) -> Dict[str, Any]:
        """GET /prefix/index: this replica's prefix inventory (stable
        key, tier, recency ring, hits, host bytes) — the fleet eviction
        policy's input, without fetching any payload."""
        with self._prefix_lock:
            meta = self._prefix.entries_meta()
        entries = []
        for toks, payload, hits, hot in meta:
            if isinstance(payload, _SpilledPrefix):
                tier: Dict[str, Any] = {"tier": "host",
                                        "nbytes": payload.nbytes}
            elif isinstance(payload, _PagedPrefix):
                tier = {"tier": "device"}
            else:
                tier = {"tier": "legacy"}
            entries.append({"key": self._prefix_key(toks),
                            "rows": int(toks.shape[0]),
                            "tokens": int(toks.shape[1]),
                            "hits": int(hits),
                            "hot": bool(hot), **tier})
        with self._stats_lock:
            host_bytes = self._host_bytes
        return {"entries": entries,
                "host_bytes": host_bytes,
                "host_budget_bytes": self.kv_host_spill_bytes}

    def prefix_evict(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """POST /prefix/evict: drop the named HOST-TIER entries (the
        router's redundant cold copies).  Device-tier entries never drop
        on a hint; an unknown key is skipped."""
        keys = req.get("keys")
        if not isinstance(keys, list) \
                or not all(isinstance(k, str) for k in keys):
            raise ValueError("'keys' must be a list of entry keys "
                             "(GET /prefix/index)")
        want = set(keys)
        dropped = []
        with self._prefix_lock:
            for toks, payload in list(self._prefix.entries()):
                if not isinstance(payload, _SpilledPrefix):
                    continue
                if self._prefix_key(toks) in want:
                    self._prefix.remove(toks)
                    dropped.append((toks, payload))
        self._free_displaced(dropped)
        with self._stats_lock:
            self._evict_hints_total += len(dropped)
        return {"evicted": len(dropped),
                "requested": len(want)}

    def prefix_handoff(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """POST /prefix/handoff: push this replica's prefix entries to a
        successor, hottest first (the drain workflow's cache half).
        Device-tier entries ride too (gathered read-only).  Every push
        runs outside all locks over its own bounded connection; per-entry
        failures are counted and skipped, never raised."""
        host = req.get("host")
        port = req.get("port")
        if not isinstance(host, str) or not host:
            raise ValueError("'host' must be a non-empty string")
        try:
            port = _int_param(port)
        except (TypeError, ValueError):
            raise ValueError("'port' must be an int")
        max_entries = req.get("max_entries")
        if max_entries is not None:
            max_entries = _int_param(max_entries)
            if max_entries < 1:
                raise ValueError("max_entries must be >= 1")
        include_device = req.get("include_device", True)
        if not isinstance(include_device, bool):
            raise ValueError("'include_device' must be a boolean")
        import http.client

        t0 = time.perf_counter()
        with self._prefix_lock:
            # entries() is coldest-first: the budget goes to the
            # hottest entries.
            ents = [(t, p) for t, p in
                    reversed(self._prefix.entries())
                    if isinstance(p, _SpilledPrefix)
                    or (include_device
                        and isinstance(p, _PagedPrefix))]
        if max_entries is not None:
            ents = ents[:max_entries]
        sent = bytes_sent = failed = 0
        for ent_toks, payload in ents:
            blob = self._pack_entry_wire(ent_toks, payload)
            if blob is None:
                failed += 1
                continue
            try:
                conn = http.client.HTTPConnection(
                    host, port, timeout=self.prefix_fetch_timeout_s)
                try:
                    conn.request(
                        "POST", "/prefix/ingest", body=blob,
                        headers={"Content-Type":
                                 "application/octet-stream"})
                    resp = conn.getresponse()
                    body = resp.read()
                finally:
                    conn.close()
                out = json.loads(body or b"{}") \
                    if resp.status == 200 else {}
                if out.get("stored") \
                        or out.get("reason") == "already_stored":
                    sent += 1
                    if out.get("stored"):
                        bytes_sent += len(blob)
                else:
                    failed += 1
            except (OSError, ValueError,
                    http.client.HTTPException):
                failed += 1
        with self._stats_lock:
            self._handoff_entries_total += sent
            self._handoff_bytes_total += bytes_sent
            self._handoff_failed_total += failed
        t_end = time.perf_counter()
        self._push_solo_events(
            [("prefix_handoff", t0, t_end,
              {"to": f"{host}:{port}", "entries": sent,
               "bytes": bytes_sent, "failed": failed})])
        return {"sent": sent, "bytes": bytes_sent,
                "failed": failed, "considered": len(ents),
                "wall_s": round(t_end - t0, 4)}

    def _prefix_wire_fetch(self, toks: np.ndarray,
                           hint: Dict[str, Any]):
        """Affinity-miss wire fetch (the client half): ask the router's
        holder for the entry, verify it, admit it through the host tier
        and serve THIS request from it.  Returns ``(PrefixHit,
        fetch_span_events)`` or None; every failure lands in
        ``prefix_fetch_failed_total{reason=}`` and falls back to a
        re-prefill.  No lock is held across any socket work."""
        host, port = hint.get("host"), hint.get("port")
        if not host or not port:
            self._note_fetch_failed("bad_hint")
            return None

        def _est(key):
            v = hint.get(key)
            try:
                return None if v is None else float(v)
            except (TypeError, ValueError):
                return None

        # Router-measured link estimates, when the hint carries them.
        link_bw = _est("wire_bytes_per_s")
        link_rtt = _est("rtt_s")
        n_tokens = int(toks.shape[1])
        ok, why = self.fetch_policy.should_fetch(
            n_tokens, 0, wire_bytes_per_s=link_bw, rtt_s=link_rtt)
        if not ok:
            self._note_fetch_failed(why)
            return None
        import http.client

        with self._stats_lock:
            self._fetch_attempts_total += 1
        t0 = time.perf_counter()
        blob = None
        try:
            conn = http.client.HTTPConnection(
                str(host), int(port),
                timeout=self.prefix_fetch_timeout_s)
            try:
                conn.request(
                    "POST", "/prefix/fetch",
                    body=json.dumps(
                        {"prompt": toks.tolist()}).encode(),
                    headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                if resp.status != 200:
                    resp.read()
                    self._note_fetch_failed(
                        "holder_miss" if resp.status == 404
                        else f"http_{resp.status}")
                    return None
                nbytes = int(resp.getheader("Content-Length") or 0)
                # The policy's second look, on the true size, before
                # the body transfer.
                ok, why = self.fetch_policy.should_fetch(
                    n_tokens, nbytes, wire_bytes_per_s=link_bw,
                    rtt_s=link_rtt)
                if not ok:
                    self._note_fetch_failed(why)
                    return None
                blob = resp.read()
            finally:
                conn.close()
        except (OSError, ValueError, http.client.HTTPException):
            self._note_fetch_failed("wire_error")
            return None
        try:
            ent_toks, leaves, pc, logits = unpack_spilled(blob)
        except WirePayloadError:
            self._note_fetch_failed("integrity")
            return None
        if ent_toks.shape[0] != toks.shape[0] or pc > n_tokens \
                or not np.array_equal(ent_toks, toks[:, :pc]):
            # Verified bytes but the WRONG prefix (a holder bug or a
            # stale hint): admitting it would poison the cache.
            self._note_fetch_failed("wrong_prefix")
            return None
        spilled = _SpilledPrefix(leaves, pc, logits)
        # Admit through the host tier (budget-gated), so later local
        # requests hit it without another wire trip...
        stored = False
        if spilled.nbytes <= self.kv_host_spill_bytes:
            with self._prefix_lock:
                anc = self._prefix.longest_ancestor(ent_toks)
                have = anc is not None and anc[0].shape[1] >= pc
                displaced = [] if have \
                    else self._prefix.store(ent_toks, spilled)
                stored = not have
            self._free_displaced(displaced)
            if stored:
                with self._stats_lock:
                    self._host_bytes += spilled.nbytes
                    self._host_entries += 1
                self._enforce_spill_budget()
        # ...then serve THIS request: the normal lookup when the entry
        # landed (promotion and shared pages included), else a direct
        # rematerialization — bitwise the same either way.
        try:
            hit = self._prefix_lookup(toks) if stored else None
            if hit is None:
                hit = self._rematerialize_hit(ent_toks, spilled, pc)
        except Exception:
            self._note_fetch_failed("rematerialize")
            self._note_prefix_error("lookup")
            return None
        t_end = time.perf_counter()
        with self._stats_lock:
            self._fetch_hits_total += 1
            self._fetch_bytes_total += len(blob)
        events = [("prefix_wire_fetch", t0, t_end,
                   {"holder": str(hint.get("replica")
                                  or f"{host}:{port}"),
                    "bytes": len(blob), "tokens": int(pc)})]
        return hit, events

    def _push_solo_events(self, events,
                          rid: Optional[str] = None) -> None:
        """Put span tuples on the shared trace ring (one fresh track),
        ``rid`` stamped into every span's args."""
        tid = self.telemetry.new_tid()
        for name, a, b, args in events:
            if rid is not None:
                args.setdefault("rid", rid)
            if a == b:
                self.telemetry.instant(tid, name, a, **args)
            else:
                self.telemetry.span(tid, name, a, b, **args)

    def prefill_prompt(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """POST /prefill: register a prompt (prefix) in the prefix
        cache — the system-prompt workflow.  Later requests whose
        prompt starts with it skip its prefill."""
        self._check_not_draining()
        if not self._prefix_enabled:
            raise ValueError(
                "prefix cache is disabled on this server "
                "(start with --prefix-cache N)"
                + (" — it disabled itself after a store error; see "
                   "/info prefix_store_errors"
                   if self._prefix_store_errors else ""))
        from ..models import generate as G

        rows = _parse_prompt_rows(req, self.max_batch)
        max_pos = self.model.cfg.max_position
        if len(rows[0]) > max_pos and not _is_ring(self.model):
            raise ValueError(f"prompt ({len(rows[0])}) exceeds the "
                             f"model's max_position ({max_pos})")
        chunk = req.get("prefill_chunk")
        try:
            chunk = None if chunk is None else _int_param(chunk)
        except (TypeError, ValueError):
            raise ValueError("prefill_chunk must be an int")
        if chunk is not None and chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        toks = np.asarray(rows, np.int64)
        t0 = time.perf_counter()
        with self._lock:
            logits, cache = G.prefill(self.model, toks, chunk=chunk)
            self._sync()
        # Outside the device lock: the paged store takes it again for
        # its page scatter.
        self._prefix_store_safe(toks, logits, cache)
        with self._stats_lock:
            self.requests += 1
            self._lat_sum += time.perf_counter() - t0
            self._lat_count += 1
        return {"cached_rows": toks.shape[0],
                "cached_len": toks.shape[1],
                "entries": len(self._prefix)}

    def _generate_prefix_cached(self, toks: np.ndarray, new: int,
                                temp, top_k, top_p, eos, chunk, seed,
                                hit: PrefixHit, deadline=None):
        """Solo decode of a MULTI-ROW prefix hit through the split
        programs: extend the stored prefill with the suffix (stored
        back, cold), then ``generate_continue`` — position-keyed when
        sampled, so a warm hit draws what a cold request would.  Holds
        the device lock for the whole decode (the reference's solo
        path).  Returns ``(tokens, (queue_s, prefill_s, decode_s))``."""
        from ..models import generate as G

        t0 = time.perf_counter()
        p_len = toks.shape[1]
        store_back = None
        try:
            with self._lock:
                t_lock = time.perf_counter()
                if deadline is not None and t_lock > deadline:
                    raise DeadlineExceeded(
                        "deadline exceeded waiting for the device "
                        "(prefix-cache solo path)")
                pc, logits, cache = hit.p_cached, hit.logits, hit.cache
                if pc < p_len:
                    logits, cache = G.prefill(
                        self.model, toks[:, pc:], chunk=chunk,
                        cache=cache, position=pc)
                    store_back = (logits, cache.clone())
                t_pf = time.perf_counter()
                if G.positional_eligible(self.model, temp):
                    out_new = G.generate_continue_positional(
                        self.model, cache, logits, p_len,
                        max_new_tokens=new, seed=seed, temperature=temp,
                        top_k=top_k or 0, top_p=top_p or 0.0,
                        eos_id=eos, _validated=True)
                else:
                    out_new = G.generate_continue(
                        self.model, cache, logits, p_len,
                        max_new_tokens=new, temperature=temp,
                        top_k=top_k, top_p=top_p, eos_id=eos,
                        _validated=True)
                out_new = host_copy(out_new).numpy()
                self._sync()
                t_end = time.perf_counter()
        finally:
            # The solo path never maps shared pages into a slot.
            self._unpin_prefix(hit.pins)
        if store_back is not None:
            self._prefix_store_safe(toks, *store_back, hot=False)
        out = np.concatenate([toks, out_new], axis=1)
        return out, (t_lock - t0, t_pf - t_lock, t_end - t_pf)

    # -- /generate -------------------------------------------------------

    def generate(self, req: Dict[str, Any],
                 cancel_check=None,
                 rid: Optional[str] = None) -> Dict[str, Any]:
        if rid is None:
            rid = new_request_id()
        self._check_not_draining()
        if self.role == "prefill":
            # A role-split fleet never routes /generate here; a direct
            # caller gets the typed 400.
            raise ValueError(
                "this replica runs role='prefill': it serves "
                "/prefill and /prefix/* only — send /generate to a "
                "decode-capable replica (role 'decode' or 'both')")
        rows = _parse_prompt_rows(req, self.max_batch)
        from ..models.generate import check_decoder_only

        check_decoder_only(self.model)
        _int = _int_param

        def _float(v):
            # float(True) == 1.0: {"temperature": true} must not
            # silently switch greedy to temp-1.0 sampling.
            if isinstance(v, bool):
                raise ValueError("expected a number, got a boolean")
            return float(v)

        try:
            new = _int(req.get("max_new_tokens", 32))
            temp = _float(req.get("temperature", 0.0))
            top_k = req.get("top_k")
            top_k = None if top_k is None else _int(top_k)
            top_p = req.get("top_p")
            top_p = None if top_p is None else _float(top_p)
            eos = req.get("eos_id")
            eos = None if eos is None else _int(eos)
            beams = _int(req.get("num_beams", 1))
            seed = _int(req.get("seed", 0))
        except (TypeError, ValueError):
            raise ValueError(
                "sampling params must be scalars (temperature/top_p "
                "float, max_new_tokens/top_k/eos_id/num_beams/seed "
                "int, not booleans)")
        if new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        from ..models.generate import (SPEC_BEAM_MSG, _check_spec_k,
                                       _check_temperature, _check_top_k,
                                       _check_top_p)

        _check_top_k(top_k, getattr(getattr(self.model, "cfg", None),
                                    "vocab_size", None))
        _check_top_p(top_p)
        _check_temperature(temp)
        if beams > 1 and (temp != 0.0 or top_k is not None
                          or top_p is not None):
            raise ValueError(
                "beam search is deterministic; temperature/top_k/"
                "top_p cannot be combined with num_beams > 1")
        speculative = req.get("speculative", False)
        if not isinstance(speculative, bool):
            raise ValueError("'speculative' must be a JSON boolean")
        want_timings = req.get("timings", False)
        if not isinstance(want_timings, bool):
            raise ValueError("'timings' must be a JSON boolean")
        priority = req.get("priority", self.default_priority)
        if priority not in PRIORITIES:
            raise ValueError(
                f"priority must be one of {list(PRIORITIES)}; got "
                f"{priority!r}")
        deadline_ms = req.get("deadline_ms")
        if deadline_ms is not None:
            try:
                deadline_ms = _int(deadline_ms)
            except (TypeError, ValueError):
                raise ValueError("deadline_ms must be an int")
            if deadline_ms < 1:
                raise ValueError("deadline_ms must be >= 1")
        deadline_s = None if deadline_ms is None else deadline_ms / 1e3
        spec_k = 0
        if speculative:
            if self.draft_model is None:
                raise ValueError(
                    "server has no draft model (start with "
                    "--draft-model to enable speculative decoding)")
            if beams > 1:
                raise ValueError(SPEC_BEAM_MSG)
            if temp == 0.0 and (top_k is not None or top_p is not None):
                raise ValueError(
                    "speculative top_k/top_p need temperature > 0 "
                    "(temperature=0 is greedy and would ignore them)")
            try:
                spec_k = _int(req.get("spec_k", self.spec_k_default))
            except (TypeError, ValueError):
                raise ValueError("spec_k must be an int")
            _check_spec_k(spec_k)
        chunk = req.get("prefill_chunk")
        try:
            chunk = None if chunk is None else _int(chunk)
        except (TypeError, ValueError):
            raise ValueError("prefill_chunk must be an int")
        if chunk is not None and chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        p_len = len(rows[0])
        if chunk is not None and chunk >= p_len:
            chunk = None
        # CROSS-REPLICA RESUME: ``resume_tokens: N`` declares the
        # trailing N prompt tokens a prior attempt's committed output (a
        # router failover replaying ``prompt ++ tokens_so_far``); the
        # engine re-enters it through the preempt-resume machinery, so
        # the draws continue at position key N, token-identically.
        resume_tokens = req.get("resume_tokens", 0)
        try:
            resume_tokens = _int(resume_tokens)
        except (TypeError, ValueError):
            raise ValueError("resume_tokens must be an int")
        if resume_tokens < 0:
            raise ValueError("resume_tokens must be >= 0")
        if resume_tokens:
            if beams > 1:
                raise ValueError(
                    "resume_tokens cannot combine with beam search "
                    "(beam requests replay whole)")
            if self.engine is None:
                raise ValueError(
                    "resume_tokens requires the continuous-batching "
                    f"engine (batching={self.batching!r})")
            if len(rows) != 1:
                raise ValueError(
                    "resume_tokens takes a single-row request")
        # The EFFECTIVE prompt length: what the slot holds (a resume
        # replay's original prompt, not the concatenation).
        eff_p_len = p_len - resume_tokens
        if resume_tokens and eff_p_len < 1:
            raise ValueError(
                f"resume_tokens ({resume_tokens}) must leave at least "
                f"one original prompt token (prompt length {p_len})")
        # Capacity of every model the request touches: speculative
        # rounds touch spec_k - 1 positions past the last committed
        # token.
        slack = (spec_k - 1) if speculative else 0
        models = [("model", self.model)]
        if speculative:
            models.append(("draft model", self.draft_model))
        for label, m in models:
            max_pos = m.cfg.max_position
            if _is_ring(m):
                ring_slack = m.cfg.kv_cache_ring_slack
                if speculative and ring_slack < spec_k - 1:
                    raise ValueError(
                        f"{label} needs kv_cache_ring_slack >= "
                        f"{spec_k - 1} for spec_k={spec_k} "
                        f"(got {ring_slack})")
                continue  # ring caches are position-keyed, unbounded
            if eff_p_len + new + slack > max_pos:
                raise ValueError(
                    f"prompt ({eff_p_len}) + max_new_tokens ({new})"
                    + (f" + spec_k-1 ({slack})" if slack else "")
                    + f" exceeds the {label}'s max_position "
                    f"({max_pos})")
        toks = np.asarray(rows, np.int64)
        # temperature 0 is greedy (top_k/top_p inert, as in solo
        # generate); temperature > 0 samples per slot, position-keyed;
        # speculative streams draft/verify per round in a spec slot.
        if speculative:
            sampling = SamplingSpec(seed, temp, top_k, top_p,
                                    spec_k=spec_k)
        else:
            sampling = SamplingSpec(seed, temp, top_k, top_p) \
                if temp != 0.0 else None
        # Engine eligibility: every non-beam request; on a draft-capable
        # server a spec_k over the cap, or a budget within cap - 1 of
        # max_position (the pool's verify chunks are cap + 1 wide),
        # decodes solo instead.  Engine-less modes decode solo (plain
        # greedy requests through the coalescer under "coalesce").
        engine_ok = self.engine is not None and beams == 1
        if speculative and self.engine is None:
            self._note_fallback(
                "speculative",
                f"batching={self.batching!r} has no decode engine; "
                f"speculative requests hold the device lock for a "
                f"whole solo decode")
        if engine_ok and self.draft_model is not None:
            cap = self.spec_k_default
            if speculative and spec_k > cap:
                engine_ok = False
                self._note_fallback(
                    "speculative (spec_k over cap)",
                    f"request spec_k {spec_k} exceeds the engine cap "
                    f"{cap} (--spec-k); decoding solo")
            elif not _is_ring(self.model) and (
                    eff_p_len + new + cap - 1
                    > self.model.cfg.max_position
                    or eff_p_len + new + cap - 1
                    > self.draft_model.cfg.max_position):
                engine_ok = False
                self._note_fallback(
                    "near-capacity",
                    f"prompt + max_new_tokens within {cap - 1} tokens "
                    f"of max_position cannot co-tenant a speculative "
                    f"pool (verify chunks are {cap + 1} wide); "
                    f"decoding solo")
        if resume_tokens and not engine_ok:
            # Solo paths have no resume machinery: silently restarting
            # the draws at index 0 would break token identity.
            raise ValueError(
                "resume_tokens requires the engine path for this "
                "request (it fell back solo); replay the request "
                "without resume_tokens instead")
        t0 = time.perf_counter()
        # Prefix-cache hit (registered via /prefill, a stored-back
        # session, a spilled entry, or a holder's over the wire): a
        # single-row hit rides the engine seeded with the stored
        # prefill (paged: its full pages mapped read-only); a multi-row
        # hit decodes on the solo split path.  Beam and speculative
        # requests stay cold (the draft has no stored prefill; beams
        # tile the cache), and so do resume replays (the replayed
        # tokens ARE the state).
        prefix_hit = None
        fetch_events = None
        if self._prefix_enabled and beams == 1 and not speculative \
                and not resume_tokens \
                and (engine_ok or self.engine is None):
            prefix_hit = self._prefix_lookup_safe(toks)
            if prefix_hit is None and self.prefix_fetch \
                    and isinstance(req.get("prefix_hint"), dict):
                # Local miss + a router hint naming the holder: try the
                # fleet tier; any failure is a counted re-prefill.
                fetched = self._prefix_wire_fetch(
                    np.asarray(toks, np.int32), req["prefix_hint"])
                if fetched is not None:
                    prefix_hit, fetch_events = fetched
        # Where this request's prefill came from (the router learns
        # holders from it).
        if prefix_hit is None:
            prefix_source = "re_prefill"
        elif fetch_events is not None:
            prefix_source = "wire_fetch"
        elif prefix_hit.source == "host":
            prefix_source = "local_spilled"
        else:
            prefix_source = "local_hot"
        # The coalescer merges plain greedy requests ONLY — beam and
        # speculative greedy requests keep their solo programs.
        greedy = temp == 0.0 and beams == 1 and not speculative
        group = None
        solo_events = None
        breakdown = None
        coalesced = False
        if prefix_hit is not None and engine_ok and toks.shape[0] == 1:
            pc = prefix_hit.p_cached
            try:
                group = self.engine.submit(
                    toks, new, eos, chunk, sampling=sampling,
                    prefix=(pc, prefix_hit.logits, prefix_hit.cache),
                    on_prefilled=self._store_stream_prefix,
                    record_timings=want_timings, priority=priority,
                    deadline_s=deadline_s,
                    shared_pages=prefix_hit.pins or None, rid=rid,
                    prefix_info={"cached_tokens": pc,
                                 "shared_pages":
                                     len(prefix_hit.pins or ()),
                                 "source": prefix_source},
                    pre_events=fetch_events)
            except BaseException:
                self._unpin_prefix(prefix_hit.pins)
                raise
            if fetch_events:
                # The fetch span also rides the shared trace ring.
                self._push_solo_events(list(fetch_events), rid=rid)
        elif prefix_hit is not None:
            out, breakdown = self._generate_prefix_cached(
                toks, new, temp, top_k, top_p, eos, chunk, seed,
                prefix_hit, deadline=t0 + deadline_s
                if deadline_s is not None else None)
            t_end = time.perf_counter()
            solo_events = [("prefix_solo", t0, t_end,
                            {"rows": len(rows)}),
                           ("complete", t_end, t_end, {})]
            if fetch_events:
                self._push_solo_events(list(fetch_events), rid=rid)
                solo_events = list(fetch_events) + solo_events
            tid = self.telemetry.new_tid()
            self.telemetry.span(tid, "prefix_solo", t0, t_end, rid=rid,
                                rows=len(rows))
        elif engine_ok:
            # CONTINUOUS BATCHING: per-row decode streams through the
            # slot pool.  May raise QueueFullError -> 429, ShedError
            # -> 503.
            group = self.engine.submit(toks, new, eos, chunk,
                                       sampling=sampling,
                                       record_timings=want_timings,
                                       priority=priority,
                                       deadline_s=deadline_s, rid=rid,
                                       resume_tokens=resume_tokens)
        elif greedy and self._coalescer is not None:
            # The deadline is honored INSIDE the coalescer, at its one
            # boundary (post-lock, pre-dispatch).  Its queue wait is its
            # device-lock wait, folded into one opaque span.
            out = self._coalescer.generate(
                toks, p_len, new, eos, chunk, deadline=t0 + deadline_s
                if deadline_s is not None else None)
            coalesced = True
            t_end = time.perf_counter()
            solo_events = [("coalesce_decode", t0, t_end,
                            {"rows": len(rows)}),
                           ("complete", t_end, t_end, {})]
            tid = self.telemetry.new_tid()
            self.telemetry.span(tid, "coalesce_decode", t0, t_end,
                                rid=rid, rows=len(rows))
        else:
            from ..models import generate as G

            if speculative:
                kind = "spec_pos" if temp != 0.0 else "spec"
                width = spec_k
            elif beams > 1:
                kind, width = "beam", beams
            else:
                kind = "sample_pos" \
                    if G.positional_eligible(self.model, temp) \
                    else "sample"
                width = 1
            key = (kind, len(rows), p_len, new, temp, top_k, top_p, eos,
                   width, chunk)
            out, breakdown = self._generate_solo(
                key, toks, seed, deadline=t0 + deadline_s
                if deadline_s is not None else None)
            t_end = time.perf_counter()
            solo_events = [("queue", t0, t0 + breakdown[0],
                            {"kind": kind}),
                           ("solo_decode", t0 + breakdown[0], t_end,
                            {"kind": kind, "rows": len(rows)}),
                           ("complete", t_end, t_end, {})]
            tid = self.telemetry.new_tid()
            self.telemetry.span(tid, "solo_decode", t0 + breakdown[0],
                                t_end, rid=rid, kind=kind,
                                rows=len(rows))
        if group is not None:
            self._wait_group(group, cancel_check)
            out = group.result()
            breakdown = group.breakdown()
        with self._stats_lock:
            if not coalesced:   # the coalescer counts its batches' own
                self.requests += 1
            if prefix_hit is not None:
                self.prefix_hits += 1
                self.prefix_hit_tokens += prefix_hit.p_cached
        dt = time.perf_counter() - t0
        if breakdown is not None:
            self._note_breakdown(*breakdown)
            tokens_done = len(rows) * new if group is None \
                else sum(len(s.out) for s in group.streams)
            # Histogram KEY (telemetry.HIST_SPECS), not a ledger
            # phase reference.  # ptpu: ignore[PHASE-ENUM]
            self.telemetry.observe("queue_wait", breakdown[0],
                                   exemplar=rid)
            self.telemetry.observe("prefill", breakdown[1], exemplar=rid)
            self.telemetry.observe(
                "decode_per_token", breakdown[2] / max(1, tokens_done),
                exemplar=rid)
        # A solo program delivers every token at once: its TTFT is the
        # whole latency.
        ttft = dt
        if group is None and engine_ok:
            ttft = breakdown[0] + breakdown[1]
        elif group is not None and group.t_first_admit is not None:
            ttft = group.t_first_admit - group.t_submit
        self.telemetry.observe("ttft", ttft, exemplar=rid)
        self.telemetry.observe("total", dt, exemplar=rid)
        ledger = None
        if group is not None and want_timings:
            all_events: List = []
            for s in group.streams:
                if s.events:
                    all_events.extend(s.events)
            t_done = group.t_done if group.t_done is not None \
                else t0 + dt
            ledger = compute_ledger(all_events, group.t_submit, t_done)
        elif solo_events is not None \
                and (want_timings or self.forensics is not None):
            ledger = compute_ledger(solo_events, t0, t0 + dt, solo=True)
            if self.forensics is not None:
                self.forensics.note(ledger, rid)
        timings = None
        if want_timings:
            timings = {"ttft_ms": round(1e3 * ttft, 3)}
            if group is not None:
                timings["streams"] = [
                    {"row": s.row,
                     "spans": _span_dicts(s.events or [],
                                          group.t_submit)}
                    for s in group.streams]
            else:
                timings["spans"] = _span_dicts(solo_events, t0)
            timings["phases"] = ledger
        with self._stats_lock:
            self._lat_sum += dt
            self._lat_count += 1
            self._tokens_out += len(rows) * new
        eng_fields: Dict[str, Any] = {}
        if group is not None:
            slots_used = [s.last_slot for s in group.streams
                          if s.last_slot is not None]
            if slots_used:
                eng_fields["slot"] = slots_used[0] \
                    if len(slots_used) == 1 else slots_used
            pre = sum(s.preempts for s in group.streams)
            res = sum(s.resumes for s in group.streams)
            if pre or res:
                eng_fields["preempts"] = pre
                eng_fields["resumes"] = res
        return {
            "model": self.model_name,
            "request_id": rid,
            "new_tokens": out[:, p_len:].tolist(),
            "tokens": out.tolist(),
            "wall_s": round(dt, 4),
            "tok_per_sec": round(len(rows) * new / dt, 1),
            **eng_fields,
            "ttft_ms": round(1e3 * ttft, 3),
            **({"queue_ms": round(1e3 * breakdown[0], 3),
                "prefill_ms": round(1e3 * breakdown[1], 3),
                "decode_ms": round(1e3 * breakdown[2], 3)}
               if breakdown is not None else {}),
            **({"prefix_hit_len": prefix_hit.p_cached}
               if prefix_hit is not None else {}),
            **({"prefix_source": prefix_source}
               if self._prefix_enabled else {}),
            # The wire fetch's measured size and wall (the router's
            # link calibration).
            **({"prefix_fetch_bytes": fetch_events[0][3]["bytes"],
                "prefix_fetch_s": round(
                    fetch_events[0][2] - fetch_events[0][1], 6)}
               if fetch_events else {}),
            **({"timings": timings} if timings is not None else {}),
        }

    # -- introspection --------------------------------------------------

    def _spill_stats(self) -> Dict[str, Any]:
        """The host tier's and the wire lanes' counters: ONE dict that
        /metrics and /info both render."""
        with self._stats_lock:
            return {
                "kv_host_spill_bytes": self._host_bytes,
                "kv_host_spill_bytes_budget":
                    self.kv_host_spill_bytes,
                "kv_host_entries": self._host_entries,
                "kv_host_spills_total": self._host_spills_total,
                "kv_host_dropped_total": self._host_dropped_total,
                "kv_rematerialize_hits_total": self._remat_hits_total,
                "kv_rematerialize_bytes_total":
                    self._remat_bytes_total,
                "kv_promotions_total": self._promotions_total,
                "prefix_fetch_total": self._fetch_attempts_total,
                "prefix_fetch_hits_total": self._fetch_hits_total,
                "prefix_fetch_bytes_total": self._fetch_bytes_total,
                "prefix_fetch_failed": dict(self._fetch_failed),
                "prefix_ingest_total": self._ingest_total,
                "prefix_ingest_rejected_total":
                    self._ingest_rejected_total,
                "prefix_handoff_entries_total":
                    self._handoff_entries_total,
                "prefix_handoff_bytes_total":
                    self._handoff_bytes_total,
                "prefix_handoff_failed_total":
                    self._handoff_failed_total,
                "prefix_evict_hints_total": self._evict_hints_total,
            }

    def info(self) -> Dict[str, Any]:
        cfg = getattr(self.model, "cfg", None)
        summary = {}
        if cfg is not None:
            for f in ("vocab_size", "hidden_size", "num_layers",
                      "num_heads", "max_position", "kv_cache_int8"):
                v = getattr(cfg, f, None)
                if v is not None:
                    summary[f] = v
            summary["dtype"] = str(cfg.dtype).removeprefix("torch.")
            if getattr(cfg, "kv_cache_ring", False):
                summary["kv_cache_ring"] = True
                summary["kv_cache_ring_slack"] = cfg.kv_cache_ring_slack
        engine = self.engine.stats() if self.engine is not None else {}
        if self.engine is not None:
            routing = {"greedy": "engine", "sampled": "engine",
                       "speculative": "engine"
                       if self.draft_model is not None
                       else "unavailable (no draft model)",
                       "beam": "solo"}
        else:
            routing = {"greedy": "coalesce"
                       if self.batching == "coalesce" else "solo",
                       "sampled": "solo",
                       "speculative": "solo"
                       if self.draft_model is not None
                       else "unavailable (no draft model)",
                       "beam": "solo"}
        compile_cache = self.recompile.snapshot()
        with self._stats_lock:
            fallbacks = {k: dict(v)
                         for k, v in self.solo_fallbacks.items()}
        return {"model": self.model_name, "config": summary,
                "backend": self.model.device.type,
                "max_batch": self.max_batch,
                "batching": self.batching,
                "role": self.role,
                "default_priority": self.default_priority,
                "draining": self.draining,
                "drain_rejected_total": self.drain_rejected,
                "routing": routing,
                "solo_fallbacks": fallbacks,
                "spec_k_default": self.spec_k_default,
                "kv_paged": self.kv_paged,
                "kv_lazy": self.kv_lazy,
                # The host tier and the wire lanes (the same dict
                # /metrics renders), and the fetch client's policy.
                **(self._spill_stats() if self.kv_paged else {}),
                "prefix_fetch": self.prefix_fetch,
                **({"prefix_fetch_policy":
                    self.fetch_policy.describe()}
                   if self.prefix_fetch else {}),
                "int8_weights": has_quantized(
                    getattr(self.model, "replicas", [self.model])[0]),
                # A compile-cache miss is a CUDA-graph capture (the
                # first eager run of a window on the CPU).
                "compile_cache_misses":
                    compile_cache["compile_cache_misses"],
                "compile_cache": compile_cache,
                **({"sanitizer": self.sanitizer.stats()}
                   if self.sanitizer is not None else {}),
                "debug": {
                    **self.history.stats(),
                    **({"watchdog": self.watchdog.status()}
                       if self.watchdog is not None else {})},
                # Flight-recorder attribution (serving/profiling.py):
                # the SAME published record /metrics and GET
                # /profile/report render.
                **({"profiling": self.recorder.info_block()}
                   if self.recorder is not None else {}),
                "requests": self.requests,
                "coalesced_batches": self.coalesced_batches,
                "coalesced_requests": self.coalesced_requests,
                # Prefix cache (the degradation ladder's error count
                # and live enabled flag included).
                "prefix_cache": self.prefix_cache_size,
                "prefix_entries": len(self._prefix),
                "prefix_hits": self.prefix_hits,
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "prefix_store_skips": self._prefix_store_skips,
                "prefix_store_errors": self._prefix_store_errors,
                "prefix_enabled": self._prefix_enabled,
                # Fault tolerance: the supervisor block and the armed
                # plan (the flat counters ride the engine passthrough).
                **({"supervisor": self.supervisor.status()}
                   if self.supervisor is not None else {}),
                **({"fault_plan": self.faults.stats()}
                   if self.faults is not None else {}),
                **{k: v for k, v in engine.items()
                   if not k.startswith("compile_cache")},
                **self.extra_info}

    def metrics_text(self) -> str:
        """Prometheus text exposition of the serving counters, the
        per-request queue/prefill/decode phase summaries, the latency
        histograms and the engine gauges."""
        es = self.engine.stats() if self.engine is not None else {}
        with self._stats_lock:
            lat_sum, lat_count = self._lat_sum, self._lat_count
            toks, errs = self._tokens_out, self.errors
            q_sum, p_sum, d_sum, bd_count = (
                self._queue_s_sum, self._prefill_s_sum,
                self._decode_s_sum, self._breakdown_count)
        lines = [
            "# TYPE ptpu_serving_requests_total counter",
            f"ptpu_serving_requests_total {self.requests}",
            "# TYPE ptpu_serving_errors_total counter",
            f"ptpu_serving_errors_total {errs}",
            "# TYPE ptpu_serving_rejected_total counter",
            f"ptpu_serving_rejected_total "
            f"{es.get('rejected_total', 0)}",
            "# TYPE ptpu_serving_tokens_generated_total counter",
            f"ptpu_serving_tokens_generated_total {toks}",
            "# TYPE ptpu_serving_coalesced_batches_total counter",
            f"ptpu_serving_coalesced_batches_total "
            f"{self.coalesced_batches}",
            "# TYPE ptpu_serving_coalesced_requests_total counter",
            f"ptpu_serving_coalesced_requests_total "
            f"{self.coalesced_requests}",
            "# TYPE ptpu_serving_request_seconds summary",
            f"ptpu_serving_request_seconds_sum {lat_sum:.6f}",
            f"ptpu_serving_request_seconds_count {lat_count}",
            "# TYPE ptpu_serving_queue_seconds summary",
            f"ptpu_serving_queue_seconds_sum {q_sum:.6f}",
            f"ptpu_serving_queue_seconds_count {bd_count}",
            "# TYPE ptpu_serving_prefill_seconds summary",
            f"ptpu_serving_prefill_seconds_sum {p_sum:.6f}",
            f"ptpu_serving_prefill_seconds_count {bd_count}",
            "# TYPE ptpu_serving_decode_seconds summary",
            f"ptpu_serving_decode_seconds_sum {d_sum:.6f}",
            f"ptpu_serving_decode_seconds_count {bd_count}",
            "# TYPE ptpu_serving_drain_rejected_total counter",
            f"ptpu_serving_drain_rejected_total {self.drain_rejected}",
            "# TYPE ptpu_serving_prefix_hits_total counter",
            f"ptpu_serving_prefix_hits_total {self.prefix_hits}",
            "# TYPE ptpu_serving_prefix_entries gauge",
            f"ptpu_serving_prefix_entries {len(self._prefix)}",
            "# TYPE ptpu_serving_prefix_hit_tokens_total counter",
            f"ptpu_serving_prefix_hit_tokens_total "
            f"{self.prefix_hit_tokens}",
            "# TYPE ptpu_serving_prefix_store_skips_total counter",
            f"ptpu_serving_prefix_store_skips_total "
            f"{self._prefix_store_skips}",
            "# TYPE ptpu_serving_prefix_store_errors_total counter",
            f"ptpu_serving_prefix_store_errors_total "
            f"{self._prefix_store_errors}",
            "# TYPE ptpu_serving_stalls_total counter",
            f"ptpu_serving_stalls_total "
            f"{self.watchdog.stalls_total if self.watchdog else 0}",
            "# TYPE ptpu_serving_request_records gauge",
            f"ptpu_serving_request_records {len(self.history)}",
            "# TYPE ptpu_serving_request_records_evicted_total "
            "counter",
            f"ptpu_serving_request_records_evicted_total "
            f"{self.history.evicted_total}",
        ]
        lines += render_compile_cache(self.recompile.snapshot())
        if self.recorder is not None:
            # The flight recorder's attribution gauges, rendered from
            # the SAME record GET /profile/report returns.
            lines += self.recorder.metrics_lines()
        lines += self.telemetry.metrics_lines()
        if self.forensics is not None:
            lines += self.forensics.metrics_lines("ptpu_serving")
        if self.engine is not None:
            gauges = ("slots", "slots_active", "slot_occupancy",
                      "queue_len", "queue_depth", "queue_len_interactive",
                      "queue_len_batch")
            counters = ("admitted_total", "admitted_interactive_total",
                        "admitted_batch_total", "admitted_greedy_total",
                        "admitted_sampled_total", "admitted_spec_total",
                        "completed_total", "completed_greedy_total",
                        "completed_sampled_total", "completed_spec_total",
                        "spec_rounds_total", "spec_drafted_total",
                        "spec_accepted_total",
                        "evicted_total", "cancelled_total", "shed_total",
                        "shed_interactive_total", "shed_batch_total",
                        "decode_steps_total", "decode_dispatches_total",
                        "prefill_chunks_total", "telemetry_errors_total",
                        "step_device_seconds_total",
                        "step_wall_seconds_total", "shed_kv_pages_total",
                        "kv_preempt_exhaustion_total", "preempted_total",
                        "requests_requeued_total", "resumed_total",
                        "step_retries_total", "poisoned_total",
                        "engine_crashes_total", "engine_restarts_total")
            for key in gauges:
                lines += [f"# TYPE ptpu_serving_{key} gauge",
                          f"ptpu_serving_{key} {es[key]}"]
            for key in counters:
                lines += [f"# TYPE ptpu_serving_{key} counter",
                          f"ptpu_serving_{key} {es[key]}"]
            if "kv_pages" in es:
                # The page pool's occupancy (kv_paged engines only).
                for key in ("kv_pages", "kv_page_tokens", "kv_pages_free",
                            "kv_pages_resident", "kv_pages_shared"):
                    lines += [f"# TYPE ptpu_serving_{key} gauge",
                              f"ptpu_serving_{key} {es[key]}"]
                lines += ["# TYPE ptpu_serving_kv_lazy gauge",
                          f"ptpu_serving_kv_lazy {1 if es['kv_lazy'] else 0}"]
                for key in ("kv_pages_lazy_growths_total",
                            "kv_pages_lazy_grown_total"):
                    lines += [f"# TYPE ptpu_serving_{key} counter",
                              f"ptpu_serving_{key} {es[key]}"]
                # The host tier and the wire lanes (the _spill_stats dict
                # /info renders).  The fetch-failure family's TYPE line
                # renders before its first labelled sample.
                sp = self._spill_stats()
                for key, kind in (
                        ("kv_host_spill_bytes", "gauge"),
                        ("kv_host_entries", "gauge"),
                        ("kv_host_spills_total", "counter"),
                        ("kv_rematerialize_hits_total", "counter"),
                        ("kv_rematerialize_bytes_total", "counter"),
                        ("kv_host_dropped_total", "counter"),
                        ("kv_promotions_total", "counter"),
                        ("prefix_fetch_total", "counter"),
                        ("prefix_fetch_hits_total", "counter"),
                        ("prefix_fetch_bytes_total", "counter")):
                    lines += [f"# TYPE ptpu_serving_{key} {kind}",
                              f"ptpu_serving_{key} {sp[key]}"]
                lines.append("# TYPE ptpu_serving_prefix_fetch_failed_total "
                             "counter")
                lines += [f'ptpu_serving_prefix_fetch_failed_total'
                          f'{{reason="{r}"}} {n}'
                          for r, n in sorted(
                              sp["prefix_fetch_failed"].items())]
                for key in ("prefix_ingest_total",
                            "prefix_ingest_rejected_total",
                            "prefix_handoff_entries_total",
                            "prefix_handoff_bytes_total",
                            "prefix_handoff_failed_total",
                            "prefix_evict_hints_total"):
                    lines += [f"# TYPE ptpu_serving_{key} counter",
                              f"ptpu_serving_{key} {sp[key]}"]
            if "mesh" in es:
                # Mesh topology (meshed engines only): the device count
                # and one axis-size sample per active axis.
                lines += [
                    "# TYPE ptpu_serving_mesh_devices gauge",
                    f"ptpu_serving_mesh_devices {es['mesh_devices']}",
                    "# TYPE ptpu_serving_mesh_axis_size gauge",
                    *[f'ptpu_serving_mesh_axis_size{{axis="{axis}"}} '
                      f'{size}'
                      for axis, size in sorted(es["mesh"]["axes"].items())]]
            lines += [
                "# TYPE ptpu_serving_deadline_expired_total counter",
                f"ptpu_serving_deadline_expired_total "
                f"{es['expired_total']}",
                "# TYPE ptpu_serving_draining gauge",
                f"ptpu_serving_draining {1 if es['draining'] else 0}",
                # Fault tolerance: the down latch, the breaker as a 0/1
                # open gauge and the per-site injected-fault family.
                "# TYPE ptpu_serving_engine_down gauge",
                f"ptpu_serving_engine_down {1 if es['engine_down'] else 0}",
                "# TYPE ptpu_serving_breaker_open gauge",
                f"ptpu_serving_breaker_open "
                f"{1 if es['breaker_state'] == 'open' else 0}",
                "# TYPE ptpu_serving_faults_injected_total counter",
                *[f'ptpu_serving_faults_injected_total{{site="{site}"}} {n}'
                  for site, n in sorted(es["faults_injected"].items())],
            ]
            # Per-request acceptance rate of completed speculative streams
            # (accepted / drafted), one histogram family.
            lines += render_histogram(
                "ptpu_serving_spec_accept_rate", es["spec_accept_buckets"],
                es["spec_accept_hist"], es["spec_accept_sum"],
                es["spec_accept_count"])
        # The process's flash kernel launches: decode and prefill take
        # plain attention, so a served model's stay at 0.
        from ..ops import flash
        for name, count in (("fwd", flash.launch_count),
                            ("bwd_dq", flash.dq_launch_count),
                            ("bwd_dkv", flash.dkv_launch_count)):
            lines += [f"# TYPE ptpu_flash_{name}_launches_total counter",
                      f"ptpu_flash_{name}_launches_total {count}"]
        return "\n".join(lines) + "\n"


def _disconnect_probe(conn):
    """A zero-cost poll for "is the client still there?" while a
    handler waits on an engine group: after the request body a
    well-behaved client sends nothing until the response, so a
    readable socket whose peek returns b"" means the peer closed."""
    def check() -> bool:
        try:
            p = select.poll()
            p.register(conn.fileno(), select.POLLIN)
            if not p.poll(0):
                return False
            return conn.recv(1, socket.MSG_PEEK) == b""
        except (OSError, ValueError):
            return True     # probe failed: the socket is gone
    return check


class _ServingHTTPServer(ThreadingHTTPServer):
    # The admission queue, not the listen backlog, is the intended
    # backpressure surface (the stdlib default backlog is 5).
    request_queue_size = 128
    daemon_threads = True


def make_server(host: str, port: int, ms: ModelServer
                ) -> ThreadingHTTPServer:
    return _ServingHTTPServer((host, port), make_handler(ms))


def make_handler(ms: ModelServer):
    """The request-handler CLASS for ``ms`` (what ``make_server``
    binds)."""
    class Handler(BaseHTTPRequestHandler):
        def _req_id(self) -> str:
            rid = sanitize_request_id(
                self.headers.get("X-Request-Id"))
            self._rid = rid or new_request_id()
            return self._rid

        def _send_raw(self, code: int, body: bytes, ctype: str,
                      extra=None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            rid = getattr(self, "_rid", None)
            if rid is None:
                rid = self._rid = new_request_id()
            self.send_header("X-Request-Id", rid)
            for k, v in (extra or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send(self, code: int, obj: Dict[str, Any],
                  extra=None) -> None:
            self._send_raw(code, json.dumps(obj).encode(),
                           "application/json", extra)

        def log_message(self, fmt, *args):
            pass  # the structured access log (--access-log) replaces it

        def do_GET(self):
            self._req_id()
            path = urlparse(self.path).path
            if path == "/requests" or path.startswith("/requests/") \
                    or path == "/debug/state":
                self._do_debug_get(path)
            elif path == "/healthz":
                # One not-ready schema for every cause: draining, or
                # the engine down (breaker open, or a lost device).
                if ms.draining:
                    self._send(503, {"status": "unavailable",
                                     "reason": "draining",
                                     "model": ms.model_name,
                                     **ms.drain_status()})
                elif ms.engine is not None and ms.engine.down:
                    self._send(503, {
                        "status": "unavailable",
                        "reason": "engine_down",
                        "model": ms.model_name,
                        **({"supervisor": ms.supervisor.status()}
                           if ms.supervisor is not None else {})})
                else:
                    # ``role`` rides the 200 body, so the router's
                    # probes learn the fleet's prefill/decode split.
                    self._send(200, {"status": "ok",
                                     "model": ms.model_name,
                                     "role": ms.role,
                                     "t": time.time()})
            elif path == "/info":
                self._send(200, ms.info())
            elif path == "/metrics":
                self._send_raw(200, ms.metrics_text().encode(),
                               "text/plain; version=0.0.4")
            elif path == "/trace":
                self._send(200, ms.telemetry.chrome_trace())
            elif path == "/anomalies":
                # The anomaly sentry's ranked findings and baselines
                # (serving/forensics.py).
                if ms.forensics is None:
                    self._send(400, {
                        "error": "forensics disabled (start the "
                                 "server with forensics enabled)"})
                else:
                    self._send(200, ms.forensics.report())
            elif path == "/debug/exemplars":
                # Every latency histogram's per-bucket request-ID
                # exemplars, all K kept (/metrics carries the latest).
                self._send(200, ms.telemetry.exemplars_report())
            elif path == "/prefix/index":
                # Fleet inventory: stable entry keys, tiers and hits.
                if not ms.kv_paged:
                    self._send(400, {
                        "error": "prefix index requires a paged "
                                 "engine (--kv-paged)"})
                else:
                    self._send(200, ms.prefix_index())
            elif path == "/profile/report":
                # The flight recorder's parsed attribution for the most
                # recent profiled window(s) — the same numbers the
                # /metrics gauges export (one reduction).
                if ms.recorder is None:
                    self._send(400, {
                        "error": "flight recorder disabled (start "
                                 "the server with --profile-every N "
                                 "and --profile-dir)"})
                else:
                    rep = ms.recorder.report()
                    if rep["latest"] is None:
                        self._send(404, {
                            "error": "no profiled window analyzed "
                                     "yet",
                            **{k: rep[k] for k in
                               ("windows_total", "windows_skipped",
                                "windows_deferred", "last_error")}})
                    else:
                        self._send(200, rep)
            else:
                self._send(404, {"error": f"no route {self.path}"})

        def _do_debug_get(self, path: str):
            if path == "/debug/state":
                self._send(200, ms.debug_state())
                return
            if not ms.history.enabled:
                self._send(400, {
                    "error": "request history disabled (start the "
                             "server with --request-history N)"})
                return
            if path in ("/requests", "/requests/"):
                q = parse_qs(urlparse(self.path).query)
                status = (q.get("status") or [None])[0]
                try:
                    limit = int((q.get("limit") or ["100"])[0])
                except ValueError:
                    self._send(400,
                               {"error": "limit must be an int"})
                    return
                self._send(200, {
                    "requests": ms.history.list(status=status,
                                                limit=limit),
                    **ms.history.stats()})
                return
            want = path[len("/requests/"):]
            rec = ms.history.get(want)
            if rec is None:
                self._send(404, {
                    "error": f"no record for request {want!r} "
                             f"(never seen, or rolled off the "
                             f"{ms.history.capacity}-record "
                             f"retention ring)"})
            else:
                self._send(200, rec)

        def _do_profile(self):
            """POST /profile/start|stop: the guarded single-flight
            torch.profiler wrap.  400 when the server was started
            without a profile dir (traces go to disk — explicit
            opt-in); 409 on state conflicts (a second start, a stop
            with nothing running, another owner's trace)."""
            t0 = time.perf_counter()
            if ms.profiler is None:
                code, resp = 400, {
                    "error": "profiling disabled (start the server "
                             "with --profile-dir)"}
            else:
                try:
                    if self.path == "/profile/start":
                        d = ms.profiler.start()
                        code, resp = 200, {"profiling": True, "dir": d}
                    else:
                        d = ms.profiler.stop()
                        code, resp = 200, {"profiling": False,
                                           "dir": d}
                except RuntimeError as e:
                    code, resp = 409, {"error": str(e)}
                except Exception as e:
                    code, resp = 500, {
                        "error": f"{type(e).__name__}: {e}"}
            try:
                self._send(code, resp)
            except OSError:
                pass
            ms.log_access("POST", self.path, code, None, resp,
                          time.perf_counter() - t0,
                          rid=getattr(self, "_rid", None))

        def _do_prefix(self, rid: str) -> None:
            """The fleet prefix tier's wire surface: ``POST
            /prefix/fetch`` (a stored entry, serialized; 404 = holder
            miss), ``/prefix/ingest`` (verify and admit one blob into
            the host tier), ``/prefix/handoff`` (push this replica's
            entries to a successor), ``/prefix/evict`` (host-tier
            hints).  All answer while DRAINING."""
            t0 = time.perf_counter()
            req = None
            try:
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                if self.path == "/prefix/fetch":
                    req = json.loads(raw or b"{}")
                    blob = ms.prefix_wire_payload(req)
                    if blob is None:
                        code, resp = 404, {"error": "prefix not held "
                                                    "here"}
                    else:
                        self._send_raw(200, blob,
                                       "application/octet-stream")
                        ms.log_access("POST", self.path, 200, req,
                                      {"nbytes": len(blob)},
                                      time.perf_counter() - t0,
                                      rid=rid)
                        return
                elif self.path == "/prefix/ingest":
                    # The body IS the wire payload (octet-stream).
                    req = {"nbytes": len(raw)}
                    code, resp = 200, ms.prefix_ingest(raw)
                elif self.path == "/prefix/handoff":
                    req = json.loads(raw or b"{}")
                    code, resp = 200, ms.prefix_handoff(req)
                elif self.path == "/prefix/evict":
                    req = json.loads(raw or b"{}")
                    code, resp = 200, ms.prefix_evict(req)
                else:
                    code, resp = 404, {"error":
                                       f"no route {self.path}"}
            except WirePayloadError as e:
                # Typed integrity failure: nothing reached the cache.
                code, resp = 400, {"error": str(e),
                                   "reason": "payload_integrity"}
            except ValueError as e:
                code, resp = 400, {"error": str(e)}
            except Exception as e:  # never kill the server thread
                code, resp = 500, {"error":
                                   f"{type(e).__name__}: {e}"}
            if isinstance(resp, dict):
                resp.setdefault("request_id", rid)
            try:
                self._send(code, resp)
            except OSError:
                pass
            ms.log_access("POST", self.path, code, req, resp,
                          time.perf_counter() - t0, rid=rid)

        def do_POST(self):
            rid = self._req_id()
            t0 = time.perf_counter()
            if self.path == "/drain":
                resp = ms.drain()
                try:
                    self._send(200, resp)
                except OSError:
                    pass
                ms.log_access("POST", self.path, 200, None, resp,
                              time.perf_counter() - t0, rid=rid)
                return
            if self.path.startswith("/prefix/"):
                self._do_prefix(rid)
                return
            if self.path in ("/profile/start", "/profile/stop"):
                self._do_profile()
                return
            if self.path not in ("/generate", "/prefill"):
                self._send(404, {"error": f"no route {self.path}"})
                return
            # Generate FIRST, send after: a client hanging up while a
            # successful response streams out is not a serving error.
            extra = None
            req = None
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/generate":
                    code, resp = 200, ms.generate(
                        req, cancel_check=_disconnect_probe(
                            self.connection), rid=rid)
                else:
                    code, resp = 200, ms.prefill_prompt(req)
            except ShedError as e:
                code = 503
                resp = {"error": str(e), "reason": e.reason}
                if e.retry_after:
                    extra = {"Retry-After": str(e.retry_after)}
            except DeadlineExceeded as e:
                code, resp = 504, {"error": str(e),
                                   "reason": "deadline"}
            except RequestCancelled as e:
                code, resp = 499, {"error": str(e),
                                   "reason": "cancelled"}
            except QueueFullError as e:
                # Explicit backpressure: the bounded admission queue
                # is full (counted by AdmissionQueue.submit).
                code = 429
                resp = {"error": str(e),
                        "retry_after": e.retry_after}
                extra = {"Retry-After": str(e.retry_after)}
            except NotImplementedError as e:
                code, resp = 501, {"error": str(e),
                                   "reason": "not_ported"}
            except PoisonedRequest as e:
                # Quarantine conviction: THIS request alone fails,
                # typed; its co-tenants resumed token-identically.
                with ms._stats_lock:
                    ms.errors += 1
                code, resp = 500, {"error": str(e), "reason": e.reason}
            except ValueError as e:
                with ms._stats_lock:
                    ms.errors += 1
                code, resp = 400, {"error": str(e)}
            except Exception as e:  # never kill the server thread
                with ms._stats_lock:
                    ms.errors += 1
                code, resp = 500, {"error": f"{type(e).__name__}: {e}"}
            if isinstance(resp, dict):
                resp.setdefault("request_id", rid)
            try:
                if ms.faults is not None:
                    # Injected handler-socket death at the response
                    # write: the connection drops with no response,
                    # server-side state already terminal.
                    ms.faults.check("socket_reset")
                self._send(code, resp, extra)
            except SocketReset:
                self.close_connection = True
                try:
                    self.connection.close()
                except OSError:
                    pass
            except OSError:
                pass  # client went away mid-write
            ms.log_access("POST", self.path, code, req, resp,
                          time.perf_counter() - t0, rid=rid)
            ms.record_front(rid, self.path, code, req, resp)

    return Handler
