"""Legacy request-coalescing path (the seed serving design), kept as
the measurable A/B baseline for the continuous-batching engine.

This is the pre-engine batching policy: whole ``generate()`` calls
that share a compile shape (prompt length, eos, prefill chunk) are
merged into one device batch which decodes to the LONGEST member's
budget, and whoever holds the device lock leads the merged batch.  Its
two structural costs are exactly what engine.py removes — short
requests pay the tail latency of long ones, and requests with
different prompt lengths never merge at all — so both policies run
on the same traffic to record the before/after (``chip_smoke.py``'s
``phase_profiling``).  Select with
``ModelServer(batching="coalesce")``; the default is the engine.

The port's own copy of ``polyaxon_tpu/serving/legacy.py``: a merged
batch runs the server's solo ``generate`` program
(``models/generate.py``) on the card.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from .scheduler import DeadlineExceeded


class _Pending:
    """One coalescible request waiting for a leader to execute it."""

    __slots__ = ("toks", "new", "event", "result", "error")

    def __init__(self, toks: np.ndarray, new: int):
        self.toks = toks          # [rows, p_len] int64
        self.new = new            # this request's max_new_tokens
        self.event = threading.Event()
        self.result = None        # [rows, p_len + new] when done
        self.error: Optional[BaseException] = None


def _batch_bucket(n: int, cap: int) -> int:
    """Next power-of-two >= n, capped: merged batches land on a handful
    of compiled shapes instead of one per client-count."""
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


class RequestCoalescer:
    """Request-level coalescing over one ModelServer's device lock and
    compile cache (see module docstring for why this is the baseline,
    not the default)."""

    def __init__(self, server):
        self.ms = server
        # pending greedy requests by compile shape (minus batch);
        # _pending_lock guards the queues only, the server's device
        # lock guards execution.
        self._pending: Dict[Tuple, list] = {}
        self._pending_lock = threading.Lock()

    def _drain(self, ckey) -> list:
        """Pop the longest prefix of ``ckey``'s queue that fits in
        max_batch (first item always fits: per-request batch is
        validated <= max_batch)."""
        with self._pending_lock:
            q = self._pending.get(ckey)
            if not q:
                return []
            batch, n = [], 0
            while q and n + q[0].toks.shape[0] <= self.ms.max_batch:
                it = q.pop(0)
                batch.append(it)
                n += it.toks.shape[0]
            if not q:
                self._pending.pop(ckey, None)
            return batch

    def _execute_batch(self, ckey, batch) -> None:
        """Run one merged greedy batch; deliver each request's slice.

        Requests may differ in max_new_tokens (ckey excludes it): the
        batch decodes to the LONGEST request's length and each item is
        sliced back to its own — exact, because greedy rows never
        interact and eos-frozen rows just keep emitting eos past their
        requested budget (truncated away by the slice).

        Failures are delivered through item.error, never raised: the
        executing leader may not own any row of this batch, and its
        own request must not die for a stranger's OOM.
        """
        import torch

        ms = self.ms
        p_len, eos, chunk = ckey
        try:
            rows = np.concatenate([it.toks for it in batch], axis=0)
            new = max(it.new for it in batch)
            n = rows.shape[0]
            b = _batch_bucket(n, ms.max_batch)
            if b > n:  # batch-dim pad: rows never interact across it
                rows = np.concatenate(
                    [rows, np.repeat(rows[-1:], b - n, axis=0)], axis=0)
            # Same key format as the solo path, so coalesced buckets
            # and equal-sized solo requests share one program.
            key = ("sample", b, p_len, new, 0.0, None, None, eos, 1,
                   chunk)
            fn = ms._fn(key)
            out = fn(torch.as_tensor(rows, device=ms.model.device),
                     0).cpu().numpy()
            ms._sync()
            ofs = 0
            for it in batch:
                r = it.toks.shape[0]
                it.result = out[ofs:ofs + r, :p_len + it.new]
                ofs += r
                it.event.set()
            with ms._stats_lock:
                ms.requests += len(batch)
                if len(batch) > 1:
                    ms.coalesced_batches += 1
                    ms.coalesced_requests += len(batch)
        except BaseException as e:
            for it in batch:
                if not it.event.is_set():
                    it.error = e
                    it.event.set()

    def _pull_pending(self, ckey, item) -> None:
        """Remove a still-queued item from its shape queue (deadline
        shed, or the broken-invariant bailout) so no later leader
        executes work nobody is waiting for."""
        with self._pending_lock:
            q = self._pending.get(ckey)
            if q and item in q:
                q.remove(item)
                if not q:
                    self._pending.pop(ckey, None)

    def generate(self, toks: np.ndarray, p_len: int, new: int, eos,
                 chunk, deadline: Optional[float] = None
                 ) -> np.ndarray:
        """Queue a greedy request; lead merged batches until ours is
        done.  Leader election is just lock acquisition: whoever gets
        the device lock drains and executes; everyone else's request
        was either in those batches (event set before the lock is
        released) or still queued for the next leader — so inside the
        lock, an unset event implies our item is drainable and every
        drain makes progress.

        ``deadline`` (absolute perf_counter, or None) is honored at
        the only boundary this path has: after the lock is acquired,
        before dispatching a batch.  An expired still-pending item is
        pulled and shed instead of joining a merged decode it no
        longer wants; one already executed by an earlier leader
        delivers its (late) result — finished device work is never
        discarded.
        """
        ckey = (p_len, eos, chunk)  # new excluded: lengths merge
        item = _Pending(toks, new)
        with self._pending_lock:
            self._pending.setdefault(ckey, []).append(item)
        with self.ms._lock:
            while not item.event.is_set():
                if deadline is not None \
                        and time.perf_counter() > deadline:
                    self._pull_pending(ckey, item)
                    if not item.event.is_set():
                        raise DeadlineExceeded(
                            "deadline exceeded waiting for the "
                            "coalesced dispatch")
                    break
                batch = self._drain(ckey)
                if not batch:
                    # Invariant broken (e.g. max_batch shrunk below a
                    # queued request's rows after validation): fail
                    # loudly instead of waiting forever — and pull the
                    # orphaned item so no later leader runs it after
                    # this request has already errored out.
                    self._pull_pending(ckey, item)
                    if not item.event.is_set():
                        raise RuntimeError(
                            "coalescing invariant broken: queued "
                            "request no longer drainable (max_batch "
                            "changed mid-flight?)")
                    break
                self._execute_batch(ckey, batch)
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.result
