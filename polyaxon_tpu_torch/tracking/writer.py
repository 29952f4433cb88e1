"""Async event writer: keeps tracking off the training step's critical path.

Parity: the reference's async event queue -> event-file writer (SURVEY.md
3.2 step 4, "must stay off the training step's critical path").  Events are
buffered in a thread-safe queue and flushed by a daemon thread in batches;
``log_*`` calls never block on IO.

The port's own copy of ``polyaxon_tpu/tracking/writer.py`` (no JAX in it;
kept here so the port imports nothing of the JAX package).
"""

from __future__ import annotations

import atexit
import queue
import threading
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple


class JsonlFileClient:
    """Minimal AsyncEventWriter client that appends events to ONE
    local JSONL file (one JSON object per line) — the serving layer's
    ``--trace-file`` span dump rides this through the same async
    writer the training tracking path uses, instead of growing a
    second file-writing stack."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def append_events(self, kind, name, events) -> None:
        import json

        with self._lock, open(self.path, "a") as f:
            for event in events:
                f.write(json.dumps(event) + "\n")

    def touch_heartbeat(self) -> None:
        pass  # a local file needs no liveness signal


class AsyncEventWriter:
    def __init__(self, client, flush_interval: float = 2.0,
                 max_batch: int = 512,
                 heartbeat_interval: float = 10.0):
        self._client = client
        self._queue: "queue.Queue[Optional[Tuple[str, str, Dict[str, Any]]]]" = \
            queue.Queue()
        self._flush_interval = flush_interval
        self._max_batch = max_batch
        self._thread: Optional[threading.Thread] = None
        self._closed = threading.Event()
        self._flushed = threading.Condition()
        self._pending = 0
        # Liveness signal for the control plane's zombie sweep
        # (SURVEY.md 5.3): touched from this daemon thread, so it tracks
        # PROCESS liveness — a slow/wedged training step still beats
        # (hang enforcement is activeDeadlineSeconds' job, not the
        # sweep's).
        self._heartbeat_interval = heartbeat_interval
        self._last_heartbeat = 0.0

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ptpu-event-writer")
        self._thread.start()
        atexit.register(self.close)

    def add(self, kind: str, name: str, event: Dict[str, Any]) -> None:
        if self._closed.is_set():
            # Late events (e.g. from user atexit hooks) are written inline.
            self._client.append_events(kind, name, [event])
            return
        with self._flushed:
            self._pending += 1
        self._queue.put((kind, name, event))

    def _heartbeat(self) -> None:
        import time

        now = time.monotonic()
        if now - self._last_heartbeat < self._heartbeat_interval:
            return
        self._last_heartbeat = now
        try:
            self._client.touch_heartbeat()
        except Exception:  # liveness is best-effort; never kill the loop
            pass

    def _loop(self) -> None:
        while True:
            batch: List[Tuple[str, str, Dict[str, Any]]] = []
            self._heartbeat()
            try:
                item = self._queue.get(timeout=self._flush_interval)
            except queue.Empty:
                continue
            if item is None:
                self._drain(batch)
                return
            batch.append(item)
            while len(batch) < self._max_batch:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is None:
                    self._drain(batch)
                    return
                batch.append(item)
            self._write(batch)

    def _drain(self, batch) -> None:
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                batch.append(item)
        self._write(batch)

    def _write(self, batch) -> None:
        if not batch:
            return
        grouped: Dict[Tuple[str, str], List[Dict[str, Any]]] = defaultdict(list)
        for kind, name, event in batch:
            grouped[(kind, name)].append(event)
        for (kind, name), events in grouped.items():
            try:
                self._client.append_events(kind, name, events)
            except Exception:  # never kill the writer thread on IO errors
                pass
        with self._flushed:
            self._pending -= len(batch)
            self._flushed.notify_all()

    def flush(self, timeout: float = 10.0) -> bool:
        """Block until everything queued so far hits the store."""
        with self._flushed:
            return self._flushed.wait_for(lambda: self._pending <= 0,
                                          timeout=timeout)

    def close(self, timeout: float = 10.0) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=timeout)
            self._thread = None
