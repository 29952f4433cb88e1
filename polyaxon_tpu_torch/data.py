"""Input pipeline: shuffled epoch iteration + host->device prefetch.

Port of ``polyaxon_tpu/data.py``.  The datasets are numpy and copied
unchanged, so the same seed, epoch and ``start_step`` give the same
batches in both packages:

- ``ArrayDataset``: in-memory (or memmapped) arrays -> shuffled epoch
  batches, deterministic per (seed, epoch).
- ``npy_dataset``: ``inputs.npy``/``labels.npy`` from a directory,
  loaded with ``mmap_mode="r"`` so datasets larger than RAM stream.
- ``synthetic_dataset``: a deterministic pool of synthetic batches
  cycled with reshuffling.
- ``TokenWindowDataset`` / ``token_dataset``: random fixed-length LM
  windows from one long token stream.
- ``prefetch_to_device``: a background thread that turns the next
  batches into tensors in pinned host memory and copies them onto the
  device without blocking, so the host copy overlaps device compute.

The digits and span-corruption datasets come with a later slice.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch


def _epoch_rng(seed: int, epoch: int) -> np.random.RandomState:
    """One seed-mixing formula for every dataset (deterministic per
    (seed, epoch), distinct across epochs)."""
    return np.random.RandomState((seed * 100003 + epoch) % (2 ** 31))


class _EpochIterable:
    """Shared epoch chaining: subclasses define ``epoch(e, start=0)``.

    Every dataset is deterministic in (seed, epoch), which makes the
    stream CHECKPOINTABLE by position alone: ``epochs(start_step=k)``
    resumes exactly where an uninterrupted run's k-th batch would be —
    no iterator state to serialize.  train.py passes the restored step
    so a preemption-resumed run continues through the data instead of
    replaying batch 0 (exactly-once over the schedule).
    """

    def __iter__(self):
        return self.epoch(0)

    def epochs(self, n: Optional[int] = None, *, start_step: int = 0
               ) -> Iterator[Dict[str, np.ndarray]]:
        spe = self.steps_per_epoch
        e, skip = divmod(int(start_step), spe) if start_step else (0, 0)
        while n is None or e < n:
            yield from self.epoch(e, start=skip)
            skip = 0
            e += 1


class ArrayDataset(_EpochIterable):
    """Dict-of-arrays -> iterator of shuffled, fixed-size batches.

    Iterating yields one epoch.  ``epochs(n)`` chains n epochs (n=None
    for an endless stream), reshuffling every epoch deterministically
    from (seed, epoch).
    """

    def __init__(self, arrays: Dict[str, np.ndarray], batch_size: int,
                 *, shuffle: bool = True, seed: int = 0,
                 drop_remainder: bool = True):
        sizes = {k: len(v) for k, v in arrays.items()}
        if len(set(sizes.values())) > 1:
            raise ValueError(f"Array length mismatch: {sizes}")
        self.arrays = arrays
        self.n = next(iter(sizes.values())) if sizes else 0
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        if self.n < self.batch_size:
            raise ValueError(
                f"Dataset of {self.n} examples can't fill a batch of "
                f"{self.batch_size}")

    @property
    def steps_per_epoch(self) -> int:
        return self.n // self.batch_size if self.drop_remainder \
            else -(-self.n // self.batch_size)

    def sample(self, n: int = 2) -> Dict[str, np.ndarray]:
        """A shape-defining sample (model init / sharding layout)."""
        return {k: np.asarray(v[:n]) for k, v in self.arrays.items()}

    def epoch(self, epoch: int = 0, start: int = 0
              ) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(self.n)
        if self.shuffle:
            _epoch_rng(self.seed, epoch).shuffle(order)
        stop = self.n - (self.n % self.batch_size) \
            if self.drop_remainder else self.n
        # ``start`` skips whole batches without gathering them (resume
        # through memmapped arrays costs nothing).
        for lo in range(start * self.batch_size, stop, self.batch_size):
            idx = order[lo:lo + self.batch_size]
            idx.sort()  # monotone gather: fast on memmapped arrays
            yield {k: np.asarray(v[idx]) for k, v in self.arrays.items()}


def npy_dataset(data_dir: str, batch_size: int, *, shuffle: bool = True,
                seed: int = 0) -> ArrayDataset:
    arrays = {"inputs": np.load(os.path.join(data_dir, "inputs.npy"),
                                mmap_mode="r")}
    labels_path = os.path.join(data_dir, "labels.npy")
    if os.path.exists(labels_path):
        arrays["labels"] = np.load(labels_path, mmap_mode="r")
    return ArrayDataset(arrays, batch_size, shuffle=shuffle, seed=seed)


def synthetic_dataset(spec, batch_size: int, *, pool_batches: int = 64,
                      pool_budget_bytes: int = 256 * 1024 * 1024,
                      seed: int = 0) -> ArrayDataset:
    """Deterministic varied data from a model spec's batch generator.

    The pool is capped by ``pool_budget_bytes`` so large-input models
    (resnet50 at batch 128 is ~77 MB/batch) don't materialize gigabytes
    of host RAM just to provide shuffle variety.
    """
    probe = spec.make_batch(batch_size)
    batch_bytes = sum(np.asarray(v).nbytes for v in probe.values())
    pool_batches = max(2, min(pool_batches,
                              pool_budget_bytes // max(batch_bytes, 1)))
    pool = spec.make_batch(batch_size * pool_batches)
    return ArrayDataset({k: np.asarray(v) for k, v in pool.items()},
                        batch_size, shuffle=True, seed=seed)


class TokenWindowDataset(_EpochIterable):
    """Contiguous token stream -> random fixed-length training windows.

    The standard LM data layout (one long token array on disk, sampled
    at random offsets): ``tokens`` is a 1-D integer array (memmap
    welcome — sampling reads only the touched windows).  Each epoch
    yields ``len(tokens) // (batch * seq_len)`` batches of
    ``{"inputs": [batch, seq_len]}``, offsets drawn deterministically
    from (seed, epoch); the registry's LM losses shift inputs
    internally, so no separate labels array exists.
    """

    def __init__(self, tokens: np.ndarray, batch_size: int,
                 seq_len: int, *, seed: int = 0):
        if tokens.ndim != 1:
            raise ValueError(f"tokens must be 1-D; got {tokens.shape}")
        if len(tokens) < seq_len + 1:
            raise ValueError(
                f"{len(tokens)} tokens can't fill a window of {seq_len}")
        self.tokens = tokens
        self.batch_size = int(batch_size)
        self.seq_len = int(seq_len)
        self.seed = seed

    @property
    def steps_per_epoch(self) -> int:
        return max(1, len(self.tokens) //
                   (self.batch_size * self.seq_len))

    def sample(self, n: int = 2) -> Dict[str, np.ndarray]:
        # Clamp offsets: a stream longer than one window but shorter
        # than n non-overlapping windows still yields full-length rows.
        hi = len(self.tokens) - self.seq_len
        win = np.stack([self.tokens[o:o + self.seq_len]
                        for o in (min(i * self.seq_len, hi)
                                  for i in range(n))])
        return {"inputs": win.astype(np.int32)}

    def epoch(self, epoch: int = 0, start: int = 0
              ) -> Iterator[Dict[str, np.ndarray]]:
        rs = _epoch_rng(self.seed, epoch)
        hi = len(self.tokens) - self.seq_len
        for i in range(self.steps_per_epoch):
            offs = np.sort(rs.randint(0, hi + 1, size=self.batch_size))
            if i < start:
                continue  # rng consumed, window gather skipped
            batch = np.stack([self.tokens[o:o + self.seq_len]
                              for o in offs])
            yield {"inputs": batch.astype(np.int32)}


def token_dataset(path: str, batch_size: int, seq_len: int, *,
                  seed: int = 0) -> TokenWindowDataset:
    """Load a token stream: ``tokens.npy`` (any int dtype) or a raw
    ``tokens.bin`` of uint16 (the common GPT-2-vocab packing).  ``path``
    may be the file or a directory containing it."""
    if os.path.isdir(path):
        for name in ("tokens.npy", "tokens.bin"):
            cand = os.path.join(path, name)
            if os.path.exists(cand):
                path = cand
                break
        else:
            raise FileNotFoundError(
                f"no tokens.npy/tokens.bin under {path}")
    if path.endswith(".npy"):
        tokens = np.load(path, mmap_mode="r")
    else:
        tokens = np.memmap(path, dtype=np.uint16, mode="r")
    return TokenWindowDataset(tokens, batch_size, seq_len, seed=seed)


def prefetch_to_device(batches: Iterator[Dict[str, np.ndarray]],
                       device=None, *, depth: int = 2
                       ) -> Iterator[Dict[str, torch.Tensor]]:
    """Stage upcoming batches onto ``device`` from a background thread.

    Each array becomes a tensor; for a CUDA device it is copied into
    pinned host memory and sent with ``non_blocking=True``, so the copy
    of batch t+1 overlaps the compute of batch t (the copy is queued on
    the current stream before the batch is handed over, so stream order
    keeps the consumer behind it).  ``depth`` bounds the staged batches.
    ``device=None`` or a CPU device yields CPU tensors.
    """
    device = torch.device("cpu" if device is None else device)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    def stage(batch):
        out = {}
        for key, value in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(value))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[key] = t
        return out

    def worker():
        try:
            if device.type == "cuda" and device.index is not None:
                torch.cuda.set_device(device.index)
            for batch in batches:
                q.put(stage(batch))
        except Exception as e:  # surface in the consumer, not the thread
            q.put(e)
        finally:
            q.put(_END)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, Exception):
            raise item
        yield item
