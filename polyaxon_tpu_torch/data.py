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
- ``digits_dataset``: the 1,797 8x8 digit images with a held-out eval
  split, read from the package's own copy of scikit-learn's
  ``digits.csv.gz`` (``assets/``; scikit-learn, BSD-3, from UCI's
  optdigits), parsed as ``sklearn.datasets.load_digits`` parses it.
- ``TokenWindowDataset`` / ``token_dataset``: random fixed-length LM
  windows from one long token stream.
- ``prefetch_to_device``: a background thread that turns the next
  batches into tensors in pinned host memory and copies them onto the
  device without blocking, so the host copy overlaps device compute.

- ``SpanCorruptionDataset``: T5's span-corruption objective over a
  token stream, padded to static input and target lengths with
  ``enc_mask`` / ``target_mask``.
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


DIGITS_CSV = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "assets", "digits.csv.gz")


def load_digits():
    """(images float64 [1797, 8, 8], labels int [1797]) from the
    packaged ``digits.csv.gz``: 64 pixel columns then the label, as
    ``sklearn.datasets.load_digits`` reads it (its ``images`` and
    ``target``)."""
    import gzip

    with gzip.open(DIGITS_CSV, "rt") as f:
        data = np.loadtxt(f, delimiter=",")
    return data[:, :-1].reshape(-1, 8, 8), data[:, -1].astype(int)


def digits_dataset(batch_size: int, *, split: str = "train",
                   eval_fraction: float = 0.2, seed: int = 0
                   ) -> ArrayDataset:
    """Real 10-class image data available offline: 1797 8x8 grayscale
    digits, images / 16 as float32 ``[N, 8, 8, 1]``, with the
    reference's deterministic train/eval split.  The eval split keeps
    its remainder batch — truncating the held-out set would bias the
    reported accuracy."""
    images, labels = load_digits()
    images = (images / 16.0).astype("float32")[..., None]
    labels = labels.astype("int32")
    order = np.arange(len(images))
    np.random.RandomState(seed).shuffle(order)
    n_eval = int(len(images) * eval_fraction)
    idx = order[n_eval:] if split == "train" else order[:n_eval]
    train = split == "train"
    return ArrayDataset({"inputs": images[idx], "labels": labels[idx]},
                        min(batch_size, len(idx)),
                        shuffle=train, drop_remainder=train, seed=seed)


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


def _random_segmentation(total: int, parts: int,
                         rs: np.random.RandomState) -> np.ndarray:
    """Random composition of ``total`` into ``parts`` positive parts
    (uniform over compositions): choose parts-1 distinct cut points."""
    if parts <= 1:
        return np.array([total])
    cuts = np.sort(rs.choice(total - 1, size=parts - 1,
                             replace=False)) + 1
    return np.diff(np.concatenate([[0], cuts, [total]]))


class SpanCorruptionDataset(_EpochIterable):
    """T5's span-corruption pretraining objective over a token stream.

    Per example: a window of ``window_length`` tokens is split into
    alternating keep/noise segments (noise fraction ``noise_density``,
    mean noise-span length ``mean_span``); each noise span is replaced
    by one descending sentinel (vocab_size-1, vocab_size-2, ...) in
    the encoder input, and the decoder target is the concatenation of
    ``sentinel_i + span_i`` pairs followed by ``eos_id``.  Both sides
    are padded to the STATIC (``inputs_length``, ``targets_length``) —
    every batch has one shape — with ``enc_mask``/``target_mask``
    marking real tokens (the registry's seq2seq loss applies them).
    The produced lengths are deterministic in ``window_length``, so a
    window that would overflow the static lengths (silently dropping
    noise spans) is rejected at construction; the default window is
    auto-sized to exactly fill ``inputs_length``.

    The stream's token ids must stay below
    ``vocab_size - num_sentinels`` (T5 reserves the top of the vocab
    for sentinels); ids at or above that range would collide and are
    rejected per batch.
    """

    def __init__(self, tokens: np.ndarray, batch_size: int,
                 inputs_length: int, targets_length: int, *,
                 vocab_size: int, window_length: Optional[int] = None,
                 noise_density: float = 0.15, mean_span: float = 3.0,
                 num_sentinels: int = 100, pad_id: int = 0,
                 eos_id: int = 1, seed: int = 0):
        if tokens.ndim != 1:
            raise ValueError(f"tokens must be 1-D; got {tokens.shape}")
        if not 0.0 < noise_density < 1.0:
            raise ValueError(
                f"noise_density must be in (0, 1); got {noise_density}")
        self.noise_density = float(noise_density)
        self.mean_span = float(mean_span)
        self.num_sentinels = int(num_sentinels)
        if window_length is None:
            # Window sized so the corrupted input ((1-r)*W + spans)
            # fills inputs_length; spans ~= W*r/mean_span sentinels
            # are added.  Rounding can overshoot by a token or two —
            # shrink until the EXACT planned lengths fit (n_noise and
            # n_spans are deterministic in W, so this is checkable).
            window_length = min(
                len(tokens) - 1,
                round(inputs_length / (1.0 - noise_density
                                       + noise_density / mean_span)))
            while window_length > 1:
                need_in, need_tgt = self._plan(window_length)
                if need_in <= inputs_length and \
                        need_tgt <= targets_length:
                    break
                window_length -= 1
        else:
            need_in, need_tgt = self._plan(int(window_length))
            if need_in > inputs_length or need_tgt > targets_length:
                # Silent truncation would drop noise spans from the
                # target — a corrupted objective, not a shorter one.
                raise ValueError(
                    f"window_length {window_length} produces inputs of "
                    f"{need_in} and targets of {need_tgt}, exceeding "
                    f"the static (inputs_length={inputs_length}, "
                    f"targets_length={targets_length})")
        self.window_length = int(window_length)
        if len(tokens) < self.window_length + 1:
            raise ValueError(
                f"{len(tokens)} tokens can't fill a window of "
                f"{self.window_length}")
        self.tokens = tokens
        self.batch_size = int(batch_size)
        self.inputs_length = int(inputs_length)
        self.targets_length = int(targets_length)
        self.vocab_size = int(vocab_size)
        self.pad_id = int(pad_id)
        self.eos_id = int(eos_id)
        self.seed = seed

    def _counts(self, L: int):
        """(n_noise, n_spans) for a window of L — deterministic, so
        the produced lengths are exact, not worst-case."""
        n_noise = max(1, int(round(L * self.noise_density)))
        n_noise = min(n_noise, L - 1)
        n_spans = max(1, int(round(n_noise / self.mean_span)))
        n_spans = min(n_spans, n_noise, self.num_sentinels,
                      L - n_noise)
        return n_noise, n_spans

    def _plan(self, L: int):
        """Exact (input_len, target_len) a window of L produces."""
        n_noise, n_spans = self._counts(L)
        return L - n_noise + n_spans, n_noise + n_spans + 1

    @property
    def steps_per_epoch(self) -> int:
        return max(1, len(self.tokens) //
                   (self.batch_size * self.window_length))

    def _corrupt(self, window: np.ndarray, rs: np.random.RandomState):
        L = len(window)
        n_noise, n_spans = self._counts(L)
        noise_lens = _random_segmentation(n_noise, n_spans, rs)
        keep_lens = _random_segmentation(L - n_noise, n_spans, rs)
        sentinel0 = self.vocab_size - 1
        inp, tgt, pos = [], [], 0
        for i in range(n_spans):
            inp.extend(window[pos:pos + keep_lens[i]])
            pos += keep_lens[i]
            inp.append(sentinel0 - i)
            tgt.append(sentinel0 - i)
            tgt.extend(window[pos:pos + noise_lens[i]])
            pos += noise_lens[i]
        tgt.append(self.eos_id)
        return np.asarray(inp, np.int32), np.asarray(tgt, np.int32)

    def _pad(self, row: np.ndarray, length: int):
        row = row[:length]
        mask = np.zeros(length, np.int32)
        mask[:len(row)] = 1
        out = np.full(length, self.pad_id, np.int32)
        out[:len(row)] = row
        return out, mask

    def sample(self, n: int = 2) -> Dict[str, np.ndarray]:
        """First-batch rows (deterministic), sized to n — the trainer's
        compile-shape probe (TokenWindowDataset.sample contract)."""
        batch = next(self.epoch(0))
        reps = -(-n // self.batch_size)
        return {k: np.concatenate([v] * reps)[:n]
                for k, v in batch.items()}

    def epoch(self, epoch: int = 0, start: int = 0
              ) -> Iterator[Dict[str, np.ndarray]]:
        rs = _epoch_rng(self.seed, epoch)
        hi = len(self.tokens) - self.window_length
        limit = self.vocab_size - self.num_sentinels
        for step_i in range(self.steps_per_epoch):
            # ONE code path for skipped and emitted batches: the rng
            # consumption (offset draw + data-dependent segmentation
            # draws inside _corrupt) is identical by construction, so
            # a resume skip can never desynchronize the stream even if
            # the draw pattern changes later.  Skipped batches only
            # save the pad/stack/yield tail — numpy-only cost.
            emit = step_i >= start
            offs = np.sort(rs.randint(0, hi + 1,
                                      size=self.batch_size))
            ins, tgts, in_m, tgt_m = [], [], [], []
            for o in offs:
                window = np.asarray(
                    self.tokens[o:o + self.window_length], np.int64)
                if window.max() >= limit:
                    raise ValueError(
                        f"token id {int(window.max())} collides with "
                        f"the sentinel range [{limit}, "
                        f"{self.vocab_size}); re-pack the stream or "
                        f"lower num_sentinels")
                i, t = self._corrupt(window, rs)
                if not emit:
                    continue
                i, im = self._pad(i, self.inputs_length)
                t, tm = self._pad(t, self.targets_length)
                ins.append(i); tgts.append(t)
                in_m.append(im); tgt_m.append(tm)
            if emit:
                yield {"inputs": np.stack(ins),
                       "labels": np.stack(tgts),
                       "enc_mask": np.stack(in_m),
                       "target_mask": np.stack(tgt_m)}


def prefetch_to_device(batches: Iterator[Dict[str, np.ndarray]],
                       sharding=None, *, depth: int = 2
                       ) -> Iterator[Dict[str, torch.Tensor]]:
    """Stage upcoming batches onto a device from a background thread.

    ``sharding``: a device, or a ``parallel.mesh.DataSharding`` (the
    train step's ``batch_sharding``).  Every rank of a data-parallel
    gang builds the same global host batch from the seed, as the
    reference's processes do; with a sharding each rank keeps its rows
    and moves only those (a global batch that does not divide over the
    data axes raises).  Each array becomes a tensor; for a CUDA device
    it is copied into pinned host memory and sent with
    ``non_blocking=True``, so the copy of batch t+1 overlaps the compute
    of batch t (the copy is queued on the current stream before the
    batch is handed over, so stream order keeps the consumer behind it).
    ``depth`` bounds the staged batches.  ``None`` or a CPU device
    yields CPU tensors.
    """
    rows = getattr(sharding, "shard", None)
    device = getattr(sharding, "device", sharding)
    device = torch.device("cpu" if device is None else device)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    def stage(batch):
        out = {}
        for key, value in batch.items():
            if rows is not None:
                value = rows(value)
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
