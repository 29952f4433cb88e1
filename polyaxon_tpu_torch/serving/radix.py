"""Radix (compressed token-trie) index for the serving prefix cache.

The seed prefix cache was a flat OrderedDict scanned linearly under
``_prefix_lock`` — O(entries x prompt) token comparisons per lookup,
fine at 4 entries, hostile at the entry counts a system-prompt fleet
wants.  This index stores entries in a compressed trie over token
COLUMNS (a batch-``b`` prompt is a sequence of b-wide columns, so
multi-row prompts radix exactly like single-row ones), giving:

- ``lookup``: longest stored entry that prefixes the query in one
  O(prompt) walk, whatever the entry count;
- ``store``: path-splitting insert that also returns the DEEPEST
  ancestor entry already stored — the hook the paged-KV prefix store
  uses to share page-aligned prefix pages between entries (a stored
  system prompt's pages are referenced, not recopied, by every
  session extension stored on top of it);
- LRU eviction over ENTRIES with structural pruning: evicting an
  entry removes its node (and any childless chain above it) but
  never touches descendants — payload-level sharing (page refcounts)
  is the owner's concern, reported back via the evicted payloads.

TWO-TIER STORE SUPPORT: the index itself is tier-agnostic (a payload
is opaque), but the host-RAM spill tier (ModelServer) needs
two more primitives so an entry can be DEMOTED in place — its device
pages spilled to pinned host buffers — instead of dropped:

- :meth:`set_payload` swaps one entry's payload without touching its
  recency position (with an identity guard, so a concurrent
  overwrite is never clobbered by a stale demotion);
- :meth:`remove` pops one EXACT entry (the byte-budget eviction of
  the host tier, and the recovery flush's survivor rebuild).

Thread-safety is the CALLER's: ModelServer wraps every call in its
``_prefix_lock`` exactly as it wrapped the flat dict.

The port's own copy of
``polyaxon_tpu/serving/radix.py`` (host-only code, kept here so
the port imports nothing of the JAX package).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, List, Optional, Tuple

import numpy as np

__all__ = ["RadixPrefixIndex"]


class _Node:
    __slots__ = ("edge", "children", "entry", "parent", "hits")

    def __init__(self, edge: np.ndarray,
                 parent: Optional["_Node"]):
        self.edge = edge                 # [b, m] tokens from parent
        self.children = {}               # first-column bytes -> _Node
        self.entry: Optional[Tuple[np.ndarray, Any]] = None
        self.parent = parent
        # Lifetime hit count for the entry stored HERE (0 until a
        # lookup lands on it) — the fleet eviction policy's "which
        # copy is the hot one" signal (entries_meta).
        self.hits = 0


def _col_key(toks: np.ndarray, i: int) -> bytes:
    return toks[:, i].tobytes()


class RadixPrefixIndex:
    """LRU-bounded radix index: token matrix [b, n] -> payload."""

    def __init__(self, cap: int):
        self.cap = int(cap)
        self._roots = {}                 # batch size -> root _Node
        # Two recency rings over entries (key = (b, len, bytes) ->
        # entry node): HOT holds explicit registrations and anything
        # a lookup ever hit (LRU order); COLD holds speculative
        # session store-backs that no lookup has touched yet (FIFO —
        # oldest first).  Eviction drains COLD before touching HOT,
        # so one-shot store-backs cycle among THEMSELVES instead of
        # flushing a registered system prompt (scan resistance), and
        # a cold entry that proves useful is promoted on its first
        # hit.
        self._hot: "OrderedDict[tuple, _Node]" = OrderedDict()
        self._cold: "OrderedDict[tuple, _Node]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._hot) + len(self._cold)

    @staticmethod
    def _key(toks: np.ndarray) -> tuple:
        return (toks.shape[0], toks.shape[1], toks.tobytes())

    def _match_walk(self, toks: np.ndarray):
        """Walk as deep as full edges match ``toks``; returns
        ``(node, depth, best)`` where ``best`` is the deepest
        fully-matched node holding an entry (or None)."""
        b, n = toks.shape
        node = self._roots.get(b)
        depth, best = 0, None
        while node is not None:
            if node.entry is not None:
                best = node
            if depth >= n:
                break
            child = node.children.get(_col_key(toks, depth))
            if child is None:
                break
            m = child.edge.shape[1]
            if depth + m > n or not np.array_equal(
                    child.edge, toks[:, depth:depth + m]):
                break
            node, depth = child, depth + m
        return node, depth, best

    def _promote(self, key) -> None:
        """A hit makes an entry HOT (and freshest) wherever it was."""
        node = self._cold.pop(key, None)
        if node is not None:
            self._hot[key] = node
        else:
            self._hot.move_to_end(key)

    def lookup(self, toks: np.ndarray
               ) -> Optional[Tuple[np.ndarray, Any]]:
        """Longest stored entry whose prompt is a prefix of ``toks``
        (same batch width): ``(entry_tokens, payload)`` or None.
        Refreshes the hit's recency (cold entries promote to hot)."""
        _, _, best = self._match_walk(np.ascontiguousarray(toks))
        if best is None:
            return None
        ent_toks, payload = best.entry
        best.hits += 1
        self._promote(self._key(ent_toks))
        return ent_toks, payload

    def longest_ancestor(self, toks: np.ndarray
                         ) -> Optional[Tuple[np.ndarray, Any]]:
        """Deepest stored entry that strictly or exactly prefixes
        ``toks`` — the page-sharing parent for a store.  Does NOT
        refresh LRU (a store is not a hit)."""
        _, _, best = self._match_walk(np.ascontiguousarray(toks))
        return best.entry if best is not None else None

    def store(self, toks: np.ndarray, payload, *, hot: bool = True
              ) -> List[Tuple[np.ndarray, Any]]:
        """Insert/overwrite the entry for ``toks``; returns the
        DISPLACED payload entries — the overwritten same-prompt entry
        (if any) plus LRU evictions past ``cap`` — for the caller to
        free (unpin pages / drop caches).

        ``hot=False`` inserts into the COLD ring (scan resistance):
        speculative session store-backs — one per served request —
        evict each other FIFO instead of flushing a deliberately
        registered system prompt, which a stream of one-shot
        suffixes would otherwise evict within ``cap`` requests.  A
        later lookup hit promotes a cold entry to hot like any
        other.  When the index is at capacity with every OTHER entry
        hot, a cold insert cannot survive (hot entries outrank
        speculation) — :meth:`accepts` lets callers skip the store's
        expensive side effects up front in that case."""
        toks = np.ascontiguousarray(np.asarray(toks, np.int32))
        b, n = toks.shape
        displaced: List[Tuple[np.ndarray, Any]] = []
        root = self._roots.get(b)
        if root is None:
            root = self._roots[b] = _Node(
                np.zeros((b, 0), np.int32), None)
        node, depth = root, 0
        while depth < n:
            child = node.children.get(_col_key(toks, depth))
            if child is None:
                leaf = _Node(toks[:, depth:].copy(), node)
                node.children[_col_key(toks, depth)] = leaf
                node, depth = leaf, n
                break
            m_max = child.edge.shape[1]
            rem = toks[:, depth:]
            m = 0
            while m < m_max and m < rem.shape[1] and \
                    np.array_equal(child.edge[:, m], rem[:, m]):
                m += 1
            if m == m_max:
                node, depth = child, depth + m
                continue
            # Split child's edge at m: node -> mid -> child.
            mid = _Node(child.edge[:, :m].copy(), node)
            node.children[_col_key(toks, depth)] = mid
            child.edge = child.edge[:, m:].copy()
            child.parent = mid
            mid.children[child.edge[:, 0].tobytes()] = child
            if depth + m == n:
                node, depth = mid, n
                break
            leaf = _Node(toks[:, depth + m:].copy(), mid)
            mid.children[_col_key(toks, depth + m)] = leaf
            node, depth = leaf, n
            break
        key = self._key(toks)
        if node.entry is not None:
            displaced.append(node.entry)
            old_key = self._key(node.entry[0])
            self._hot.pop(old_key, None)
            self._cold.pop(old_key, None)
        node.entry = (toks, payload)
        ring = self._hot if hot else self._cold
        ring[key] = node
        ring.move_to_end(key)
        while len(self) > self.cap:
            ev = self.pop_lru()
            if ev is None:
                break
            displaced.append(ev)
        return displaced

    def accepts(self, hot: bool = True) -> bool:
        """Whether a NEW entry of this hotness could survive
        insertion: a cold insert into an index whose capacity is
        fully held by hot entries is evicted in the same call —
        callers with expensive store side effects (the paged page
        scatter) check first."""
        return hot or len(self._hot) < self.cap

    def pop_lru(self) -> Optional[Tuple[np.ndarray, Any]]:
        """Evict the coldest entry (oldest COLD store-back first,
        then least-recently-hit HOT entry); prunes its node chain and
        returns ``(tokens, payload)`` for the caller to free, or None
        when empty.  Structural only: descendants — deeper entries
        whose payloads may share this entry's pages — are untouched;
        the page refcounts decide what memory actually frees."""
        if self._cold:
            _, node = self._cold.popitem(last=False)
        elif self._hot:
            _, node = self._hot.popitem(last=False)
        else:
            return None
        entry = node.entry
        node.entry = None
        # Prune childless, entry-less nodes upward.
        while node.parent is not None and node.entry is None \
                and not node.children:
            parent = node.parent
            parent.children.pop(node.edge[:, 0].tobytes(), None)
            node = parent
        return entry

    def _exact_node(self, toks: np.ndarray) -> Optional[_Node]:
        """The node holding EXACTLY ``toks``'s entry, or None."""
        toks = np.ascontiguousarray(np.asarray(toks, np.int32))
        node, depth, _ = self._match_walk(toks)
        if node is None or depth != toks.shape[1] \
                or node.entry is None \
                or node.entry[0].shape != toks.shape \
                or not np.array_equal(node.entry[0], toks):
            return None
        return node

    def set_payload(self, toks: np.ndarray, payload, *,
                    expect=None) -> bool:
        """Swap the payload of the EXACT entry for ``toks`` in place
        (recency position untouched) — the tier-demotion/promotion
        primitive.  With ``expect`` set, the swap only happens while
        the current payload IS ``expect`` (identity), so a demotion
        computed outside the caller's lock can never clobber an
        entry that was overwritten meanwhile.  Returns whether the
        swap happened."""
        node = self._exact_node(toks)
        if node is None:
            return False
        if expect is not None and node.entry[1] is not expect:
            return False
        node.entry = (node.entry[0], payload)
        return True

    def remove(self, toks: np.ndarray) -> Optional[Any]:
        """Pop the EXACT entry for ``toks`` (structural pruning like
        pop_lru; descendants untouched); returns its payload, or
        None when not stored."""
        node = self._exact_node(toks)
        if node is None:
            return None
        key = self._key(node.entry[0])
        self._hot.pop(key, None)
        self._cold.pop(key, None)
        payload = node.entry[1]
        node.entry = None
        while node.parent is not None and node.entry is None \
                and not node.children:
            parent = node.parent
            parent.children.pop(node.edge[:, 0].tobytes(), None)
            node = parent
        return payload

    def entries(self) -> List[Tuple[np.ndarray, Any]]:
        """Every stored entry, eviction order (coldest first)."""
        return [n.entry
                for ring in (self._cold, self._hot)
                for n in ring.values() if n.entry is not None]

    def entries_meta(self) -> List[Tuple[np.ndarray, Any, int, bool]]:
        """Every stored entry with its recency metadata, eviction
        order (coldest first): ``(tokens, payload, hits, hot)``.
        The fleet prefix-index endpoint reads this — hit counts and
        ring membership are what the router's one-copy-somewhere
        eviction pass ranks duplicate copies by."""
        out: List[Tuple[np.ndarray, Any, int, bool]] = []
        for ring, hot in ((self._cold, False), (self._hot, True)):
            for n in ring.values():
                if n.entry is not None:
                    out.append((n.entry[0], n.entry[1],
                                n.hits, hot))
        return out
