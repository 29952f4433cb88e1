"""Bounded LRU shared by the serving package's compile and prefix
caches — one recency/eviction policy, one place to change it.

The port's own copy of
``polyaxon_tpu/serving/_lru.py`` (host-only code, kept here so
the port imports nothing of the JAX package).
"""

from collections import OrderedDict


def lru_get(cache: OrderedDict, key, cap: int, build,
            sentinel=None, kind: str = "program"):
    """Return ``cache[key]`` (refreshing its recency) or ``build()``,
    insert, and evict the least-recently-used entry past ``cap``.

    ``sentinel`` (analysis.recompile.RecompileSentinel) makes
    hits/misses/evictions observable when the cache holds COMPILED
    PROGRAMS: a miss is a recompile, and steady-state traffic is
    supposed to produce none (the zero-recompile contract pinned in
    tests/test_analysis.py).  Value caches (the prefix KV store) pass
    no sentinel."""
    if key in cache:
        cache.move_to_end(key)
        if sentinel is not None:
            sentinel.hit(kind, key)
        return cache[key]
    if sentinel is not None:
        sentinel.miss(kind, key)
    val = build()
    cache[key] = val
    if len(cache) > cap:
        evicted_key, _ = cache.popitem(last=False)
        if sentinel is not None:
            sentinel.evicted(kind, evicted_key)
    return val
