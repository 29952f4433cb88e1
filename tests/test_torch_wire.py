"""The host spill tier's wire format and page-pool transfers in the port
(``serving/paged.py``: ``pack_spilled``/``unpack_spilled``,
``spill_pages``/``rematerialize``, ``ensure_shaped``) against the JAX
reference, on gpt2-tiny and llama-tiny.

- The reference prefills one prompt (float32, bf16, and an int8 KV
  cache); both packages page that same cache content into their pools
  and spill it: the port's blob is BYTE-EQUAL to the reference's (the
  JSON header with its key order, dtype names and crc32, and the buffer
  order — the reference's flax leaf order, not ``KVCache.leaves``').
- Each package's ``unpack_spilled`` reads the other's blob, bitwise
  (bf16 through a 16-bit view: the port has no bf16 numpy type).
- Truncated, bit-flipped, wrong-version and header/body-mismatched
  blobs raise ``WirePayloadError``, never a partial payload.
- ``rematerialize(spill_pages(ids))`` is bitwise ``materialize(ids)`` on
  plain and int8 pools, and equals the reference's ``materialize``.
- Two racing first touches of an unshaped pool allocate ONE pool.
"""

from __future__ import annotations

import json
import struct
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.models import generate as JG
from polyaxon_tpu.models.registry import get_model as j_get_model
from polyaxon_tpu.serving.paged import PagedSlotKVManager as JPaged
from polyaxon_tpu.serving.paged import pack_spilled as j_pack
from polyaxon_tpu.serving.paged import unpack_spilled as j_unpack
from polyaxon_tpu_torch.models.kv_cache import KVCache
from polyaxon_tpu_torch.models.registry import get_model
from polyaxon_tpu_torch.serving.paged import (PagedSlotKVManager,
                                              WirePayloadError,
                                              pack_spilled,
                                              unpack_spilled)

torch.set_num_threads(2)

PT, N_TOK = 8, 21                      # 3 pages, the last partial
IDS = [5, 2, 9]
CASES = {"float32": dict(dtype=jnp.float32),
         "bf16": dict(dtype=jnp.bfloat16),
         "int8kv": dict(dtype=jnp.float32, kv_cache_int8=True)}
_T_DT = {"float32": torch.float32, "bf16": torch.bfloat16,
         "int8kv": torch.float32}


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def _same(t: torch.Tensor, a) -> bool:
    """Bitwise equality of a host tensor and a reference array."""
    a = np.asarray(a)
    if t.dtype == torch.bfloat16:
        return a.dtype.name == "bfloat16" and np.array_equal(
            t.view(torch.int16).numpy().view(np.uint16),
            a.view(np.uint16))
    return t.numpy().dtype == a.dtype and t.numpy().tobytes() \
        == a.tobytes() and tuple(t.shape) == a.shape


_CACHE = {}


def _case(name, case):
    """(reference model, variables, tokens, reference cache, logits,
    the port's KVCache of the same content, port model)."""
    key = (name, case)
    if key not in _CACHE:
        jmodel = j_get_model(name).make_model(**CASES[case])
        variables = jmodel.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8), jnp.int32))
        vocab = jmodel.cfg.vocab_size
        toks = np.random.RandomState(7).randint(
            0, vocab, (1, N_TOK)).astype(np.int32)
        logits, jcache = JG._prefill(jmodel, variables,
                                     jnp.asarray(toks))
        block = jcache["h"]["block"]
        if "attn" in block:
            block = block["attn"]
        names = ["cached_key", "cached_value"]
        if "cached_key_scale" in block:
            names += ["cached_key_scale", "cached_value_scale"]
        tcache = KVCache.from_leaves([_to_torch(block[n]) for n in names],
                                     index=N_TOK)
        over = {"kv_cache_int8": True} if case == "int8kv" else {}
        tmodel = get_model(name).make_model(device="cpu",
                                            dtype=_T_DT[case], **over)
        _CACHE[key] = (jmodel, variables, toks, jcache,
                       np.asarray(logits), tcache, tmodel)
    return _CACHE[key]


def _pools(name, case):
    """Both packages' paged pools holding the case's cache at IDS, and
    each one's spilled leaves."""
    jmodel, variables, toks, jcache, logits, tcache, tmodel = \
        _case(name, case)
    maxp = jmodel.cfg.max_position
    jm = JPaged(jmodel, variables, 2, page_tokens=PT, n_pages=16,
                max_position=maxp, decode_window=2)
    jm.scatter_cache(jcache, IDS)
    tm = PagedSlotKVManager(tmodel, 2, page_tokens=PT, n_pages=16,
                            max_position=maxp, decode_window=2)
    tm.scatter_cache(tcache, IDS)
    return jm, tm, jm.spill_pages(IDS, N_TOK), tm.spill_pages(IDS, N_TOK)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_blob_byte_equal_to_reference(name, case):
    """The same cache content spilled and packed by each package gives
    the same bytes; the spilled leaves themselves are the reference's,
    in its order."""
    *_, toks, _jc, logits, _tc, _tm = _case(name, case)
    _jm, _tm2, jleaves, tleaves = _pools(name, case)
    assert len(tleaves) == len(jleaves)
    for t, a in zip(tleaves, jleaves):
        assert (t is None) == (a is None)
        if t is not None:
            assert _same(t, a)
    jblob = j_pack(toks, jleaves, N_TOK, logits)
    tblob = pack_spilled(toks, tleaves, N_TOK, _to_torch(logits))
    assert tblob == jblob
    (hlen,) = struct.unpack(">I", tblob[:4])
    header = json.loads(tblob[4:4 + hlen])
    want = {"float32": "float32", "bf16": "bfloat16",
            "int8kv": "int8"}[case]
    assert header["leaves"][0] is None
    assert header["leaves"][1]["dtype"] == want
    if case == "int8kv":
        assert [m and m["dtype"] for m in header["leaves"]] == [
            None, "int8", "bfloat16", "int8", "bfloat16"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_package_reads_the_others_blob(case):
    *_, toks, _jc, logits, _tc, _tm = _case("gpt2-tiny", case)
    _jm, _tm2, jleaves, tleaves = _pools("gpt2-tiny", case)
    # The port reads the reference's blob.
    t_toks, t_leaves, n, t_logits = unpack_spilled(
        j_pack(toks, jleaves, N_TOK, logits))
    assert n == N_TOK and np.array_equal(t_toks, toks)
    assert _same(t_logits, logits)
    for t, a in zip(t_leaves, jleaves):
        assert (t is None and a is None) or _same(t, a)
    # The reference reads the port's.
    j_toks, j_leaves, n, j_logits = j_unpack(
        pack_spilled(toks, tleaves, N_TOK, _to_torch(logits)))
    assert n == N_TOK and np.array_equal(j_toks, toks)
    assert np.asarray(j_logits).tobytes() == logits.tobytes()
    for a, t in zip(j_leaves, tleaves):
        assert (t is None and a is None) or _same(t, a)


def test_corrupt_blobs_raise_typed():
    *_, toks, _jc, logits, _tc, _tm = _case("gpt2-tiny", "bf16")
    _jm, _tm2, _jl, tleaves = _pools("gpt2-tiny", "bf16")
    blob = pack_spilled(toks, tleaves, N_TOK, _to_torch(logits))
    bad = bytearray(blob)
    bad[-3] ^= 0xFF                                 # a flipped bit
    with pytest.raises(WirePayloadError, match="checksum"):
        unpack_spilled(bytes(bad))
    for cut in (2, 10, len(blob) - 5):              # truncations
        with pytest.raises(WirePayloadError):
            unpack_spilled(blob[:cut])
    with pytest.raises(WirePayloadError):           # garbage header
        unpack_spilled(b"\x00\x00\x00\x04carpbody")
    (hlen,) = struct.unpack(">I", blob[:4])
    header = json.loads(blob[4:4 + hlen])
    body = blob[4 + hlen:]

    def reframe(h, b=body):
        raw = json.dumps(h).encode()
        return struct.pack(">I", len(raw)) + raw + b

    with pytest.raises(WirePayloadError, match="version"):
        unpack_spilled(reframe({**header, "v": 2}))
    # A header that declares more than the body holds (the crc covers
    # the body alone, so it still matches).
    meta = [dict(m) if m else m for m in header["leaves"]]
    meta[1]["shape"] = [meta[1]["shape"][0] + 1] + meta[1]["shape"][1:]
    with pytest.raises(WirePayloadError, match="truncated"):
        unpack_spilled(reframe({**header, "leaves": meta}))
    for bad in ("x", {"shape": [2, -1], "dtype": "float32"},
                {"shape": [2], "dtype": "complex64"}):
        with pytest.raises(WirePayloadError, match="malformed"):
            unpack_spilled(reframe({**header, "leaves": [None, bad]}))
    with pytest.raises(WirePayloadError, match="malformed"):
        unpack_spilled(reframe({**header, "prompt": [["a"]]}))
    with pytest.raises(WirePayloadError, match="trailing"):
        unpack_spilled(reframe({**header, "crc32": __import__(
            "zlib").crc32(body + b"xx") & 0xFFFFFFFF}, body + b"xx"))
    assert issubclass(WirePayloadError, ValueError)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-tiny"])
def test_rematerialize_is_bitwise_materialize(name, case):
    """Every leaf of the rematerialized cache (keys, values, an int8
    cache's codes and scales) equals ``materialize``'s bitwise, and the
    reference's ``materialize`` of the same pages."""
    jm, tm, _jl, tleaves = _pools(name, case)
    got = tm.rematerialize(unpack_spilled(pack_spilled(
        np.zeros((1, N_TOK), np.int32), tleaves, N_TOK,
        torch.zeros(1, 4)))[1], N_TOK)
    want = tm.materialize(IDS, N_TOK)
    assert got.index == want.index == N_TOK
    assert len(got.leaves()) == len(want.leaves())
    for a, b in zip(got.leaves(), want.leaves()):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int8) if a.dtype == torch.int8
                           else a, b)
    block = jm.materialize(IDS, N_TOK)["h"]["block"]
    block = block.get("attn", block)
    names = ["cached_key", "cached_value"]
    if "cached_key_scale" in block:
        names += ["cached_key_scale", "cached_value_scale"]
    for t, n in zip(got.leaves(), names):
        assert _same(t, block[n]), n


def test_ensure_shaped_concurrent_first_touch():
    """Two wire admissions racing a fresh replica's unshaped pool:
    exactly one allocation, one pool — the loser observes the winner's
    pool and never replaces it."""
    tmodel = get_model("gpt2-tiny").make_model(device="cpu",
                                               dtype=torch.float32)
    mgr = PagedSlotKVManager(tmodel, 2, page_tokens=8, n_pages=32,
                             max_position=64, decode_window=2)
    shape = (2, 1, 64, 4, 16)
    template = KVCache(torch.empty(shape, device="meta"),
                       torch.empty(shape, device="meta"))
    orig = mgr._alloc_pool
    allocs = []

    def slow_alloc(cache, device=None):
        # Widen the race window: without the shape lock both racers
        # sit here and the second allocation REPLACES the first.
        allocs.append(threading.get_ident())
        time.sleep(0.1)
        return orig(cache, device)

    mgr._alloc_pool = slow_alloc
    barrier = threading.Barrier(2)
    pools = []

    def first_touch():
        barrier.wait()
        mgr.ensure_shaped(template, torch.device("cpu"))
        pools.append(mgr._pools)

    threads = [threading.Thread(target=first_touch) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(allocs) == 1
    assert len(pools) == 2 and pools[0] is pools[1]
    assert mgr.shaped and mgr._pools[0].device.type == "cpu"
    assert mgr._pools[0].shape == (2, 32 + 2 + 1, 8, 4, 16)
