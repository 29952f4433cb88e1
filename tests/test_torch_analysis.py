"""The port's static checker (``polyaxon_tpu_torch/analysis/``) against
the reference's (``polyaxon_tpu/analysis/``).

Parity: every positive and negative fixture of ``tests/test_analysis.py``
for the families the port copies as they are (EXC-SWALLOW, PAGE-REF,
PHASE-ENUM, SOCKET-TIMEOUT, WIRE-VERIFY) and for the program analyses
(LOCK-ORDER, THREAD-SHARE), copied here as literals, goes through both
checkers under ``polyaxon_tpu/...`` and ``polyaxon_tpu_torch/...``
virtual paths: the two give the same ``(rule, line, func, code)`` list,
and the reference test's expected rules.  Then one positive and one
negative torch fixture per retargeted family, the module-level locks of
the port's lock graph, and suppression, SYNTAX, the baseline and
overlapping paths held against the reference's behaviour.
"""

from __future__ import annotations

import json
import textwrap

import pytest
import torch

from polyaxon_tpu import analysis as ref
from polyaxon_tpu_torch import analysis as port
from polyaxon_tpu_torch.analysis import lockgraph
from polyaxon_tpu_torch.analysis.rules import ALL_RULES

torch.set_num_threads(2)


def _key(findings):
    return [(f.rule, f.line, f.func, f.code) for f in findings]


def _run(pkg, src, suffix, family=None):
    """Findings of ``pkg``'s checker on ``src`` at ``<pkg>/<suffix>``:
    the per-module family ``family``, or the program analyses."""
    src = textwrap.dedent(src)
    name = pkg.__name__.rsplit(".", 1)[0]
    path = f"{name}/{suffix}"
    if family is None:
        return pkg.check_program({path: src})
    rules = [r for r in pkg.ALL_RULES if r.id == family]
    return pkg.check_source(src, path, rules)


# -- parity fixtures, copied from tests/test_analysis.py --------------------
#
# (case id, family or None for the program analyses, source, path under
# the package, the rules the reference test expects).

_SERVING = "serving/somefile.py"
_POOL = "serving/paged.py"
_VFILE = "serving/vfile.py"

_INVERSION = """
import threading

class Pair:
    def __init__(self):
        self.a_lock = threading.Lock()
        self.b_lock = threading.Lock()

    def fwd(self):
        with self.a_lock:
            with self.b_lock:
                pass

    def rev(self):
        with self.b_lock:
            with self.a_lock:
                pass
"""

_SHARED = """
import threading

class Worker:
    def __init__(self):
        self.lock = threading.Lock()
        self.count = 0
        self.t1 = threading.Thread(target=self.loop_a, name="alpha")
        self.t2 = threading.Thread(target=self.loop_b, name="beta")

    def loop_a(self):
        self.count = 1

    def loop_b(self):
        self.count = 2
"""

PARITY = [
    ("exc-swallow-pass", "EXC-SWALLOW", """
    def f():
        try:
            risky()
        except Exception:
            pass
        try:
            risky()
        except:
            pass
    """, "anything.py", ["EXC-SWALLOW"] * 2),
    ("exc-swallow-continue", "EXC-SWALLOW", """
    def sweep(self):
        for slot, stream in items:
            try:
                evict(slot)
            except Exception:
                continue
    """, "anything.py", ["EXC-SWALLOW"]),
    ("exc-swallow-negative", "EXC-SWALLOW", """
    import logging

    def f():
        try:
            risky()
        except Exception:
            logging.getLogger(__name__).debug("x", exc_info=True)
        try:
            risky()
        except KeyError:
            pass               # narrow: a decision, not a swallow
        try:
            risky()
        except Exception:
            fallback = None    # handled, not dropped
    """, "anything.py", []),
    ("page-ref-unlocked", "PAGE-REF", """
    class Pool:
        def bad_bump(self, i):
            self.refcounts[i] += 1
        def bad_assign(self, i):
            self.refcounts[i] = 0
        def bad_free(self, i):
            self._free_pages.append(i)
    """, _POOL, ["PAGE-REF"] * 3),
    ("page-ref-locked", "PAGE-REF", """
    class Pool:
        def ok(self, ids):
            with self._page_lock:
                for i in ids:
                    self.refcounts[i] += 1
                    if self.refcounts[i] == 0:
                        self._free_pages.append(i)
        def reads_ok(self, i):
            return self.refcounts[i]      # reads aren't mutations
        def tables_ok(self, s):
            self.page_tables[s, :] = 0    # engine-thread state
    """, _POOL, []),
    ("page-ref-nested-def", "PAGE-REF", """
    class Pool:
        def sneaky(self, i):
            with self._page_lock:
                def later():
                    self.refcounts[i] += 1
                return later
    """, _POOL, ["PAGE-REF"]),
    ("page-ref-private", "PAGE-REF", """
    def peek(mgr, s):
        return mgr.refcounts[3], mgr.page_tables[s], mgr._free_pages
    """, "serving/engine.py", ["PAGE-REF"] * 3),
    ("page-ref-literal-ids", "PAGE-REF", """
    def ok(mgr, ids):
        mgr.pin(ids)
        mgr.unpin(tuple(ids))
    def bad(mgr):
        mgr.unpin([3, 4])
    """, "serving/server.py", ["PAGE-REF"]),
    ("page-ref-scope", "PAGE-REF", """
    def elsewhere(mgr):
        return mgr.refcounts
    """, "tracking/thing.py", []),
    ("socket-timeout-flagged", "SOCKET-TIMEOUT", """
    import http.client
    import socket
    import urllib.request

    def probe(self, replica):
        return socket.create_connection((replica.host, replica.port))

    def fetch(self, url):
        return urllib.request.urlopen(url)

    def connect(self, replica):
        return http.client.HTTPConnection(replica.host, replica.port)

    def connect_tls(self, replica):
        return http.client.HTTPSConnection(replica.host)
    """, _SERVING, ["SOCKET-TIMEOUT"] * 4),
    ("socket-timeout-explicit", "SOCKET-TIMEOUT", """
    import http.client
    import socket
    import urllib.request

    def probe(self, replica):
        return socket.create_connection(
            (replica.host, replica.port), 2.0)

    def fetch(self, url):
        return urllib.request.urlopen(url, None, 5.0)

    def fetch_kw(self, url):
        return urllib.request.urlopen(url, timeout=self.timeout_s)

    def connect(self, replica):
        return http.client.HTTPConnection(
            replica.host, replica.port, timeout=self.probe_timeout_s)
    """, _SERVING, []),
    ("socket-timeout-scope", "SOCKET-TIMEOUT", """
    import urllib.request

    def fetch(self, url):
        return urllib.request.urlopen(url)
    """, "bench_serving_load.py", []),
    ("wire-verify-unverified", "WIRE-VERIFY", """
    import json
    import struct

    import numpy as np

    def admit_handoff(self, blob):
        (hlen,) = struct.unpack(">I", blob[:4])
        header = json.loads(blob[4:4 + hlen])
        body = blob[4 + hlen:]
        return np.frombuffer(body, dtype=header["dtype"])
    """, _SERVING, ["WIRE-VERIFY"]),
    ("wire-verify-verified", "WIRE-VERIFY", """
    import json
    import struct
    import zlib

    import numpy as np

    def admit_verified(self, blob):
        (hlen,) = struct.unpack(">I", blob[:4])
        header = json.loads(blob[4:4 + hlen])
        body = blob[4 + hlen:]
        if zlib.crc32(body) & 0xFFFFFFFF != header["crc32"]:
            raise WirePayloadError("checksum mismatch")
        return np.frombuffer(body, dtype=header["dtype"])

    def admit_canonical(self, blob):
        return unpack_spilled(blob)

    def admit_closure(self, blob, header, body):
        if zlib.crc32(body) & 0xFFFFFFFF != header["crc32"]:
            raise WirePayloadError("checksum mismatch")

        def _take(off, n, dtype):
            return np.frombuffer(body[off:off + n], dtype=dtype)

        return _take(0, header["nbytes"], header["dtype"])
    """, _SERVING, []),
    ("wire-verify-scope", "WIRE-VERIFY", """
    import numpy as np

    def load(self, raw):
        return np.frombuffer(raw, dtype=np.float32)
    """, "checkpoint/io.py", []),
    ("phase-enum-literals", "PHASE-ENUM", """
    def classify(led):
        slow = led["phases"].get("queue_wait", 0.0)
        if led["dominant"] == "preempt_gap":
            return "preempted"
        return "ok" if slow < 0.5 else "slow"
    """, _SERVING, ["PHASE-ENUM", "PHASE-ENUM"]),
    ("phase-enum-forensics", "PHASE-ENUM", """
    PHASE = "queue_wait"
    SPAN = "prefill"
    """, "serving/forensics.py", []),
    ("phase-enum-outside-serving", "PHASE-ENUM", """
    PHASE = "queue_wait"
    SPAN = "prefill"
    """, "analysis/report.py", []),
    ("phase-enum-serving", "PHASE-ENUM", """
    PHASE = "queue_wait"
    SPAN = "prefill"
    """, _SERVING, ["PHASE-ENUM"]),
    ("lock-order-inversion", None, _INVERSION, _VFILE, ["LOCK-ORDER"]),
    ("lock-order-call-chain", None, """
    import threading

    class Pair:
        def __init__(self):
            self.a_lock = threading.Lock()
            self.b_lock = threading.Lock()

        def takes_b(self):
            with self.b_lock:
                pass

        def fwd(self):
            with self.a_lock:
                self.takes_b()

        def rev(self):
            with self.b_lock:
                with self.a_lock:
                    pass
    """, _VFILE, ["LOCK-ORDER"]),
    ("lock-order-consistent", None, """
    import threading

    class Pair:
        def __init__(self):
            self.a_lock = threading.Lock()
            self.b_lock = threading.Lock()

        def fwd(self):
            with self.a_lock:
                with self.b_lock:
                    pass

        def also_fwd(self):
            with self.a_lock:
                with self.b_lock:
                    pass
    """, _VFILE, []),
    ("lock-order-try-lock", None, """
    import threading

    class Pair:
        def __init__(self):
            self.a_lock = threading.Lock()
            self.b_lock = threading.Lock()

        def fwd(self):
            with self.a_lock:
                with self.b_lock:
                    pass

        def rev(self):
            with self.b_lock:
                if self.a_lock.acquire(False):
                    self.a_lock.release()
    """, _VFILE, []),
    ("lock-order-out-of-scope", None, _INVERSION, "models/vfile.py", []),
    ("lock-order-locksan-scope", None, _INVERSION, "analysis/locksan.py",
     ["LOCK-ORDER"]),
    ("thread-share-unlocked", None, _SHARED, _VFILE, ["THREAD-SHARE"]),
    ("thread-share-common-lock", None, _SHARED.replace(
        "self.count = 1",
        "with self.lock:\n            self.count = 1").replace(
        "self.count = 2",
        "with self.lock:\n            self.count = 2"), _VFILE, []),
    ("thread-share-single-root", None, """
    import threading

    class Worker:
        def __init__(self):
            self.count = 0
            self.t1 = threading.Thread(target=self.loop_a)

        def loop_a(self):
            self.count = 1
    """, _VFILE, []),
    ("thread-share-lockfree-write", None, _SHARED.replace(
        "self.count = 1",
        "# ptpu: lockfree[test: monotonic flag]\n"
        "        self.count = 1"), _VFILE, []),
    ("thread-share-lockfree-def", None, _SHARED.replace(
        "    def loop_a(self):",
        "    # ptpu: lockfree[test: single owner by contract]\n"
        "    def loop_a(self):"), _VFILE, []),
]


@pytest.mark.parametrize("family,src,suffix,want",
                         [p[1:] for p in PARITY],
                         ids=[p[0] for p in PARITY])
def test_parity_with_the_reference(family, src, suffix, want):
    got_ref = _run(ref, src, suffix, family)
    got_port = _run(port, src, suffix, family)
    assert [f.rule for f in got_ref] == want
    assert _key(got_port) == _key(got_ref)


def test_parity_witnesses_name_both_ends():
    """The LOCK-ORDER witness and the THREAD-SHARE message carry the
    same evidence as the reference's, under the port's paths."""
    inv = _run(port, _INVERSION, _VFILE)[0]
    assert "Pair.fwd" in inv.message and "Pair.rev" in inv.message
    assert "polyaxon_tpu_torch/serving/vfile.py:" in inv.message
    shared = _run(port, _SHARED, _VFILE)[0]
    for words in ("Worker.count", "alpha@Worker.loop_a",
                  "beta@Worker.loop_b", "holds {nothing}"):
        assert words in shared.message


def test_phase_enum_literals_track_the_ports_enum():
    """The port's PHASE-ENUM copy carries the literal vocabulary of the
    port's own forensics enum, minus the span-name collisions."""
    from polyaxon_tpu_torch.analysis.rules import PhaseEnumRule
    from polyaxon_tpu_torch.serving.forensics import PHASES, ROUTER_PHASES

    collisions = {"prefill", "decode", "kv_handoff", "prefill_remote"}
    live = set(PHASES) | set(ROUTER_PHASES)
    assert collisions < live
    assert PhaseEnumRule._PHASE_LITERALS == live - collisions


def test_catalog_matches_the_reference():
    """The same ids in the same order, every rule an instance with the
    standard interface, and the same program families."""
    assert port.RULE_IDS == ref.RULE_IDS
    assert port.PROGRAM_RULE_IDS == ref.PROGRAM_RULE_IDS
    for r in ALL_RULES:
        assert callable(r.check) and callable(r.applies_to)


# -- suppression, SYNTAX, baseline, overlapping paths -----------------------


_BUGGY = """
import time

def f(self):
    with self.device_lock:
        time.sleep(1)
"""


@pytest.mark.parametrize("src", [
    """
    import time

    def f(self):
        with self.device_lock:
            time.sleep(1)  # ptpu: ignore[LOCK-HOLD]
            # ptpu: ignore[LOCK-HOLD]
            time.sleep(2)
    """,
    """
    import time

    def f(self):
        with self.device_lock:
            time.sleep(1)  # ptpu: ignore[RNG-DET]
            time.sleep(2)  # ptpu: ignore[*]
    """,
    "def broken(:\n",
], ids=["same-line-and-above", "rule-specific-and-star", "syntax"])
def test_suppression_and_syntax_match_the_reference(src):
    """A suppression covers its line and the next, for its rule id (or
    ``*``) only; a file that does not parse is one SYNTAX finding."""
    got_ref = ref.check_source(textwrap.dedent(src),
                               "polyaxon_tpu/serving/x.py")
    got_port = port.check_source(textwrap.dedent(src),
                                 "polyaxon_tpu_torch/serving/x.py")
    assert _key(got_port) == _key(got_ref)
    assert [f.rule for f in got_port] in ([], ["LOCK-HOLD"], ["SYNTAX"])


def test_baseline_round_trip_matches_the_reference(tmp_path):
    """Save, load, apply: a second occurrence is new, fixed code turns
    the entry stale, a line shift keeps it, and a subset update keeps
    the other files' written justifications — in both packages."""
    outcomes = []
    for pkg, name in ((ref, "polyaxon_tpu"), (port, "polyaxon_tpu_torch")):
        serving = f"{name}/serving/somefile.py"
        other = f"{name}/other/file.py"
        findings = pkg.check_source(_BUGGY, serving)
        path = str(tmp_path / f"{name}.json")
        pkg.save_baseline(path, findings)
        entries = pkg.load_baseline(path)
        two = _BUGGY + ("\n\ndef g(self):\n    with self.device_lock:\n"
                        "        time.sleep(1)\n")
        new2, _ = pkg.apply_baseline(pkg.check_source(two, serving),
                                     entries)
        new3, stale3 = pkg.apply_baseline([], entries)
        shifted = pkg.check_source("# one\n# two\n" + _BUGGY, serving)
        new4, stale4 = pkg.apply_baseline(shifted, entries)
        kept = pkg.save_baseline(path, pkg.check_source(_BUGGY, other))
        kept[0]["justification"] = "a hand-written reason"
        with open(path, "w") as fh:
            json.dump({"version": 1, "entries": kept}, fh)
        merged = pkg.save_baseline(
            path, findings, previous=pkg.load_baseline(path),
            preserve=[e for e in pkg.load_baseline(path)
                      if e["path"] != serving])
        outcomes.append((
            len(findings), len(new2), len(new3), len(stale3),
            len(new4), len(stale4),
            sorted((e["path"].split("/", 1)[1], e["justification"])
                   for e in merged)))
    assert outcomes[0][:6] == (1, 1, 0, 1, 0, 0)
    assert outcomes[1] == outcomes[0]


def test_overlapping_paths_do_not_double_count(tmp_path):
    for pkg, name in ((ref, "polyaxon_tpu"), (port, "polyaxon_tpu_torch")):
        from importlib import import_module

        iter_py_files = import_module(
            f"{name}.analysis.checker").iter_py_files
        sub = tmp_path / name / "serving"
        sub.mkdir(parents=True)
        (sub / "bad.py").write_text(_BUGGY)
        paths = [str(tmp_path / name), str(sub)]
        assert len(iter_py_files(paths)) == 1
        fs = pkg.check_paths(paths, root=str(tmp_path))
        assert [f.rule for f in fs] == ["LOCK-HOLD"]


# -- the retargeted families: one positive, one negative torch fixture ------

_ENGINE = "polyaxon_tpu_torch/serving/engine.py"
_SERV = "polyaxon_tpu_torch/serving/somefile.py"
_MESHED = "polyaxon_tpu_torch/serving/meshed.py"

RETARGETED = [
    ("RNG-DET", _SERV, """
    import torch
    from polyaxon_tpu_torch import prng

    def draw(self, rng, seed, probs):
        rng, key = prng.split(rng)
        fresh = prng.PRNGKey(seed)
        u = torch.rand(3)
        tok = torch.multinomial(probs, 1)
        return key, fresh, u, tok
    """, 4, """
    import torch
    from polyaxon_tpu_torch import prng

    def draw(self, seed, row, gen):
        key = prng.fold_in(prng.PRNGKey(seed), row)
        base = prng.PRNGKey(seed)
        k2 = prng.fold_in(base, row)
        return key, k2, torch.rand(3, generator=gen)
    """),
    ("LOCK-HOLD", _SERV, """
    import torch

    def step(self, x, stream):
        with self.device_lock:
            torch.cuda.synchronize()
            stream.synchronize()
            a = x.item()
            b = x.tolist()
            c = self.fn(x).cpu()
        return a, b, c
    """, 5, """
    import torch
    from .slots import host_copy, sync_device

    def step(self, x):
        with self.device_lock:
            out = host_copy(self.fn(x)).numpy()
            sync_device(self.device)

            def later():
                return x.item()
        return out, later, x.cpu()
    """),
    ("SNAPSHOT-LOCK", _SERV, """
    import torch

    def snapshot(self):
        with self._state_lock:
            torch.cuda.synchronize()
            live = self._lens.cpu()
            dump = host_copy(self._outs)
        return live, dump
    """, 3, """
    def snapshot(self):
        with self._state_lock:
            return dict(self._published)
    """),
    ("RETRY-BACKOFF", _SERV, """
    import torch

    def loop(self):
        while True:
            try:
                return torch.cuda.synchronize()
            except Exception:
                self.errors += 1
    """, 1, """
    import torch

    def loop(self):
        attempt = 0
        while True:
            try:
                return torch.cuda.synchronize()
            except Exception:
                attempt += 1
                if attempt >= self.retry_policy.max_attempts:
                    raise
    """),
    ("TIER-XFER", _SERV, """
    def evict(self, dev):
        host = self._pools[0].cpu()
        back = host.to(dev)
        self._pool.to(device="cuda")
        self._pool.copy_(host.cuda())
        return back
    """, 3, """
    import torch

    def spill_pages(self, ids):
        return self._pools[0].cpu()

    def cast(self):
        return self._pool.to(torch.float32), self._pool.copy_(self._k)
    """),
    ("HOST-SYNC", _ENGINE, """
    import torch

    def step(self, logits):
        a = int(torch.argmax(logits))
        b = logits.tolist()
        c = logits.cpu().numpy()
        torch.cuda.synchronize()
        return a, b, c, logits[0].item()
    """, 5, """
    import torch
    from .slots import host_copy, sync_device

    def step(self, logits):
        out = host_copy(torch.argmax(logits)).numpy()
        sync_device(logits.device)
        return out
    """),
    ("TIME-TRUTH", _SERV, """
    import time
    import torch

    def timed(self, a, b, graph):
        t0 = time.perf_counter()
        y = torch.matmul(a, b)
        graph.replay()
        dt = time.perf_counter() - t0
        return y, dt
    """, 1, """
    import time
    import torch
    from .slots import host_copy

    def timed(self, a, b):
        t0 = time.perf_counter()
        y = host_copy(torch.matmul(a, b))
        dt = time.perf_counter() - t0
        t1 = time.perf_counter()
        self.http_call()
        return y, dt, time.perf_counter() - t1
    """),
    ("JIT-PURITY", _SERV, """
    import time
    import numpy as np
    import torch

    class Pool:
        def _body(self, w):
            self.count += 1
            t = time.time()
            n = self._lens.item()
            return t, n

        def step(self, w):
            return self._replay((w,), lambda: self._body(w), None)

        def _capture(self, body, g):
            with torch.cuda.graph(g):
                noise = np.random.rand()
                body()
            return noise
    """, 4, """
    import time

    class Pool:
        def _body(self, w):
            self._buf.copy_(self._tok)
            self._out[w] = self._buf

        def step(self, w):
            t0 = time.time()
            out = self._replay((w,), lambda: self._body(w), None)
            return out, time.time() - t0, self.count
    """),
    ("SHARD-LEAK", _MESHED, """
    import torch

    class MeshedModel:
        def forward(self, ids, group):
            x = ids.to(group.primary)
            w = self.weight.cuda()
            buf = torch.zeros(4, device=group.primary)
            self._pool = torch.zeros(8, 4)
            return x, w, buf
    """, 4, """
    import torch

    class ServingMesh:
        def place_cache(self, t, dev):
            return torch.empty(t.shape, device=dev).copy_(t)

        def stacked_pool(self, cache, n):
            return [s.stacked(n, device=self.device_at(0, 0, r))
                    for r, s in enumerate(cache.shards)]

    class Pool:
        def _ensure_stacked(self, cache):
            self._pool = self.mesh.stacked_pool(cache, 8)

        def step(self, x):
            return x.to(torch.float32), self._pool.leaves()
    """),
    ("JIT-DEADLINE", _SERV, """
    import time

    class Pool:
        def _body(self, w):
            if time.monotonic() > self.deadline:
                return None
            self._buf.copy_(self._tok)

        def step(self, w):
            return self._dispatch((w,), lambda: self._body(w))
    """, 1, """
    import time

    class Pool:
        def _body(self, w):
            self._buf.copy_(self._tok)

        def step(self, w):
            if time.monotonic() > self.deadline:
                return None
            return self._dispatch((w,), lambda: self._body(w))
    """),
]


# Families that hold every module, as the reference's do.
_UNSCOPED = {"LOCK-HOLD", "JIT-PURITY", "JIT-DEADLINE"}


@pytest.mark.parametrize("family,path,bad,n_bad,good", RETARGETED,
                         ids=[r[0] for r in RETARGETED])
def test_retargeted_family(family, path, bad, n_bad, good):
    """Each retargeted family flags the torch spelling of its hazard
    and passes the sanctioned spelling (and, where it has one, the
    out-of-scope path)."""
    rules = [r for r in ALL_RULES if r.id == family]
    got = port.check_source(textwrap.dedent(bad), path, rules)
    assert [f.rule for f in got] == [family] * n_bad, _key(got)
    assert port.check_source(textwrap.dedent(good), path, rules) == []
    if family not in _UNSCOPED:
        assert port.check_source(textwrap.dedent(bad),
                                 "polyaxon_tpu_torch/tracking/x.py",
                                 rules) == []


def test_host_sync_scope_is_the_step_modules():
    src = "def f(x):\n    return x.item()\n"
    rules = [r for r in ALL_RULES if r.id == "HOST-SYNC"]
    for mod in ("engine", "slots", "paged"):
        assert len(port.check_source(
            src, f"polyaxon_tpu_torch/serving/{mod}.py", rules)) == 1
    assert port.check_source(
        src, "polyaxon_tpu_torch/serving/server.py", rules) == []


def test_shard_leak_waits_for_the_meshed_server():
    """SHARD-LEAK keeps its catalog slot and matches the port's meshed
    placement: a stray device move in ``serving/meshed.py`` only, a
    pool allocated outside ``_alloc*``/``_ensure*`` there and in the two
    slot pools; the engine and the server are out of its scope."""
    move = "def admit(self, c, dev):\n    return c.to(dev)\n"
    pool = "import torch\n\ndef admit(self):\n    self._pools = torch.zeros(2)\n"
    rules = [r for r in ALL_RULES if r.id == "SHARD-LEAK"]
    for src in (move, pool):
        assert port.check_source(src, _ENGINE, rules) == []
        assert len(port.check_source(src, _MESHED, rules)) == 1
    for mod in ("slots", "paged"):
        path = f"polyaxon_tpu_torch/serving/{mod}.py"
        assert port.check_source(move, path, rules) == []
        assert len(port.check_source(pool, path, rules)) == 1


# -- module-level locks in the lock graph -----------------------------------

_CAPTURE = """
import threading

_CAPTURE_LOCK = threading.Lock()


def sync_device(dev):
    with _CAPTURE_LOCK:
        dev.wait()


class Pool:
    def _capture(self, body):
        with _CAPTURE_LOCK:
            return body()
"""

_ENGINE_SRC = """
import threading

from .slots import sync_device
from . import slots


class Engine:
    def __init__(self):
        self.device_lock = threading.Lock()

    def tick(self, dev):
        with self.device_lock:
            sync_device(dev)

    def peek(self):
        with slots._CAPTURE_LOCK:
            pass
"""


def _graph(pkg_graph, sources):
    return pkg_graph.canonical_graph(
        pkg_graph.build_lock_graph(pkg_graph.build_model(sources)))


def test_module_level_locks_are_nodes():
    """A module-level ``threading.Lock()`` is the node
    ``<module>.<NAME>``, reached by a bare name in its module, by a
    relative import of a function that takes it, and by
    ``module.NAME``; the reference's lock graph, which resolves a bare
    name only through a declaring class, has no node for it."""
    from polyaxon_tpu.analysis import lockgraph as ref_lockgraph

    sources = {"polyaxon_tpu_torch/serving/slots.py": _CAPTURE,
               "polyaxon_tpu_torch/serving/engine.py": _ENGINE_SRC}
    g = _graph(lockgraph, sources)
    assert "slots._CAPTURE_LOCK" in g["nodes"]
    assert {"from": "Engine.device_lock", "to": "slots._CAPTURE_LOCK",
            "blocking": True} in g["edges"]
    ref_sources = {k.replace("polyaxon_tpu_torch", "polyaxon_tpu"): v
                   for k, v in sources.items()}
    assert "slots._CAPTURE_LOCK" not in _graph(ref_lockgraph,
                                               ref_sources)["nodes"]
    # An inversion through a module-level lock is a LOCK-ORDER cycle.
    inverted = _CAPTURE + """

class Other:
    def __init__(self):
        self.b_lock = threading.Lock()

    def fwd(self):
        with self.b_lock:
            with _CAPTURE_LOCK:
                pass

    def rev(self):
        with _CAPTURE_LOCK:
            with self.b_lock:
                pass
"""
    fs = port.check_program({"polyaxon_tpu_torch/serving/slots.py":
                             inverted})
    assert [f.rule for f in fs] == ["LOCK-ORDER"]
    assert "slots._CAPTURE_LOCK" in fs[0].code


def test_reference_fixtures_give_the_reference_graph():
    """On sources with no module-level lock the port's lock graph is
    the reference's."""
    from polyaxon_tpu.analysis import lockgraph as ref_lockgraph

    for src in (_INVERSION, _SHARED):
        got = _graph(lockgraph, {"polyaxon_tpu_torch/serving/v.py":
                                 textwrap.dedent(src)})
        want = _graph(ref_lockgraph, {"polyaxon_tpu/serving/v.py":
                                      textwrap.dedent(src)})
        assert got == want
