"""The port's profiling slice against the JAX package: the trace parser
(``analysis/xprof.py``), the decode-flop estimate, the flight recorder
(``serving/profiling.py``), ``ProfileSession`` on ``torch.profiler`` and
the server's ``/profile/*`` routes, and ``serve --trace-file``.

- The reference's synthetic xprof fixtures give the same records through
  both packages' ``attribute_events``; kineto-shaped fixtures pin the
  port's own device-event choice (``kernel`` / ``gpu_memset`` /
  ``gpu_memcpy``, never a ``gpu_user_annotation``; only the CPU
  ``ptpu_step`` copy anchors the window).
- Both packages' ``FlightRecorder``, driven by one fake session and one
  ``on_step_*`` sequence, open the same windows and publish the same
  records, gauge names and ``/info`` keys.
- On gpt2-tiny (float32, CPU): ``/profile/start|stop`` answer 400, 200
  and 409 as the reference's; a manual window started from an HTTP
  handler thread sees the engine thread's markers; the recorder
  publishes on a live server.
Every wait is bounded (a few seconds), never a 60 s poll.
"""

from __future__ import annotations

import gzip
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from polyaxon_tpu.analysis import xprof as jx
from polyaxon_tpu.serving import profiling as jprof
from polyaxon_tpu_torch.analysis import xprof as tx
from polyaxon_tpu_torch.models.registry import get_model
from polyaxon_tpu_torch.serving import ModelServer, make_server
from polyaxon_tpu_torch.serving import profiling as tprof
from polyaxon_tpu_torch.serving.telemetry import (ProfileSession,
                                                  dump_spans_jsonl)

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _meta(pid, name):
    return {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": name}}


def _thread(pid, tid, name):
    return {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": name}}


def _ev(name, pid, tid, ts, dur, cat=None):
    ev = {"ph": "X", "name": name, "pid": pid, "tid": tid, "ts": ts,
          "dur": dur}
    if cat is not None:
        ev["cat"] = cat
    return ev


# The reference's synthetic fixtures (tests/test_profiling.py), with the
# keyword arguments each is attributed under.
_XPROF_FIXTURES = {
    "device_track_overlap": ([
        _meta(1, "/device:TPU:0"), _meta(99, "/host:CPU"),
        _ev("fusion.1", 1, 0, 0, 100), _ev("all-reduce.2", 1, 0, 50, 100),
        _ev("copy.3", 1, 0, 200, 50), _ev("host_noise", 99, 0, 0, 1000),
    ], {"window": (0, 500)}),
    "multi_track": ([
        _meta(1, "/device:TPU:0"), _ev("dot.1", 1, 1, 0, 100),
        _ev("dot.2", 1, 2, 0, 100),
    ], {"window": (0, 200)}),
    "step_marker_window": ([
        _meta(1, "/device:TPU:0"), _meta(7, "/host:CPU"),
        _ev("ptpu_step", 7, 3, 100, 100), _ev("ptpu_step", 7, 3, 300, 100),
        _ev("fusion.a", 1, 0, 0, 150), _ev("fusion.b", 1, 0, 350, 100),
    ], {}),
    "max_steps": ([
        _meta(1, "/device:TPU:0"), _meta(7, "/host:CPU"),
        _ev("ptpu_step", 7, 3, 100, 100), _ev("ptpu_step", 7, 3, 300, 100),
        _ev("ptpu_step", 7, 3, 900, 100), _ev("fusion.a", 1, 0, 100, 100),
        _ev("fusion.b", 1, 0, 950, 50),
    ], {"max_steps": 2}),
    "host_fallback_threads": ([
        _meta(7, "/host:CPU"), _thread(7, 1, "tf_XLAEigen/1"),
        _thread(7, 2, "python"), _thread(7, 3, "tf_XLATfrtCpuClient/3"),
        _ev("dot.5", 7, 1, 0, 100),
        _ev("ThreadpoolListener::Record", 7, 1, 0, 50),
        _ev("ThunkExecutor::Execute (wait for completion)", 7, 3, 0, 80),
        _ev("$builtins isinstance", 7, 2, 0, 30),
        _ev("PjitFunction(f)", 7, 2, 0, 40),
    ], {"window": (0, 200)}),
    "empty": ([], {}),
}


@pytest.mark.parametrize("name", sorted(_XPROF_FIXTURES))
def test_xprof_fixtures_give_the_reference_records(name):
    events, kw = _XPROF_FIXTURES[name]
    assert tx.attribute_events(events, **kw) == \
        jx.attribute_events(events, **kw)


def test_interval_math_and_names_match_reference():
    names = ["all-reduce.17", "AllGather_fusion", "reduce-scatter.2",
             "collective-permute-send.1", "psum_combiner", "copy.3",
             "MemcpyD2H", "infeed-dequeue", "fusion.12", "dot.5",
             "reduce-window.clone", "scan_loop", "send.1", "recv-done"]
    assert [tx.classify_name(n) for n in names] == \
        [jx.classify_name(n) for n in names]
    iv = [(0, 10), (5, 20), (30, 40), (40, 50), (60, 60)]
    assert tx.merge_intervals(iv) == jx.merge_intervals(iv)
    sub = [(2, 3), (15, 35)]
    assert tx.subtract_intervals([(0, 20), (30, 50)], sub) == \
        jx.subtract_intervals([(0, 20), (30, 50)], sub)


# A torch.profiler (kineto) trace of three decode steps on one stream:
# the CPU user_annotation markers on the engine thread, kineto's
# gpu_user_annotation copy spanning each step on the device track, and
# the host-side runtime calls, flows and ops around the device work.
def _kineto_trace():
    cpu, dev = (100, 5), (0, 7)
    evs = [_meta(100, "python3"), _meta(0, "python3")]
    for i, t in enumerate((1000, 2000, 3000)):
        evs.append(_ev("ptpu_step", *cpu, t, 600, cat="user_annotation"))
        evs.append(_ev("ptpu_step", *dev, t + 5, 640,
                       cat="gpu_user_annotation"))
        evs.append(_ev("cudaGraphLaunch", *cpu, t + 1, 20,
                       cat="cuda_runtime"))
        evs.append(_ev("aten::copy_", *cpu, t + 30, 50, cat="cpu_op"))
        evs.append(_ev("nvjet_tst_128x64_64x8_1x2_h_bz_NNT", *dev, t + 10,
                       200, cat="kernel"))
        evs.append(_ev("void at::native::direct_copy_kernel_cuda", *dev,
                       t + 210, 100, cat="kernel"))
        evs.append(_ev("Memcpy DtoH (Device -> Pageable)", *dev, t + 400,
                       20, cat="gpu_memcpy"))
        evs.append(_ev("Memset (Device)", *dev, t + 430, 10,
                       cat="gpu_memset"))
        evs.append({"ph": "f", "cat": "ac2g", "name": "ac2g", "pid": 0,
                    "tid": 7, "ts": t + 10, "id": i})
    return evs


def test_kineto_device_events_and_cpu_marker_anchor():
    att = tx.attribute_events(_kineto_trace())
    # Three steps, not six: the gpu_user_annotation copies neither
    # anchor nor count; they are not device work either.
    assert att["step_markers"] == 3 and not att["host_fallback"]
    assert att["device_pids"] == ["0"] and att["events"] == 12
    assert att["wall_s"] == 0.0026              # [1000, 3600) us
    # per step: GEMM 200 + memset 10 compute; copy kernel 100 + memcpy
    # 20 transfer
    assert att["category_s"] == {"collective": 0.0, "transfer": 0.00036,
                                 "compute": 0.00063}
    assert att["device_busy_share"] == round(990 / 2600, 6)
    assert att["device_busy_share"] < 0.5       # not the annotations' ~1.0
    # max_steps anchors on the first N CPU markers only
    two = tx.attribute_events(_kineto_trace(), max_steps=2)
    assert two["step_markers"] == 2 and two["wall_s"] == 0.0016


def test_kineto_kernel_names_keep_the_reference_regexes():
    """A kernel's category is the reference's name rule, plus every
    ``nccl*`` kernel a collective; a memcpy is always a transfer."""
    def cat(name, c="kernel"):
        return tx.classify_device_event({"name": name, "cat": c})

    assert cat("ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)") \
        == "collective"
    assert cat("ncclDevKernel_AllReduce_Sum_f32_RING_LL") == "collective"
    assert cat("void at::native::direct_copy_kernel_cuda") == "transfer"
    assert cat("nvjet_tst_128x64_64x8_1x2_h_bz_NNT") == "compute"
    assert cat("flash_fwd_kernel") == "compute"
    assert cat("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy") \
        == "transfer"
    assert cat("anything", "gpu_memcpy") == "transfer"
    assert cat("Memset (Device)", "gpu_memset") == "compute"
    for name in ("all-reduce.1", "copy.3", "fusion.2"):
        assert cat(name) == jx.classify_name(name)


def test_torch_host_trace_falls_back_to_the_marker_threads():
    """No device activity (a CPU run): the cpu_ops on the marker threads
    stand in for the device, labelled host_fallback."""
    evs = [_ev("ptpu_step", 1, 5, 0, 100, cat="user_annotation"),
           _ev("aten::mm", 1, 5, 10, 40, cat="cpu_op"),
           _ev("aten::addmm", 1, 5, 20, 10, cat="cpu_op"),   # nested
           _ev("aten::copy_", 1, 5, 60, 20, cat="cpu_op"),
           _ev("aten::mm", 1, 9, 0, 100, cat="cpu_op")]      # HTTP thread
    att = tx.attribute_events(evs)
    assert att["host_fallback"] and att["device_pids"] == []
    assert att["events"] == 3
    assert att["category_s"] == {"collective": 0.0, "transfer": 0.00002,
                                 "compute": 0.00004}
    assert att["host_gap_share"] == 0.4


def test_find_trace_file_takes_torch_dumps(tmp_path):
    d = tmp_path / "profile_1"
    d.mkdir()
    events = {"traceEvents": _kineto_trace()}
    (d / "host_1.pt.trace.json").write_text(json.dumps(events))
    assert tx.find_trace_file(str(tmp_path)).endswith(".pt.trace.json")
    with gzip.open(d / "host_2.pt.trace.json.gz", "wt") as f:
        json.dump(events, f)
    os.utime(d / "host_2.pt.trace.json.gz", (2e9, 2e9))
    assert tx.find_trace_file(str(tmp_path)).endswith(".pt.trace.json.gz")
    assert tx.attribute_dump(str(tmp_path))["step_markers"] == 3


@pytest.mark.parametrize("name", ["gpt2-medium", "tinyllama-1.1b",
                                  "gpt2-tiny", "llama-tiny"])
def test_decode_flops_equal_reference(name):
    from polyaxon_tpu.models.registry import get_model as j_get_model

    jcfg = j_get_model(name).make_model().cfg
    tcfg = get_model(name).make_model(device="meta").cfg
    for pos in (0, 100.5, 1000):
        assert tprof.decode_flops_per_token(tcfg, pos) == \
            jprof.decode_flops_per_token(jcfg, pos)


def test_peak_flops_on_the_cpu_is_nominal():
    assert tprof.detect_peak_flops("cpu") == {
        "peak_flops": tprof.NOMINAL_PEAK_FLOPS,
        "peak_flops_source": "nominal"}


# -- FlightRecorder against one fake session ----------------------------------

_FAKE_TRACE = [
    _meta(1, "/device:TPU:0"),
    _ev("fusion.1", 1, 0, 0, 300),
    _ev("all-reduce.1", 1, 0, 300, 100),
    _ev("fusion.2", 1, 0, 950, 50),
]


class _FakeSession:
    """ProfileSession stand-in (the reference test's): the owner
    contract, the synthetic trace written on stop."""

    def __init__(self, root):
        self.root = root
        self.owner = None
        self.n = 0
        self._d = None

    def start(self, owner="manual", python_tracer=True):
        if self.owner is not None:
            raise RuntimeError("busy")
        self.owner = owner
        self.n += 1
        self._d = os.path.join(self.root, f"w{self.n}")
        os.makedirs(self._d)
        return self._d

    def stop(self, owner="manual"):
        if self.owner is None:
            raise RuntimeError("not running")
        if owner != self.owner:
            raise RuntimeError("owner mismatch")
        self.owner = None
        with open(os.path.join(self._d, "x.trace.json"), "w") as f:
            json.dump({"traceEvents": _FAKE_TRACE}, f)
        return self._d


def _settle(rec, n_windows, deadline_s=5.0):
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        rep = rec.report()
        t = rec._analyzer
        if rep["windows_analyzed"] >= n_windows \
                and (t is None or not t.is_alive()):
            return rep
        time.sleep(0.005)
    raise AssertionError(f"no {n_windows} windows in {deadline_s} s")


_VOLATILE = ("completed_at", "host_wall_s", "trace_dir")


def _stable(rec):
    return None if rec is None else {k: v for k, v in rec.items()
                                     if k not in _VOLATILE}


def _drive(FR, root, scenario):
    """One scenario's sequence on package ``FR``'s recorder; returns
    (report without volatile fields, metric names, info keys,
    session owner)."""
    sess = _FakeSession(root)
    kw = dict(every=3, steps=2, prime=False, flops_fn=lambda pos: 100.0,
              peak_flops=1e6, n_devices=1, position_probe=lambda: 7.0)
    if scenario == "deadline":
        kw.update(every=1, steps=100, max_window_s=0.1)
    if scenario == "no_flops":
        kw.update(flops_fn=lambda pos: None)
    rec = FR(sess, **kw)
    want = 0
    if scenario == "manual":
        sess.start(owner="manual")
        for _ in range(7):
            rec.on_step_start()
            rec.on_step_end(1)
        sess.stop(owner="manual")
    if scenario == "own_stop":
        sess.owner = "recorder"       # a previous stop still in flight
        for _ in range(3):
            rec.on_step_start()
            rec.on_step_end(1)
        sess.owner = None
    if scenario == "deadline":
        rec.on_step_start()
        rec.on_step_end(4)
        _settle(rec, 1)
        want = 1
    for tokens in (5, 5, 4, 6, 1, 1, 1, 2, 3):
        rec.on_step_start()
        rec.on_step_end(tokens)
        if rec._window is None and rec._analyzer is not None:
            want = rec.windows_total
            _settle(rec, want)
    rep = _settle(rec, want) if want else rec.report()
    out = ({**{k: v for k, v in rep.items()
               if k not in ("latest", "windows")},
            "latest": _stable(rep["latest"]),
            "windows": [_stable(w) for w in rep["windows"]]},
           [line.split()[0] for line in rec.metrics_lines()],
           sorted(k for k in rec.info_block() if k != "last_window_age_s"),
           sess.owner)
    rec.close()
    return out


@pytest.mark.parametrize("scenario", ["cadence", "manual", "own_stop",
                                      "deadline", "no_flops"])
def test_recorder_windows_and_records_match_reference(scenario, tmp_path):
    ours = _drive(tprof.FlightRecorder, str(tmp_path / "t"), scenario)
    theirs = _drive(jprof.FlightRecorder, str(tmp_path / "j"), scenario)
    assert ours == theirs
    assert ours[0]["windows_total"] >= 1


def test_recorder_prime_raises_on_a_broken_profiler(tmp_path):
    """No quiet disable: a profiler that cannot start fails the
    recorder's construction (the reference records it and serves on
    without windows)."""
    class Broken(_FakeSession):
        def start(self, owner="manual", python_tracer=True):
            raise OSError("profiler unavailable")

    with pytest.raises(OSError):
        tprof.FlightRecorder(Broken(str(tmp_path)), every=1)
    rec = jprof.FlightRecorder(Broken(str(tmp_path)), every=1)
    assert rec.last_error.startswith("prime: OSError")


# -- ProfileSession on torch.profiler ------------------------------------------

def test_profile_session_single_flight_per_process(tmp_path):
    """One profiler per process: a second session refuses to start while
    the first holds it; owners are enforced; the trace lands as a torch
    dump that the parser reads.  The runner keeps the profiler on this
    thread (the one whose ops it records); the default runner is a
    thread of the session's own."""
    def here(fn):
        return fn()

    a = ProfileSession(str(tmp_path / "a"), runner=here)
    b = ProfileSession(str(tmp_path / "b"))
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    d = a.start(owner="recorder", python_tracer=False)
    try:
        with pytest.raises(RuntimeError, match="already running"):
            a.start()
        with pytest.raises(RuntimeError, match="in this process"):
            b.start()
        with pytest.raises(RuntimeError, match="flight recorder"):
            a.stop(owner="manual")
        with torch.profiler.record_function("ptpu_step"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    finally:
        assert a.stop(owner="recorder") == d
    assert tx.find_trace_file(d).endswith(".pt.trace.json")
    att = tx.attribute_dump(d)
    assert att["step_markers"] == 1 and att["host_fallback"]
    assert set(a.timings) == {"start_s", "stop_s", "export_s"}
    b.start()
    b.close()
    assert not b.active
    with pytest.raises(RuntimeError, match="no profile is running"):
        b.stop()


# -- the server's /profile/* routes, on gpt2-tiny --------------------------------

@pytest.fixture(scope="module")
def tiny():
    return get_model("gpt2-tiny").init_params(seed=0, device="cpu",
                                              dtype=torch.float32)


def _start(ms):
    srv = make_server("127.0.0.1", 0, ms)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _post(base, payload, path="/generate"):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base, path):
    try:
        with urllib.request.urlopen(base + path, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_profile_routes_answer_as_the_reference(tiny, tmp_path):
    """400 without a profile dir; with one, 200 / 409 on a second start
    / 200 / 409 on a stop with nothing running; a window started from a
    handler thread holds the engine thread's ptpu_step markers."""
    ms = ModelServer(tiny, n_slots=2, decode_window=1)
    srv, base = _start(ms)
    try:
        for path in ("/profile/start", "/profile/stop"):
            code, out = _post(base, {}, path)
            assert code == 400 and "--profile-dir" in out["error"]
        assert _get(base, "/profile/report")[0] == 400
    finally:
        srv.shutdown()
        srv.server_close()
        ms.close()
    ms = ModelServer(tiny, n_slots=2, decode_window=1,
                     profile_dir=str(tmp_path))
    srv, base = _start(ms)
    try:
        code, started = _post(base, {}, "/profile/start")
        assert code == 200 and started["profiling"]
        code, out = _post(base, {}, "/profile/start")
        assert code == 409 and "already running" in out["error"]
        threads = [threading.Thread(target=_post, args=(base, {
            "prompt": [1, 2, 3 + i], "max_new_tokens": 6}))
            for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        code, stopped = _post(base, {}, "/profile/stop")
        assert code == 200 and stopped["dir"] == started["dir"]
        assert _post(base, {}, "/profile/stop")[0] == 409
        events = tx.load_profile_events(stopped["dir"])
        marks = [e for e in events if e.get("name") == "ptpu_step"]
        assert marks and {(e["pid"], e["tid"]) for e in marks} == {
            (e["pid"], e["tid"]) for e in events
            if e.get("cat") == "cpu_op" and e["name"] == "aten::mm"
            and any(m["ts"] <= e["ts"] <= m["ts"] + m["dur"]
                    for m in marks)}
        att = tx.attribute_dump(stopped["dir"])
        assert att["step_markers"] == len(marks) >= 5
        assert 0 < att["device_busy_share"] <= 1
    finally:
        srv.shutdown()
        srv.server_close()
        ms.close()


def test_live_recorder_publishes_gauges_and_info(tiny, tmp_path):
    """The recorder on a live engine: windows fire under traffic, the
    published record's gauges, /info block and report agree, and its
    metric names and /info keys are the reference recorder's."""
    from polyaxon_tpu_torch.serving.telemetry import parse_prometheus_text

    ms = ModelServer(tiny, n_slots=2, decode_window=1,
                     profile_dir=str(tmp_path), profile_every=2,
                     profile_steps=3)
    srv, base = _start(ms)
    try:
        assert _get(base, "/profile/report")[0] == 404
        _post(base, {"prompt": [1, 2, 3], "max_new_tokens": 12})
        rep = _settle(ms.recorder, 1)
        latest = rep["latest"]
        assert latest["steps"] == 3 and latest["step_markers"] == 3
        assert latest["host_fallback"] and latest["mfu"] is not None
        assert latest["peak_flops_source"] == "nominal"
        code, body = _get(base, "/profile/report")
        assert code == 200 and json.loads(body)["latest"] == latest
        metrics = parse_prometheus_text(_get(base, "/metrics")[1])
        for key in ("collective_share", "host_gap_share",
                    "device_busy_share", "mfu"):
            assert metrics[f"ptpu_serving_{key}"] == latest[key]
        info = json.loads(_get(base, "/info")[1])
        assert info["profiling"]["device_busy_share"] == \
            latest["device_busy_share"]
        assert info["coalesced_batches"] == 0
        names = {e["name"] for e in ms.telemetry.events()}
        assert {"profile_window_start", "profile_window_stop"} <= names
        ours = [line.split()[0] for line in ms.recorder.metrics_lines()]
        theirs = jprof.FlightRecorder(_FakeSession(str(tmp_path / "j")),
                                      every=1, prime=False)
        theirs._latest = ms.recorder.latest()
        assert ours == [line.split()[0]
                        for line in theirs.metrics_lines()]
        assert sorted(ms.recorder.info_block()) == \
            sorted(theirs.info_block())
    finally:
        srv.shutdown()
        srv.server_close()
        ms.close()
    assert not ms.profiler.active


def test_recorder_stop_outlasting_the_loop_timeout_is_retried(tiny,
                                                              tmp_path):
    """A window's stop the engine loop does not take in time (the loop
    held the device lock past the runner's timeout) is handed over
    again, so the trace ends and the session is free once the loop
    comes back."""
    ms = ModelServer(tiny, n_slots=2, decode_window=1,
                     profile_dir=str(tmp_path), profile_every=1,
                     profile_steps=1)
    try:
        ms.profiler.runner = lambda fn: ms.engine.run_on_loop(fn,
                                                              timeout=0.1)
        rec = ms.recorder
        rec.on_step_start()
        assert ms.profiler.owner == "recorder"
        entered, release = threading.Event(), threading.Event()

        def hold():
            entered.set()
            release.wait(10)

        holder = threading.Thread(target=ms.engine.run_on_loop,
                                  args=(hold,), kwargs={"timeout": 10})
        holder.start()
        assert entered.wait(5)
        rec.on_step_end(1)
        end = time.monotonic() + 5
        while "retrying" not in (rec.report()["last_error"] or ""):
            assert time.monotonic() < end, rec.report()
            time.sleep(0.01)
        assert ms.profiler.owner == "recorder"
        release.set()
        holder.join(5)
        rec._analyzer.join(5)
        assert not rec._analyzer.is_alive()
        assert not ms.profiler.active and ms.profiler.owner is None
        d = ms.profiler.start(owner="manual", python_tracer=False)
        assert ms.profiler.stop(owner="manual") == d
    finally:
        release.set()
        ms.close()


def test_dump_spans_jsonl_one_line_an_event(tiny, tmp_path):
    ms = ModelServer(tiny, n_slots=2, decode_window=1)
    try:
        ms.generate({"prompt": [1, 2, 3], "max_new_tokens": 4})
        path = tmp_path / "spans.jsonl"
        path.write_text("stale line\n")
        n = dump_spans_jsonl(ms.telemetry, str(path))
        lines = path.read_text().splitlines()
        assert n == len(lines) == len(ms.telemetry.events()) > 0
        assert [json.loads(line) for line in lines] == \
            ms.telemetry.events()
    finally:
        ms.close()


def test_cli_trace_file_written_at_sigint(tmp_path):
    """``serve --cpu --trace-file T`` as a process: after SIGINT, T holds
    one JSON line per event ``GET /trace`` showed."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    trace = tmp_path / "spans.jsonl"
    env = {**os.environ, "OMP_NUM_THREADS": "2", "PYTHONPATH": ROOT}
    proc = subprocess.Popen(
        [sys.executable, "-m", "polyaxon_tpu_torch.cli", "serve", "--cpu",
         "--model", "gpt2-tiny", "--port", str(port), "--trace-file",
         str(trace)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                if _get(base, "/healthz")[0] == 200:
                    break
            except OSError:
                pass
            assert time.monotonic() < deadline and proc.poll() is None
            time.sleep(0.2)
        assert _post(base, {"prompt": [1, 2, 3],
                            "max_new_tokens": 4})[0] == 200
        doc = json.loads(_get(base, "/trace")[1])
        n = len([e for e in doc["traceEvents"] if e.get("ph") != "M"])
        proc.send_signal(signal.SIGINT)
        out = proc.communicate(timeout=30)[0].decode()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    assert f"wrote {n} trace events" in out
    assert len(trace.read_text().splitlines()) == n > 0



def test_crash_inside_a_recorder_window_releases_the_session(tiny,
                                                             tmp_path):
    """An engine death (the ``--fault-plan`` site ``engine_death``)
    inside an open recorder window: the supervisor restarts the loop on
    a new thread, the window's trace is stopped on the thread that
    started it before that thread exits and is analyzed, later windows
    open, and a manual ``/profile/start`` answers 200 once they close
    (the reference goes on recording after a restart).  The death is
    armed once the window is open (its ``after`` gate moved to the
    probes seen so far), so it lands inside the window."""
    plan = {"seed": 0, "faults": [{"site": "engine_death",
                                   "after": 10 ** 9, "times": 1}]}
    ms = ModelServer(tiny, n_slots=2, decode_window=1,
                     profile_dir=str(tmp_path), profile_every=1,
                     profile_steps=1000, fault_plan=plan)
    srv, base = _start(ms)
    try:
        rec = ms.recorder
        done = {}
        t = threading.Thread(target=lambda: done.update(out=_post(
            base, {"prompt": [1, 2, 3], "max_new_tokens": 40})))
        t.start()
        end = time.monotonic() + 10
        while rec.windows_total < 1:
            assert time.monotonic() < end
            time.sleep(0.001)
        spec = ms.faults.specs[0]
        with ms.faults._plan_lock:
            spec.after = spec.probes
        t.join(60)
        code, out = done["out"]
        assert code == 200 and len(out["tokens"][0]) == 43
        assert ms.supervisor.restarts_total == 1
        assert ms.faults.stats()["faults_injected"]["engine_death"] == 1
        assert rec.windows_total == 2, rec.report()
        rec._deadline_close(2)          # the watchdog's close
        end = time.monotonic() + 10
        while rec.windows_analyzed < 2:
            assert time.monotonic() < end, rec.report()
            time.sleep(0.01)
        assert rec.last_error is None and not ms.profiler.active
        code, started = _post(base, {}, "/profile/start")
        assert code == 200 and started["profiling"], started
        _post(base, {"prompt": [4, 5, 6], "max_new_tokens": 4})
        code, stopped = _post(base, {}, "/profile/stop")
        assert code == 200 and stopped["dir"] == started["dir"]
        assert tx.attribute_dump(stopped["dir"])["step_markers"] >= 3
    finally:
        srv.shutdown()
        srv.server_close()
        ms.close()
    assert not ms.profiler.active
