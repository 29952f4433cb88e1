"""Chrome-trace attribution for profiler dumps: ``torch.profiler``
(kineto) traces on the card, and the reference's xprof traces.

``torch.profiler`` writes one Chrome trace-event document per window
(``*.pt.trace.json``, serving/telemetry.py ``ProfileSession``).  This
module reduces such a document into the attribution record the serving
flight recorder (serving/profiling.py) publishes:

- every selected DEVICE event is CLASSIFIED as ``collective``
  (all-reduce / all-gather / reduce-scatter / all-to-all /
  collective-permute / psum, and every ``nccl*`` kernel), ``transfer``
  (copy / memcpy / infeed / outfeed / send / recv) or ``compute``
  (everything else — GEMMs, attention, elementwise);
- per-category busy time is the UNION of event intervals (parallel
  streams never double-count), with overlaps resolved by priority
  collective > transfer > compute, so the categories PARTITION the
  busy timeline and their shares can never sum past 1.0 of wall;
- ``host_gap`` is the remainder: wall time in the attribution window
  during which the device ran nothing — dispatch bubbles, host
  scheduling, admission bookkeeping (arXiv:2011.03641's "host-bound"
  signature).

Which events are device work (``attribute_events``):

- a kineto trace: the events whose ``cat`` is ``kernel`` or
  ``gpu_memset`` (classified by name with the reference's regexes, plus
  the ``nccl*`` rule) and ``gpu_memcpy`` (always ``transfer``).  Never
  the ``gpu_user_annotation`` copies of ``record_function`` ranges
  (kineto projects each CPU range onto the device track; the
  ``ptpu_step`` copy spans the whole step and would read busy ≈ 1.0),
  nor ``cuda_runtime`` / ``cuda_driver`` calls, ``ac2g`` flows or any
  other host-side category;
- an xprof trace (the reference's format): processes named
  ``/device:*``.  Nothing in the port writes this format: these
  branches (with the ``tf_*`` threads and ``_RUNTIME_NOISE`` below)
  serve offline reading of the reference's dumps, and keep the
  reference's fixtures giving the same records through both packages;
- neither (a CPU run): the host fallback — ``cpu_op`` events on the
  thread(s) that carry the step markers (a torch trace), else XLA's
  ``tf_*`` runtime threads (an xprof host trace); the record says
  ``host_fallback: true``.

The attribution window defaults to the span of the serving step
markers (``ptpu_step`` ``record_function`` ranges, emitted by the slot
managers around every decode dispatch).  Only the CPU
``user_annotation`` copy of a marker anchors the window and counts as
a step.

Pure stdlib — importable for offline analysis of a saved dump
(``python -c "from polyaxon_tpu_torch.analysis.xprof import
attribute_dump; print(attribute_dump('DIR'))"``).  The port's own copy
of the reference's ``analysis/xprof.py``: the interval math and the
name regexes are the reference's; the device-event choice above is
the port's.
"""

from __future__ import annotations

import functools
import glob
import gzip
import json
import os
import re
from typing import Any, Dict, Iterable, List, Optional, Sequence, \
    Tuple

__all__ = ["CATEGORIES", "classify_name", "classify_device_event",
           "find_trace_file", "load_profile_events", "merge_intervals",
           "subtract_intervals", "attribute_events", "attribute_dump",
           "STEP_MARKER", "DEVICE_CATS"]

# The record_function name the slot managers wrap every decode
# dispatch in (serving/slots.py step_annotation) — the parser's
# window anchor.
STEP_MARKER = "ptpu_step"

# Priority order: an event matching an earlier category never counts
# toward a later one, and overlap between categories resolves the
# same way (see attribute_events).
CATEGORIES = ("collective", "transfer", "compute")

# kineto's device-activity categories: the only events of a torch
# trace that are work on the card.
DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")

_COLLECTIVE = re.compile(
    r"all[-_ ]?reduce|all[-_ ]?gather|reduce[-_ ]?scatter"
    r"|all[-_ ]?to[-_ ]?all|collective|psum|ppermute"
    r"|(^|[-_ .])permute", re.IGNORECASE)
_TRANSFER = re.compile(
    r"copy|memcpy|infeed|outfeed|(^|[-_ .])(send|recv)($|[-_ .0-9])"
    r"|transfer|h2d|d2h|host[-_ ]?to[-_ ]?device"
    r"|device[-_ ]?to[-_ ]?host", re.IGNORECASE)
# NCCL's kernels (ncclDevKernel_*, ncclKernel_*): every one is a
# collective, whatever its operation's name.
_NCCL = re.compile(r"^(void )?nccl", re.IGNORECASE)

# xprof host-platform fallback: XLA runtime worker threads whose
# events are the closest thing a CPU "device" has to a device track
# ... minus pure bookkeeping noise on those threads.
_RUNTIME_THREAD = re.compile(r"^tf_")
_RUNTIME_NOISE = re.compile(
    r"ThreadpoolListener|TaskDispatcher|dispatch|wait", re.IGNORECASE)


def classify_name(name: str) -> str:
    """collective / transfer / compute for one event name (priority
    order — ``collective-permute-send`` is a collective, not a
    transfer)."""
    if _COLLECTIVE.search(name):
        return "collective"
    if _TRANSFER.search(name):
        return "transfer"
    return "compute"


def classify_device_event(ev: Dict[str, Any]) -> str:
    """The category of one selected device event: a ``gpu_memcpy`` is
    always ``transfer``; an ``nccl*`` kernel is ``collective``; any
    other kernel or memset goes by :func:`classify_name` (a ``copy``
    kernel — ``direct_copy_kernel_cuda`` — is ``transfer``)."""
    return _classify(ev.get("cat"), ev.get("name", ""))


@functools.lru_cache(maxsize=4096)
def _classify(cat, name: str) -> str:
    # Cached by (cat, name): a window holds tens of thousands of
    # launches of a few dozen kernels, and the parse competes with the
    # decode loop for the GIL.
    if cat == "gpu_memcpy":
        return "transfer"
    if cat == "kernel" and _NCCL.search(name):
        return "collective"
    return classify_name(name)


def find_trace_file(root: str) -> Optional[str]:
    """Newest ``*.trace.json[.gz]`` under ``root`` — torch's
    ``*.pt.trace.json[.gz]`` and xprof's ``*.trace.json[.gz]`` alike
    (a session dir, its parent ``--profile-dir``, or any ancestor)."""
    hits: List[str] = []
    for pat in ("*.trace.json.gz", "*.trace.json"):
        hits += glob.glob(os.path.join(root, "**", pat),
                          recursive=True)
    if not hits:
        return None
    return max(hits, key=os.path.getmtime)


def load_profile_events(path: str) -> List[Dict[str, Any]]:
    """Trace events from a profiler dump: ``path`` may be the trace
    file itself (.json / .json.gz) or a directory to search with
    :func:`find_trace_file`."""
    if os.path.isdir(path):
        f = find_trace_file(path)
        if f is None:
            raise FileNotFoundError(
                f"no *.trace.json[.gz] under {path!r} — did the "
                f"profiler write this dump?")
        path = f
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        doc = json.load(fh)
    evs = doc.get("traceEvents") if isinstance(doc, dict) else doc
    if not isinstance(evs, list):
        raise ValueError(f"{path}: not a Chrome trace document")
    return evs


def merge_intervals(iv: Iterable[Tuple[float, float]]
                    ) -> List[Tuple[float, float]]:
    """Union of half-open intervals, sorted and coalesced."""
    iv = sorted((a, b) for a, b in iv if b > a)
    out: List[Tuple[float, float]] = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def subtract_intervals(iv: Sequence[Tuple[float, float]],
                       sub: Sequence[Tuple[float, float]]
                       ) -> List[Tuple[float, float]]:
    """``iv`` minus ``sub`` (both merged/sorted)."""
    out: List[Tuple[float, float]] = []
    j = 0
    for a, b in iv:
        cur = a
        while j < len(sub) and sub[j][1] <= cur:
            j += 1
        k = j
        while k < len(sub) and sub[k][0] < b:
            s, e = sub[k]
            if s > cur:
                out.append((cur, s))
            cur = max(cur, e)
            if cur >= b:
                break
            k += 1
        if cur < b:
            out.append((cur, b))
    return out


def _span(iv: Sequence[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in iv)


def _clip(iv: Iterable[Tuple[float, float]], lo: float, hi: float
          ) -> List[Tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in iv
            if min(b, hi) > max(a, lo)]


def _meta_maps(events: Sequence[Dict[str, Any]]):
    procs: Dict[Any, str] = {}
    threads: Dict[Tuple[Any, Any], str] = {}
    for ev in events:
        if ev.get("ph") != "M":
            continue
        args = ev.get("args") or {}
        if ev.get("name") == "process_name":
            procs[ev.get("pid")] = str(args.get("name", ""))
        elif ev.get("name") == "thread_name":
            threads[(ev.get("pid"), ev.get("tid"))] = str(
                args.get("name", ""))
    return procs, threads


def _is_marker(ev: Dict[str, Any], step_marker: str) -> bool:
    """A step marker's HOST copy: kineto also projects every
    ``record_function`` range onto the device track as a
    ``gpu_user_annotation`` (and other backends as ``*_user_annotation``
    device copies) — those neither anchor nor count."""
    if ev.get("name") != step_marker:
        return False
    cat = str(ev.get("cat", ""))
    return not (cat.endswith("user_annotation")
                and cat != "user_annotation")


def _select(events: Sequence[Dict[str, Any]], step_marker: str):
    """(device events, CPU step markers, host_fallback, device pids)."""
    procs, threads = _meta_maps(events)
    xs = [ev for ev in events if ev.get("ph") == "X" and "ts" in ev]
    steps = [ev for ev in xs if _is_marker(ev, step_marker)]
    kineto = [ev for ev in xs if ev.get("cat") in DEVICE_CATS]
    if kineto:
        return (kineto, steps, False,
                sorted({str(ev.get("pid")) for ev in kineto}))
    device_pid_set = {pid for pid, name in procs.items()
                      if "/device:" in name}
    dev: List[Dict[str, Any]] = []
    if device_pid_set:
        for ev in xs:
            name = ev.get("name", "")
            if name == step_marker \
                    or name.startswith(("ThreadpoolListener", "$")):
                continue
            if ev.get("pid") in device_pid_set:
                dev.append(ev)
        return dev, steps, False, sorted(str(p)
                                         for p in device_pid_set)
    if any(ev.get("cat") == "cpu_op" for ev in xs):
        # A torch host trace: the ops on the threads the step markers
        # ran on (the engine thread) are the closest thing a CPU run
        # has to a device track.
        marker_tids = {(ev.get("pid"), ev.get("tid")) for ev in steps}
        dev = [ev for ev in xs if ev.get("cat") == "cpu_op"
               and (ev.get("pid"), ev.get("tid")) in marker_tids]
        return dev, steps, True, []
    runtime_tids = {key for key, name in threads.items()
                    if _RUNTIME_THREAD.search(name)}
    for ev in xs:
        name = ev.get("name", "")
        if name == step_marker \
                or name.startswith(("ThreadpoolListener", "$")):
            continue
        if (ev.get("pid"), ev.get("tid")) not in runtime_tids \
                or _RUNTIME_NOISE.search(name):
            continue
        dev.append(ev)
    return dev, steps, True, []


def attribute_events(events: Sequence[Dict[str, Any]], *,
                     window: Optional[Tuple[float, float]] = None,
                     step_marker: str = STEP_MARKER,
                     max_steps: Optional[int] = None
                     ) -> Dict[str, Any]:
    """Reduce one trace-event list to the per-window attribution
    record (all times in SECONDS):

    - device events as the module docstring chooses them
      (``host_fallback: true`` when the trace has none);
    - window = explicit ``window`` (ts microseconds), else the span
      of the CPU ``step_marker`` events — the FIRST ``max_steps`` of
      them when given, so a straggler dispatch that lands its marker
      between a logical window close and the profiler stop cannot
      stretch the wall — else the span of the selected device events;
    - category seconds partition the busy union (priority
      collective > transfer > compute), ``host_gap_s`` is the
      unattributed remainder, so shares sum to exactly 1.0 of wall
      (and each is <= 1.0).
    """
    dev, steps, host_fallback, device_pids = _select(events,
                                                     step_marker)
    if window is None:
        if steps and max_steps is not None:
            anchor = sorted(steps,
                            key=lambda ev: ev["ts"])[:max_steps]
        else:
            anchor = steps or dev
        if not anchor:
            return {"wall_s": 0.0, "events": 0,
                    "step_markers": 0,
                    "host_fallback": host_fallback,
                    "device_pids": device_pids,
                    "category_s": {c: 0.0 for c in CATEGORIES},
                    "host_gap_s": 0.0,
                    "shares": {c: 0.0 for c in CATEGORIES},
                    "host_gap_share": 0.0,
                    "device_busy_share": 0.0}
        lo = min(ev["ts"] for ev in anchor)
        hi = max(ev["ts"] + ev.get("dur", 0) for ev in anchor)
    else:
        lo, hi = window
    wall_us = max(hi - lo, 1e-9)

    by_cat: Dict[str, List[Tuple[float, float]]] = {
        c: [] for c in CATEGORIES}
    for ev in dev:
        a = ev["ts"]
        b = a + ev.get("dur", 0)
        by_cat[classify_device_event(ev)].append((a, b))

    merged = {c: merge_intervals(_clip(by_cat[c], lo, hi))
              for c in CATEGORIES}
    taken: List[Tuple[float, float]] = []
    cat_us: Dict[str, float] = {}
    for c in CATEGORIES:            # priority order
        own = subtract_intervals(merged[c], taken)
        cat_us[c] = _span(own)
        taken = merge_intervals(taken + own)
    busy_us = _span(taken)
    gap_us = max(0.0, wall_us - busy_us)

    wall_s = wall_us / 1e6
    shares = {c: round(cat_us[c] / wall_us, 6) for c in CATEGORIES}
    return {
        "wall_s": round(wall_s, 6),
        "events": len(dev),
        "step_markers": len([ev for ev in steps
                             if lo <= ev["ts"] <= hi]),
        "host_fallback": host_fallback,
        "device_pids": device_pids,
        "category_s": {c: round(cat_us[c] / 1e6, 6)
                       for c in CATEGORIES},
        "host_gap_s": round(gap_us / 1e6, 6),
        "shares": shares,
        "host_gap_share": round(gap_us / wall_us, 6),
        "device_busy_share": round(busy_us / wall_us, 6),
    }


def attribute_dump(path: str, **kw) -> Dict[str, Any]:
    """:func:`attribute_events` over a dump file/dir on disk."""
    return attribute_events(load_profile_events(path), **kw)
