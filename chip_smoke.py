#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``polyaxon_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

``--compare-fwd DIR`` also builds another version of the forward kernel
(``DIR`` holds its ``flash_fwd.cu`` and headers, e.g. the parent commit's
``polyaxon_tpu_torch/csrc`` unpacked with ``git archive``) and times it in
turns with this one, in the same process on the same card;
``--compare DIR`` does the same for all three kernels (``DIR``'s
``flash_fwd.cu`` and ``flash_bwd.cu``).

Phases, each raising on failure:

1. the card's name and power limit; build every CUDA kernel from
   ``polyaxon_tpu_torch/csrc`` with nvcc (sm_90a);
2. the flash-forward kernel against its plain PyTorch version at the
   main path's shape, the training shape and the masks, types, head dims
   and tile edges it takes; times of the kernel, the plain version and
   PyTorch's own ``scaled_dot_product_attention`` (a yardstick the port
   never calls) at the serving and the training shape;
3. GPT-2 medium's full forward on [2, 1024] tokens (24 flash launches),
   held against the same model's plain-attention decode path, in bf16
   and in float32;
4. greedy serving through the CLI's functions: ``generate`` equals
   ``prefill`` + ``generate_continue``, and (in float32) one-shot and
   chunked prefill give the same tokens;
5. the threefry random numbers on the card against the CPU, bitwise;
   then the continuous-batching server (``ModelServer`` ->
   ``DecodeEngine`` -> ``SlotKVManager`` / ``PagedSlotKVManager``):
   float32 engine tokens, half of them sampled, equal solo decoding and
   the paged pool (eager and lazy) gives the fixed lane's tokens; the
   CUDA-graph decode windows (greedy, sampled, paged) equal the eager
   ones bitwise, with their device times; three HTTP loads of 32
   requests from 16 clients (all greedy on the fixed-lane pool, then
   half sampled on the fixed-lane and on the paged pool: tok/s,
   latency, TTFT, windows, graph captures, device busy share), then
   POST /drain;
6. the flash-backward kernels (dq, dkv) against their plain version at
   the training path's shape, the forward's case list, the Hopper
   kernels' tile edges and an LSE cotangent; their times, bounds and
   PyTorch's SDPA backward;
7. GPT-2 medium training at full width and depth (batch 8 x 1024, bf16
   compute on float32 master weights, AdamW): a few steps through
   ``polyaxon_tpu_torch.train.main`` (24 forward, 24 dq and 24 dkv
   launches a step), whose checkpoint ``generate --checkpoint`` then
   serves with the trained model's tokens (bf16 as served, and float32),
   then a timed loop of ``TrainStep`` calls (step time, tok/s, MFU,
   device idle share, top kernels);
8. one float32 step's loss and gradients through the flash route against
   the plain-attention route, at GPT-2 medium's width and 4 layers;
9. one JSON line of kernel records, the card line, and the final
   ``{"ok": true, ...}`` line.

Exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA's data sheet, dense): HBM bytes/s and FLOP/s.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
TOL = {torch.bfloat16: (2e-2, 1e-2), torch.float16: (2e-2, 1e-2),
       torch.float32: (1e-4, 1e-4)}  # (O, LSE)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def eager_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Per-call time of ``calls`` eager calls back to back (median of
    ``reps``): the device time, or the host's launch cost where that is
    larger."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = _events()
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def graph_ms(fn, calls: int = 10, reps: int = 20) -> float:
    """Device time of one call: ``calls`` calls captured in a CUDA graph,
    replayed ``reps`` times (median), so no host launch cost is in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = _events()
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def device_breakdown(fn, wall_ms: float, label: str, host: bool = True):
    """One call of ``fn`` under torch.profiler: the device's busy time
    (kernel times summed; one stream, so they do not overlap) against
    ``wall_ms`` measured without the profiler, and the top kernels.
    ``host=False`` traces the device alone (a long serving load's host
    events cost more to collect than its kernels).  Returns the busy ms
    (None when the profiler saw no kernel)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if host:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = []
    for e in prof.key_averages():
        # Device kernels only: a record_function range such as
        # "Optimizer.step#AdamW.step" also carries device time, which
        # overlaps the kernels it encloses.  (Kernel names may hold "#"
        # too: "{lambda()#3}".)
        if not str(e.device_type).endswith("CUDA") or \
                getattr(e, "is_user_annotation", False) or \
                e.key.startswith(("Optimizer.", "ProfilerStep")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            kernels.append((us / 1e3, e.count, e.key))
    if not kernels:
        print(f"[{label}] device busy time: not measured (the profiler "
              f"saw no CUDA kernel)")
        return None
    kernels.sort(reverse=True)
    busy = sum(k[0] for k in kernels)
    flash = {name: sum(k[0] for k in kernels if name in k[2])
             for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    print(f"[{label}] device busy {busy:.3f} ms of {wall_ms:.3f} ms wall "
          f"(idle share {max(0.0, 1 - busy / wall_ms):.3f}); "
          + ", ".join(f"{n} {ms:.3f} ms ({ms / busy:.3f} of busy)"
                      for n, ms in flash.items() if ms > 0)
          + f"; {sum(k[1] for k in kernels)} kernel launches")
    for ms, count, name in kernels[:8]:
        print(f"[{label}]   {ms:9.3f} ms  x{count:<5d} {name[:90]}")
    return busy


def device_kernels(fn) -> list:
    """The names of the CUDA kernels one call of ``fn`` launches, as
    torch.profiler prints them (cut to 100 characters)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:100] for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")})


def admitted_pairs(b, h, sq, sk, causal, window, kv_mask, device) -> int:
    """(q, k) pairs these inputs' masks admit: the work the function
    needs (4 * D FLOPs a pair)."""
    q_ids = torch.arange(sq, device=device)[:, None] + (sk - sq)
    k_ids = torch.arange(sk, device=device)[None, :]
    valid = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        valid &= q_ids >= k_ids
    if window is not None:
        valid &= q_ids - k_ids <= window
    valid = valid[None].expand(b, sq, sk)
    if kv_mask is not None:
        valid = valid & kv_mask[:, None, :]
    return int(valid.sum().item()) * h


def bound(q, k, causal, window, kv_mask, *, q_like=2, kv_like=2, rows=1,
          flop_per_pair=4):
    """(least ms, "bytes" | "operations") for one call on an H100:
    ``q_like`` tensors of q's shape and ``kv_like`` of k's read or
    written once, ``rows`` f32 arrays of [B, H, Sq], the mask, and
    ``flop_per_pair`` x D FLOP per admitted (q, k) pair.  The forward is
    Q, O / K, V / LSE at 4 D; dq is Q, dO, dQ / K, V / LSE, delta at 6 D;
    dkv is Q, dO / K, V, dK, dV / LSE, delta at 8 D."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    el = q.element_size()
    nbytes = (q_like * q.numel() + kv_like * k.numel()) * el \
        + rows * b * h * sq * 4 + (0 if kv_mask is None else kv_mask.numel())
    flops = float(flop_per_pair) * d * admitted_pairs(
        b, h, sq, sk, causal, window, kv_mask, q.device)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_build():
    from polyaxon_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    secs = time.perf_counter() - t0
    print(f"[build] {_build.sources()} in {secs:.1f} s")
    faults = []
    for log in _build.build_log.values():
        faults += ptxas_report(log, "")
    print(f"[build] wgmma kernels: "
          f"{', '.join(faults) if faults else 'no spills, no C75xx'}")


def _kernel_label(mangled: str) -> str:
    """e.g. ...18flash_bwd_dq_wgmmaI13__nv_bfloat16Li64E... ->
    flash_bwd_dq_wgmma/nv_bfloat16/D64."""
    fn = re.search(r"\d(flash_[a-z0-9_]+?)I", mangled)
    ty = re.search(r"(__nv_bfloat16|__half)", mangled)
    d = re.search(r"Li(\d+)E", mangled)
    return "/".join(x for x in (
        fn and fn.group(1), ty and ty.group(1).strip("_"),
        d and f"D{d.group(1)}") if x)


def ptxas_report(log: str, prefix: str) -> list:
    """Print each kernel's registers, spills and any C75xx line (wgmmas
    serialised: C7511 for want of registers, C7518 for a branch) of an
    nvcc log; return the faults of the bf16/fp16 (wgmma) kernels, which
    must neither spill nor serialise their wgmmas."""
    faults, kernel = [], "?"
    for line in log.splitlines():
        entry = re.search(r"entry function '(\S+)'", line)
        if entry:
            kernel = prefix + _kernel_label(entry.group(1))
        elif "(C75" in line:  # e.g. C7511: wgmmas serialised
            fn = re.search(r"function '(\S+)'", line)
            code = re.search(r"\((C75\d+)\)", line).group(1)
            where = prefix + _kernel_label(fn.group(1)) if fn else kernel
            print(f"[build] {where}: {line.strip()[:160]}")
            faults.append(f"{where} {code}")
        elif "registers" in line or "spill" in line or "warn" in line:
            print(f"[build] {kernel}: {line.strip()}")
            spills = re.search(r"(\d+) bytes spill stores", line)
            if "wgmma" in kernel and spills and int(spills.group(1)):
                faults.append(f"{kernel} spills")
    return faults


def _qkv(b, sq, sk, h, d, dtype, gen, fused=False):
    dev = "cuda"
    if fused:  # the model's layout: q/k/v are views of one projection
        qkv = torch.randn((b, sq, 3 * h * d), generator=gen, device=dev)
        qkv = qkv.to(dtype)
        return tuple(t.reshape(b, sq, h, d)
                     for t in qkv.split(h * d, dim=-1))
    return tuple(torch.randn((b, s, h, d), generator=gen,
                             device=dev).to(dtype)
                 for s in (sq, sk, sk))


def other_forward(src_dir):
    """``flash_fwd`` of another version of the kernel sources (a directory
    holding its ``flash_fwd.cu`` and headers, e.g. the parent commit's
    ``csrc`` unpacked with ``git archive``), built here like the port's
    own; called as ``fn(q, k, v, causal, scale) -> (O, LSE)``."""
    import ctypes

    from polyaxon_tpu_torch.ops import _build, flash

    entry = ctypes.CDLL(str(_build.build("flash_fwd", src_dir))).flash_fwd
    ptxas_report(_build.build_log.get(f"flash_fwd ({src_dir})", ""),
                 "other ")
    entry.restype = ctypes.c_int
    entry.argtypes = flash._FWD_ARGTYPES

    def run(q, k, v, causal, scale):
        args, out, lse = flash._fwd_kernel_args(q, k, v, None, causal, scale)
        err = entry(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{src_dir}: flash_fwd failed: CUDA error "
                               f"{err}")
        return out, lse

    return run


def other_backward(src_dir):
    """``flash_bwd_dq`` / ``flash_bwd_dkv`` of another version of the
    kernel sources (a directory holding its ``flash_bwd.cu`` and headers),
    built here like the port's own; called as ``fn(which, args)`` with the
    C arguments of ``flash._bwd_kernel_args`` (the entries' contract is
    the same)."""
    import ctypes

    from polyaxon_tpu_torch.ops import _build, flash

    lib = ctypes.CDLL(str(_build.build("flash_bwd", src_dir)))
    ptxas_report(_build.build_log.get(f"flash_bwd ({src_dir})", ""),
                 "other ")
    entries = {}
    for which in ("dq", "dkv"):
        entry = getattr(lib, f"flash_bwd_{which}")
        entry.restype = ctypes.c_int
        entry.argtypes = flash._BWD_ARGTYPES
        entries[which] = entry

    def run(which, args):
        err = entries[which](*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{src_dir}: flash_bwd_{which} failed: CUDA "
                               f"error {err}")

    return run


def _turns(theirs, ours) -> list:
    """Device times of two builds in turns: other / this / this / other."""
    return [graph_ms(theirs), graph_ms(ours), graph_ms(ours),
            graph_ms(theirs)]


def _time_forward(label, q, k, v, other=None):
    """Device times at one causal shape: the kernel, the plain version,
    SDPA and the bound; with ``other`` (another build of the kernel) both
    builds in turns, other / this / this / other."""
    from polyaxon_tpu_torch.ops import flash

    scale = q.shape[-1] ** -0.5
    kernel = lambda: flash._flash_forward_kernel(q, k, v, None, True, scale)
    rec = {"eager_ms": eager_ms(kernel), "ms": graph_ms(kernel)}
    rec["plain_ms"] = graph_ms(lambda: flash._flash_forward_reference(
        q, k, v, None, True, scale), calls=2, reps=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=scale)
    rec["library_ms"] = graph_ms(sdpa)
    rec["bound_ms"], rec["bound_by"] = bound(q, k, True, None, None)
    line = (f"[kernel] {label} {list(q.shape)} {str(q.dtype)[6:]} causal, "
            f"device time (CUDA graph): kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, sdpa {rec['library_ms']:.4f} ms, "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}); eager "
            f"call {rec['eager_ms']:.4f} ms; sdpa runs "
            f"{', '.join(device_kernels(sdpa)) or 'not seen'}")
    if other is not None:
        o_ref, _ = flash._flash_forward_reference(q, k, v, None, True, scale)
        err = _max_err(other(q, k, v, True, scale)[0], o_ref)
        if err > TOL[q.dtype][0]:
            raise AssertionError(f"the other kernel disagrees: {err}")
        turns = _turns(lambda: other(q, k, v, True, scale), kernel)
        rec["other_ms"] = [turns[0], turns[3]]
        rec["this_ms"] = [turns[1], turns[2]]
        line += (f"; in turns other / this / this / other: "
                 + " / ".join(f"{t:.4f}" for t in turns) + " ms")
    print(line)
    return rec


def phase_kernel(other_src=None):
    """Kernel vs plain at every listed case; times at the serving and the
    training shape (and, given ``other_src``, another build's times in
    turns with this one's)."""
    from polyaxon_tpu_torch.ops import flash

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    # name, B, Sq, Sk, H, D, dtype, causal, window, mask
    cases = [
        ("main", 2, 1024, 1024, 16, 64, bf16, True, None, None),
        ("non_causal", 2, 512, 512, 8, 64, bf16, False, None, None),
        ("sk_gt_sq_causal", 1, 256, 1024, 8, 64, bf16, True, None, None),
        ("window_remap", 1, 2048, 2048, 4, 64, bf16, True, 256, None),
        ("kv_mask_masked_rows", 2, 256, 256, 4, 64, bf16, True, None,
         "pad"),
        ("f32", 2, 256, 256, 4, 64, f32, True, None, None),
        ("d128", 2, 512, 512, 8, 128, bf16, True, None, None),
        ("f32_d128_raw_window", 1, 256, 512, 4, 128, f32, False, -64,
         None),
        ("f16", 1, 256, 256, 4, 64, f16, True, None, None),
        # The Hopper kernel's edges: one 128-row tile, an odd number of q
        # tiles a head, a negative raw window, fp16 D = 128 with padding.
        ("single_tile", 1, 128, 128, 1, 64, bf16, True, None, None),
        ("sq384_odd_q_tiles", 2, 384, 384, 3, 64, bf16, True, None, None),
        ("raw_window_neg64", 1, 256, 512, 4, 64, bf16, False, -64, None),
        ("f16_d128_kv_mask_masked_rows", 2, 256, 256, 4, 128, f16, True,
         None, "pad"),
        ("train_fused", 8, 1024, 1024, 16, 64, bf16, True, None, None),
    ]
    fused = ("main", "train_fused")  # the model's layout
    results, shapes = {}, {}
    for name, b, sq, sk, h, d, dtype, causal, window, mk in cases:
        q, k, v = _qkv(b, sq, sk, h, d, dtype, gen, fused=name in fused)
        kv_mask = None
        if mk == "pad":
            kv_mask = torch.rand((b, sk), generator=gen,
                                 device="cuda") > 0.3
            kv_mask[0, :128] = False  # causal rows 0..127 of batch 0: empty
        scale = d ** -0.5
        o, lse = flash._flash_forward_kernel(q, k, v, kv_mask, causal,
                                             scale, window)
        o_ref, lse_ref = flash._flash_forward_reference(
            q, k, v, kv_mask, causal, scale, window)
        torch.cuda.synchronize()
        err_o = _max_err(o, o_ref)
        err_l = (lse - lse_ref).abs().max().item()
        tol_o, tol_l = TOL[dtype]
        ok = err_o <= tol_o and err_l <= tol_l and \
            bool(torch.isfinite(o.float()).all())
        if mk == "pad":  # fully masked rows: exact zeros and -1e30
            ok &= bool((lse[0, :, :128] == flash.NEG_INF).all()) and \
                bool((o[0, :128] == 0).all())
        print(f"[kernel] {name}: B={b} Sq={sq} Sk={sk} H={h} D={d} "
              f"{str(dtype)[6:]} causal={causal} window={window} "
              f"mask={mk}: max|dO|={err_o:.3e} (tol {tol_o}) "
              f"max|dLSE|={err_l:.3e} (tol {tol_l}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash kernel disagrees with its plain "
                                 f"version at case {name}")
        results[name] = (err_o, err_l)
        if name in fused:
            shapes[name] = (q, k, v)
        del q, k, v, o, lse, o_ref, lse_ref

    other = other_forward(other_src) if other_src else None
    rec = _time_forward("main", *shapes["main"], other)
    train = _time_forward("training", *shapes["train_fused"], other)
    rec.update({f"{key}_train": val for key, val in train.items()})
    rec.update({"max_abs_err": results["main"][0],
                "max_abs_err_lse": results["main"][1],
                "max_abs_err_train": results["train_fused"][0],
                "max_abs_err_all_cases": max(e[0] for e in results.values())})
    return rec


def _max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def phase_backward(other_src=None):
    """The dq and dkv kernels against their plain version at the training
    path's shape, the forward's case list and the Hopper kernels' tile
    edges, plus an LSE cotangent; times, bounds and PyTorch's SDPA
    backward at the main shape (and, given ``other_src``, another build's
    dq and dkv in turns with this one's).  Both sides take the same (O,
    LSE) from the forward kernel and the same dO.
    Tolerance on each of dQ, dK, dV: float32 1e-4 (only summation order
    differs); bf16 / fp16 2e-2 / 1e-2 of the largest |grad| (dS and P
    are rounded to the input type from f32 values that differ in their
    last bits, and the card sums in another order)."""
    from polyaxon_tpu_torch.ops import flash

    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    rel = {bf16: 2e-2, f16: 1e-2}
    # name, B, Sq, Sk, H, D, dtype, causal, window, extra: "pad" masks keys
    # (rows 0..127 of batch 0 wholly), "dlse" adds an LSE cotangent,
    # "fused" takes q/k/v as views of one projection (the model's layout)
    cases = [
        ("main_train", 8, 1024, 1024, 16, 64, bf16, True, None, "fused"),
        ("non_causal", 2, 512, 512, 8, 64, bf16, False, None, None),
        ("sk_gt_sq_causal", 1, 256, 1024, 8, 64, bf16, True, None, None),
        ("window_remap", 1, 2048, 2048, 4, 64, bf16, True, 256, None),
        ("kv_mask_masked_rows", 2, 256, 256, 4, 64, bf16, True, None,
         "pad"),
        ("f32", 2, 256, 256, 4, 64, f32, True, None, None),
        ("d128", 2, 512, 512, 8, 128, bf16, True, None, None),
        ("f32_d128_raw_window", 1, 256, 512, 4, 128, f32, False, -64,
         None),
        ("f16", 1, 256, 256, 4, 64, f16, True, None, None),
        ("lse_cotangent", 2, 256, 256, 4, 64, bf16, True, None, "dlse"),
        # The Hopper kernels' edges: one 128-row tile, an odd number of
        # 128-row tiles, a negative raw window, fp16 D = 128 with padding
        # and fully masked rows, Sk > Sq and Sq > Sk under causality at
        # D = 128 (64-row streamed tiles), the fused layout at D = 128.
        ("single_tile", 1, 128, 128, 1, 64, bf16, True, None, None),
        ("sq384_odd_q_tiles", 2, 384, 384, 3, 64, bf16, True, None, None),
        ("raw_window_neg64", 1, 256, 512, 4, 64, bf16, False, -64, None),
        ("f16_d128_kv_mask_masked_rows", 2, 256, 256, 4, 128, f16, True,
         None, "pad"),
        ("sk_gt_sq_causal_d128", 1, 256, 1024, 8, 128, bf16, True, None,
         None),
        ("sq_gt_sk_causal_d128", 1, 512, 256, 4, 128, bf16, True, None,
         None),
        ("fused_d128", 2, 512, 512, 8, 128, bf16, True, None, "fused"),
    ]
    worst = {"dq": 0.0, "dkv": 0.0}
    for name, b, sq, sk, h, d, dtype, causal, window, extra in cases:
        q, k, v = _qkv(b, sq, sk, h, d, dtype, gen, fused=extra == "fused")
        kv_mask = None
        if extra == "pad":
            kv_mask = torch.rand((b, sk), generator=gen,
                                 device="cuda") > 0.3
            kv_mask[0, :128] = False  # causal rows 0..127 of batch 0: empty
        scale = d ** -0.5
        o, lse = flash._flash_forward_kernel(q, k, v, kv_mask, causal,
                                             scale, window)
        do = torch.randn(o.shape, generator=gen, device="cuda").to(dtype)
        dlse = None
        if extra == "dlse":
            dlse = torch.randn((b, h, sq), generator=gen, device="cuda")
        got = flash._flash_backward_kernel(q, k, v, kv_mask, o, lse, do,
                                           causal, scale, window, dlse)
        want = flash._flash_backward_reference(q, k, v, kv_mask, o, lse,
                                               do, causal, scale, window,
                                               dlse)
        torch.cuda.synchronize()
        errs, tols, ok = [], [], True
        for g, w in zip(got, want):
            tol = 1e-4 if dtype == f32 else \
                rel[dtype] * w.float().abs().max().item()
            err = _max_err(g, w)
            ok &= err <= tol and bool(torch.isfinite(g.float()).all())
            errs.append(err)
            tols.append(tol)
        if extra == "pad":
            gone = ~kv_mask[:, :, None, None]
            ok &= bool((got[0][0, :128] == 0).all()) and bool(
                (got[1].masked_select(gone) == 0).all()) and bool(
                (got[2].masked_select(gone) == 0).all())
        print(f"[backward] {name}: B={b} Sq={sq} Sk={sk} H={h} D={d} "
              f"{str(dtype)[6:]} causal={causal} window={window} "
              f"extra={extra}: max|d dQ|={errs[0]:.3e} (tol {tols[0]:.2e}) "
              f"max|d dK|={errs[1]:.3e} (tol {tols[1]:.2e}) "
              f"max|d dV|={errs[2]:.3e} (tol {tols[2]:.2e}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash backward kernels disagree with "
                                 f"their plain version at case {name}")
        worst["dq"] = max(worst["dq"], errs[0])
        worst["dkv"] = max(worst["dkv"], errs[1], errs[2])
        if name == "main_train":
            main = (q, k, v, o, lse, do, scale, errs)
        del q, k, v, o, lse, do, got, want

    q, k, v, o, lse, do, scale, errs = main
    args, _ = flash._bwd_kernel_args(q, k, v, None, o, lse, do, True, scale)
    plain_args = (q, k, v, None, o, lse, do, True, scale)
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=scale)

    # SDPA's backward: forward + backward captured together (autograd
    # runs the backward on its forward's stream, which must be the
    # capturing one), less the forward alone.
    t_lib = graph_ms(lambda: torch.autograd.grad(
        sdpa(), (qt, kt, vt), dot)) - graph_ms(sdpa)
    other = other_backward(other_src) if other_src else None
    if other is not None:  # the other build's outputs, held as this one's
        other_args, theirs = flash._bwd_kernel_args(q, k, v, None, o, lse, do,
                                                    True, scale)
        for which in ("dq", "dkv"):
            flash._launch_bwd(which, args)
            other(which, other_args)
        torch.cuda.synchronize()
        for name, g, w in zip(("dQ", "dK", "dV"), theirs, args.keep[-3:]):
            err = _max_err(g, w)
            if err > rel[bf16] * w.float().abs().max().item():
                raise AssertionError(f"the other build's {name} disagrees: "
                                     f"{err}")
    recs = {}
    for which, plain, q_like, kv_like, fpp, err in (
            ("dq", flash._bwd_dq_reference, 3, 2, 6, errs[0]),
            ("dkv", flash._bwd_dkv_reference, 2, 4, 8, max(errs[1:]))):
        kernel = lambda: flash._launch_bwd(which, args)
        t_kernel = graph_ms(kernel)
        t_eager = eager_ms(kernel)
        t_plain = graph_ms(lambda: plain(*plain_args), calls=2, reps=5)
        t_bound, bound_by = bound(q, k, True, None, None, q_like=q_like,
                                  kv_like=kv_like, rows=2,
                                  flop_per_pair=fpp)
        rec = {"max_abs_err": err, "max_abs_err_all_cases": worst[which],
               "ms": t_kernel, "plain_ms": t_plain, "library_ms": t_lib,
               "bound_ms": t_bound, "bound_by": bound_by,
               "eager_ms": t_eager}
        line = (f"[backward] {which} at [8,1024,16,64] bf16 causal, device "
                f"time (CUDA graph): kernel {t_kernel:.4f} ms, plain "
                f"{t_plain:.4f} ms, bound {t_bound:.4f} ms ({bound_by}); "
                f"eager call {t_eager:.4f} ms; sdpa backward (dq+dk+dv) "
                f"{t_lib:.4f} ms")
        if other is not None:
            turns = _turns(lambda: other(which, other_args), kernel)
            rec["other_ms"] = [turns[0], turns[3]]
            rec["this_ms"] = [turns[1], turns[2]]
            line += (f"; in turns other / this / this / other: "
                     + " / ".join(f"{t:.4f}" for t in turns) + " ms")
        print(line)
        recs[which] = rec
    return recs


def forward_vs_plain(model, tokens):
    """The full forward (flash route) and the same model's plain-attention
    decode path (the cache's causal mask routes every layer off flash):
    (flash logits, max|d|, max|logit|, argmax agreement)."""
    from polyaxon_tpu_torch.models.generate import init_cache

    logits = model(tokens)
    ref = model(tokens, decode=True, decode_position=0,
                cache=init_cache(model, tokens.shape[0]))
    diff = (logits - ref).abs().max().item()
    scale = ref.abs().max().item()
    agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    return logits, diff, scale, agree


def phase_forward(model, model_f32):
    """entry()'s full forward on GPT-2 medium; returns flash launches.

    Held against the plain-attention path in bf16 (max|d| within 5% of
    max|logit|: 24 layers of bf16 rounding; argmax agreement >= 0.9:
    bf16 logits lie on a grid of 1/32 near 5, so near-ties flip) and in
    float32 (1e-3 of max|logit|, agreement >= 0.999: only summation
    order differs)."""
    from polyaxon_tpu_torch.ops import flash

    cfg = model.cfg
    tokens = torch.as_tensor(
        np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 1024)),
        device="cuda")
    with torch.no_grad():
        flash.launch_count = 0
        logits = model(tokens)
        torch.cuda.synchronize()
        launches = flash.launch_count
        if launches != cfg.num_layers:
            raise AssertionError(f"forward made {launches} flash launches;"
                                 f" expected {cfg.num_layers}")
        if tuple(logits.shape) != (2, 1024, cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"bad logits {tuple(logits.shape)}")
        del logits
        for m, rel, min_agree in ((model, 0.05, 0.9),
                                  (model_f32, 1e-3, 0.999)):
            logits, diff, scale, agree = forward_vs_plain(m, tokens)
            ok = bool(torch.isfinite(logits).all()) and \
                diff <= rel * scale and agree >= min_agree
            print(f"[forward] {str(m.cfg.dtype)[6:]}: flash vs plain-"
                  f"attention path: max|d|={diff:.6f} (tol {rel} x "
                  f"max|logit| {scale:.4f}), argmax agreement "
                  f"{agree:.4f} (min {min_agree}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("flash forward disagrees with the "
                                     "plain-attention forward")
            del logits
        t = eager_ms(lambda: model(tokens), calls=5, reps=3)
        print(f"[forward] gpt2-medium [2,1024] bf16: {t:.3f} ms "
              f"({2 * 1024 / t * 1e3:.0f} tok/s), flash launches "
              f"{launches}")
        device_breakdown(lambda: model(tokens), t, "forward")
    return launches


def phase_serving(model, model_f32):
    """Greedy serving on GPT-2 medium.  bf16 (the main path): tok/s, and
    generate == prefill + generate_continue (the same program).  The
    one-shot vs chunked-prefill equality is held in float32 at the same
    width: in bf16 the two prefills round apart (other GEMM shapes) and
    bf16 logits tie at the argmax, so it is reported there, not held."""
    from polyaxon_tpu_torch.cli.main import run_generate
    from polyaxon_tpu_torch.models import generate as G
    from polyaxon_tpu_torch.ops import flash

    cfg = model.cfg
    rows = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 128)).tolist()
    for m in (model, model_f32):
        name = str(m.cfg.dtype)[6:]
        run_generate(m, "gpt2-medium", rows, max_new_tokens=2,
                     prefill_chunk=32)  # warm-up: cuBLAS picks its kernels
        flash.launch_count = 0
        one = run_generate(m, "gpt2-medium", rows, max_new_tokens=32)
        chunked = run_generate(m, "gpt2-medium", rows, max_new_tokens=32,
                               prefill_chunk=32)
        launches = flash.launch_count
        toks = np.asarray(one["tokens"])
        if toks.shape != (2, 160) or toks.min() < 0 or \
                toks.max() >= cfg.vocab_size:
            raise AssertionError(f"bad generate output {toks.shape}")
        with torch.no_grad():
            logits, cache = G.prefill(m, torch.tensor(rows, device="cuda"))
            new = G.generate_continue(m, cache, logits, 128,
                                      max_new_tokens=32)
        if new.cpu().tolist() != one["new_tokens"]:
            raise AssertionError(f"{name}: generate != prefill + "
                                 f"generate_continue")
        same = int((toks == np.asarray(chunked["tokens"])).sum()) - 2 * 128
        print(f"[serving] gpt2-medium {name} greedy, 2 x 128 prompt + 32 "
              f"new: {one['tok_per_sec']} tok/s one-shot ({one['wall_s']}"
              f" s), {chunked['tok_per_sec']} tok/s chunked; chunked "
              f"agrees on {same}/64 new tokens; generate == prefill + "
              f"continue; flash launches {launches} (decode masks take "
              f"the plain path)")
        if m is model_f32 and one["tokens"] != chunked["tokens"]:
            raise AssertionError("one-shot and chunked prefill disagree")
        if m is model:
            device_breakdown(lambda: run_generate(
                m, "gpt2-medium", rows, max_new_tokens=32),
                one["wall_s"] * 1e3, "serving", host=False)


def _first_gap(model, prompt, solo_new, got_new) -> tuple:
    """(index, top-2 gap) of the solo float32 logits at the first new
    token where ``got_new`` leaves the solo tokens ``solo_new``."""
    from polyaxon_tpu_torch.models import generate as G

    k = next(i for i, (a, b) in enumerate(zip(solo_new, got_new))
             if a != b)
    prefix = torch.tensor([list(prompt) + list(solo_new[:k])],
                          device="cuda")
    with torch.no_grad():
        logits, _ = G.prefill(model, prefix)
    top = torch.topk(logits[0].float(), 2).values
    return k, float(top[0] - top[1])


def _load_clients(base, bodies, n_clients):
    """POST every body to /generate from ``n_clients`` threads; returns
    (wall s, [(latency s, response)] in body order)."""
    import queue
    import threading
    import urllib.request

    todo = queue.Queue()
    for i, body in enumerate(bodies):
        todo.put((i, json.dumps(body).encode()))
    out = [None] * len(bodies)
    errors = []

    def client():
        while True:
            try:
                i, data = todo.get_nowait()
            except queue.Empty:
                return
            req = urllib.request.Request(
                base + "/generate", data=data,
                headers={"Content-Type": "application/json"})
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(req, timeout=600) as r:
                    resp = json.loads(r.read())
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(f"request {i}: {type(e).__name__}: {e}")
                continue
            out[i] = (time.perf_counter() - t0, resp)

    threads = [threading.Thread(target=client) for _ in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"{len(errors)} requests failed: {errors[:3]}")
    return wall, out


def _sampled_gap(model, prompt, solo_new, got_new, seed, spec) -> tuple:
    """(index, top-2 gap) of the solo float32 shaped logits + gumbel
    noise of the draw at the first new token where ``got_new`` leaves
    the solo sampled tokens ``solo_new`` (the sampled tie rule)."""
    from polyaxon_tpu_torch import prng
    from polyaxon_tpu_torch.models import generate as G

    k = next(i for i, (a, b) in enumerate(zip(solo_new, got_new))
             if a != b)
    prefix = torch.tensor([list(prompt) + list(solo_new[:k])],
                          device="cuda")
    with torch.no_grad():
        logits, _ = G.prefill(model, prefix)
        shaped, _ = G._shape_logits_positional(
            logits[0], spec["temperature"], spec["top_k"], spec["top_p"])
        key = prng.fold_in(G.sample_stream_keys(seed, 1, device="cuda")[0],
                           k)
        z = shaped + prng.gumbel(key, shaped.shape)
    top = torch.topk(z, 2).values
    return k, float(top[0] - top[1])


# The sampled half of every mixed load: T 0.8, top-k 50, top-p 0.95,
# seed = the request's index.
SAMPLED = {"temperature": 0.8, "top_k": 50, "top_p": 0.95}


def _mixed(bodies):
    """The same requests with every odd one sampled (``SAMPLED``)."""
    return [dict(b, **SAMPLED, seed=i) if i % 2 else dict(b)
            for i, b in enumerate(bodies)]


def _concurrent(ms, bodies):
    """``ms.generate`` for every body from its own thread; (responses,
    seconds)."""
    import threading

    got = [None] * len(bodies)

    def go(i):
        got[i] = ms.generate(bodies[i])

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(bodies))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return got, time.perf_counter() - t0


def _f32_schedule(model_f32):
    """float32, 4 slots, prefill chunk 64: 12 concurrent requests
    (prompts of 16-200 tokens from seed 0, 24 new tokens, every odd one
    sampled) through ``ModelServer.generate`` on the fixed-lane pool
    equal solo ``generate`` / ``generate_positional`` under the tie
    rule (a first difference whose solo float32 top-2 gap, of the
    logits or of shaped logits + noise, is below 1e-4, printed); the
    paged pool, eager and lazy, gives exactly the fixed lane's
    tokens."""
    from polyaxon_tpu_torch.models import generate as G
    from polyaxon_tpu_torch.serving import ModelServer

    cfg = model_f32.cfg
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in rng.randint(16, 201, 12)]
    bodies = _mixed([{"prompt": p, "max_new_tokens": 24} for p in prompts])
    with torch.no_grad():
        solo = []
        for i, p in enumerate(prompts):
            if i % 2:
                out = G.generate_positional(model_f32, [p],
                                            max_new_tokens=24, seed=i,
                                            **SAMPLED)
            else:
                out = G.generate(model_f32, [p], max_new_tokens=24)
            solo.append(out[0, len(p):].tolist())
    runs = {}
    for label, kw in (("fixed", {}),
                      ("paged", {"kv_paged": True}),
                      ("lazy", {"kv_paged": True, "kv_lazy": True})):
        ms = ModelServer(model_f32, model_name="gpt2-medium", n_slots=4,
                         prefill_chunk=64, decode_window=8, **kw)
        try:
            got, secs = _concurrent(ms, bodies)
            stats = ms.engine.stats()
        finally:
            ms.close()
        runs[label] = [g["new_tokens"][0] for g in got]
        print(f"[http] float32 {label}: 12 concurrent requests (6 "
              f"sampled) in {secs:.2f} s; admitted "
              f"{stats['admitted_total']} ({stats['admitted_sampled_total']}"
              f" sampled), decode steps {stats['decode_steps_total']} in "
              f"{stats['decode_dispatches_total']} dispatches, graph "
              f"captures {stats['compile_cache_misses']}"
              + (f", lazy growths {stats['kv_pages_lazy_growths_total']}, "
                 f"exhaustion preemptions "
                 f"{stats['kv_preempt_exhaustion_total']}"
                 if "kv_pages" in stats else ""))
    ties = 0
    for i, (p, want) in enumerate(zip(prompts, solo)):
        new = runs["fixed"][i]
        if new == want:
            continue
        if i % 2:
            k, gap = _sampled_gap(model_f32, p, want, new, i, SAMPLED)
        else:
            k, gap = _first_gap(model_f32, p, want, new)
        kind = "sampled" if i % 2 else "greedy"
        print(f"[http] tie rule used: request {i} ({kind}, prompt "
              f"{len(p)}) leaves solo at new token {k}, solo "
              f"float32 top-2 gap {gap:.3e} (limit 1e-4)")
        if gap >= 1e-4:
            raise AssertionError(f"float32 engine tokens != solo for "
                                 f"request {i} at new token {k}")
        ties += 1
    for label in ("paged", "lazy"):
        bad = [i for i in range(12) if runs[label][i] != runs["fixed"][i]]
        if bad:
            raise AssertionError(f"float32 {label} pool tokens != fixed "
                                 f"lane for requests {bad}")
    print(f"[http] float32 engine (6 greedy + 6 sampled, T 0.8 top-k 50 "
          f"top-p 0.95, seed = index) equals solo generate / "
          f"generate_positional ({12 - ties} exactly, {ties} by the tie "
          f"rule); paged (eager and lazy) == fixed lane, all 12 exactly")


def _replay_ms(pool, key, restore) -> float:
    """Median device time of one graph replay of ``key`` (CUDA events,
    5 replays, the state restored before each)."""
    start, end = _events()
    times = []
    for _ in range(5):
        restore()
        pool._load_state()
        start.record()
        pool._graphs[key].replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _graph_vs_eager(model):
    """bf16, 8 slots filled (prompts of 64-512 tokens, every odd slot
    sampled): the W = 8 window as a CUDA-graph replay and eagerly from
    the same state give identical tokens and bitwise-equal KV, for the
    fixed-lane greedy and sampled bodies and the paged sampled body
    (pool pages); then the device time of each replay.  Returns the ms
    of one decode step per program."""
    from polyaxon_tpu_torch import prng
    from polyaxon_tpu_torch.models import generate as G
    from polyaxon_tpu_torch.serving.paged import PagedSlotKVManager
    from polyaxon_tpu_torch.serving.slots import SlotKVManager

    cfg = model.cfg
    lengths = np.random.RandomState(2).randint(64, 513, 8)
    step_ms = {}
    for label, paged, sampled in (("greedy", False, False),
                                  ("sampled", False, True),
                                  ("paged sampled", True, True)):
        pool = PagedSlotKVManager(model, 8, page_tokens=64,
                                  max_position=cfg.max_position,
                                  decode_window=8) if paged \
            else SlotKVManager(model, 8, max_window=8)
        for s, n in enumerate(lengths):
            toks = torch.as_tensor(np.random.RandomState(10 + s).randint(
                0, cfg.vocab_size, (1, n)), device="cuda")
            logits, cache = G.prefill(model, toks)
            kw = dict(SAMPLED) if sampled and s % 2 else {}
            key = prng.fold_in(prng.PRNGKey(s, device="cuda"), 0)
            if kw:
                first = int(G._sample_positional_row(
                    logits[0], key, 0, kw["temperature"], kw["top_k"],
                    kw["top_p"]))
            else:
                first = int(torch.argmax(logits[0]))
            pool.acquire()
            extra = {"total_tokens": int(n) + 64} if paged else {}
            pool.insert(s, cache, first, int(n),
                        base_key=key.cpu().numpy() if kw else None,
                        temperature=kw.get("temperature", 0.0),
                        top_k=kw.get("top_k", 0),
                        top_p=kw.get("top_p", 0.0), **extra)
            del cache
        host = {k: getattr(pool, k).copy()
                for k in ("tokens", "positions", "next_index")}
        kv = (pool._k.clone(), pool._v.clone())

        def restore():
            for k, v in host.items():
                setattr(pool, k, v.copy())
            pool._k.copy_(kv[0])
            pool._v.copy_(kv[1])

        eager = pool.step(8, sampled, graph=False)
        k_eager, v_eager = pool._k.clone(), pool._v.clone()
        restore()
        replay = pool.step(8, sampled)
        live = slice(0, pool.n_pages) if paged else slice(None)
        same_toks = bool((replay == eager).all())
        same_kv = bool(torch.equal(pool._k[:, live], k_eager[:, live])) \
            and bool(torch.equal(pool._v[:, live], v_eager[:, live]))
        print(f"[http] bf16 {label} W=8 window over 8 full slots: graph "
              f"replay vs eager tokens "
              f"{'identical' if same_toks else 'DIFFER'}, "
              f"{'pool pages' if paged else 'caches'} "
              f"{'bitwise equal' if same_kv else 'DIFFER'}")
        if not (same_toks and same_kv):
            raise AssertionError(f"{label}: CUDA-graph window != eager")
        # The paged pool's greedy body too, on the same state: the
        # layout's cost apart from the sampler's.
        for body in ((False, True) if paged else (sampled,)):
            restore()
            pool.step(8, body)
            key = pool._step_key(8, body)
            ms = _replay_ms(pool, key, restore)
            name = f"paged {'sampled' if body else 'greedy'}" if paged \
                else label
            step_ms[name] = ms / 8
            print(f"[http] bf16 {name} W=8 window, 8 slots at positions "
                  f"{min(lengths)}-{max(lengths) + 7}"
                  f"{f', pad class {key[2]}' if paged else ''}: {ms:.3f} "
                  f"ms a replay ({ms / 8:.3f} ms a decode step, "
                  f"{8 * 8 / ms * 1e3:.0f} tok/s at full occupancy)")
        del pool, kv, k_eager, v_eager
        torch.cuda.empty_cache()
    return step_ms


def _warm_every_key(ms, sampled_too: bool) -> None:
    """Capture every graph a load can reach, with all slots idle: each
    window (1, 2, 4, 8), the greedy body (and the sampled one), and on a
    paged pool every pad class (forced through an idle slot's reserved
    width, restored after)."""
    slots = ms.engine.slots
    bodies = (False, True) if sampled_too else (False,)
    classes = [None]
    if slots.paged:
        classes = sorted({slots._pad_class(n) for n in range(
            slots._n_dirty_cap, slots.max_pages_slot + 1)})
    with ms._lock:
        for P in classes:
            if P is not None:
                slots._slot_need[0] = P
            for w in (1, 2, 4, 8):
                for sampled in bodies:
                    slots.step(w, sampled)
        if slots.paged:
            slots._slot_need[0] = 0
    torch.cuda.synchronize()


def _http_load(model, label, bodies, *, sampled_too=False,
               warm_requests=8, **server_kw):
    """bf16 over HTTP (``make_server`` on port 0), 8 slots, prefill chunk
    256, window 8: a warm-up of ``warm_requests`` requests (8 warm the
    process's GEMM and prefill shapes; 1 allocates a later server's
    pool) and every graph key, then all
    ``bodies`` from 16 client threads: tok/s, latency p50/p99, TTFT p50,
    decode steps, mean window, graph captures (in all, and in the run:
    0 allowed), replays, device busy and idle share (over the first 16
    requests, run again plain and under the profiler), flash launches,
    page stats on a paged pool, the /metrics phase lines.  Returns the
    record and (server, ModelServer, base URL) for the caller to
    close."""
    import threading
    import urllib.request

    from polyaxon_tpu_torch.serving import ModelServer, make_server

    cfg = model.cfg
    ms = ModelServer(model, model_name="gpt2-medium", n_slots=8,
                     prefill_chunk=256, decode_window=8, **server_kw)
    srv = make_server("127.0.0.1", 0, ms)
    server_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    server_thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    _load_clients(base, bodies[:warm_requests], warm_requests)
    _warm_every_key(ms, sampled_too)
    reserved_gb = torch.cuda.memory_reserved() / 1e9
    warm = ms.recompile.snapshot()
    steps0 = ms.engine.decode_steps_total
    disp0 = ms.engine.decode_dispatches_total
    peak = {"resident": 0, "running": True}

    def watch_pages():
        # The page pool's peak occupancy during the run (10 ms polls).
        while peak["running"]:
            peak["resident"] = max(peak["resident"], sum(
                ms.engine.slots.slot_page_counts().values()))
            time.sleep(0.01)

    watcher = threading.Thread(target=watch_pages, daemon=True)
    if ms.engine.paged:
        watcher.start()
    _zero_counts()
    wall, results = _load_clients(base, bodies, 16)
    counts = _counts()
    peak["running"] = False
    if ms.engine.paged:
        watcher.join()
    after = ms.recompile.snapshot()
    steps = ms.engine.decode_steps_total - steps0
    dispatches = ms.engine.decode_dispatches_total - disp0
    lat = sorted(r[0] for r in results)
    ttft = sorted(r[1]["ttft_ms"] for r in results)
    ntok = sum(len(r[1]["new_tokens"][0]) for r in results)
    bad = [i for i, (_, r) in enumerate(results)
           if len(r["new_tokens"][0]) != bodies[i]["max_new_tokens"]
           or min(r["new_tokens"][0]) < 0
           or max(r["new_tokens"][0]) >= cfg.vocab_size]
    if bad:
        raise AssertionError(f"{label}: malformed responses {bad[:5]}")
    captures = after["compile_cache_misses"] - warm["compile_cache_misses"]
    replays = after["compile_cache_hits"] - warm["compile_cache_hits"]
    n_sampled = sum(1 for b in bodies if b.get("temperature"))
    rec = {"load": label, "requests": len(results),
           "sampled_requests": n_sampled, "new_tokens": ntok,
           "wall_s": wall, "tok_per_s": ntok / wall,
           "latency_p50_s": lat[len(lat) // 2],
           "latency_p99_s": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
           "ttft_p50_ms": ttft[len(ttft) // 2],
           "decode_steps": steps, "dispatches": dispatches,
           "mean_window": steps / max(1, dispatches),
           "captures_total": after["compile_cache_misses"],
           "captures_in_run": captures, "replays_in_run": replays,
           "memory_reserved_gb_after_captures": reserved_gb,
           "flash_launches": counts}
    if ms.engine.paged:
        rec["pages"] = {**ms.engine.slots.page_stats(),
                        "kv_pages_resident_peak": peak["resident"]}
    print(f"[http] {label}: 32 POST /generate from 16 clients ({n_sampled}"
          f" sampled; prompts 64-512, 64 new tokens), 8 slots, prefill "
          f"chunk 256, window 8: {ntok} tokens in {wall:.3f} s = "
          f"{rec['tok_per_s']:.1f} tok/s; latency p50 "
          f"{rec['latency_p50_s']:.3f} s p99 {rec['latency_p99_s']:.3f} s;"
          f" TTFT p50 {rec['ttft_p50_ms']:.1f} ms; decode steps {steps} "
          f"in {dispatches} dispatches (mean window "
          f"{rec['mean_window']:.2f}); graph captures "
          f"{rec['captures_total']} in all, {captures} in the run, "
          f"replays {replays} (memory reserved after the captures "
          f"{reserved_gb:.2f} GB); flash launches {counts}"
          + (f"; pages {rec['pages']}" if "pages" in rec else ""))
    slots = ms.engine.slots
    bound = 4 * (2 if sampled_too else 1) * (
        len({slots._pad_class(n) for n in range(
            slots._n_dirty_cap, slots.max_pages_slot + 1)})
        if slots.paged else 1)
    if captures or rec["captures_total"] > bound:
        raise AssertionError(f"{label}: {rec['captures_total']} graph "
                             f"captures in all (at most {bound}), "
                             f"{captures} after warm-up")
    # Device busy and idle share over a rerun of the first 16 requests
    # (one a client), timed once plain and once under the profiler: a
    # sampled load launches about 460,000 kernels in 32 requests, and
    # the profiler takes about a minute to collect that many.
    sub = bodies[:16]
    t0 = time.perf_counter()
    _load_clients(base, sub, 16)
    rec["profiled_wall_s"] = time.perf_counter() - t0
    rec["busy_ms"] = device_breakdown(
        lambda: _load_clients(base, sub, 16),
        rec["profiled_wall_s"] * 1e3, "http", host=False)
    if rec["busy_ms"] is not None:
        rec["idle_share"] = max(
            0.0, 1 - rec["busy_ms"] / (rec["profiled_wall_s"] * 1e3))
    print(f"[http] record {json.dumps(rec)}")
    with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
        metrics = r.read().decode()
    for line in metrics.splitlines():
        if re.match(r"ptpu_serving_(queue|prefill|decode|kv_pages|"
                    r"admitted_sampled|completed_sampled)\S*"
                    r"(_sum|_count|_total)? ", line) and \
                "_bucket" not in line:
            print(f"[http] /metrics {line}")
    return rec, (srv, ms, base)


def phase_http_serving(model, model_f32):
    """The continuous-batching server on GPT-2 medium, through
    ``ModelServer`` -> ``DecodeEngine`` -> ``SlotKVManager`` /
    ``PagedSlotKVManager``.

    1. float32 exactness (``_f32_schedule``): 12 concurrent requests,
       half sampled, equal solo decoding; the paged pool (eager and
       lazy) gives the fixed lane's tokens exactly;
    2. bf16 CUDA-graph windows equal eager ones bitwise, for the greedy,
       sampled and paged sampled programs, and their device times
       (``_graph_vs_eager``);
    3. three loads over HTTP (``_http_load``), the same 32 requests
       (prompts 64-512 from seed 0, 64 new tokens): all greedy on the
       fixed-lane pool, then every odd one sampled on the fixed-lane
       pool and on the paged pool (64-token pages, default size); after
       the last, POST /drain turns /healthz readiness off.
    Returns the decode-step ms per program and the three records (each
    with its flash launch counts: 0, decode and chunked prefill take the
    plain path)."""
    import urllib.error
    import urllib.request

    t0 = time.perf_counter()
    _f32_schedule(model_f32)
    print(f"[time] http: float32 schedules {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    step_ms = _graph_vs_eager(model)
    print(f"[time] http: graph vs eager windows "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(0)
    bodies = [{"prompt": rng.randint(0, model.cfg.vocab_size, n).tolist(),
               "max_new_tokens": 64}
              for n in rng.randint(64, 513, 32)]
    recs = {}
    for label, load, kw in (
            ("greedy fixed-lane", bodies, {}),
            ("mixed fixed-lane", _mixed(bodies),
             {"sampled_too": True, "warm_requests": 1}),
            ("mixed paged", _mixed(bodies),
             {"sampled_too": True, "warm_requests": 1,
              "kv_paged": True})):
        t0 = time.perf_counter()
        rec, (srv, ms, base) = _http_load(model, label, load, **kw)
        print(f"[time] http: {label} load {time.perf_counter() - t0:.1f} s")
        try:
            if label == "mixed paged":
                drain = urllib.request.Request(base + "/drain", data=b"{}")
                with urllib.request.urlopen(drain, timeout=60) as r:
                    drained = json.loads(r.read())
                try:
                    urllib.request.urlopen(base + "/healthz", timeout=60)
                    raise AssertionError("/healthz still ready after "
                                         "/drain")
                except urllib.error.HTTPError as e:
                    health = json.loads(e.read())
                    if e.code != 503 or health["reason"] != "draining":
                        raise AssertionError(f"/healthz after /drain: "
                                             f"{e.code} {health}")
                print(f"[http] POST /drain -> {drained}; /healthz 503 "
                      f"{health['status']} ({health['reason']})")
        finally:
            srv.shutdown()
            srv.server_close()
            ms.close()
        recs[label] = rec
        torch.cuda.empty_cache()
    return step_ms, recs


def phase_prng():
    """The threefry keys, fold_in, split and random bits on the card
    equal the same calls on the CPU, bitwise (the CPU's are held
    against jax.random by the tests)."""
    from polyaxon_tpu_torch import prng

    checks = 0
    for seed in (0, 7, 2 ** 31 - 1):
        cpu, dev = prng.PRNGKey(seed), prng.PRNGKey(seed, device="cuda")
        rows = torch.arange(8)
        pairs = [
            (prng.fold_in(dev, 12345), prng.fold_in(cpu, 12345)),
            (prng.split(dev, 4), prng.split(cpu, 4)),
            (prng.fold_in(dev.expand(8, 2), rows.cuda()),
             prng.fold_in(cpu.expand(8, 2), rows)),
            (prng.random_bits(dev, (8, 50257)),
             prng.random_bits(cpu, (8, 50257))),
            (prng.uniform(dev, (8, 50257)), prng.uniform(cpu, (8, 50257))),
        ]
        for got, want in pairs:
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"prng on the card != CPU (seed "
                                     f"{seed})")
            checks += 1
    print(f"[prng] keys, fold_in, split, random bits and uniforms on the "
          f"card equal the CPU bitwise ({checks} checks, 3 seeds, "
          f"[8, 50257] draws)")


def _counts():
    from polyaxon_tpu_torch.ops import flash

    return {"flash_fwd": flash.launch_count,
            "flash_bwd_dq": flash.dq_launch_count,
            "flash_bwd_dkv": flash.dkv_launch_count}


def _zero_counts():
    from polyaxon_tpu_torch.ops import flash

    flash.launch_count = flash.dq_launch_count = flash.dkv_launch_count = 0


def _check_per_step(counts, steps: int, layers: int, where: str):
    want = {name: steps * layers for name in counts}
    if counts != want:
        raise AssertionError(f"{where}: flash launches {counts}, expected "
                             f"{want} ({layers} of each a step)")


def phase_train_entry(steps: int = 3):
    """``python -m polyaxon_tpu_torch.train --model gpt2-medium`` as a
    user runs it (in-process, its checkpoints in a temporary home): the
    flash launch counts of the run, 24 of each kernel a step, and a
    finite loss on every logged step; then the checkpoint it wrote is
    served (``phase_checkpoint``) before the home is removed."""
    import contextlib
    import io
    import re

    from polyaxon_tpu_torch import checkpoint, train

    out = io.StringIO()
    live = {}
    real_save = checkpoint.CheckpointManager.save

    def save(self, step, state):
        # The trained model as train.main holds it, for the comparison.
        live["model"], live["dir"] = state["params"], self.directory
        return real_save(self, step, state)

    with tempfile.TemporaryDirectory() as home:
        env = {"POLYAXON_TPU_HOME": home,
               "POLYAXON_TPU_RUN_UUID": "chip-smoke"}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        checkpoint.CheckpointManager.save = save
        try:
            t0 = time.perf_counter()
            _zero_counts()
            with contextlib.redirect_stdout(out):
                rc = train.main(["--model", "gpt2-medium", "--steps",
                                 str(steps), "--log-every", "1",
                                 "--batch-size", "8"])
            torch.cuda.synchronize()
            counts = _counts()
            secs = time.perf_counter() - t0
        finally:
            checkpoint.CheckpointManager.save = real_save
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        for line in out.getvalue().splitlines():
            print(f"[train.main] {line}")
        losses = [float(m) for m in re.findall(
            r"^step \d+/\d+ loss=(\S+)", out.getvalue(), re.M)]
        if rc != 0 or len(losses) != steps or \
                not all(np.isfinite(losses)):
            raise AssertionError(f"train.main: exit {rc}, losses {losses}")
        _check_per_step(counts, steps, 24, "train.main")
        print(f"[train.main] gpt2-medium {steps} steps in {secs:.1f} s "
              f"(model init, data, steps and the final checkpoint); "
              f"flash launches {counts}")
        phase_checkpoint(live["dir"], live["model"].eval())
    return counts


def phase_checkpoint(ckpt_dir, trained):
    """The checkpoint ``train.main`` wrote, served: ``generate
    --checkpoint`` (the CLI, bf16 as served) gives the tokens of the
    in-memory trained model (float32 master weights cast at each use);
    in float32, the CLI's checkpoint loader gives the tokens of a
    float32 model holding the in-memory weights."""
    import contextlib
    import io

    from polyaxon_tpu_torch.cli import main as cli_main
    from polyaxon_tpu_torch.models import generate as G
    from polyaxon_tpu_torch.models.registry import get_model

    rows = np.random.RandomState(3).randint(0, 50257, (2, 32)).tolist()
    prompt = "@" + os.path.join(os.path.dirname(ckpt_dir), "prompt.json")
    with open(prompt[1:], "w") as f:
        json.dump(rows, f)
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_main.cli.main(["generate", "--model", "gpt2-medium",
                           "--checkpoint", ckpt_dir, "--prompt", prompt,
                           "--max-new-tokens", "16"], standalone_mode=False)
    served = json.loads(out.getvalue().strip().splitlines()[-1])
    secs = time.perf_counter() - t0
    with torch.no_grad():
        want = G.generate(trained, rows, max_new_tokens=16).tolist()
    if served["tokens"] != want:
        raise AssertionError("generate --checkpoint != the in-memory "
                             "trained model (bf16)")
    spec = get_model("gpt2-medium")
    f32 = cli_main._build_serving_model("gpt2-medium", 2,
                                        ckpt_dir=ckpt_dir,
                                        dtype=torch.float32)
    ref = spec.make_model(device="cuda", dtype=torch.float32)
    ref.load_state_dict(trained.state_dict())
    ref.eval().requires_grad_(False)
    with torch.no_grad():
        got = G.generate(f32, rows, max_new_tokens=16).tolist()
        want32 = G.generate(ref, rows, max_new_tokens=16).tolist()
    if got != want32:
        raise AssertionError("checkpoint served in float32 != the "
                             "in-memory weights in float32")
    print(f"[checkpoint] {ckpt_dir.split(os.sep)[-1]}/ from train.main "
          f"served by `generate --checkpoint` in {secs:.1f} s (restore, "
          f"cast to bf16, 2 x 32 prompt + 16 new): tokens == the "
          f"in-memory trained model; float32: tokens == the in-memory "
          f"weights ({sum(len(r) - 32 for r in got)} tokens each)")
    del f32, ref
    torch.cuda.empty_cache()


def phase_train_timed(steps: int = 5):
    """GPT-2 medium TrainStep calls on one device batch: launches a step,
    finite loss and gradients, step time, tok/s, MFU against 989 TFLOP/s,
    peak memory, and one step under the profiler."""
    from polyaxon_tpu_torch.models.registry import get_model
    from polyaxon_tpu_torch.parallel import make_train_step
    from polyaxon_tpu_torch.train import make_optimizer

    spec = get_model("gpt2-medium")
    model = spec.init_params(seed=0, device="cuda", train=True)
    step_fn = make_train_step(spec.loss_fn(model),
                              make_optimizer("adamw", 1e-3))
    state = step_fn.init_state(model)
    batch = {"inputs": torch.as_tensor(spec.make_batch(8)["inputs"],
                                       device="cuda")}
    state, metrics = step_fn(state, batch)  # warm-up: cuBLAS picks kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    state, metrics = step_fn(state, batch)
    torch.cuda.synchronize()
    _check_per_step(_counts(), 1, 24, "TrainStep")
    loss = float(metrics["loss"])
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    if not np.isfinite(loss) or bad or \
            not np.isfinite(float(metrics["grad_norm"])):
        raise AssertionError(f"TrainStep: loss {loss}, non-finite grads "
                             f"{bad[:5]}")
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step_fn(state, batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    flops = spec.train_flops(8)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rec = {"step_ms": step_s * 1e3, "tok_per_s": 8 * 1024 / step_s,
           "mfu": flops / step_s / 989e12, "train_flops": flops,
           "peak_memory_gb": peak_gb, "loss": float(metrics["loss"])}
    print(f"[train] gpt2-medium batch 8 x 1024 bf16 (f32 master weights, "
          f"AdamW): {rec['step_ms']:.2f} ms a step ({steps} steps), "
          f"{rec['tok_per_s']:.0f} tok/s, MFU {rec['mfu']:.4f} "
          f"({flops / 1e12:.2f} TFLOP a step, floor "
          f"{flops / 989e12 * 1e3:.2f} ms); peak memory {peak_gb:.2f} GB; "
          f"loss {rec['loss']:.4f}; flash launches a step 24 / 24 / 24")
    rec["busy_ms"] = device_breakdown(lambda: step_fn(state, batch),
                                      rec["step_ms"], "train")
    return rec


def _grads(model, tokens, loss_fn):
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn({"inputs": tokens})
    loss.backward()
    torch.cuda.synchronize()
    return loss.item(), {n: p.grad.detach().clone()
                         for n, p in model.named_parameters()}


def phase_grad_route(layers: int = 4):
    """One step's loss and gradients at GPT-2 medium's width and
    ``layers`` layers, [2, 1024] tokens, through the flash route (the
    forward and backward kernels) and through the plain-attention route
    (the route pinned by turning flash eligibility off): float32 must
    agree within 1e-4 of each tensor's max |grad| (only summation order
    differs) and 1e-5 relative on the loss; the bf16 difference is
    printed, not held."""
    from polyaxon_tpu_torch.models.registry import get_model
    from polyaxon_tpu_torch.ops import attention

    spec = get_model("gpt2-medium")
    tokens = torch.as_tensor(spec.make_batch(2)["inputs"], device="cuda")
    eligible = attention.flash_eligible
    for dtype in (torch.float32, torch.bfloat16):
        model = spec.init_params(seed=0, device="cuda", train=True,
                                 dtype=dtype, num_layers=layers)
        loss_fn = spec.loss_fn(model)
        _zero_counts()
        flash_loss, flash_g = _grads(model, tokens, loss_fn)
        counts = _counts()
        try:
            attention.flash_eligible = lambda *a, **kw: False
            plain_loss, plain_g = _grads(model, tokens, loss_fn)
        finally:
            attention.flash_eligible = eligible
        if counts != {n: layers for n in counts} or \
                any(_counts()[n] != layers for n in counts):
            raise AssertionError(f"route check: flash launches {counts}, "
                                 f"then {_counts()} after the plain route")
        worst, where = 0.0, ""
        for name, g in plain_g.items():
            rel = (flash_g[name] - g).abs().max().item() / max(
                g.abs().max().item(), 1e-30)
            if rel > worst:
                worst, where = rel, name
        finite = all(bool(torch.isfinite(g).all())
                     for g in flash_g.values())
        loss_rel = abs(flash_loss - plain_loss) / abs(plain_loss)
        name = str(dtype)[6:]
        held = dtype == torch.float32
        ok = finite and (not held or (worst <= 1e-4 and loss_rel <= 1e-5))
        print(f"[route] gpt2-medium width, {layers} layers, {name}: flash "
              f"vs plain attention: loss {flash_loss:.6f} vs "
              f"{plain_loss:.6f} (rel {loss_rel:.2e}), max |d grad| / "
              f"max |grad| {worst:.2e} at {where}"
              + (" (tol 1e-4) " if held else " (printed, not held) ")
              + ("ok" if ok else "FAIL"))
        if not ok:
            raise AssertionError("flash-route gradients disagree with the "
                                 "plain-attention route")
        del model, flash_g, plain_g
        torch.cuda.empty_cache()


KERNELS = {
    "flash_fwd": ("polyaxon_tpu_torch/csrc/flash_fwd.cu",
                  "polyaxon_tpu/ops/flash.py:171"),
    "flash_bwd_dq": ("polyaxon_tpu_torch/csrc/flash_bwd.cu",
                     "polyaxon_tpu/ops/flash.py:347"),
    "flash_bwd_dkv": ("polyaxon_tpu_torch/csrc/flash_bwd.cu",
                      "polyaxon_tpu/ops/flash.py:407"),
}


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--compare-fwd", metavar="DIR", default=None,
        help="a directory holding another version of csrc/flash_fwd.cu and "
             "its headers (e.g. the parent commit's): its forward kernel is "
             "built too and timed in turns with this one")
    parser.add_argument(
        "--compare", metavar="DIR", default=None,
        help="the same for all three kernels: DIR also holds another "
             "version of csrc/flash_bwd.cu, whose dq and dkv kernels are "
             "timed in turns with this one's too")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from polyaxon_tpu_torch.models.registry import get_model

    start = time.perf_counter()

    def mark(phase):
        print(f"[time] {phase} done at {time.perf_counter() - start:.1f} s")

    card = card_line()
    print(f"[card] {card}")
    phase_build()
    mark("build")
    recs = {"flash_fwd": phase_kernel(args.compare_fwd or args.compare)}
    mark("forward kernel")
    recs.update({f"flash_bwd_{k}": v
                 for k, v in phase_backward(args.compare).items()})
    mark("backward kernels")
    t0 = time.perf_counter()
    spec = get_model("gpt2-medium")
    model = spec.init_params(seed=0, device="cuda")
    print(f"[model] gpt2-medium random init in "
          f"{time.perf_counter() - t0:.1f} s")
    model_f32 = spec.init_params(seed=0, device="cuda",
                                 dtype=torch.float32)
    forward_launches = phase_forward(model, model_f32)
    mark("forward")
    phase_serving(model, model_f32)
    mark("serving")
    phase_prng()
    mark("prng")
    step_ms, http = phase_http_serving(model, model_f32)
    print(f"[http] decode step ms (bf16, 8 slots, W=8 replay): "
          + ", ".join(f"{k} {v:.3f}" for k, v in step_ms.items()))
    mark("http serving")
    del model, model_f32
    torch.cuda.empty_cache()
    train_counts = phase_train_entry()
    mark("train.main and checkpoint serving")
    phase_train_timed()
    mark("timed training")
    torch.cuda.empty_cache()
    phase_grad_route()
    mark("gradient route check")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        rec = recs[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": train_counts[name],
            "launches_by_path": {
                "forward": forward_launches if name == "flash_fwd" else 0,
                "http_serving": http["greedy fixed-lane"][
                    "flash_launches"][name],
                "http_serving_sampled": http["mixed fixed-lane"][
                    "flash_launches"][name],
                "http_serving_paged": http["mixed paged"][
                    "flash_launches"][name],
                "train_main": train_counts[name]},
            **rec, "kernel_ms": rec["ms"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
