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
5. the continuous-batching server (``ModelServer`` -> ``DecodeEngine``
   -> ``SlotKVManager``): float32 engine tokens equal solo generate,
   the CUDA-graph decode window equals the eager one bitwise, and 32
   HTTP requests from 16 clients (tok/s, latency, TTFT, windows, graph
   captures, device busy share), then POST /drain;
6. the flash-backward kernels (dq, dkv) against their plain version at
   the training path's shape, the forward's case list, the Hopper
   kernels' tile edges and an LSE cotangent; their times, bounds and
   PyTorch's SDPA backward;
7. GPT-2 medium training at full width and depth (batch 8 x 1024, bf16
   compute on float32 master weights, AdamW): a few steps through
   ``polyaxon_tpu_torch.train.main`` (24 forward, 24 dq and 24 dkv
   launches a step), then a timed loop of ``TrainStep`` calls (step
   time, tok/s, MFU, device idle share, top kernels);
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


def device_breakdown(fn, wall_ms: float, label: str):
    """One call of ``fn`` under torch.profiler: the device's busy time
    (kernel times summed; one stream, so they do not overlap) against
    ``wall_ms`` measured without the profiler, and the top kernels.
    Returns the busy ms (None when the profiler saw no kernel)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
                one["wall_s"] * 1e3, "serving")


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


def phase_http_serving(model, model_f32):
    """The continuous-batching server on GPT-2 medium, through
    ``ModelServer`` -> ``DecodeEngine`` -> ``SlotKVManager``.

    1. float32, 4 slots, prefill chunk 64: 12 concurrent requests
       (prompts of 16-200 tokens from seed 0, 24 new tokens) through
       ``ModelServer.generate`` equal solo ``generate`` (tie rule: a
       first difference where the solo float32 top-2 logit gap is below
       1e-4 is accepted, and printed);
    2. bf16, 8 slots filled: the W = 8 window as a CUDA-graph replay and
       eagerly from the same state give identical tokens and bitwise
       equal caches;
    3. bf16 over HTTP (``make_server`` on port 0), 8 slots, prefill chunk
       256, window 8: 32 POST /generate from 16 client threads (prompts
       of 64-512 tokens from seed 0, 64 new tokens): tok/s, latency
       p50/p99, TTFT p50, decode steps, mean window, graph captures vs
       replays (at most 4 captures, none after warm-up), device busy vs
       wall; the /metrics queue/prefill/decode lines; then POST /drain
       turns /healthz readiness off.
    Returns the flash launch counts of step 3's run (the path launches
    no kernel: decode and chunked-prefill masks take the plain path)."""
    import threading
    import urllib.error
    import urllib.request

    from polyaxon_tpu_torch.models import generate as G
    from polyaxon_tpu_torch.serving import ModelServer, make_server

    cfg = model.cfg
    # 1. float32 exactness against solo generate.
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in rng.randint(16, 201, 12)]
    with torch.no_grad():
        solo = [G.generate(model_f32, [p], max_new_tokens=24)[0, len(p):]
                .tolist() for p in prompts]
    ms = ModelServer(model_f32, model_name="gpt2-medium", n_slots=4,
                     prefill_chunk=64, decode_window=8)
    got = [None] * len(prompts)

    def go(i):
        got[i] = ms.generate({"prompt": prompts[i], "max_new_tokens": 24})

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    secs = time.perf_counter() - t0
    stats = ms.engine.stats()
    ms.close()
    ties = 0
    for i, (p, want) in enumerate(zip(prompts, solo)):
        if got[i] is None:
            raise AssertionError(f"float32 request {i} got no response")
        new = got[i]["new_tokens"][0]
        if new == want:
            continue
        k, gap = _first_gap(model_f32, p, want, new)
        print(f"[http] tie rule used: request {i} (prompt {len(p)}) "
              f"leaves solo at new token {k}, solo float32 top-2 logit "
              f"gap {gap:.3e} (limit 1e-4)")
        if gap >= 1e-4:
            raise AssertionError(f"float32 engine tokens != solo generate "
                                 f"for request {i} at new token {k}")
        ties += 1
    print(f"[http] float32 engine: 12 concurrent requests (prompts "
          f"{min(map(len, prompts))}-{max(map(len, prompts))}, 24 new "
          f"tokens, 4 slots, prefill chunk 64) equal solo generate "
          f"({12 - ties} exactly, {ties} by the tie rule) in {secs:.2f} s; "
          f"admitted {stats['admitted_total']}, decode steps "
          f"{stats['decode_steps_total']} in "
          f"{stats['decode_dispatches_total']} dispatches, graph captures "
          f"{stats['compile_cache_misses']}")
    if stats["compile_cache_misses"] > 4:
        raise AssertionError(f"float32 pool captured "
                             f"{stats['compile_cache_misses']} graphs")

    # 2. bf16 graph replay vs eager, the pool full.
    from polyaxon_tpu_torch.serving.slots import SlotKVManager

    pool = SlotKVManager(model, 8, max_window=8)
    for s, n in enumerate(np.random.RandomState(2).randint(64, 513, 8)):
        toks = torch.as_tensor(
            np.random.RandomState(10 + s).randint(0, cfg.vocab_size,
                                                  (1, n)), device="cuda")
        logits, cache = G.prefill(model, toks)
        pool.acquire()
        pool.insert(s, cache, int(torch.argmax(logits[0])), int(n))
        del cache
    state = (pool.tokens.copy(), pool.positions.copy(), pool._k.clone(),
             pool._v.clone())
    eager = pool.step(8, graph=False)
    k_eager, v_eager = pool._k.clone(), pool._v.clone()
    pool.tokens, pool.positions = state[0].copy(), state[1].copy()
    pool._k.copy_(state[2])
    pool._v.copy_(state[3])
    replay = pool.step(8)
    same_toks = bool((replay == eager).all())
    same_kv = bool(torch.equal(pool._k, k_eager)) and \
        bool(torch.equal(pool._v, v_eager))
    print(f"[http] bf16 W=8 window over 8 full slots: graph replay vs "
          f"eager tokens {'identical' if same_toks else 'DIFFER'}, caches "
          f"{'bitwise equal' if same_kv else 'DIFFER'}")
    if not (same_toks and same_kv):
        raise AssertionError("CUDA-graph window != eager window")
    # The window's device time, replayed alone: one graph launch.
    for _ in range(3):
        pool.step(8)
    start, end = _events()
    times = []
    for _ in range(5):
        pool.tokens, pool.positions = state[0].copy(), state[1].copy()
        pool._load_state()
        start.record()
        pool._graphs[8].replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    print(f"[http] bf16 W=8 window, 8 slots at positions 64-519: "
          f"{statistics.median(times):.3f} ms a replay "
          f"({statistics.median(times) / 8:.3f} ms a decode step, "
          f"{8 * 8 / statistics.median(times) * 1e3:.0f} tok/s at full "
          f"occupancy)")
    del pool, state, k_eager, v_eager
    torch.cuda.empty_cache()

    # 3. bf16 over HTTP.
    ms = ModelServer(model, model_name="gpt2-medium", n_slots=8,
                     prefill_chunk=256, decode_window=8)
    srv = make_server("127.0.0.1", 0, ms)
    server_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    server_thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        rng = np.random.RandomState(0)
        bodies = [{"prompt": rng.randint(0, cfg.vocab_size, n).tolist(),
                   "max_new_tokens": 64}
                  for n in rng.randint(64, 513, 32)]
        # Warm-up: a few requests, then every window once (idle lanes
        # step harmlessly), so every graph is captured before timing.
        _load_clients(base, bodies[:8], 8)
        with ms._lock:
            for w in (1, 2, 4, 8):
                ms.engine.slots.step(w)
        torch.cuda.synchronize()
        warm = ms.recompile.snapshot()
        steps0 = ms.engine.decode_steps_total
        disp0 = ms.engine.decode_dispatches_total
        _zero_counts()
        wall, results = _load_clients(base, bodies, 16)
        counts = _counts()
        after = ms.recompile.snapshot()
        steps = ms.engine.decode_steps_total - steps0
        dispatches = ms.engine.decode_dispatches_total - disp0
        lat = sorted(r[0] for r in results)
        ttft = sorted(r[1]["ttft_ms"] for r in results)
        ntok = sum(len(r[1]["new_tokens"][0]) for r in results)
        bad = [i for i, (_, r) in enumerate(results)
               if len(r["new_tokens"][0]) != 64
               or min(r["new_tokens"][0]) < 0
               or max(r["new_tokens"][0]) >= cfg.vocab_size]
        if bad:
            raise AssertionError(f"malformed responses {bad[:5]}")
        captures = after["compile_cache_misses"] - warm["compile_cache_misses"]
        replays = after["compile_cache_hits"] - warm["compile_cache_hits"]
        rec = {"requests": len(results), "new_tokens": ntok,
               "wall_s": wall, "tok_per_s": ntok / wall,
               "latency_p50_s": lat[len(lat) // 2],
               "latency_p99_s": lat[min(len(lat) - 1,
                                        int(0.99 * len(lat)))],
               "ttft_p50_ms": ttft[len(ttft) // 2],
               "decode_steps": steps, "dispatches": dispatches,
               "mean_window": steps / max(1, dispatches),
               "captures_total": after["compile_cache_misses"],
               "captures_in_run": captures, "replays_in_run": replays,
               "flash_launches": counts}
        print(f"[http] gpt2-medium bf16 over HTTP: 32 POST /generate "
              f"from 16 clients (prompts 64-512, 64 new tokens), 8 slots, "
              f"prefill chunk 256, window 8: {ntok} tokens in "
              f"{wall:.3f} s = {rec['tok_per_s']:.1f} tok/s; latency p50 "
              f"{rec['latency_p50_s']:.3f} s p99 {rec['latency_p99_s']:.3f}"
              f" s; TTFT p50 {rec['ttft_p50_ms']:.1f} ms; decode steps "
              f"{steps} in {dispatches} dispatches (mean window "
              f"{rec['mean_window']:.2f}); graph captures "
              f"{rec['captures_total']} in all, {captures} in the run, "
              f"replays {replays}; flash launches {counts}")
        if rec["captures_total"] > 4 or captures:
            raise AssertionError(f"graph captures: {rec['captures_total']}"
                                 f" in all, {captures} after warm-up")
        rec["busy_ms"] = device_breakdown(
            lambda: _load_clients(base, bodies, 16), wall * 1e3, "http")
        print(f"[http] record {json.dumps(rec)}")
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
        for line in metrics.splitlines():
            if re.match(r"ptpu_serving_(queue|prefill|decode)\S*"
                        r"(_sum|_count|_total)? ", line) and \
                    "_bucket" not in line:
                print(f"[http] /metrics {line}")
        drain = urllib.request.Request(base + "/drain", data=b"{}")
        with urllib.request.urlopen(drain, timeout=60) as r:
            drained = json.loads(r.read())
        try:
            urllib.request.urlopen(base + "/healthz", timeout=60)
            raise AssertionError("/healthz still ready after /drain")
        except urllib.error.HTTPError as e:
            health = json.loads(e.read())
            if e.code != 503 or health["reason"] != "draining":
                raise AssertionError(f"/healthz after /drain: {e.code} "
                                     f"{health}")
        print(f"[http] POST /drain -> {drained}; /healthz 503 "
              f"{health['status']} ({health['reason']})")
    finally:
        srv.shutdown()
        srv.server_close()
        ms.close()
    return rec


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
    finite loss on every logged step."""
    import contextlib
    import io
    import re

    from polyaxon_tpu_torch import train

    out = io.StringIO()
    with tempfile.TemporaryDirectory() as home:
        env = {"POLYAXON_TPU_HOME": home,
               "POLYAXON_TPU_RUN_UUID": "chip-smoke"}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
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
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    for line in out.getvalue().splitlines():
        print(f"[train.main] {line}")
    losses = [float(m) for m in re.findall(r"^step \d+/\d+ loss=(\S+)",
                                           out.getvalue(), re.M)]
    if rc != 0 or len(losses) != steps or \
            not all(np.isfinite(losses)):
        raise AssertionError(f"train.main: exit {rc}, losses {losses}")
    _check_per_step(counts, steps, 24, "train.main")
    print(f"[train.main] gpt2-medium {steps} steps in {secs:.1f} s "
          f"(model init, data, steps and the final checkpoint); flash "
          f"launches {counts}")
    return counts


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
    http = phase_http_serving(model, model_f32)
    mark("http serving")
    del model, model_f32
    torch.cuda.empty_cache()
    train_counts = phase_train_entry()
    mark("train.main")
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
                "http_serving": http["flash_launches"][name],
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
