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
   main path's shape, the training shapes (GPT-2 medium's, TinyLlama's
   [4, 2048, 32, 64] full and windowed, BERT-base's [32, 512, 12, 64]
   non-causal, bare and key-padded, T5-small's cross-attention at
   scale 1.0, [16, 512, 8, 64] and [16, 128 -> 512, 8, 64] key-padded,
   MoE-GPT-small's [8, 1024, 12, 64] causal) and the masks, types, head
   dims
   and tile edges it takes; times of the kernel, the plain version and
   PyTorch's own ``scaled_dot_product_attention`` (a yardstick the port
   never calls) at the serving and the training shapes;
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
   ones bitwise, with their device times; three HTTP loads of 16
   requests from 16 clients (all greedy on the fixed-lane pool, then
   half sampled on the fixed-lane and on the paged pool: tok/s,
   latency, TTFT, windows, graph captures; device busy share of the
   greedy and the paged load), then
   POST /drain; the radix prefix cache on both pools (a 512-token
   system prompt registered by POST /prefill, 8 requests extending it
   from 8 clients and a 2-row one: float32 tokens with the cache on ==
   off on both pools, bf16 prefill tokens, hits, TTFT and pages cold
   against warm on the paged pool);
   the float32 exactness checks run at a few layers of the model's
   own weights (``F32_LAYERS``), the bf16 timings at full depth;
   fault containment in float32 (a transient step fault retried, a
   poisoned request alone failing 500 ``poisoned_request``, an engine
   death on the paged pool recovered by the supervisor: every other
   request equal to the fault-free run, the prefix index flushed and
   refilled, no graph captured after the restart); speculative decoding
   with K = 4 and two drafts made from seeds, gpt2-small and a
   4-of-24-layer cut of the target (float32 solo greedy
   ``generate_speculative`` == ``generate``; the float32 engine's spec
   slots on the fixed-lane and the paged pool, 8 requests of which 6
   speculative, each equal to its solo run, no capture after warm-up on
   the fixed lane;
   bf16 spec and plain window replay times and the cut draft's
   acceptance; an HTTP load of 16 requests, half speculative, with the
   ``ptpu_serving_spec_accept_rate`` family); beam search in float32
   (``num_beams`` 4 over HTTP and ``generate --beams 4`` == the port's
   ``generate_beam`` on the CPU, ``num_beams`` 1 == greedy); the
   serving mesh (``phase_serving_mesh``, virtual devices on the one
   card): the column-split probe, float32 meshed engines (GPT-2 medium
   tp 2/4, TinyLlama tp 2, MoE-GPT-small tp 2 x ep 2) == unmeshed ==
   solo, bf16 tp 2 at full width (rows equal, replay ms, captures,
   shard bytes), and ``ModelServer(mesh="tp=1")`` over HTTP;
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
   device idle share, top kernels); then ``phase_mesh``: a one-rank
   NCCL group started by the bootstrap (NCCL puts no two ranks on one
   card), the slice health probe, the collectives, and 3 GPT-2 medium
   steps through the mesh ``TrainStep`` under ``{dp: -1}`` and
   ``{dp: 1, fsdp: -1}`` (FSDP2) equal to the group-less step
   (``[mesh]`` lines); then ``phase_tp_train``: a two-process gang on
   the one card (gloo over the card's tensors), GPT-2 medium on
   ``tp:2`` and MoE-GPT-small on ``ep:2``, float32 at a few layers equal
   to the group-less step, bf16 at a quarter depth timed, the flash kernels
   launched at each rank's local heads (``[tp]`` lines), and in the same
   ranks sequence parallelism on ``sp:2``: ring and Ulysses attention
   over the gang, float32 GPT-2 medium and TinyLlama's width (windowed
   ring) equal to the group-less step, bf16 GPT-2 medium timed with
   each rank's launches (``[sp]`` lines); then ``phase_compose_train``:
   a four-process gang on the one card, float32 GPT-2 medium at
   ``dp:1,fsdp:2,tp:2`` and ``sp:2,fsdp:2`` and MoE-GPT-small at
   ``fsdp:2,ep:2`` and ``sp:2,ep:2`` equal to the group-less step, each
   rank's launches and parameter bytes, the fsdp x tp checkpoint
   restored in one process (``[compose]`` lines); then
   ``phase_pipeline_train``: in the same four ranks float32 GPT-2
   medium at ``dp:2,pp:2`` (GPipe) and ``pp:2,fsdp:2`` (1F1B) and
   TinyLlama's width at ``dp:2,pp:2`` (1F1B under remat) and
   ``pp:2,tp:2`` (1F1B, its checkpoint restored in one process) equal
   to the group-less step, each rank's launches as its schedule gives
   them and its parameter bytes; bf16 GPT-2 medium at full depth through
   ``train.main --strategy pp:2`` in those ranks (their PTPU_* block),
   step ms a rank against the group-less step (``[pipeline]`` lines);
   the four ranks run beside the phases from ``phase_mesh`` to the
   named remat policy's (item 9) and are collected after it;
8. one float32 step's loss and gradients through the flash route against
   the plain-attention route, at GPT-2 medium's width and 4 layers;
   the baseline's training zoo (``phase_zoo``, ``[zoo]`` lines):
   BERT-base MLM at full width and depth, bf16, 32 x 512, through
   ``train.main`` (12 non-causal launches of each kernel a step) and a
   timed ``TrainStep`` loop (step ms, tok/s, MFU), and at 2 layers of
   its width in float32 flash == plain attention without and with a
   padded ``attention_mask``; ResNet-50 at 128 x 224 x 224 (img/s, MFU,
   running averages moved, eval-mode logits, channels-last); ``run -f``
   of ``mnist.yaml`` to ``eval_accuracy >= 0.95``; the rest of the
   zoo (``phase_zoo_rest``, ``[moe]`` / ``[t5]`` / ``[vit]`` /
   ``[zoo-rest]`` lines), each model from seed 0 at the registry's full
   width and depth: MoE-GPT-small ``TrainStep`` at 8 x 1024 (12 causal
   launches of each kernel a step; step ms, tok/s, MFU, aux loss), its
   flash route at 2 layers in float32, the float32 engine == solo on
   both pools, a bf16 HTTP load of 8 requests on the paged pool (no
   flash launch) and the greedy decode step; T5-small ``train.main
   --dataset span-corruption`` on a seeded token file (6 cross-attention
   launches of each kernel a step, 128 rows over 512 key-padded keys at
   scale 1.0), a timed ``TrainStep`` at 16 x 512, the cross-attention's
   flash route at 2 + 2 layers in float32 with and without
   ``enc_mask``, cached greedy == no-cache greedy and 1 beam == greedy
   in float32, bf16 ms a token greedy and with 4 beams; ViT-B/16
   ``TrainStep`` at 64 x 224 x 224 (no flash launch: 197 tokens);
   ``train.main --init-hf`` of ``export_hf_vit`` / ``export_hf_t5``
   (first loss == the source model's);
9. TinyLlama-1.1B (RoPE, RMSNorm, SwiGLU, GQA 32/4) at full width and
   depth, random from seed 0: the full forward on [2, 2048] (22 flash
   launches) against plain attention in bf16 and float32; the CLI's
   ``generate``; the server (float32 engine == solo on both pools, graph
   windows == eager bitwise, an HTTP load of 32 mixed requests on the
   fixed-lane and on the paged pool, no flash launch; 8 float32
   requests over a 512-token prefix on the paged pool: cache on == off);
   ``TrainStep`` at
   batch 4 x 2048 with remat (44 forward, 22 dq and 22 dkv launches a
   step; step time, MFU); at its width and 2 layers, the flash route's
   logits and gradients against plain attention, full causal and with a
   sliding window of 511 (the registry's ``sliding_window`` override);
   float32 solo greedy ``generate_speculative`` with a 2-of-22-layer
   cut draft == greedy ``generate``; the named remat policy
   ``dots_with_no_batch_dims_saveable`` at 4 x 2048 (step ms and peak
   memory against whole-layer remat; float32 gradients equal at 2
   layers); ``train.main --init-hf`` of the seeded weights through
   ``export_hf_llama`` and ``torch.save`` (its first loss == the source
   model's);
   mistral-tiny's window in decode: float32 engine == solo on both pools;
   int8 weights and the int8 KV cache (GPT-2 medium: weight and cache
   bytes against bf16; float32 ``--int8-weights --int8-kv`` engine ==
   solo on both pools with sampled, prefix-hit and speculative requests;
   bf16 decode steps for plain, int8 KV, int8 weights and both on both
   pools; an HTTP load on ``serve --int8-weights --int8-kv --kv-paged``'s
   model; TinyLlama's bytes and paged steps); the ring cache at
   TinyLlama's width with a window of 511 (float32 at 4 layers: a
   1,536 + 560-token greedy and a 2,000 + 64-token sampled session past
   max_position solo == a plain cache of max_position 4096 == the
   fixed-lane engine; bf16 at full depth: cache
   bytes, the decode step past position 2048, paged refused);
   the fleet tier (``phase_fleet``, run after the int8 phase, GPT-2
   medium at full width and depth): a 512-token prefix's
   ``spill_pages`` -> ``pack_spilled`` -> ``unpack_spilled`` ->
   ``rematerialize`` == ``materialize`` bitwise in bf16, int8 KV and at
   TinyLlama's width, with bytes and ms; in float32 a ``ReplicaRouter``
   over in-process replicas (one ``role="prefill"``, two ``"decode"``
   capturing their graphs at the same time) == a monolithic server on 8
   requests, each long one admitted over the wire, then a decode replica
   killed mid-request (failover and ``resume_tokens`` token-identical);
   ``serve --role prefill``, two ``serve --role decode`` and ``route``
   as processes under 16 bf16 requests (tok/s, TTFT, handoffs and their
   bytes and ms against a local re-prefill, the router's link
   estimates); the host tier on one server (spills, host hits == the
   uncached tokens, TTFT cold / device hit / host hit);
   the flight recorder and the legacy baselines (``phase_profiling``,
   GPT-2 medium): ``profile_every`` 16 / ``profile_steps`` 8 windows over
   the mixed HTTP load on both pools (step markers, shares summing to 1,
   the card's peak, /metrics == /profile/report), a manual
   ``/profile/start|stop`` window whose busy seconds equal this
   script's own kernel + memcpy + memset sum within 2 %, tok/s with the
   recorder attached and detached, float32 tokens with it on == off and
   under ``batching`` coalesce and off == solo ``generate``, and bf16
   tok/s and TTFT of continuous / coalesce / off on the mixed load and
   on a load the coalescer merges; the lock sanitizer armed on the
   paged engine-death server of ``phase_faults`` and on the float32
   coalesce server (which nests ``device_lock -> _stats_lock``): no
   violation, observed edges, and every one of them in the static lock
   graph that the port's ``analysis.lockgraph`` builds from the port's
   sources (``[locks]``: the observed and static edge counts);
10. ``python -m polyaxon_tpu_torch.cli run -f`` on the port's example
   polyaxonfiles in a temporary home, each read back through the port's
   store: the GPT-2 medium ``job`` (3 tracked steps equal to its log
   lines, the card in its env record, ``gpu0_*`` system metrics, its
   checkpoint, 24 launches of each flash kernel in the profiled step's
   trace) and the GPT-2 medium ``service`` (tokens equal to an
   in-process server's, reaped by ``ops stop`` with the card's memory
   back); before them ``convnet_hyperband.yaml`` cut to 6 ConvNet
   trials (the port's schedule for the sweep's seed, the best run the
   highest accuracy), its trial processes started while TinyLlama's
   ``train.main``, gradient route and mistral-tiny checks run;
11. the deployment twin (``phase_stack``, ``[stack]`` lines), started
   beside those TinyLlama checks: the C++ operator built with ``make -C
   operator``; ``ptpu-torch server --auth-token``, a copy of
   ``gpt2_mpijob.yaml`` (one worker, GPT-2 medium at batch 8, 2 steps,
   step 2 profiled, the phase's home) submitted by ``ptpu-torch run``
   with ``POLYAXON_TPU_HOST``, ``ptpu-torch agent --backend manifest``
   and the operator on its cluster directory: the CR asks one
   ``nvidia.com/gpu`` and carries the ``PTPU_*`` block, the pod starts
   a one-rank NCCL group on ``cuda:0`` and trains, the run ends
   ``succeeded`` over the API (``ops statuses``), its logs over the API
   (``ops logs``) hold 2 finite losses equal to the tracked ones, its
   env event names the card, its profiled step has 24 launches of each
   flash kernel, its metrics reach the control plane, ``/metrics`` and
   the dashboard answer;
12. one JSON line of kernel records, the card line, and the final
   ``{"ok": true, ...}`` line.

Exits non-zero, printing no result, without a CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
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


def _release():
    """Free what a phase dropped.  A closed ``ModelServer`` no longer
    sits in reference cycles (its ``close()`` breaks them), so its
    engine, pools and model go when the phase drops them; the collect
    stays for anything else a phase leaves in a cycle — left to the
    collector's own timing, dropped servers once held 6.6 GB into
    TinyLlama's timed training, whose steps then took 1.8-2.8x as long
    with the device idle (NVIDIA H100 80GB HBM3, 700.00 W)."""
    gc.collect()
    torch.cuda.empty_cache()


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
    kernels = _kernel_times(prof)
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
    classes = {}
    for ms, _, name in kernels:
        cls = ("flash" if "flash_" in name else
               "matmul" if re.search(r"gemm|gemv|nvjet|cutlass|xmma", name)
               else "copy" if "copy" in name else "other")
        classes[cls] = classes.get(cls, 0.0) + ms
    print(f"[{label}] by class: " + ", ".join(
        f"{c} {classes.get(c, 0.0):.3f} ms" for c in
        ("matmul", "flash", "copy", "other")) + " (other: elementwise, "
        "reductions, softmax, indexing)")
    for ms, count, name in kernels[:8]:
        print(f"[{label}]   {ms:9.3f} ms  x{count:<5d} {name[:90]}")
    return busy


def _kernel_times(prof) -> list:
    """(ms, launches, name) of each device kernel a profile saw, summed
    by name over the raw kineto events.  Building the profiler's own
    per-event objects (``key_averages``) for a serving load's
    50,000-200,000 kernels made its profiled rerun take 9-27 s; without
    them it takes 2-8 s (NVIDIA H100 80GB HBM3, 700.00 W)."""
    from torch.autograd import DeviceType

    times = {}
    for e in prof.profiler.kineto_results.events():
        # Device kernels only: a record_function range such as
        # "Optimizer.step#AdamW.step" also carries device time, which
        # overlaps the kernels it encloses.  (Kernel names may hold "#"
        # too: "{lambda()#3}".)
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        name = e.name()
        if name.startswith(("Optimizer.", "ProfilerStep")):
            continue
        ms, count = times.get(name, (0.0, 0))
        times[name] = (ms + e.duration_ns() / 1e6, count + 1)
    return [(ms, count, name) for name, (ms, count) in times.items()
            if ms > 0]


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


def _window_mask(sq, sk, window, device, causal=True):
    """SDPA's boolean mask for a sliding window (True = attend): causal,
    or the raw window alone (a ring's past block): SDPA has no window
    argument, so the library call takes a mask."""
    q_ids = torch.arange(sq, device=device)[:, None] + (sk - sq)
    k_ids = torch.arange(sk, device=device)[None, :]
    inside = q_ids - k_ids <= window
    return (q_ids >= k_ids) & inside if causal else inside


def _sdpa_fn(qt, kt, vt, scale, window, causal=True, kv_mask=None):
    """SDPA on BHSD tensors; a window or a key-padding mask goes in as a
    mask made here, outside the timed call."""
    mask = None if window is None else _window_mask(
        qt.shape[2], kt.shape[2], window, qt.device, causal)
    if kv_mask is not None:
        mask = kv_mask[:, None, None, :]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        scale=scale)


def _mask_label(causal, window, kv_mask) -> str:
    return (("causal" if causal else "non-causal")
            + (f" window {window}" if window else "")
            + (" key-padding mask" if kv_mask is not None else ""))


def _time_forward(label, q, k, v, other=None, window=None, causal=True,
                  kv_mask=None, scale=None):
    """Device times at one shape (``window``: a sliding window;
    ``causal``; ``kv_mask``: key padding; ``scale``: D ** -0.5 unless
    given): the kernel, the plain version, SDPA and the bound; with
    ``other`` (another build of the kernel) both builds in turns, other
    / this / this / other."""
    from polyaxon_tpu_torch.ops import flash

    if scale is None:
        scale = q.shape[-1] ** -0.5
    kernel = lambda: flash._flash_forward_kernel(q, k, v, kv_mask, causal,
                                                 scale, window)
    rec = {"eager_ms": eager_ms(kernel), "ms": graph_ms(kernel)}
    rec["plain_ms"] = graph_ms(lambda: flash._flash_forward_reference(
        q, k, v, kv_mask, causal, scale, window), calls=2, reps=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = _sdpa_fn(qt, kt, vt, scale, window, causal, kv_mask)
    rec["library_ms"] = graph_ms(sdpa)
    rec["bound_ms"], rec["bound_by"] = bound(q, k, causal, window, kv_mask)
    line = (f"[kernel] {label} {list(q.shape)}"
            + (f"->{k.shape[1]}" if k.shape[1] != q.shape[1] else "")
            + f" {str(q.dtype)[6:]} "
            f"{_mask_label(causal, window, kv_mask)}, scale {scale:.4g}, "
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
        # TinyLlama's training shape: 32 query heads over GQA-repeated
        # K/V (contiguous after RoPE and the repeat), full and windowed.
        ("llama_train", 4, 2048, 2048, 32, 64, bf16, True, None, None),
        ("llama_train_window", 4, 2048, 2048, 32, 64, bf16, True, 511,
         None),
        # BERT-base's training shape: non-causal over the fused qkv
        # projection, bare and under a key-padding mask.
        ("bert_train", 32, 512, 512, 12, 64, bf16, False, None, None),
        ("bert_train_kv_mask", 32, 512, 512, 12, 64, bf16, False, None,
         "lengths"),
        # The rest of the zoo: T5-small's cross-attention (non-causal,
        # scale 1.0: the synthetic batch's 512 -> 512, span corruption's
        # 128 decoder rows over 512 key-padded encoder keys) and
        # MoE-GPT-small's causal training shape over its fused qkv.
        ("t5_cross", 16, 512, 512, 8, 64, bf16, False, None, None, 1.0),
        ("t5_cross_kv_mask", 16, 128, 512, 8, 64, bf16, False, None,
         "lengths", 1.0),
        ("moe_train", 8, 1024, 1024, 12, 64, bf16, True, None, None),
        # Sequence parallelism's ring blocks (GPT-2 medium and TinyLlama
        # at sp 2): a past block, non-causal, and a windowed rotation's
        # raw window 511 - 1024 (rows past 510 keep no key).
        ("ring_past_block", 8, 512, 512, 16, 64, bf16, False, None, None),
        ("ring_window_rotation", 2, 1024, 1024, 32, 64, bf16, False, -513,
         None),
    ]
    fused = ("main", "train_fused", "bert_train", "bert_train_kv_mask",
             "moe_train")
    timed = fused + ("llama_train", "llama_train_window", "t5_cross",
                     "t5_cross_kv_mask", "ring_past_block",
                     "ring_window_rotation")
    results, shapes = {}, {}
    for name, b, sq, sk, h, d, dtype, causal, window, mk, *sc in cases:
        q, k, v = _qkv(b, sq, sk, h, d, dtype, gen, fused=name in fused)
        kv_mask = _kv_mask(mk, b, sk, gen)
        scale = sc[0] if sc else d ** -0.5
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
        if mk == "lengths":  # batch 0 keeps no key: every row empty
            ok &= bool((lse[0] == flash.NEG_INF).all()) and \
                bool((o[0] == 0).all())
        if name == "ring_window_rotation":  # rows 511.. keep no key
            ok &= bool((lse[:, :, 511:] <= flash.NEG_INF / 2).all()) and \
                bool((o[:, 511:] == 0).all())
        print(f"[kernel] {name}: B={b} Sq={sq} Sk={sk} H={h} D={d} "
              f"{str(dtype)[6:]} causal={causal} window={window} "
              f"mask={mk} scale={scale:.4g}: max|dO|={err_o:.3e} "
              f"(tol {tol_o}) "
              f"max|dLSE|={err_l:.3e} (tol {tol_l}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash kernel disagrees with its plain "
                                 f"version at case {name}")
        results[name] = (err_o, err_l)
        if name in timed:
            shapes[name] = (q, k, v, kv_mask, scale)
        del q, k, v, o, lse, o_ref, lse_ref

    other = other_forward(other_src) if other_src else None
    rec = _time_forward("main", *shapes.pop("main")[:3], other)
    train = _time_forward("training", *shapes.pop("train_fused")[:3], other)
    rec.update({f"{key}_train": val for key, val in train.items()})
    for name, window, causal in (("llama_train", None, True),
                                 ("llama_train_window", 511, True),
                                 ("bert_train", None, False),
                                 ("bert_train_kv_mask", None, False),
                                 ("t5_cross", None, False),
                                 ("t5_cross_kv_mask", None, False),
                                 ("moe_train", None, True),
                                 ("ring_past_block", None, False),
                                 ("ring_window_rotation", -513, False)):
        q, k, v, kv_mask, scale = shapes.pop(name)
        rec[name] = _time_forward(name, q, k, v, window=window,
                                  causal=causal, kv_mask=kv_mask,
                                  scale=scale)
        rec[name]["max_abs_err"] = results[name][0]
        del q, k, v, kv_mask
        _release()
    rec.update({"max_abs_err": results["main"][0],
                "max_abs_err_lse": results["main"][1],
                "max_abs_err_train": results["train_fused"][0],
                "max_abs_err_all_cases": max(e[0] for e in results.values())})
    return rec


def _kv_mask(kind, b, sk, gen):
    """None; "pad": random keys kept, keys 0..127 of batch 0 masked (its
    causal rows 0..127 wholly); "lengths": BERT's key padding, row i
    keeping its first ``len_i`` keys, ``len_i`` in [sk / 2, sk], but
    batch 0 none and batch 1 the first 100 (key tiles the padding
    admits whole, cuts and refuses whole, and rows with no key)."""
    if kind == "pad":
        kv_mask = torch.rand((b, sk), generator=gen, device="cuda") > 0.3
        kv_mask[0, :128] = False
        return kv_mask
    if kind == "lengths":
        lens = torch.randint(sk // 2, sk + 1, (b, 1), generator=gen,
                             device="cuda")
        lens[0], lens[1] = 0, 100
        return torch.arange(sk, device="cuda")[None, :] < lens
    return None


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
        # TinyLlama's training shape, full and windowed.
        ("llama_train", 4, 2048, 2048, 32, 64, bf16, True, None, None),
        ("llama_train_window", 4, 2048, 2048, 32, 64, bf16, True, 511,
         None),
        # BERT-base's training shape, non-causal, bare and key-padded.
        ("bert_train", 32, 512, 512, 12, 64, bf16, False, None, "fused"),
        ("bert_train_kv_mask", 32, 512, 512, 12, 64, bf16, False, None,
         "lengths"),
        # The rest of the zoo: T5-small's cross-attention at scale 1.0
        # (512 -> 512; 128 rows over 512 key-padded keys) and
        # MoE-GPT-small's causal training shape.
        ("t5_cross", 16, 512, 512, 8, 64, bf16, False, None, None, 1.0),
        ("t5_cross_kv_mask", 16, 128, 512, 8, 64, bf16, False, None,
         "lengths", 1.0),
        ("moe_train", 8, 1024, 1024, 12, 64, bf16, True, None, "fused"),
        # The ring's blocks at sp 2 with the LSE cotangent the ring's
        # log-sum-exp combination sends back: a past block, non-causal,
        # and a windowed rotation's raw window -513 (rows 511.. and keys
        # ..512 fully masked: zero gradients).
        ("ring_past_block", 8, 512, 512, 16, 64, bf16, False, None,
         "dlse"),
        ("ring_window_rotation", 2, 1024, 1024, 32, 64, bf16, False, -513,
         "dlse"),
    ]
    timed = ("main_train", "llama_train", "llama_train_window",
             "bert_train", "bert_train_kv_mask", "t5_cross",
             "t5_cross_kv_mask", "moe_train", "ring_past_block",
             "ring_window_rotation")
    kept = {}
    worst = {"dq": 0.0, "dkv": 0.0}
    for name, b, sq, sk, h, d, dtype, causal, window, extra, *sc in cases:
        q, k, v = _qkv(b, sq, sk, h, d, dtype, gen,
                       fused=extra in ("fused", "lengths") and sq == sk)
        kv_mask = _kv_mask(extra, b, sk, gen)
        scale = sc[0] if sc else d ** -0.5
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
        if kv_mask is not None:   # masked keys: exact zero dK, dV
            gone = ~kv_mask[:, :, None, None]
            ok &= bool((got[1].masked_select(gone) == 0).all()) and bool(
                (got[2].masked_select(gone) == 0).all())
        if extra == "pad":        # wholly masked causal rows: zero dQ
            ok &= bool((got[0][0, :128] == 0).all())
        if extra == "lengths":    # batch 0 keeps no key: zero dQ
            ok &= bool((got[0][0] == 0).all())
        if name == "ring_window_rotation":  # masked rows and keys: zeros
            ok &= bool((got[0][:, 511:] == 0).all()) and all(
                bool((g[:, :513] == 0).all()) for g in got[1:])
        print(f"[backward] {name}: B={b} Sq={sq} Sk={sk} H={h} D={d} "
              f"{str(dtype)[6:]} causal={causal} window={window} "
              f"extra={extra} scale={scale:.4g}: "
              f"max|d dQ|={errs[0]:.3e} (tol {tols[0]:.2e}) "
              f"max|d dK|={errs[1]:.3e} (tol {tols[1]:.2e}) "
              f"max|d dV|={errs[2]:.3e} (tol {tols[2]:.2e}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"flash backward kernels disagree with "
                                 f"their plain version at case {name}")
        worst["dq"] = max(worst["dq"], errs[0])
        worst["dkv"] = max(worst["dkv"], errs[1], errs[2])
        if name in timed:
            kept[name] = ((q, k, v, o, lse, do, scale, errs),
                          dict(window=window, causal=causal,
                               kv_mask=kv_mask, dlse=dlse))
        del q, k, v, o, lse, do, dlse, got, want

    other = other_backward(other_src) if other_src else None
    args, _ = kept.pop("main_train")
    recs = _time_backward("main_train", *args, worst, other=other)
    for name in timed[1:]:
        args, kw = kept.pop(name)
        more = _time_backward(name, *args, None, **kw)
        for which in recs:
            recs[which][name] = more[which]
        del args, kw
        _release()
    return recs


def _time_backward(label, q, k, v, o, lse, do, scale, errs, worst, *,
                   window=None, causal=True, kv_mask=None, dlse=None,
                   other=None):
    """Device times of dq and dkv at one shape (``window``: a sliding
    window; ``causal``; ``kv_mask``: key padding; ``dlse``: an LSE
    cotangent): the kernels, their plain versions, SDPA's backward
    (which takes no LSE cotangent) and the bounds; with ``other``
    (another build) both builds in turns.  ``worst``: the largest
    errors over all cases (the main shape's record carries them)."""
    from polyaxon_tpu_torch.ops import flash

    args, _ = flash._bwd_kernel_args(q, k, v, kv_mask, o, lse, do, causal,
                                     scale, window, dlse)
    plain_args = (q, k, v, kv_mask, o, lse, do, causal, scale, window,
                  dlse)
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)
    sdpa = _sdpa_fn(qt, kt, vt, scale, window, causal, kv_mask)
    # SDPA's backward: forward + backward captured together (autograd
    # runs the backward on its forward's stream, which must be the
    # capturing one), less the forward alone.
    t_lib = graph_ms(lambda: torch.autograd.grad(
        sdpa(), (qt, kt, vt), dot)) - graph_ms(sdpa)
    if other is not None:  # the other build's outputs, held as this one's
        other_args, theirs = flash._bwd_kernel_args(q, k, v, None, o, lse, do,
                                                    True, scale)
        for which in ("dq", "dkv"):
            flash._launch_bwd(which, args)
            other(which, other_args)
        torch.cuda.synchronize()
        for name, g, w in zip(("dQ", "dK", "dV"), theirs, args.keep[-3:]):
            err = _max_err(g, w)
            if err > 2e-2 * w.float().abs().max().item():
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
        t_bound, bound_by = bound(q, k, causal, window, kv_mask,
                                  q_like=q_like, kv_like=kv_like,
                                  rows=2 if dlse is None else 3,
                                  flop_per_pair=fpp)
        rec = {"max_abs_err": err, "ms": t_kernel, "plain_ms": t_plain,
               "library_ms": t_lib, "bound_ms": t_bound,
               "bound_by": bound_by, "eager_ms": t_eager}
        if worst is not None:
            rec["max_abs_err_all_cases"] = worst[which]
        line = (f"[backward] {which} {label} at {list(q.shape)}"
                + (f"->{k.shape[1]}" if k.shape[1] != q.shape[1] else "")
                + f" {str(q.dtype)[6:]} "
                f"{_mask_label(causal, window, kv_mask)}"
                + ("" if dlse is None else ", LSE cotangent") + ", scale "
                f"{scale:.4g}, device "
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


def phase_forward(model, model_f32, name="gpt2-medium", seq=1024,
                  tag="forward", min_agree_bf16=0.9):
    """The full forward on [2, ``seq``] tokens (entry()'s on GPT-2
    medium; TinyLlama's at [2, 2048], its RoPE'd q over GQA-repeated
    K/V); returns the launches of each kernel in it: one forward a
    layer, no dq or dkv.

    Held against the same model's plain-attention decode path in bf16
    (max|d| within 5% of max|logit|: 24 or 22 layers of bf16 rounding;
    argmax agreement >= ``min_agree_bf16``: bf16 logits lie on a grid
    of 1/32 near 5 and near-ties flip, 0.9 for GPT-2 medium, 0.8 for
    TinyLlama, whose random untied head's top-2 gaps over 32,000 tokens
    are about 0.2) and in float32 (1e-3 of max|logit|, agreement >=
    0.999: only summation order differs)."""
    cfg = model.cfg
    tokens = torch.as_tensor(
        np.random.RandomState(0).randint(0, cfg.vocab_size, (2, seq)),
        device="cuda")
    with torch.no_grad():
        _zero_counts()
        logits = model(tokens)
        torch.cuda.synchronize()
        counts = _counts()
        want = {"flash_fwd": cfg.num_layers, "flash_bwd_dq": 0,
                "flash_bwd_dkv": 0}
        if counts != want:
            raise AssertionError(f"forward made flash launches {counts};"
                                 f" expected {want}")
        if tuple(logits.shape) != (2, seq, cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"bad logits {tuple(logits.shape)}")
        del logits
        for m, rel, min_agree in ((model, 0.05, min_agree_bf16),
                                  (model_f32, 1e-3, 0.999)):
            logits, diff, scale, agree = forward_vs_plain(m, tokens)
            ok = bool(torch.isfinite(logits).all()) and \
                diff <= rel * scale and agree >= min_agree
            print(f"[{tag}] {str(m.cfg.dtype)[6:]}: flash vs plain-"
                  f"attention path: max|d|={diff:.6f} (tol {rel} x "
                  f"max|logit| {scale:.4f}), argmax agreement "
                  f"{agree:.4f} (min {min_agree}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("flash forward disagrees with the "
                                     "plain-attention forward")
            del logits
        t = eager_ms(lambda: model(tokens), calls=5, reps=3)
        print(f"[{tag}] {name} [2,{seq}] bf16: {t:.3f} ms "
              f"({2 * seq / t * 1e3:.0f} tok/s), flash launches "
              f"{counts}")
        device_breakdown(lambda: model(tokens), t, tag)
    return counts


def phase_serving(model, model_f32, name="gpt2-medium", tag="serving",
                  profile=True):
    """Greedy serving through the CLI's ``generate`` function on
    ``name`` (GPT-2 medium, or TinyLlama).  bf16 (the main path): tok/s, and
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
        dt = str(m.cfg.dtype)[6:]
        run_generate(m, name, rows, max_new_tokens=2,
                     prefill_chunk=32)  # warm-up: cuBLAS picks its kernels
        flash.launch_count = 0
        one = run_generate(m, name, rows, max_new_tokens=32)
        chunked = run_generate(m, name, rows, max_new_tokens=32,
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
            raise AssertionError(f"{dt}: generate != prefill + "
                                 f"generate_continue")
        same = int((toks == np.asarray(chunked["tokens"])).sum()) - 2 * 128
        print(f"[{tag}] {name} {dt} greedy, 2 x 128 prompt + 32 "
              f"new: {one['tok_per_sec']} tok/s one-shot ({one['wall_s']}"
              f" s), {chunked['tok_per_sec']} tok/s chunked; chunked "
              f"agrees on {same}/64 new tokens; generate == prefill + "
              f"continue; flash launches {launches} (decode masks take "
              f"the plain path)")
        if m is model_f32 and one["tokens"] != chunked["tokens"]:
            raise AssertionError("one-shot and chunked prefill disagree")
        if m is model and profile:
            device_breakdown(lambda: run_generate(
                m, name, rows, max_new_tokens=32),
                one["wall_s"] * 1e3, tag, host=False)


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


def _sampled_gap(model, prompt, solo_new, got_new, seed, spec,
                 row: int = 0) -> tuple:
    """(index, top-2 gap) of the solo float32 shaped logits + gumbel
    noise of the draw at the first new token where ``got_new`` leaves
    the solo sampled tokens ``solo_new`` (the sampled tie rule; ``row``
    is the request row whose key draws)."""
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
        key = prng.fold_in(
            G.sample_stream_keys(seed, row + 1, device="cuda")[row], k)
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


def _f32_schedule(model_f32, name="gpt2-medium", tag="http",
                  pools=("paged", "lazy"), n: int = 12):
    """float32, 4 slots, prefill chunk 64: ``n`` concurrent requests
    (prompts of 16-200 tokens from seed 0, 24 new tokens, every odd one
    sampled) through ``ModelServer.generate`` on the fixed-lane pool
    equal solo ``generate`` / ``generate_positional`` under the tie
    rule (a first difference whose solo float32 top-2 gap, of the
    logits or of shaped logits + noise, is below 1e-4, printed); the
    paged ``pools`` (eager, lazy) give exactly the fixed lane's
    tokens."""
    from polyaxon_tpu_torch.models import generate as G
    from polyaxon_tpu_torch.serving import ModelServer

    cfg = model_f32.cfg
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, m).tolist()
               for m in rng.randint(16, 201, n)]
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
    paged = {"paged": {"kv_paged": True},
             "lazy": {"kv_paged": True, "kv_lazy": True}}
    for label, kw in (("fixed", {}),) + tuple((p, paged[p]) for p in pools):
        ms = ModelServer(model_f32, model_name=name, n_slots=4,
                         prefill_chunk=64, decode_window=8, **kw)
        try:
            got, secs = _concurrent(ms, bodies)
            stats = ms.engine.stats()
        finally:
            ms.close()
        runs[label] = [g["new_tokens"][0] for g in got]
        print(f"[{tag}] float32 {label}: {n} concurrent requests "
              f"({n // 2} sampled) in {secs:.2f} s; admitted "
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
        print(f"[{tag}] tie rule used: request {i} ({kind}, prompt "
              f"{len(p)}) leaves solo at new token {k}, solo "
              f"float32 top-2 gap {gap:.3e} (limit 1e-4)")
        if gap >= 1e-4:
            raise AssertionError(f"float32 engine tokens != solo for "
                                 f"request {i} at new token {k}")
        ties += 1
    for label in pools:
        bad = [i for i in range(n) if runs[label][i] != runs["fixed"][i]]
        if bad:
            raise AssertionError(f"float32 {label} pool tokens != fixed "
                                 f"lane for requests {bad}")
    print(f"[{tag}] float32 engine ({n - n // 2} greedy + {n // 2} "
          f"sampled, T 0.8 top-k 50 "
          f"top-p 0.95, seed = index) equals solo generate / "
          f"generate_positional ({n - ties} exactly, {ties} by the tie "
          f"rule); {' and '.join(pools)} pool == fixed lane, all {n} "
          f"exactly")


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


def _graph_vs_eager(model, tag="http", profile=False):
    """bf16, 8 slots filled (prompts of 64-512 tokens, every odd slot
    sampled): the W = 8 window as a CUDA-graph replay and eagerly from
    the same state give identical tokens and bitwise-equal KV, for the
    fixed-lane greedy and sampled bodies and the paged sampled body
    (pool pages); then the device time of each replay (``profile``: and
    where the greedy window's device time goes, from an eager window
    under the profiler).  Returns the ms of one decode step per
    program."""
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
        print(f"[{tag}] bf16 {label} W=8 window over 8 full slots: graph "
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
            print(f"[{tag}] bf16 {name} W=8 window, 8 slots at positions "
                  f"{min(lengths)}-{max(lengths) + 7}"
                  f"{f', pad class {key[2]}' if paged else ''}: {ms:.3f} "
                  f"ms a replay ({ms / 8:.3f} ms a decode step, "
                  f"{8 * 8 / ms * 1e3:.0f} tok/s at full occupancy)")
        if profile and label == "greedy":
            restore()
            device_breakdown(lambda: pool.step(8, False, graph=False),
                             ms, f"{tag} decode window", host=False)
        del pool, kv, k_eager, v_eager
        _release()
    return step_ms


def _pad_classes(slots, max_tokens: int) -> list:
    """The pad classes a paged pool's step can take while no request
    needs more than ``max_tokens`` positions."""
    return sorted({slots._pad_class(n) for n in range(
        slots._n_dirty_cap, max(slots._n_dirty_cap,
                                slots.pages_needed(max_tokens)) + 1)})


def _warm_every_key(ms, sampled_too: bool, max_tokens: int) -> None:
    """Capture every graph a load whose requests need at most
    ``max_tokens`` positions can reach, with all slots idle: each window
    (1, 2, 4, 8), the greedy body (and the sampled one), and on a paged
    pool every pad class up to that need (forced through an idle slot's
    reserved width, restored after)."""
    slots = ms.engine.slots
    bodies = (False, True) if sampled_too else (False,)
    classes = [None]
    if slots.paged:
        classes = _pad_classes(slots, max_tokens)
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
               warm_requests=8, name="gpt2-medium", idle_share=True,
               **server_kw):
    """bf16 over HTTP (``make_server`` on port 0), 8 slots, prefill chunk
    256, window 8: a warm-up of ``warm_requests`` requests (8 warm the
    process's GEMM and prefill shapes; 1 allocates a later server's
    pool) and every graph key, then all
    ``bodies`` from 16 client threads: tok/s, latency p50/p99, TTFT p50,
    decode steps, mean window, graph captures (in all, and in the run:
    0 allowed), replays, device busy and idle share (over the first 4
    requests, run again plain and under the profiler), flash launches,
    page stats on a paged pool, the /metrics phase lines
    (``idle_share=False``: no rerun, no busy share).  Returns the
    record and (server, ModelServer, base URL) for the caller to
    close."""
    import threading
    import urllib.request

    from polyaxon_tpu_torch.serving import ModelServer, make_server

    cfg = model.cfg
    ms = ModelServer(model, model_name=name, n_slots=8,
                     prefill_chunk=256, decode_window=8, **server_kw)
    srv = make_server("127.0.0.1", 0, ms)
    server_thread = threading.Thread(target=srv.serve_forever, daemon=True)
    server_thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    split = {}
    t0 = time.perf_counter()
    _load_clients(base, bodies[:warm_requests], warm_requests)
    split["warm-up requests"] = time.perf_counter() - t0
    max_tokens = max(len(b["prompt"]) + b["max_new_tokens"] for b in bodies)
    t0 = time.perf_counter()
    _warm_every_key(ms, sampled_too, max_tokens)
    split["graph captures"] = time.perf_counter() - t0
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
    lens = [len(b["prompt"]) for b in bodies]
    print(f"[http] {label}: {len(bodies)} POST /generate from 16 clients "
          f"({n_sampled}"
          f" sampled; prompts {min(lens)}-{max(lens)}, "
          f"{bodies[0]['max_new_tokens']} new tokens), 8 slots, prefill "
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
        len(_pad_classes(slots, max_tokens)) if slots.paged else 1)
    if captures or rec["captures_total"] > bound:
        raise AssertionError(f"{label}: {rec['captures_total']} graph "
                             f"captures in all (at most {bound}), "
                             f"{captures} after warm-up")
    # Device busy and idle share over a rerun of the first 4 requests
    # (one a client), timed once plain and once under the profiler: a
    # sampled load launches about 460,000 kernels in 32 requests, and
    # the profiler takes about a minute to collect that many.
    split["load"] = wall
    if idle_share:
        sub = bodies[:4]
        t0 = time.perf_counter()
        _load_clients(base, sub, len(sub))
        rec["profiled_wall_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec["busy_ms"] = device_breakdown(
            lambda: _load_clients(base, sub, len(sub)),
            rec["profiled_wall_s"] * 1e3, "http", host=False)
        split["idle-share rerun"] = rec["profiled_wall_s"]
        split["profiled rerun"] = time.perf_counter() - t0
    print(f"[time] {label}: " + ", ".join(f"{k} {v:.1f} s"
                                          for k, v in split.items()))
    if rec.get("busy_ms") is not None:
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

    1. float32 exactness (``_f32_schedule``): 6 concurrent requests,
       half sampled, equal solo decoding; the paged pool (eager and
       lazy) gives the fixed lane's tokens exactly;
    2. bf16 CUDA-graph windows equal eager ones bitwise, for the greedy,
       sampled and paged sampled programs, and their device times
       (``_graph_vs_eager``);
    3. three loads over HTTP (``_http_load``), the same 16 requests
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
    # 6 requests (12 before the zoo's phases joined), for the
    # script's time.
    # float32 exactness at F32_LAYERS layers (PR 17, for time).
    _f32_schedule(_cut_draft(model_f32, "gpt2-medium", F32_LAYERS), n=6)
    print(f"[time] http: float32 schedules {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    step_ms = _graph_vs_eager(model)
    print(f"[time] http: graph vs eager windows "
          f"{time.perf_counter() - t0:.1f} s")
    # 16 requests a load (32 until PR 9): the script's time went to the
    # speculative phases.
    rng = np.random.RandomState(0)
    bodies = [{"prompt": rng.randint(0, model.cfg.vocab_size, n).tolist(),
               "max_new_tokens": 64}
              for n in rng.randint(64, 513, 16)]
    recs = {}
    for label, load, kw in (
            ("greedy fixed-lane", bodies, {}),
            ("mixed fixed-lane", _mixed(bodies),
             {"sampled_too": True, "warm_requests": 1,
              "idle_share": False}),
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
        _release()
    return step_ms, recs


# -- the prefix cache and fault containment ----------------------------------


def _tie_or_raise(model_f32, tag, what, prompt, want, got, spec, row=0):
    """Tokens ``got`` leave ``want`` (both a float32 run's): allowed only
    under the tie rule — the solo float32 top-2 gap (of the logits, or
    of the shaped logits + noise of a sampled draw) at the first
    difference below 1e-4 — and printed; otherwise raise."""
    if spec is not None and spec.get("temperature"):
        k, gap = _sampled_gap(model_f32, prompt, want, got, spec["seed"],
                              spec, row=row)
    else:
        k, gap = _first_gap(model_f32, prompt, want, got)
    print(f"[{tag}] tie rule used: {what} (prompt {len(prompt)}) leaves "
          f"the reference run at new token {k}, solo float32 top-2 gap "
          f"{gap:.3e} (limit 1e-4)")
    if gap >= 1e-4:
        raise AssertionError(f"{tag}: {what} tokens differ at new token "
                             f"{k} (top-2 gap {gap:.3e})")


def _same_tokens(model_f32, tag, bodies, want, got) -> int:
    """Hold a float32 run's tokens (per row) against a reference run's:
    equal, or a tie by the rule; returns the number of ties."""
    ties = 0
    for i, (body, w_rows, g_rows) in enumerate(zip(bodies, want, got)):
        prompts = body["prompt"]
        if not isinstance(prompts[0], list):
            prompts = [prompts]
        for row, (p, w, g) in enumerate(zip(prompts, w_rows, g_rows)):
            if w != g:
                spec = body if body.get("temperature") else None
                _tie_or_raise(model_f32, tag, f"request {i} row {row}", p,
                              w, g, spec, row=row)
                ties += 1
    return ties


def _post_json(base, path, body, rid=None):
    """(HTTP status, JSON body) of one POST; error statuses returned."""
    import urllib.error
    import urllib.request

    headers = {"Content-Type": "application/json"}
    if rid is not None:
        headers["X-Request-Id"] = rid
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _serve(model, name, **server_kw):
    """A ``ModelServer`` behind ``make_server`` on port 0 (8 slots,
    window 8): (server, ModelServer, base URL)."""
    import threading

    from polyaxon_tpu_torch.serving import ModelServer, make_server

    ms = ModelServer(model, model_name=name,
                     **{"n_slots": 8, "decode_window": 8, **server_kw})
    srv = make_server("127.0.0.1", 0, ms)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, ms, f"http://127.0.0.1:{srv.server_address[1]}"


def _stop(srv, ms):
    srv.shutdown()
    srv.server_close()
    ms.close()


def _prefix_traffic(cfg, n: int = 32, new: int = 64, seed: int = 1):
    """A 512-token system prompt; ``n`` requests of it plus 16-64 tokens
    of their own (``new`` new tokens each, every odd one sampled: T 0.8,
    top-k 50, top-p 0.95, seed = index); one 2-row sampled request of it
    plus 24 tokens a row (the solo hit path)."""
    rng = np.random.RandomState(seed)
    sys_p = rng.randint(0, cfg.vocab_size, 512).tolist()
    bodies = _mixed([{"prompt": sys_p + rng.randint(0, cfg.vocab_size,
                                                    k).tolist(),
                      "max_new_tokens": new}
                     for k in rng.randint(16, 65, n)])
    own = rng.randint(0, cfg.vocab_size, (2, 24))
    two = {"prompt": [sys_p + own[0].tolist(), sys_p + own[1].tolist()],
           "max_new_tokens": new, **SAMPLED, "seed": 99}
    return sys_p, bodies, two


def _prefix_load(base, ms, label, sys_p, bodies, two, register: bool):
    """One load against a warm server: (with ``register``) POST /prefill
    of the system prompt (in 2 rows too, for ``two``), then ``bodies``
    from 8 clients
    and ``two`` (if any) alone.  Returns its record: tokens per request
    and row, prefill tokens computed (registration included), hits,
    TTFT p50 / p99, captures in the run (0 allowed), flash launches,
    and on a paged pool the peak pages in use and shared."""
    import threading

    registered = ([sys_p] + ([[sys_p, sys_p]] if two else [])) \
        if register else []
    for prompt in registered:
        code, out = _post_json(base, "/prefill", {"prompt": prompt})
        if code != 200:
            raise AssertionError(f"{label}: /prefill -> {code} {out}")
    slots = ms.engine.slots
    peak = {"in_use": 0, "shared": 0, "running": True}

    def watch_pages():
        # Host-side page counters only (10 ms polls, no CUDA call).
        while peak["running"]:
            st = slots.page_stats()
            peak["in_use"] = max(peak["in_use"],
                                 st["kv_pages"] - st["kv_pages_free"])
            peak["shared"] = max(peak["shared"], st["kv_pages_shared"])
            time.sleep(0.01)

    watcher = threading.Thread(target=watch_pages, daemon=True)
    if slots.paged:
        watcher.start()
    caps0 = ms.recompile.snapshot()["compile_cache_misses"]
    hits0 = ms.prefix_hits
    _zero_counts()
    wall, results = _load_clients(base, bodies, 8)
    two_res = None
    if two is not None:
        code, two_res = _post_json(base, "/generate", two)
        if code != 200:
            raise AssertionError(f"{label}: 2-row request -> {code}")
    counts = _counts()
    peak["running"] = False
    if slots.paged:
        watcher.join()
    caps = ms.recompile.snapshot()["compile_cache_misses"] - caps0
    resps = [r for _, r in results] + ([two_res] if two_res else [])
    reqs = bodies + ([two] if two else [])
    computed = len(sys_p) * (1 + 2 * (len(registered) > 1)) \
        * bool(registered) + sum(
        (len(b["prompt"][0]) if isinstance(b["prompt"][0], list)
         else len(b["prompt"])) * len(r["new_tokens"])
        - r.get("prefix_hit_len", 0) * len(r["new_tokens"])
        for b, r in zip(reqs, resps))
    ttft = sorted(r["ttft_ms"] for _, r in results)
    prefill = sorted(r["prefill_ms"] for _, r in results)
    rec = {"label": label, "tokens": [r["new_tokens"] for r in resps],
           "prefill_tokens": computed, "hits": ms.prefix_hits - hits0,
           "ttft_p50_ms": ttft[len(ttft) // 2],
           "ttft_p99_ms": ttft[min(len(ttft) - 1, int(0.99 * len(ttft)))],
           "prefill_p50_ms": prefill[len(prefill) // 2],
           "wall_s": wall, "captures_in_run": caps,
           "flash_launches": counts}
    if slots.paged:
        rec["pages_in_use_peak"] = peak["in_use"]
        rec["pages_shared_peak"] = peak["shared"]
        rec["kv_pages"] = slots.n_pages
    print(f"[prefix] {label}: {len(results)} requests from 8 clients"
          + (" + the 2-row request" if two else "")
          + f" in {wall:.2f} s; prefill tokens computed "
          f"{rec['prefill_tokens']}, hits {rec['hits']}; TTFT p50 "
          f"{rec['ttft_p50_ms']:.1f} ms p99 {rec['ttft_p99_ms']:.1f} ms, "
          f"engine prefill p50 {rec['prefill_p50_ms']:.1f} ms; "
          f"captures in the run {caps}; flash launches {counts}"
          + (f"; pages in use peak {peak['in_use']} of {slots.n_pages}, "
             f"shared peak {peak['shared']}" if slots.paged else ""))
    if caps:
        raise AssertionError(f"{label}: {caps} graph captures in the run")
    if any(counts.values()):
        raise AssertionError(f"{label}: flash launches {counts}")
    return rec


PREFIX_POOLS = (("fixed-lane", {}),
                ("paged", {"kv_paged": True, "kv_page_tokens": 64}))
# The bf16 cold/warm loads run on the paged pool alone, to bound the
# script's time (PERF.md keeps both pools' earlier numbers).
PREFIX_BF16_POOLS = ("paged",)


def _warm_server(base, ms, cfg, max_tokens: int) -> None:
    """One unrelated request (the process's prefill and GEMM shapes),
    then every graph key a load up to ``max_tokens`` positions reaches."""
    rng = np.random.RandomState(7)
    _load_clients(base, [{"prompt": rng.randint(0, cfg.vocab_size,
                                                560).tolist(),
                          "max_new_tokens": 8}], 1)
    _warm_every_key(ms, True, max_tokens)


def phase_prefix_cache(model, model_f32, name="gpt2-medium"):
    """The radix prefix cache on GPT-2 medium at full width, both pools:
    a 512-token system prompt registered by POST /prefill, 8 requests
    extending it (8 clients, 64 new tokens, half sampled; 32 until the
    fleet phase needed the time, then 16) and one 2-row request
    (the solo hit path).

    - float32, at ``F32_LAYERS`` layers: a server with the cache off and
      one with it on (4 entries) give the same tokens, greedy and
      sampled alike (the tie rule for a float32 difference);
    - bf16, one warm server on each of ``PREFIX_BF16_POOLS``: the same
      load cold (nothing registered) and warm; prefill tokens computed,
      hits, TTFT p50 / p99, peak pages in use and shared, and the warm
      tokens' agreement with the cold ones.
    Returns the bf16 records and the flash launches (0) of every
    pool."""
    cfg = model.cfg
    # 8 requests (16 before the zoo's phases joined), for the
    # script's time.
    sys_p, bodies, two = _prefix_traffic(cfg, n=8)
    max_tokens = max(len(b["prompt"]) + b["max_new_tokens"] for b in bodies)
    f32 = _cut_draft(model_f32, name, F32_LAYERS)
    out = {}
    for pool, kw in PREFIX_POOLS:
        t0 = time.perf_counter()
        runs = {}
        for cache in (0, 4):
            srv, ms, base = _serve(f32, name, prefix_cache=cache, **kw)
            try:
                _warm_server(base, ms, cfg, max_tokens)
                runs[cache] = _prefix_load(
                    base, ms, f"float32 {pool} prefix_cache={cache}",
                    sys_p, bodies, two, register=bool(cache))
            finally:
                _stop(srv, ms)
            _release()
        ties = _same_tokens(f32, "prefix", bodies + [two],
                            runs[0]["tokens"], runs[4]["tokens"])
        print(f"[prefix] float32 {pool} ({F32_LAYERS} layers): "
              f"prefix_cache=4 == prefix_cache=0 "
              f"on all {len(bodies)} requests + 2 rows ({len(bodies) // 2} "
              f"greedy, {len(bodies) // 2} sampled + the sampled 2-row), "
              f"{ties} by the tie rule; hits {runs[4]['hits']}")
        if runs[4]["hits"] != len(bodies) + 1:
            raise AssertionError(f"float32 {pool}: {runs[4]['hits']} hits, "
                                 f"expected {len(bodies) + 1}")
        print(f"[time] prefix: float32 {pool} {time.perf_counter() - t0:.1f} s")
        if pool not in PREFIX_BF16_POOLS:
            # The cache-on run's launches stand for the pool's.
            out[pool] = {"warm": {"flash_launches":
                                  runs[4]["flash_launches"]}}
            continue
        t0 = time.perf_counter()
        srv, ms, base = _serve(model, name, **kw)
        try:
            _warm_server(base, ms, cfg, max_tokens)
            cold = _prefix_load(base, ms, f"bf16 {pool} cold", sys_p,
                                bodies, two, register=False)
            warm = _prefix_load(base, ms, f"bf16 {pool} warm", sys_p,
                                bodies, two, register=True)
        finally:
            _stop(srv, ms)
        _release()
        rows = [(c, w) for cr, wr in zip(cold["tokens"], warm["tokens"])
                for c, w in zip(cr, wr)]
        agree = sum(c == w for c, w in rows)
        print(f"[prefix] bf16 {pool}: warm == cold on {agree} of "
              f"{len(rows)} rows; prefill tokens computed cold "
              f"{cold['prefill_tokens']} warm {warm['prefill_tokens']}; "
              f"TTFT p50 cold {cold['ttft_p50_ms']:.1f} warm "
              f"{warm['ttft_p50_ms']:.1f} ms, p99 cold "
              f"{cold['ttft_p99_ms']:.1f} warm {warm['ttft_p99_ms']:.1f} "
              f"ms; engine prefill p50 cold {cold['prefill_p50_ms']:.1f} "
              f"warm {warm['prefill_p50_ms']:.1f} ms")
        if warm["hits"] != len(bodies) + 1 or cold["hits"]:
            raise AssertionError(f"bf16 {pool}: hits cold {cold['hits']} "
                                 f"warm {warm['hits']}")
        out[pool] = {"cold": {k: v for k, v in cold.items()
                              if k != "tokens"},
                     "warm": {k: v for k, v in warm.items()
                              if k != "tokens"},
                     "bf16_rows_agree": agree, "rows": len(rows)}
        print(f"[time] prefix: bf16 {pool} {time.perf_counter() - t0:.1f} s")
    print(f"[prefix] record {json.dumps(out)}")
    return out


def phase_llama_prefix(model_f32):
    """TinyLlama-1.1B's width, float32 at ``LLAMA_F32_LAYERS`` layers of
    its own weights, paged pool (64-token pages): 4 requests
    over a 512-token prefix (16-64 own tokens, 32 new, half sampled)
    with the cache off and with it on after POST /prefill: the same
    tokens (RoPE'd keys at num_kv_heads materialized from the pages, the
    suffix rotated from position 512), 4 hits, no flash launch."""
    model_f32 = _cut_draft(model_f32, LLAMA, LLAMA_F32_LAYERS)
    cfg = model_f32.cfg
    # 4 requests (8 before the zoo's phases joined), for the
    # script's time.
    sys_p, bodies, _ = _prefix_traffic(cfg, n=4, new=32, seed=2)
    max_tokens = max(len(b["prompt"]) + b["max_new_tokens"] for b in bodies)
    kw = dict(PREFIX_POOLS[1][1])
    runs = {}
    for cache in (0, 4):
        srv, ms, base = _serve(model_f32, LLAMA, prefix_cache=cache, **kw)
        try:
            _warm_server(base, ms, cfg, max_tokens)
            runs[cache] = _prefix_load(
                base, ms, f"llama float32 paged prefix_cache={cache}",
                sys_p, bodies, None, register=bool(cache))
        finally:
            _stop(srv, ms)
        _release()
    ties = _same_tokens(model_f32, "prefix", bodies, runs[0]["tokens"],
                        runs[4]["tokens"])
    if runs[4]["hits"] != len(bodies):
        raise AssertionError(f"llama prefix: {runs[4]['hits']} hits")
    print(f"[prefix] llama float32 paged ({LLAMA_F32_LAYERS} layers): "
          f"prefix_cache=4 == prefix_cache=0 "
          f"on all {len(bodies)} requests ({ties} by the tie rule); hits "
          f"{runs[4]['hits']}, prefill tokens computed "
          f"{runs[0]['prefill_tokens']} -> {runs[4]['prefill_tokens']}")
    return {k: {kk: vv for kk, vv in v.items() if kk != "tokens"}
            for k, v in runs.items()}


def _fault_load(base, bodies):
    """``bodies`` from 8 clients, request i sent with X-Request-Id
    ``req-i``: [(HTTP status, response)] in body order."""
    import threading

    out = [None] * len(bodies)

    def go(i):
        out[i] = _post_json(base, "/generate", bodies[i], rid=f"req-{i}")

    threads = [threading.Thread(target=go, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def _arm(ms, plan):
    from polyaxon_tpu_torch.serving.faults import FaultPlan

    ms.faults = ms.engine.faults = FaultPlan.load(plan) if plan else None
    return ms.faults


def phase_faults(model_f32, name="gpt2-medium"):
    """Fault containment on GPT-2 medium, float32: 8 concurrent requests
    (prompts of 64-256 tokens, 48 new, half sampled) over HTTP, the
    fault-free run first, then three seeded plans:

    1. fixed lane, a transient ``step`` fault firing twice: 2 retries,
       every request equal to the fault-free run;
    2. fixed lane, a ``poisoned`` step fault on request 3 (X-Request-Id
       ``req-3``): it alone gets a 500 ``poisoned_request``, the other 7
       equal the fault-free run after bisection requeued them;
    3. paged pool with a stored prefix, one ``engine_death``: the
       supervisor restarts the engine (residents requeued), all 8 equal
       the fault-free run, the paged prefix index is flushed, a new
       /prefill registers again and hits, and the same 8 requests after
       the restart capture no graph (the pools were reset in place).
    Every mismatch raises (the tie rule for a float32 difference).  At
    ``F32_LAYERS`` layers of the model's own weights since PR 17."""
    import threading

    model_f32 = _cut_draft(model_f32, name, F32_LAYERS)
    cfg = model_f32.cfg
    rng = np.random.RandomState(2)
    bodies = _mixed([{"prompt": rng.randint(0, cfg.vocab_size, n).tolist(),
                      "max_new_tokens": 48}
                     for n in rng.randint(64, 257, 8)])
    max_tokens = max(len(b["prompt"]) + 48 for b in bodies)
    out = {}
    t0 = time.perf_counter()
    srv, ms, base = _serve(model_f32, name)
    try:
        _warm_server(base, ms, cfg, max_tokens)
        _zero_counts()
        ref = _fault_load(base, bodies)
        if any(code != 200 for code, _ in ref):
            raise AssertionError(f"fault-free run: {[c for c, _ in ref]}")
        ref = [r["new_tokens"] for _, r in ref]
        plan = _arm(ms, {"seed": 11, "faults": [
            {"site": "step", "kind": "transient", "after": 4,
             "times": 2}]})
        before = ms.engine.stats()
        got = _fault_load(base, bodies)
        st = ms.engine.stats()
        if any(code != 200 for code, _ in got):
            raise AssertionError(f"transient: {[c for c, _ in got]}")
        ties = _same_tokens(model_f32, "faults", bodies, ref,
                            [r["new_tokens"] for _, r in got])
        retries = st["step_retries_total"] - before["step_retries_total"]
        print(f"[faults] transient step fault x2 (fixed lane): "
              f"{plan.injected_total} injected, {retries} retries, "
              f"convictions {st['poisoned_total']}, crashes "
              f"{st['engine_crashes_total']}; all 8 == the fault-free run "
              f"({ties} by the tie rule)")
        if retries != 2 or st["poisoned_total"] or st["engine_crashes_total"]:
            raise AssertionError(f"transient plan: {retries} retries, {st}")
        out["transient"] = {"retries": retries, "ties": ties}
        _arm(ms, {"seed": 12, "faults": [
            {"site": "step", "kind": "poisoned", "rid": "req-3"}]})
        before = ms.engine.stats()
        got = _fault_load(base, bodies)
        st = ms.engine.stats()
        _arm(ms, None)
        codes = [c for c, _ in got]
        if codes[3] != 500 or got[3][1].get("reason") != "poisoned_request":
            raise AssertionError(f"poisoned request: {got[3]}")
        if any(c != 200 for i, c in enumerate(codes) if i != 3):
            raise AssertionError(f"poisoned plan: innocents {codes}")
        keep = [i for i in range(8) if i != 3]
        ties = _same_tokens(model_f32, "faults", [bodies[i] for i in keep],
                            [ref[i] for i in keep],
                            [got[i][1]["new_tokens"] for i in keep])
        requeued = (st["requests_requeued_total"]
                    - before["requests_requeued_total"])
        print(f"[faults] poisoned step fault on req-3 (fixed lane): 500 "
              f"{got[3][1]['reason']}; convictions "
              f"{st['poisoned_total'] - before['poisoned_total']}, "
              f"innocents requeued by bisection {requeued}; the other 7 == "
              f"the fault-free run ({ties} by the tie rule)")
        out["poisoned"] = {"requeued": requeued, "ties": ties}
        counts = _counts()
    finally:
        _stop(srv, ms)
    _release()
    print(f"[time] faults: fixed lane {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # The lock sanitizer rides this server (_lock_cross_check): HTTP
    # threads, graph captures under slots._CAPTURE_LOCK and a supervised
    # restart all take the wrapped locks.
    out["locks_report"] = os.path.join(
        tempfile.mkdtemp(prefix="ptpu_locks_"), "faults.json")
    srv, ms, base = _serve(model_f32, name, kv_paged=True,
                           kv_page_tokens=64, sanitize=True,
                           sanitize_report=out["locks_report"])
    sys_p = np.random.RandomState(3).randint(0, cfg.vocab_size,
                                             300).tolist()
    try:
        _warm_server(base, ms, cfg, max_tokens)
        code, _ = _post_json(base, "/prefill", {"prompt": sys_p})
        if code != 200 or ms.info()["prefix_entries"] != 1:
            raise AssertionError(f"/prefill -> {code}")
        warm = ms.recompile.snapshot()["compile_cache_misses"]
        before = ms.engine.stats()
        _zero_counts()
        # Armed once the load is resident (host-side reads), so the
        # death lands mid-run whatever the host's speed.
        got = [None]
        load = threading.Thread(
            target=lambda: got.__setitem__(0, _fault_load(base, bodies)))
        load.start()
        deadline = time.monotonic() + 120
        while len(ms.engine._resident) < 4:
            if time.monotonic() > deadline or not load.is_alive():
                raise AssertionError("engine death: the load never "
                                     "became resident")
            time.sleep(0.001)
        plan = _arm(ms, {"seed": 13, "faults": [
            {"site": "engine_death", "times": 1}]})
        load.join()
        got = got[0]
        st = ms.engine.stats()
        _arm(ms, None)
        if any(c != 200 for c, _ in got):
            raise AssertionError(f"engine death: {[c for c, _ in got]}")
        ties = _same_tokens(model_f32, "faults", bodies, ref,
                            [r["new_tokens"] for _, r in got])
        requeued = (st["requests_requeued_total"]
                    - before["requests_requeued_total"])
        entries = ms.info()["prefix_entries"]
        if st["engine_restarts_total"] != 1 or not requeued or entries:
            raise AssertionError(f"engine death: restarts "
                                 f"{st['engine_restarts_total']}, "
                                 f"requeued {requeued}, prefix entries "
                                 f"{entries} after the flush")
        caps_run = ms.recompile.snapshot()["compile_cache_misses"] - warm
        code, _ = _post_json(base, "/prefill", {"prompt": sys_p})
        code2, hit = _post_json(base, "/generate", {
            "prompt": sys_p + [1, 2, 3], "max_new_tokens": 8})
        if code != 200 or code2 != 200 \
                or hit.get("prefix_hit_len") != len(sys_p):
            raise AssertionError(f"re-register after the flush: {code} "
                                 f"{code2} {hit.get('prefix_hit_len')}")
        again = _fault_load(base, bodies)
        caps_after = ms.recompile.snapshot()["compile_cache_misses"] - warm
        if caps_after or any(c != 200 for c, _ in again):
            raise AssertionError(f"after the restart: {caps_after} graph "
                                 f"captures once warm")
        counts2 = _counts()
        print(f"[faults] engine death on the paged pool with a stored "
              f"prefix: {plan.injected_total} injected, crashes "
              f"{st['engine_crashes_total']}, restarts "
              f"{st['engine_restarts_total']} (recovery "
              f"{ms.supervisor.last_recovery_s} s), streams requeued "
              f"{requeued}; all 8 == the fault-free run ({ties} by the tie "
              f"rule); prefix index flushed (entries 0), /prefill again and "
              f"a hit of {hit['prefix_hit_len']} tokens; graph captures "
              f"after warm-up: {caps_run} in the crash run, {caps_after} "
              f"after the restart")
        out["engine_death"] = {"requeued": requeued, "ties": ties,
                               "recovery_s": ms.supervisor.last_recovery_s,
                               "captures_after_restart": caps_after}
    finally:
        _stop(srv, ms)
    _release()
    print(f"[time] faults: paged engine death {time.perf_counter() - t0:.1f} s")
    launches = {k: counts[k] + counts2[k] for k in counts}
    if any(launches.values()):
        raise AssertionError(f"faults: flash launches {launches}")
    out["flash_launches"] = launches
    return out


# -- speculative and beam decoding -------------------------------------------

SPEC_K = 4
# Depth of the float32 exactness checks that compare paths of one model
# against each other (the cache off / on, int8 engine / solo, the spec
# engine / solo): their result does not depend on the depth, and since
# PR 17 they run at a cut of the model's own weights, for the script's
# time (full depth until then).  The bf16 timings stay at full depth.
F32_LAYERS = 2              # of GPT-2 medium's 24, for the script's time
SPEC_F32_LAYERS = 6         # the spec target (8 until PR 21); its draft is a 4-layer cut
LLAMA_F32_LAYERS = 4        # of TinyLlama's 22


def _cut_draft(model, name: str, layers: int):
    """A draft cut from ``model``'s own weights: its embeddings, its
    first ``layers`` blocks and its final norm (and head), in its
    dtype on its device."""
    from polyaxon_tpu_torch.models.registry import get_model

    draft = get_model(name).make_model(device=model.device,
                                       dtype=model.cfg.dtype,
                                       num_layers=layers)
    keep = {k: v for k, v in model.state_dict().items()
            if not k.startswith("h.") or int(k.split(".")[1]) < layers}
    draft.load_state_dict(keep, strict=True)
    return draft.eval().requires_grad_(False)


def _spec_bodies(cfg, seed: int = 5):
    """8 requests of 64-256 prompt tokens and 24 new (fewer for time; 40 before
    the zoo's phases joined the script):
    4 speculative greedy, 2 speculative sampled (T 0.8, top-k 50, top-p
    0.95, seed = index), 1 plain greedy and 1 plain sampled."""
    rng = np.random.RandomState(seed)
    bodies = []
    for i, n in enumerate(rng.randint(64, 257, 8)):
        body = {"prompt": rng.randint(0, cfg.vocab_size, n).tolist(),
                "max_new_tokens": 24}
        if i < 6:
            body.update(speculative=True, spec_k=SPEC_K)
        if i in (4, 5, 7):
            body.update(SAMPLED, seed=i)
        bodies.append(body)
    return bodies


def _spec_solo(model_f32, draft_f32, body):
    """A request's solo float32 run: ``generate_speculative`` (seed mode
    when sampled), ``generate`` or ``generate_positional``."""
    from polyaxon_tpu_torch.models import generate as G

    p, new = [body["prompt"]], body["max_new_tokens"]
    samp = {k: body[k] for k in ("temperature", "top_k", "top_p")
            if k in body}
    if body.get("speculative"):
        out = G.generate_speculative(
            model_f32, draft_f32, p, max_new_tokens=new, k=body["spec_k"],
            seed=body.get("seed") if samp else None, **samp)
    elif samp:
        out = G.generate_positional(model_f32, p, max_new_tokens=new,
                                    seed=body["seed"], **samp)
    else:
        out = G.generate(model_f32, p, max_new_tokens=new)
    return out[0, len(body["prompt"]):].tolist()


def _warm_spec_keys(ms, max_tokens: int) -> None:
    """Capture every graph a mixed speculative load can reach (all slots
    idle): each window (1, 2, 4, 8), the plain and the speculative
    programs (K = ``SPEC_K``), greedy and sampled, and on a paged pool
    every pad class up to ``max_tokens`` positions."""
    slots = ms.engine.slots
    classes = _pad_classes(slots, max_tokens) if slots.paged else [None]
    with ms._lock:
        for P in classes:
            if P is not None:
                slots._slot_need[0] = P
            for w in (1, 2, 4, 8):
                for sampled in (False, True):
                    slots.step(w, sampled)
                    slots.step_spec(w, SPEC_K, sampled)
        if slots.paged:
            slots._slot_need[0] = 0
    torch.cuda.synchronize()


def _spec_engine_runs(model_f32, draft_f32, bodies, solo, draft_label,
                      pools=("fixed-lane", "paged"),
                      warm_keys=("fixed-lane",)):
    """float32 ``ModelServer`` with the draft, 8 slots: the 8 bodies
    concurrently on each of ``pools`` after a warm-up request (and, on
    the pools in ``warm_keys``, every graph key: then no capture may
    happen in the run — a paged pool's 48 keys take 26 s to capture, so
    by default it captures what the run needs); every request equals
    its solo run (tie rule for greedy), paged == fixed lane exactly.
    Returns the spec counters of the fixed-lane run."""
    from polyaxon_tpu_torch.serving import ModelServer

    max_tokens = max(len(b["prompt"]) + b["max_new_tokens"]
                     for b in bodies) + SPEC_K
    runs, counters = {}, {}
    for label, kw in (("fixed-lane", {}), ("paged", {"kv_paged": True})):
        if label not in pools:
            continue
        ms = ModelServer(model_f32, model_name="gpt2-medium", n_slots=8,
                         prefill_chunk=64, decode_window=8,
                         draft_model=draft_f32, spec_k=SPEC_K, **kw)
        try:
            t0 = time.perf_counter()
            ms.generate(dict(bodies[0], max_new_tokens=8))
            if label in warm_keys:
                _warm_spec_keys(ms, max_tokens)
            warm = ms.recompile.snapshot()["compile_cache_misses"]
            st0 = ms.engine.stats()
            t1 = time.perf_counter()
            got, secs = _concurrent(ms, [dict(b) for b in bodies])
            st = ms.engine.stats()
            captures = st["compile_cache_misses"] - warm
        finally:
            ms.close()
        runs[label] = [g["new_tokens"][0] for g in got]
        counters[label] = {k: st[k] - st0[k] for k in (
            "spec_rounds_total", "spec_drafted_total",
            "spec_accepted_total", "decode_steps_total",
            "decode_dispatches_total")}
        c = counters[label]
        n_spec = sum(1 for b in bodies if b.get("speculative"))
        n_samp = sum(1 for b in bodies if b.get("speculative")
                     and b.get("temperature"))
        print(f"[spec] float32 engine, draft {draft_label}, {label} "
              f"pool, 8 slots: {len(bodies)} requests ({n_spec - n_samp} "
              f"spec greedy, {n_samp} spec sampled, "
              f"{len(bodies) - n_spec} plain; spec_k "
              f"{sorted({b['spec_k'] for b in bodies if 'spec_k' in b})};"
              f" prompts "
              f"{min(len(b['prompt']) for b in bodies)}-"
              f"{max(len(b['prompt']) for b in bodies)}, "
              f"{max(b['max_new_tokens'] for b in bodies)} new) in "
              f"{secs:.2f} s (warm-up {t1 - t0:.1f} s, {warm} graph "
              f"captures); spec rounds {c['spec_rounds_total']}, drafted "
              f"{c['spec_drafted_total']}, accepted "
              f"{c['spec_accepted_total']} (acceptance "
              f"{c['spec_accepted_total'] / max(1, c['spec_drafted_total']):.3f}"
              f"), {c['decode_dispatches_total']} dispatches; captures "
              f"in the run {captures}")
        if captures and label in warm_keys:
            raise AssertionError(f"spec engine {label}: {captures} graph "
                                 f"captures after warm-up")
    # Sampled speculative requests are held exactly (their draws are
    # keyed by token index and lane); the rest under the tie rule.
    got = runs["fixed-lane"]
    bad = [i for i, b in enumerate(bodies)
           if b.get("speculative") and b.get("temperature")
           and got[i] != solo[i]]
    if bad:
        raise AssertionError(f"spec engine: sampled spec requests {bad} "
                             f"!= generate_speculative's seed mode")
    rest = [i for i in range(len(bodies)) if not (
        bodies[i].get("speculative") and bodies[i].get("temperature"))]
    ties = _same_tokens(model_f32, "spec", [bodies[i] for i in rest],
                        [[solo[i]] for i in rest], [[got[i]] for i in rest])
    bad = [i for i in range(len(bodies)) if "paged" in runs
           and runs["paged"][i] != runs["fixed-lane"][i]]
    if bad:
        raise AssertionError(f"spec engine: paged tokens != fixed lane "
                             f"for requests {bad}")
    print(f"[spec] float32 engine, draft {draft_label}, == solo for all "
          f"{len(bodies)} requests ({len(bodies) - ties} exactly, {ties} "
          f"by the tie "
          f"rule; the sampled spec requests equal generate_speculative's"
          f" seed mode)"
          + (", paged == fixed lane exactly" if "paged" in runs else ""))
    return counters["fixed-lane"]


def _spec_step_ms(model, draft, label: str, sampled_body: bool) -> dict:
    """bf16, 8 slots filled (prompts of 64-256 tokens, all speculative
    greedy with K = ``SPEC_K``): the W = 1 and W = 8 spec windows and the
    plain greedy windows as graph replays (ms), with ``sampled_body``
    the W = 1 window of the body with the sampling lanes too, and the
    acceptance of ``draft`` over 4 W = 8 windows from the filled
    state."""
    from polyaxon_tpu_torch.models import generate as G
    from polyaxon_tpu_torch.serving.slots import SlotKVManager

    cfg = model.cfg
    lengths = np.random.RandomState(7).randint(64, 257, 8)
    pool = SlotKVManager(model, 8, max_window=8, draft_model=draft,
                         spec_k_cap=SPEC_K)
    for s, n in enumerate(lengths):
        toks = torch.as_tensor(np.random.RandomState(20 + s).randint(
            0, cfg.vocab_size, (1, n)), device="cuda")
        logits, cache = G.prefill(model, toks)
        _, dcache = G.prefill(draft, toks)
        pool.acquire()
        pool.insert(s, cache, int(torch.argmax(logits[0])), int(n),
                    base_key=np.zeros(2, np.int64), draft_cache=dcache,
                    spec_k=SPEC_K)
        del cache, dcache
    host = {k: getattr(pool, k).copy()
            for k in ("tokens", "positions", "next_index")}
    kv = [t.clone() for t in (pool._k, pool._v, pool._dk, pool._dv)]

    def restore():
        for k, v in host.items():
            setattr(pool, k, v.copy())
        for dst, src in zip((pool._k, pool._v, pool._dk, pool._dv), kv):
            dst.copy_(src)

    rec = {}
    for w in (1, 8):
        restore()
        pool.step_spec(w, SPEC_K)
        rec[f"spec W={w}"] = _replay_ms(pool, (w, "spec", SPEC_K, False),
                                        restore)
        restore()
        pool.step(w, False)
        rec[f"plain W={w}"] = _replay_ms(pool, (w, False), restore)
    if sampled_body:
        # The body with the sampling lanes, on the same greedy slots
        # (W = 1: its capture is long): the same commits, and what the
        # lanes cost.
        restore()
        greedy_body = pool.step_spec(1, SPEC_K)
        restore()
        outs = pool.step_spec(1, SPEC_K, True)
        if not all((a == b).all() for a, b in zip(greedy_body, outs)):
            raise AssertionError(f"draft {label}: the sampled spec "
                                 f"body's greedy lanes != the greedy body")
        rec["spec sampled body W=1"] = _replay_ms(
            pool, (1, "spec", SPEC_K, True), restore)
    restore()
    acc = drafted = commits = 0
    for _ in range(4):
        _, cs, ms_ = pool.step_spec(8, SPEC_K)
        acc += int(ms_.sum())
        commits += int(cs.sum())
        drafted += SPEC_K * cs.size
    rec["acceptance"] = acc / drafted
    rec["tokens_per_round"] = commits / (drafted / SPEC_K)
    print(f"[spec] bf16 8 spec slots (positions {min(lengths)}-"
          f"{max(lengths)}+), draft {label}, K={SPEC_K}: spec window W=1 "
          f"{rec['spec W=1']:.3f} ms, W=8 {rec['spec W=8']:.3f} ms "
          f"({rec['spec W=8'] / 8:.3f} ms a round); plain greedy W=1 "
          f"{rec['plain W=1']:.3f} ms, W=8 {rec['plain W=8']:.3f} ms "
          f"({rec['plain W=8'] / 8:.3f} ms a step); "
          + (f"the sampled spec body W=1 {rec['spec sampled body W=1']:.3f}"
             f" ms on the same greedy slots (same commits); "
             if sampled_body else "") + f"acceptance "
          f"{rec['acceptance']:.3f}, {rec['tokens_per_round']:.2f} "
          f"tokens a slot a round over 32 rounds")
    del pool, kv
    _release()
    return rec


def phase_speculative(model, model_f32):
    """Speculative decoding on GPT-2 medium (the target at full width),
    two drafts made from seeds: gpt2-small (random, so near-zero
    acceptance) and a 4-of-24-layer draft cut from the target's own
    weights (partial acceptance: rows commit different counts in one
    round); K = 4.

    1. solo float32 ``generate_speculative`` == greedy ``generate`` with
       both drafts (tie rule); steps 1 and 2 on a float32 target cut to
       ``SPEC_F32_LAYERS`` layers of its own weights (since PR 17, for
       the script's time), the 4-layer draft cut from that;
    2. the float32 engine on the fixed-lane and the paged pool: 8
       requests (4 spec greedy, 2 spec sampled, 2 plain) each equal to
       its solo run, no graph captured after warm-up (``_spec_engine_
       runs``); then on the fixed-lane pool with the target as its own
       draft (full acceptance), spec_k 4 and 2 mixed and 24 new tokens,
       so rows commit 4, 2 and 1 tokens in one round;
    3. bf16 spec and plain windows' replay times and the cut draft's
       acceptance (``_spec_step_ms``);
    4. HTTP: a bf16 server with the cut draft, 16 requests from 16
       clients, half speculative: tok/s, TTFT p50, the
       ``ptpu_serving_spec_accept_rate`` family from /metrics, flash
       launches.
    Returns the record (with the flash launches of the engine runs and
    of the HTTP load)."""
    import urllib.request

    from polyaxon_tpu_torch.models import generate as G
    from polyaxon_tpu_torch.models.registry import get_model

    rec = {}
    split = {}
    t0 = time.perf_counter()
    model_f32 = _cut_draft(model_f32, "gpt2-medium", SPEC_F32_LAYERS)
    small_f32 = get_model("gpt2-small").init_params(
        seed=1, device="cuda", dtype=torch.float32)
    cut_f32 = _cut_draft(model_f32, "gpt2-medium", 4)
    rng = np.random.RandomState(3)
    ties = 0
    for label, draft in (("gpt2-small", small_f32),
                         ("4-layer cut", cut_f32)):
        for n in (64, 200)[:1 if label == "gpt2-small" else 2]:
            p = rng.randint(0, model_f32.cfg.vocab_size, n).tolist()
            want = G.generate(model_f32, [p], max_new_tokens=64)[
                0, n:].tolist()
            got = G.generate_speculative(model_f32, draft, [p],
                                         max_new_tokens=64, k=SPEC_K)[
                0, n:].tolist()
            if got != want:
                _tie_or_raise(model_f32, "spec", f"solo greedy spec, "
                              f"draft {label}", p, want, got, None)
                ties += 1
    print(f"[spec] float32 solo greedy generate_speculative (K={SPEC_K}, "
          f"{SPEC_F32_LAYERS}-layer target, 64 new; prompt 64 with "
          f"gpt2-small, 64 and 200 with the cut) =="
          f" greedy generate ({3 - ties} exactly, {ties} by the tie rule)")
    split["solo"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    bodies = _spec_bodies(model_f32.cfg)
    solo = [_spec_solo(model_f32, cut_f32, b) for b in bodies]
    _zero_counts()
    rec["engine"] = _spec_engine_runs(model_f32, cut_f32, bodies, solo,
                                      "4-layer cut")
    # The target as its own draft accepts (nearly) every proposal: with
    # spec_k 4 and 2 and plain rows in one pool, rows commit 4, 2 and 1
    # tokens in the same round.
    # Four of the bodies (spec greedy K 4 and 2, plain greedy and
    # sampled; all 8 before the zoo's phases joined, for the
    # script's time).
    self_bodies = [dict(b, spec_k=2, max_new_tokens=24)
                   if b.get("speculative") and i % 2
                   else dict(b, max_new_tokens=24)
                   for i, b in enumerate(bodies) if i in (0, 1, 6, 7)]
    self_solo = [_spec_solo(model_f32, model_f32, b) for b in self_bodies]
    rec["engine_self_draft"] = _spec_engine_runs(
        model_f32, model_f32, self_bodies, self_solo, "= target",
        pools=("fixed-lane",), warm_keys=())
    rec["engine_flash_launches"] = _counts()
    split["engine"] = time.perf_counter() - t0
    del small_f32, cut_f32, model_f32
    _release()
    t0 = time.perf_counter()
    cut = _cut_draft(model, "gpt2-medium", 4)
    # bf16 is held as an agreement share (a K+1-wide verify and a
    # one-token step round apart, and a near tie flips the argmax);
    # the cut draft's rows only (gpt2-small's, a random draft, are
    # left out for the script's time), on the float32 check's prompts.
    rng = np.random.RandomState(3)
    rng.randint(0, model.cfg.vocab_size, 64)    # gpt2-small's prompt
    firsts = []
    for label, draft in (("4-layer cut", cut),):
        for n in (64, 200):
            p = rng.randint(0, model.cfg.vocab_size, n).tolist()
            want = G.generate(model, [p], max_new_tokens=64)[0, n:].tolist()
            got = G.generate_speculative(model, draft, [p],
                                         max_new_tokens=64, k=SPEC_K)[
                0, n:].tolist()
            firsts.append(next((i for i, (a, b) in enumerate(zip(want, got))
                                if a != b), 64))
    rec["bf16_rows_equal"] = sum(f == 64 for f in firsts)
    print(f"[spec] bf16 solo greedy generate_speculative == greedy generate"
          f" on {rec['bf16_rows_equal']} of {len(firsts)} rows (the cut "
          f"draft on the float32 check's prompts; first differing new "
          f"token per row: {firsts}, 64 = none)")
    # gpt2-small's windows are not timed, to bound the script's time
    # (PERF.md keeps their earlier numbers: acceptance 0.000).
    rec["step_ms"] = {"4-layer cut": _spec_step_ms(model, cut,
                                                   "4-layer cut", True)}
    _release()
    split["step times"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rng = np.random.RandomState(11)
    plain = [{"prompt": rng.randint(0, model.cfg.vocab_size, n).tolist(),
              "max_new_tokens": 64} for n in rng.randint(64, 513, 16)]
    load = []
    for i, b in enumerate(plain):
        b = dict(b)
        if i % 2 == 0:
            b.update(speculative=True, spec_k=SPEC_K)
        if i % 4 in (2, 3):
            b.update(SAMPLED, seed=i)
        load.append(b)
    srv, ms, base = _serve(model, "gpt2-medium", prefill_chunk=256,
                           draft_model=cut, spec_k=SPEC_K)
    try:
        _load_clients(base, load[:2], 2)
        _warm_spec_keys(ms, max(len(b["prompt"]) for b in load) + 64
                        + SPEC_K)
        warm = ms.recompile.snapshot()["compile_cache_misses"]
        st0 = ms.engine.stats()
        _zero_counts()
        wall, results = _load_clients(base, load, 16)
        rec["http_flash_launches"] = _counts()
        st = ms.engine.stats()
        captures = st["compile_cache_misses"] - warm
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
    finally:
        _stop(srv, ms)
    ntok = sum(len(r[1]["new_tokens"][0]) for r in results)
    ttft = sorted(r[1]["ttft_ms"] for r in results)
    acc = [line for line in metrics.splitlines()
           if line.startswith("ptpu_serving_spec_accept_rate")]
    if not any(line.startswith("ptpu_serving_spec_accept_rate_count")
               and int(line.split()[-1]) >= 8 for line in acc):
        raise AssertionError(f"/metrics spec accept rate: {acc}")
    bad = [i for i, (_, r) in enumerate(results)
           if len(r["new_tokens"][0]) != 64
           or max(r["new_tokens"][0]) >= model.cfg.vocab_size]
    if bad or captures:
        raise AssertionError(f"spec http: malformed {bad}, captures in "
                             f"the run {captures}")
    d = {k: st[k] - st0[k] for k in ("spec_rounds_total",
                                     "spec_drafted_total",
                                     "spec_accepted_total")}
    rec["http"] = {"requests": 16, "speculative": 8, "new_tokens": ntok,
                   "wall_s": wall, "tok_per_s": ntok / wall,
                   "ttft_p50_ms": ttft[len(ttft) // 2], **d,
                   "captures_in_run": captures}
    print(f"[spec] HTTP bf16, 8 slots, draft 4-layer cut, spec_k "
          f"{SPEC_K}: 16 requests from 16 clients (8 speculative, half "
          f"of each kind sampled; prompts 64-512, 64 new): {ntok} tokens "
          f"in {wall:.3f} s = {ntok / wall:.1f} tok/s, TTFT p50 "
          f"{rec['http']['ttft_p50_ms']:.1f} ms; spec rounds "
          f"{d['spec_rounds_total']}, drafted {d['spec_drafted_total']}, "
          f"accepted {d['spec_accepted_total']}; captures in the run "
          f"{captures}; flash launches {rec['http_flash_launches']}")
    for line in acc:
        print(f"[spec] /metrics {line}")
    split["http"] = time.perf_counter() - t0
    print("[time] speculative: " + ", ".join(f"{k} {v:.1f} s"
                                             for k, v in split.items()))
    print(f"[spec] record {json.dumps(rec)}")
    del cut
    _release()
    return rec


def phase_beam(model_f32):
    """Beam search on GPT-2 medium in float32, 16 new tokens from a
    32-token prompt: ``num_beams`` 4 over HTTP (the server's solo beam
    path) and ``generate --beams 4`` (the CLI's function) equal the
    port's ``generate_beam`` on the same weights moved to the CPU, and
    ``num_beams`` 1 equals greedy ``generate``.  At ``F32_LAYERS``
    layers of the model's own weights since PR 17.  Returns the
    record."""
    from polyaxon_tpu_torch.cli.main import run_generate
    from polyaxon_tpu_torch.models import generate as G
    from polyaxon_tpu_torch.models.registry import get_model

    t0 = time.perf_counter()
    model_f32 = _cut_draft(model_f32, "gpt2-medium", F32_LAYERS)
    p = np.random.RandomState(13).randint(
        0, model_f32.cfg.vocab_size, 32).tolist()
    srv, ms, base = _serve(model_f32, "gpt2-medium")
    _zero_counts()
    try:
        t1 = time.perf_counter()
        st4, r4 = _post_json(base, "/generate", {
            "prompt": p, "max_new_tokens": 16, "num_beams": 4})
        beam_s = time.perf_counter() - t1
        st1, r1 = _post_json(base, "/generate", {
            "prompt": p, "max_new_tokens": 16, "num_beams": 1})
        routing = ms.info()["routing"]["beam"]
    finally:
        _stop(srv, ms)
    launches = _counts()
    if st4 != 200 or st1 != 200:
        raise AssertionError(f"beam HTTP: {st4} {r4} / {st1} {r1}")
    cli = run_generate(model_f32, "gpt2-medium", [p], max_new_tokens=16,
                       beams=4)
    greedy = G.generate(model_f32, [p], max_new_tokens=16).tolist()
    cpu = get_model("gpt2-medium").make_model(
        device="cpu", dtype=torch.float32,
        num_layers=model_f32.cfg.num_layers)
    cpu.load_state_dict(model_f32.state_dict())
    cpu.eval().requires_grad_(False)
    t1 = time.perf_counter()
    want = G.generate_beam(cpu, [p], max_new_tokens=16,
                           num_beams=4).tolist()
    cpu_s = time.perf_counter() - t1
    del cpu
    ok = r4["tokens"] == want and cli["tokens"] == want \
        and r1["tokens"] == greedy
    print(f"[beam] float32 ({F32_LAYERS} layers) num_beams=4, 16 new "
          f"tokens, prompt 32: HTTP "
          f"(solo path, routing {routing!r}) {beam_s:.3f} s, generate "
          f"--beams 4 {cli['wall_s']} s, the CPU generate_beam "
          f"{cpu_s:.1f} s: HTTP {'==' if r4['tokens'] == want else '!='} "
          f"CPU, CLI {'==' if cli['tokens'] == want else '!='} CPU; "
          f"num_beams=1 {'==' if r1['tokens'] == greedy else '!='} greedy "
          f"generate; flash launches {launches}")
    if not ok:
        raise AssertionError(f"beam: HTTP {r4['tokens']}, CLI "
                             f"{cli['tokens']}, CPU {want}; num_beams=1 "
                             f"{r1['tokens']} vs greedy {greedy}")
    print(f"[time] beam: {time.perf_counter() - t0:.1f} s")
    _release()
    return {"http_beam4_s": beam_s, "cpu_beam4_s": cpu_s,
            "flash_launches": launches}


def phase_llama_speculative(model_f32):
    """TinyLlama-1.1B, float32: solo greedy ``generate_speculative``
    with a 2-of-22-layer draft cut from its own weights (K = 4, 32 new
    tokens from a 64-token prompt) == greedy ``generate`` (tie rule),
    with the draft's acceptance.  Returns the flash launches."""
    from polyaxon_tpu_torch.models import generate as G

    t0 = time.perf_counter()
    draft = _cut_draft(model_f32, LLAMA, 2)
    p = np.random.RandomState(17).randint(
        0, model_f32.cfg.vocab_size, 64).tolist()
    _zero_counts()
    want = G.generate(model_f32, [p], max_new_tokens=32)[0, 64:].tolist()
    t1 = time.perf_counter()
    got = G.generate_speculative(model_f32, draft, [p], max_new_tokens=32,
                                 k=SPEC_K)[0, 64:].tolist()
    spec_s = time.perf_counter() - t1
    launches = _counts()
    if got != want:
        _tie_or_raise(model_f32, "llama spec", "solo greedy spec", p,
                      want, got, None)
    print(f"[llama] float32 solo greedy generate_speculative, 2-of-22-"
          f"layer cut draft, K={SPEC_K}, 32 new tokens: "
          f"{'==' if got == want else 'tie-rule =='} greedy generate "
          f"({spec_s:.2f} s); flash launches {launches}")
    del draft
    _release()
    print(f"[time] llama speculative: {time.perf_counter() - t0:.1f} s")
    return launches


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


def _check_per_step(counts, steps: int, layers: int, where: str,
                    fwd_passes: int = 1):
    """Each kernel's launches: ``layers`` of dq and of dkv a step, and
    ``fwd_passes * layers`` of the forward (GPT-2 medium: 1; a remat
    model runs each layer's forward again in the backward: 2)."""
    want = {name: steps * layers * (fwd_passes if name == "flash_fwd"
                                    else 1) for name in counts}
    if counts != want:
        raise AssertionError(f"{where}: flash launches {counts}, expected "
                             f"{want} ({fwd_passes} x {layers} forward, "
                             f"{layers} dq and {layers} dkv a step)")


@contextlib.contextmanager
def _train_main(argv):
    """``python -m polyaxon_tpu_torch.train ARGV`` as a user runs it
    (in-process, its run ``chip-smoke`` and checkpoints in a temporary
    home): yields a record of its output lines, its flash launches, its
    seconds, the trained model as ``train.main`` held it, its checkpoint
    directory and the run store, until the home is removed."""
    import io

    from polyaxon_tpu_torch import checkpoint, train
    from polyaxon_tpu_torch.client import FileRunStore

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
                rc = train.main(argv)
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
        lines = out.getvalue().splitlines()
        for line in lines:
            print(f"[train.main] {line}")
        losses = [float(m) for m in re.findall(
            r"^step \d+/\d+ loss=(\S+)", out.getvalue(), re.M)]
        if rc != 0 or not losses or not all(np.isfinite(losses)):
            raise AssertionError(f"train.main: exit {rc}, losses {losses}")
        yield {"lines": lines, "losses": losses, "counts": counts,
               "secs": secs, "model": live.pop("model"),
               "dir": live["dir"], "store": FileRunStore(home),
               "home": home}


def phase_train_entry(name: str = "gpt2-medium", steps: int = 3,
                      batch: int = 8, fwd_passes: int = 1,
                      init_hf_from=None, checkpoint_f32: bool = True):
    """``python -m polyaxon_tpu_torch.train --model NAME`` as a user runs
    it: the flash launch counts of the run (a step: ``fwd_passes``
    forward launches a layer, 2 under remat, and one dq and one dkv),
    and a finite loss on every logged step; then the checkpoint it wrote
    is served (``phase_checkpoint``) before the home is removed.

    ``init_hf_from`` (a state dict): the run starts from ``--init-hf``
    of a file ``export_hf_llama`` wrote from a model holding it
    (``torch.save``, as a user brings an HF checkpoint), with ``--seed
    1`` (the weights are seed 0's, so a random init would differ); its
    first tracked loss must equal the source model's loss on the same
    batch.  ``checkpoint_f32``: serve the checkpoint in float32 too
    (``phase_checkpoint``)."""
    argv = ["--model", name, "--steps", str(steps), "--log-every", "1",
            "--batch-size", str(batch)]
    want = None
    with contextlib.ExitStack() as stack:
        if init_hf_from is not None:
            tmp = stack.enter_context(tempfile.TemporaryDirectory())
            path = os.path.join(tmp, "hf.pt")
            want, export_s = _export_hf_source(name, batch, init_hf_from,
                                               path, seed=1)
            argv += ["--init-hf", path, "--seed", "1"]
        run = stack.enter_context(_train_main(argv))
        counts, secs = run["counts"], run["secs"]
        trained = run["model"].eval()
        if len(run["losses"]) != steps:
            raise AssertionError(f"train.main: {run['losses']}")
        _check_per_step(counts, steps, trained.cfg.num_layers,
                        f"train.main {name}", fwd_passes)
        print(f"[train.main] {name} batch {batch}, {steps} steps in "
              f"{secs:.1f} s (model init, data, steps and the final "
              f"checkpoint); flash launches {counts}")
        if want is not None:
            got = run["store"].read_events("chip-smoke", "metric",
                                           "loss")[0]["value"]
            rel = abs(got - want) / abs(want)
            ok = rel <= 1e-5
            print(f"[zoo] --init-hf round trip: {name} (seed 0's weights)"
                  f" -> export_hf_llama -> torch.save "
                  f"({export_s:.1f} s) -> train.main --init-hf: first step "
                  f"loss {got:.6f} vs the source model's {want:.6f} on the "
                  f"same batch (rel {rel:.2e}, tol 1e-5) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("--init-hf: the first loss is not the "
                                     "source model's")
        phase_checkpoint(run["dir"], trained, name, float32=checkpoint_f32)
    return counts, secs


def _export_hf_source(name, batch, state_dict, path, seed,
                      export="export_hf_llama"):
    """A model holding ``state_dict`` (float32 masters, as ``train.main``
    holds them, with the family's ``--init-hf`` config overrides), its
    loss on the first batch ``train.main --seed SEED`` draws, and
    ``torch.save`` of the ``models.import_hf`` function ``export`` of it
    at ``path``: (the loss, seconds of the export and save)."""
    from polyaxon_tpu_torch import train
    from polyaxon_tpu_torch.models import import_hf
    from polyaxon_tpu_torch.models.registry import get_model

    spec = get_model(name)
    model = spec.make_model(device="cuda", param_dtype=torch.float32,
                            **train._HF_MODEL_KW.get(name.split("-")[0],
                                                     {}))
    model.load_state_dict(state_dict)
    model.train()
    args = train.build_argparser().parse_args(["--model", name, "--seed",
                                               str(seed)])
    first = next(train.make_datasets(args, spec, batch)[0].epoch(0))
    with torch.no_grad():
        want = spec.loss_fn(model)(first)[0].item()
    t0 = time.perf_counter()
    torch.save(getattr(import_hf, export)(model, model.cfg), path)
    secs = time.perf_counter() - t0
    del model
    _release()
    return want, secs


def phase_checkpoint(ckpt_dir, trained, name="gpt2-medium",
                     float32: bool = True):
    """The checkpoint ``train.main`` wrote, served: ``generate
    --checkpoint`` (the CLI, bf16 as served) gives the tokens of the
    in-memory trained model (float32 master weights cast at each use:
    the same bf16 values the served copy holds); with ``float32``, the
    CLI's checkpoint loader in float32 gives the tokens of a float32
    model holding the in-memory weights."""
    import contextlib
    import io

    from polyaxon_tpu_torch.cli import main as cli_main
    from polyaxon_tpu_torch.models import generate as G
    from polyaxon_tpu_torch.models.registry import get_model

    rows = np.random.RandomState(3).randint(
        0, trained.cfg.vocab_size, (2, 32)).tolist()
    prompt = "@" + os.path.join(os.path.dirname(ckpt_dir), "prompt.json")
    with open(prompt[1:], "w") as f:
        json.dump(rows, f)
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_main.cli.main(["generate", "--model", name,
                           "--checkpoint", ckpt_dir, "--prompt", prompt,
                           "--max-new-tokens", "16"], standalone_mode=False)
    served = json.loads(out.getvalue().strip().splitlines()[-1])
    secs = time.perf_counter() - t0
    with torch.no_grad():
        want = G.generate(trained, rows, max_new_tokens=16).tolist()
    if served["tokens"] != want:
        raise AssertionError(f"{name}: generate --checkpoint != the "
                             f"in-memory trained model (bf16)")
    gb = sum(os.path.getsize(os.path.join(d, f))
             for d, _, files in os.walk(ckpt_dir) for f in files) / 1e9
    print(f"[checkpoint] {name}: {ckpt_dir.split(os.sep)[-1]}/ "
          f"({gb:.2f} GB) from train.main served by `generate "
          f"--checkpoint` in {secs:.1f} s (restore, cast to bf16, 2 x 32 "
          f"prompt + 16 new): tokens == the in-memory trained model")
    if not float32:
        return
    t0 = time.perf_counter()
    f32 = cli_main._build_serving_model(name, 2, ckpt_dir=ckpt_dir,
                                        dtype=torch.float32)
    ref = get_model(name).make_model(device="cuda", dtype=torch.float32)
    ref.load_state_dict(trained.state_dict())
    ref.eval().requires_grad_(False)
    with torch.no_grad():
        got = G.generate(f32, rows, max_new_tokens=16).tolist()
        want32 = G.generate(ref, rows, max_new_tokens=16).tolist()
    if got != want32:
        raise AssertionError(f"{name}: checkpoint served in float32 != "
                             f"the in-memory weights in float32")
    print(f"[checkpoint] {name} float32: tokens == the in-memory weights "
          f"({sum(len(r) - 32 for r in got)} tokens each) in "
          f"{time.perf_counter() - t0:.1f} s")
    del f32, ref
    _release()


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


MESH_STEPS = 2              # steps of each GPT-2 medium mesh run
MESH_LR = 1e-4


def _mesh_model(spec, weights, **over):
    """A train-mode GPT-2 (float32 master weights) holding ``weights``."""
    model = spec.make_model(device="cuda", param_dtype=torch.float32,
                            **over).train()
    model.load_state_dict(weights, strict=True)
    return model


def _mesh_run(spec, weights, batches, mesh, **over) -> dict:
    """``MESH_STEPS`` AdamW steps of ``make_train_step`` over ``mesh``
    (None: the group-less step) on the same weights and batches: losses,
    the final full state, the flash launches and the ms of a step after
    the first."""
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions, get_model_state_dict)

    from polyaxon_tpu_torch.parallel import make_train_step
    from polyaxon_tpu_torch.train import make_optimizer

    model = _mesh_model(spec, weights, **over)
    step = make_train_step(spec.loss_fn(model),
                           make_optimizer("adamw", MESH_LR), mesh)
    state = step.init_state(model)
    losses, times = [], []
    _zero_counts()
    for batch in batches:
        if mesh is not None:
            batch = {k: step.batch_sharding.shard(v)
                     for k, v in batch.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))   # reads back: synced
        times.append(time.perf_counter() - t0)
    counts = _counts()
    if mesh is None:
        final = {k: v.detach().clone() for k, v in model.state_dict().items()}
    else:
        final = get_model_state_dict(model, options=StateDictOptions(
            full_state_dict=True))
    sharded = sum(type(p).__name__ == "DTensor" for p in model.parameters())
    rec = {"losses": losses, "final": final, "counts": counts,
           "step_ms": float(np.mean(times[1:])) * 1e3, "sharded": sharded,
           "grads": [p.grad for p in model.parameters()
                     if p.grad is not None and
                     type(p.grad).__name__ != "DTensor"]}
    del state, step, model
    return rec


def _mesh_compare(label, got, want, rtol_loss, atol_param):
    """Losses within ``rtol_loss``; every final parameter within
    ``atol_param``; returns (max loss rel diff, max param diff, share of
    elements exactly equal)."""
    loss_d = max(abs(g - w) / abs(w) for g, w in zip(got["losses"],
                                                     want["losses"]))
    worst, same, total = 0.0, 0, 0
    for name, w in want["final"].items():
        g = got["final"][name].to(w.device)
        d = (g.float() - w.float()).abs()
        worst = max(worst, float(d.max()))
        same += int((d == 0).sum())
        total += d.numel()
    if loss_d > rtol_loss or worst > atol_param or \
            not all(np.isfinite(got["losses"])):
        raise AssertionError(f"mesh {label}: losses {got['losses']} vs "
                             f"{want['losses']} (rel {loss_d:.3g} > "
                             f"{rtol_loss}?), params max |d| {worst:.3g} "
                             f"(> {atol_param}?)")
    return loss_d, worst, same / total


def phase_mesh() -> dict:
    """Processes and data parallelism on the card: a ONE-rank NCCL group
    (NCCL places no two ranks on one GPU; gangs of several ranks are
    held to the reference with gloo on the CPU) started through the
    bootstrap's group-start function, as a gang's rank starts it.

    1. ``check_slice_health`` over NCCL: 1 device healthy.
    2. Each collective helper on the one-rank mesh against its
       definition (the identity over one rank), and the raw NCCL
       all-reduce, all-gather, reduce-scatter and all-to-all of the
       helpers' autograd functions over the dp group (values, and the
       all-reduce's gradient).
    3. GPT-2 medium at full width, 8 x 1024 bf16 on float32 master
       weights, 3 AdamW steps through the mesh ``TrainStep`` with
       ``{dp: -1}`` (the bucketed NCCL gradient all-reduce) and
       ``{dp: 1, fsdp: -1}`` (FSDP2 over the fsdp axis: the reference's
       sharded leaves), each against the group-less ``TrainStep`` on the
       same weights and batches: losses rtol 1e-3 and every parameter
       within Adam's step bound, 2 lr a step (bf16 activations: a
       reordered reduction can flip the sign of Adam's first update
       where a gradient is near eps); a 2-layer float32 copy within 1e-5
       relative on the losses and 1e-5 on the parameters; 24 launches
       of each flash kernel a step, none fed a DTensor.
    Prints ``[mesh]`` lines (step ms of the three runs, the all-reduce ms
    of the gradient bytes, the card) and returns the flash launches of
    the dp and fsdp runs."""
    import socket

    import torch.distributed as dist

    from polyaxon_tpu_torch.models.registry import get_model
    from polyaxon_tpu_torch.parallel import (MeshSpec, bootstrap,
                                             build_mesh,
                                             check_slice_health)
    from polyaxon_tpu_torch.parallel import collectives as C
    from polyaxon_tpu_torch.parallel.strategies import all_reduce_grads

    t_phase = time.perf_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    backend = bootstrap.start_process_group(f"tcp://127.0.0.1:{port}", 1,
                                            0, "cuda:0", timeout_s=120)
    out = {}
    try:
        if backend != "nccl" or dist.get_backend() != "nccl":
            raise AssertionError(f"mesh: backend {backend}, not nccl")
        health = check_slice_health(timeout_s=60)
        if not health.ok or health.n_devices != 1:
            raise AssertionError(f"mesh: slice health {health}")
        mesh = build_mesh(MeshSpec(dp=-1))
        if not mesh.is_distributed or mesh.device != torch.device("cuda", 0):
            raise AssertionError(f"mesh: {mesh}")
        # 2. the helpers (identities over one rank) and the raw NCCL ops.
        g = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn(64, 32, device="cuda", generator=g)
        group = mesh.group("dp")
        helpers = {
            "all_reduce": C.all_reduce(x, ("dp", "fsdp"), mesh=mesh),
            "all_reduce_mean": C.all_reduce_mean(x, "dp", mesh=mesh),
            "reduce_scatter": C.reduce_scatter(x, "fsdp", mesh=mesh),
            "all_gather": C.all_gather(x, "fsdp", mesh=mesh),
            "all_to_all": C.all_to_all(x, "dp", split_dim=1,
                                       concat_dim=0, mesh=mesh),
            "ring_permute": C.ring_permute(x, "fsdp", mesh=mesh),
            "hierarchical_all_reduce": C.hierarchical_all_reduce(
                x, mesh=mesh)}
        raw = {"nccl all_reduce": C._AllReduce.apply(x, group),
               "nccl all_gather": C._AllGather.apply(x, group, 1, 0),
               "nccl reduce_scatter": C._ReduceScatter.apply(x, group, 1,
                                                             1),
               "nccl all_to_all": C._AllToAll.apply(x, group, 1, 1, 0)}
        t = x.clone().requires_grad_(True)
        (C._AllReduce.apply(t, group) * x).sum().backward()
        raw["nccl all_reduce grad"] = t.grad      # d/dt sum(t x) = x
        bad = [k for k, v in {**helpers, **raw}.items()
               if not torch.equal(v, x)]
        if bad:
            raise AssertionError(f"mesh: collectives != definition: {bad}")
        print(f"[mesh] one-rank NCCL group via "
              f"bootstrap.start_process_group: {health.detail} in "
              f"{health.latency_s * 1e3:.1f} ms; {len(helpers)} collective "
              f"helpers == their one-rank definition; raw NCCL all-reduce "
              f"(value, gradient), all-gather, reduce-scatter, all-to-all "
              f"== definition")
        # 3. GPT-2 medium at full width.
        spec = get_model("gpt2-medium")
        weights = {k: v.detach().clone() for k, v in spec.init_params(
            seed=0, device="cuda", train=True).state_dict().items()}
        batches = [{"inputs": torch.as_tensor(np.random.RandomState(
            i).randint(0, 50257, (8, 1024)), device="cuda")}
            for i in range(MESH_STEPS)]
        runs = {"group-less": _mesh_run(spec, weights, batches, None)}
        _release()
        strategies = {"dp": {"dp": -1}, "fsdp": {"dp": 1, "fsdp": -1}}
        for label, axes in strategies.items():
            runs[label] = _mesh_run(spec, weights, batches,
                                    build_mesh(MeshSpec.from_dict(axes)))
            _release()
        bound = 2 * MESH_LR * MESH_STEPS
        cmp_ = {label: _mesh_compare(label, runs[label],
                                     runs["group-less"], 1e-3, bound)
                for label in strategies}
        for label, rec in runs.items():
            _check_per_step(rec["counts"], MESH_STEPS, 24, f"mesh {label}")
        if runs["fsdp"]["sharded"] < 1 or runs["dp"]["sharded"]:
            raise AssertionError(f"mesh: sharded parameters dp "
                                 f"{runs['dp']['sharded']}, fsdp "
                                 f"{runs['fsdp']['sharded']}")
        # The gradient all-reduce alone, on the dp run's gradient bytes.
        grads = runs["dp"]["grads"]
        nbytes = sum(g.numel() * g.element_size() for g in grads)
        start, end = _events()
        dp_mesh = build_mesh(MeshSpec(dp=-1))
        all_reduce_grads(grads, dp_mesh)       # warm
        start.record()
        for _ in range(3):
            all_reduce_grads(grads, dp_mesh)
        end.record()
        torch.cuda.synchronize()
        ar_ms = start.elapsed_time(end) / 3
        n_grads = len(grads)
        del runs["dp"]["grads"], runs["fsdp"]["grads"], grads
        # The same three runs on a 2-layer float32 copy: held tight.
        f32 = {k: v for k, v in weights.items()
               if not k.startswith("h.") or int(k.split(".")[1]) < 2}
        small = {"group-less": _mesh_run(spec, f32, batches, None,
                                         num_layers=2,
                                         dtype=torch.float32)}
        for label, axes in strategies.items():
            small[label] = _mesh_run(spec, f32, batches,
                                     build_mesh(MeshSpec.from_dict(axes)),
                                     num_layers=2, dtype=torch.float32)
        cmp32 = {label: _mesh_compare(f"{label} float32", small[label],
                                      small["group-less"], 1e-5, 1e-5)
                 for label in strategies}
        card = card_line()
        print(f"[mesh] gpt2-medium 8 x 1024 bf16 (f32 master weights, "
              f"AdamW lr {MESH_LR}), {MESH_STEPS} steps each, step ms "
              f"(after the first): group-less "
              f"{runs['group-less']['step_ms']:.2f}, dp "
              f"{runs['dp']['step_ms']:.2f}, fsdp "
              f"{runs['fsdp']['step_ms']:.2f}; gradient all-reduce "
              f"{ar_ms:.3f} ms for {nbytes / 1e9:.3f} GB (one rank, "
              f"{n_grads} tensors in 25 MiB buckets); {card}")
        print(f"[mesh] vs group-less: " + "; ".join(
            f"{k} loss rel {c[0]:.2e}, params max |d| {c[1]:.2e} "
            f"({c[2]:.4f} of elements equal)" for k, c in cmp_.items())
            + f" (bound {bound:.0e}); 2-layer float32: " + "; ".join(
                f"{k} loss rel {c[0]:.2e}, params max |d| {c[1]:.2e}"
                for k, c in cmp32.items())
            + f"; fsdp sharded {runs['fsdp']['sharded']} parameters; "
              f"flash launches a step 24 / 24 / 24 in each run")
        out = {"step_ms": {k: r["step_ms"] for k, r in runs.items()},
               "all_reduce_ms": ar_ms, "grad_bytes": nbytes,
               "flash_launches": {"mesh_dp_step": runs["dp"]["counts"],
                                  "mesh_fsdp_step": runs["fsdp"]["counts"]}}
        del runs, small, weights
    finally:
        bootstrap.shutdown()
        _release()
    print(f"[time] mesh: {time.perf_counter() - t_phase:.1f} s")
    return out


TP_STEPS = 2                # steps of each float32 tp / ep / sp check
TP_BF16_STEPS = 2           # steps of each bf16 gang timing run
# Depth of the bf16 gang timing runs: a quarter of GPT-2 medium's 24
# layers and of MoE-GPT-small's 12, for the script's time.
TP_BF16_LAYERS = 6
TP_MOE_BF16_LAYERS = 3
TP_LR = 1e-4
TP_MOE_F32_LAYERS = 2       # of MoE-GPT-small's 12, float32
# Each rank of phase_tp_train's gang: both on cuda:0, gloo over the
# card's tensors, started by the PTPU_* bootstrap.  Writes
# rank{r}.json into argv[1].
TP_RANK = r"""
import json, os, sys, time
import numpy as np, torch
import torch.distributed as dist
from polyaxon_tpu_torch.models.registry import get_model
from polyaxon_tpu_torch.ops import flash
from polyaxon_tpu_torch.ops.attention import sequence_parallel
from polyaxon_tpu_torch.parallel import MeshSpec, build_mesh, make_train_step
from polyaxon_tpu_torch.parallel.bootstrap import initialize_from_env, shutdown
from polyaxon_tpu_torch.parallel.moe import moe_layer
from polyaxon_tpu_torch.parallel.strategies import gather_shard
from polyaxon_tpu_torch.train import make_optimizer

(out_dir, steps, lr, f32_layers, moe_f32_layers, llama_f32_layers,
 bf16_steps, bf16_layers, moe_bf16_layers) = (
    sys.argv[1], int(sys.argv[2]), float(sys.argv[3]), int(sys.argv[4]),
    int(sys.argv[5]), int(sys.argv[6]), int(sys.argv[7]), int(sys.argv[8]),
    int(sys.argv[9]))
# Imported: wait for the phase's go before touching the card.
while not os.path.exists(os.path.join(out_dir, "go")):
    time.sleep(0.05)
topo = initialize_from_env(device="cuda")
rank = topo.process_id
assert dist.get_backend() == "gloo", dist.get_backend()
shapes = set()
real_fwd = flash._flash_forward_kernel

def fwd(q, *a, **k):
    shapes.add(tuple(q.shape))
    return real_fwd(q, *a, **k)

flash._flash_forward_kernel = fwd

def counts():
    return {"flash_fwd": flash.launch_count,
            "flash_bwd_dq": flash.dq_launch_count,
            "flash_bwd_dkv": flash.dkv_launch_count}

def emulate_ep(model, ep):
    # The reference's moe_layer on one device: each of ep sequence
    # chunks routed with its own capacity, the aux their mean.
    gelu = lambda t: torch.nn.functional.gelu(t, approximate="tanh")
    for m in model.modules():
        if type(m).__name__ == "MoEMlp":
            def forward(x, decode=False, experts=None, m=m):
                parts = [moe_layer(c, m.router, m.experts_w1, m.experts_w2,
                                   None, capacity_factor=m.cfg.capacity_factor,
                                   activation=gelu) for c in x.chunk(ep, 1)]
                return (torch.cat([o for o, _ in parts], 1).to(m.cfg.dtype),
                        sum(a for _, a in parts) / ep)
            m.forward = forward

def card_init(model, seed=0):
    # The registry's scales, drawn on the card (the timing runs' weights:
    # a CPU draw of 355M-600M values takes seconds).
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if p.ndim == 1 and getattr(p, "init_std", None) is None:
                p.fill_(0.0 if n.endswith("bias") else 1.0)
            else:
                std = getattr(p, "init_std", None) or p[0].numel() ** -0.5
                p.normal_(0.0, std, generator=g)

def run(name, axes, seq=1024, rows=8, weights=None, ep_emulated=0,
        gather=False, seeded=False, sp_mode=None, n_steps=None, **over):
    t_run = time.perf_counter()
    spec = get_model(name)
    if weights is None and seeded and (axes is None or rank == 0):
        model = spec.init_params(seed=0, device="cuda", train=True, **over)
    elif weights is None and (axes is None or rank == 0):
        model = spec.make_model(device="cuda", param_dtype=torch.float32,
                                **over).train()
        card_init(model)
    else:
        model = spec.make_model(device="cuda", param_dtype=torch.float32,
                                **over).train()
        if weights is not None:
            model.load_state_dict(weights)
    init = None if axes is None or rank else {
        k: v.detach().clone() for k, v in model.state_dict().items()}
    if ep_emulated:
        emulate_ep(model, ep_emulated)
    mesh = None if axes is None else build_mesh(MeshSpec.from_dict(axes))
    step = make_train_step(spec.loss_fn(model),
                           make_optimizer("adamw", lr), mesh)
    state = step.init_state(model)
    vocab = model.cfg.vocab_size
    losses, aux, times = [], [], []
    flash.launch_count = flash.dq_launch_count = flash.dkv_launch_count = 0
    shapes.clear()
    torch.cuda.reset_peak_memory_stats()
    resident_mib = torch.cuda.memory_allocated() / 2 ** 20
    for i in range(n_steps or steps):
        tokens = np.random.RandomState(100 + i).randint(0, vocab, (rows, seq))
        if mesh is not None:
            tokens = step.batch_sharding.shard(tokens)
        batch = {"inputs": torch.as_tensor(tokens, device="cuda")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if sp_mode is None:
            state, m = step(state, batch)
        else:
            with sequence_parallel(mesh, sp_mode):
                state, m = step(state, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
        if "aux_loss" in m:
            aux.append(float(m["aux_loss"]))
    c = counts()
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    final = None if not gather else {
        n: gather_shard(model, n, t) if n in step.shards else t
        for n, t in model.state_dict().items()}
    rec = {"losses": losses, "aux": aux, "times": times, "counts": c,
           "shapes": sorted(shapes), "shards": len(step.shards),
           "local_params": sum(p.numel() for p in model.parameters()),
           "peak_mib": peak_mib, "resident_mib": resident_mib,
           "secs": time.perf_counter() - t_run}
    del state, step, model
    torch.cuda.empty_cache()
    return rec, final, init

def compare(got, want):
    # Loss relative difference; parameters: the largest |d| and the
    # share of elements within 2e-6.
    tight = total = 0
    worst = 0.0
    for k, w in want.items():
        d = (got[k].float() - w.float()).abs()
        worst = max(worst, float(d.max()))
        tight += int((d <= 2e-6).sum())
        total += d.numel()
    return worst, tight / total

res = {}
# float32 at 4 x 512 tokens (the bf16 runs take 8 x 1024).
f32 = dict(dtype=torch.float32, rows=4, seq=512, gather=True, seeded=True)
# GPT-2 medium, tp 2: float32 at f32_layers against the group-less step.
gang, final, init = run("gpt2-medium", {"dp": 1, "tp": 2},
                        num_layers=f32_layers, **f32)
if rank == 0:
    ref, ref_final, _ = run("gpt2-medium", None, weights=init,
                            num_layers=f32_layers, **f32)
    worst, tight = compare(final, ref_final)
    res["gpt2_f32"] = {"gang": gang, "ref": ref, "worst": worst,
                       "tight": tight}
del final, init
dist.barrier()
# MoE-GPT-small, ep 2: float32 at moe_f32_layers against the group-less
# step with the reference's per-chunk routing emulated.
gang, final, init = run("moe-gpt-small", {"dp": 1, "ep": 2},
                        num_layers=moe_f32_layers, **f32)
if rank == 0:
    ref, ref_final, _ = run("moe-gpt-small", None, weights=init,
                            ep_emulated=2, num_layers=moe_f32_layers,
                            **f32)
    worst, tight = compare(final, ref_final)
    res["moe_f32"] = {"gang": gang, "ref": ref, "worst": worst,
                      "tight": tight}
del final, init
dist.barrier()
# bf16 at a quarter depth: step times and the flash launches; rank 0 then
# times the group-less step alone on the same initial weights.
res["gpt2_bf16"], _, gpt2_init = run("gpt2-medium", {"dp": 1, "tp": 2},
                                     n_steps=bf16_steps,
                                     num_layers=bf16_layers)
res["moe_bf16"], _, moe_init = run("moe-gpt-small", {"dp": 1, "ep": 2},
                                   n_steps=bf16_steps,
                                   num_layers=moe_bf16_layers)
dist.barrier()
if rank == 0:
    res["gpt2_bf16_ref"] = run("gpt2-medium", None, weights=gpt2_init,
                               num_layers=bf16_layers)[0]
    del gpt2_init
    res["moe_bf16_ref"] = run("moe-gpt-small", None, weights=moe_init,
                              num_layers=moe_bf16_layers)[0]
dist.barrier()
# Sequence parallelism on sp 2.  float32 at a few layers of the models'
# own weights against the group-less step: GPT-2 medium at 4 x 1024,
# ring and Ulysses (one group-less run holds both), TinyLlama's width at
# 2 x 2048 with window 511 on the ring (its 1024-token blocks: one
# windowed rotation, raw window -513).
t_sp = time.perf_counter()
sp2 = {"dp": 1, "sp": 2}
f32_sp = dict(dtype=torch.float32, rows=4, gather=True, seeded=True)
ref_final = None
for mode in ("ring", "ulysses"):
    gang, final, init = run("gpt2-medium", sp2, sp_mode=mode,
                            num_layers=f32_layers, **f32_sp)
    res[f"sp_{mode}_f32"] = {"gang": gang}
    if rank == 0:
        if ref_final is None:
            ref, ref_final, _ = run("gpt2-medium", None, weights=init,
                                    num_layers=f32_layers, **f32_sp)
        worst, tight = compare(final, ref_final)
        res[f"sp_{mode}_f32"].update(ref=ref, worst=worst, tight=tight)
    del final, init
    dist.barrier()
del ref_final
llama = dict(f32_sp, rows=2, seq=2048, sliding_window=511,
             num_layers=llama_f32_layers)
gang, final, init = run("tinyllama-1.1b", sp2, sp_mode="ring", **llama)
res["sp_llama_f32"] = {"gang": gang}
if rank == 0:
    ref, ref_final, _ = run("tinyllama-1.1b", None, weights=init, **llama)
    worst, tight = compare(final, ref_final)
    res["sp_llama_f32"].update(ref=ref, worst=worst, tight=tight)
del final, init
dist.barrier()
# bf16 GPT-2 medium at a quarter depth, 8 x 1024, on the timing runs'
# weights (gpt2_bf16_ref is their group-less step): step times and
# launches.
res["sp_ring_bf16"] = run("gpt2-medium", sp2, sp_mode="ring",
                         n_steps=bf16_steps, num_layers=bf16_layers)[0]
res["sp_ulysses_bf16"] = run("gpt2-medium", sp2, sp_mode="ulysses",
                            n_steps=bf16_steps, num_layers=bf16_layers)[0]
res["sp_secs"] = time.perf_counter() - t_sp
res["backend"] = dist.get_backend()
with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
    json.dump(res, f)
dist.barrier()
shutdown()
print("ok", flush=True)
"""


def _tp_step_ms(rec) -> float:
    return float(np.mean(rec["times"][1:])) * 1e3


def _start_gang(script: str, n: int, args, prefix: str) -> dict:
    """Start an ``n``-rank gang of ``script`` (the kernels built first):
    each rank imports the port and waits for a ``go`` file in the gang's
    directory (its first argument) before it joins the group or touches
    the card, so their start-up can run beside an earlier phase."""
    import socket

    from polyaxon_tpu_torch.ops import _build

    _build.build_all()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix=prefix)
    path = os.path.join(tmp, "rank.py")
    with open(path, "w") as f:
        f.write(script)
    gang = {"dir": tmp, "procs": [], "logs": [],
            "t0": time.perf_counter()}
    for r in range(n):
        env = dict(os.environ, PYTHONPATH=root,
                   PTPU_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   PTPU_NUM_PROCESSES=str(n), PTPU_PROCESS_ID=str(r),
                   PTPU_INIT_TIMEOUT="120", PTPU_DIST_BACKEND="gloo")
        log = open(os.path.join(tmp, f"rank{r}.log"), "w+")
        gang["logs"].append(log)
        gang["procs"].append(subprocess.Popen(
            [sys.executable, path, tmp] + [str(a) for a in args], cwd=root,
            env=env, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True))
    return gang


def _release_gang(gang: dict) -> None:
    """The gang's ``go`` file: its ranks run now, beside whatever runs
    in this process; :func:`_gang_results` collects them."""
    open(os.path.join(gang["dir"], "go"), "w").close()


def _start_tp_gang() -> dict:
    """``phase_tp_train``'s two rank processes (:func:`_start_gang`)."""
    return _start_gang(TP_RANK, 2, [TP_STEPS, TP_LR, F32_LAYERS,
                                    TP_MOE_F32_LAYERS, LLAMA_F32_LAYERS,
                                    TP_BF16_STEPS, TP_BF16_LAYERS,
                                    TP_MOE_BF16_LAYERS], "ptpu_tp_")


def _gang_results(gang: dict, label: str, timeout: float = 600) -> list:
    """Release the gang (its ``go`` file), wait for its ranks, and return
    each rank's ``rank{r}.json``; a rank that fails fails the phase with
    its output.  The gang is stopped either way."""
    procs, tmp = gang["procs"], gang["dir"]
    try:
        _release_gang(gang)
        deadline = time.monotonic() + timeout
        try:
            for proc in procs:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        for r, proc in enumerate(procs):
            if proc.returncode != 0:
                outs = _stop_gang(gang)
                raise AssertionError(f"{label} rank {r} exited "
                                     f"{proc.returncode}:\n"
                                     f"{outs[r][-6000:]}")
        ranks = []
        for r in range(len(procs)):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        _stop_gang(gang)
    return ranks


def _stop_gang(gang: dict) -> list:
    """Kill what is left of the gang, remove its directory, and return
    each rank's output."""
    import shutil

    for proc in gang["procs"]:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    outs = []
    for log in gang["logs"]:
        if not log.closed:
            log.seek(0)
            outs.append(log.read())
            log.close()
    shutil.rmtree(gang["dir"], ignore_errors=True)
    return outs


def phase_tp_train(gang=None) -> dict:
    """Tensor and expert parallelism in training on the card: a
    TWO-process gang on the one card (both ranks on ``cuda:0``; NCCL
    places no two ranks on one GPU, so the group is gloo over the card's
    tensors, ``PTPU_DIST_BACKEND=gloo``), started through the PTPU_*
    bootstrap as a gang's ranks start.

    1. float32, the models' own seeded weights at a few layers: GPT-2
       medium (``F32_LAYERS`` layers, full width, 8 heads a rank) on
       ``tp:2`` and MoE-GPT-small (``TP_MOE_F32_LAYERS``) on ``ep:2``,
       ``TP_STEPS`` AdamW steps of 4 x 512 tokens each, against the
       group-less step on the same weights and batches (MoE: the
       reference's per-chunk routing, each of 2 sequence halves with its
       own capacity, emulated on one device): losses rtol 1e-5, every
       parameter within 2 lr a step and 99% of the elements within
       2e-6 (the CPU tests' tolerance, ``tests/test_torch_tp.py``);
    2. bf16 at a quarter depth (``TP_BF16_LAYERS`` /
       ``TP_MOE_BF16_LAYERS`` layers), ``TP_BF16_STEPS`` steps: GPT-2
       medium ``tp:2`` and MoE-GPT-small ``ep:2``, step ms against the
       group-less step (rank 0 alone after the gang), and each rank's
       flash launches: one of each kernel a layer a step, GPT-2 at the
       local-head shape [8, 1024, 8, 64], MoE at [8, 1024, 12, 64];
    3. sequence parallelism on ``sp:2`` in the same ranks
       (:func:`_check_sp_train`): float32 GPT-2 medium at 4 x 1024, ring
       and Ulysses, and TinyLlama's width at 2 x 2048 with window 511 on
       the ring (one windowed rotation), with the tolerances of 1.; bf16
       GPT-2 medium at full depth, 8 x 1024, ring and Ulysses, step ms
       and each rank's launches.
    Two ranks sharing one card and a host-staged gloo group measure
    correctness and the layout's cost on one card, not tp or sp
    scaling.
    ``gang``: the ranks :func:`_start_tp_gang` started beside an earlier
    phase (they import and wait for this phase's go); None starts them
    here.  Prints ``[tp]`` and ``[sp]`` lines, ``[time] sp-train`` and
    ``[time] tp-train``; a gloo refusal of a CUDA collective fails the
    phase with the rank's error."""
    t_phase = time.perf_counter()
    gang = gang or _start_tp_gang()
    overlapped = max(0.0, t_phase - gang["t0"])
    ranks = _gang_results(gang, "tp-train")
    res = ranks[0]
    bound = 2 * TP_LR * TP_STEPS
    for key, label in (("gpt2_f32", f"gpt2-medium tp 2, {F32_LAYERS} "
                        "layers"), ("moe_f32", f"moe-gpt-small ep 2, "
                                    f"{TP_MOE_F32_LAYERS} layers")):
        c = res[key]
        rel = max(abs(g - w) / abs(w) for g, w in
                  zip(c["gang"]["losses"], c["ref"]["losses"]))
        if rel > 1e-5 or c["worst"] > bound or c["tight"] < 0.99:
            raise AssertionError(
                f"tp-train {label} float32: losses {c['gang']['losses']} "
                f"vs {c['ref']['losses']} (rel {rel:.3g} > 1e-5?), params "
                f"max |d| {c['worst']:.3g} (> {bound}?), {c['tight']:.4f} "
                f"within 2e-6 (< 0.99?)")
        c["loss_rel"] = rel
        print(f"[tp] {label} float32, {TP_STEPS} AdamW steps 4 x 512 "
              f"(lr {TP_LR}): gang == group-less step: loss rel "
              f"{rel:.2e}, params max |d| {c['worst']:.2e} "
              f"({c['tight']:.6f} within 2e-6); losses "
              + ", ".join(f"{x:.6f}" for x in c["gang"]["losses"]))
    want = {"gpt2_bf16": (TP_BF16_LAYERS, [8, 1024, 8, 64]),
            "moe_bf16": (TP_MOE_BF16_LAYERS, [8, 1024, 12, 64])}
    for key, (layers, shape) in want.items():
        for r, rank in enumerate(ranks):
            rec = rank[key]
            if rec["shapes"] != [shape]:
                raise AssertionError(f"tp-train {key} rank {r}: flash "
                                     f"shapes {rec['shapes']}, not "
                                     f"{[shape]}")
            _check_per_step(rec["counts"], TP_BF16_STEPS, layers,
                            f"tp-train {key} rank {r}")
            if not all(np.isfinite(rec["losses"])):
                raise AssertionError(f"tp-train {key}: {rec['losses']}")
    sp = _check_sp_train(ranks, bound)
    card = card_line()
    g, gr = res["gpt2_bf16"], res["gpt2_bf16_ref"]
    m, mr = res["moe_bf16"], res["moe_bf16_ref"]
    print(f"[tp] bf16 8 x 1024, {TP_BF16_LAYERS} / {TP_MOE_BF16_LAYERS} "
          f"layers, {TP_BF16_STEPS} steps, step ms after the "
          f"first (two ranks on one card, gloo; the layout's cost, not "
          f"scaling): gpt2-medium tp 2 {_tp_step_ms(g):.2f} against "
          f"group-less {_tp_step_ms(gr):.2f}; moe-gpt-small ep 2 "
          f"{_tp_step_ms(m):.2f} against group-less {_tp_step_ms(mr):.2f};"
          f" flash launches a rank {g['counts']} at {g['shapes'][0]} "
          f"({TP_BF16_LAYERS} a step each) and {m['counts']} at "
          f"{m['shapes'][0]} ({TP_MOE_BF16_LAYERS}); "
          f"{card}")
    print(f"[time] tp-train: {time.perf_counter() - t_phase:.1f} s (the "
          f"ranks started {overlapped:.1f} s before, beside the phases "
          f"then running; rank 0's runs: " + ", ".join(
              f"{k} {res[k]['secs']:.1f} s" for k in (
                  "gpt2_bf16", "moe_bf16", "gpt2_bf16_ref", "moe_bf16_ref"))
          + ", " + ", ".join(f"{k} gang {res[k]['gang']['secs']:.1f} s, "
                             f"group-less {res[k]['ref']['secs']:.1f} s"
                             for k in ("gpt2_f32", "moe_f32")) + ")")
    ring, uly = (res[f"sp_{k}_bf16"] for k in ("ring", "ulysses"))
    print(f"[sp] bf16 gpt2-medium 8 x 1024, {TP_BF16_LAYERS} layers, sp 2, "
          f"{TP_BF16_STEPS} steps, "
          f"step ms after the first (two ranks on one card, gloo; the "
          f"layout's cost, not scaling): ring {_tp_step_ms(ring):.2f} / "
          f"{_tp_step_ms(ranks[1]['sp_ring_bf16']):.2f} (ranks 0 / 1), "
          f"ulysses {_tp_step_ms(uly):.2f} / "
          f"{_tp_step_ms(ranks[1]['sp_ulysses_bf16']):.2f}, against "
          f"group-less {_tp_step_ms(gr):.2f}; flash launches: ring rank 0 "
          f"{ring['counts']}, rank 1 {ranks[1]['sp_ring_bf16']['counts']} "
          f"at {ring['shapes'][0]} ({TP_BF16_LAYERS} / "
          f"{2 * TP_BF16_LAYERS} a step each: rank 0's diagonal, rank 1's "
          f"diagonal and past block), ulysses {uly['counts']} a rank at "
          f"{uly['shapes'][0]} ({TP_BF16_LAYERS} a step each); {card}")
    print(f"[time] sp-train: {res['sp_secs']:.1f} s of the ranks' run "
          f"(rank 0: " + ", ".join(
              f"{k} {res[k]['secs']:.1f} s" for k in (
                  "sp_ring_bf16", "sp_ulysses_bf16")) + ", " + ", ".join(
              f"{k} gang {res[k]['gang']['secs']:.1f} s, group-less "
              f"{res[k]['ref']['secs']:.1f} s" for k in (
                  "sp_ring_f32", "sp_llama_f32")) + ")")
    return {"flash_launches": {"tp_train_gpt2": g["counts"],
                               "ep_train_moe": m["counts"], **sp},
            "step_ms": {"gpt2 tp2": _tp_step_ms(g),
                        "gpt2": _tp_step_ms(gr),
                        "moe ep2": _tp_step_ms(m),
                        "moe": _tp_step_ms(mr),
                        "gpt2 sp2 ring": _tp_step_ms(ring),
                        "gpt2 sp2 ulysses": _tp_step_ms(uly)}}


def _check_sp_train(ranks, bound) -> dict:
    """The sp runs of ``phase_tp_train``'s ranks: float32 GPT-2 medium
    (ring, Ulysses) and TinyLlama's width (windowed ring) against the
    group-less step, with the tp runs' tolerances, and every run's
    launches and shapes on each rank, so a quiet fall back to local
    attention fails: on the causal ring rank 0 launches its diagonal
    block's kernels alone, rank 1 its diagonal and past block's (the
    windowed ring's past block at the raw window 511 - 1024), each at
    [B, S / 2, H, D]; Ulysses one launch of each a layer at
    [B, S, H / 2, D]; TinyLlama's remat runs each forward twice (bf16
    GPT-2 at ``TP_BF16_LAYERS`` layers: rank 0 one of each kernel a
    layer a step, rank 1 two, at [8, 512, 16, 64]; Ulysses one a layer
    a rank at [8, 1024, 8, 64]).  Prints
    the windowed ring's peak memory beside the group-less remat
    step's.  Returns the gang's launches of each path, both ranks
    summed."""
    res = ranks[0]
    for key, label, layers, fwd_passes, blocks, shape in (
            ("sp_ring_f32", f"gpt2-medium sp 2 ring, {F32_LAYERS} layers, "
             "4 x 1024", F32_LAYERS, 1, (1, 2), [4, 512, 16, 64]),
            ("sp_ulysses_f32", f"gpt2-medium sp 2 ulysses, {F32_LAYERS} "
             "layers, 4 x 1024", F32_LAYERS, 1, (1, 1), [4, 1024, 8, 64]),
            ("sp_llama_f32", f"{LLAMA} width sp 2 ring, window 511, "
             f"{LLAMA_F32_LAYERS} layers, 2 x 2048", LLAMA_F32_LAYERS, 2,
             (1, 2), [2, 1024, 32, 64])):
        for r, rank in enumerate(ranks):
            rec = rank[key]["gang"]
            if rec["shapes"] != [shape]:
                raise AssertionError(f"sp-train {key} rank {r}: flash "
                                     f"shapes {rec['shapes']}, not "
                                     f"{[shape]}")
            _check_per_step(rec["counts"], TP_STEPS, layers * blocks[r],
                            f"sp-train {key} rank {r}", fwd_passes)
        c = res[key]
        rel = max(abs(g - w) / abs(w) for g, w in
                  zip(c["gang"]["losses"], c["ref"]["losses"]))
        if rel > 1e-5 or c["worst"] > bound or c["tight"] < 0.99:
            raise AssertionError(
                f"sp-train {label} float32: losses {c['gang']['losses']} "
                f"vs {c['ref']['losses']} (rel {rel:.3g} > 1e-5?), params "
                f"max |d| {c['worst']:.3g} (> {bound}?), {c['tight']:.4f} "
                f"within 2e-6 (< 0.99?)")
        print(f"[sp] {label} float32, {TP_STEPS} AdamW steps (lr {TP_LR}): "
              f"gang == group-less step: loss rel {rel:.2e}, params max "
              f"|d| {c['worst']:.2e} ({c['tight']:.6f} within 2e-6); "
              f"flash launches rank 0 {c['gang']['counts']}, rank 1 "
              f"{ranks[1][key]['gang']['counts']}; losses "
              + ", ".join(f"{x:.6f}" for x in c["gang"]["losses"]))
    out = {}
    for key, path, layers, shape in (
            ("sp_ring_bf16", "sp_ring_gpt2",
             (TP_BF16_LAYERS, 2 * TP_BF16_LAYERS), [8, 512, 16, 64]),
            ("sp_ulysses_bf16", "sp_ulysses_gpt2",
             (TP_BF16_LAYERS, TP_BF16_LAYERS), [8, 1024, 8, 64])):
        for r, rank in enumerate(ranks):
            rec = rank[key]
            if rec["shapes"] != [shape]:
                raise AssertionError(f"sp-train {key} rank {r}: flash "
                                     f"shapes {rec['shapes']}, not "
                                     f"{[shape]}")
            _check_per_step(rec["counts"], TP_BF16_STEPS, layers[r],
                            f"sp-train {key} rank {r}")
            if not all(np.isfinite(rec["losses"])):
                raise AssertionError(f"sp-train {key}: {rec['losses']}")
        out[path] = {k: sum(rank[key]["counts"][k] for rank in ranks)
                     for k in ranks[0][key]["counts"]}
    runs = [rank["sp_llama_f32"]["gang"] for rank in ranks] + \
        [res["sp_llama_f32"]["ref"]]
    print(f"[sp] {LLAMA} width, window 511, {LLAMA_F32_LAYERS} layers under "
          f"remat, 2 x 2048 float32, the steps' peak memory above what was "
          f"resident before them (the weights and the harness's copies): "
          f"sp 2 ring {runs[0]['peak_mib'] - runs[0]['resident_mib']:.1f} / "
          f"{runs[1]['peak_mib'] - runs[1]['resident_mib']:.1f} MiB (ranks "
          f"0 / 1), group-less "
          f"{runs[2]['peak_mib'] - runs[2]['resident_mib']:.1f} MiB (peaks "
          + " / ".join(f"{r['peak_mib']:.1f}" for r in runs) + " MiB)")
    return out


COMPOSE_STEPS = 2           # AdamW steps of each composed-mesh check
# Each rank of phase_compose_train's gang: four on cuda:0, gloo over the
# card's tensors, started by the PTPU_* bootstrap.  Writes
# rank{r}.json into argv[1].
COMPOSE_RANK = r"""
import json, os, sys, time
import numpy as np, torch
import torch.distributed as dist
from polyaxon_tpu_torch.checkpoint import CheckpointManager
from polyaxon_tpu_torch.models.registry import get_model
from polyaxon_tpu_torch.ops import flash
from polyaxon_tpu_torch.ops.attention import sequence_parallel
from polyaxon_tpu_torch.parallel import MeshSpec, build_mesh, make_train_step
from polyaxon_tpu_torch.parallel.bootstrap import initialize_from_env
from polyaxon_tpu_torch.parallel.moe import moe_layer
from polyaxon_tpu_torch.parallel.pipeline import (pipelined_lm_loss,
                                                  pipelined_lm_loss_1f1b)
from polyaxon_tpu_torch.parallel.strategies import gather_full, local_block
from polyaxon_tpu_torch.train import make_optimizer

out_dir, steps, lr, gpt2_layers, moe_layers, llama_layers = (
    sys.argv[1], int(sys.argv[2]), float(sys.argv[3]), int(sys.argv[4]),
    int(sys.argv[5]), int(sys.argv[6]))
main_argv = sys.argv[7:]

# Imported: wait for the go before touching the card.
while not os.path.exists(os.path.join(out_dir, "go")):
    time.sleep(0.05)
topo = initialize_from_env(device="cuda")
rank = topo.process_id
assert dist.get_backend() == "gloo", dist.get_backend()
shapes = set()
real_fwd = flash._flash_forward_kernel

def fwd(q, *a, **k):
    shapes.add(tuple(q.shape))
    return real_fwd(q, *a, **k)

flash._flash_forward_kernel = fwd

def counts():
    return {"flash_fwd": flash.launch_count,
            "flash_bwd_dq": flash.dq_launch_count,
            "flash_bwd_dkv": flash.dkv_launch_count}

def emulate(model, data, ep):
    # The reference's moe_layer on one device: each of data x ep blocks
    # (rows over the data axes, the sequence over ep) routed with its
    # own capacity, the aux their mean.
    gelu = lambda t: torch.nn.functional.gelu(t, approximate="tanh")
    for m in model.modules():
        if type(m).__name__ == "MoEMlp":
            def forward(x, decode=False, experts=None, m=m):
                rows = []
                for r in x.chunk(data, 0):
                    parts = [moe_layer(c, m.router, m.experts_w1,
                                       m.experts_w2, None,
                                       capacity_factor=m.cfg.capacity_factor,
                                       activation=gelu)
                             for c in r.chunk(ep, 1)]
                    rows.append(parts)
                out = torch.cat([torch.cat([o for o, _ in p], 1)
                                 for p in rows], 0)
                aux = sum(a for p in rows for _, a in p) / (data * ep)
                return out.to(m.cfg.dtype), aux
            m.forward = forward

def nbytes(model):
    return sum(local_block(p).numel() * p.element_size()
               for p in model.parameters())

def run(name, axes, seq, rows, layers, weights=None, sp_mode=None,
        emulated=None, ckpt=None, schedule=None, **over):
    t_run = time.perf_counter()
    spec = get_model(name)
    model = spec.make_model(device="cuda", param_dtype=torch.float32,
                            dtype=torch.float32, num_layers=layers,
                            **over).train()
    if weights is None:
        if rank == 0:
            model = spec.init_params(seed=0, device="cuda", train=True,
                                     dtype=torch.float32, num_layers=layers,
                                     **over)
    else:
        model.load_state_dict(weights)
    init = None if axes is None or rank else {
        k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    full_bytes = nbytes(model)
    if emulated:
        emulate(model, *emulated)
    mesh = None if axes is None else build_mesh(MeshSpec.from_dict(axes))
    # A pp gang trains through the pipelined loss; its group-less step
    # through the model's own.
    loss = spec.loss_fn(model) if schedule is None or mesh is None else (
        pipelined_lm_loss if schedule == "gpipe"
        else pipelined_lm_loss_1f1b)(model, mesh)
    step = make_train_step(loss, make_optimizer("adamw", lr), mesh)
    state = step.init_state(model)
    setup_secs = time.perf_counter() - t_run
    local_bytes = nbytes(model)
    vocab = model.cfg.vocab_size
    losses, aux, times = [], [], []
    flash.launch_count = flash.dq_launch_count = flash.dkv_launch_count = 0
    shapes.clear()
    for i in range(steps):
        tokens = np.random.RandomState(100 + i).randint(0, vocab, (rows, seq))
        if mesh is not None:
            tokens = step.batch_sharding.shard(tokens)
        batch = {"inputs": torch.as_tensor(tokens, device="cuda")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if sp_mode is None:
            state, m = step(state, batch)
        else:
            with sequence_parallel(mesh, sp_mode):
                state, m = step(state, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
        if "aux_loss" in m:
            aux.append(float(m["aux_loss"]))
    c = counts()
    # Every entry of the one-process model (a pp rank holds its stage's).
    live = model.state_dict()
    layout = getattr(model, "pipeline_layout", None)
    names = list(live) if layout is None else [n for n, _, _ in
                                               layout.entries]
    final = {}
    for n in names:     # collective; rank 0 alone compares
        t = gather_full(model, n, live.get(n))
        if rank == 0:
            final[n] = t.cpu()
    if ckpt is not None:
        t0 = time.perf_counter()
        manager = CheckpointManager(ckpt)
        manager.save(state["step"], state)
        manager.wait()
        ckpt_secs = time.perf_counter() - t0
    rec = {"losses": losses, "aux": aux, "times": times, "counts": c,
           "shapes": sorted(shapes), "local_bytes": local_bytes,
           "full_bytes": full_bytes, "setup_secs": setup_secs,
           "coord": None if mesh is None else {
               a: mesh.coordinate(a) for a in ("fsdp", "pp", "sp", "ep",
                                               "tp")},
           "secs": time.perf_counter() - t_run}
    if ckpt is not None:
        rec["ckpt_secs"] = ckpt_secs
    del state, step, model
    torch.cuda.empty_cache()
    return rec, final, init

def compare(got, want):
    # The largest |d| and the share of elements within 2e-6.
    tight = total = 0
    worst = 0.0
    for k, w in want.items():
        d = (got[k].float() - w.float()).abs()
        worst = max(worst, float(d.max()))
        tight += int((d <= 2e-6).sum())
        total += d.numel()
    return worst, tight / total

PIPE = ("gpt2_pp_dp", "llama_pp_dp", "llama_pp_tp", "gpt2_pp_fsdp")
RUNS = [
    # key, model, mesh, seq, rows, layers, sp mode, emulated (data, ep),
    # pp schedule, config overrides
    ("gpt2_fsdp_tp", "gpt2-medium", {"dp": 1, "fsdp": 2, "tp": 2}, 512, 4,
     gpt2_layers, None, None, None, {}),
    ("moe_fsdp_ep", "moe-gpt-small", {"fsdp": 2, "ep": 2}, 512, 4,
     moe_layers, None, (2, 2), None, {}),
    ("moe_sp_ep", "moe-gpt-small", {"dp": 1, "sp": 2, "ep": 2}, 1024, 4,
     moe_layers, "ring", (1, 2), None, {}),
    ("gpt2_sp_fsdp", "gpt2-medium", {"sp": 2, "fsdp": 2}, 1024, 4,
     gpt2_layers, "ring", None, None, {}),
    # The pipeline (phase_pipeline_train): the dry run's legs 4-6 and
    # pp beside fsdp, 8 x 512 tokens.
    ("gpt2_pp_dp", "gpt2-medium", {"dp": 2, "pp": 2}, 512, 8, gpt2_layers,
     None, None, "gpipe", {}),
    ("llama_pp_dp", "tinyllama-1.1b", {"dp": 2, "pp": 2}, 512, 8,
     llama_layers, None, None, "1f1b", {"remat": True}),
    ("llama_pp_tp", "tinyllama-1.1b", {"pp": 2, "tp": 2}, 512, 8,
     llama_layers, None, None, "1f1b", {"remat": False}),
    ("gpt2_pp_fsdp", "gpt2-medium", {"pp": 2, "fsdp": 2}, 512, 8,
     gpt2_layers, None, None, "1f1b", {}),
]
CKPT = ("gpt2_fsdp_tp", "llama_pp_tp")
res, pending = {}, []
t_all = time.perf_counter()
inits = {}              # rank 0: a model's seeded weights, drawn once
for key, name, axes, seq, rows, layers, mode, emulated, sched, over in RUNS:
    if key == PIPE[0]:
        t_pipe = time.perf_counter()
    ckpt = os.path.join(out_dir, f"ckpt_{key}") if key in CKPT else None
    gang, final, init = run(name, axes, seq, rows, layers, sp_mode=mode,
                            ckpt=ckpt, schedule=sched,
                            weights=inits.get((name, layers)), **over)
    res[key] = {"gang": gang}
    if rank == 0:
        inits.setdefault((name, layers), init)
        pending.append((key, name, seq, rows, layers, emulated, over,
                        final, init))
    del final, init
    dist.barrier()
del inits
res["gang_secs"] = time.perf_counter() - t_all
res["pipe_secs"] = time.perf_counter() - t_pipe
res["backend"] = dist.get_backend()
if rank == 0:
    # The group-less step on the same weights and batches, after the
    # gang's runs; the fsdp x tp and pp x tp checkpoints restored in one
    # process.
    for key, name, seq, rows, layers, emulated, over, final, init in \
            pending:
        ref, ref_final, _ = run(name, None, seq, rows, layers, weights=init,
                                emulated=emulated, **over)
        worst, tight = compare(final, ref_final)
        res[key].update(ref=ref, worst=worst, tight=tight)
        if key in CKPT:
            t0 = time.perf_counter()
            saved = CheckpointManager(os.path.join(out_dir,
                                                   f"ckpt_{key}")).restore()
            one = get_model(name).make_model(
                device="cuda", param_dtype=torch.float32,
                dtype=torch.float32, num_layers=layers, **over)
            one.load_state_dict(saved["params"])
            res[key]["ckpt"] = {
                "step": saved["step"],
                "equal": all(torch.equal(v.cpu(), final[k]) for k, v in
                             one.state_dict().items()),
                "groups": len(saved["opt_state"]["param_groups"]),
                "secs": time.perf_counter() - t0}
            del one, saved
        del ref_final
dist.barrier()

def train_main(argv):
    # phase_pipeline_train's bf16 run: train.main in these ranks as
    # `python -m polyaxon_tpu_torch.train ARGV` runs it (its bootstrap
    # finds the PTPU_* group up, and leaves it on its way out), in the
    # gang's directory; its launches and shapes, its parameter bytes at
    # the final checkpoint.
    import contextlib, io
    from polyaxon_tpu_torch import checkpoint, train
    held = {}
    real_save = checkpoint.CheckpointManager.save

    def save(self, step, state):
        model = state["params"]
        layout = model.pipeline_layout
        held["bytes"] = nbytes(model)
        held["full"] = sum(torch.Size(shape).numel() * dtype.itemsize
                           for n, shape, dtype in layout.entries
                           if n in layout.params)
        held["t0"] = time.perf_counter()
        return real_save(self, step, state)

    checkpoint.CheckpointManager.save = save
    os.environ["POLYAXON_TPU_HOME"] = os.path.join(out_dir, "home")
    os.chdir(out_dir)
    flash.launch_count = flash.dq_launch_count = flash.dkv_launch_count = 0
    shapes.clear()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = train.main(argv)
    torch.cuda.synchronize()
    end = time.perf_counter()
    return {"rc": rc, "lines": out.getvalue().splitlines(),
            "counts": counts(), "shapes": sorted(shapes),
            "local_bytes": held["bytes"], "full_bytes": held["full"],
            "secs": end - t0, "ckpt_secs": end - held["t0"]}

res["main"] = train_main(main_argv)
with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
    json.dump(res, f)
print("ok", flush=True)
"""


def _check_gang_run(tag, ranks, key, label, shape, launches) -> dict:
    """One float32 run of the compose gang (``COMPOSE_STEPS`` AdamW
    steps, lr ``TP_LR``) against its group-less step: every rank's flash
    shapes ``[shape]`` and launches (``launches(rec)`` -> (forward passes
    a layer, layer launches a step)), losses rel 1e-5, every parameter
    within 2 lr a step and 99% of the elements within 2e-6; prints the
    ``[tag]`` lines (parameter bytes and step ms a rank) and returns the
    launches summed over the ranks."""
    phase = f"{tag}-train {key}"
    for r, rank in enumerate(ranks):
        rec = rank[key]["gang"]
        if rec["shapes"] != [shape]:
            raise AssertionError(f"{phase} rank {r}: flash shapes "
                                 f"{rec['shapes']}, not {[shape]}")
        passes, per_step = launches(rec)
        _check_per_step(rec["counts"], COMPOSE_STEPS, per_step,
                        f"{phase} rank {r}", passes)
    c = ranks[0][key]
    bound = 2 * TP_LR * COMPOSE_STEPS
    rel = max(abs(g - w) / abs(w) for g, w in
              zip(c["gang"]["losses"], c["ref"]["losses"]))
    if rel > 1e-5 or c["worst"] > bound or c["tight"] < 0.99:
        raise AssertionError(
            f"{phase} float32: losses {c['gang']['losses']} vs "
            f"{c['ref']['losses']} (rel {rel:.3g} > 1e-5?), params max "
            f"|d| {c['worst']:.3g} (> {bound}?), {c['tight']:.4f} within "
            f"2e-6 (< 0.99?)")
    full = c["ref"]["full_bytes"]
    gangs = [rank[key]["gang"] for rank in ranks]
    print(f"[{tag}] {label} float32, {COMPOSE_STEPS} AdamW steps (lr "
          f"{TP_LR}): gang == group-less step: loss rel {rel:.2e}, params "
          f"max |d| {c['worst']:.2e} ({c['tight']:.6f} within 2e-6); losses "
          + ", ".join(f"{x:.6f}" for x in c["gang"]["losses"])
          + (f", aux " + ", ".join(f"{x:.6f}" for x in c["gang"]["aux"])
             if c["gang"]["aux"] else ""))
    print(f"[{tag}] {label}: parameter bytes a rank "
          + ", ".join(f"{g['local_bytes']}" for g in gangs)
          + " (ranks 0-3, coordinates " + "; ".join(
              ", ".join(f"{a} {v}" for a, v in g["coord"].items() if v)
              or "0" for g in gangs)
          + f") against {full} group-less ("
          + ", ".join(f"{g['local_bytes'] / full:.4f}" for g in gangs)
          + f"); step ms after the first, rank 0: "
          f"{_tp_step_ms(c['gang']):.2f} against group-less "
          f"{_tp_step_ms(c['ref']):.2f}; flash launches "
          + ", ".join(f"{g['counts']}" for g in gangs)
          + f" at {shape}; {card_line()}")
    return {k: sum(g["counts"][k] for g in gangs) for k in gangs[0]["counts"]}


def phase_compose_train(gang=None) -> dict:
    """Composed training meshes on the card: a FOUR-process gang on the
    one card (every rank on ``cuda:0``, gloo over the card's tensors, as
    ``phase_tp_train``'s), started through the PTPU_* bootstrap.  float32,
    full width, ``COMPOSE_STEPS`` AdamW steps (lr ``TP_LR``) each
    against the group-less step on the same weights and batches:

    - GPT-2 medium (``F32_LAYERS`` layers) at ``dp:1,fsdp:2,tp:2``,
      4 x 512 tokens: each rank 8 local heads of 2 rows, [2, 512, 8,
      64]; its collective checkpoint restored in one process;
    - MoE-GPT-small (``TP_MOE_F32_LAYERS`` layers) at ``fsdp:2,ep:2``,
      4 x 512 ([2, 512, 12, 64]), and at ``sp:2,ep:2`` on the flash
      ring, 4 x 1024 ([4, 512, 12, 64] blocks); the group-less step
      routes as the reference's ``moe_layer`` does, each (data, ep)
      block with its own capacity;
    - GPT-2 medium at ``sp:2,fsdp:2`` on the flash ring, 4 x 1024
      ([2, 512, 16, 64] blocks).

    Losses rtol 1e-5, every parameter within 2 lr a step and 99% of the
    elements within 2e-6 (``phase_tp_train``'s tolerances); each rank's
    flash launches and shapes (the ring's sp rank 0 its diagonal block,
    rank 1 its diagonal and past block a layer), so a quiet plain or
    local attention fails the phase; each rank's parameter bytes
    against the group-less model's.  Four ranks on one card over a
    host-staged gloo group measure correctness and the layout's cost,
    not scaling.  Prints ``[compose]`` lines and ``[time]
    compose-train``."""
    t_phase = time.perf_counter()
    gang = gang or _start_compose_gang()
    overlapped = max(0.0, t_phase - gang["t0"])
    ranks = _gang_results(gang, "compose-train")
    res = ranks[0]
    out = {}
    for key, label, layers, shape, ring in (
            ("gpt2_fsdp_tp", "gpt2-medium dp:1,fsdp:2,tp:2, 4 x 512",
             F32_LAYERS, [2, 512, 8, 64], False),
            ("moe_fsdp_ep", "moe-gpt-small fsdp:2,ep:2, 4 x 512",
             TP_MOE_F32_LAYERS, [2, 512, 12, 64], False),
            ("moe_sp_ep", "moe-gpt-small dp:1,sp:2,ep:2 ring, 4 x 1024",
             TP_MOE_F32_LAYERS, [4, 512, 12, 64], True),
            ("gpt2_sp_fsdp", "gpt2-medium sp:2,fsdp:2 ring, 4 x 1024",
             F32_LAYERS, [2, 512, 16, 64], True)):
        out[f"compose_{key}"] = _check_gang_run(
            "compose", ranks, key, f"{label}, {layers} layers", shape,
            lambda rec, layers=layers, ring=ring: (
                1, layers * (1 + rec["coord"]["sp"] if ring else 1)))
    ck = res["gpt2_fsdp_tp"]["ckpt"]
    if not ck["equal"] or ck["groups"] != 1 or ck["step"] != COMPOSE_STEPS:
        raise AssertionError(f"compose-train: the fsdp x tp checkpoint "
                             f"restored in one process: {ck}")
    print(f"[compose] the dp:1,fsdp:2,tp:2 gang's checkpoint (saved in "
          f"{res['gpt2_fsdp_tp']['gang']['ckpt_secs']:.1f} s) restored in "
          f"one process in {ck['secs']:.1f} s: the one-process layout "
          f"(one optimizer group), parameters == the gang's gathered ones")
    print(f"[time] compose-train: {time.perf_counter() - t_phase:.1f} s "
          f"(the ranks started {overlapped:.1f} s before, beside the "
          f"phases then running; the gang's runs "
          f"{res['gang_secs'] - res['pipe_secs']:.1f} s, then "
          f"phase_pipeline_train's float32 runs {res['pipe_secs']:.1f} s "
          f"and train.main {res['main']['secs']:.1f} s; rank 0's: "
          + ", ".join(
              f"{k} gang {res[k]['gang']['secs']:.1f} s (set-up "
              f"{res[k]['gang']['setup_secs']:.1f} s), group-less "
              f"{res[k]['ref']['secs']:.1f} s" for k in (
                  "gpt2_fsdp_tp", "moe_fsdp_ep", "moe_sp_ep",
                  "gpt2_sp_fsdp")) + ")")
    return {"flash_launches": out, "ranks": ranks,
            "step_ms": {k: _tp_step_ms(res[k]["gang"]) for k in (
                "gpt2_fsdp_tp", "moe_fsdp_ep", "moe_sp_ep",
                "gpt2_sp_fsdp")}}


def _start_compose_gang() -> dict:
    """``phase_compose_train``'s four rank processes
    (:func:`_start_gang`), which run ``phase_pipeline_train``'s checks
    too: its float32 runs, then ``train.main`` of GPT-2 medium at full
    depth, ``--strategy pp:2`` (1F1B; dp 2 fills the four ranks), 8 x
    1024, bf16."""
    return _start_gang(COMPOSE_RANK, 4, [
        COMPOSE_STEPS, TP_LR, F32_LAYERS, TP_MOE_F32_LAYERS,
        LLAMA_F32_LAYERS, "--model", "gpt2-medium", "--steps", PIPE_STEPS,
        "--log-every", 1, "--batch-size", 8, "--strategy", "pp:2"],
        "ptpu_compose_")


PIPE_STEPS = 2              # bf16 train.main steps of the pipeline run


def _pipe_launches(schedule: str, micros: int, layers: int,
                   remat: bool) -> tuple:
    """(forward passes a layer, layer-micros) of a pp rank's step, from
    the schedule: every micro through the rank's ``layers`` blocks, the
    forward once (GPipe keeps its graph) or twice (1F1B's backward slot
    re-runs it), once more each under remat; dq and dkv once."""
    return (1 if schedule == "gpipe" else 2) + int(remat), micros * layers


def phase_pipeline_train(compose_ranks, groupless_ms: float) -> dict:
    """Pipeline parallelism in training on the card (the dry run's legs
    4-6 and pp beside fsdp).

    1. float32, in ``phase_compose_train``'s four ranks (gloo on
       ``cuda:0``), ``COMPOSE_STEPS`` AdamW steps of 8 x 512 tokens each
       against the group-less step on the same weights and batches, with
       its tolerances: GPT-2 medium (``F32_LAYERS`` layers) at
       ``dp:2,pp:2`` on GPipe and at ``pp:2,fsdp:2`` on 1F1B; TinyLlama's
       width (``LLAMA_F32_LAYERS`` layers) at ``dp:2,pp:2`` on 1F1B under
       remat and at ``pp:2,tp:2`` on 1F1B, whose collective checkpoint
       is restored in one process.  4 microbatches a step (2 pp); each
       rank's flash launches and shapes as the schedule gives them
       (:func:`_pipe_launches`), so a quiet plain-attention fallback
       fails; each rank's parameter bytes against the group-less
       model's.
    2. then, in the same four ranks as the PTPU_* block started them,
       bf16 GPT-2 medium at full depth through ``train.main --strategy
       pp:2`` (``pp:2,dp:2``, 1F1B, 8 x 1024, ``PIPE_STEPS`` steps):
       equal losses on every rank, the launches and shapes a rank,
       parameter bytes, and the last step's ms a rank against
       ``groupless_ms`` (``phase_train_timed``'s group-less step on the
       same batch shape).
    Four ranks on one card over a host-staged gloo group measure
    correctness and the layout's cost, not scaling; they run beside the
    script's phases from ``phase_mesh`` on (``main``), so their step ms
    are taken beside those.  Prints ``[pipeline]`` lines and ``[time]
    pipeline-train``."""
    res = compose_ranks[0]
    card = card_line()
    out = {}
    for key, label, layers, shape, schedule, remat in (
            ("gpt2_pp_dp", "gpt2-medium dp:2,pp:2 GPipe", F32_LAYERS,
             [1, 512, 16, 64], "gpipe", False),
            ("llama_pp_dp", f"{LLAMA} width dp:2,pp:2 1F1B under remat",
             LLAMA_F32_LAYERS, [1, 512, 32, 64], "1f1b", True),
            ("llama_pp_tp", f"{LLAMA} width pp:2,tp:2 1F1B",
             LLAMA_F32_LAYERS, [2, 512, 16, 64], "1f1b", False),
            ("gpt2_pp_fsdp", "gpt2-medium pp:2,fsdp:2 1F1B", F32_LAYERS,
             [1, 512, 16, 64], "1f1b", False)):
        launches = _pipe_launches(schedule, 4, layers // 2, remat)
        out[f"pipeline_{key}"] = _check_gang_run(
            "pipeline", compose_ranks, key,
            f"{label}, {layers} layers, 8 x 512, 4 microbatches ("
            f"{launches[0]} x {launches[1]} forward, {launches[1]} dq and "
            f"dkv a step)", shape, lambda rec, launches=launches: launches)
    ck = res["llama_pp_tp"]["ckpt"]
    if not ck["equal"] or ck["groups"] != 1 or ck["step"] != COMPOSE_STEPS:
        raise AssertionError(f"pipeline-train: the pp x tp checkpoint "
                             f"restored in one process: {ck}")
    print(f"[pipeline] the pp:2,tp:2 gang's checkpoint (saved in "
          f"{res['llama_pp_tp']['gang']['ckpt_secs']:.1f} s: each stage's "
          f"blocks from their pp rank) restored in one process in "
          f"{ck['secs']:.1f} s: the one-process layout (one optimizer "
          f"group), parameters == the gang's gathered ones")
    mains = [rank["main"] for rank in compose_ranks]
    passes, per_step = _pipe_launches("1f1b", 4, 12, False)
    losses, step_ms = [], []
    for r, m in enumerate(mains):
        lines = [ln for ln in m["lines"] if ln.startswith("step ")]
        got = [float(re.search(r"loss=(\S+)", ln).group(1))
               for ln in lines]
        tps = float(re.search(r"tok_per_sec_per_chip=(\S+)",
                              lines[-1]).group(1))
        # tok/s a chip over the last step, 4 ranks: its wall ms.
        step_ms.append(8 * 1024 / (tps * 4) * 1e3)
        if m["rc"] != 0 or len(got) != PIPE_STEPS or \
                not all(np.isfinite(got)) or \
                m["shapes"] != [[1, 1024, 16, 64]]:
            raise AssertionError(f"pipeline-train train.main rank {r}: "
                                 f"rc {m['rc']}, losses {got}, shapes "
                                 f"{m['shapes']}\n" + "\n".join(m["lines"]))
        _check_per_step(m["counts"], PIPE_STEPS, per_step,
                        f"pipeline-train train.main rank {r}", passes)
        losses.append(got)
    if any(g != losses[0] for g in losses):
        raise AssertionError(f"pipeline-train train.main: the ranks' "
                             f"losses differ: {losses}")
    for line in mains[0]["lines"]:
        print(f"[pipeline] train.main rank 0: {line}")
    print(f"[pipeline] bf16 gpt2-medium 24 layers, train.main --strategy "
          f"pp:2 (dp:2,pp:2 on four ranks, 1F1B, 4 microbatches of 1 x "
          f"1024 a data rank), 8 x 1024, {PIPE_STEPS} steps: losses "
          + ", ".join(f"{x:.4f}" for x in losses[0])
          + " on every rank; step ms of the last step a rank (beside the "
          "phases then running) " + ", ".join(f"{x:.1f}" for x in step_ms)
          + f" against the group-less step's {groupless_ms:.1f} "
          f"(phase_train_timed, same batch, alone); parameter bytes a rank "
          + ", ".join(f"{m['local_bytes']}" for m in mains)
          + f" (float32 masters) against the whole model's "
          f"{mains[0]['full_bytes']} ("
          + ", ".join(f"{m['local_bytes'] / m['full_bytes']:.4f}"
                      for m in mains) + "); "
          f"flash launches a rank " + ", ".join(f"{m['counts']}"
                                               for m in mains)
          + f" at [1, 1024, 16, 64] ({passes} x {per_step} forward, "
          f"{per_step} dq and dkv a step); train.main "
          + ", ".join(f"{m['secs']:.1f}" for m in mains)
          + f" s a rank (the final checkpoint {mains[0]['ckpt_secs']:.1f} "
          f"s); {card}")
    out["pipeline_train_main"] = {k: sum(m["counts"][k] for m in mains)
                                  for k in mains[0]["counts"]}
    print(f"[time] pipeline-train: {res['pipe_secs'] + mains[0]['secs']:.1f}"
          f" s of phase_compose_train's ranks' run (the float32 runs "
          f"{res['pipe_secs']:.1f} s, train.main {mains[0]['secs']:.1f} "
          f"s on rank 0)")
    return {"flash_launches": out,
            "step_ms": {"gpt2 pp2 dp2 train.main": float(np.mean(step_ms)),
                        "gpt2": groupless_ms}}


def phases_compose_and_pipeline() -> dict:
    """``phase_compose_train`` and ``phase_pipeline_train`` alone, as
    the script runs them (the group-less GPT-2 step from
    ``phase_train_timed``)."""
    phase_build()
    timed = phase_train_timed()
    compose = phase_compose_train()
    return phase_pipeline_train(compose.pop("ranks"), timed["step_ms"])


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
        _release()


ZOO_POLICY = "dots_with_no_batch_dims_saveable"


def _route_grads(model, loss_of, layers: int, where: str):
    """(loss, logits, grads) through the flash route (``layers`` launches
    of each kernel) and through the plain-attention route, then the
    worst relative differences: (loss rel, logits rel, grad rel, at)."""
    from polyaxon_tpu_torch.ops import attention

    def run():
        model.zero_grad(set_to_none=True)
        loss, logits = loss_of(model)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), logits.detach(), {
            n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}

    _zero_counts()
    flash = run()
    counts = _counts()
    eligible = attention.flash_eligible
    try:
        attention.flash_eligible = lambda *a, **kw: False
        plain = run()
    finally:
        attention.flash_eligible = eligible
    if counts != {n: layers for n in counts} or \
            any(_counts()[n] != layers for n in counts):
        raise AssertionError(f"{where}: flash launches {counts}, then "
                             f"{_counts()} after the plain route")
    worst, at = 0.0, ""
    for name, g in plain[2].items():
        rel = (flash[2][name] - g).abs().max().item() / max(
            g.abs().max().item(), 1e-30)
        if rel > worst:
            worst, at = rel, name
    logits_rel = (flash[1] - plain[1]).abs().max().item() / \
        plain[1].abs().max().item()
    return abs(flash[0] - plain[0]) / abs(plain[0]), logits_rel, worst, at


def _zoo_bert():
    """(a) BERT-base MLM at full width and depth, bf16 on float32 master
    weights, 32 x 512: ``train.main`` for 3 steps (12 forward, 12 dq and
    12 dkv launches a step: every layer's non-causal attention through
    the flash kernels), a timed ``TrainStep`` loop (step ms, tok/s, MFU
    of ``_bert_train_flops``), and at 2 layers of its width in float32
    the flash route's loss, logits and gradients against plain
    attention, without and with a padded ``attention_mask`` (the
    kernels' ``kv_mask``)."""
    import torch.nn.functional as F

    from polyaxon_tpu_torch import prng
    from polyaxon_tpu_torch.models.registry import get_model
    from polyaxon_tpu_torch.parallel import make_train_step
    from polyaxon_tpu_torch.train import make_optimizer

    name, steps, batch = "bert-base", 3, 32
    with _train_main(["--model", name, "--steps", str(steps),
                      "--log-every", "1", "--batch-size",
                      str(batch)]) as run:
        layers = run["model"].cfg.num_layers
        _check_per_step(run["counts"], steps, layers, "train.main bert")
        main_counts = run["counts"]
        print(f"[zoo] bert-base train.main, batch {batch} x 512, {steps} "
              f"steps in {run['secs']:.1f} s (init, steps, the final "
              f"checkpoint): losses "
              + ", ".join(f"{v:.4f}" for v in run["losses"])
              + f"; flash launches {main_counts} ({layers} / {layers} / "
              f"{layers} a step)")
    _release()
    spec = get_model(name)
    model = spec.init_params(seed=0, device="cuda", train=True)
    step_fn = make_train_step(spec.loss_fn(model),
                              make_optimizer("adamw", 1e-4))
    state = step_fn.init_state(model)
    data = {"inputs": torch.as_tensor(spec.make_batch(batch)["inputs"],
                                      device="cuda")}
    key = prng.PRNGKey(0, device="cuda")
    state, _ = step_fn(state, data, prng.fold_in(key, 0))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    state, metrics = step_fn(state, data, prng.fold_in(key, 1))
    torch.cuda.synchronize()
    step_counts = _counts()
    _check_per_step(step_counts, 1, layers, "bert TrainStep")
    t0 = time.perf_counter()
    for i in range(5):
        state, metrics = step_fn(state, data, prng.fold_in(key, 2 + i))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 5
    flops = spec.train_flops(batch)
    rec = {"step_ms": step_s * 1e3, "tok_per_s": batch * 512 / step_s,
           "mfu": flops / step_s / 989e12,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss": float(metrics["loss"]),
           "masked_tokens": int(metrics["masked_tokens"])}
    if not np.isfinite(rec["loss"]):
        raise AssertionError(f"bert TrainStep: loss {rec['loss']}")
    print(f"[zoo] bert-base TrainStep batch {batch} x 512 bf16 (f32 master "
          f"weights, AdamW, MLM mask 0.15 from the step's key): "
          f"{rec['step_ms']:.2f} ms a step (5 steps), "
          f"{rec['tok_per_s']:.0f} tok/s, MFU {rec['mfu']:.4f} "
          f"({flops / 1e12:.2f} TFLOP a step, floor "
          f"{flops / 989e12 * 1e3:.2f} ms); peak memory "
          f"{rec['peak_memory_gb']:.2f} GB; loss {rec['loss']:.4f} over "
          f"{rec['masked_tokens']} masked tokens; flash launches a step "
          f"{step_counts}")
    del state, step_fn, model
    _release()
    small = spec.init_params(seed=0, device="cuda", train=True,
                             dtype=torch.float32, num_layers=2)
    tokens = torch.as_tensor(spec.make_batch(4)["inputs"], device="cuda")
    pad = torch.ones_like(tokens)
    pad[1, 300:] = 0
    pad[3, 130:] = 0
    for label, am in (("no mask", None), ("padded attention_mask", pad)):
        def loss_of(m, am=am):
            logits = m(tokens, attention_mask=am)
            keep = torch.ones_like(tokens, dtype=torch.bool) \
                if am is None else am.bool()
            return F.cross_entropy(logits[keep], tokens[keep]), logits
        loss_rel, logits_rel, worst, at = _route_grads(
            small, loss_of, 2, f"bert route ({label})")
        ok = loss_rel <= 1e-5 and logits_rel <= 1e-4 and worst <= 1e-4
        print(f"[zoo] bert-base width, 2 layers, float32, {label}: flash "
              f"vs plain attention: loss rel {loss_rel:.2e} (tol 1e-5), "
              f"logits max|d| / max|logit| {logits_rel:.2e} (tol 1e-4), "
              f"max |d grad| / max |grad| {worst:.2e} at {at} (tol 1e-4) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"bert flash route disagrees with plain "
                                 f"attention ({label})")
    del small
    _release()
    rec.update(main_counts=main_counts, step_counts=step_counts)
    return rec


def _zoo_resnet(steps: int = 5, batch: int = 128):
    """(b) ResNet-50 at batch 128 x 224 x 224, bf16 convolutions on
    float32 master weights, SGD with momentum (the example's): img/s
    (the baseline's metric, on one card), MFU of
    ``_RESNET50_TRAIN_FLOPS_PER_IMG``, the batch norms' running averages
    moved by a step, eval-mode logits finite, and whether it runs
    channels-last."""
    from polyaxon_tpu_torch.models.layers import batch_stats
    from polyaxon_tpu_torch.models.registry import get_model
    from polyaxon_tpu_torch.parallel import make_train_step
    from polyaxon_tpu_torch.train import make_optimizer

    spec = get_model("resnet50")
    model = spec.init_params(seed=0, device="cuda", train=True)
    step_fn = make_train_step(spec.loss_fn(model),
                              make_optimizer("sgd", 0.1))
    state = step_fn.init_state(model)
    data = {k: torch.as_tensor(v, device="cuda")
            for k, v in spec.make_batch(batch).items()}
    for _ in range(2):                      # warm-up: cuDNN picks kernels
        state, metrics = step_fn(state, data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = [b.clone() for b in batch_stats(model)]
    _zero_counts()
    state, metrics = step_fn(state, data)
    torch.cuda.synchronize()
    counts = _counts()
    moved = sum(not torch.equal(a, b)
                for a, b in zip(before, batch_stats(model)))
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step_fn(state, data)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    with torch.no_grad():
        x = data["inputs"].to(model.cfg.dtype).permute(0, 3, 1, 2)
        stem = model.stem_conv(x)
        logits = model(data["inputs"], train=False)
    channels_last = stem.is_contiguous(memory_format=torch.channels_last)
    flops = spec.train_flops(batch)
    rec = {"step_ms": step_s * 1e3, "img_per_s": batch / step_s,
           "mfu": flops / step_s / 989e12,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss": float(metrics["loss"]), "channels_last": channels_last,
           "flash_launches": counts}
    ok = moved == len(before) and bool(torch.isfinite(logits).all()) and \
        logits.shape == (batch, 1000) and np.isfinite(rec["loss"]) and \
        all(v == 0 for v in counts.values())
    print(f"[zoo] resnet50 batch {batch} x 224 x 224 bf16 (f32 master "
          f"weights, f32 batch norm, SGD momentum 0.9): "
          f"{rec['step_ms']:.2f} ms a step ({steps} steps), "
          f"{rec['img_per_s']:.1f} img/s, MFU {rec['mfu']:.4f} "
          f"({flops / 1e12:.2f} TFLOP a step); peak memory "
          f"{rec['peak_memory_gb']:.2f} GB; loss {rec['loss']:.4f}; "
          f"running averages moved by a step: {moved} of {len(before)}; "
          f"eval-mode logits finite {list(logits.shape)}; channels_last: "
          f"{channels_last}; flash launches {counts} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("resnet50 training check failed")
    del state, step_fn, model, data, stem, logits
    _release()
    return rec


def _cli_env(home):
    """The environment a ``ptpu-torch`` subprocess gets: a temporary
    home, this checkout on the path, no run of this process's."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("POLYAXON_TPU_RUN_UUID", "POLYAXON_TPU_HOST")}
    env.update({
        "POLYAXON_TPU_HOME": home,
        "PYTHONPATH": os.pathsep.join(
            [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
        "POLYAXON_TPU_SERVICE_READY_TIMEOUT": "180"})
    return env


def _zoo_mnist():
    """(c) ``run -f mnist.yaml`` as a user types it: the MLP on digits to
    the example's ``eval_accuracy>=0.95`` target, read back through the
    store."""
    from polyaxon_tpu_torch.client import FileRunStore
    from polyaxon_tpu_torch.lifecycle import V1Statuses

    with tempfile.TemporaryDirectory() as home:
        store = FileRunStore(home)
        rc, out, wall = _ptpu(_cli_env(home), "run", "-f",
                              os.path.join(EXAMPLES, "mnist.yaml"),
                              "--no-watch")
        uuid = _uuid_of(out)
        rec = store.get_run(uuid)
        logs = store.read_logs(uuid)
        acc = rec["outputs"].get("eval_accuracy")
        evals = store.read_events(uuid, "metric", "eval_accuracy")
        ok = rc == 0 and rec["status"] == V1Statuses.SUCCEEDED and \
            acc is not None and acc >= 0.95 and \
            "reached" in logs and "on cuda" in logs
        print(f"[zoo] run -f mnist.yaml: {rec['status']}, `run` wall "
              f"{wall:.1f} s; eval_accuracy by step "
              + ", ".join(f"{e['step']}: {e['value']:.4f}" for e in evals)
              + f"; outputs.eval_accuracy {acc} (target 0.95) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"run mnist.yaml: exit {rc}\n{out[-2000:]}"
                                 f"\n{logs[-3000:]}")
    return {"wall_s": wall, "eval_accuracy": acc}


def phase_zoo():
    """The baseline's training zoo on the card: (a) BERT-base MLM,
    (b) ResNet-50, (c) ``run -f mnist.yaml``.  (d) ``--init-hf`` and
    (e) a named remat policy ride TinyLlama's phases
    (``phase_train_entry(..., init_hf_from=...)``, ``phase_zoo_remat``).
    Returns the records; (c) is still running in its own process (since
    PR 17, for the script's time: it trains an MLP, mostly process
    start-up), its record a handle for ``_finish_mnist``."""
    recs = {"mnist run -f": _start_mnist()}
    for label, fn in (("bert-base", _zoo_bert), ("resnet50", _zoo_resnet)):
        t0 = time.perf_counter()
        recs[label] = fn()
        print(f"[time] zoo: {label} {time.perf_counter() - t0:.1f} s")
    return recs


def _start_mnist() -> dict:
    """``_zoo_mnist`` on a thread: a handle for ``_finish_mnist``."""
    import threading

    box = {"t0": time.perf_counter()}

    def run():
        try:
            box["rec"] = _zoo_mnist()
        except BaseException as e:  # noqa: BLE001 - re-raised by finish
            box["error"] = e
        box["secs"] = time.perf_counter() - box["t0"]

    box["thread"] = threading.Thread(target=run, daemon=True)
    box["thread"].start()
    return box


def _finish_mnist(box: dict) -> dict:
    box["thread"].join()
    if "error" in box:
        raise box["error"]
    print(f"[time] zoo: mnist run -f {box['secs']:.1f} s, beside the "
          f"in-process zoo phases")
    return box["rec"]


def phase_zoo_remat(state_dict, full, steps: int = 3):
    """(e) TinyLlama at batch 4 x 2048 under the named remat policy
    ``dots_with_no_batch_dims_saveable`` (the dense layers' outputs
    saved, attention and the flash kernel recomputed): step ms and peak
    memory against ``full`` (``phase_llama_train``'s whole-layer remat,
    same weights and protocol), launches a step (44 / 22 / 22: the flash
    forward runs again); and at 2 layers of its width in float32 the
    policy's gradients equal whole-layer remat's."""
    from polyaxon_tpu_torch.models.registry import get_model
    from polyaxon_tpu_torch.parallel import make_train_step
    from polyaxon_tpu_torch.train import make_optimizer

    t0 = time.perf_counter()
    spec = get_model(LLAMA)
    model = spec.make_model(device="cuda", param_dtype=torch.float32,
                            remat_policy=ZOO_POLICY)
    model.load_state_dict(state_dict)
    model.train()
    step_fn = make_train_step(spec.loss_fn(model),
                              make_optimizer("adamw", 1e-3))
    state = step_fn.init_state(model)
    batch = {"inputs": torch.as_tensor(spec.make_batch(4)["inputs"],
                                       device="cuda")}
    state, metrics = step_fn(state, batch)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    state, metrics = step_fn(state, batch)
    torch.cuda.synchronize()
    counts = _counts()
    _check_per_step(counts, 1, model.cfg.num_layers,
                    f"llama TrainStep {ZOO_POLICY}", fwd_passes=2)
    t1 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step_fn(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t1) / steps * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    rec = {"step_ms": step_ms, "peak_memory_gb": peak,
           "mfu": spec.train_flops(4) / step_ms * 1e3 / 989e12,
           "flash_launches": counts}
    print(f"[zoo] {LLAMA} batch 4 x 2048 remat_policy={ZOO_POLICY}: "
          f"{step_ms:.2f} ms a step ({steps} steps), MFU {rec['mfu']:.4f}, "
          f"peak memory {peak:.2f} GB, against whole-layer remat "
          f"{full['step_ms']:.2f} ms and {full['peak_memory_gb']:.2f} GB; "
          f"loss {float(metrics['loss']):.4f}; flash launches a step "
          f"{counts}")
    del state, step_fn, model
    _release()
    tokens = torch.as_tensor(spec.make_batch(1)["inputs"], device="cuda")
    grads = {}
    for policy in (None, ZOO_POLICY):
        small = spec.init_params(seed=0, device="cuda", train=True,
                                 dtype=torch.float32, num_layers=2,
                                 remat_policy=policy)
        loss, _ = spec.loss_fn(small)({"inputs": tokens})
        loss.backward()
        grads[policy] = (loss.item(), {n: p.grad for n, p in
                                       small.named_parameters()})
        del small
    (l0, g0), (l1, g1) = grads[None], grads[ZOO_POLICY]
    worst = max((g1[n] - g).abs().max().item() / max(
        g.abs().max().item(), 1e-30) for n, g in g0.items())
    ok = abs(l1 - l0) <= 1e-6 * abs(l0) and worst <= 1e-6
    print(f"[zoo] {LLAMA} width, 2 layers, float32: {ZOO_POLICY} vs "
          f"whole-layer remat: loss {l1:.6f} vs {l0:.6f}, max |d grad| / "
          f"max |grad| {worst:.2e} (tol 1e-6) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{ZOO_POLICY} gradients differ from "
                             f"whole-layer remat")
    del grads
    _release()
    print(f"[time] zoo: named remat policy {time.perf_counter() - t0:.1f} s")
    return rec


# -- the rest of the zoo: MoE-GPT, T5, ViT ------------------------------

MOE = "moe-gpt-small"
T5 = "t5-small"
VIT = "vit-base"


def _timed_steps(spec, model, data, steps, lr=3e-4):
    """A warm-up ``TrainStep`` then ``steps`` timed ones (AdamW): (step
    seconds, the last metrics, flash launches of the timed steps)."""
    from polyaxon_tpu_torch.parallel import make_train_step
    from polyaxon_tpu_torch.train import make_optimizer

    step_fn = make_train_step(spec.loss_fn(model),
                              make_optimizer("adamw", lr))
    state = step_fn.init_state(model)
    state, metrics = step_fn(state, data)
    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step_fn(state, data)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    counts = _counts()
    metrics = {k: float(v) for k, v in metrics.items()}
    del state, step_fn
    return step_s, metrics, counts


def _train_line(tag, label, spec, batch, step_s, metrics, counts, unit,
                per_batch):
    flops = spec.train_flops(batch)
    rec = {"step_ms": step_s * 1e3, f"{unit}_per_s": per_batch / step_s,
           "mfu": flops / step_s / 989e12, "tflop_per_step": flops / 1e12,
           "flash_launches": counts, **metrics}
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{label}: metrics {metrics}")
    print(f"[{tag}] {label}: {rec['step_ms']:.2f} ms a step, "
          f"{rec[f'{unit}_per_s']:.1f} {unit}/s, MFU {rec['mfu']:.4f} "
          f"({rec['tflop_per_step']:.2f} TFLOP a step, floor "
          f"{flops / 989e12 * 1e3:.2f} ms); "
          + ", ".join(f"{k} {v:.4f}" for k, v in metrics.items())
          + f"; flash launches {counts}")
    return rec


def _route_line(tag, label, loss_of, model, layers, tol=1e-4):
    loss_rel, logits_rel, worst, at = _route_grads(model, loss_of, layers,
                                                   f"{tag} {label}")
    ok = loss_rel <= 1e-5 and logits_rel <= tol and worst <= tol
    print(f"[{tag}] {label}: flash vs plain attention: loss rel "
          f"{loss_rel:.2e} (tol 1e-5), logits max|d| / max|logit| "
          f"{logits_rel:.2e} (tol {tol:g}), max |d grad| / max |grad| "
          f"{worst:.2e} at {at} (tol {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag} {label}: flash route disagrees")


def _moe_zoo():
    """MoE-GPT-small: TrainStep at 8 x 1024 (12 / 12 / 12 launches a
    step), the flash route at 2 layers in float32, the float32 engine ==
    solo on both pools (4 requests), a bf16 HTTP load of 8 requests on
    the paged pool (no flash launch) and the eager greedy decode step."""
    import torch.nn.functional as F

    from polyaxon_tpu_torch.models import generate as G
    from polyaxon_tpu_torch.models.registry import get_model

    spec = get_model(MOE)
    recs = {}
    f32 = spec.init_params(seed=0, device="cuda", dtype=torch.float32)
    weights = f32.state_dict()
    model = spec.make_model(device="cuda", param_dtype=torch.float32)
    model.load_state_dict(weights)
    model.train()
    data = {"inputs": torch.as_tensor(spec.make_batch(8)["inputs"],
                                      device="cuda")}
    step_s, metrics, counts = _timed_steps(spec, model, data, 3)
    _check_per_step(counts, 3, 12, "moe TrainStep")
    recs["train"] = _train_line(
        "moe", f"{MOE} TrainStep 8 x 1024 bf16 (f32 master weights, f32 "
        f"router and experts, AdamW), 3 steps", spec, 8, step_s, metrics,
        {k: v // 3 for k, v in counts.items()}, "tok", 8 * 1024)
    recs["train"]["expert_products_ms"] = _expert_products_ms(model)
    del model
    _release()
    small = spec.init_params(seed=0, device="cuda", train=True,
                             dtype=torch.float32, num_layers=2)
    tokens = data["inputs"][:2]

    def loss_of(m):
        logits, aux = m(tokens, train=True)
        return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                               tokens[:, 1:].reshape(-1)) + 0.01 * aux, \
            logits

    _route_line("moe", f"{MOE} width, 2 layers, float32, 2 x 1024", loss_of,
                small, 2)
    del small
    _release()
    t0 = time.perf_counter()
    _f32_schedule(f32, MOE, tag="moe", pools=("paged",), n=4)
    print(f"[time] zoo rest: moe float32 engine {time.perf_counter() - t0:.1f}"
          f" s")
    del f32
    _release()
    bf = spec.make_model(device="cuda").eval().requires_grad_(False)
    bf.load_state_dict(weights)
    del weights
    rng = np.random.RandomState(0)
    bodies = [{"prompt": rng.randint(0, bf.cfg.vocab_size, n).tolist(),
               "max_new_tokens": 32} for n in rng.randint(64, 513, 8)]
    rec, (srv, ms, _) = _http_load(bf, "moe paged", bodies,
                                   warm_requests=1, name=MOE,
                                   idle_share=False, kv_paged=True)
    _stop(srv, ms)
    if any(rec["flash_launches"].values()):
        raise AssertionError(f"moe serving: flash launches "
                             f"{rec['flash_launches']}")
    recs["http"] = rec
    prompt = torch.as_tensor(np.random.RandomState(1).randint(
        0, bf.cfg.vocab_size, (8, 256)), device="cuda")
    with torch.no_grad():
        logits, cache = G.prefill(bf, prompt)
        tok = logits.argmax(-1)
        start, end = _events()
        for i in range(4):              # warm-up
            tok = G.extract_logits(bf(tok[:, None], decode=True,
                                      decode_position=256 + i,
                                      cache=cache))[:, -1].argmax(-1)
        start.record()
        for i in range(32):
            tok = G.extract_logits(bf(tok[:, None], decode=True,
                                      decode_position=260 + i,
                                      cache=cache))[:, -1].argmax(-1)
        end.record()
        torch.cuda.synchronize()
    recs["decode_step_ms"] = start.elapsed_time(end) / 32
    print(f"[moe] {MOE} bf16 greedy decode step (8 rows at positions "
          f"260-291, eager, one expert's weights gathered a token): "
          f"{recs['decode_step_ms']:.3f} ms; HTTP {rec['tok_per_s']:.1f} "
          f"tok/s, TTFT p50 {rec['ttft_p50_ms']:.1f} ms")
    del bf, cache
    _release()
    return recs


def _expert_products_ms(model, tokens: int = 8 * 1024) -> float:
    """Device ms of a step's expert products alone: one layer's bucketed
    float32 ``bmm``s (E x C rows, C = capacity of ``tokens``), forward
    and backward, times the layers (CUDA events, 5 repeats, median)."""
    from polyaxon_tpu_torch.models.moe_gpt import _experts

    cfg = model.cfg
    moe = model.h[0].moe
    cap = int(cfg.capacity_factor * tokens / cfg.num_experts)
    gen = torch.Generator(device="cuda").manual_seed(0)
    buckets = torch.randn((cfg.num_experts, cap, cfg.hidden_size),
                          generator=gen, device="cuda", requires_grad=True)
    times = []
    for _ in range(6):
        start, end = _events()
        start.record()
        out = _experts(buckets, moe.experts_w1, moe.experts_w2)
        torch.autograd.grad(out, (buckets, moe.experts_w1,
                                  moe.experts_w2), torch.ones_like(out))
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times[1:]) * cfg.num_layers
    flops = 3 * 2 * 2 * cfg.num_experts * cap * cfg.hidden_size \
        * cfg.intermediate_size * cfg.num_layers
    print(f"[moe] the expert products alone (float32 bmm, {cfg.num_experts}"
          f" x {cap} bucket rows, forward + backward, x {cfg.num_layers} "
          f"layers): {ms:.2f} ms a step for {flops / 1e12:.2f} TFLOP "
          f"({flops / ms / 1e9:.1f} TFLOP/s)")
    return ms


def _t5_no_cache_greedy(model, src, n):
    """Greedy decoding that reruns the teacher-forced decoder over the
    whole prefix every step: (tokens [B, n], per-step top-2 gaps)."""
    ids = torch.zeros((src.shape[0], 1), dtype=torch.long, device="cuda")
    gaps = []
    with torch.no_grad():
        enc = model.encode(src)
        for _ in range(n):
            last = model.decode(ids, enc)[:, -1]
            top = torch.topk(last, 2).values
            gaps.append((top[:, 0] - top[:, 1]).min().item())
            ids = torch.cat([ids, last.argmax(-1, keepdim=True)], dim=1)
    return ids[:, 1:], gaps


def _t5_zoo(tmp):
    """T5-small: ``train.main --dataset span-corruption`` (16 x 512
    inputs / 128 targets, 6 / 6 / 6 launches a step), a timed TrainStep
    on the synthetic batch, the cross-attention's flash route at 2 + 2
    layers in float32 with and without ``enc_mask``, cached greedy ==
    no-cache greedy and 1 beam == greedy in float32, and bf16 ms a
    token for greedy and 4 beams."""
    from polyaxon_tpu_torch.models import generate as G
    from polyaxon_tpu_torch.models.registry import get_model
    from polyaxon_tpu_torch.models.t5 import shift_right

    spec = get_model(T5)
    recs = {}
    data_dir = os.path.join(tmp, "t5_tokens")
    os.makedirs(data_dir)
    np.save(os.path.join(data_dir, "tokens.npy"), np.random.RandomState(
        0).randint(2, 32000, 400_000).astype(np.int32))
    with _train_main(["--model", T5, "--steps", "3", "--log-every", "1",
                      "--batch-size", "16", "--dataset", "span-corruption",
                      "--data-dir", data_dir]) as run:
        _check_per_step(run["counts"], 3, 6, "t5 train.main")
        recs["main_counts"] = run["counts"]
        print(f"[t5] {T5} train.main --dataset span-corruption, batch 16 "
              f"x 512 inputs / 128 targets, 3 steps in {run['secs']:.1f} "
              f"s: losses " + ", ".join(f"{v:.4f}" for v in run["losses"])
              + f"; flash launches {run['counts']} (6 / 6 / 6 a step: "
              f"the decoder's cross-attention, 128 rows over 512 "
              f"key-padded keys)")
    _release()
    model = spec.init_params(seed=0, device="cuda", train=True)
    data = {"inputs": torch.as_tensor(spec.make_batch(16)["inputs"],
                                      device="cuda")}
    step_s, metrics, counts = _timed_steps(spec, model, data, 3, lr=1e-3)
    _check_per_step(counts, 3, 6, "t5 TrainStep")
    recs["train"] = _train_line(
        "t5", f"{T5} TrainStep 16 x 512 -> 512 bf16 (f32 master weights, "
        f"AdamW), 3 steps", spec, 16, step_s, metrics,
        {k: v // 3 for k, v in counts.items()}, "tok", 16 * 512)
    del model
    _release()
    # Gated-GELU (T5 v1.1's FFN): under ReLU a pre-activation within
    # float32 rounding of 0 flips between the routes and moves a whole
    # token's term of the FFN's gradient (2e-2 of the largest on the
    # CPU with no kernel at all; gated-GELU: 3.4e-6).
    small = spec.init_params(seed=0, device="cuda", train=True,
                             dtype=torch.float32, num_layers=2,
                             num_decoder_layers=2,
                             feed_forward="gated-gelu")
    with torch.no_grad():
        # T5's own init folds d_kv ** -0.5 into the queries; the zoo's
        # flax default leaves scores of std ~8, where two float32
        # routes' gradients differ by ~1e-4 of the largest.
        for name, p in small.named_parameters():
            if "q_proj" in name:
                p.mul_(small.cfg.d_kv ** -0.5)
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in spec.make_batch(4).items()}
    pad = torch.ones_like(batch["inputs"])
    pad[1, 300:] = 0
    pad[3, 130:] = 0
    for label, mask in (("no mask", None), ("enc_mask", pad)):
        def loss_of(m, mask=mask):
            src = batch["inputs"]
            logits = m(src, shift_right(src, 0), enc_mask=mask)
            return torch.nn.functional.cross_entropy(
                logits.reshape(-1, logits.shape[-1]),
                src.reshape(-1)), logits
        _route_line("t5", f"{T5} width, gated-GELU, 2 + 2 layers, "
                    f"float32, 4 x 512, {label}", loss_of, small, 2)
    del small
    _release()
    f32 = spec.init_params(seed=0, device="cuda", dtype=torch.float32)
    src = torch.as_tensor(np.random.RandomState(2).randint(
        2, 32000, (2, 512)), device="cuda")
    got = G.generate_seq2seq(f32, src, max_new_tokens=24)
    want, gaps = _t5_no_cache_greedy(f32, src, 24)
    beam1 = G.generate_beam_seq2seq(f32, src, max_new_tokens=24,
                                    num_beams=1)
    first = next((i for i in range(24)
                  if not torch.equal(got[:, i], want[:, i])), None)
    ok = (first is None or gaps[first] < 1e-4) and torch.equal(beam1, got)
    print(f"[t5] float32 generate_seq2seq (2 x 512 encoder tokens, 24 "
          f"new) == no-cache greedy: "
          + ("all equal" if first is None else
             f"first difference at token {first}, solo top-2 gap "
             f"{gaps[first]:.2e} (tie rule, limit 1e-4)")
          + f"; generate_beam_seq2seq 1 beam == greedy: "
          f"{torch.equal(beam1, got)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("t5 cached decoding disagrees")
    weights = f32.state_dict()
    del f32
    _release()
    bf = spec.make_model(device="cuda").eval().requires_grad_(False)
    bf.load_state_dict(weights)
    src = torch.as_tensor(np.random.RandomState(3).randint(
        2, 32000, (4, 512)), device="cuda")
    for label, fn in (("greedy", lambda: G.generate_seq2seq(
            bf, src, max_new_tokens=64)),
                      ("4 beams", lambda: G.generate_beam_seq2seq(
                          bf, src, max_new_tokens=64, num_beams=4))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms_tok = (time.perf_counter() - t0) * 1e3 / 64
        recs[f"{label} ms_per_token"] = ms_tok
        print(f"[t5] {T5} bf16 {label}: 4 x 512 encoder tokens, 64 new "
              f"tokens, {ms_tok:.3f} ms a token (wall, encode included); "
              f"shape {list(out.shape)}")
    del bf
    _release()
    return recs, weights


def _vit_zoo():
    """ViT-B/16 TrainStep at 64 x 224 x 224: img/s, MFU, no flash
    launch (197 tokens)."""
    from polyaxon_tpu_torch.models.registry import get_model

    spec = get_model(VIT)
    model = spec.init_params(seed=0, device="cuda", train=True)
    data = {k: torch.as_tensor(v, device="cuda")
            for k, v in spec.make_batch(64).items()}
    step_s, metrics, counts = _timed_steps(spec, model, data, 3, lr=1e-3)
    if any(counts.values()):
        raise AssertionError(f"vit: flash launches {counts}")
    rec = _train_line("vit", f"{VIT} TrainStep 64 x 224 x 224 bf16 (f32 "
                      f"master weights, AdamW, 197 tokens: plain "
                      f"attention), 3 steps", spec, 64, step_s, metrics,
                      counts, "img", 64)
    weights = model.state_dict()
    del model
    _release()
    return rec, weights


def _init_hf_round_trip(name, state_dict, batch, export):
    """``train.main --init-hf`` of ``export`` of a model holding
    ``state_dict``: the first tracked loss equals the source model's on
    the same batch (rel 1e-5)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "hf.pt")
        want, export_s = _export_hf_source(name, batch, state_dict, path,
                                           seed=1, export=export)
        with _train_main(["--model", name, "--steps", "1", "--log-every",
                          "1", "--batch-size", str(batch), "--init-hf",
                          path, "--seed", "1"]) as run:
            got = run["store"].read_events("chip-smoke", "metric",
                                           "loss")[0]["value"]
    rel = abs(got - want) / abs(want)
    ok = rel <= 1e-5
    print(f"[zoo-rest] --init-hf round trip: {name} (seed 0's weights) -> "
          f"{export} -> torch.save ({export_s:.1f} s) -> train.main "
          f"--init-hf, batch {batch}: first step loss {got:.6f} vs the "
          f"source model's {want:.6f} (rel {rel:.2e}, tol 1e-5) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"--init-hf {name}: the first loss is not the "
                             f"source model's")
    _release()
    return rel


def phase_zoo_rest():
    """The rest of the zoo on the card, each model from seed 0 at the
    registry's full width and depth: MoE-GPT-small (training, the flash
    route, the engine on both pools and an HTTP load), T5-small
    (span-corruption ``train.main``, a timed step, the cross-attention's
    flash route, seq2seq greedy and beam decoding), ViT-B/16 training,
    and ``--init-hf`` round trips of ViT and T5.  Returns the records."""
    recs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, fn in (("moe-gpt-small", _moe_zoo),
                          ("t5-small", lambda: _t5_zoo(tmp)),
                          ("vit-base", _vit_zoo)):
            t0 = time.perf_counter()
            recs[label] = fn()
            print(f"[time] zoo rest: {label} "
                  f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    recs["t5-small"], t5_weights = recs["t5-small"]
    recs["vit-base"], vit_weights = recs["vit-base"]
    recs["init_hf"] = {
        VIT: _init_hf_round_trip(VIT, vit_weights, 8, "export_hf_vit"),
        T5: _init_hf_round_trip(T5, t5_weights, 4, "export_hf_t5")}
    del t5_weights, vit_weights
    _release()
    print(f"[time] zoo rest: --init-hf round trips "
          f"{time.perf_counter() - t0:.1f} s")
    return recs


LLAMA = "tinyllama-1.1b"


def llama_models():
    """TinyLlama-1.1B at full width and depth, random from seed 0: the
    float32 copy (the exactness checks) from the seeded CPU generator,
    and the bf16 model served, its weights the float32 ones rounded once
    (what ``init_params(seed=0)`` in bf16 makes, without a second random
    draw)."""
    from polyaxon_tpu_torch.models.registry import get_model

    spec = get_model(LLAMA)
    t0 = time.perf_counter()
    model_f32 = spec.init_params(seed=0, device="cuda", dtype=torch.float32)
    secs = time.perf_counter() - t0
    model = spec.make_model(device="cuda")
    model.load_state_dict(model_f32.state_dict())
    model.eval().requires_grad_(False)
    cfg = model.cfg
    print(f"[llama] {LLAMA}: hidden {cfg.hidden_size}, {cfg.num_layers} "
          f"layers, {cfg.num_heads} query / {cfg.num_kv_heads} KV heads, "
          f"vocab {cfg.vocab_size}, {cfg.max_position} positions, "
          f"{sum(p.numel() for p in model.parameters())} params; random "
          f"init (seed 0, float32, CPU generator) in {secs:.1f} s, bf16 "
          f"copy in {time.perf_counter() - t0 - secs:.1f} s")
    return model, model_f32


def phase_llama_serving(model, model_f32):
    """TinyLlama through the continuous-batching server: float32 engine
    tokens (half sampled) == solo on the fixed-lane pool and paged ==
    fixed lane; the bf16 W = 8 graph windows == eager bitwise, with the
    decode step's device time and where it goes; two HTTP loads shaped
    as GPT-2 medium's (16 requests; prompts of
    64-512 tokens from seed 0, 64 new, every odd one sampled at T 0.8,
    top-k 50, top-p 0.95),
    one on the fixed-lane pool and one on the paged pool.  Neither load
    launches a flash kernel (decode and chunked prefill masks take the
    plain path).
    Returns the decode-step ms per program and the two records."""
    t0 = time.perf_counter()
    # 6 requests (12 before the zoo's phases joined), for the
    # script's time.
    _f32_schedule(_cut_draft(model_f32, LLAMA, LLAMA_F32_LAYERS), LLAMA,
                  tag="llama", pools=("paged",), n=6)
    print(f"[time] llama: float32 schedules {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # No profiled eager window, to bound the script's time (PERF.md
    # keeps its split: copies 0.73 of the busy time).
    step_ms = _graph_vs_eager(model, tag="llama")
    print(f"[time] llama: graph vs eager windows "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(0)
    bodies = _mixed([{"prompt": rng.randint(0, model.cfg.vocab_size,
                                            n).tolist(),
                      "max_new_tokens": 64}
                     for n in rng.randint(64, 513, 16)])
    recs = {}
    # One warm-up request (4 before the zoo's phases joined), for
    # the script's time.
    for label, kw in (("llama mixed fixed-lane", {"warm_requests": 1,
                                                  "idle_share": False}),
                      # No idle-share reruns either: trimmed for the
                      # fleet phase's time (PERF.md keeps the earlier ones).
                      ("llama mixed paged", {"warm_requests": 1,
                                             "kv_paged": True,
                                             "idle_share": False})):
        t0 = time.perf_counter()
        rec, (srv, ms, _) = _http_load(model, label, bodies,
                                       sampled_too=True, name=LLAMA, **kw)
        srv.shutdown()
        srv.server_close()
        ms.close()
        print(f"[time] llama: {label} load {time.perf_counter() - t0:.1f} s")
        if any(rec["flash_launches"].values()):
            raise AssertionError(f"{label}: flash launches "
                                 f"{rec['flash_launches']}, expected none")
        recs[label] = rec
        _release()
    print(f"[llama] decode step ms (bf16, 8 slots, W=8 replay): "
          + ", ".join(f"{k} {v:.3f}" for k, v in step_ms.items()))
    return step_ms, recs


def phase_llama_train(state_dict, steps: int = 5):
    """TinyLlama ``TrainStep`` calls at batch 4 x 2048 (bf16 compute on
    float32 master weights loaded from ``state_dict``, AdamW, remat):
    each step launches the forward kernel twice a layer (the forward,
    and again as remat recomputes each layer in the backward) and dq and
    dkv once; finite loss and gradients; step time, tok/s, MFU against
    989 TFLOP/s, peak memory, one step under the profiler, and the
    forward, forward + backward and optimizer times apart.  Returns the
    record, with the launches of one step."""
    from polyaxon_tpu_torch.models.registry import get_model
    from polyaxon_tpu_torch.parallel import make_train_step
    from polyaxon_tpu_torch.train import make_optimizer

    spec = get_model(LLAMA)
    model = spec.make_model(device="cuda", param_dtype=torch.float32)
    model.load_state_dict(state_dict)
    model.train()
    layers = model.cfg.num_layers
    step_fn = make_train_step(spec.loss_fn(model),
                              make_optimizer("adamw", 1e-3))
    state = step_fn.init_state(model)
    batch = {"inputs": torch.as_tensor(spec.make_batch(4)["inputs"],
                                       device="cuda")}
    state, metrics = step_fn(state, batch)  # warm-up: cuBLAS picks kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    state, metrics = step_fn(state, batch)
    torch.cuda.synchronize()
    counts = _counts()
    _check_per_step(counts, 1, layers, "llama TrainStep", fwd_passes=2)
    loss = float(metrics["loss"])
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    if not np.isfinite(loss) or bad or \
            not np.isfinite(float(metrics["grad_norm"])):
        raise AssertionError(f"llama TrainStep: loss {loss}, non-finite "
                             f"grads {bad[:5]}")
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step_fn(state, batch)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    flops = spec.train_flops(4)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rec = {"step_ms": step_s * 1e3, "tok_per_s": 4 * 2048 / step_s,
           "mfu": flops / step_s / 989e12, "train_flops": flops,
           "peak_memory_gb": peak_gb, "loss": float(metrics["loss"]),
           "flash_launches": counts}
    print(f"[llama] train {LLAMA} batch 4 x 2048 bf16 (f32 master weights, "
          f"AdamW, remat): {rec['step_ms']:.2f} ms a step ({steps} steps), "
          f"{rec['tok_per_s']:.0f} tok/s, MFU {rec['mfu']:.4f} "
          f"({flops / 1e12:.2f} TFLOP a step, floor "
          f"{flops / 989e12 * 1e3:.2f} ms); peak memory {peak_gb:.2f} GB; "
          f"loss {rec['loss']:.4f}; flash launches a step {counts}")
    rec["busy_ms"] = device_breakdown(lambda: step_fn(state, batch),
                                      rec["step_ms"], "llama train")
    # The step's three parts apart: the loss forward (grad enabled, so
    # remat saves only each layer's input), forward + backward, and the
    # AdamW update (repeated on the last gradients).
    loss_fn = spec.loss_fn(model)
    rec["forward_ms"] = eager_ms(lambda: loss_fn(batch), calls=2, reps=3)
    rec["forward_backward_ms"] = eager_ms(
        lambda: loss_fn(batch)[0].backward(), calls=2, reps=3)
    rec["optimizer_ms"] = eager_ms(state["opt_state"].step, calls=2, reps=3)
    print(f"[llama] train step split: forward {rec['forward_ms']:.2f} ms, "
          f"forward + backward {rec['forward_backward_ms']:.2f} ms, AdamW "
          f"{rec['optimizer_ms']:.2f} ms (eager, CUDA events)")
    del state, step_fn, model, loss_fn
    _release()
    return rec


def phase_llama_grad_route(layers: int = 2):
    """TinyLlama's width at ``layers`` layers (the registry's overrides),
    [2, 2048] tokens, full causal and with ``sliding_window=511``: logits
    and one step's loss and gradients through the flash route (forward,
    dq, dkv; remat recomputes the forward) against the plain-attention
    route.  float32 must agree within 1e-4 of max|logit| on the logits,
    1e-5 relative on the loss and 1e-4 of each tensor's max |grad| (only
    summation order differs; dK and dV reach the 4 KV heads through the
    GQA repeat's backward); the bf16 differences are printed, not
    held."""
    from polyaxon_tpu_torch.models.registry import get_model
    from polyaxon_tpu_torch.ops import attention

    spec = get_model(LLAMA)
    tokens = torch.as_tensor(spec.make_batch(2)["inputs"], device="cuda")
    eligible = attention.flash_eligible
    for window in (None, 511):
        for dtype in (torch.float32, torch.bfloat16):
            model = spec.init_params(seed=0, device="cuda", train=True,
                                     dtype=dtype, num_layers=layers,
                                     sliding_window=window)
            loss_fn = spec.loss_fn(model)
            with torch.no_grad():
                logits = model(tokens)
            _zero_counts()
            flash_loss, flash_g = _grads(model, tokens, loss_fn)
            counts = _counts()
            try:
                attention.flash_eligible = lambda *a, **kw: False
                with torch.no_grad():
                    ref = model(tokens)
                plain_loss, plain_g = _grads(model, tokens, loss_fn)
            finally:
                attention.flash_eligible = eligible
            _check_per_step(counts, 1, layers, "llama route check",
                            fwd_passes=2)
            if _counts() != counts:
                raise AssertionError(f"the plain route launched a kernel: "
                                     f"{_counts()}")
            d_logit = (logits - ref).abs().max().item() / \
                ref.abs().max().item()
            worst, where = 0.0, ""
            for name, g in plain_g.items():
                rel = (flash_g[name] - g).abs().max().item() / max(
                    g.abs().max().item(), 1e-30)
                if rel > worst:
                    worst, where = rel, name
            finite = all(bool(torch.isfinite(g).all())
                         for g in flash_g.values())
            loss_rel = abs(flash_loss - plain_loss) / abs(plain_loss)
            held = dtype == torch.float32
            ok = finite and (not held or (d_logit <= 1e-4 and
                                          loss_rel <= 1e-5 and
                                          worst <= 1e-4))
            print(f"[llama] route, {LLAMA} width, {layers} layers, window "
                  f"{window}, {str(dtype)[6:]}: flash vs plain attention: "
                  f"max|d logit| / max|logit| {d_logit:.2e}, loss "
                  f"{flash_loss:.6f} vs {plain_loss:.6f} (rel "
                  f"{loss_rel:.2e}), max |d grad| / max |grad| {worst:.2e} "
                  f"at {where}; flash launches {counts}"
                  + (" (tol 1e-4, 1e-5, 1e-4) " if held
                     else " (printed, not held) ")
                  + ("ok" if ok else "FAIL"))
            if not ok:
                raise AssertionError("llama flash-route logits or "
                                     "gradients disagree with the "
                                     "plain-attention route")
            del model, flash_g, plain_g, logits, ref
            _release()


def phase_mistral():
    """mistral-tiny (GQA 4/2, sliding window 31) on the card, float32:
    12 concurrent requests through ``ModelServer`` (prompts of 16-200
    tokens, so every budget runs past the window and the decode append
    clips it) equal solo decoding on the fixed-lane pool, and the paged
    pool (eager and lazy) gives the fixed lane's tokens."""
    from polyaxon_tpu_torch.models.registry import get_model

    model = get_model("mistral-tiny").init_params(seed=0, device="cuda",
                                                  dtype=torch.float32)
    _f32_schedule(model, "mistral-tiny", tag="mistral")


def _serve_cli(env, args, bodies):
    """``python -m polyaxon_tpu_torch.cli serve ARGS --port P`` as a user
    starts it: POST every body to /generate once it prints that it
    serves, then stop it; returns (seconds to serving, responses)."""
    import socket
    import urllib.request

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "polyaxon_tpu_torch.cli",
                             "serve", *args, "--port", str(port)], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        while line and "serving" not in line:
            line = proc.stdout.readline()
        if not line:
            raise AssertionError(f"serve {args} exited {proc.wait()}")
        ready = time.perf_counter() - t0
        out = []
        for body in bodies:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/generate",
                data=json.dumps(body).encode())
            with urllib.request.urlopen(req, timeout=300) as r:
                out.append(json.loads(r.read()))
        return ready, out
    finally:
        proc.terminate()
        proc.wait(timeout=60)


def phase_llama_entry_points(steps: int = 3):
    """TinyLlama through the commands a user types, each a fresh process
    in a temporary home: ``python -m polyaxon_tpu_torch.train --model
    tinyllama-1.1b`` (batch 4 x 2048, ``steps`` steps, its final
    checkpoint), ``generate`` with random weights and with
    ``--checkpoint`` of that run, and ``serve`` on the fixed-lane and the
    paged pool with a greedy and a sampled request; ``generate`` and
    ``serve --kv-paged`` of mistral-tiny (its window).  ``main`` covers
    the same path in-process (``phase_train_entry`` on TinyLlama: one
    step, its 13.2 GB checkpoint of float32 weights and AdamW moments
    served by ``generate --checkpoint``); these fresh processes take
    about 3 minutes more and are run apart:
    ``python3 -c "import chip_smoke as c; c.phase_llama_entry_points()"``."""
    print(f"[card] {card_line()}")
    with tempfile.TemporaryDirectory() as home:
        env = {k: v for k, v in os.environ.items()
               if k not in ("POLYAXON_TPU_RUN_UUID", "POLYAXON_TPU_HOST")}
        env.update({"POLYAXON_TPU_HOME": home, "PYTHONPATH": os.pathsep.join(
            [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])})
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "polyaxon_tpu_torch.train", "--model",
             LLAMA, "--steps", str(steps), "--log-every", "1"], env=env,
            cwd=home, capture_output=True, text=True, timeout=1200)
        wall = time.perf_counter() - t0
        for line in (out.stdout + out.stderr).splitlines()[-12:]:
            print(f"[llama cli] train: {line}")
        losses = re.findall(r"^step \d+/\d+ loss=(\S+)", out.stdout, re.M)
        if out.returncode != 0 or len(losses) != steps or \
                not all(np.isfinite(float(x)) for x in losses):
            raise AssertionError(f"train {LLAMA}: exit {out.returncode}")
        ckpt = next(d for d, _, _ in os.walk(home)
                    if os.path.basename(d) == "checkpoints")
        gb = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, files in os.walk(ckpt) for f in files) / 1e9
        print(f"[llama cli] train {LLAMA} {steps} steps at 4 x 2048: exit 0 "
              f"in {wall:.1f} s (process, init, steps, {gb:.2f} GB "
              f"checkpoint)")
        prompt = ",".join(str(t) for t in range(1, 33))
        for name, extra, vocab in ((LLAMA, [], 32000),
                                   (LLAMA, ["--checkpoint", ckpt], 32000),
                                   ("mistral-tiny", [], 512)):
            t0 = time.perf_counter()
            rc, text, _ = _ptpu(env, "generate", "--model", name,
                                "--prompt", prompt, "--max-new-tokens",
                                "32", *extra)
            rec = json.loads(text.strip().splitlines()[-1]) if rc == 0 \
                else {}
            new = rec.get("new_tokens", [[]])[0]
            if rc != 0 or len(new) != 32 or \
                    not all(0 <= t < vocab for t in new):
                raise AssertionError(f"generate {name} {extra}: exit {rc}"
                                     f"\n{text[-2000:]}")
            print(f"[llama cli] generate {name} "
                  f"{' '.join(extra) or '(seed 0)'}: 32 new tokens, "
                  f"{rec['tok_per_sec']} tok/s in the decode, "
                  f"{time.perf_counter() - t0:.1f} s in all")
        bodies = [{"prompt": list(range(1, 65)), "max_new_tokens": 32},
                  {"prompt": list(range(1, 65)), "max_new_tokens": 32,
                   **SAMPLED, "seed": 1}]
        for name, flags in ((LLAMA, []), (LLAMA, ["--kv-paged"]),
                            ("mistral-tiny", ["--kv-paged"])):
            ready, got = _serve_cli(env, ["--model", name, *flags],
                                    bodies)
            ok = all(len(g["new_tokens"][0]) == 32 for g in got)
            if not ok:
                raise AssertionError(f"serve {name} {flags}: {got}")
            print(f"[llama cli] serve {name} "
                  f"{' '.join(flags) or '(fixed lane)'}: "
                  f"ready in {ready:.1f} s; a greedy and a sampled request "
                  f"answered, 32 tokens each, TTFT "
                  + " / ".join(f"{g['ttft_ms']:.1f}" for g in got) + " ms")


# -- int8 weights, the int8 KV cache and the ring --------------------------


class _serving_cfg:
    """Within the block, every module of ``model`` that holds the config
    sees it with ``over`` (serve-time fields: ``kv_cache_int8``,
    ``kv_cache_ring``, ``sliding_window``), so one set of weights serves
    under each cache layout; the registry's ``init_params(**over)``
    builds the same model."""

    def __init__(self, model, **over):
        self.mods = [m for m in model.modules() if hasattr(m, "cfg")]
        self.old = [m.cfg for m in self.mods]
        self.new = dataclasses.replace(model.cfg, **over)

    def __enter__(self):
        for m in self.mods:
            m.cfg = self.new
        return self

    def __exit__(self, *exc):
        for m, cfg in zip(self.mods, self.old):
            m.cfg = cfg


def _cache_bytes(model, slots: int) -> int:
    """Bytes of a ``slots``-row decode cache of ``model`` (a slot pool's
    lanes): entries, int8 scales, a ring's per-row position tables."""
    from polyaxon_tpu_torch.models import generate as G

    cache = G.init_cache(model, 1)
    n = slots * sum(t.numel() * t.element_size() for t in cache.leaves())
    if cache.ring_pos is not None:
        n += slots * cache.ring_pos.numel() * cache.ring_pos.element_size()
    return n


def _filled_pool(model, paged: bool, prompts, new: int = 64):
    """A pool of ``len(prompts)`` slots over ``model`` (paged: 64-token
    pages), each slot prefilled with its prompt and armed greedy, and a
    ``restore`` of that state (host decode state and every pool
    tensor)."""
    from polyaxon_tpu_torch.models import generate as G
    from polyaxon_tpu_torch.serving.paged import PagedSlotKVManager
    from polyaxon_tpu_torch.serving.slots import SlotKVManager

    n = len(prompts)
    pool = PagedSlotKVManager(model, n, page_tokens=64,
                              max_position=model.cfg.max_position,
                              decode_window=8) if paged \
        else SlotKVManager(model, n, max_window=8)
    for s, p in enumerate(prompts):
        with torch.no_grad():
            logits, cache = G.prefill(model, torch.as_tensor(
                [p], device="cuda"))
        pool.acquire()
        extra = {"total_tokens": len(p) + new} if paged else {}
        pool.insert(s, cache, int(torch.argmax(logits[0])), len(p),
                    **extra)
        del cache
    host = {k: getattr(pool, k).copy()
            for k in ("tokens", "positions", "next_index")}
    state = list(pool._pools) if paged else pool._pool.leaves() + (
        [] if pool._pool.ring_pos is None else [pool._pool.ring_pos])
    saved = [t.clone() for t in state]

    def restore():
        for k, v in host.items():
            setattr(pool, k, v.copy())
        for dst, src in zip(state, saved):
            dst.copy_(src)

    return pool, restore


def _step_times(variants, paged: bool, prompts, tag: str) -> dict:
    """bf16 greedy decode step (W = 8 replay / 8) of every (label,
    model, cfg overrides) in ``variants``: each pool is filled and its
    graph captured first, then the replays are timed in turns (each
    variant in order, then in reverse) and the two medians averaged."""
    pools = {}
    for label, model, over in variants:
        with _serving_cfg(model, **over):
            pool, restore = _filled_pool(model, paged, prompts)
            restore()
            pool.step(8, False)
        pools[label] = (pool, pool._step_key(8, False), restore)
    times = {label: [] for label in pools}
    order = list(pools)
    for label in order + order[::-1]:
        pool, key, restore = pools[label]
        times[label].append(_replay_ms(pool, key, restore) / 8)
    out = {label: sum(t) / 2 for label, t in times.items()}
    where = "paged" if paged else "fixed-lane"
    print(f"[{tag}] bf16 greedy decode step on the {where} pool, 8 slots "
          f"at positions {min(map(len, prompts))}-"
          f"{max(map(len, prompts)) + 7} (W=8 replay / 8, two turns): "
          + ", ".join(f"{k} {v:.4f} ms ({times[k][0]:.4f} / "
                      f"{times[k][1]:.4f})" for k, v in out.items()))
    del pools
    _release()
    return out


def _int8_f32_check(model_f32, name: str) -> dict:
    """float32, ``--int8-weights --int8-kv``: 4 concurrent requests
    (every odd one sampled, position-keyed), one extending a prefix
    registered by ``prefill_prompt`` (a radix hit) and one speculative
    (K = 4, the draft a 4-layer cut, also int8), through ``ModelServer``
    on the fixed-lane and the paged pool, each equal to its solo run
    under the tie rule; at ``F32_LAYERS`` layers.  Returns the flash
    launches of the engine runs."""
    from polyaxon_tpu_torch.models import generate as G
    from polyaxon_tpu_torch.ops.quant import quantize_params
    from polyaxon_tpu_torch.serving import ModelServer

    model_f32 = _cut_draft(model_f32, name, F32_LAYERS)
    draft = quantize_params(_cut_draft(model_f32, name, F32_LAYERS))
    qf = quantize_params(model_f32)
    vocab = model_f32.cfg.vocab_size
    rng = np.random.RandomState(11)
    # 4 plain prompts (6 before the zoo's phases joined), for the
    # script's time.
    prompts = [rng.randint(0, vocab, n).tolist()
               for n in rng.randint(16, 201, 4)]
    sys_p = rng.randint(0, vocab, 64).tolist()
    bodies = [dict({"prompt": p, "max_new_tokens": 24},
                   **({**SAMPLED, "seed": i} if i % 2 else {}))
              for i, p in enumerate(prompts)]
    bodies.append({"prompt": sys_p + rng.randint(0, vocab, 12).tolist(),
                   "max_new_tokens": 24})
    bodies.append({"prompt": prompts[0], "max_new_tokens": 24,
                   "speculative": True, "spec_k": SPEC_K})
    counts = {}
    with _serving_cfg(qf, kv_cache_int8=True), \
            _serving_cfg(draft, kv_cache_int8=True), torch.no_grad():
        want = []
        for b in bodies:
            if b.get("speculative"):
                out = G.generate_speculative(qf, draft, [b["prompt"]],
                                             max_new_tokens=24, k=SPEC_K)
            elif b.get("temperature"):
                out = G.generate_positional(qf, [b["prompt"]],
                                            max_new_tokens=24,
                                            seed=b["seed"], **SAMPLED)
            else:
                out = G.generate(qf, [b["prompt"]], max_new_tokens=24)
            want.append([out[0, len(b["prompt"]):].tolist()])
        for label, kw in (("fixed-lane", {}), ("paged", {"kv_paged": True})):
            ms = ModelServer(qf, model_name=name, n_slots=4,
                             prefill_chunk=64, decode_window=8,
                             draft_model=draft, spec_k=SPEC_K, **kw)
            try:
                ms.prefill_prompt({"prompt": sys_p})
                _zero_counts()
                got, secs = _concurrent(ms, bodies)
                counts[label] = _counts()
                info = ms.info()
            finally:
                ms.close()
            ties = _same_tokens(qf, "int8", bodies, want,
                                [g["new_tokens"] for g in got])
            if info["prefix_hits"] < 1 or \
                    got[len(prompts)].get("prefix_hit_len") != 64:
                raise AssertionError(f"int8 {label}: no prefix hit "
                                     f"({info['prefix_hits']})")
            print(f"[int8] float32 --int8-weights --int8-kv, {label} pool "
                  f"({F32_LAYERS} layers): "
                  f"{len(bodies)} concurrent requests "
                  f"({len(prompts) // 2} sampled, 1 on a 64-token "
                  f"prefix hit, 1 speculative with an int8 4-layer draft) "
                  f"in {secs:.2f} s equal solo ({len(bodies) - ties} "
                  f"exactly, {ties} by the tie rule); flash launches "
                  f"{counts[label]}")
    del qf, draft
    _release()
    return counts


def phase_int8(model, model_f32, name: str = "gpt2-medium") -> dict:
    """GPT-2 medium served with int8 weights and the int8 KV cache:
    the bytes as stored against bf16 (weights: ``quantized_bytes``; the
    KV cache of 8 slots); the float32 exactness check
    (``_int8_f32_check``); the bf16 decode step for plain, int8 KV,
    int8 weights and both on the fixed-lane and the paged pool
    (``_step_times``); an 8-request HTTP mixed load on the model
    ``serve --int8-weights --int8-kv --kv-paged`` builds
    (``cli.main._build_serving_model``).  Returns the step times, the
    load's record and the flash launches of each path."""
    import copy

    from polyaxon_tpu_torch.cli.main import _build_serving_model
    from polyaxon_tpu_torch.ops.quant import quantize_params, \
        quantized_bytes

    t0 = time.perf_counter()
    qmodel = quantize_params(copy.deepcopy(model))
    stored, bf16 = quantized_bytes(qmodel)
    kv_plain = _cache_bytes(model, 8)
    with _serving_cfg(model, kv_cache_int8=True):
        kv_int8 = _cache_bytes(model, 8)
    print(f"[int8] {name}: weights as stored {stored} bytes against "
          f"{bf16} in bf16 ({stored / bf16:.4f}); KV cache of 8 slots x "
          f"{model.cfg.max_position} positions: int8 {kv_int8} bytes "
          f"against {kv_plain} ({kv_int8 / kv_plain:.4f})")
    counts = {"engine": _int8_f32_check(model_f32, name)}
    print(f"[time] int8: float32 checks {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, model.cfg.vocab_size, n).tolist()
               for n in rng.randint(64, 513, 8)]
    variants = (("plain", model, {}),
                ("int8 KV", model, {"kv_cache_int8": True}),
                ("int8 weights", qmodel, {}),
                ("both", qmodel, {"kv_cache_int8": True}))
    steps = {pool: _step_times(variants, pool == "paged", prompts, "int8")
             for pool in ("fixed", "paged")}
    del qmodel, variants
    _release()
    print(f"[time] int8: step times {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    served = _build_serving_model(name, 1, 0, "cuda", kv_int8=True,
                                  int8_weights=True)
    rng = np.random.RandomState(0)
    # The HTTP loads' first 8 requests (16 before the serving mesh's
    # phase joined the script, for its time).
    lens = rng.randint(64, 513, 16)
    bodies = _mixed([{"prompt": rng.randint(
        0, model.cfg.vocab_size, n).tolist(), "max_new_tokens": 64}
        for n in lens][:8])
    rec, (srv, ms, _) = _http_load(served, "int8 mixed paged", bodies,
                                   sampled_too=True, warm_requests=1,
                                   idle_share=False, kv_paged=True)
    _stop(srv, ms)
    counts["http"] = rec["flash_launches"]
    del served
    _release()
    print(f"[int8] serve --int8-weights --int8-kv --kv-paged: 8 mixed "
          f"requests {rec['tok_per_s']:.1f} tok/s, TTFT p50 "
          f"{rec['ttft_p50_ms']:.1f} ms; flash launches {counts['http']}")
    print(f"[time] int8: HTTP load {time.perf_counter() - t0:.1f} s")
    return {"step_ms": steps, "http": rec, "flash_launches": counts}


def phase_int8_llama(model) -> dict:
    """TinyLlama-1.1B's bytes under int8 weights and int8 KV, and its
    bf16 decode step for plain, int8 KV, int8 weights and both on the
    paged pool."""
    import copy

    from polyaxon_tpu_torch.ops.quant import quantize_params, \
        quantized_bytes

    t0 = time.perf_counter()
    qmodel = quantize_params(copy.deepcopy(model))
    stored, bf16 = quantized_bytes(qmodel)
    kv_plain = _cache_bytes(model, 8)
    with _serving_cfg(model, kv_cache_int8=True):
        kv_int8 = _cache_bytes(model, 8)
    print(f"[int8] {LLAMA}: weights as stored {stored} bytes against "
          f"{bf16} in bf16 ({stored / bf16:.4f}); KV cache of 8 slots x "
          f"{model.cfg.max_position} positions: int8 {kv_int8} bytes "
          f"against {kv_plain} ({kv_int8 / kv_plain:.4f})")
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, model.cfg.vocab_size, n).tolist()
               for n in rng.randint(64, 513, 8)]
    steps = _step_times((("plain", model, {}),
                         ("int8 KV", model, {"kv_cache_int8": True}),
                         ("int8 weights", qmodel, {}),
                         ("both", qmodel, {"kv_cache_int8": True})),
                        True, prompts, "int8 llama")
    del qmodel
    _release()
    print(f"[time] int8 llama: {time.perf_counter() - t0:.1f} s")
    return steps


def phase_ring(model) -> dict:
    """The ring cache at TinyLlama's width with ``sliding_window=511``.

    float32 at 4 layers (the depth cut): a greedy session of a
    1,536-token prompt and 560 new tokens and a sampled one of 2,000 and
    64 (2,096 and 2,064 positions, past ``max_position`` 2048), solo on
    the ring == the same weights with a plain cache of ``max_position``
    4096 (RoPE has no table) == the
    fixed-lane engine on the ring (2 slots), under the tie rule, with
    no flash launch.  bf16 at full depth (``model``): the ring's cache
    bytes against the plain cache's, the decode step at positions over
    2048 (and the plain windowed cache's below 2048), and
    ``serve --kv-ring --kv-paged`` and a paged engine refused."""
    import click

    from polyaxon_tpu_torch.cli.main import cli
    from polyaxon_tpu_torch.models import generate as G
    from polyaxon_tpu_torch.models.registry import get_model
    from polyaxon_tpu_torch.serving import (DecodeEngine, ModelServer,
                                            SchedulerPolicy)

    t0 = time.perf_counter()
    spec = get_model(LLAMA)
    window = {"sliding_window": 511}
    ring = spec.init_params(seed=0, device="cuda", dtype=torch.float32,
                            num_layers=4, kv_cache_ring=True, **window)
    plain = spec.make_model(device="cuda", dtype=torch.float32,
                            num_layers=4, max_position=4096, **window)
    plain.load_state_dict(ring.state_dict())
    plain.eval().requires_grad_(False)
    vocab = ring.cfg.vocab_size
    rng = np.random.RandomState(12)
    # Greedy: 1,536 + 560 (the long stream); sampled: 2,000 + 64 (the
    # positional sampler's solo step is the slow one, so a short stream
    # that still crosses position 2048).
    bodies = [{"prompt": rng.randint(0, vocab, 1536).tolist(),
               "max_new_tokens": 560},
              {"prompt": rng.randint(0, vocab, 2000).tolist(),
               "max_new_tokens": 64, **SAMPLED, "seed": 1}]
    solo, wide = [], []
    with torch.no_grad():
        for b in bodies:
            n, new = len(b["prompt"]), b["max_new_tokens"]
            for m, out in ((ring, solo), (plain, wide)):
                if b.get("temperature"):
                    t = G.generate_positional(m, [b["prompt"]],
                                              max_new_tokens=new, seed=1,
                                              **SAMPLED)
                else:
                    t = G.generate(m, [b["prompt"]], max_new_tokens=new)
                out.append([t[0, n:].tolist()])
    ties = _same_tokens(ring, "ring", bodies, wide, solo)
    ms = ModelServer(ring, model_name=LLAMA, n_slots=2, prefill_chunk=512,
                     decode_window=8)
    try:
        _zero_counts()
        got, secs = _concurrent(ms, bodies)
        counts = _counts()
        lane = ms.engine.slots._k.shape[2]
    finally:
        ms.close()
    ties += _same_tokens(ring, "ring", bodies, solo,
                         [g["new_tokens"] for g in got])
    if any(counts.values()) or lane != 512:
        raise AssertionError(f"ring engine: flash launches {counts}, lane "
                             f"{lane}")
    print(f"[ring] float32 {LLAMA} width, 4 layers, window 511, ring of "
          f"512 slots: a greedy session of 1536 + 560 tokens and a "
          f"sampled one of 2000 + 64"
          f" (past max_position 2048): solo ring == plain cache of "
          f"max_position 4096 == fixed-lane engine ({secs:.2f} s, lanes "
          f"of {lane} positions; {ties} tokens by the tie rule); flash "
          f"launches {counts}")
    del ring, plain
    _release()
    print(f"[time] ring: float32 sessions {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with _serving_cfg(model, kv_cache_ring=True, **window):
        ring_bytes = _cache_bytes(model, 8)
        rng = np.random.RandomState(3)
        long = [rng.randint(0, vocab, n).tolist()
                for n in rng.randint(2100, 2401, 8)]
        ring_ms = _step_times((("ring", model, {}),), False, long, "ring")
        try:
            DecodeEngine(model, autostart=False, policy=SchedulerPolicy(
                n_slots=2, kv_paged=True))
            raise AssertionError("a paged engine took a ring model")
        except ValueError as e:
            refused = str(e)
    with _serving_cfg(model, **window):
        plain_bytes = _cache_bytes(model, 8)
        short = [rng.randint(0, vocab, n).tolist()
                 for n in rng.randint(1500, 1901, 8)]
        plain_ms = _step_times((("plain window", model, {}),), False,
                               short, "ring")
    try:
        cli.main(["serve", "--model", "mistral-tiny", "--kv-ring",
                  "--kv-paged"], standalone_mode=False)
        raise AssertionError("serve --kv-ring --kv-paged was not refused")
    except click.ClickException as e:
        cli_refused = e.format_message()
    print(f"[ring] bf16 {LLAMA}, window 511, 8 slots: ring cache "
          f"{ring_bytes} bytes against the plain cache's {plain_bytes} "
          f"({ring_bytes / plain_bytes:.4f}); decode step "
          f"{ring_ms['ring']:.4f} ms past position 2048 (ring), "
          f"{plain_ms['plain window']:.4f} ms below it (plain); paged "
          f"refused: engine '{refused}', serve '{cli_refused}'")
    print(f"[time] ring: bf16 {time.perf_counter() - t0:.1f} s")
    return {"flash_launches": counts, "step_ms": {**ring_ms, **plain_ms},
            "bytes": (ring_bytes, plain_bytes)}


# -- the fleet tier: host spill, the wire, the router, disaggregated roles --

FLEET_PROMPT = 512          # tokens of the wire checks' prefix
FLEET_PT = 64               # page tokens of every fleet pool


def _bits(t):
    """An integer view of ``t`` (bitwise comparisons of any dtype)."""
    return t.view({4: torch.int32, 2: torch.int16, 1: torch.int8}[
        t.element_size()])


def _wire_leg(label, mgr, cache, logits, predicted):
    """One prefix through the host tier and the wire on the card: pages
    written, ``spill_pages`` -> ``pack_spilled`` -> ``unpack_spilled``
    -> ``rematerialize``, each step timed, the result held bitwise
    against ``materialize`` of the same pages."""
    from polyaxon_tpu_torch.serving.paged import (pack_spilled,
                                                  unpack_spilled)

    n = cache.index
    ids = list(range(mgr.pages_needed(n)))
    toks = np.arange(n, dtype=np.int32)[None] % 50257
    mgr.scatter_cache(cache, ids)
    want = mgr.materialize(ids, n)
    torch.cuda.synchronize()
    ms = {}
    t0 = time.perf_counter()
    leaves = mgr.spill_pages(ids, n)
    torch.cuda.synchronize()
    ms["spill"] = 1e3 * (time.perf_counter() - t0)
    host_logits = logits.cpu()
    t0 = time.perf_counter()
    blob = pack_spilled(toks, leaves, n, host_logits)
    ms["pack (crc32 included)"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    _toks, back, n_back, _lg = unpack_spilled(blob)
    ms["unpack (crc32 included)"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    got = mgr.rematerialize(back, n_back)
    torch.cuda.synchronize()
    ms["rematerialize"] = 1e3 * (time.perf_counter() - t0)
    if got.index != n or len(got.leaves()) != len(want.leaves()):
        raise AssertionError(f"fleet wire {label}: wrong cache kind")
    for a, b in zip(got.leaves(), want.leaves()):
        if a.dtype != b.dtype or a.shape != b.shape \
                or not torch.equal(_bits(a), _bits(b)):
            raise AssertionError(f"fleet wire {label}: rematerialize != "
                                 f"materialize")
    kv = sum(t.numel() * t.element_size() for t in leaves
             if t is not None)
    if kv != predicted:
        raise AssertionError(f"fleet wire {label}: {kv} K/V bytes, "
                             f"predicted {predicted}")
    print(f"[fleet] wire {label}: blob {len(blob)} bytes (K/V {kv}, "
          f"predicted {predicted}; logits and header "
          f"{len(blob) - kv}); " + ", ".join(
              f"{k} {v:.2f} ms" for k, v in ms.items())
          + "; rematerialize == materialize bitwise")
    return {"blob_bytes": len(blob), "kv_bytes": kv, "ms": ms}


def _fleet_wire(model, name):
    """Part a: GPT-2 medium's 512-token bf16 prefix and its int8-KV
    twin, and a cache of TinyLlama's width (22 layers, 4 KV heads of 64,
    2048 positions) through the wire on the paged pool."""
    from polyaxon_tpu_torch.models import generate as G
    from polyaxon_tpu_torch.models.kv_cache import KVCache, quantize_chunk
    from polyaxon_tpu_torch.serving import PagedSlotKVManager

    cfg = model.cfg
    prompt = torch.from_numpy(np.random.RandomState(21).randint(
        0, cfg.vocab_size, (1, FLEET_PROMPT))).cuda()
    with torch.no_grad():
        logits, cache = G.prefill(model, prompt)
    out = {}
    kv = 2 * cfg.num_layers * FLEET_PROMPT * cfg.num_heads \
        * (cfg.hidden_size // cfg.num_heads) * 2
    mgr = PagedSlotKVManager(model, 2, page_tokens=FLEET_PT, n_pages=32,
                             max_position=cfg.max_position)
    out["bf16"] = _wire_leg(f"{name} bf16", mgr, cache, logits, kv)

    def q(t):                   # [L, 1, cap, H, D] -> int8 + bf16 scale
        L = t.shape[0]
        codes, scale = quantize_chunk(t.reshape((L,) + t.shape[2:]))
        return codes.unsqueeze(1), scale.unsqueeze(1)

    (kq, ks), (vq, vs) = q(cache.k), q(cache.v)
    int8 = KVCache(kq, vq, index=cache.index, k_scale=ks, v_scale=vs)
    mgr = PagedSlotKVManager(model, 2, page_tokens=FLEET_PT, n_pages=32,
                             max_position=cfg.max_position)
    kv8 = kv // 2 + 2 * cfg.num_layers * FLEET_PROMPT * cfg.num_heads * 2
    out["int8"] = _wire_leg(f"{name} int8 KV", mgr, int8, logits, kv8)
    print(f"[fleet] wire int8 / bf16: K/V bytes "
          f"{out['int8']['kv_bytes'] / out['bf16']['kv_bytes']:.4f}, blob "
          f"bytes {out['int8']['blob_bytes'] / out['bf16']['blob_bytes']:.4f}")
    del mgr, int8, cache
    gen = torch.Generator(device="cuda").manual_seed(3)
    shape = (22, 1, 2048, 4, 64)
    llama = KVCache(*(torch.randn(shape, generator=gen, device="cuda")
                      .to(torch.bfloat16) for _ in range(2)),
                    index=FLEET_PROMPT)
    mgr = PagedSlotKVManager(model, 2, page_tokens=FLEET_PT, n_pages=40,
                             max_position=2048)
    out["llama"] = _wire_leg(f"{LLAMA} width (22 layers, 4 KV heads)",
                             mgr, llama,
                             torch.zeros((1, 32000), device="cuda"),
                             2 * 22 * FLEET_PROMPT * 4 * 64 * 2)
    return out


def _fleet_bodies(vocab, n, new, seed):
    """``n`` requests of 64-512 prompt tokens and ``new`` new tokens."""
    rng = np.random.RandomState(seed)
    return [{"prompt": rng.randint(0, vocab, int(p)).tolist(),
             "max_new_tokens": new} for p in rng.randint(64, 513, n)]


def _wait_roles(router, roles, timeout=120.0):
    deadline = time.monotonic() + timeout
    while [r.role for r in router.replicas] != list(roles) \
            or not all(r.up() for r in router.replicas):
        if time.monotonic() > deadline:
            raise AssertionError(f"router never saw roles {roles}")
        time.sleep(0.05)


def _warm_fleet_keys(ms, max_tokens: int) -> None:
    """Capture every graph a decode replica's load can reach: each window
    up to its ``decode_window``, greedy and sampled, plain and
    speculative (K = ``SPEC_K``), every pad class up to ``max_tokens``
    positions (forced through an idle slot's width, restored after)."""
    from polyaxon_tpu_torch.serving.slots import sync_device

    slots = ms.engine.slots
    windows = [w for w in (1, 2, 4, 8) if w <= slots.max_window]
    with ms._lock:
        for P in _pad_classes(slots, max_tokens):
            slots._slot_need[0] = P
            for w in windows:
                for sampled in (False, True):
                    slots.step(w, sampled)
                    slots.step_spec(w, SPEC_K, sampled)
        slots._slot_need[0] = 0
        # Another replica may be capturing in this process right now: a
        # bare device-wide synchronize would invalidate its capture.
        sync_device(slots.device)


def _fleet_disagg(model_f32, name):
    """Part b: a ``ReplicaRouter`` over in-process ``LocalReplica``s —
    one ``role="prefill"`` (paged, a spill budget), two
    ``role="decode"`` (``prefix_fetch``) — sharing one float32 model, and
    a monolithic ``ModelServer`` on the same model.  The two decode
    replicas warm their graphs at the same time (several engines
    capturing in one process); 8 requests from 8 clients (3 sampled, 1
    speculative with the 4-layer cut draft) equal the monolithic tokens,
    every long prompt admitted over the wire; then a decode replica is
    killed mid-request."""
    import threading

    from polyaxon_tpu_torch.serving import (LocalReplica, ModelServer,
                                            PrefixFetchPolicy,
                                            ReplicaRouter,
                                            make_router_server)

    cfg = model_f32.cfg
    draft = _cut_draft(model_f32, name, 4)
    common = dict(model_name=name, n_slots=4, decode_window=1,
                  kv_paged=True, kv_page_tokens=FLEET_PT, prefix_cache=8,
                  draft_model=draft, spec_k=SPEC_K)
    # A float32 prefix is twice bf16's bytes: the policy's default curve
    # (4e3 tok/s of re-prefill against 1e9 B/s of wire) prices it above
    # a re-prefill, so this float32 check prices re-prefill at 1 tok/s
    # to take the wire lane; part c runs the defaults in bf16.
    policy = PrefixFetchPolicy(prefill_tok_per_s=1.0)

    def factory(role):
        kw = dict(common, role=role, kv_host_spill_bytes=4 << 30)
        if role == "decode":
            kw.update(prefix_fetch=True, prefix_fetch_policy=policy)
        return lambda: ModelServer(model_f32, **kw)

    t0 = time.perf_counter()
    roles = ["prefill", "decode", "decode"]
    reps = [LocalReplica(factory(r), f"r{i}") for i, r in enumerate(roles)]
    router = ReplicaRouter(reps, probe_interval_s=0.1, probe_timeout_s=2.0,
                           cooldown_s=0.5, request_timeout_s=600.0)
    srv = make_router_server("127.0.0.1", 0, router)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    mono = ModelServer(model_f32, **common)
    try:
        _wait_roles(router, roles)
        bodies = _fleet_bodies(cfg.vocab_size, 8, 32, seed=31)
        for i in (1, 4, 6):
            bodies[i].update(SAMPLED, seed=i)
        bodies[3].update(speculative=True, spec_k=SPEC_K)
        # Shape both decode pools (and the draft pools) with a greedy and
        # a speculative request each, then capture every key on both
        # replicas AT ONCE, with a prefill running on the prefill tier.
        warm = _fleet_bodies(cfg.vocab_size, 4, 8, seed=32)
        for j, rep in enumerate(reps[1:]):
            _post_json(rep.url, "/generate", warm[2 * j])
            _post_json(rep.url, "/generate",
                       dict(warm[2 * j + 1], speculative=True,
                            spec_k=SPEC_K))
        errs = []

        def warm_keys(ms):
            try:
                _warm_fleet_keys(ms, 512 + 32 + SPEC_K)
            except Exception as e:  # noqa: BLE001 - raised below
                errs.append(e)

        threads = [threading.Thread(target=warm_keys, args=(r.ms,))
                   for r in reps[1:]]
        threads.append(threading.Thread(target=lambda: _post_json(
            reps[0].url, "/prefill", {"prompt": warm[0]["prompt"]})))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        graphs = [len(r.ms.engine.slots._graphs) for r in reps[1:]]
        print(f"[fleet] disagg: the two decode replicas captured "
              f"{graphs} graphs concurrently (one process, one card)")
        t_warm = time.perf_counter() - t0
        _zero_counts()
        wall, out = _load_clients(base, bodies, 8)
        counts = _counts()
        after = [len(r.ms.engine.slots._graphs) for r in reps[1:]]
        if any(counts.values()) or after != graphs:
            raise AssertionError(f"fleet disagg: flash {counts}, graphs "
                                 f"{graphs} -> {after}")
        want = [mono.generate(dict(b))["new_tokens"] for b in bodies]
        got = [r[1]["new_tokens"] for r in out]
        ties = _same_tokens(model_f32, "fleet", bodies, want, got)
        sources = [r[1]["prefix_source"] for r in out]
        for b, s, r in zip(bodies, sources, out):
            wired = "re_prefill" if b.get("speculative") else "wire_fetch"
            if s != wired or r[1]["router"]["replica"] == "r0":
                raise AssertionError(f"fleet disagg: {s} on "
                                     f"{r[1]['router']['replica']}")
        print(f"[fleet] disagg float32: 8 requests (3 sampled, 1 "
              f"speculative) == monolithic ({ties} ties); sources "
              f"{sources}; handoffs {router.disagg_handoffs_total}, "
              f"wire fetches {router.kv_fleet_wire_fetches_total}; 0 "
              f"flash launches, 0 captures after warm-up; {wall:.2f} s")
        kill = _fleet_kill(model_f32, router, base, reps, mono, cfg)
        print(f"[time] fleet disagg: warm-up {t_warm:.1f} s, total "
              f"{time.perf_counter() - t0:.1f} s")
        return {"flash_launches": counts, "ties": ties, **kill}
    finally:
        router.close()
        srv.shutdown()
        srv.server_close()
        for r in reps:
            r.close()
        mono.close()


def _fleet_kill(model_f32, router, base, reps, mono, cfg):
    """A decode replica killed (``chaos_kill``) while it decodes a
    request: the router replays it on the other DECODE replica (never
    the prefill tier) with the uninterrupted tokens; the survivor also
    resumes the committed tokens the dead replica held, through
    ``resume_tokens``, token-identically."""
    import threading

    body = _fleet_bodies(cfg.vocab_size, 1, 96, seed=33)[0]
    body.update(SAMPLED, seed=5)
    p = len(body["prompt"])
    want = mono.generate(dict(body))["tokens"][0]
    failovers = router.failovers_total
    got, committed = {}, []
    t = threading.Thread(target=lambda: got.update(
        r=_post_json(base, "/generate", body)))
    t.start()
    victim = None
    deadline = time.monotonic() + 300
    while victim is None and time.monotonic() < deadline:
        for rep in reps[1:]:
            res = list(rep.ms.engine._resident.values())
            if res and len(res[0].out) >= 8:
                committed = list(res[0].out)
                victim = rep
                break
        time.sleep(0.001)
    if victim is None:
        raise AssertionError("fleet kill: no decode replica took it")
    victim.chaos_kill()
    t.join(timeout=600)
    status, resp = got["r"]
    survivor = next(r for r in reps[1:] if r is not victim)
    if status != 200 or resp["tokens"][0] != want \
            or resp["router"]["replica"] != survivor.id \
            or router.failovers_total != failovers + 1 \
            or reps[0].id in router.history.get(
                resp["request_id"])["replicas"]:
        raise AssertionError(f"fleet kill: {status} {resp.get('router')}")
    n = len(committed)
    if want[p:p + n] != committed:
        raise AssertionError("fleet kill: the dead replica's tokens "
                             "left the uninterrupted run")
    status, resumed = _post_json(survivor.url, "/generate", dict(
        body, prompt=want[:p + n], resume_tokens=n))
    if status != 200 or resumed["tokens"][0] != want:
        raise AssertionError(f"fleet kill: resume_tokens={n} diverged")
    print(f"[fleet] kill: {victim.id} killed after {n} of 96 tokens; the "
          f"router replayed the request on {survivor.id} (failovers "
          f"+1, never the prefill tier) == uninterrupted; {survivor.id} "
          f"resumed the {n} committed tokens (resume_tokens={n}) == "
          f"uninterrupted")
    return {"killed_after": n}


def _fleet_cli(name):
    """Part c: the fleet as a user starts it — ``serve --role prefill``,
    two ``serve --role decode --prefix-fetch`` and ``route`` as
    processes on the one card (bf16, the policy's defaults) — under 16
    mixed requests from 16 clients."""
    import socket

    t0 = time.perf_counter()
    ports = []
    for _ in range(4):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ports.append(sock.getsockname()[1])
    # A prefix cache of 32 entries: at the default 4, 16 concurrent
    # prefills displace each other on the prefill tier before their
    # decode replica fetches them (a holder miss).
    spill = ["--kv-paged", "--kv-page-tokens", str(FLEET_PT),
             "--kv-host-spill-bytes", str(4 << 30), "--prefix-cache", "32"]
    cmds = [["serve", "--model", name, "--port", str(ports[0]), *spill,
             "--role", "prefill"]]
    cmds += [["serve", "--model", name, "--port", str(p), *spill,
              "--role", "decode", "--prefix-fetch"] for p in ports[1:3]]
    cmds.append(["route", "--port", str(ports[3]), *sum(
        (["--replica", f"127.0.0.1:{p}"] for p in ports[:3]), [])])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    logs = [tempfile.TemporaryFile() for _ in cmds]
    procs = [subprocess.Popen([sys.executable, "-m",
                               "polyaxon_tpu_torch.cli", *c], cwd=ROOT,
                              env=env, stdout=f, stderr=subprocess.STDOUT)
             for c, f in zip(cmds, logs)]
    base = f"http://127.0.0.1:{ports[3]}"
    urls = [f"http://127.0.0.1:{p}" for p in ports[:3]]
    try:
        import urllib.request

        def get(url):
            with urllib.request.urlopen(url, timeout=60) as r:
                return r.read()

        deadline = time.monotonic() + 300
        while True:
            try:
                info = json.loads(get(base + "/info"))
                if sorted(r["role"] for r in info["replicas"]) == [
                        "decode", "decode", "prefill"] \
                        and all(r["up"] for r in info["replicas"]):
                    break
            except OSError:
                pass
            if time.monotonic() > deadline or any(
                    p.poll() is not None for p in procs):
                for f in logs:
                    f.seek(0)
                    print(f.read()[-1500:].decode(errors="replace"))
                raise AssertionError("fleet cli: the fleet never came up")
            time.sleep(0.2)
        ready = time.perf_counter() - t0
        made = _fleet_bodies(50257, 20, 64, seed=34)
        warm, bodies = _mixed(made[:4]), _mixed(made[4:])
        _w, warm_out = _load_clients(base, warm, 4)
        t_load = time.perf_counter()
        wall, out = _load_clients(base, bodies, 16)
        tok_s = sum(len(r["new_tokens"][0]) for _, r in out) / wall

        def spans_of(r):
            rec = json.loads(get(base + f"/fleet/requests/"
                                        f"{r['request_id']}"))
            return {e["event"]: e.get("dur_ms", 0.0)
                    for e in rec["timeline"]}

        ttft, handoff, remote, handed = [], [], [], []
        for body, (_, r) in zip(warm + bodies, warm_out + out):
            spans = spans_of(r)
            if "kv_handoff" in spans:   # (prompt tokens, ms, bytes)
                handoff.append((len(body["prompt"]),
                                round(spans["kv_handoff"], 2),
                                r.get("prefix_fetch_bytes")))
                handed.append((body, r["router"]["replica"],
                               spans["kv_handoff"]))
        for _, r in out:
            spans = spans_of(r)
            remote.append(spans.get("prefill_remote", 0.0))
            ttft.append(spans.get("prefill_remote", 0.0) + r["ttft_ms"])
        sources = [r["prefix_source"] for _, r in out]
        warm_sources = [r["prefix_source"] for _, r in warm_out]
        nbytes = sum(r.get("prefix_fetch_bytes", 0)
                     for _, r in warm_out + out)
        info = json.loads(get(base + "/info"))
        links = {r["id"]: (r.get("wire_bytes_per_s"), r.get("rtt_s"))
                 for r in info["replicas"]}
        vetoes = {}
        flash = {k: 0 for k in KERNELS}
        for u in urls:
            rinfo = json.loads(get(u + "/info"))
            for k, v in rinfo.get("prefix_fetch_failed", {}).items():
                vetoes[k] = vetoes.get(k, 0) + v
            for line in get(u + "/metrics").decode().splitlines():
                m = re.match(r"ptpu_(flash_\w+)_launches_total (\d+)$",
                             line)
                if m:
                    flash[m.group(1)] += int(m.group(2))
        if any(flash.values()):
            raise AssertionError(f"fleet cli: flash launches {flash}")
        # The decode side's own re-prefill of the longest handed-off
        # prompt (else the longest prompt), on the decode replica that
        # did not serve it.
        if handed:
            body, served, ms_h = max(handed,
                                     key=lambda h: len(h[0]["prompt"]))
        else:
            i = max(range(len(bodies)),
                    key=lambda j: len(bodies[j]["prompt"]))
            body, served, ms_h = bodies[i], out[i][1]["router"][
                "replica"], None
        other = next(u for u, r in zip(urls, info["replicas"])
                     if r["role"] == "decode" and r["id"] != served)
        _s, local = _post_json(other, "/generate", dict(
            body, max_new_tokens=1))
        print(f"[fleet] cli bf16: fleet up in {ready:.1f} s; 16 requests "
              f"from 16 clients: {tok_s:.1f} tok/s, TTFT p50 "
              f"{np.percentile(ttft, 50):.1f} ms p99 "
              f"{np.percentile(ttft, 99):.1f} ms (prefill_remote + the "
              f"decode replica's TTFT); sources "
              f"{ {s: sources.count(s) for s in set(sources)} } (the 4 "
              f"warm-up requests' {warm_sources}); handoffs "
              f"{info['disagg_handoffs_total']} of "
              f"{info['disagg_prefills_total']} remote prefills, "
              f"{nbytes} bytes; fetch vetoes {vetoes}; links "
              f"(wire_bytes_per_s, rtt_s) {links}")
        pays = ms_h is not None and ms_h < local["prefill_ms"]
        print(f"[fleet] cli spans: prefill_remote ms "
              f"{[round(x, 2) for x in remote]}; kv_handoffs (prompt "
              f"tokens, ms, bytes) {handoff}; the decode side's own "
              f"re-prefill of the {len(body['prompt'])}-token prompt "
              f"{local['prefill_ms']:.2f} ms ({local['prefix_source']}) "
              f"against its handoff's "
              f"{'none' if ms_h is None else f'{ms_h:.2f} ms'}; the wire "
              f"pays for itself here: {pays}")
        print(f"[time] fleet cli: up {ready:.1f} s, load "
              f"{time.perf_counter() - t_load:.1f} s")
        return {"tok_per_s": tok_s, "flash": flash, "handoffs":
                info["disagg_handoffs_total"], "bytes": nbytes}
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=60)
        for f in logs:
            f.close()


def _fleet_host_tier(model_f32, name):
    """Part d: one paged server whose pool (20 pages of 64) holds two
    512-token prefixes and a short request: registering three spills the
    coldest to host memory
    (``--kv-host-spill-bytes``); a request on it is a HOST hit
    (``local_spilled``), float32 tokens equal to the uncached server's.
    TTFT (a one-token request's wall) of a cold miss, a device hit and a
    host hit."""
    from polyaxon_tpu_torch.serving import ModelServer

    t0 = time.perf_counter()
    cfg = model_f32.cfg
    common = dict(model_name=name, n_slots=2, decode_window=2,
                  kv_paged=True, kv_page_tokens=FLEET_PT, kv_pages=20)
    ms = ModelServer(model_f32, kv_host_spill_bytes=4 << 30,
                     prefix_cache=8, **common)
    cold = ModelServer(model_f32, prefix_cache=0, **common)
    rng = np.random.RandomState(35)
    systems = [rng.randint(0, cfg.vocab_size, FLEET_PROMPT).tolist()
               for _ in range(3)]
    try:
        _zero_counts()
        for s in systems:
            ms.prefill_prompt({"prompt": s})
        info = ms.info()
        if info["kv_host_spills_total"] < 1:
            raise AssertionError(f"fleet host tier: nothing spilled "
                                 f"({info['kv_host_entries']} host)")

        def one(body, server=ms):
            t = time.perf_counter()
            r = server.generate(dict(body, max_new_tokens=1))
            return 1e3 * (time.perf_counter() - t), r

        tail = rng.randint(0, cfg.vocab_size, 16).tolist()
        ttft = {}
        ttft["cold miss"], r = one({"prompt": rng.randint(
            0, cfg.vocab_size, FLEET_PROMPT + 16).tolist()})
        assert r["prefix_source"] == "re_prefill", r["prefix_source"]
        ttft["device hit"], r = one({"prompt": systems[2] + tail})
        assert r["prefix_source"] == "local_hot", r["prefix_source"]
        ttft["host hit"], r = one({"prompt": systems[0] + tail})
        if r["prefix_source"] != "local_spilled":
            raise AssertionError(f"fleet host tier: {r['prefix_source']}")
        bodies = [{"prompt": s + tail[:8], "max_new_tokens": 16}
                  for s in systems]
        bodies[1].update(SAMPLED, seed=1)
        got = [ms.generate(dict(b)) for b in bodies]
        want = [cold.generate(dict(b))["new_tokens"] for b in bodies]
        ties = _same_tokens(model_f32, "fleet", bodies, want,
                            [g["new_tokens"] for g in got])
        counts = _counts()
        if any(counts.values()):
            raise AssertionError(f"fleet host tier: flash {counts}")
        info = ms.info()
        print(f"[fleet] host tier float32 (pool 20 pages of {FLEET_PT}): "
              f"spills {info['kv_host_spills_total']}, host hits "
              f"{info['kv_rematerialize_hits_total']}, promotions "
              f"{info['kv_promotions_total']}, host bytes "
              f"{info['kv_host_spill_bytes']}; sources "
              f"{[g['prefix_source'] for g in got]} == uncached ({ties} "
              f"ties); TTFT ms " + ", ".join(
                  f"{k} {v:.2f}" for k, v in ttft.items()))
        print(f"[time] fleet host tier: {time.perf_counter() - t0:.1f} s")
        return {"flash_launches": counts, "ttft_ms": ttft}
    finally:
        ms.close()
        cold.close()


def phase_fleet(model, model_f32, name="gpt2-medium"):
    """The fleet tier at GPT-2 medium's full width and depth: (a) the
    wire on the card, (b) disaggregated == monolithic in float32 with a
    decode replica killed mid-request, (c) the fleet through the CLI in
    bf16, (d) the host tier on one server.  Flash launches: 0 on every
    part."""
    t0 = time.perf_counter()
    wire = _fleet_wire(model, name)
    print(f"[time] fleet wire: {time.perf_counter() - t0:.1f} s")
    _release()
    disagg = _fleet_disagg(model_f32, name)
    _release()
    host = _fleet_host_tier(model_f32, name)
    _release()
    cli = _fleet_cli(name)
    _release()
    return {"wire": wire, "disagg": disagg, "host": host, "cli": cli,
            "flash_launches": {
                "fleet_disagg": disagg["flash_launches"],
                "fleet_host_tier": host["flash_launches"],
                # Summed over the CLI fleet's three server processes.
                "fleet_cli": cli["flash"]}}


# -- the flight recorder and the legacy baselines ----------------------------

PROFILE_EVERY = 16          # recorder period, decode dispatches
PROFILE_STEPS = 8           # dispatches a recorder window profiles
MERGE_PROMPT = 256          # the coalescer's merge load: prompt tokens
MERGE_NEW = 16              # and new tokens of each of its requests
MERGE_N = 4                 # the merge load's requests (8 until PR 17)
MODES_MIXED = 2             # the batching A/B's mixed load (8 until PR 17, 4 until PR 21)


def _trace_busy(events) -> tuple:
    """Independent of ``analysis/xprof.py``: (device seconds, window
    seconds, markers) of a torch.profiler trace's events — the durations
    of the ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events clipped
    to the span of the CPU ``ptpu_step`` markers, summed (serving runs
    on one stream, so they do not overlap)."""
    marks = [e for e in events if e.get("name") == "ptpu_step"
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise AssertionError("no CPU ptpu_step marker in the trace")
    lo = min(e["ts"] for e in marks)
    hi = max(e["ts"] + e["dur"] for e in marks)
    busy = sum(max(0.0, min(e["ts"] + e["dur"], hi) - max(e["ts"], lo))
               for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    return busy / 1e6, (hi - lo) / 1e6, len(marks)


def _wait_analyzed(rec, deadline_s: float = 30.0) -> None:
    """Until every opened recorder window is analyzed or abandoned (a
    window the load's end left open closes at its deadline)."""
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        t = rec._analyzer
        if rec._window is None and (t is None or not t.is_alive()):
            return
        time.sleep(0.05)
    raise AssertionError(f"flight recorder still busy after {deadline_s} "
                         f"s: {rec.report()['windows_total']} windows")


def _recorder_gates(label, base, ms) -> dict:
    """The recorder's published record against its gates: a full
    window's ``step_markers`` == ``profile_steps``, the shares sum to 1
    within 1e-6 (plus their 6-decimal rounding, 4 x 5e-7), 0 < busy <=
    1, the card's own peak, and the /metrics gauges == the report."""
    import urllib.request

    from polyaxon_tpu_torch.serving.telemetry import parse_prometheus_text

    _wait_analyzed(ms.recorder)
    with urllib.request.urlopen(base + "/profile/report", timeout=60) as r:
        rep = json.loads(r.read())
    with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
        gauges = parse_prometheus_text(r.read().decode())
    latest = rep["latest"]
    if rep["windows_analyzed"] < 1 or latest is None:
        summary = {k: v for k, v in rep.items() if k != "windows"}
        raise AssertionError(f"{label}: no recorder window analyzed: "
                             f"{summary}")
    full = [w for w in rep["windows"] if not w.get("deadline_closed")]
    if not full:
        raise AssertionError(f"{label}: every window deadline-closed")
    for w in rep["windows"]:
        want = PROFILE_STEPS if not w.get("deadline_closed") else w["steps"]
        total = sum(w["shares"].values()) + w["host_gap_share"]
        if w["step_markers"] != want or w["steps"] != want \
                or abs(total - 1.0) > 1e-6 + 4 * 5e-7 \
                or not 0 < w["device_busy_share"] <= 1 \
                or w["peak_flops_source"] != "device" \
                or w["host_fallback"]:
            raise AssertionError(f"{label}: window {w['window']} fails "
                                 f"its gates: {w}")
    for key, gauge in (("collective_share", "collective_share"),
                       ("host_gap_share", "host_gap_share"),
                       ("device_busy_share", "device_busy_share"),
                       ("mfu", "mfu")):
        if gauges[f"ptpu_serving_{gauge}"] != latest[key]:
            raise AssertionError(f"{label}: /metrics {gauge} "
                                 f"{gauges[f'ptpu_serving_{gauge}']} != "
                                 f"report {latest[key]}")
    if gauges["ptpu_serving_profile_windows_analyzed_total"] \
            != rep["windows_analyzed"]:
        raise AssertionError(f"{label}: /metrics window count != report")
    tim = ms.profiler.timings
    print(f"[profile] {label}: {rep['windows_analyzed']} of "
          f"{rep['windows_total']} windows analyzed ({rep['windows_skipped']}"
          f" skipped, {rep['windows_deferred']} deferred, "
          f"{len(rep['windows']) - len(full)} deadline-closed); latest "
          f"window {latest['window']}: {latest['steps']} steps, "
          f"{latest['tokens']} tokens, step_markers "
          f"{latest['step_markers']}, wall {latest['wall_s'] * 1e3:.3f} ms"
          f" (host clock {latest['host_wall_s'] * 1e3:.3f} ms), "
          f"{latest['events']} device events; shares compute "
          f"{latest['compute_share']}, transfer {latest['transfer_share']},"
          f" collective {latest['collective_share']}, host_gap_share "
          f"{latest['host_gap_share']}, device_busy_share "
          f"{latest['device_busy_share']}; mean position "
          f"{latest['mean_position']}, {latest['flops_per_token']:.4g} "
          f"FLOP/token, serving MFU {latest['mfu']} (peak "
          f"{latest['peak_flops']:.4g} FLOP/s, peak_flops_source "
          f"{latest['peak_flops_source']}); /metrics gauges == report")
    print(f"[profile] {label}: profiler start "
          f"{tim.get('start_s', 0) * 1e3:.3f} ms, stop (disable, engine "
          f"thread) {tim.get('stop_s', 0) * 1e3:.3f} ms, export "
          f"{tim.get('export_s', 0) * 1e3:.3f} ms, analyze "
          f"{(ms.recorder.last_analyze_s or 0) * 1e3:.3f} ms (last window)")
    print(f"[profile] {label} windows: " + "; ".join(
        f"#{w['window']} busy {w['device_busy_share']} gap "
        f"{w['host_gap_share']} mfu {w['mfu']}" for w in rep["windows"]))
    return {"latest": latest, "windows": rep["windows"],
            "timings": dict(tim),
            "analyze_s": ms.recorder.last_analyze_s}


def _manual_window(label, base, ms, bodies) -> dict:
    """POST /profile/start, a load of ``bodies``, POST /profile/stop:
    xprof's busy seconds on the dump == ``_trace_busy``'s within 2 %."""
    from polyaxon_tpu_torch.analysis.xprof import (attribute_events,
                                                   find_trace_file)

    deadline = time.monotonic() + 30
    while True:   # a recorder window may hold the session briefly
        code, out = _post_json(base, "/profile/start", {})
        if code == 200:
            break
        if code != 409 or time.monotonic() > deadline:
            raise AssertionError(f"{label}: /profile/start {code} {out}")
        time.sleep(0.05)
    again, _ = _post_json(base, "/profile/start", {})
    if again != 409:
        raise AssertionError(f"{label}: a second /profile/start -> {again}")
    wall, _ = _load_clients(base, bodies, len(bodies))
    code, out = _post_json(base, "/profile/stop", {})
    if code != 200:
        raise AssertionError(f"{label}: /profile/stop {code} {out}")
    with open(find_trace_file(out["dir"])) as f:
        events = json.load(f)["traceEvents"]
    att = attribute_events(events)
    xbusy = sum(att["category_s"].values())
    busy, window, marks = _trace_busy(events)
    rel = abs(xbusy - busy) / busy
    print(f"[profile] {label} manual window: {len(bodies)} requests in "
          f"{wall:.3f} s; {marks} CPU ptpu_step markers (xprof "
          f"step_markers {att['step_markers']}); window {window * 1e3:.3f}"
          f" ms (xprof {att['wall_s'] * 1e3:.3f}); device busy by "
          f"chip_smoke's own sum {busy * 1e3:.3f} ms, by xprof "
          f"{xbusy * 1e3:.3f} ms (relative difference {rel:.2e}, limit "
          f"0.02); xprof device_busy_share {att['device_busy_share']}, "
          f"host_gap_share {att['host_gap_share']}, events {att['events']}")
    if rel > 0.02 or att["step_markers"] != marks \
            or att["host_fallback"]:
        raise AssertionError(f"{label}: xprof busy {xbusy} s vs the "
                             f"kernel sum {busy} s ({att})")
    return {"busy_s": busy, "xprof_busy_s": xbusy, "markers": marks,
            "attribution": att}


def _solo_rows(model_f32, bodies):
    from polyaxon_tpu_torch.models import generate as G

    return [G.generate(model_f32, torch.tensor([b["prompt"]],
                                               device=model_f32.device),
                       max_new_tokens=b["max_new_tokens"])[
        :, len(b["prompt"]):].tolist() for b in bodies]


def _mode_load(model, mode, loads) -> dict:
    """Each of ``loads`` ({label: bodies}) in bf16 under
    ``batching=mode`` on one fresh server, after one warm-up request."""
    srv, ms, base = _serve(model, "gpt2-medium", batching=mode,
                           prefill_chunk=256)
    try:
        _load_clients(base, next(iter(loads.values()))[:1], 1)
        return {label: _mode_stats(base, ms, label, bodies)
                for label, bodies in loads.items()}
    finally:
        _stop(srv, ms)


def _mode_stats(base, ms, label, bodies, run=None) -> dict:
    """``bodies`` from one client each on a warm server (or ``run``,
    the (wall, results, flash launches) of a load already made): tok/s,
    TTFT and latency p50, the coalescer's counters, flash launches."""
    mode = ms.batching
    keys = ("coalesced_batches", "coalesced_requests")
    before = dict.fromkeys(keys, 0)
    if run is None:
        before = {k: ms.info()[k] for k in keys}
        _zero_counts()
        wall, res = _load_clients(base, bodies, len(bodies))
        run = (wall, res, _counts())
    wall, res, counts = run
    info = {k: ms.info()[k] - before[k] for k in keys}
    ntok = sum(len(r[1]["new_tokens"][0]) for r in res)
    ttft = sorted(r[1]["ttft_ms"] for r in res)
    lat = sorted(r[0] for r in res)
    rec = {"mode": mode, "load": label, "requests": len(res),
           "tok_per_s": ntok / wall, "wall_s": wall,
           "ttft_p50_ms": ttft[len(ttft) // 2],
           "latency_p50_s": lat[len(lat) // 2],
           "coalesced_batches": info["coalesced_batches"],
           "coalesced_requests": info["coalesced_requests"],
           "flash_launches": counts}
    print(f"[coalesce] bf16 batching={mode}, {label} load: {len(res)} "
          f"requests from {len(res)} clients, {ntok} tokens in "
          f"{wall:.3f} s = "
          f"{rec['tok_per_s']:.1f} tok/s; TTFT p50 {rec['ttft_p50_ms']:.1f}"
          f" ms, latency p50 {rec['latency_p50_s']:.3f} s; coalesced "
          f"batches {rec['coalesced_batches']} "
          f"({rec['coalesced_requests']} requests); flash launches "
          f"{counts}")
    return rec


def _lock_cross_check(reports) -> dict:
    """The lock sanitizer's runtime edges against the static lock graph.
    ``reports`` ({label: path}) are the ``sanitize_report`` files of the
    servers that ran sanitized (``phase_faults``' paged engine-death
    server and ``phase_profiling``'s float32 coalesce server); the static
    graph is the one the port's ``analysis.lockgraph`` builds from the
    port's installed sources, as ``ptpu-torch check --dump-lock-graph``
    does.  Fails on a sanitizer violation, on no observed edge at all
    (a vacuous check) and on an observed edge the static graph lacks
    (an analyzer blind spot)."""
    import polyaxon_tpu_torch
    from polyaxon_tpu_torch.analysis import lockgraph
    from polyaxon_tpu_torch.analysis.checker import iter_py_files

    import shutil

    t0 = time.perf_counter()
    observed, acquisitions, per = set(), 0, {}
    for label, path in reports.items():
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
        if doc["violations"]:
            raise AssertionError(f"locks: sanitizer violations on the "
                                 f"{label} server: {doc['violations']}")
        observed |= set(doc["edges"])
        acquisitions += doc["acquisitions"]
        per[label] = doc["edges"]
    if not observed:
        raise AssertionError(f"locks: no lock edge observed ({per}): "
                             f"the cross-check would be vacuous")
    pkg = os.path.dirname(os.path.abspath(polyaxon_tpu_torch.__file__))
    root = os.path.dirname(pkg)
    sources = {}
    for p in iter_py_files([pkg]):
        rel = os.path.relpath(os.path.abspath(p), root).replace(os.sep, "/")
        if lockgraph.in_program_scope(rel):
            with open(p, encoding="utf-8") as fh:
                sources[rel] = fh.read()
    graph = lockgraph.build_lock_graph(lockgraph.build_model(sources))
    static = graph.edge_names()
    missing = sorted(observed - static)
    if missing:
        raise AssertionError(f"locks: edges observed at run time but "
                             f"absent from the static graph (a blind "
                             f"spot): {missing}")
    print(f"[locks] sanitizer on the paged engine-death server and a "
          f"float32 coalesce server: {acquisitions} acquisitions, 0 "
          f"violations, {len(observed)} observed edges "
          f"({'; '.join(f'{k}: {v}' for k, v in per.items())}), all in "
          f"the static graph of {len(static)} edges over "
          f"{len(graph.nodes())} locks from {len(sources)} sources")
    print(f"[time] locks: static graph and cross-check "
          f"{time.perf_counter() - t0:.1f} s")
    return {"observed": sorted(observed), "static_edges": len(static),
            "acquisitions": acquisitions}


def phase_profiling(model, model_f32, name="gpt2-medium"):
    """The flight recorder and the legacy baselines on GPT-2 medium at
    full width and depth:

    1. the recorder (``profile_every`` 16, ``profile_steps`` 8) over the
       mixed HTTP load (16 requests from 16 clients, prompts 64-512, 64
       new, every odd one sampled) on the fixed-lane and the paged pool:
       its records against their gates (``_recorder_gates``);
    2. a manual ``POST /profile/start|stop`` window over 1 request:
       xprof's busy seconds == the trace's kernel + memcpy + memset sum;
    3. the recorder's cost: tok/s of the load on one server with it
       attached (the load of 1.) and then detached (reported, not
       gated); float32 greedy tokens with it on == off;
    4. legacy coalescing: in float32, 8 greedy requests of one prompt
       length under ``batching="coalesce"`` and ``"off"`` == solo
       ``generate`` (coalesced_batches >= 1); in bf16 tok/s and TTFT
       under continuous, coalesce and off of the mixed load's first 4
       requests and of a load the coalescer can merge (4 greedy
       requests of 256 prompt tokens, 16 new; coalesced_batches >= 1;
       8 and 8 until PR 17, for the script's time).
    ``serve --profile-dir --profile-every --trace-file`` as a process is
    left to ``tests/test_torch_profiling.py`` on the CPU, for the
    script's time.  Returns the records with the flash launches of each
    path (0: serving reaches no flash kernel)."""
    import shutil

    split = {}
    out = {"flash_launches": {}}
    prof_root = tempfile.mkdtemp(prefix="ptpu_profile_")
    rng = np.random.RandomState(0)
    bodies = _mixed([{"prompt": rng.randint(0, model.cfg.vocab_size,
                                            n).tolist(),
                      "max_new_tokens": 64}
                     for n in rng.randint(64, 513, 16)])
    # The load the coalescer can merge: MERGE_N greedy requests of one
    # prompt length and budget.
    merge = [{"prompt": p, "max_new_tokens": MERGE_NEW}
             for p in np.random.RandomState(1).randint(
                 0, model.cfg.vocab_size, (MERGE_N, MERGE_PROMPT)).tolist()]
    try:
        for pool, kw, path in (("fixed-lane", {}, "profiling_http"),
                               ("paged", {"kv_paged": True},
                                "profiling_http_paged")):
            t0 = time.perf_counter()
            rec, (srv, ms, base) = _http_load(
                model, f"profiled mixed {pool}", bodies, sampled_too=True,
                warm_requests=1, idle_share=False,
                profile_dir=os.path.join(prof_root, pool),
                profile_every=PROFILE_EVERY, profile_steps=PROFILE_STEPS,
                **kw)
            try:
                out[pool] = {"load": rec,
                             **_recorder_gates(f"recorder {pool}", base, ms)}
                out["flash_launches"][path] = rec["flash_launches"]
                split[f"recorder {pool}"] = time.perf_counter() - t0
                if pool == "fixed-lane":
                    t0 = time.perf_counter()
                    out["manual"] = _manual_window(
                        f"{pool}", base, ms, bodies[:1])
                    split["manual window"] = time.perf_counter() - t0
                    # The recorder's cost and the continuous side of
                    # the batching A/B: the same load on this server,
                    # warm, with its recorder detached (the disabled
                    # state), after the recorder's own run; then the
                    # merge load.
                    t0 = time.perf_counter()
                    recorder = ms.engine.recorder
                    recorder.close()
                    ms.engine.recorder = None
                    try:
                        off = _mode_stats(base, ms, "mixed (16)",
                                          bodies)["tok_per_s"]
                        modes = {"continuous": {
                            "mixed": _mode_stats(base, ms, "mixed",
                                                 bodies[:MODES_MIXED]),
                            "merge": _mode_stats(base, ms, "merge",
                                                 merge)}}
                    finally:
                        ms.engine.recorder = recorder
                    on = rec["tok_per_s"]
                    out["cost"] = {"on": on, "off": off}
                    print(f"[profile] recorder cost, mixed fixed-lane load"
                          f" on one server, recorder attached then "
                          f"detached: {on:.1f} / {off:.1f} tok/s = "
                          f"{on / off:.4f} (reported, not gated)")
                    split["recorder off + continuous A/B"] = \
                        time.perf_counter() - t0
            finally:
                _stop(srv, ms)
            _release()
        # float32: greedy tokens with the recorder on == off; the
        # coalescer and off == solo generate.
        t0 = time.perf_counter()
        p_len = 200
        greedy = [{"prompt": rng.randint(0, model.cfg.vocab_size,
                                         p_len).tolist(),
                   "max_new_tokens": 12 + i} for i in range(8)]
        solo = _solo_rows(model_f32, greedy)
        runs = {}
        # The recorder on and off: one server, its engine's recorder
        # attached for one run and detached for the other.
        srv, ms, base = _serve(model_f32, name, decode_window=2,
                               profile_dir=os.path.join(prof_root, "f32"),
                               profile_every=2, profile_steps=2)
        try:
            recorder = ms.engine.recorder
            for label in ("recorder on", "recorder off"):
                recorder.close()
                ms.engine.recorder = recorder if label == "recorder on" \
                    else None
                _, res = _load_clients(base, greedy, 8)
                runs[label] = [r[1]["new_tokens"] for r in res]
            ms.engine.recorder = recorder
            if recorder.report()["windows_analyzed"] < 1:
                raise AssertionError(f"float32 recorder: no window "
                                     f"analyzed {recorder.report()}")
        finally:
            _stop(srv, ms)
        out["locks_report"] = os.path.join(
            tempfile.mkdtemp(prefix="ptpu_locks_"), "coalesce.json")
        for mode in ("coalesce", "off"):
            # The coalescer nests device_lock -> _stats_lock: its
            # sanitized server gives _lock_cross_check an edge.
            sanitized = {"sanitize": True,
                         "sanitize_report": out["locks_report"]} \
                if mode == "coalesce" else {}
            srv, ms, base = _serve(model_f32, name, batching=mode,
                                   **sanitized)
            try:
                _, res = _load_clients(base, greedy, 8)
                runs[mode] = [r[1]["new_tokens"] for r in res]
                info = ms.info()
            finally:
                _stop(srv, ms)
            if mode == "coalesce" and info["coalesced_batches"] < 1:
                raise AssertionError(f"coalesce: no merged batch {info}")
            print(f"[coalesce] float32 {mode}: 8 greedy requests of "
                  f"{p_len} prompt tokens, 12-19 new, from 8 clients; "
                  f"coalesced batches {info['coalesced_batches']} "
                  f"({info['coalesced_requests']} requests), requests "
                  f"{info['requests']}")
        ties = _same_tokens(model_f32, "profile", greedy,
                            runs["recorder off"], runs["recorder on"])
        for mode in ("coalesce", "off", "recorder off"):
            ties += _same_tokens(model_f32, "coalesce", greedy, solo,
                                 runs[mode])
        print(f"[coalesce] float32 tokens: recorder on == off, coalesce =="
              f" off == continuous == solo generate ({ties} ties by the "
              f"rule)")
        out["f32_ties"] = ties
        split["float32 checks"] = time.perf_counter() - t0
        _release()
        # bf16: the A/B the reference keeps the coalescer for, on the
        # mixed load (distinct prompt lengths, half sampled: nothing
        # merges) and on the merge load (one shape, all greedy).
        t0 = time.perf_counter()
        # For the script's time the three modes take the first
        # MODES_MIXED of the mixed load's 16 requests (the serialized
        # modes took 29-32 s a mode at 16, 13.8-15.8 s at 8).
        out["modes"] = {**modes, **{
            mode: _mode_load(model, mode, {"mixed": bodies[:MODES_MIXED],
                                           "merge": merge})
            for mode in ("coalesce", "off")}}
        if out["modes"]["coalesce"]["merge"]["coalesced_batches"] < 1:
            raise AssertionError(f"bf16 coalesce: the merge load merged "
                                 f"nothing {out['modes']['coalesce']}")
        out["flash_launches"]["coalesce_http"] = {
            k: sum(out["modes"]["coalesce"][load]["flash_launches"][k]
                   for load in ("mixed", "merge")) for k in KERNELS}
        split["batching modes"] = time.perf_counter() - t0
        _release()
    finally:
        shutil.rmtree(prof_root, ignore_errors=True)
    for path, counts in out["flash_launches"].items():
        if any(counts.values()):
            raise AssertionError(f"{path}: flash launches {counts} "
                                 f"(serving reaches no flash kernel)")
    print(f"[time] profiling: " + ", ".join(f"{k} {v:.1f} s"
                                            for k, v in split.items()))
    return out


ROOT = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(ROOT, "polyaxon_tpu_torch", "examples")
# The status sequence the local executor records for a job that succeeds.
JOB_STATUSES = ["created", "compiled", "running", "succeeded"]


def _ptpu(env, *args, timeout=900):
    """``python -m polyaxon_tpu_torch.cli ARGS`` as a user types it: the
    exit code, its output and its wall seconds."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "polyaxon_tpu_torch.cli",
                          *args], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=timeout)
    return out.returncode, out.stdout + out.stderr, \
        time.perf_counter() - t0


def _uuid_of(output: str) -> str:
    return re.search(r"^\s+uuid: (\w+)$", output, re.M).group(1)


def _trace_kernels(path: str) -> dict:
    """Launches of each flash kernel in a torch.profiler Chrome trace, by
    the kernel's name."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return {k: sum(1 for n in names if f"{k}_" in n)
            for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}


def _split(store, uuid: str) -> str:
    """Where a tracked training run's wall went, from the store's stamps:
    spawn to ``tracking.init`` (interpreter, imports, CUDA context, model
    init), to the last tracked step, and from there to the end (the final
    checkpoint and exit)."""
    rec = store.get_run(uuid)
    init = store.read_events(uuid, "env", "env")[0]["timestamp"]
    last = store.read_events(uuid, "metric", "loss")[-1]["timestamp"]
    ckpt = os.path.join(store.outputs_path(uuid), "checkpoints")
    gb = sum(os.path.getsize(os.path.join(d, f))
             for d, _, files in os.walk(ckpt) for f in files) / 1e9
    return (f"{init - rec['started_at']:.1f} s to tracking.init, "
            f"{last - init:.1f} s to the last step, "
            f"{rec['finished_at'] - last:.1f} s to the end "
            f"({gb:.2f} GB checkpoint)")


def _run_job(env, store, train_secs):
    """The ``job``: GPT-2 medium at batch 8 x 1024 for 3 steps, the third
    under the profiler; returns the flash launches of the profiled step.
    ``train_secs``: the same 3 steps through ``train.main`` in-process."""
    from polyaxon_tpu_torch.lifecycle import V1Statuses

    rc, out, wall = _ptpu(env, "run", "-f",
                          os.path.join(EXAMPLES, "gpt2_job.yaml"),
                          "-P", "steps=3", "-P", "log_every=1",
                          "-P", "profile_at=2", "-P", "profile_steps=1",
                          "--no-watch")
    uuid = _uuid_of(out)
    rec = store.get_run(uuid)
    logs = store.read_logs(uuid)
    if rc != 0 or rec["status"] != V1Statuses.SUCCEEDED:
        raise AssertionError(f"run gpt2_job.yaml: exit {rc}, status "
                             f"{rec['status']}\n{out[-3000:]}")
    statuses = [c.type for c in store.get_statuses(uuid)]
    if statuses != JOB_STATUSES:
        raise AssertionError(f"job statuses {statuses} != {JOB_STATUSES}")
    losses = store.read_events(uuid, "metric", "loss")
    printed = re.findall(r"^step (\d+)/3 loss=(\S+)", logs, re.M)
    if [e["step"] for e in losses] != [1, 2, 3] or \
            not all(np.isfinite(e["value"]) for e in losses) or \
            [(str(e["step"]), f"{e['value']:.4g}") for e in losses] \
            != printed:
        raise AssertionError(f"tracked losses {losses} != the logged step "
                             f"lines {printed}")
    if rec["outputs"].get("loss") != losses[-1]["value"]:
        raise AssertionError(f"outputs.loss {rec['outputs'].get('loss')} "
                             f"!= the last tracked loss")
    env_rec = store.read_events(uuid, "env", "env")[-1]["value"]
    card = torch.cuda.get_device_name(0)
    if env_rec.get("backend") != "cuda" or \
            env_rec.get("device_name") != card:
        raise AssertionError(f"env event {env_rec} does not name cuda and "
                             f"{card}")
    sysdir = os.path.join(store.run_path(uuid), "events", "system")
    system = sorted(os.path.splitext(n)[0] for n in (
        os.listdir(sysdir) if os.path.isdir(sysdir) else []))
    gpu = [n for n in system if n.startswith("gpu0_")]
    if not gpu:
        raise AssertionError(f"no gpu0_* system metric among {system}")
    outputs = store.outputs_path(uuid)
    if not os.path.exists(os.path.join(outputs, "checkpoints", "3",
                                       "state.pt")):
        raise AssertionError("no checkpoint under the run's outputs")
    launches = _trace_kernels(os.path.join(outputs, "profile",
                                           "trace_step3.json"))
    _check_per_step(launches, 1, 24, "run_job profiled step")
    first = losses[0]["timestamp"] - rec["started_at"]
    tps = store.read_events(uuid, "metric", "tok_per_sec_per_chip")
    step_ms = [8 * 1024 / e["value"] * 1e3 for e in tps]
    gpu_last = {n: store.read_events(uuid, "system", n)[-1]["value"]
                for n in gpu}
    print(f"[run] job gpt2_job.yaml: {rec['status']} "
          f"({' -> '.join(statuses)}), `run` wall {wall:.1f} s "
          f"({wall - train_secs:+.1f} s over train.main in-process), first "
          f"step tracked "
          f"{first:.1f} s after the run started, step ms "
          + ", ".join(f"{ms:.1f}" for ms in step_ms)
          + " (step 3 profiled); tracked loss "
          + ", ".join(f"{e['value']:.4f}" for e in losses)
          + f" == the step lines; outputs.loss == the last; env "
            f"{env_rec['backend']} {env_rec['device_name']}; "
          + ", ".join(f"{n} {v:.4g}" for n, v in gpu_last.items())
          + f"; checkpoint outputs/checkpoints/3; profiled step's trace: "
            f"flash launches {launches}")
    print(f"[run] job wall: {_split(store, uuid)}")
    return launches


SWEEP_CUT = {"maxIterations": 3, "concurrency": 3}


def _start_sweep():
    """Starts ``run -f convnet_hyperband.yaml`` in a temporary home, as
    a user types it, and returns at once: the BASELINE's configuration
    4, the hyperband matrix over the CIFAR-10 ConvNet (seeded synthetic
    batches; batch size and lr from the example's search space), cut by
    a ``--preset`` to ``maxIterations`` 3 (two brackets, 6 trials),
    three at a time (six at once took longer: 72.6 s against 64.2 s,
    their start-ups contending for the host's cores).  The trials are
    processes of their own, mostly interpreter and CUDA start-up
    (58-90 s of wall together), so the script runs its last in-process
    phases meanwhile and ``_finish_sweep`` checks the result."""
    home = tempfile.mkdtemp(prefix="ptpu_sweep_")
    preset = os.path.join(home, "sweep.json")
    with open(preset, "w") as f:  # JSON is YAML
        json.dump({"isPreset": True, "matrix": SWEEP_CUT}, f)
    log = open(os.path.join(home, "run.log"), "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "polyaxon_tpu_torch.cli", "run", "-f",
         os.path.join(EXAMPLES, "convnet_hyperband.yaml"), "--preset",
         preset, "--no-watch"], env=_cli_env(home), cwd=ROOT, stdout=log,
        stderr=subprocess.STDOUT, text=True)
    return {"proc": proc, "log": log, "home": home, "preset": preset,
            "t0": time.perf_counter()}


def _stop_sweep(sweep, timeout=600):
    """Waits for the sweep's ``run`` (it returns once every trial has
    ended), killing it past ``timeout``.  Returns (exit code, output,
    wall seconds, seconds waited here)."""
    proc = sweep["proc"]
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    end = time.perf_counter()
    sweep["log"].seek(0)
    out = sweep["log"].read()
    sweep["log"].close()
    return rc, out, end - sweep["t0"], end - t0


def _finish_sweep(sweep):
    """The sweep started by ``_start_sweep``, once it has ended: the
    trials are the port's hyperband schedule for the sweep's seed (rung
    0 and the fresh bracket's suggestions, the promoted trial one of
    rung 0's best accuracy), each trained at its suggestion, and
    ``best_run`` the highest ``outputs.accuracy``.  The trials' walls
    include contention with the phases that ran meanwhile."""
    import shutil

    from polyaxon_tpu_torch.client import FileRunStore

    try:
        rc, out, wall, waited = sweep.pop("ended", None) or \
            _stop_sweep(sweep)
        _check_sweep(FileRunStore(sweep["home"]), rc, out, wall,
                     sweep["preset"])
    finally:
        shutil.rmtree(sweep["home"], ignore_errors=True)
    print(f"[time] run: hyperband sweep {wall:.1f} s, {waited:.1f} s of it "
          f"after the phases it overlapped")


def _check_sweep(store, rc, out, wall, preset):
    """``_finish_sweep``'s checks of the ended sweep's runs."""
    from polyaxon_tpu_torch.lifecycle import V1Statuses
    from polyaxon_tpu_torch.polyaxonfile import check_polyaxonfile
    from polyaxon_tpu_torch.tune import HyperbandManager

    path = os.path.join(EXAMPLES, "convnet_hyperband.yaml")
    cut = SWEEP_CUT
    sweep = store.get_run(_uuid_of(out))
    trials = store.list_runs(pipeline=sweep["uuid"], sort="created_at")
    bad = [(t["name"], t["status"]) for t in trials
           if t["status"] != V1Statuses.SUCCEEDED]
    if rc != 0 or sweep["status"] != V1Statuses.SUCCEEDED or bad or \
            len(trials) != 6:
        raise AssertionError(f"sweep: exit {rc}, status {sweep['status']},"
                             f" {len(trials)} trials, failed {bad}\n"
                             f"{out[-3000:]}")
    op = check_polyaxonfile([path], presets=[preset])
    mgr = HyperbandManager(op.matrix)
    (r0, r1), (f0,) = mgr.rungs(1), mgr.rungs(0)
    small, full = mgr.resource_value(r0), mgr.resource_value(r1)
    acc = {t["uuid"]: t["outputs"]["accuracy"] for t in trials}
    values = [t["meta_info"]["matrix_values"] for t in trials]
    rung0 = [{**p, "steps": small} for p in mgr.initial_suggestions(1)]
    fresh = [{**p, "steps": mgr.resource_value(f0)}
             for p in mgr.initial_suggestions(0)]
    key = (lambda p: (p["steps"], p["lr"], p["batch_size"]))
    first = [t for t in trials
             if t["meta_info"]["matrix_values"]["steps"] == small]
    promoted = [v for v in values if v["steps"] == full
                and {**v, "steps": small} in rung0]
    best0 = max(acc[t["uuid"]] for t in first)
    if sorted([v for v in values if v not in promoted], key=key) != \
            sorted(rung0 + fresh, key=key) or len(promoted) != 1 or \
            max(acc[t["uuid"]] for t in first
                if t["meta_info"]["matrix_values"]
                == {**promoted[0], "steps": small}) != best0:
        raise AssertionError(f"trials {values} != the schedule: {rung0}, "
                             f"one of rung 0's best at {full} steps, "
                             f"{fresh}")
    if any(t["inputs"].get(k) != t["meta_info"]["matrix_values"][k]
           for t in trials for k in ("lr", "batch_size")):
        raise AssertionError("a trial trained at another lr or batch size "
                             "than its suggestion")
    best = max(acc.values())
    if acc.get(sweep["outputs"].get("best_run")) != best:
        raise AssertionError(f"best_run {sweep['outputs'].get('best_run')}"
                             f" has not the highest outputs.accuracy "
                             f"{best}")
    print(f"[run] convnet_hyperband.yaml (preset {cut}): {sweep['status']}, "
          f"6 trials succeeded, `run` wall {wall:.1f} s; trials == the "
          f"port's hyperband schedule for seed {op.matrix.seed}; best_run "
          f"has the highest outputs.accuracy ({best:.4f})")
    for t in trials:
        mv = t["meta_info"]["matrix_values"]
        print(f"[run]   {t['name']}: lr {mv['lr']:.4g}, batch "
              f"{mv['batch_size']}, {mv['steps']} step(s), accuracy "
              f"{acc[t['uuid']]:.4f}, {t['duration']:.1f} s: "
              f"{_split(store, t['uuid'])}")


def _service_tokens(base, bodies):
    import urllib.request

    tokens = []
    for body in bodies:
        req = urllib.request.Request(base + "/generate",
                                     data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=300) as r:
            tokens.append(json.loads(r.read())["tokens"])
    return tokens


def _service_launches(base):
    """The flash launch counters of a served process, from ``/metrics``."""
    import urllib.request

    with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
        text = r.read().decode()
    counts = {}
    for name in KERNELS:
        metric = f"ptpu_{name}_launches_total "
        line = [ln for ln in text.splitlines() if ln.startswith(metric)]
        if len(line) != 1:
            raise AssertionError(f"service /metrics lacks {metric.strip()}")
        counts[name] = int(line[0].split()[1])
    return counts


def _gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def _run_service(env, store, home, free_before, settle):
    """The ``service``: ``serve`` of GPT-2 medium on a free port; 4 greedy
    requests one at a time == an in-process ``ModelServer`` with the same
    flags and seed; ``ops stop`` reaps it and the card's memory comes
    back to ``free_before`` (taken before anything of ``phase_run``
    started; ``settle()`` first waits for the job running beside it).
    Returns the flash launches the service process made for those
    requests, read from its ``/metrics`` before and after them."""
    import socket

    from polyaxon_tpu_torch.cli import main as cli_main
    from polyaxon_tpu_torch.lifecycle import V1Statuses
    from polyaxon_tpu_torch.serving import ModelServer

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    preset = os.path.join(home, "port.json")
    with open(preset, "w") as f:  # JSON is YAML
        json.dump({"isPreset": True, "params": {"port": {"value": port}},
                   "component": {"run": {"ports": [port]}}}, f)
    rc, out, ready = _ptpu(env, "run", "-f",
                           os.path.join(EXAMPLES, "serving.yaml"),
                           "--preset", preset)
    uuid = _uuid_of(out)
    rec = store.get_run(uuid)
    if rc != 0 or rec["status"] != V1Statuses.RUNNING:
        raise AssertionError(f"run serving.yaml: exit {rc}, status "
                             f"{rec['status']}\n{out[-2000:]}\n"
                             f"{store.read_logs(uuid)[-3000:]}")
    pid = rec["meta_info"]["service"]["pid"]
    rows = np.random.RandomState(5).randint(0, 50257, (4, 24)).tolist()
    bodies = [{"prompt": r, "max_new_tokens": 16} for r in rows]
    base = f"http://127.0.0.1:{port}"
    try:
        before = _service_launches(base)
        t0 = time.perf_counter()
        served = _service_tokens(base, bodies)
        req_s = time.perf_counter() - t0
        after = _service_launches(base)
    finally:
        rc_stop, out_stop, _ = _ptpu(env, "ops", "stop", uuid)
    deadline = time.time() + 60
    while not _gone(pid) and time.time() < deadline:
        time.sleep(0.2)
    if rc_stop != 0 or "reaped" not in out_stop or not _gone(pid):
        raise AssertionError(f"ops stop: exit {rc_stop}: {out_stop}; "
                             f"process {pid} gone: {_gone(pid)}")
    settle()
    deadline = time.time() + 30
    while time.time() < deadline:
        back = torch.cuda.mem_get_info()[0]
        if free_before - back <= 1e9:
            break
        time.sleep(0.5)
    if free_before - back > 1e9:
        raise AssertionError(f"card memory not back after ops stop: "
                             f"{(free_before - back) / 1e9:.2f} GB short")
    model = cli_main._build_serving_model("gpt2-medium", 1, 0)
    ms = ModelServer(model, model_name="gpt2-medium")
    try:
        want = [ms.generate(dict(b))["tokens"] for b in bodies]
    finally:
        ms.close()
    del model, ms
    _release()
    if served != want:
        raise AssertionError("service tokens != the in-process ModelServer")
    launches = {name: after[name] - before[name] for name in after}
    statuses = [c.type for c in store.get_statuses(uuid)]
    print(f"[run] service serving.yaml: running on port {port} when `run` "
          f"returned, {ready:.1f} s to ready; 4 greedy requests one at a "
          f"time in {req_s:.2f} s, tokens == an in-process ModelServer; "
          f"flash launches in the service for them {launches} (its "
          f"/metrics before {before}); `ops stop` reaped pid "
          f"{pid} ({' -> '.join(statuses)}), card memory back within "
          f"{max(0.0, free_before - back) / 1e9:.2f} GB")
    return launches


def phase_run(train_secs: float, sweep=None):
    """``python -m polyaxon_tpu_torch.cli run -f <example>`` in a
    temporary home, as a user types it: the ``job`` (GPT-2 medium
    training, tracked and profiled) and the GPT-2 medium ``service``;
    each result read back through the port's store.  Returns the flash
    launches by path.  The ConvNet sweep is ``_start_sweep`` /
    ``_finish_sweep``.  For the script's time the job runs beside the
    service (its process trains while the service's starts; both sequential
    until PR 17), so the job's step times and wall are taken under that
    load.  ``sweep``: the ConvNet sweep ``_start_sweep`` started, still
    running beside the job and the service (for the script's time,
    since PR 21); the service's memory check first waits for it to end
    (its result kept for ``_finish_sweep``)."""
    import threading

    from polyaxon_tpu_torch.client import FileRunStore

    with tempfile.TemporaryDirectory() as home:
        env = _cli_env(home)
        store = FileRunStore(home)
        _release()
        free_before = torch.cuda.mem_get_info()[0]
        t0 = time.perf_counter()
        job = {}

        def run_job():
            try:
                job["launches"] = _run_job(env, store, train_secs)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                job["error"] = e
            job["secs"] = time.perf_counter() - t0

        thread = threading.Thread(target=run_job, daemon=True)
        thread.start()

        def settle():
            thread.join()
            if sweep is not None and "ended" not in sweep:
                sweep["ended"] = _stop_sweep(sweep)
            if "error" in job:
                raise job["error"]

        try:
            service = _run_service(env, store, home, free_before, settle)
        finally:
            thread.join()
        settle()
        print(f"[time] run: job {job['secs']:.1f} s beside the service, "
              f"both {time.perf_counter() - t0:.1f} s")
    return {"run_job": job["launches"], "run_service": service}


# -- the deployment twin -------------------------------------------------------


# The stack pod's entry: the one-rank NCCL group from the PTPU_* block the
# operator stamps (``train.main`` starts none for one process), then the
# example's ``python -m polyaxon_tpu_torch.train`` with its arguments.
STACK_WORKER = """\
import sys

import torch.distributed as dist

from polyaxon_tpu_torch import train
from polyaxon_tpu_torch.parallel import bootstrap

topo = bootstrap.topology_from_env()
backend = bootstrap.start_process_group(
    f"tcp://{topo.coordinator_address}", topo.num_processes,
    topo.process_id, bootstrap.rank_device(topo.process_id))
print(f"[stack-pod] process group {backend}, world "
      f"{dist.get_world_size()}, rank {dist.get_rank()}, device "
      f"{bootstrap.current_device()}", flush=True)
try:
    rc = train.main(sys.argv[1:])
finally:
    bootstrap.shutdown()
sys.exit(rc)
"""


def _stack_spec(path: str, home: str, worker: str) -> None:
    """``gpt2_mpijob.yaml`` with one worker, the profiler flags of
    ``gpt2_job.yaml``, the phase's home in the worker's env (the
    operator's local runtime maps no volume) and the worker's entry."""
    import yaml

    with open(os.path.join(EXAMPLES, "gpt2_mpijob.yaml")) as f:
        doc = yaml.safe_load(f)
    comp = doc["component"]
    comp["inputs"] += [
        {"name": "profile_at", "type": "int", "value": 0,
         "isOptional": True},
        {"name": "profile_steps", "type": "int", "value": 5,
         "isOptional": True}]
    w = comp["run"]["worker"]
    w["replicas"] = 1
    c = w["container"]
    c["command"] = [sys.executable, worker]
    c["args"] += ["--profile-at={{ profile_at }}",
                  "--profile-steps={{ profile_steps }}"]
    c["env"] = [{"name": "POLYAXON_TPU_HOME", "value": home}]
    with open(path, "w") as f:
        yaml.safe_dump(doc, f, sort_keys=False)


def _wait(what: str, fn, timeout: float, interval: float = 0.2):
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(interval)
    raise AssertionError(f"[stack] timed out after {timeout:.0f} s waiting "
                         f"for {what}")


def _http_get(url: str):
    import urllib.request

    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read().decode()


def phase_stack() -> dict:
    """The deployment twin as a user stands it up: ``server``, ``run``
    with ``POLYAXON_TPU_HOST``, ``agent --backend manifest`` and the
    operator on a cluster directory, with a GPT-2 medium pod on the card
    (see the module docstring).  Returns the flash launches of the pod's
    profiled step and the phase's times."""
    import socket

    from polyaxon_tpu_torch.client import FileRunStore
    from polyaxon_tpu_torch.client.api_client import ApiRunStore
    from polyaxon_tpu_torch.lifecycle import V1Statuses

    t0 = time.perf_counter()
    build = subprocess.run(["make", "-C", os.path.join(ROOT, "operator")],
                           capture_output=True, text=True)
    if build.returncode != 0:
        raise AssertionError(f"[stack] operator build failed:\n"
                             f"{build.stdout}{build.stderr}")
    cxx = subprocess.run([os.environ.get("CXX", "g++"), "--version"],
                         capture_output=True, text=True).stdout
    print(f"[stack] operator built with {cxx.splitlines()[0]} in "
          f"{time.perf_counter() - t0:.1f} s")
    operator = os.path.join(ROOT, "operator", "build", "ptpu-operator")
    token = "stack-token"
    with tempfile.TemporaryDirectory() as home:
        cluster = os.path.join(home, "cluster")
        os.makedirs(cluster)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        host = f"http://127.0.0.1:{port}"
        env = {**_cli_env(home), "POLYAXON_TPU_AUTH_TOKEN": token}
        worker = os.path.join(home, "stack_worker.py")
        with open(worker, "w") as f:
            f.write(STACK_WORKER)
        spec = os.path.join(home, "gpt2_stack.yaml")
        _stack_spec(spec, home, worker)
        ptpu = [sys.executable, "-m", "polyaxon_tpu_torch.cli"]
        logs = {n: open(os.path.join(home, f"{n}.out"), "w")
                for n in ("server", "agent", "operator")}
        procs = {
            "server": subprocess.Popen(
                ptpu + ["server", "--port", str(port), "--auth-token",
                        token], env=env, cwd=ROOT,
                stdout=logs["server"], stderr=subprocess.STDOUT),
            "operator": subprocess.Popen(
                [operator, "--cluster-dir", cluster, "--poll-ms", "50"],
                env=env, cwd=home, stdout=logs["operator"],
                stderr=subprocess.STDOUT)}
        try:
            api = ApiRunStore(host, token=token)

            def up():
                try:
                    return api.list_runs() == []
                except Exception:  # noqa: BLE001 - not listening yet
                    return False

            _wait("the control plane", up, 120)
            # The agent's first claim needs the control plane up: an
            # agent that cannot reach it exits (a deployment restarts it).
            procs["agent"] = subprocess.Popen(
                ptpu + ["agent", "--backend", "manifest", "--cluster-dir",
                        cluster, "--host", host, "--name", "stack-agent"],
                env=env, cwd=ROOT, stdout=logs["agent"],
                stderr=subprocess.STDOUT)
            submit_env = {**env, "POLYAXON_TPU_HOST": host}
            rc, out, submit_wall = _ptpu(submit_env, "run", "-f", spec,
                               "-P", "batch_size=8", "-P", "steps=2",
                               "-P", "log_every=1", "-P", "profile_at=1",
                               "-P", "profile_steps=1", timeout=300)
            m = re.search(r"Run (\w+) queued on ", out)
            if rc != 0 or not m:
                raise AssertionError(f"[stack] run -f: exit {rc}\n{out}")
            uuid = m.group(1)
            # The CR the agent applied, read while the run is live (the
            # agent removes it once the run ends).
            cr_path = os.path.join(cluster, "operations",
                                   f"ptpu-{uuid}.json")
            _wait("the agent's CR", lambda: os.path.exists(cr_path), 120,
                  0.05)
            with open(cr_path) as f:
                cr = json.load(f)["operation"]
            pod = cr["spec"]["replicaSpecs"]["worker"]["template"]["spec"]
            main = next(c for c in pod["containers"]
                        if c["name"] == "ptpu-main")
            cr_env = {e["name"]: e.get("value") for e in main["env"]}
            if main["resources"].get("limits") != {"nvidia.com/gpu": 1} or \
                    main["resources"].get("requests") != \
                    {"nvidia.com/gpu": 1} or \
                    "google.com/tpu" in json.dumps(cr):
                raise AssertionError(f"[stack] CR resources "
                                     f"{main['resources']}")
            want_env = {"PTPU_NUM_PROCESSES": "1",
                        "PTPU_REPLICA_ROLE": "worker",
                        "POLYAXON_TPU_RUN_UUID": uuid,
                        "POLYAXON_TPU_HOME": home}
            if any(cr_env.get(k) != v for k, v in want_env.items()) or \
                    not cr_env.get("PTPU_COORDINATOR_ADDRESS"):
                raise AssertionError(f"[stack] CR env {cr_env}")

            def done():
                rec = api.get_run(uuid)
                return rec if rec.get("status") in V1Statuses.DONE else None

            rec = _wait("the run to end", done, 600, 0.5)
            conds = {c.type: c.last_transition_time
                     for c in api.get_statuses(uuid)}
            # ``ops statuses`` and ``ops logs`` over the API, side by side.
            ops = {k: subprocess.Popen(ptpu + ["ops", k, uuid],
                                       env=submit_env, cwd=ROOT,
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
                   for k in ("statuses", "logs")}
            statuses, logs_out = (ops[k].communicate(timeout=300)[0]
                                  for k in ("statuses", "logs"))
            rc, rc2 = (ops[k].returncode for k in ("statuses", "logs"))
            if rec["status"] != V1Statuses.SUCCEEDED or rc != 0 or \
                    "succeeded" not in statuses:
                with open(os.path.join(home, "operator.out")) as f:
                    op_log = f.read()
                raise AssertionError(
                    f"[stack] run ended {rec['status']}\n{statuses}\n"
                    f"{logs_out[-4000:]}\n{op_log[-2000:]}")
            group = re.search(r"\[stack-pod\] process group (\w+), world "
                              r"(\d+), rank (\d+), device (\S+)", logs_out)
            if rc2 != 0 or group is None or group.groups() != \
                    ("nccl", "1", "0", "cuda:0"):
                raise AssertionError(f"[stack] the pod's group: "
                                     f"{logs_out[-3000:]}")
            losses = api.read_events(uuid, "metric", "loss")
            printed = re.findall(r"^step (\d+)/2 loss=(\S+)", logs_out, re.M)
            if [e["step"] for e in losses] != [1, 2] or \
                    not all(np.isfinite(e["value"]) for e in losses) or \
                    [(str(e["step"]), f"{e['value']:.4g}") for e in losses] \
                    != printed:
                raise AssertionError(f"[stack] tracked losses {losses} != "
                                     f"the logged step lines {printed}")
            env_rec = api.read_events(uuid, "env", "env")[-1]["value"]
            card = torch.cuda.get_device_name(0)
            if env_rec.get("backend") != "cuda" or \
                    env_rec.get("device_name") != card:
                raise AssertionError(f"[stack] env event {env_rec}")
            last = api.last_metrics(uuid)
            if last.get("loss") != losses[-1]["value"]:
                raise AssertionError(f"[stack] last metrics {last}")
            store = FileRunStore(home)
            launches = _trace_kernels(os.path.join(
                store.outputs_path(uuid), "profile", "trace_step2.json"))
            _check_per_step(launches, 1, 24, "stack pod's profiled step")
            code, metrics = _http_get(host + "/metrics")
            if code != 200 or 'ptpu_runs{status="succeeded"} 1' not in \
                    metrics:
                raise AssertionError(f"[stack] /metrics {code}\n{metrics}")
            code, page = _http_get(host + "/ui")
            if code != 200 or "<table" not in page:
                raise AssertionError(f"[stack] dashboard {code}")
            tps = api.read_events(uuid, "metric", "tok_per_sec_per_chip")
            step_ms = [8 * 1024 / e["value"] * 1e3 for e in tps]
            # From the record's creation (the submit's request): the
            # claim, the pod's tracking.init (the agent records no
            # running status: the operator's Running phase stays in its
            # status file), the end.
            t_init = api.read_events(uuid, "env", "env")[0]["timestamp"]
            since = {"scheduled": conds["scheduled"] - conds["created"],
                     "running": t_init - conds["created"],
                     "succeeded": conds["succeeded"] - conds["created"],
                     "submit_cli": submit_wall}
        finally:
            for proc in procs.values():
                proc.terminate()
            for proc in procs.values():
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
            for f in logs.values():
                f.close()
    print(f"[stack] run {uuid}: submitted over HTTP (`run` wall "
          f"{since['submit_cli']:.1f} s); from its creation claimed after "
          f"{since['scheduled']:.2f} s, the pod's tracking.init after "
          f"{since['running']:.1f} s, succeeded after "
          f"{since['succeeded']:.1f} s; CR nvidia.com/gpu 1 (limits and "
          f"requests), PTPU_* block; pod: {group.group(1)} group of "
          f"{group.group(2)} on {group.group(4)}; step ms "
          + ", ".join(f"{ms:.1f}" for ms in step_ms)
          + " (step 2 profiled); loss "
          + ", ".join(f"{e['value']:.4f}" for e in losses)
          + f" == ops logs == the tracked events; env {env_rec['backend']} "
          f"{env_rec['device_name']}; /metrics and /ui answer")
    print(f"[stack] flash launches in the profiled step: {launches}")
    print(f"[time] stack: {time.perf_counter() - t0:.1f} s")
    return {"flash_launches": launches, "since_submit": since,
            "step_ms": step_ms}


KERNELS = {
    "flash_fwd": ("polyaxon_tpu_torch/csrc/flash_fwd.cu",
                  "polyaxon_tpu/ops/flash.py:171"),
    "flash_bwd_dq": ("polyaxon_tpu_torch/csrc/flash_bwd.cu",
                     "polyaxon_tpu/ops/flash.py:347"),
    "flash_bwd_dkv": ("polyaxon_tpu_torch/csrc/flash_bwd.cu",
                      "polyaxon_tpu/ops/flash.py:407"),
}


# -- the serving mesh ----------------------------------------------------------


MESH_F32_NEW = 16           # new tokens of the float32 mesh checks
MOE_MESH_LAYERS = 2         # of MoE-GPT-small's 12, float32 (4 until PR 21)


def _mesh_probe() -> dict:
    """The column-split probe: does each column shard's product equal
    the full product's columns bit for bit on the card (cuBLAS picks its
    kernel and split-K from M, N and K, so N / tp may take another)?
    GPT-2 medium's ``qkv`` split by heads and its ``fc1``, TinyLlama's
    q/k/v/gate/up, random weights from seed 0, bf16 and float32, tp 2
    and 4, 8 rows (a decode step's slots), 100 (a prompt's prefill)
    and 256 (a prefill chunk); then the decode step's and a prefill's
    plain attention (float32) over head shards against the whole.
    Prints and returns, per case, the bitwise shards and the largest
    |d| of the others."""
    import torch.nn.functional as F

    from polyaxon_tpu_torch.models.gpt2 import qkv_rows_by_heads
    from polyaxon_tpu_torch.models.layers import contiguous_rows

    gen = torch.Generator(device="cuda").manual_seed(0)
    # (label, out, in, split by heads, with a bias: GPT-2's have one)
    weights = (("gpt2-medium qkv", 3072, 1024, True, True),
               ("gpt2-medium fc1", 4096, 1024, False, True),
               ("tinyllama q_proj", 2048, 2048, False, False),
               ("tinyllama k_proj", 256, 2048, False, False),
               ("tinyllama v_proj", 256, 2048, False, False),
               ("tinyllama gate_proj", 5632, 2048, False, False),
               ("tinyllama up_proj", 5632, 2048, False, False))
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for tp in (2, 4):
            for rows in (8, 100, 256):
                n = n_bit = 0
                worst, off = 0.0, set()
                for label, o, i, by_heads, bias in weights:
                    w = (0.02 * torch.randn(o, i, generator=gen,
                                            device="cuda")).to(dtype)
                    bv = (0.02 * torch.randn(o, generator=gen,
                                             device="cuda")).to(dtype) \
                        if bias else None
                    x = torch.randn(rows, i, generator=gen,
                                    device="cuda").to(dtype)
                    full = F.linear(x, w, bv)
                    split = qkv_rows_by_heads(i, tp) if by_heads \
                        else contiguous_rows(o, tp)
                    for idx in split:
                        idx = idx.cuda()
                        got = F.linear(x, w.index_select(0, idx),
                                       None if bv is None else bv[idx])
                        want = full.index_select(1, idx)
                        n += 1
                        if torch.equal(got, want):
                            n_bit += 1
                            continue
                        off.add(label)
                        worst = max(worst, (got.float() - want.float())
                                    .abs().max().item())
                key = f"{str(dtype).removeprefix('torch.')} tp={tp} " \
                      f"rows={rows}"
                out[key] = {"bitwise": n_bit, "shards": n,
                            "max_abs_d": worst, "not_bitwise": sorted(off)}
                print(f"[mesh-serve] probe {key}: {n_bit}/{n} shards "
                      f"bitwise" + (f", max |d| {worst:.3e} ("
                                    f"{', '.join(sorted(off))})"
                                    if n_bit < n else ""))
    # The plain attention (float32 whatever the model's type) over each
    # head shard against the same heads of the whole, GPT-2 medium's 16
    # heads over a 1024-key lane: a decode step's 8 slots x 1 query and
    # a 100-token chunk's prefill, the queries at positions 500 on (so
    # some 500 keys are live: with one, the softmax is exact whatever
    # the kernels).  Each shard's q, k and v are tensors of their own,
    # as a shard's cache is (a view of the whole keeps its strides).
    from polyaxon_tpu_torch.ops.attention import _torch_attention

    for label, b, sq in (("decode", 8, 1), ("prefill", 1, 100)):
        q = torch.randn(b, sq, 16, 64, generator=gen, device="cuda")
        k, v = (torch.randn(b, 1024, 16, 64, generator=gen, device="cuda")
                for _ in range(2))
        keys = torch.arange(1024, device="cuda")
        pos = 500 + torch.arange(sq, device="cuda")
        mask = (keys[None, :] <= pos[:, None])[None, None]
        full = _torch_attention(q, k, v, mask, False, 0.125)
        for tp in (2, 4):
            got = torch.cat([_torch_attention(
                *(t.chunk(tp, dim=2)[r].contiguous() for t in (q, k, v)),
                mask, False, 0.125) for r in range(tp)], dim=2)
            key = f"attention float32 {label} tp={tp}"
            d = (got - full).abs().max().item()
            out[key] = {"bitwise": int(torch.equal(got, full)),
                        "shards": 1, "max_abs_d": d}
            print(f"[mesh-serve] probe {key} ([{b}, {sq} -> 1024, 16, "
                  f"64], queries at 500+): " + (
                      "bitwise" if out[key]["bitwise"]
                      else f"max |d| {d:.3e}"))
    return out


def _mesh_requests(cfg, spec: bool, n: int = 4) -> list:
    """``n`` requests (prompts of 16-64 tokens from seed 3): even ones
    greedy, odd ones sampled (``SAMPLED``, seed = index), and with a
    draft the last a greedy speculative one (K 3)."""
    rng = np.random.RandomState(3)
    reqs = []
    for i, m in enumerate(rng.randint(16, 65, n)):
        samp = dict(SAMPLED, seed=i) if i % 2 else None
        if spec and i == n - 1:
            samp = {"seed": i, "temperature": 0.0, "spec_k": 3}
        reqs.append((rng.randint(0, cfg.vocab_size, m).tolist(), samp))
    return reqs


def _mesh_engine(model, reqs, mesh, *, paged, draft=None, new=None,
                 n_slots=4, prefill_chunk=64, rounds=1):
    """``reqs`` through one ``DecodeEngine`` (on ``mesh``: a spec whose
    devices are ``cuda:0`` named dp*tp*ep times), ``rounds`` times;
    returns (the last round's new tokens per request, the engine)."""
    from polyaxon_tpu_torch.serving import (DecodeEngine, SamplingSpec,
                                            SchedulerPolicy, ServingMesh)

    kw = dict(n_slots=n_slots, decode_window=8,
              prefill_chunk=prefill_chunk)
    if paged:
        kw.update(kv_paged=True, kv_page_tokens=16)
    sm = None
    if mesh is not None:
        sm = ServingMesh(mesh, devices=["cuda:0"] * 8)
    eng = DecodeEngine(model, autostart=False,
                       policy=SchedulerPolicy(**kw), mesh=sm,
                       draft_model=draft)
    for _ in range(rounds):
        toks = _mesh_round(eng, reqs, new or MESH_F32_NEW)
    return toks, eng


def _mesh_round(eng, reqs, new: int) -> list:
    """Submit ``reqs`` (``new`` tokens each), run the engine idle, and
    return each request's new tokens."""
    from polyaxon_tpu_torch.serving import SamplingSpec

    groups = [eng.submit(np.asarray([p]), new, None, None,
                         sampling=None if s is None else SamplingSpec(**s))
              for p, s in reqs]
    eng.run_until_idle()
    toks = []
    for (p, _), g in zip(reqs, groups):
        if g.error is not None:
            raise AssertionError(f"mesh {eng.mesh and eng.mesh.axes_str()}"
                                 f": request failed: {g.error}")
        toks.append(g.result()[0, len(p):].tolist())
    return toks


def _mesh_f32(tag, model_f32, reqs, meshes, pools, draft=None) -> dict:
    """float32: each request's tokens from the unmeshed engine equal solo
    decoding, and every meshed engine's equal the unmeshed engine's, on
    each pool — exactly, or under the tie rule (printed).  Returns the
    exact and tie counts."""
    from polyaxon_tpu_torch.models import generate as G

    with torch.no_grad():
        solo = []
        for p, s in reqs:
            if s is None or not s.get("temperature"):
                out = G.generate(model_f32, [p], max_new_tokens=MESH_F32_NEW)
            else:
                out = G.generate_positional(
                    model_f32, [p], max_new_tokens=MESH_F32_NEW,
                    **{k: v for k, v in s.items() if k != "spec_k"})
            solo.append(out[0, len(p):].tolist())

    def hold(what, want, got):
        ties = 0
        for i, ((p, s), w, g) in enumerate(zip(reqs, want, got)):
            if w != g:
                spec = s if s and s.get("temperature") else None
                _tie_or_raise(model_f32, "mesh-serve",
                              f"{tag} {what} request {i}", p, w, g, spec)
                ties += 1
        return ties

    rec = {"exact": 0, "ties": 0}
    for pool in pools:
        base, _ = _mesh_engine(model_f32, reqs, None, paged=pool == "paged",
                               draft=draft)
        ties = hold(f"unmeshed {pool} vs solo", solo, base)
        for mesh in meshes:
            got, eng = _mesh_engine(model_f32, reqs, mesh,
                                    paged=pool == "paged", draft=draft)
            t = hold(f"{mesh} {pool} vs unmeshed", base, got)
            ties += t
            rec["exact"] += len(reqs) - t
            rec["ties"] += t
            print(f"[mesh-serve] {tag} float32 {mesh} {pool}: "
                  f"{len(reqs) - t}/{len(reqs)} requests == the unmeshed "
                  f"engine exactly ({t} by the tie rule), graph captures "
                  f"{eng.sentinel.misses}")
            del eng
    return rec


def _pool_bytes(pool) -> int:
    leaves = pool.leaves() if hasattr(pool, "leaves") else pool
    return sum(t.numel() * t.element_size() for t in leaves)


MESH_BF16_NEW = 32          # new tokens of the bf16 meshed rounds


def _mesh_bf16(model) -> dict:
    """bf16, GPT-2 medium at all 24 layers, tp = 2 against unmeshed: the
    HTTP loads' first 8 requests (prompts 64-512 from seed 0, every odd
    one sampled, ``MESH_BF16_NEW`` new) twice through each engine (8
    slots).  Rows
    equal to the unmeshed run (a count: bf16 near-ties are known), the
    captures of the second round (0 expected) against the unmeshed
    engine's, the decode step (the W=8 greedy replay's ms / 8, the
    idle pool: plain attention reads the whole lane whatever the
    positions), and each shard's KV bytes as a share of the unmeshed
    pool."""
    rng = np.random.RandomState(0)
    lens = rng.randint(64, 513, 16)
    reqs = [(rng.randint(0, model.cfg.vocab_size, m).tolist(),
             dict(SAMPLED, seed=i) if i % 2 else None)
            for i, m in enumerate(lens)][:8]
    rec = {}
    for mesh in (None, "tp=2"):
        _, eng = _mesh_engine(model, reqs, mesh, paged=False,
                              new=MESH_BF16_NEW, n_slots=8,
                              prefill_chunk=256)
        warm = eng.sentinel.misses
        toks = _mesh_round(eng, reqs, MESH_BF16_NEW)
        steady = eng.sentinel.misses - warm
        pool = eng.slots
        if (8, False) not in pool._graphs:
            pool.step(8, False)
        ms = _replay_ms(pool, (8, False), lambda: None) / 8
        shards = getattr(pool._pool, "shards", [pool._pool])
        rec[mesh or "unmeshed"] = {
            "tokens": toks, "captures_warm": warm,
            "captures_steady": steady, "step_ms": ms,
            "shard_bytes": [_pool_bytes(sh) for sh in shards]}
        del eng, pool
        _release()
    base, meshed = rec["unmeshed"], rec["tp=2"]
    equal = sum(a == b for a, b in zip(base["tokens"], meshed["tokens"]))
    first = [next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
             for a, b in zip(base["tokens"], meshed["tokens"]) if a != b]
    share = [b / base["shard_bytes"][0] for b in meshed["shard_bytes"]]
    print(f"[mesh-serve] bf16 gpt2-medium (24 layers) tp=2 vs unmeshed, 8 "
          f"requests x {MESH_BF16_NEW} new: {equal}/8 rows equal (the others part at "
          f"new token {first}); decode step (W=8 "
          f"greedy replay / 8) {meshed['step_ms']:.3f} ms meshed, "
          f"{base['step_ms']:.3f} ms unmeshed; captures warm {meshed['captures_warm']} / steady "
          f"{meshed['captures_steady']} (unmeshed "
          f"{base['captures_warm']} / {base['captures_steady']}); shard KV "
          f"bytes / unmeshed pool: " + ", ".join(f"{x:.4f}" for x in share))
    if meshed["captures_steady"] or base["captures_steady"]:
        raise AssertionError("mesh bf16: graph captures after warm-up")
    if any(abs(x - 0.5) > 1e-9 for x in share):
        raise AssertionError(f"mesh bf16: shard bytes share {share} != 1/2")
    return {"rows_equal": equal, "first_diff": first, "step_ms": {
        "tp=2": meshed["step_ms"], "unmeshed": base["step_ms"]},
        "captures": {k: (v["captures_warm"], v["captures_steady"])
                     for k, v in rec.items()}, "shard_share": share}


def _mesh_weights(model) -> dict:
    """The weights a tp = 2 placement holds on each (virtual) device,
    against the model's: the first device the whole weights and half of
    the split ones, the second the other half; the placement allocates
    the shards and nothing else, and its replica holds the split weights
    as shapes only (so a server that owns the model frees them)."""
    from polyaxon_tpu_torch.serving import ServingMesh

    mesh = ServingMesh("tp=2", devices=["cuda:0"] * 2)
    sh = mesh.param_shardings(model)
    named = dict(model.named_parameters())
    named.update(model.named_buffers())
    whole = sum(t.numel() * t.element_size() for n, t in named.items()
                if not sh[n].dims)
    split = sum(t.numel() * t.element_size() for n, t in named.items()
                if sh[n].dims)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    placed = mesh.place_params(model)
    torch.cuda.synchronize()
    added = torch.cuda.memory_allocated() - before
    held = placed.device_bytes()
    names = [n for n in named if sh[n].dims]
    kept = dict(placed.replicas[0].named_parameters())
    kept.update(placed.replicas[0].named_buffers())
    meta = all(kept[n].is_meta for n in names)
    print(f"[mesh-serve] weights of gpt2-medium bf16 under tp=2: unmeshed "
          f"{whole + split} bytes ({split} split over tp); held per "
          f"device {held} (want {[whole + split // 2, split // 2]}); the "
          f"placement allocated {added} bytes (the shards: {split}); the "
          f"replica's {len(names)} split weights all meta: {meta}")
    if held != [whole + split // 2, split // 2] or not meta \
            or abs(added - split) > 512 * 2 * len(names):
        raise AssertionError("mesh weights: a device holds more than its "
                             "shards of the split weights")
    del placed
    _release()
    return {"unmeshed_bytes": whole + split, "split_bytes": split,
            "held": held, "allocated": added}


def _mesh_bf16_where(model) -> dict:
    """Where bf16 meshed and unmeshed part: one 100-token prompt's
    prefill (logits and cache), then 8 slots each holding it stepping a
    W=8 greedy window: eagerly, with every block's o_proj and fc2
    inputs and outputs recorded at each step (the first to part is
    named), and as a CUDA graph; every result of tp = 2 (its head
    shards concatenated) against unmeshed, bitwise, and each one's
    graph against its eager run."""
    from polyaxon_tpu_torch.models import generate as G
    from polyaxon_tpu_torch.serving import ServingMesh, SlotKVManager

    mesh = ServingMesh("tp=2", devices=["cuda:0"] * 2)
    models = {"unmeshed": model, "tp=2": mesh.place_params(model)}
    prompt = torch.tensor([np.random.RandomState(4).randint(
        0, model.cfg.vocab_size, 100).tolist()], device="cuda")
    got = {}
    with torch.no_grad():
        for label, m in models.items():
            meshed = label != "unmeshed"
            logits, cache = G.prefill(m, prompt)
            leaves = cache.leaves()
            got[label, "prefill"] = [logits] + (
                cache.merge_heads(leaves) if meshed else leaves)
            first = int(torch.argmax(logits[0]).item())
            # An eager W=8 window of the 8 slots with every block's
            # o_proj and fc2 inputs and outputs recorded at each step
            # (whole in both: the model's own, or the replica's), to
            # name the first step and op that part.
            seen, steps = [], [0]

            def record(tag):
                def hook(mod, inp, out):
                    if tag == "layer 0 o_proj":
                        steps[0] += 1
                    at = f"step {steps[0]} {tag}"
                    seen.append((f"{at} input", inp[0].cpu()))
                    seen.append((f"{at} output", out.cpu()))
                return hook

            blocks = (m.replicas[0] if meshed else m).h
            hooks = [getattr(block, name).register_forward_hook(
                record(f"layer {i} {name}"))
                for i, block in enumerate(blocks)
                for name in ("o_proj", "fc2")]
            pool = SlotKVManager(m, 8, mesh=mesh if meshed else None)
            for slot in range(8):
                pool.insert(slot, cache, first, 100)
            toks = torch.from_numpy(pool.step(8, False, graph=False))
            for h in hooks:
                h.remove()
            got[label, "ops"] = seen
            leaves = pool._pool.leaves()
            got[label, False] = [toks] + [t.cpu() for t in (
                pool._pool.merge_heads(leaves) if meshed else leaves)]
            del pool
            for graph in (True,):
                pool = SlotKVManager(m, 8, mesh=mesh if meshed else None)
                for slot in range(8):
                    pool.insert(slot, cache, first, 100)
                toks = torch.from_numpy(pool.step(8, False, graph=graph))
                leaves = pool._pool.leaves()
                got[label, graph] = [toks] + [t.cpu() for t in (
                    pool._pool.merge_heads(leaves) if meshed else leaves)]
                del pool
    _release()

    def cmp(a, b) -> str:
        if all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b)):
            return "bitwise"
        d = max((x.cpu().float() - y.cpu().float()).abs().max().item()
                for x, y in zip(a, b))
        return f"max |d| {d:.3e}"

    part = next(((name, (x.float() - y.float()).abs().max().item())
                 for (name, x), (_, y) in zip(got["unmeshed", "ops"],
                                              got["tp=2", "ops"])
                 if not torch.equal(x, y)), None)
    rec = {"prefill": cmp(got["unmeshed", "prefill"],
                          got["tp=2", "prefill"]),
           "first op parting in a decode step": "none" if part is None
           else f"{part[0]} (max |d| {part[1]:.3e})",
           "eager window": cmp(got["unmeshed", False], got["tp=2", False]),
           "graph window": cmp(got["unmeshed", True], got["tp=2", True]),
           "unmeshed graph vs eager": cmp(got["unmeshed", True],
                                          got["unmeshed", False]),
           "tp=2 graph vs eager": cmp(got["tp=2", True],
                                      got["tp=2", False])}
    print("[mesh-serve] bf16 where tp=2 and unmeshed part (100-token "
          "prefill's logits and cache; 8 slots x W=8 greedy window's "
          "tokens and cache): " + "; ".join(f"{k} {v}"
                                            for k, v in rec.items()))
    return rec


def _mesh_http(model) -> dict:
    """The real one-device path: ``ModelServer(mesh="tp=1")`` over HTTP
    (/generate, /info's mesh block, the two /metrics gauges), and
    ``tp=2`` on this one-card host refused by name."""
    import urllib.request

    from polyaxon_tpu_torch.serving import (MeshError, ServingMesh,
                                            parse_mesh)

    srv, ms, base = _serve(model, "gpt2-medium", n_slots=2, mesh="tp=1",
                           prefix_cache=0)
    try:
        status, got = _post_json(base, "/generate", {"prompt": [1, 2, 3],
                                                     "max_new_tokens": 4})
        if status != 200:
            raise AssertionError(f"mesh tp=1 server /generate: {status} "
                                 f"{got}")
        with urllib.request.urlopen(base + "/info", timeout=60) as r:
            info = json.loads(r.read())
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            text = r.read().decode()
    finally:
        _stop(srv, ms)
    want = {"axes": {"tp": 1}, "devices": 1, "layout": "exact"}
    gauges = [ln for ln in text.splitlines()
              if ln.startswith("ptpu_serving_mesh_")]
    if info.get("mesh") != want or gauges != [
            "ptpu_serving_mesh_devices 1",
            'ptpu_serving_mesh_axis_size{axis="tp"} 1']:
        raise AssertionError(f"mesh tp=1 server: /info mesh "
                             f"{info.get('mesh')}, gauges {gauges}")
    try:
        ServingMesh(parse_mesh("tp=2"))
        raise AssertionError("tp=2 on one card was not refused")
    except MeshError as e:
        if "needs 2 devices; only 1 available" not in str(e):
            raise
        refused = str(e)
    print(f"[mesh-serve] ModelServer(mesh='tp=1') over HTTP: "
          f"{len(got['new_tokens'][0])} tokens, /info mesh {info['mesh']}, "
          f"{' | '.join(gauges)}; ServingMesh(parse_mesh('tp=2')): "
          f"{refused!r}")
    return {"info_mesh": info["mesh"], "gauges": gauges}


def phase_serving_mesh(model, model_f32) -> dict:
    """The serving mesh (``serving/meshed.py``) on the card, over VIRTUAL
    devices: every shard on ``cuda:0``, so the time is the exact
    layout's cost on one card, not a multi-card number.

    1. the column-split probe (``_mesh_probe``);
    2. float32 engines == unmeshed engines == solo decoding (tie rule):
       GPT-2 medium's own weights at ``F32_LAYERS`` layers with a
       2-layer cut as the draft, tp 2 and 4, fixed lane and paged,
       greedy, sampled and speculative; TinyLlama's width at
       ``LLAMA_F32_LAYERS`` layers from seed 0, tp 2 (2 of its 4 KV
       heads a shard), paged; MoE-GPT-small at ``MOE_MESH_LAYERS``
       layers from seed 0, tp 2 x ep 2, both pools;
    3. bf16 at full width (``_mesh_bf16``), the weights each device
       holds (``_mesh_weights``), and where its tokens part from
       unmeshed ones (``_mesh_bf16_where``);
    4. ``ModelServer(mesh="tp=1")`` over HTTP (``_mesh_http``).
    Returns the records and the flash launches of 2-4 (0, checked:
    serving takes the plain attention path, meshed or not)."""
    from polyaxon_tpu_torch.models.registry import get_model

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    probe = _mesh_probe()
    print(f"[time] mesh-serve: probe {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    # From here every run is meshed serving (or its unmeshed twin),
    # which launches no flash kernel.
    _zero_counts()
    f32 = {}
    gpt2 = _cut_draft(model_f32, "gpt2-medium", F32_LAYERS)
    draft = _cut_draft(model_f32, "gpt2-medium", 2)
    f32["gpt2-medium"] = _mesh_f32(
        "gpt2-medium", gpt2, _mesh_requests(gpt2.cfg, spec=True),
        ("tp=2", "tp=4"), ("fixed", "paged"), draft=draft)
    del gpt2, draft
    llama = get_model(LLAMA).init_params(seed=0, device="cuda",
                                         dtype=torch.float32,
                                         num_layers=LLAMA_F32_LAYERS)
    f32[LLAMA] = _mesh_f32(LLAMA, llama,
                           _mesh_requests(llama.cfg, spec=False),
                           ("tp=2",), ("paged",))
    del llama
    moe = get_model("moe-gpt-small").init_params(
        seed=0, device="cuda", dtype=torch.float32,
        num_layers=MOE_MESH_LAYERS)
    f32["moe-gpt-small"] = _mesh_f32(
        "moe-gpt-small", moe, _mesh_requests(moe.cfg, spec=False),
        ("tp=2,ep=2",), ("fixed", "paged"))
    del moe
    _release()
    print(f"[time] mesh-serve: float32 engines "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    bf16 = _mesh_bf16(model)
    bf16["weights"] = _mesh_weights(model)
    bf16["where"] = _mesh_bf16_where(model)
    print(f"[time] mesh-serve: bf16 full width "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    http = _mesh_http(model)
    launches = _counts()
    print(f"[mesh-serve] flash launches of meshed serving: {launches}")
    if any(launches.values()):
        raise AssertionError(f"meshed serving launched flash kernels: "
                             f"{launches}")
    print(f"[time] mesh-serve: {time.perf_counter() - t_phase:.1f} s "
          f"(http {time.perf_counter() - t0:.1f} s)")
    return {"probe": probe, "f32": f32, "bf16": bf16, "http": http,
            "flash_launches": launches}


def main(argv=None) -> int:
    import argparse
    import shutil
    import threading

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
    forward_counts = phase_forward(model, model_f32)
    mark("forward")
    phase_serving(model, model_f32)
    mark("serving")
    phase_prng()
    mark("prng")
    step_ms, http = phase_http_serving(model, model_f32)
    print(f"[http] decode step ms (bf16, 8 slots, W=8 replay): "
          + ", ".join(f"{k} {v:.3f}" for k, v in step_ms.items()))
    mark("http serving")
    prefix = phase_prefix_cache(model, model_f32)
    mark("prefix cache")
    faults = phase_faults(model_f32)
    mark("fault containment")
    spec = phase_speculative(model, model_f32)
    mark("speculative decoding")
    beam = phase_beam(model_f32)
    mark("beam search")
    int8 = phase_int8(model, model_f32)
    mark("int8 weights and int8 KV")
    fleet = phase_fleet(model, model_f32)
    mark("fleet tier")
    profiling = phase_profiling(model, model_f32)
    mark("flight recorder and legacy coalescing")
    _lock_cross_check({"faults": faults["locks_report"],
                       "coalesce": profiling["locks_report"]})
    serving_mesh = phase_serving_mesh(model, model_f32)
    mark("serving mesh: the exact layout on virtual devices")
    del model, model_f32
    _release()
    train_counts, train_secs = phase_train_entry()
    mark("train.main and checkpoint serving")
    timed = phase_train_timed()
    mark("timed training")
    _release()
    # phase_tp_train's ranks import while phase_mesh runs.
    # phase_compose_train's ranks, and phase_pipeline_train's runs in
    # them, run from here beside the phases up to the named remat
    # policy's, and are collected after it, for the script's time:
    # the step ms of those phases and of the compose
    # gang's runs are taken beside each other.
    tp_gang = _start_tp_gang()
    compose_gang = _start_compose_gang()
    try:
        _release_gang(compose_gang)
        try:
            mesh = phase_mesh()
            mark("mesh: one-rank NCCL group, dp and fsdp steps")
            _release()
            tp_train = phase_tp_train(tp_gang)
        finally:
            _stop_gang(tp_gang)
        mark("tp / ep / sp training: a two-rank gloo gang on the one card")
        phase_grad_route()
        mark("gradient route check")
        _release()
        zoo = phase_zoo()
        try:
            zoo_rest = phase_zoo_rest()
        finally:
            zoo["mnist run -f"] = _finish_mnist(zoo["mnist run -f"])
        mark("zoo: bert-base, resnet50, moe-gpt-small, t5-small, vit-base, "
             "--init-hf, and beside them mnist run -f")
        model, model_f32 = llama_models()
        mark("llama init")
        llama_forward = phase_forward(model, model_f32, LLAMA, 2048,
                                      "llama forward", min_agree_bf16=0.8)
        mark("llama forward")
        phase_serving(model, model_f32, LLAMA, tag="llama", profile=False)
        mark("llama generate")
        llama_step_ms, llama_http = phase_llama_serving(model, model_f32)
        mark("llama http serving")
        llama_prefix = phase_llama_prefix(model_f32)
        mark("llama prefix cache")
        llama_spec = phase_llama_speculative(model_f32)
        mark("llama speculative decoding")
        int8_llama = phase_int8_llama(model)
        mark("llama int8")
        ring = phase_ring(model)
        mark("ring cache")
        del model
        weights = model_f32.state_dict()
        del model_f32
        _release()
        llama_train = phase_llama_train(weights)
        mark("llama timed training")
        llama_remat = phase_zoo_remat(weights, llama_train)
        mark("zoo: llama named remat policy")
        compose = phase_compose_train(compose_gang)
    finally:
        _stop_gang(compose_gang)
    mark("composed meshes and the pipeline: fsdp x tp, fsdp x ep, sp x "
         "ep, sp x fsdp, pp beside dp, fsdp and tp, and train.main "
         "--strategy pp:2 on a four-rank gloo gang on the one card, beside "
         "the phases since phase_mesh")
    pipeline = phase_pipeline_train(compose.pop("ranks"), timed["step_ms"])
    # The ConvNet sweep's trial processes start up while the last
    # checks, which time nothing the findings compare, run in-process,
    # and end beside the job and the service of phase_run.
    sweep = _start_sweep()
    # The deployment twin runs beside the same checks (its pod trains on
    # the card while they run), and ends before phase_run.
    stack = {}

    def run_stack():
        try:
            stack.update(phase_stack())
        except BaseException as e:  # noqa: BLE001 - re-raised below
            stack["error"] = e

    stack_thread = threading.Thread(target=run_stack, daemon=True)
    stack_thread.start()
    try:
        # The float32 checkpoint loader is GPT-2 medium's check (for
        # the script's time; TinyLlama's checkpoint serves in bf16).
        llama_main_counts, _ = phase_train_entry(LLAMA, steps=1, batch=4,
                                                 fwd_passes=2,
                                                 init_hf_from=weights,
                                                 checkpoint_f32=False)
        del weights
        mark("llama train.main from --init-hf and checkpoint serving")
        phase_llama_grad_route()
        mark("llama gradient route check (full and windowed)")
        phase_mistral()
        mark("mistral-tiny serving")
        stack_thread.join()
        if "error" in stack:
            raise stack["error"]
        mark("the deployment twin: server, run, agent, operator, a GPT-2 "
             "medium pod")
        _release()
        # The sweep's last trials run beside the job and the service.
        run_counts = phase_run(train_secs, sweep)
        mark("run -f: job, service")
    except BaseException:
        stack_thread.join()
        if "ended" not in sweep:
            _stop_sweep(sweep, timeout=300)   # no trial outlives the script
        shutil.rmtree(sweep["home"], ignore_errors=True)
        raise
    _finish_sweep(sweep)
    mark("run -f: convnet hyperband sweep")
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        rec = recs[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": train_counts[name],
            "launches_by_path": {
                "forward": forward_counts[name],
                "http_serving": http["greedy fixed-lane"][
                    "flash_launches"][name],
                "http_serving_sampled": http["mixed fixed-lane"][
                    "flash_launches"][name],
                "http_serving_paged": http["mixed paged"][
                    "flash_launches"][name],
                "prefix_cache": prefix["fixed-lane"]["warm"][
                    "flash_launches"][name],
                "prefix_cache_paged": prefix["paged"]["warm"][
                    "flash_launches"][name],
                "faults": faults["flash_launches"][name],
                "speculative_engine": spec["engine_flash_launches"][name],
                "speculative_http": spec["http_flash_launches"][name],
                "beam_http_and_cli": beam["flash_launches"][name],
                "llama_speculative": llama_spec[name],
                "train_main": train_counts[name],
                **{k: v[name] for k, v in mesh["flash_launches"].items()},
                **{k: v[name] for k, v in
                   tp_train["flash_launches"].items()},
                **{k: v[name] for k, v in
                   compose["flash_launches"].items()},
                **{k: v[name] for k, v in
                   pipeline["flash_launches"].items()},
                "run_job": run_counts["run_job"][name],
                "stack": stack["flash_launches"][name],
                "run_service": run_counts["run_service"][name],
                "llama_forward": llama_forward[name],
                "llama_train": llama_train["flash_launches"][name],
                "llama_train_main": llama_main_counts[name],
                "llama_http_serving": llama_http[
                    "llama mixed fixed-lane"]["flash_launches"][name],
                "llama_http_serving_paged": llama_http[
                    "llama mixed paged"]["flash_launches"][name],
                "llama_prefix_cache_paged": llama_prefix[4][
                    "flash_launches"][name],
                "int8_engine": int8["flash_launches"]["engine"][
                    "fixed-lane"][name],
                "int8_engine_paged": int8["flash_launches"]["engine"][
                    "paged"][name],
                "int8_http_paged": int8["flash_launches"]["http"][name],
                "ring_engine": ring["flash_launches"][name],
                "bert_train_main": zoo["bert-base"]["main_counts"][name],
                "bert_train_step": zoo["bert-base"]["step_counts"][name],
                "resnet50_train_step": zoo["resnet50"][
                    "flash_launches"][name],
                "llama_train_remat_policy": llama_remat[
                    "flash_launches"][name],
                "moe_train_step": zoo_rest["moe-gpt-small"]["train"][
                    "flash_launches"][name],
                "moe_http_serving_paged": zoo_rest["moe-gpt-small"][
                    "http"]["flash_launches"][name],
                "t5_train_main_span_corruption": zoo_rest["t5-small"][
                    "main_counts"][name],
                "t5_train_step": zoo_rest["t5-small"]["train"][
                    "flash_launches"][name],
                "vit_train_step": zoo_rest["vit-base"][
                    "flash_launches"][name],
                **{k: v[name] for k, v in
                   fleet["flash_launches"].items()},
                **{k: v[name] for k, v in
                   profiling["flash_launches"].items()},
                "serving_mesh": serving_mesh["flash_launches"][name]},
            **rec, "kernel_ms": rec["ms"]})
    print(f"[llama] decode step ms (bf16, 8 slots, W=8 replay): "
          + ", ".join(f"{k} {v:.3f}" for k, v in llama_step_ms.items())
          + f"; train step {llama_train['step_ms']:.2f} ms, MFU "
          f"{llama_train['mfu']:.4f}; HTTP tok/s "
          + ", ".join(f"{k} {r['tok_per_s']:.1f}"
                      for k, r in llama_http.items()))
    print(f"[spec] bf16 step ms (8 spec slots, K={SPEC_K}, W=1 / W=8 "
          f"replay): " + "; ".join(
              f"draft {d}: spec {r['spec W=1']:.3f} / {r['spec W=8']:.3f},"
              f" plain {r['plain W=1']:.3f} / {r['plain W=8']:.3f}, "
              f"acceptance {r['acceptance']:.3f}"
              for d, r in spec["step_ms"].items())
          + f"; HTTP {spec['http']['tok_per_s']:.1f} tok/s")
    print(f"[int8] bf16 decode step ms (8 slots, W=8 replay / 8): "
          + "; ".join(f"gpt2-medium {pool}: " + ", ".join(
              f"{k} {v:.4f}" for k, v in ms_.items())
              for pool, ms_ in int8["step_ms"].items())
          + f"; {LLAMA} paged: " + ", ".join(
              f"{k} {v:.4f}" for k, v in int8_llama.items())
          + f"; ring past 2048: {ring['step_ms']['ring']:.4f}")
    moe, t5, vit = (zoo_rest[k] for k in ("moe-gpt-small", "t5-small",
                                          "vit-base"))
    print(f"[zoo-rest] moe-gpt-small train {moe['train']['step_ms']:.2f} ms "
          f"(MFU {moe['train']['mfu']:.4f}), HTTP "
          f"{moe['http']['tok_per_s']:.1f} tok/s, decode step "
          f"{moe['decode_step_ms']:.3f} ms; t5-small train "
          f"{t5['train']['step_ms']:.2f} ms (MFU {t5['train']['mfu']:.4f}), "
          f"greedy {t5['greedy ms_per_token']:.3f} / 4 beams "
          f"{t5['4 beams ms_per_token']:.3f} ms a token; vit-base train "
          f"{vit['step_ms']:.2f} ms ({vit['img_per_s']:.1f} img/s, MFU "
          f"{vit['mfu']:.4f})")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
