"""CLI of the port: ``python -m polyaxon_tpu_torch.cli`` (``ptpu-torch``).

``run -f polyaxonfile.yaml`` compiles an operation, executes it with the
local executor (a ``job`` or a distributed kind as subprocesses, a
``service`` detached until ``ops stop``, a matrix through the tuner, a
``dag`` member by member), and tracks it in the file store; the ``ops``
group lists, compares and manages the runs.  Both are the JAX package's
commands (``polyaxon_tpu/cli/main.py``) over the port's own copies of the
orchestration layers; ``run`` does no device work itself: the
polyaxonfile's command decides where its child runs.  ``check`` is the
JAX package's command over the port: ``-f`` validates a polyaxonfile,
and without it the static analyzer (``analysis/``) checks PATHS, by
default ``polyaxon_tpu_torch/``, against the committed baseline.  The
deployment twin's commands are the JAX package's too: ``server`` (the
control plane), ``agent`` (``--backend local|manifest|kube``), ``admin
deploy``, ``doctor``, ``config``, ``port-forward``, ``project`` and
``auth``, over the port's ``scheduler/``, ``runner/agent.py``,
``k8s/`` and ``deploy.py``.

Port of ``polyaxon_tpu/cli/main.py``'s ``generate`` command (greedy,
position-keyed sampled, ``--beams`` beam search and ``--draft-model``
speculative decoding) and its ``serve`` command (the
continuous-batching HTTP server over the fixed-lane or the paged KV
pool, with the prefix cache behind ``POST /prefill``, the engine
supervisor, ``--fault-plan`` and, with ``--draft-model``, speculative
requests in the engine's spec slots; with ``--kv-host-spill-bytes``
the prefix store's host spill tier, with ``--prefix-fetch`` the fleet
wire-fetch client, ``--role prefill|decode`` for a disaggregated
fleet, ``--batching coalesce|off`` for the legacy baselines,
``--profile-dir`` / ``--profile-every`` for ``POST /profile/*`` and the
flight recorder, and ``--trace-file`` for the shutdown span dump), and
its ``route`` command (the replica router in front of
``serve`` replicas).  Both serve random-init weights
from seed 0, or the float32 master weights of a training checkpoint
(``--checkpoint DIR``) cast to the model's serving dtype, with the
serving options: ``--int8-weights`` (quantized after loading, the draft
too), ``--int8-kv`` and, for a sliding-window model, ``--kv-ring``
(``serve --kv-ring-slack``; ``generate`` gives a ring ``spec_k - 1``
spare slots with ``--draft-model``).  ``serve`` carries every flag of
the reference's; ``--mesh tp=N`` serves over ``dp * tp * ep`` local
devices in the exact layout (``serving/meshed.py``), its spec parsed
before the model is built.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import click

from polyaxon_tpu_torch import __version__


@click.group(name="ptpu-torch")
@click.version_option(version=__version__, prog_name="polyaxon-tpu-torch")
def cli():
    """polyaxon-tpu, PyTorch/CUDA port."""


def _parse_prompt(prompt: str):
    """``"1,2,3"`` -> one row; ``@file.json`` -> list of rows (all the
    same length — ragged prompts must be padded upstream)."""
    if prompt.startswith("@"):
        try:
            with open(prompt[1:]) as f:
                rows = json.load(f)
        except (OSError, ValueError) as e:
            raise click.ClickException(
                f"cannot read prompt file {prompt[1:]!r}: {e}")
        if not isinstance(rows, list):
            raise click.ClickException(
                "prompt file must hold a JSON list of token ids or a "
                "list of rows")
        if not rows or not isinstance(rows[0], list):
            rows = [rows]
    else:
        rows = [[t for t in prompt.split(",") if t.strip()]]
    try:
        rows = [[int(t) for t in r] for r in rows]
    except (TypeError, ValueError) as e:
        raise click.ClickException(
            f"prompt rows must contain integer token ids: {e}")
    if not rows or not rows[0]:
        raise click.ClickException("prompt must contain at least one "
                                   "token id")
    if len({len(r) for r in rows}) != 1:
        raise click.ClickException(
            "All prompt rows must share one length (pad upstream)")
    return rows


def _build_serving_model(name: str, batch_size: int, seed: int = 0,
                         device=None, ckpt_dir: Optional[str] = None,
                         dtype=None, kv_int8: bool = False,
                         int8_weights: bool = False,
                         kv_ring: bool = False, kv_ring_slack: int = 0):
    """Zoo model on ``device`` with the serving options applied: random
    weights from ``seed``, or the ``params`` of the newest checkpoint
    under ``ckpt_dir`` (the float32 master weights ``train`` saves,
    cast to the serving dtype); then the int8 KV / ring config fields
    (``kv_int8``, ``kv_ring`` with ``kv_ring_slack`` spare slots) and,
    after loading, ``int8_weights`` (``ops.quant.quantize_params``).
    ``dtype`` overrides the config's serving dtype."""
    from polyaxon_tpu_torch import default_device
    from polyaxon_tpu_torch.models.registry import get_model

    try:
        spec = get_model(name)
    except KeyError as e:
        raise click.ClickException(str(e.args[0]))
    from polyaxon_tpu_torch.models.generate import check_lm_head

    try:
        # Judged on a meta model: nothing is allocated for a refusal.
        check_lm_head(spec.make_model(device="meta"))
    except NotImplementedError as e:
        raise click.ClickException(str(e))
    serving = {}
    if kv_int8:
        serving["kv_cache_int8"] = True
    if kv_ring:
        serving["kv_cache_ring"] = True
        if kv_ring_slack:
            # Speculative rounds on a ring need spare slots for their
            # rollback overwrites (generate_speculative's guard).
            serving["kv_cache_ring_slack"] = int(kv_ring_slack)
    kw = dict(serving, **({} if dtype is None else {"dtype": dtype}))
    try:
        if ckpt_dir:
            # Restoring replaces the weights: no random init to discard.
            model = spec.make_model(device=default_device(device), **kw)
        else:
            model = spec.init_params(batch_size=batch_size, seed=seed,
                                     device=device, **kw)
    except TypeError:
        if serving:
            # Name only the fields the family lacks: --int8-kv
            # --kv-ring on gpt2 fails on the ring alone.
            import dataclasses as _dc

            cfg = spec.make_model(device="meta").cfg
            known = {f.name for f in _dc.fields(cfg)}
            bad = sorted(k for k in serving if k not in known) \
                or sorted(serving)
            raise click.ClickException(
                f"{name} does not support {bad} (no such config "
                f"field{'s' if len(bad) > 1 else ''} on this model "
                f"family)")
        raise
    except ValueError as e:
        if serving:
            # The config's own validation of a passed flag (kv_cache_ring
            # on a model with no sliding window): a clean CLI error.
            raise click.ClickException(str(e))
        raise
    if ckpt_dir:
        from polyaxon_tpu_torch.checkpoint import CheckpointManager

        try:
            state = CheckpointManager(directory=ckpt_dir).restore()
        except FileNotFoundError as e:
            raise click.ClickException(str(e))
        restored = state.get("params") if isinstance(state, dict) \
            else None
        if restored is None:
            raise click.ClickException(
                f"checkpoint under {ckpt_dir} has no 'params'")
        model.load_state_dict(restored, strict=True)   # casts on copy
        model = model.eval().requires_grad_(False)
    if int8_weights:
        from polyaxon_tpu_torch.ops.quant import quantize_params

        quantize_params(model)
    return model


def run_generate(model, model_name: str, rows, *, max_new_tokens: int,
                 eos_id: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, seed: int = 0,
                 beams: int = 1, draft=None, spec_k: int = 4) -> dict:
    """Decode ``rows`` and return the command's JSON record.  Sampled
    requests on a decoder-only model take the POSITION-KEYED schedule
    (``generate_positional``: token i's key is a function of ``seed``,
    the row and i alone), the contract the server's engine samples
    under, so ``generate --seed N`` and a served request with seed N
    return the same tokens.  ``draft`` decodes speculatively
    (``generate_speculative``, ``spec_k`` proposals a round; sampled
    under the same position-keyed ``seed`` schedule); ``beams`` > 1
    runs beam search."""
    import torch

    from polyaxon_tpu_torch import prng
    from polyaxon_tpu_torch.models import generate as G

    dev = model.device
    toks = torch.tensor(rows, dtype=torch.long, device=dev)
    t0 = time.perf_counter()
    try:
        G.check_decoder_only(model)
        if draft is not None:
            out = G.generate_speculative(
                model, draft, toks, max_new_tokens=max_new_tokens,
                k=spec_k, eos_id=eos_id, prefill_chunk=prefill_chunk,
                temperature=temperature, top_k=top_k, top_p=top_p,
                seed=seed if temperature != 0.0 else None)
        elif beams > 1:
            out = G.generate_beam(model, toks,
                                  max_new_tokens=max_new_tokens,
                                  num_beams=beams, eos_id=eos_id,
                                  prefill_chunk=prefill_chunk)
        elif G.positional_eligible(model, temperature):
            out = G.generate_positional(
                model, toks, max_new_tokens=max_new_tokens,
                temperature=temperature, top_k=top_k, top_p=top_p,
                eos_id=eos_id, seed=seed, prefill_chunk=prefill_chunk)
        else:
            out = G.generate(model, toks, max_new_tokens=max_new_tokens,
                             temperature=temperature, top_k=top_k,
                             top_p=top_p, eos_id=eos_id,
                             rng=prng.PRNGKey(seed, device=dev),
                             prefill_chunk=prefill_chunk)
    except (ValueError, NotImplementedError) as e:
        raise click.ClickException(str(e))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out = out.cpu()
    dt = time.perf_counter() - t0
    p_len = toks.shape[1]
    cfg = model.cfg
    from polyaxon_tpu_torch.ops.quant import has_quantized

    return {
        "model": model_name,
        "tokens": out.tolist(),
        "new_tokens": out[:, p_len:].tolist(),
        "wall_s": round(dt, 3),
        "tok_per_sec": round(len(rows) * max_new_tokens / dt, 1),
        "backend": dev.type,
        **({"int8_weights": True} if has_quantized(model) else {}),
        **({"int8_kv": True} if getattr(cfg, "kv_cache_int8", False)
           else {}),
        **({"kv_ring": True} if getattr(cfg, "kv_cache_ring", False)
           else {}),
    }


def _check_spec_flags(draft_model, draft_checkpoint, spec_k, beams=1,
                      temperature=0.0, top_k=None, top_p=None) -> None:
    """The speculative flags' validation, before any model is built:
    the library's messages (``_check_spec_k``, ``SPEC_BEAM_MSG``)."""
    from polyaxon_tpu_torch.models import generate as G

    if draft_checkpoint and not draft_model:
        raise click.ClickException(
            "--draft-checkpoint requires --draft-model")
    try:
        G._check_spec_k(spec_k)
    except ValueError as e:
        raise click.ClickException(str(e))
    if draft_model is None:
        return
    if beams > 1:
        raise click.ClickException(G.SPEC_BEAM_MSG)
    if temperature == 0.0 and (top_k is not None or top_p is not None):
        raise click.ClickException(
            "speculative --top-k/--top-p need --temperature > 0 "
            "(temperature=0 is greedy and would ignore them)")


@cli.command()
@click.option("--model", "model_name", required=True,
              help="Zoo model name (see models/registry.py).")
@click.option("--prompt", required=True,
              help="Comma-separated token ids, or @file.json with a "
                   "list of rows.")
@click.option("--max-new-tokens", default=32, type=int)
@click.option("--temperature", default=0.0, type=float,
              help="0 = greedy; > 0 samples (position-keyed: the "
                   "server's schedule).")
@click.option("--top-k", default=None, type=int)
@click.option("--top-p", default=None, type=float)
@click.option("--beams", default=1, type=int,
              help=">1 switches to beam search (greedy scoring).")
@click.option("--eos-id", default=None, type=int)
@click.option("--checkpoint", default=None, type=click.Path(),
              help="Serve the newest checkpoint under DIR (what train "
                   "writes) instead of random-init weights.")
@click.option("--draft-model", "--spec-draft", "draft_model",
              default=None,
              help="Zoo model for SPECULATIVE decoding (same vocab; "
                   "--spec-draft is an alias). Greedy by default (the "
                   "target's greedy tokens); with --temperature, "
                   "rejection speculative sampling under the "
                   "position-keyed --seed schedule the server uses.")
@click.option("--draft-checkpoint", default=None, type=click.Path(),
              help="The draft's weights: the newest checkpoint under "
                   "DIR (default: random init from seed 0).")
@click.option("--spec-k", default=4, type=int,
              help="Draft proposals per speculative round.")
@click.option("--int8-weights", is_flag=True, default=False,
              help="Weight-only int8 (int8 weights + bf16 per-channel "
                   "scales, dequantized where each layer reads them).")
@click.option("--int8-kv", is_flag=True, default=False,
              help="int8 KV cache (per-token, per-head bf16 scales).")
@click.option("--kv-ring", is_flag=True, default=False,
              help="O(window) ring KV cache for sliding-window "
                   "models: stream past max_position (composes with "
                   "beam, --int8-kv and --draft-model).")
@click.option("--seed", default=0, type=int,
              help="Sampling seed (row r's i-th token draws with "
                   "fold_in(fold_in(PRNGKey(seed), r), i)).")
@click.option("--prefill-chunk", default=None, type=int,
              help="Prefill the prompt in fixed-size pieces to bound "
                   "activation memory (long prompts).")
@click.option("--cpu", is_flag=True, default=False,
              help="Run on the CPU (default: the CUDA device).")
def generate(model_name, prompt, max_new_tokens, temperature, top_k,
             top_p, beams, eos_id, checkpoint, draft_model,
             draft_checkpoint, spec_k, int8_weights, int8_kv, kv_ring,
             seed, prefill_chunk, cpu):
    """Decode with a zoo model (greedy, sampled with --temperature, beam
    search with --beams, speculative with --draft-model); emits one
    JSON object: tokens plus timing."""
    if temperature < 0.0:
        raise click.ClickException(
            f"temperature must be >= 0; got {temperature}")
    _check_spec_flags(draft_model, draft_checkpoint, spec_k, beams,
                      temperature, top_k, top_p)
    if beams > 1 and (temperature != 0.0 or top_k is not None
                      or top_p is not None):
        raise click.ClickException(
            "beam search is deterministic (no --temperature, --top-k "
            "or --top-p)")
    rows = _parse_prompt(prompt)
    device = "cpu" if cpu else None
    # Speculative rounds on a ring overwrite up to spec_k - 1 in-window
    # slots on a rollback: both models get that slack.
    ring_slack = (spec_k - 1) if (kv_ring and draft_model) else 0
    opts = dict(kv_int8=int8_kv, int8_weights=int8_weights,
                kv_ring=kv_ring, kv_ring_slack=ring_slack)
    try:
        model = _build_serving_model(model_name, len(rows), 0, device,
                                     ckpt_dir=checkpoint, **opts)
        draft = None if draft_model is None else _build_serving_model(
            draft_model, len(rows), 0, device, ckpt_dir=draft_checkpoint,
            **opts)
    except RuntimeError as e:  # no CUDA device and no --cpu
        raise click.ClickException(str(e))
    click.echo(json.dumps(run_generate(
        model, model_name, rows, max_new_tokens=max_new_tokens,
        eos_id=eos_id, prefill_chunk=prefill_chunk,
        temperature=temperature, top_k=top_k, top_p=top_p, seed=seed,
        beams=beams, draft=draft, spec_k=spec_k)))


@cli.command()
@click.option("--model", "model_name", required=True,
              help="Zoo model name (see models/registry.py).")
@click.option("--host", default="127.0.0.1")
@click.option("--port", default=8000, type=int)
@click.option("--n-slots", "--slots", "n_slots", default=8, type=int,
              help="Decode slots in the continuous-batching pool.")
@click.option("--queue-depth", default=64, type=int,
              help="Max queued rows before /generate answers 429.")
@click.option("--prefill-chunk", default=None, type=int,
              help="Prompt-chunk length for prefill interleaved with "
                   "decode steps (default: whole prompt).")
@click.option("--decode-window", default=8, type=int,
              help="Max decode steps fused into one dispatch (one "
                   "CUDA-graph replay) when no admission is pending.")
@click.option("--request-timeout", default=600.0, type=float,
              help="Seconds a /generate waits before shedding (503).")
@click.option("--access-log", is_flag=True, default=False,
              help="One JSON line per request on stderr.")
@click.option("--request-history", default=256, type=int,
              help="Terminal request records kept for GET /requests "
                   "(0 disables).")
@click.option("--checkpoint", default=None, type=click.Path(),
              help="Serve the newest checkpoint under DIR (what train "
                   "writes) instead of random-init weights.")
@click.option("--kv-paged", is_flag=True, default=False,
              help="Paged KV cache: slot KV lives in a pool of "
                   "fixed-size pages with per-slot page tables, so "
                   "occupancy is bounded by token usage instead of "
                   "slots x max_position lanes.")
@click.option("--kv-page-tokens", default=64, type=int,
              help="With --kv-paged: positions per KV page (>= 8; "
                   "smaller pages pack tighter, bigger pages gather/"
                   "scatter less).")
@click.option("--kv-pages", default=None, type=int,
              help="With --kv-paged: page-pool size in pages (default:"
                   " the fixed-lane footprint, slots x ceil("
                   "max_position / page size)).")
@click.option("--kv-lazy", is_flag=True, default=False,
              help="With --kv-paged: LAZY page reservation — admission "
                   "reserves prompt + one decode window, slots grow "
                   "their page tables at step boundaries, and pool "
                   "exhaustion preempts the resident with the most "
                   "remaining budget (token-identical resume).")
@click.option("--kv-host-spill-bytes", default=0, type=int,
              help="With --kv-paged: the prefix store's HOST SPILL "
                   "tier byte budget.  0 (default) drops a prefix "
                   "evicted under page pressure; > 0 spills it to "
                   "host memory (coldest first past the budget), and "
                   "a later hit brings it back and promotes it to "
                   "pages.")
@click.option("--prefix-fetch/--no-prefix-fetch", default=False,
              help="Needs --kv-paged and --kv-host-spill-bytes: the "
                   "fleet prefix tier's wire-fetch client — a local "
                   "prefix miss carrying a router hint "
                   "({\"prefix_hint\": ...}) fetches the holder's "
                   "entry over HTTP (checksummed; any failure degrades "
                   "to a re-prefill, counted in "
                   "prefix_fetch_failed_total).  The serving half "
                   "(/prefix/fetch|ingest|handoff|evict, GET "
                   "/prefix/index) is mounted on every paged server.")
@click.option("--prefix-fetch-timeout", default=5.0, type=float,
              help="Per-connection timeout (seconds) for wire fetches "
                   "and handoff pushes.")
@click.option("--prefix-fetch-min-tokens", default=16, type=int,
              help="Fetch-policy floor: prefixes shorter than this "
                   "re-prefill locally.")
@click.option("--prefix-fetch-remat-ratio", default=0.26, type=float,
              help="Fetch-policy curve: rematerialization cost as a "
                   "fraction of re-prefill cost.")
@click.option("--role", default="both",
              type=click.Choice(["prefill", "decode", "both"]),
              help="Disaggregated-serving role. 'both' (default) is the "
                   "monolithic replica. 'prefill' runs prompt prefill "
                   "only — serves /prefill and the /prefix/* wire "
                   "lanes, rejects /generate (400); needs --kv-paged "
                   "and --kv-host-spill-bytes. 'decode' pulls "
                   "handed-off KV over the wire-fetch lane; needs "
                   "--prefix-fetch. The router learns roles from "
                   "/healthz.")
@click.option("--max-batch", default=8, type=int,
              help="Most prompt rows one /generate may carry.")
@click.option("--batching", default="continuous",
              type=click.Choice(["continuous", "coalesce", "off"]),
              help="Batching policy: continuous (the slot engine), "
                   "coalesce (the legacy whole-request coalescer: plain "
                   "greedy requests of one prompt length merge into one "
                   "batch) or off (every request decodes alone) — the "
                   "engine's measured A/B baselines.")
@click.option("--mesh", "mesh_arg", default=None,
              help="Serve over a device mesh, e.g. 'tp=4' or "
                   "'tp=2,ep=2': column-parallel weights split over tp "
                   "and the slot KV cache its heads (experts over ep; "
                   "dp splits the slot axis on fixed-lane pools).  The "
                   "exact serving layout: no sum crosses a device, so "
                   "meshed responses equal unmeshed ones bitwise on the "
                   "CPU, and on CUDA in float32 (bf16 ones may part at "
                   "near-ties).  "
                   "Requires --batching continuous and dp*tp*ep local "
                   "devices.")
@click.option("--prefix-cache", default=4, type=int,
              help="Prefix-cache entries (POST /prefill registers a "
                   "system prompt; matching /generate requests skip "
                   "its prefill). 0 disables; a fixed-lane entry holds "
                   "a full KV cache on the device, a paged one its "
                   "pages (shared copy-on-write by every hit).")
@click.option("--default-priority", default="interactive",
              type=click.Choice(["interactive", "batch"]),
              help="Priority class of requests that declare none: "
                   "interactive drains ahead of batch, and batch "
                   "decodes are preemptible under --slo-ttft-ms.")
@click.option("--batch-queue-depth", default=None, type=int,
              help="Admission-queue bound (rows) of the BATCH class "
                   "(default: --queue-depth).")
@click.option("--queue-deadline-ms", default=None, type=int,
              help="Shed an INTERACTIVE request (503 queue_deadline) "
                   "that got no engine attention for this long.")
@click.option("--batch-queue-deadline-ms", default=None, type=int,
              help="The same shed deadline for the BATCH class.")
@click.option("--slo-ttft-ms", default=None, type=int,
              help="Interactive TTFT SLO: when the interactive TTFT "
                   "p99 (or the waiting head's own age) degrades past "
                   "it, the longest batch decode is preempted and "
                   "requeued with its generated-so-far prefix "
                   "(token-identical resume). Unset: never preempt.")
@click.option("--trace-buffer", default=4096, type=int,
              help="Telemetry ring capacity in trace events (GET "
                   "/trace). 0 disables span recording; /metrics "
                   "histograms stay live.")
@click.option("--trace-file", default=None, type=click.Path(),
              help="Dump the telemetry ring to this JSONL file on "
                   "shutdown (one trace event per line).")
@click.option("--profile-dir", default=None, type=click.Path(),
              help="Enable POST /profile/start|stop: torch.profiler "
                   "traces land in timestamped subdirs here (omit to "
                   "keep the endpoints disabled).")
@click.option("--profile-every", default=0, type=int,
              help="FLIGHT RECORDER (needs --profile-dir): every N "
                   "decode dispatches, profile --profile-steps of them, "
                   "attribute the card's kernels, copies and memsets, "
                   "and publish collective/host-gap/device-busy shares "
                   "+ serving MFU as /metrics gauges and GET "
                   "/profile/report. 0 (default) disables.")
@click.option("--profile-steps", default=8, type=int,
              help="With --profile-every: decode dispatches per "
                   "recorder window.")
@click.option("--sanitize", is_flag=True, default=False,
              help="Wrap the serving locks in the lock-order sanitizer "
                   "(raises on lock-order inversion, reports in /info). "
                   "A debugging aid, off by default.")
@click.option("--sanitize-max-hold", default=None, type=float,
              help="With --sanitize: flag device_lock holds longer than "
                   "this many seconds.")
@click.option("--sanitize-report", "sanitize_report", default=None,
              type=click.Path(),
              help="With --sanitize: write the observed lock "
                   "acquisition graph to this JSON file at shutdown.")
@click.option("--stall-timeout", default=None, type=float,
              help="Arm the stall watchdog: when work exists but no "
                   "decode-step boundary completes for this many "
                   "seconds, write a one-shot diagnostic bundle to "
                   "--stall-dir. Unset: off.")
@click.option("--stall-dir", default=".", type=click.Path(),
              help="With --stall-timeout: where stall bundles go.")
@click.option("--forensics/--no-forensics", "forensics", default=True,
              help="Per-request phase ledgers, histogram exemplars and "
                   "the anomaly sentry (on by default).")
@click.option("--exemplar-k", default=4, type=int,
              help="Request-ID exemplars kept per latency-histogram "
                   "bucket. 0 disables exemplars only.")
@click.option("--forensics-dir", default=None, type=click.Path(),
              help="Write one anomaly bundle per sentry episode here. "
                   "Unset: findings and counters only.")
@click.option("--fault-plan", "fault_plan_path", default=None,
              type=click.Path(exists=True),
              help="CHAOS TESTING: arm the seeded fault-injection "
                   "harness from a JSON plan (sites: step, page_alloc, "
                   "slow_step, engine_death, prefix_store, "
                   "socket_reset, telemetry): bounded step retries, "
                   "quarantine (the poisoned request alone fails 500 "
                   "poisoned_request), supervised restart with "
                   "token-identical resume, the crash-storm breaker. "
                   "Unset: nothing armed.")
@click.option("--no-supervise", is_flag=True, default=False,
              help="Disable the engine crash supervisor: an engine "
                   "crash then fails every in-flight request instead "
                   "of restarting with token-identical resume.")
@click.option("--draft-model", "--spec-draft", "draft_model",
              default=None,
              help="Zoo model enabling SPECULATIVE requests "
                   "({\"speculative\": true}); same vocab as --model "
                   "(--spec-draft is an alias). Speculative requests "
                   "ride the engine's spec slots.")
@click.option("--draft-checkpoint", default=None, type=click.Path(),
              help="The draft's weights: the newest checkpoint under "
                   "DIR (default: random init from seed 0).")
@click.option("--spec-k", default=4, type=int,
              help="Default draft proposals per speculative round for "
                   "requests that pass no spec_k, and the engine's "
                   "cap: requests asking for more decode solo.")
@click.option("--int8-weights", is_flag=True, default=False,
              help="Weight-only int8 (int8 weights + bf16 per-channel "
                   "scales, dequantized where each layer reads them).")
@click.option("--int8-kv", is_flag=True, default=False,
              help="int8 KV cache (per-token, per-head bf16 scales).")
@click.option("--kv-ring", is_flag=True, default=False,
              help="O(window) ring KV cache (sliding-window models; "
                   "sessions stream past max_position).")
@click.option("--kv-ring-slack", default=0, type=int,
              help="Spare ring slots beyond the window; speculative "
                   "requests need >= spec_k - 1 (default 0 rejects "
                   "them).")
@click.option("--cpu", is_flag=True, default=False,
              help="Run on the CPU (default: the CUDA device).")
def serve(model_name, host, port, n_slots, queue_depth, prefill_chunk,
          decode_window, request_timeout, access_log, request_history,
          checkpoint, kv_paged, kv_page_tokens, kv_pages, kv_lazy,
          kv_host_spill_bytes, prefix_cache, default_priority,
          batch_queue_depth, queue_deadline_ms, batch_queue_deadline_ms,
          slo_ttft_ms, trace_buffer, sanitize, sanitize_max_hold,
          sanitize_report, stall_timeout, stall_dir, forensics,
          exemplar_k, forensics_dir, fault_plan_path, no_supervise,
          draft_model, draft_checkpoint, spec_k, int8_weights, int8_kv,
          kv_ring, kv_ring_slack, prefix_fetch, prefix_fetch_timeout,
          prefix_fetch_min_tokens, prefix_fetch_remat_ratio, role,
          max_batch, batching, mesh_arg, trace_file, profile_dir,
          profile_every, profile_steps, cpu):
    """Serve a zoo model over HTTP: greedy and sampled POST /generate
    through the continuous-batching engine (step-boundary admission,
    eos eviction, interleaved chunked prefill, fused decode windows,
    429 once the admission queue fills) over the fixed-lane or
    (--kv-paged) the paged KV pool; POST /prefill registers a prefix
    whose prefill later requests skip; /healthz, /info, /metrics,
    /trace, /requests, /debug/state; POST /drain.  Supervised: an
    engine crash restarts with token-identical resume (--no-supervise
    turns it off; --fault-plan injects faults).  --draft-model enables
    {"speculative": true} requests (the engine's spec slots, --spec-k
    the default and cap); {"num_beams": B} decodes solo.  --batching
    coalesce|off serves the legacy baselines without the engine;
    --profile-dir enables POST /profile/start|stop and, with
    --profile-every, the flight recorder (GET /profile/report);
    --trace-file dumps the span ring at shutdown.  Random-init
    weights from seed 0, or --checkpoint DIR."""
    # Flag validation before the model build (fail fast).
    for name, v in (("--n-slots", n_slots), ("--queue-depth", queue_depth),
                    ("--decode-window", decode_window)):
        if v < 1:
            raise click.ClickException(f"{name} must be >= 1")
    if prefix_cache < 0:
        raise click.ClickException("--prefix-cache must be >= 0")
    if batch_queue_depth is not None and batch_queue_depth < 1:
        raise click.ClickException("--batch-queue-depth must be >= 1")
    for name, v in (("--queue-deadline-ms", queue_deadline_ms),
                    ("--batch-queue-deadline-ms",
                     batch_queue_deadline_ms),
                    ("--slo-ttft-ms", slo_ttft_ms)):
        if v is not None and v < 1:
            raise click.ClickException(f"{name} must be >= 1")
    if trace_buffer < 0:
        raise click.ClickException("--trace-buffer must be >= 0")
    if profile_every < 0:
        raise click.ClickException("--profile-every must be >= 0")
    if profile_steps < 1:
        raise click.ClickException("--profile-steps must be >= 1")
    if profile_every and not profile_dir:
        raise click.ClickException(
            "--profile-every needs --profile-dir (the flight "
            "recorder writes torch.profiler windows there)")
    if profile_every and batching != "continuous":
        raise click.ClickException(
            "--profile-every requires --batching continuous (the "
            "flight recorder windows decode-step boundaries)")
    if exemplar_k < 0:
        raise click.ClickException("--exemplar-k must be >= 0")
    if sanitize_max_hold is not None and not sanitize:
        raise click.ClickException(
            "--sanitize-max-hold requires --sanitize")
    if sanitize_report is not None and not sanitize:
        raise click.ClickException(
            "--sanitize-report requires --sanitize")
    if stall_timeout is not None and stall_timeout <= 0:
        raise click.ClickException("--stall-timeout must be > 0")
    fault_plan = None
    if fault_plan_path is not None:
        # Parse and validate the plan before the model build: a typo'd
        # fault site must not cost a checkpoint restore.
        from polyaxon_tpu_torch.serving.faults import FaultPlan

        try:
            fault_plan = FaultPlan.load(fault_plan_path)
        except (ValueError, OSError) as e:
            raise click.ClickException(
                f"--fault-plan {fault_plan_path}: {e}")
    if prefill_chunk is not None and prefill_chunk < 1:
        raise click.ClickException("--prefill-chunk must be >= 1")
    if request_timeout <= 0:
        raise click.ClickException("--request-timeout must be > 0")
    if request_history < 0:
        raise click.ClickException("--request-history must be >= 0")
    if max_batch < 1:
        raise click.ClickException("--max-batch must be >= 1")
    _check_spec_flags(draft_model, draft_checkpoint, spec_k)
    # Paged-KV flag validation: fail fast, before the model build.
    if kv_page_tokens < 8:
        raise click.ClickException("--kv-page-tokens must be >= 8")
    if kv_pages is not None and kv_pages < 1:
        raise click.ClickException("--kv-pages must be >= 1")
    if kv_paged and kv_ring:
        raise click.ClickException(
            "--kv-paged needs a plain/int8 max_position cache; it "
            "cannot combine with --kv-ring (the ring is already "
            "O(window))")
    if kv_paged and batching != "continuous":
        raise click.ClickException(
            "--kv-paged requires --batching continuous (paging is "
            "the engine's slot storage)")
    if kv_lazy and not kv_paged:
        raise click.ClickException(
            "--kv-lazy requires --kv-paged (lazy growth is a page-"
            "reservation policy)")
    if kv_host_spill_bytes < 0:
        raise click.ClickException(
            "--kv-host-spill-bytes must be >= 0")
    if kv_host_spill_bytes and not kv_paged:
        raise click.ClickException(
            "--kv-host-spill-bytes requires --kv-paged (the host "
            "tier spills page-pool payloads)")
    if prefix_fetch and not (kv_paged and kv_host_spill_bytes):
        raise click.ClickException(
            "--prefix-fetch requires --kv-paged and "
            "--kv-host-spill-bytes (wire-fetched payloads admit "
            "through the host spill tier)")
    # Role validation before the model build: a mis-flagged tier dies
    # on usage, not after a checkpoint restore.
    if role == "prefill" and not (kv_paged and kv_host_spill_bytes):
        raise click.ClickException(
            "--role prefill requires --kv-paged and "
            "--kv-host-spill-bytes (a prefill tier's product is "
            "admit-ready KV served over the /prefix/fetch lane)")
    if role == "decode" and not prefix_fetch:
        raise click.ClickException(
            "--role decode requires --prefix-fetch (the decode tier "
            "admits handed-off prefills through the wire-fetch "
            "lane)")
    mesh_spec = None
    if mesh_arg is not None:
        # Parsed BEFORE the model build: a typo'd axis must not cost a
        # checkpoint restore.  The device count is checked by the
        # server's ServingMesh, on the platform --cpu picked.
        if batching != "continuous":
            raise click.ClickException(
                "--mesh requires --batching continuous (the mesh "
                "shards the engine's slot KV pools)")
        from polyaxon_tpu_torch.serving.meshed import MeshError, parse_mesh

        try:
            mesh_spec = parse_mesh(mesh_arg)
        except MeshError as e:
            raise click.ClickException(str(e))
    from polyaxon_tpu_torch.serving import (ModelServer,
                                            PrefixFetchPolicy,
                                            make_server)

    device = "cpu" if cpu else None
    opts = dict(kv_int8=int8_kv, int8_weights=int8_weights,
                kv_ring=kv_ring, kv_ring_slack=kv_ring_slack)
    try:
        model = _build_serving_model(model_name, 1, 0, device,
                                     ckpt_dir=checkpoint, **opts)
        draft = None if draft_model is None else _build_serving_model(
            draft_model, 1, 0, device, ckpt_dir=draft_checkpoint, **opts)
    except RuntimeError as e:  # no CUDA device and no --cpu
        raise click.ClickException(str(e))
    try:
        ms = ModelServer(model, model_name=model_name, n_slots=n_slots,
                         max_batch=max_batch, batching=batching,
                         queue_depth=queue_depth, prefill_chunk=prefill_chunk,
                         decode_window=decode_window,
                         request_timeout_s=request_timeout,
                         access_log=access_log,
                         request_history=request_history,
                         kv_paged=kv_paged, kv_page_tokens=kv_page_tokens,
                         kv_pages=kv_pages, kv_lazy=kv_lazy,
                         kv_host_spill_bytes=kv_host_spill_bytes,
                         prefix_fetch=prefix_fetch,
                         prefix_fetch_policy=PrefixFetchPolicy(
                             min_tokens=prefix_fetch_min_tokens,
                             remat_ratio=prefix_fetch_remat_ratio)
                         if prefix_fetch else None,
                         prefix_fetch_timeout_s=prefix_fetch_timeout,
                         role=role,
                         prefix_cache=prefix_cache,
                         default_priority=default_priority,
                         batch_queue_depth=batch_queue_depth,
                         queue_deadline_s=queue_deadline_ms / 1e3
                         if queue_deadline_ms is not None else None,
                         batch_queue_deadline_s=batch_queue_deadline_ms / 1e3
                         if batch_queue_deadline_ms is not None else None,
                         slo_ttft_s=slo_ttft_ms / 1e3
                         if slo_ttft_ms is not None else None,
                         trace_buffer=trace_buffer,
                         profile_dir=profile_dir,
                         profile_every=profile_every,
                         profile_steps=profile_steps, sanitize=sanitize,
                         sanitize_max_hold_s=sanitize_max_hold,
                         sanitize_report=sanitize_report,
                         stall_timeout_s=stall_timeout, stall_dir=stall_dir,
                         forensics=forensics, exemplar_k=exemplar_k,
                         forensics_dir=forensics_dir, fault_plan=fault_plan,
                         supervise=not no_supervise, draft_model=draft,
                         spec_k=spec_k, mesh=mesh_spec)
    except ValueError as e:  # e.g. a spec pool over a ring without slack,
        # or a mesh this host has too few devices for (MeshError)
        raise click.ClickException(str(e))
    # The server owns the models: on a mesh it holds their shards, and
    # the whole split weights go with these names.
    del model, draft
    try:
        srv = make_server(host, port, ms)
    except OSError as e:
        ms.close()
        raise click.ClickException(f"cannot bind {host}:{port}: {e}")
    click.echo(f"serving {model_name} on http://{host}:"
               f"{srv.server_address[1]}")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        ms.close()
        if trace_file:
            # The shutdown span dump, through the tracking stack's
            # async writer — the offline twin of GET /trace.
            from polyaxon_tpu_torch.serving.telemetry import \
                dump_spans_jsonl

            n = dump_spans_jsonl(ms.telemetry, trace_file)
            click.echo(f"wrote {n} trace events to {trace_file}",
                       err=True)


# ---------------------------------------------------------------------------
# route
# ---------------------------------------------------------------------------


@cli.command()
@click.option("--host", default="127.0.0.1")
@click.option("--port", default=8100, type=int)
@click.option("--replica", "replicas", multiple=True, required=True,
              help="Replica endpoint (host:port or http://host:port);"
                   " repeat per replica.")
@click.option("--probe-interval", default=0.5, type=float,
              help="Seconds between /healthz probe rounds.")
@click.option("--probe-timeout", default=2.0, type=float,
              help="Per-probe socket timeout (a timeout-less probe "
                   "is how a hung replica wedges the router).")
@click.option("--down-after", default=2, type=int,
              help="Consecutive transport failures that trip a "
                   "replica out of rotation.")
@click.option("--cooldown", default=1.0, type=float,
              help="Seconds out of rotation before the half-open "
                   "re-admission probe.")
@click.option("--retry-ratio", default=0.1, type=float,
              help="Retry-budget refill per live request (retries + "
                   "hedges can never exceed this fraction of "
                   "traffic plus --retry-burst).")
@click.option("--retry-burst", default=8.0, type=float,
              help="Retry-budget bucket capacity (the cold-start "
                   "failover headroom).")
@click.option("--max-attempts", default=3, type=int,
              help="Replica attempts per request (first + "
                   "failovers).")
@click.option("--request-timeout", default=120.0, type=float,
              help="Per-attempt read timeout / default request "
                   "deadline, seconds.")
@click.option("--hedge", default="off",
              help="'off', 'p99' (duplicate a request sitting past "
                   "the sliding p99 watermark), or a fixed "
                   "threshold in seconds.")
@click.option("--hedge-min", default=0.2, type=float,
              help="Hedge watermark floor, seconds.")
@click.option("--affinity/--no-affinity", default=True,
              help="Radix-prefix affinity: route a request to the "
                   "replica whose store holds its registered "
                   "prefix (never beats health).")
@click.option("--prefix-handoff/--no-prefix-handoff", default=True,
              help="Drain-time cache migration: a rolling restart "
                   "pushes the drainee's hot host-tier prefix "
                   "entries to its router-chosen successor (POST "
                   "/prefix/handoff) before the flush.  Off = a "
                   "restart is a cache flush (the per-replica "
                   "baseline).")
@click.option("--disagg-min-tokens", default=16, type=int,
              help="Disaggregated serving: prompts at or above this "
                   "length take the two-stage prefill->decode "
                   "schedule when the fleet runs a dedicated "
                   "--role prefill tier (shorter prompts decode "
                   "locally — the handoff would cost more than the "
                   "prefill).")
@click.option("--rebalance-every", default=0.0, type=float,
              help="Seconds between cadenced POST "
                   "/fleet/prefix/rebalance passes, driven off the "
                   "federated kv_host_* gauges (runs only while "
                   ">=2 replicas hold host-tier entries; "
                   "one-flight; failures counted, never fatal).  "
                   "0 = operator trigger only (default).")
@click.option("--min-ready", default=1, type=int,
              help="Rolling restart never drops the ready-replica "
                   "count below this.")
@click.option("--fleet-fault-plan", default=None, type=click.Path(),
              help="Seeded fleet chaos plan (JSON; replica_kill/"
                   "replica_hang/replica_slow sites) — local "
                   "replicas only.")
@click.option("--request-history", default=256, type=int,
              help="Router-side request-span retention ring "
                   "(GET /fleet/requests/<id> — the cross-replica "
                   "stitched timeline); 0 disables.")
@click.option("--slo", default=None,
              help="Declared objectives evaluated over a sliding "
                   "window of the router's own accounting, e.g. "
                   "'availability=99.9,ttft_p99_ms=1000'; exported "
                   "as ptpu_router_slo_burn_rate{objective=}.")
@click.option("--slo-window", default=512, type=int,
              help="Sliding-window size (requests) the SLO burn "
                   "rates are computed over.")
@click.option("--forensics/--no-forensics", "forensics",
              default=True,
              help="Router-side tail-latency forensics: the "
                   "per-request router phase ledger (route_pick/"
                   "replica_attempt/prefill_remote/retry_backoff), "
                   "its anomaly sentry (GET /anomalies), and the "
                   "fleet-merged GET /fleet/anomalies ranking.")
@click.option("--forensics-dir", default=None, type=click.Path(),
              help="Arm per-episode router anomaly bundles "
                   "(anomaly_<n>_<pid>.json). Unset = findings/"
                   "counters only.")
def route(host, port, replicas, probe_interval, probe_timeout,
          down_after, cooldown, retry_ratio, retry_burst,
          max_attempts, request_timeout, hedge, hedge_min, affinity,
          prefix_handoff, disagg_min_tokens, rebalance_every,
          min_ready, fleet_fault_plan,
          request_history, slo, slo_window, forensics,
          forensics_dir):
    """Run the replica ROUTER tier in front of N `ptpu-torch serve`
    replicas.

    The router probes each replica's /healthz (503 draining/
    engine_down takes it out of rotation; recovery re-admits it
    after a half-open success probe), balances by least-outstanding
    with radix-prefix affinity, fails replica deaths over inside a
    bounded retry budget with jittered backoff, optionally hedges
    requests past the p99 watermark (first winner cancels the
    loser), and rolls restarts via POST /fleet/restart without
    dropping below --min-ready ready replicas.

    Fleet observability: GET /fleet/requests/<id> stitches the router's request spans
    with every involved replica's history record into one causal
    timeline; GET /fleet/metrics federates every replica's /metrics
    with replica= labels and fleet rollups; --slo arms router-side
    error-budget burn-rate gauges.
    """
    from polyaxon_tpu_torch.serving import (ReplicaRouter,
                                            make_router_server)

    try:
        router = ReplicaRouter(
            list(replicas),
            probe_interval_s=probe_interval,
            probe_timeout_s=probe_timeout,
            down_after=down_after,
            cooldown_s=cooldown,
            retry_ratio=retry_ratio,
            retry_burst=retry_burst,
            max_attempts=max_attempts,
            request_timeout_s=request_timeout,
            hedge=hedge,
            hedge_min_s=hedge_min,
            affinity=affinity,
            prefix_handoff=prefix_handoff,
            disagg_min_tokens=disagg_min_tokens,
            rebalance_every_s=rebalance_every,
            min_ready=min_ready,
            fleet_faults=fleet_fault_plan,
            request_history=request_history,
            slo=slo,
            slo_window=slo_window,
            forensics=forensics,
            forensics_dir=forensics_dir)
    except ValueError as e:
        raise click.ClickException(str(e))
    try:
        srv = make_router_server(host, port, router)
    except OSError as e:
        router.close()
        raise click.ClickException(
            f"cannot bind {host}:{port}: {e}")
    click.echo(f"routing {len(replicas)} replica(s) on "
               f"http://{host}:{srv.server_address[1]}")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()
    finally:
        router.close()


# ---------------------------------------------------------------------------
# run
# ---------------------------------------------------------------------------


def _parse_params(params: Tuple[str, ...]) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for item in params:
        if "=" not in item:
            raise click.BadParameter(
                f"-P expects name=value, got {item!r}")
        key, _, value = item.partition("=")
        out[key.strip()] = value
    return out


def _echo_record(record: Dict[str, Any], fields: Optional[List[str]] = None):
    fields = fields or ["uuid", "name", "kind", "status", "created_at",
                        "duration"]
    for f in fields:
        click.echo(f"{f:>12}: {record.get(f)}")


@cli.command()
@click.option("-f", "--file", "files", multiple=True, required=True,
              type=click.Path(), help="Polyaxonfile(s) to run (merged in order).")
@click.option("-P", "--param", "params", multiple=True,
              help="Param override: -P lr=0.1 (repeatable).")
@click.option("--preset", "presets", multiple=True, type=click.Path(),
              help="Preset file(s) applied before -P params.")
@click.option("--name", default=None, help="Run name override.")
@click.option("--project", default="default", help="Project name.")
@click.option("--watch/--no-watch", default=True,
              help="Stream logs while running (local mode).")
@click.option("--eager", is_flag=True, default=False,
              help="Force local in-process execution even in API mode.")
@click.option("--check-only", is_flag=True, default=False,
              help="Validate and print the operation without running.")
@click.option("--queue", default=None,
              help="Queue override (API mode; else from the spec).")
@click.option("--priority", default=None, type=int,
              help="Priority override, higher claims first (API mode).")
def run(files, params, presets, name, project, watch, eager, check_only,
        queue, priority):
    """Run a polyaxonfile: compile, execute, track."""
    from polyaxon_tpu_torch.polyaxonfile import check_polyaxonfile
    from polyaxon_tpu_torch.polyaxonfile.reader import PolyaxonfileError

    try:
        op = check_polyaxonfile(list(files), params=_parse_params(params),
                                presets=list(presets) or None)
    except (PolyaxonfileError, ValueError) as e:
        raise click.ClickException(f"Invalid polyaxonfile: {e}")

    if check_only:
        click.echo(json.dumps(op.to_dict(), indent=2, default=str))
        return

    host = os.environ.get("POLYAXON_TPU_HOST")
    if host and not eager:
        from polyaxon_tpu_torch.client import RunClient

        client = RunClient(project=project)
        record = client.create(name=name or op.name, content=op.to_dict(),
                               kind=getattr(op.component.run, "kind", None)
                               if op.has_component else None,
                               managed_by="agent",
                               queue=queue or op.effective_queue,
                               priority=priority if priority is not None
                               else op.effective_priority)
        client.log_status("queued", reason="CliSubmit", force=True)
        click.echo(f"Run {record['uuid']} queued on {host}")
        return

    from polyaxon_tpu_torch.runner import LocalExecutor

    if queue or priority is not None:
        click.echo("note: --queue/--priority apply to queued (API-mode) "
                   "submission; this local run executes immediately.",
                   err=True)
    if name:
        op = op.model_copy(update={"name": name})
    executor = LocalExecutor(project=project, stream_logs=watch)
    try:
        record = executor.run_operation(op)
    except Exception as e:
        raise click.ClickException(f"Run failed: {e}")
    status = record.get("status")
    _echo_record(record)
    if status == "running" and record.get("kind") == "service":
        # RUNNING is the service's steady state, not a failure: it
        # stays up detached until `ops stop` reaps it.
        svc = (record.get("meta_info") or {}).get("service") or {}
        ports = svc.get("ports") or []
        where = f" on port {ports[0]}" if ports else ""
        click.echo(f"service is up{where}; stop with "
                   f"`ptpu-torch ops stop {record['uuid']}`")
        return
    if status != "succeeded":
        logs = executor.store.read_logs(record["uuid"], tail=20)
        if logs:
            click.echo("--- last logs ---")
            click.echo(logs)
        raise click.ClickException(f"Run finished with status {status!r}")


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


@cli.group()
def ops():
    """Inspect and manage runs."""


def _store():
    from polyaxon_tpu_torch.client.run_client import get_client

    return get_client()


@ops.command(name="ls")
@click.option("--project", default=None)
@click.option("--query", "-q", default=None,
              help='Filter, e.g. "status:running, metrics.loss:<0.1".')
@click.option("--sort", default="-created_at")
@click.option("--limit", default=20, type=int)
@click.option("--offset", default=0, type=int)
def ops_ls(project, query, sort, limit, offset):
    """List runs."""
    from polyaxon_tpu_torch.client.store import StoreError
    from polyaxon_tpu_torch.query import QueryError

    try:
        runs = _store().list_runs(project=project, query=query, sort=sort,
                                  limit=limit, offset=offset)
    except (QueryError, StoreError) as e:
        raise click.ClickException(str(e))
    if not runs:
        click.echo("No runs found.")
        return
    fmt = "{:<14} {:<24} {:<12} {:<11} {:<12} {:>3} {:>9}"
    click.echo(fmt.format("UUID", "NAME", "KIND", "STATUS", "QUEUE",
                          "PRI", "DURATION"))
    for r in runs:
        dur = r.get("duration")
        click.echo(fmt.format(
            r["uuid"], (r.get("name") or "")[:24], str(r.get("kind") or "-"),
            r.get("status") or "-", (r.get("queue") or "-")[:12],
            str(r.get("priority") or 0), f"{dur:.1f}s" if dur else "-",
        ))


@ops.command(name="get")
@click.argument("run_uuid")
def ops_get(run_uuid):
    """Show one run's record (+ heartbeat age for running runs)."""
    record = _get_run_or_fail(run_uuid)
    if record.get("status") == "running":
        try:
            beat = _store().heartbeat_at(run_uuid)
        except Exception:  # noqa: BLE001 - informational only
            beat = None
        if beat is not None:
            import time as _time

            # Clamp: in API mode `beat` is the server's clock; a few
            # seconds of client/server skew must not print a negative
            # age.
            record = {**record,
                      "heartbeat_age_s":
                          max(0.0, round(_time.time() - beat, 1))}
    click.echo(json.dumps(record, indent=2, default=str))


def _get_run_or_fail(run_uuid: str) -> Dict[str, Any]:
    from polyaxon_tpu_torch.client.store import StoreError

    try:
        return _store().get_run(run_uuid)
    except StoreError as e:
        raise click.ClickException(str(e))


@ops.command(name="compare")
@click.argument("run_uuids", nargs=-1, required=True)
def ops_compare(run_uuids):
    """Compare runs side by side: status, inputs, last metrics."""
    from polyaxon_tpu_torch.client.store import StoreError

    store = _store()
    records, metrics = [], []
    for u in run_uuids:
        try:
            records.append(store.get_run(u))
        except StoreError as e:
            raise click.ClickException(str(e))
        try:
            metrics.append(store.last_metrics(u))
        except Exception:  # noqa: BLE001 - missing metrics show as '-'
            metrics.append({})

    def fmt(value):
        return f"{value:.6g}" if isinstance(value, float) else str(value)

    input_keys = sorted({k for r in records
                         for k in (r.get("inputs") or {})})
    metric_keys = sorted({k for m in metrics for k in m})
    rows: List[Tuple[str, List[str]]] = [
        ("status", [r.get("status") or "-" for r in records]),
        ("duration", [f"{r['duration']:.1f}s" if r.get("duration")
                      else "-" for r in records]),
    ]
    rows += [(f"in:{k}", [fmt((r.get("inputs") or {}).get(k, "-"))
                          for r in records]) for k in input_keys]
    rows += [(f"metric:{k}", [fmt(m.get(k, "-")) for m in metrics])
             for k in metric_keys]

    label_w = max(16, max(len(k) for k, _ in rows) + 1)
    width = 22
    header = " ".join(f"{u[:12]:>{width}}" for u in run_uuids)
    click.echo(f"{'':<{label_w}}{header}")
    for key, values in rows:
        cells = " ".join(f"{v:>{width}}" for v in values)
        click.echo(f"{key:<{label_w}}{cells}")


@ops.command(name="logs")
@click.argument("run_uuid")
@click.option("--replica", default=None)
@click.option("--tail", default=None, type=int)
@click.option("--follow", "-f", is_flag=True, default=False,
              help="Stream new log lines until the run finishes.")
def ops_logs(run_uuid, replica, tail, follow):
    """Print (or follow) a run's logs."""
    import time as _time

    from polyaxon_tpu_torch.lifecycle import is_done

    _get_run_or_fail(run_uuid)
    store = _store()
    if not follow:
        click.echo(store.read_logs(run_uuid, replica=replica, tail=tail))
        return
    # Per-replica offset streaming (offsets are per file, so multiple
    # replicas can't shift each other's positions).  API store speaks
    # the protocol natively; the file store is read here.
    offsets: Dict[str, int] = {}

    def drain() -> None:
        out = store.read_logs_multi(run_uuid, offsets) \
            if hasattr(store, "read_logs_multi") else \
            _read_logs_multi(store, run_uuid, offsets)
        replicas = out.get("replicas", {})
        many = len(replicas) > 1 or (replica is None and len(offsets) > 1)
        for rep in sorted(replicas):
            if replica is not None and rep != replica:
                offsets[rep] = replicas[rep]["offset"]
                continue
            chunk = replicas[rep]["logs"]
            offsets[rep] = replicas[rep]["offset"]
            if not chunk:
                continue
            if many:
                for line in chunk.splitlines():
                    click.echo(f"[{rep}] {line}")
            else:
                click.echo(chunk, nl=False)

    while True:
        drain()
        status = store.get_run(run_uuid).get("status")
        if is_done(status):
            drain()  # final read: lines flushed just before completion
            break
        _time.sleep(1.0)


def _read_logs_multi(store, run_uuid: str,
                     offsets: Dict[str, int]) -> Dict[str, Any]:
    """Per-replica incremental reads of a file store's logs — the
    ``--follow`` protocol of the JAX package's control plane
    (``polyaxon_tpu/scheduler/api.py::ControlPlane.read_logs_multi``).

    ``offsets``: replica -> byte offset already delivered.  Returns
    {"replicas": {replica: {"logs": new_text, "offset": new_off}}}.
    """
    logs_dir = os.path.join(store.run_path(run_uuid), "logs")
    out: Dict[str, Any] = {}
    if os.path.isdir(logs_dir):
        for fname in sorted(os.listdir(logs_dir)):
            if not fname.endswith(".log"):
                continue
            replica = fname[:-4]
            offset = int(offsets.get(replica, 0))
            path = os.path.join(logs_dir, fname)
            try:
                size = os.path.getsize(path)
                if offset > size:
                    offset = 0  # truncated/rotated: restart
                with open(path, "rb") as f:
                    f.seek(offset)
                    chunk = f.read()
            except OSError:
                continue
            out[replica] = {"logs": chunk.decode(errors="replace"),
                            "offset": offset + len(chunk)}
    return {"replicas": out}


@ops.command(name="statuses")
@click.argument("run_uuid")
def ops_statuses(run_uuid):
    """Print a run's status history."""
    _get_run_or_fail(run_uuid)
    for c in _store().get_statuses(run_uuid):
        line = f"{c.last_transition_time:.0f}  {c.type:<16} {c.reason or ''}"
        if c.message:
            line += f"  {c.message}"
        click.echo(line)


@ops.command(name="artifacts")
@click.argument("run_uuid")
def ops_artifacts(run_uuid):
    """List a run's artifact tree and lineage."""
    _get_run_or_fail(run_uuid)
    store = _store()
    root = store.artifacts_path(run_uuid)
    for dirpath, _, files in os.walk(root):
        for fname in files:
            path = os.path.join(dirpath, fname)
            click.echo(os.path.relpath(path, root))
    lineage = store.get_lineage(run_uuid)
    if lineage:
        click.echo("--- lineage ---")
        for rec in lineage:
            click.echo(f"{rec.get('kind'):<10} {rec.get('name')}")


@ops.command(name="metrics")
@click.argument("run_uuid")
@click.option("--name", default=None, help="One metric series (else last values).")
def ops_metrics(run_uuid, name):
    """Show tracked metrics."""
    _get_run_or_fail(run_uuid)
    store = _store()
    if name:
        for e in store.read_events(run_uuid, "metric", name):
            click.echo(f"step={e.get('step')} value={e.get('value')}")
    else:
        for metric, value in sorted(store.last_metrics(run_uuid).items()):
            click.echo(f"{metric}: {value}")


def _reap_local_service(store, run_uuid: str) -> bool:
    """Kill a locally-spawned service (runner.local._run_service
    records its pid/session in meta_info) and mark it stopped.  The
    k8s path doesn't need this — the operator reconciles STOPPING —
    but a local detached service has no operator watching it."""
    try:
        rec = store.get_run(run_uuid)
    except Exception:
        return False
    svc = (rec.get("meta_info") or {}).get("service") or {}
    pid = svc.get("pid")
    if not pid or svc.get("host") not in (None, "127.0.0.1"):
        return False
    import signal

    try:
        os.killpg(int(pid), signal.SIGTERM)
    except ProcessLookupError:
        pass  # already gone — marking stopped is correct
    except PermissionError:
        # We could NOT signal it (pid reuse across uids, etc.) —
        # claiming "stopped" would strand a live orphan with a
        # terminal-status record no second `ops stop` can fix.
        click.echo(f"cannot signal service pid {pid} "
                   f"(permission denied); not marking stopped",
                   err=True)
        return False
    store.set_status(run_uuid, "stopped", reason="CliStop", force=True)
    return True


@ops.command(name="stop")
@click.argument("run_uuid")
def ops_stop(run_uuid):
    """Request a run stop."""
    _get_run_or_fail(run_uuid)
    store = _store()
    ok = store.set_status(run_uuid, "stopping", reason="CliStop")
    if ok and _reap_local_service(store, run_uuid):
        click.echo("stopped (local service reaped)")
        return
    click.echo("stopping" if ok else "run is already done")


@ops.command(name="delete")
@click.argument("run_uuid")
@click.confirmation_option(prompt="Delete this run and its artifacts?")
def ops_delete(run_uuid):
    """Delete a run."""
    _get_run_or_fail(run_uuid)
    _store().delete_run(run_uuid)
    click.echo(f"deleted {run_uuid}")


@ops.command(name="restart")
@click.argument("run_uuid")
@click.option("--copy", "copy_artifacts", is_flag=True,
              help="Copy the original run's artifacts into the new run.")
def ops_restart(run_uuid, copy_artifacts):
    """Restart a run as a new run (optionally copying artifacts)."""
    record = _restart(run_uuid, copy_artifacts=copy_artifacts, resume=False)
    _echo_record(record)


@ops.command(name="resume")
@click.argument("run_uuid")
def ops_resume(run_uuid):
    """Resume a run: restart pointing at the SAME artifacts (latest
    checkpoint is picked up via {{ globals.run_artifacts_path }})."""
    record = _restart(run_uuid, copy_artifacts=True, resume=True)
    _echo_record(record)


def _restart(run_uuid: str, copy_artifacts: bool, resume: bool):
    import shutil

    from polyaxon_tpu_torch.flow import V1Operation
    from polyaxon_tpu_torch.runner import LocalExecutor

    record = _get_run_or_fail(run_uuid)
    content = record.get("content")
    if not content:
        raise click.ClickException(
            f"Run {run_uuid} stores no operation content; cannot restart")
    op = V1Operation.from_dict(content)
    # Sweep children were created with matrix stripped and their concrete
    # suggestion stored in meta_info — replay it.
    matrix_values = (record.get("meta_info") or {}).get("matrix_values")
    meta = {"restarted_from": run_uuid, "is_resume": resume}
    if matrix_values:
        meta["matrix_values"] = matrix_values

    if os.environ.get("POLYAXON_TPU_HOST"):
        # API mode: resubmit to the control plane; the agent executes.
        store = _store()
        new = store.create_run(
            name=record.get("name"), project=record.get("project"),
            content=content, kind=record.get("kind"), meta_info=meta,
            managed_by="agent",
            # keep queue routing/priority: a restarted tpu-v5e run must
            # stay claimable by queue-scoped agents
            queue=record.get("queue"),
            priority=record.get("priority") or 0,
        )
        store.set_status(new["uuid"], "queued", reason="CliRestart",
                         force=True)
        return store.get_run(new["uuid"])

    executor = LocalExecutor(project=record.get("project") or "default")
    new_uuid = executor.create_run(op, meta_info=meta)
    if copy_artifacts:
        src = executor.store.artifacts_path(run_uuid)
        dst = executor.store.artifacts_path(new_uuid)
        if os.path.isdir(src):
            shutil.copytree(src, dst, dirs_exist_ok=True)
    try:
        return executor.run_operation(op, run_uuid=new_uuid,
                                      matrix_values=matrix_values)
    except Exception as e:
        raise click.ClickException(f"Restart failed: {e}")


# ---------------------------------------------------------------------------
# check: polyaxonfile validation and the static analyzer
# ---------------------------------------------------------------------------


@cli.command()
@click.argument("paths", nargs=-1, type=click.Path(exists=True))
@click.option("-f", "--file", "files", multiple=True,
              type=click.Path(),
              help="Validate polyaxonfile(s) instead of running the "
                   "static analyzer.")
@click.option("-P", "--param", "params", multiple=True)
@click.option("--format", "fmt", type=click.Choice(["text", "json"]),
              default="text", help="Finding output format.")
@click.option("--baseline", "baseline_path", default=None,
              type=click.Path(),
              help="Baseline file of accepted findings (default: the "
                   "committed polyaxon_tpu_torch/analysis/"
                   "baseline.json).")
@click.option("--update-baseline", is_flag=True, default=False,
              help="Rewrite the baseline from the current findings "
                   "(stable sort; justifications preserved, new "
                   "entries get a TODO placeholder to fill in).")
@click.option("--changed", "changed_ref", is_flag=False,
              flag_value="HEAD", metavar="[REF]",
              # No `default=`: click only treats the value as optional
              # (bare `--changed` -> flag_value) when the default is
              # left UNSET; passing default=None re-arms the
              # requires-an-argument parse.  The resolved default is
              # still None.
              help="Incremental mode: lint only files changed vs a "
                   "git ref (default HEAD), plus untracked files — "
                   "identical findings/exit semantics to a full run "
                   "on those files.  Fast enough for a pre-commit "
                   "hook.  Use --changed=REF when followed by PATHS "
                   "(a bare ref would swallow the next argument).")
@click.option("--dump-lock-graph", "lock_graph_path", default=None,
              type=click.Path(),
              help="Write the canonical static lock-order graph "
                   "(the committed analysis/lockorder.json artifact) "
                   "to this path and exit.")
def check(paths, files, params, fmt, baseline_path, update_baseline,
          changed_ref, lock_graph_path):
    """Validate a polyaxonfile (-f), or run the static analyzer over
    PATHS (default: polyaxon_tpu_torch/).

    The analyzer machine-checks the serving stack's own invariants —
    per-module rule families RNG-DET, LOCK-HOLD, JIT-PURITY,
    HOST-SYNC, EXC-SWALLOW, ... plus the whole-program concurrency
    families LOCK-ORDER (static lock-acquisition-graph cycles =
    potential deadlocks, with witness paths) and THREAD-SHARE
    (attributes written from several thread roots with no common
    lock) — polyaxon_tpu_torch/analysis/rules/__init__.py has the
    catalog; the families whose reference sinks named JAX match the
    torch spelling of the same hazard.  Exit status is
    non-zero when findings exist beyond the committed baseline;
    suppress locally-justified findings with `# ptpu: ignore[RULE]`
    (or `# ptpu: lockfree[reason]` for by-design lock-free sharing),
    baseline historically-justified ones with --update-baseline plus
    a written justification.
    """
    if files:
        from polyaxon_tpu_torch.polyaxonfile import check_polyaxonfile
        from polyaxon_tpu_torch.polyaxonfile.reader import \
            PolyaxonfileError

        try:
            op = check_polyaxonfile(list(files),
                                    params=_parse_params(params))
        except (PolyaxonfileError, ValueError) as e:
            raise click.ClickException(str(e))
        kind = (getattr(op.component.run, "kind", "?")
                if op.has_component else "ref")
        click.echo(f"Valid operation: name={op.name!r} kind={kind}"
                   + (f" matrix={op.matrix.kind}" if op.matrix else ""))
        return

    if params:
        # -P only means something to polyaxonfile validation: a CI
        # line that lost its -f must fail loudly, not silently run
        # the analyzer and report lint status as file validity.
        raise click.ClickException(
            "-P/--param requires -f (polyaxonfile validation); "
            "the static analyzer takes PATHS only")

    import polyaxon_tpu_torch as _pkg
    from polyaxon_tpu_torch.analysis import (DEFAULT_BASELINE,
                                             apply_baseline, check_paths,
                                             load_baseline, save_baseline)
    from polyaxon_tpu_torch.analysis.checker import iter_py_files

    # Findings and baseline entries are keyed by paths relative to
    # the REPO root (the directory holding the package), never the
    # cwd — `ptpu-torch check` must match the committed baseline from
    # any working directory.
    root = os.path.dirname(
        os.path.dirname(os.path.abspath(_pkg.__file__)))
    target = list(paths) or [os.path.join(root, "polyaxon_tpu_torch")]
    for p in target:
        if not os.path.exists(p):
            raise click.ClickException(f"no such path: {p}")

    if lock_graph_path is not None:
        from polyaxon_tpu_torch.analysis import lockgraph as _lockgraph

        sources = {}
        for p in iter_py_files(target):
            rel = os.path.relpath(os.path.abspath(p), root).replace(
                os.sep, "/")
            if _lockgraph.in_program_scope(rel):
                with open(p, encoding="utf-8") as fh:
                    sources[rel] = fh.read()
        graph = _lockgraph.build_lock_graph(
            _lockgraph.build_model(sources))
        with open(lock_graph_path, "w", encoding="utf-8") as fh:
            json.dump(_lockgraph.canonical_graph(graph), fh, indent=1,
                      sort_keys=True)
            fh.write("\n")
        click.echo(f"wrote {len(graph.edges)} lock-order edges to "
                   f"{lock_graph_path}")
        return

    if changed_ref is not None:
        # Incremental mode: the checked file set becomes "changed vs
        # REF (plus untracked)" intersected with the target paths.
        # Everything downstream — per-module rules, the program
        # families over the in-scope subset, baseline, exit status —
        # is exactly a full run on those files.
        import subprocess

        def _git(*args):
            return subprocess.run(["git", *args], cwd=root,
                                  capture_output=True, text=True)

        diff = _git("diff", "--name-only", changed_ref, "--", "*.py")
        if diff.returncode != 0:
            raise click.ClickException(
                f"git diff vs {changed_ref!r} failed: "
                f"{diff.stderr.strip() or diff.stdout.strip()}")
        names = set(diff.stdout.split())
        untracked = _git("ls-files", "--others", "--exclude-standard",
                         "--", "*.py")
        if untracked.returncode == 0:
            names.update(untracked.stdout.split())
        roots_abs = [os.path.abspath(t) for t in target]
        target = []
        for name in sorted(names):
            p = os.path.join(root, name)
            if not (name.endswith(".py") and os.path.isfile(p)):
                continue            # deleted files have no findings
            ap = os.path.abspath(p)
            if any(ap == t or ap.startswith(t + os.sep)
                   for t in roots_abs):
                target.append(p)

    baseline_path = baseline_path or DEFAULT_BASELINE
    findings = check_paths(target, root=root)
    if update_baseline:
        previous = load_baseline(baseline_path)
        # Only the CHECKED paths' debt is rewritten: entries for
        # files outside this run's scope are preserved verbatim, so
        # `ptpu-torch check DIR --update-baseline` can never drop
        # other files' entries (and their written justifications).
        checked = {
            os.path.relpath(os.path.abspath(f), root).replace(
                os.sep, "/")
            for f in iter_py_files(target)}
        entries = save_baseline(
            baseline_path, findings, previous=previous,
            preserve=[e for e in previous
                      if e["path"] not in checked])
        click.echo(f"wrote {len(entries)} baseline entries to "
                   f"{baseline_path}")
        return
    entries = load_baseline(baseline_path)
    new, stale = apply_baseline(findings, entries)
    if fmt == "json":
        click.echo(json.dumps({
            "checked_paths": target,
            "findings": [f.to_dict() for f in new],
            "baselined": len(findings) - len(new),
            "new": len(new),
            "stale_baseline_entries": stale,
        }, indent=1))
    else:
        for f in new:   # already stably sorted (path, line, rule)
            click.echo(f.render())
        for e in stale:
            click.echo(f"note: stale baseline entry (code fixed?): "
                       f"{e['rule']} {e['path']} [{e['func']}] — "
                       f"run --update-baseline to drop it", err=True)
        click.echo(f"{len(new)} new finding"
                   f"{'' if len(new) == 1 else 's'} "
                   f"({len(findings) - len(new)} baselined)")
    if new:
        raise SystemExit(1)


@cli.command()
@click.argument("url")
@click.option("--timeout", "timeout_s", default=5.0, type=float,
              help="Per-request HTTP timeout (seconds).")
@click.option("--format", "fmt", type=click.Choice(["text", "json"]),
              default="text", help="Report output format.")
def doctor(url, timeout_s, fmt):
    """Tail-latency forensics for a serving endpoint: fetch the
    anomaly-sentry findings from URL (a router — /fleet/anomalies —
    or a single replica — /anomalies), rank phase regressions, and
    print the exemplar request ids that resolve each one to a full
    per-attempt timeline via GET /fleet/requests/<id>."""
    import urllib.error
    import urllib.request

    base = url.rstrip("/")
    if not base.startswith(("http://", "https://")):
        base = "http://" + base

    def fetch(path):
        try:
            with urllib.request.urlopen(base + path,
                                        timeout=timeout_s) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, None
        except (OSError, ValueError) as e:
            raise click.ClickException(
                f"GET {base}{path} failed: {e}")

    # Router first; a replica answers 404 there, so fall back to its
    # own /anomalies (same findings shape, no source= attribution).
    status, body = fetch("/fleet/anomalies")
    source = "/fleet/anomalies"
    if status == 404 or not isinstance(body, dict):
        status, body = fetch("/anomalies")
        source = "/anomalies"
    if status != 200 or not isinstance(body, dict):
        raise click.ClickException(
            f"GET {base}{source} returned {status} "
            f"(forensics disabled on the target?)")
    if fmt == "json":
        click.echo(json.dumps({"url": base, "source": source,
                               **body}, indent=1))
        return
    findings = body.get("findings", [])
    click.echo(f"doctor {base} ({source})")
    for rid in body.get("fetch_errors", []):
        click.echo(f"  warning: replica {rid} did not answer "
                   f"/anomalies; its findings are absent", err=True)
    share = body.get("phase_share")
    if isinstance(share, dict) and share:
        # Single-replica report: one flat share dict; router report:
        # one dict per source.
        per_source = share if all(isinstance(v, dict)
                                  for v in share.values()) \
            else {"self": share}
        click.echo("phase shares (fraction of request wall time):")
        for src in sorted(per_source):
            shares = per_source[src]
            ranked = sorted(shares.items(),
                            key=lambda kv: -float(kv[1]))
            top = ", ".join(f"{ph}={float(v):.3f}"
                            for ph, v in ranked[:5] if float(v) > 0)
            click.echo(f"  {src:>12}: {top or '(no traffic)'}")
    if not findings:
        click.echo("no anomalies: every phase within its baseline "
                   "band (or the sentry is still building baselines)")
        return
    click.echo(f"{len(findings)} anomalous phase"
               f"{'' if len(findings) == 1 else 's'}, worst first:")
    for f in findings:
        src = f.get("source", "self")
        click.echo(
            f"  [{src}] {f.get('phase')}: share "
            f"{float(f.get('share', 0)):.3f} vs baseline "
            f"{float(f.get('baseline_ewma', 0)):.3f} "
            f"(band hi {float(f.get('band_hi', 0)):.3f}, score "
            f"{float(f.get('score', 0)):.3f}, window "
            f"{f.get('window')})")
        for rid in f.get("exemplars", []):
            click.echo(f"      exemplar {rid} -> GET "
                       f"{base}/fleet/requests/{rid}")
        if f.get("bundle"):
            click.echo(f"      bundle {f['bundle']}")
    raise SystemExit(1)


@cli.group()
def config():
    """Show/set client configuration."""


@config.command(name="show")
def config_show():
    import dataclasses

    from polyaxon_tpu_torch.client.store import default_home
    from polyaxon_tpu_torch.config import ClientConfig

    cfg = ClientConfig.load()
    click.echo(f"home: {default_home()}")
    for key, value in dataclasses.asdict(cfg).items():
        if key == "token" and value:
            value = "****"  # never echo secrets
        click.echo(f"{key}: {value}")


@config.command(name="set")
@click.argument("pairs", nargs=-1, required=True)
def config_set(pairs):
    """Persist config values: ptpu-torch config set host=http://cp:8000."""
    from polyaxon_tpu_torch.config import ClientConfig

    parsed = {}
    for pair in pairs:
        if "=" not in pair:
            raise click.ClickException(f"expected key=value, got {pair!r}")
        key, _, value = pair.partition("=")
        parsed[key.strip()] = value
    try:
        path = ClientConfig.set_file_values(parsed)
    except KeyError as e:
        raise click.ClickException(str(e))
    click.echo(f"saved {path}")


@config.command(name="get")
@click.argument("key")
def config_get(key):
    import dataclasses

    from polyaxon_tpu_torch.config import ClientConfig

    cfg = dataclasses.asdict(ClientConfig.load())
    if key not in cfg:
        raise click.ClickException(
            f"unknown key {key!r}; known: {sorted(cfg)}")
    click.echo(cfg[key])


@cli.command()
def version():
    """Print versions (framework + runtime stack)."""
    import torch

    click.echo(f"polyaxon-tpu-torch {__version__}")
    click.echo(f"torch {torch.__version__} (CUDA {torch.version.cuda})")


@cli.command(name="port-forward")
@click.argument("run_uuid")
@click.option("--port", "-p", default=None, type=int,
              help="Local port (default: same as the service port).")
@click.option("--target", default=None,
              help="Override target host:port (default: the run's "
                   "recorded endpoint, else 127.0.0.1:<service port>).")
def port_forward(run_uuid, port, target):
    """Forward a local port to a service run (notebook/TensorBoard)."""
    import socket
    import socketserver
    import threading

    record = _get_run_or_fail(run_uuid)
    meta = record.get("meta_info") or {}
    if target is None:
        target = meta.get("endpoint")
    if target is None:
        # A locally-executed service records its live ports
        # (runner.local._run_service).
        svc = meta.get("service") or {}
        if svc.get("ports"):
            target = (f"{svc.get('host', '127.0.0.1')}:"
                      f"{svc['ports'][0]}")
    if target is None:
        content = record.get("content") or {}
        run_section = (content.get("component") or {}).get("run") or {}
        ports = run_section.get("ports") or []
        if not ports:
            raise click.ClickException(
                f"Run {run_uuid} declares no service ports; pass --target")
        target = f"127.0.0.1:{ports[0]}"
    host, _, tport = target.partition(":")
    tport = int(tport or 80)
    local_port = port or tport

    class Relay(socketserver.BaseRequestHandler):
        def handle(self):
            try:
                upstream = socket.create_connection((host, tport),
                                                    timeout=10)
            except OSError as e:
                self.request.close()
                click.echo(f"connect {host}:{tport} failed: {e}", err=True)
                return

            def pump(src, dst):
                try:
                    while True:
                        data = src.recv(65536)
                        if not data:
                            break
                        dst.sendall(data)
                except OSError:
                    pass
                finally:
                    # Half-close only: EOF on src ends THIS direction;
                    # the reverse pump keeps relaying the response.
                    try:
                        dst.shutdown(socket.SHUT_WR)
                    except OSError:
                        pass

            t = threading.Thread(target=pump,
                                 args=(upstream, self.request),
                                 daemon=True)
            t.start()
            pump(self.request, upstream)
            t.join(timeout=5)

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True

    with Server(("127.0.0.1", local_port), Relay) as server:
        click.echo(f"forwarding 127.0.0.1:{local_port} -> {host}:{tport} "
                   "(ctrl-c to stop)")
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass


# ---------------------------------------------------------------------------
# project
# ---------------------------------------------------------------------------


@cli.group()
def project():
    """Inspect projects (namespaces grouping runs)."""


@project.command(name="ls")
def project_ls():
    from collections import Counter

    counts = Counter(r.get("project") or "default"
                     for r in _store().list_runs())
    for name, n in sorted(counts.items()):
        click.echo(f"{name:<24} {n} runs")


@project.command(name="runs")
@click.argument("name")
@click.option("--limit", default=20, type=int)
def project_runs(name, limit):
    for r in _store().list_runs(project=name, limit=limit):
        click.echo(f"{r['uuid']}  {r.get('status', ''):<10} "
                   f"{r.get('name', '')}")


# ---------------------------------------------------------------------------
# auth
# ---------------------------------------------------------------------------


@cli.group()
def auth():
    """Authentication against the control plane."""


@auth.command(name="login")
@click.option("--token", prompt=True, hide_input=True,
              help="API token (prompted when omitted).")
@click.option("--host", default=None)
def auth_login(token, host):
    from polyaxon_tpu_torch.config import ClientConfig

    values = {"token": token}
    if host:
        values["host"] = host
    ClientConfig.set_file_values(values)
    click.echo("logged in (token stored in home config)")


@auth.command(name="logout")
def auth_logout():
    from polyaxon_tpu_torch.config import ClientConfig

    ClientConfig.unset_file_values(["token"])
    click.echo("logged out")


@auth.command(name="whoami")
def auth_whoami():
    from polyaxon_tpu_torch.config import ClientConfig

    cfg = ClientConfig.load()
    click.echo(f"host: {cfg.host or '(local mode)'}")
    click.echo(f"token: {'set' if cfg.token else '(none)'}")


# ---------------------------------------------------------------------------
# admin
# ---------------------------------------------------------------------------


@cli.group()
def admin():
    """Deployment management."""


@admin.command(name="deploy")
@click.option("--namespace", default="polyaxon-tpu")
@click.option("--image", default="polyaxon-tpu-torch/core:latest")
@click.option("--operator-image", default="polyaxon-tpu/operator:latest")
@click.option("--artifacts-claim", default=None)
@click.option("-o", "--output", default="-",
              help="Write manifests to a file ('-' = stdout).")
def admin_deploy(namespace, image, operator_image, artifacts_claim, output):
    """Render the k8s manifests for a full deployment (CRD, RBAC,
    control plane, agent, native operator)."""
    import yaml as _yaml

    from polyaxon_tpu_torch.deploy import DeploymentConfig, render_all

    manifests = render_all(DeploymentConfig(
        namespace=namespace, image=image, operator_image=operator_image,
        artifacts_claim=artifacts_claim))
    text = "---\n".join(_yaml.safe_dump(m, sort_keys=False)
                        for m in manifests)
    if output == "-":
        click.echo(text)
    else:
        with open(output, "w") as f:
            f.write(text)
        click.echo(f"wrote {len(manifests)} manifests to {output}")


# ---------------------------------------------------------------------------
# control plane + agent services
# ---------------------------------------------------------------------------


@cli.command()
@click.option("--host", default="127.0.0.1")
@click.option("--port", default=8000, type=int)
@click.option("--schedules/--no-schedules", default=True,
              help="Also run the schedule-materializer loop.")
@click.option("--auth-token", default=None, envvar="POLYAXON_TPU_AUTH_TOKEN",
              help="Require this bearer token on every request.")
def server(host, port, schedules, auth_token):
    """Serve the control plane API (runs DB, queue, streams,
    dashboard at /ui, Prometheus gauges at /metrics)."""
    import threading

    from polyaxon_tpu_torch.client.store import FileRunStore
    from polyaxon_tpu_torch.scheduler import ControlPlane, ScheduleService, \
        make_server

    store = FileRunStore()
    srv = make_server(host, port, store,
                      plane=ControlPlane(store, auth_token=auth_token))
    if schedules:
        service = ScheduleService(store)
        threading.Thread(target=service.run_forever, daemon=True).start()
    click.echo(f"control plane on http://{host}:{port} (home={store.home})")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


@cli.command()
@click.option("--name", default="agent-0")
@click.option("--host", default=None,
              help="Control plane URL (default: POLYAXON_TPU_HOST, else "
                   "in-process over the local store).")
@click.option("--backend", type=click.Choice(["local", "manifest", "kube"]),
              default="local")
@click.option("--cluster-dir", default=None,
              help="Manifest backend: directory the operator watches.")
@click.option("--max-concurrent", default=8, type=int)
@click.option("--queue", "queues", multiple=True,
              help="Serve only these queues (repeatable; default: all).")
def agent(name, host, backend, cluster_dir, max_concurrent, queues):
    """Run an agent: claim queued runs and execute them."""
    from polyaxon_tpu_torch.runner.agent import (Agent, KubeBackend, LocalBackend,
                                           ManifestBackend)
    from polyaxon_tpu_torch.scheduler import ControlPlane

    host = host or os.environ.get("POLYAXON_TPU_HOST")
    if host:
        from polyaxon_tpu_torch.client.api_client import ApiRunStore

        plane = ApiRunStore(host)
    else:
        plane = ControlPlane()

    if backend == "manifest":
        if not cluster_dir:
            raise click.ClickException(
                "--backend manifest requires --cluster-dir")
        be = ManifestBackend(cluster_dir)
    elif backend == "kube":
        # API server + token from PTPU_K8S_* env or in-cluster config.
        be = KubeBackend()
    else:
        store = getattr(plane, "store", plane)
        be = LocalBackend(store)
    worker = Agent(plane, backend=be, name=name,
                   max_concurrent=max_concurrent,
                   queues=list(queues) or None)
    click.echo(f"agent {name} polling "
               f"{host or 'local store'} (backend={backend})")
    try:
        worker.run_forever()
    except KeyboardInterrupt:
        pass
