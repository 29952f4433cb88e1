"""CLI of the port: ``python -m polyaxon_tpu_torch.cli generate|serve``.

Port of ``polyaxon_tpu/cli/main.py``'s ``generate`` command (greedy
and position-keyed sampled decoding) and its ``serve`` command (the
continuous-batching HTTP server over the fixed-lane or the paged KV
pool).  Both serve random-init weights from seed 0, or the float32
master weights of a training checkpoint (``--checkpoint DIR``) cast to
the model's serving dtype.  The ``generate`` flags of the reference
that the port does not carry yet are kept and refused by name, so a
user learns what is missing rather than getting a different decode.
"""

from __future__ import annotations

import json
import time
from typing import Optional

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
                         dtype=None):
    """Zoo model on ``device``: random weights from ``seed``, or the
    ``params`` of the newest checkpoint under ``ckpt_dir`` (the float32
    master weights ``train`` saves, cast to the serving dtype).
    ``dtype`` overrides the config's serving dtype."""
    from polyaxon_tpu_torch import default_device
    from polyaxon_tpu_torch.models.registry import get_model

    try:
        spec = get_model(name)
    except KeyError as e:
        raise click.ClickException(str(e.args[0]))
    kw = {} if dtype is None else {"dtype": dtype}
    if not ckpt_dir:
        return spec.init_params(batch_size=batch_size, seed=seed,
                                device=device, **kw)
    from polyaxon_tpu_torch.checkpoint import CheckpointManager

    try:
        state = CheckpointManager(directory=ckpt_dir).restore()
    except FileNotFoundError as e:
        raise click.ClickException(str(e))
    restored = state.get("params") if isinstance(state, dict) else None
    if restored is None:
        raise click.ClickException(
            f"checkpoint under {ckpt_dir} has no 'params'")
    # Restoring replaces the weights: no random init to discard.
    model = spec.make_model(device=default_device(device), **kw)
    model.load_state_dict(restored, strict=True)   # casts on copy
    return model.eval().requires_grad_(False)


def run_generate(model, model_name: str, rows, *, max_new_tokens: int,
                 eos_id: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, seed: int = 0) -> dict:
    """Decode ``rows`` and return the command's JSON record.  Sampled
    requests on a decoder-only model take the POSITION-KEYED schedule
    (``generate_positional``: token i's key is a function of ``seed``,
    the row and i alone), the contract the server's engine samples
    under, so ``generate --seed N`` and a served request with seed N
    return the same tokens."""
    import torch

    from polyaxon_tpu_torch import prng
    from polyaxon_tpu_torch.models import generate as G

    dev = model.device
    toks = torch.tensor(rows, dtype=torch.long, device=dev)
    t0 = time.perf_counter()
    try:
        if G.positional_eligible(model, temperature):
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
    return {
        "model": model_name,
        "tokens": out.tolist(),
        "new_tokens": out[:, p_len:].tolist(),
        "wall_s": round(dt, 3),
        "tok_per_sec": round(len(rows) * max_new_tokens / dt, 1),
        "backend": dev.type,
    }


# Flags of the reference's `generate` the port refuses when set to
# anything but their default: (option name, default).
_NOT_PORTED = (
    ("--beams", 1), ("--draft-model", None),
    ("--draft-checkpoint", None), ("--spec-k", 4),
    ("--int8-weights", False), ("--int8-kv", False), ("--kv-ring", False),
)


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
@click.option("--beams", default=1, type=int)
@click.option("--eos-id", default=None, type=int)
@click.option("--checkpoint", default=None, type=click.Path(),
              help="Serve the newest checkpoint under DIR (what train "
                   "writes) instead of random-init weights.")
@click.option("--draft-model", "--spec-draft", "draft_model",
              default=None)
@click.option("--draft-checkpoint", default=None, type=click.Path())
@click.option("--spec-k", default=4, type=int)
@click.option("--int8-weights", is_flag=True, default=False)
@click.option("--int8-kv", is_flag=True, default=False)
@click.option("--kv-ring", is_flag=True, default=False)
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
    """Decode with a zoo model (greedy, or sampled with
    --temperature); emits one JSON object: tokens plus timing."""
    values = {"--beams": beams, "--draft-model": draft_model,
              "--draft-checkpoint": draft_checkpoint, "--spec-k": spec_k,
              "--int8-weights": int8_weights, "--int8-kv": int8_kv,
              "--kv-ring": kv_ring}
    refused = [flag for flag, default in _NOT_PORTED
               if values[flag] != default]
    if temperature < 0.0:
        raise click.ClickException(
            f"temperature must be >= 0; got {temperature}")
    if refused:
        raise click.ClickException(
            f"not yet ported to the PyTorch backend: {', '.join(refused)}"
            f" (beam search, speculative decoding, int8 and the ring "
            f"cache come with later slices)")
    rows = _parse_prompt(prompt)
    try:
        model = _build_serving_model(model_name, len(rows), 0,
                                     "cpu" if cpu else None,
                                     ckpt_dir=checkpoint)
    except RuntimeError as e:  # no CUDA device and no --cpu
        raise click.ClickException(str(e))
    click.echo(json.dumps(run_generate(
        model, model_name, rows, max_new_tokens=max_new_tokens,
        eos_id=eos_id, prefill_chunk=prefill_chunk,
        temperature=temperature, top_k=top_k, top_p=top_p, seed=seed)))


# Flags of the reference's `serve` for features that come with later
# slices, refused by name when set: (option, default, ROADMAP item).
_SERVE_NOT_PORTED = (
    ("--kv-host-spill-bytes", 0, "the spill tier and its wire format"),
    ("--draft-model", None, "beam and speculative decoding"),
    ("--spec-k", 4, "beam and speculative decoding"),
)


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
              help="With --kv-paged: the prefix store's host spill "
                   "tier (not ported yet; refused when set).")
@click.option("--draft-model", "--spec-draft", "draft_model",
              default=None,
              help="Draft model for speculative requests (not ported "
                   "yet; refused when set).")
@click.option("--spec-k", default=4, type=int,
              help="Speculative draft width (not ported yet; refused "
                   "when changed).")
@click.option("--cpu", is_flag=True, default=False,
              help="Run on the CPU (default: the CUDA device).")
def serve(model_name, host, port, n_slots, queue_depth, prefill_chunk,
          decode_window, request_timeout, access_log, request_history,
          checkpoint, kv_paged, kv_page_tokens, kv_pages, kv_lazy,
          kv_host_spill_bytes, draft_model, spec_k, cpu):
    """Serve a zoo model over HTTP: greedy and sampled POST /generate
    through the continuous-batching engine (step-boundary admission,
    eos eviction, interleaved chunked prefill, fused decode windows,
    429 once the admission queue fills) over the fixed-lane or
    (--kv-paged) the paged KV pool; /healthz, /info, /metrics, /trace,
    /requests, /debug/state; POST /drain.  Random-init weights from
    seed 0, or --checkpoint DIR."""
    # Flag validation before the model build (fail fast).
    for name, v in (("--n-slots", n_slots), ("--queue-depth", queue_depth),
                    ("--decode-window", decode_window)):
        if v < 1:
            raise click.ClickException(f"{name} must be >= 1")
    if prefill_chunk is not None and prefill_chunk < 1:
        raise click.ClickException("--prefill-chunk must be >= 1")
    if request_timeout <= 0:
        raise click.ClickException("--request-timeout must be > 0")
    if request_history < 0:
        raise click.ClickException("--request-history must be >= 0")
    values = {"--kv-host-spill-bytes": kv_host_spill_bytes,
              "--draft-model": draft_model, "--spec-k": spec_k}
    refused = [f"{flag} (ROADMAP Queue 1: {item})"
               for flag, default, item in _SERVE_NOT_PORTED
               if values[flag] != default]
    if refused:
        raise click.ClickException(
            f"not yet ported to the PyTorch backend: {', '.join(refused)}")
    # Paged-KV flag validation: fail fast, before the model build.
    if kv_page_tokens < 8:
        raise click.ClickException("--kv-page-tokens must be >= 8")
    if kv_pages is not None and kv_pages < 1:
        raise click.ClickException("--kv-pages must be >= 1")
    if kv_lazy and not kv_paged:
        raise click.ClickException(
            "--kv-lazy requires --kv-paged (lazy growth is a page-"
            "reservation policy)")
    from polyaxon_tpu_torch.serving import ModelServer, make_server

    try:
        model = _build_serving_model(model_name, 1, 0,
                                     "cpu" if cpu else None,
                                     ckpt_dir=checkpoint)
    except RuntimeError as e:  # no CUDA device and no --cpu
        raise click.ClickException(str(e))
    ms = ModelServer(model, model_name=model_name, n_slots=n_slots,
                     queue_depth=queue_depth, prefill_chunk=prefill_chunk,
                     decode_window=decode_window,
                     request_timeout_s=request_timeout,
                     access_log=access_log,
                     request_history=request_history,
                     kv_paged=kv_paged, kv_page_tokens=kv_page_tokens,
                     kv_pages=kv_pages, kv_lazy=kv_lazy)
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
