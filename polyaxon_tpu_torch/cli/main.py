"""CLI of the port: ``python -m polyaxon_tpu_torch.cli generate``.

Port of ``polyaxon_tpu/cli/main.py``'s ``generate`` command (greedy,
random-init weights).  The flags of the reference that this slice does
not carry yet are kept and refused by name, so a user learns what is
missing rather than getting a different decode.
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
                         device=None):
    """Zoo model with random weights from ``seed`` on ``device``
    (checkpoint restore and int8 serving come with later slices)."""
    from polyaxon_tpu_torch.models.registry import get_model

    try:
        spec = get_model(name)
    except KeyError as e:
        raise click.ClickException(str(e.args[0]))
    return spec.init_params(batch_size=batch_size, seed=seed,
                            device=device)


def run_generate(model, model_name: str, rows, *, max_new_tokens: int,
                 eos_id: Optional[int] = None,
                 prefill_chunk: Optional[int] = None) -> dict:
    """Greedy-decode ``rows`` and return the command's JSON record."""
    import torch

    from polyaxon_tpu_torch.models import generate as G

    dev = model.device
    toks = torch.tensor(rows, dtype=torch.long, device=dev)
    t0 = time.perf_counter()
    try:
        out = G.generate(model, toks, max_new_tokens=max_new_tokens,
                         eos_id=eos_id, prefill_chunk=prefill_chunk)
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


# Flags of the reference's `generate` this slice refuses when set to
# anything but their default: (option name, default).
_NOT_PORTED = (
    ("--top-k", None), ("--top-p", None), ("--beams", 1),
    ("--checkpoint", None), ("--draft-model", None),
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
              help="0 = greedy (the only mode ported so far).")
@click.option("--top-k", default=None, type=int)
@click.option("--top-p", default=None, type=float)
@click.option("--beams", default=1, type=int)
@click.option("--eos-id", default=None, type=int)
@click.option("--checkpoint", default=None, type=click.Path())
@click.option("--draft-model", "--spec-draft", "draft_model",
              default=None)
@click.option("--draft-checkpoint", default=None, type=click.Path())
@click.option("--spec-k", default=4, type=int)
@click.option("--int8-weights", is_flag=True, default=False)
@click.option("--int8-kv", is_flag=True, default=False)
@click.option("--kv-ring", is_flag=True, default=False)
@click.option("--seed", default=0, type=int,
              help="Seed of the random-init weights.")
@click.option("--prefill-chunk", default=None, type=int,
              help="Prefill the prompt in fixed-size pieces to bound "
                   "activation memory (long prompts).")
@click.option("--cpu", is_flag=True, default=False,
              help="Run on the CPU (default: the CUDA device).")
def generate(model_name, prompt, max_new_tokens, temperature, top_k,
             top_p, beams, eos_id, checkpoint, draft_model,
             draft_checkpoint, spec_k, int8_weights, int8_kv, kv_ring,
             seed, prefill_chunk, cpu):
    """Greedy decode with a zoo model; emits one JSON object: tokens
    plus timing."""
    values = {"--top-k": top_k, "--top-p": top_p, "--beams": beams,
              "--checkpoint": checkpoint, "--draft-model": draft_model,
              "--draft-checkpoint": draft_checkpoint, "--spec-k": spec_k,
              "--int8-weights": int8_weights, "--int8-kv": int8_kv,
              "--kv-ring": kv_ring}
    refused = [flag for flag, default in _NOT_PORTED
               if values[flag] != default]
    if temperature < 0.0:
        raise click.ClickException(
            f"temperature must be >= 0; got {temperature}")
    if temperature > 0.0:
        refused.insert(0, "--temperature > 0")
    if refused:
        raise click.ClickException(
            f"not yet ported to the PyTorch backend: {', '.join(refused)}"
            f" (this slice decodes greedily with random-init weights)")
    rows = _parse_prompt(prompt)
    try:
        model = _build_serving_model(model_name, len(rows), seed,
                                     "cpu" if cpu else None)
    except RuntimeError as e:  # no CUDA device and no --cpu
        raise click.ClickException(str(e))
    click.echo(json.dumps(run_generate(
        model, model_name, rows, max_new_tokens=max_new_tokens,
        eos_id=eos_id, prefill_chunk=prefill_chunk)))
