"""Training driver: ``python -m polyaxon_tpu_torch.train --model NAME``.

Port of ``polyaxon_tpu/train.py``: the same flags, data stream,
resume-at-the-restored-step, checkpoint cadence, preemption save,
``--target-metric`` early exit and ``step i/N k=v ...`` log lines.  It
runs on ``cuda`` unless ``--cpu`` asks for the CPU, and never drops to
the CPU on its own.

A gang (the ``tpujob`` / ``pytorchjob`` / ``mpijob`` / ``tfjob`` kinds
through ``ptpu-torch run -f``, or processes started by hand with the
PTPU_* block) trains as one process does over the same global batch:
the bootstrap starts the process group (NCCL on the cards, one card a
process; gloo with ``--cpu``), the slice-health gate proves it before
the checkpoint is touched, and ``--strategy`` / ``PTPU_STRATEGY`` lays
the ``dp``, ``fsdp``, ``tp`` and ``ep`` axes over the ranks
(``parallel/strategies.py``).  Every rank builds the same global batch
and keeps its rows: the tp and ep ranks of one data group keep the same
rows.  The chief
(process 0) tracks the run; every rank joins each checkpoint save, and
the chief writes one full state.

Parameters are float32 master weights cast to the model's compute dtype
at their use; the optimizers are torch's AdamW, Adam and SGD, which
compute optax's updates.

The run is tracked as the reference tracks it (``tracking``): it
attaches to the managed run the env names (``ptpu-torch run -f``) or
registers one, logs its inputs, the metrics of every logged step and the
final ``loss``/``perplexity``/``accuracy``/``eval_accuracy`` outputs a
sweep joins on, and ends the run ``succeeded``.  ``--profile-at``
captures a torch.profiler Chrome trace beside the checkpoints (the run's
outputs in a managed run).

Each step gets its key of the reference's chain (``prng.split`` of
``PRNGKey(seed)``), which the MLM loss draws its mask from.  The digits
dataset carries a held-out split: ``--eval-every`` (snapped up to the
next log step) and the end of the run report ``eval_accuracy``, the
model in eval mode (batch norms on their running averages).
``--init-hf`` starts from a HuggingFace ``state_dict`` file through
``models/import_hf.py`` (BERT, GPT-2, the Llama family, ViT and T5).
``--dataset span-corruption`` trains a seq2seq model (T5) on T5's
span-corruption objective over ``--data-dir``'s token stream.

A strategy with sp above 1 routes every model's attention through ring
or Ulysses attention over the sp group (``--sp-mode``, the reference's
default ``ring``) for the whole run: ``sequence_parallel`` is activated
before the step is built, and ``main`` deactivates it on the way out,
so an in-process caller never inherits the route.

The axes compose as the reference's do: fsdp beside tp or ep shards
each parameter on both axes, and sp runs beside fsdp or ep.  A pp axis
above 1 trains the scanned GPT-2 and Llama families through the
pipeline (``parallel/pipeline.py``): ``pp_schedule`` 1f1b (the default)
or gpipe, beside dp, fsdp and tp, the global batch rounded to a
multiple of ``data axes * 2 * pp``; beside sp or ep it is refused with
the reference's own message, before any weight is built.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="polyaxon_tpu_torch.train")
    p.add_argument("--model", default="gpt2-tiny")
    p.add_argument("--steps", type=int, default=None,
                   help="Total optimizer steps (overrides epochs).")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--steps-per-epoch", type=int, default=None,
                   help="Default: the dataset's epoch length; synthetic "
                        "data keeps the historical 100-step epoch.")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--optimizer", default="adamw",
                   choices=["adamw", "sgd", "adam"])
    p.add_argument("--strategy", default=None,
                   help="Mesh axes as JSON or 'dp:-1,tp:2' (the dp, "
                        "fsdp, tp, pp, ep and sp axes, and pp_schedule "
                        "1f1b or gpipe; default: dp over every "
                        "process).")
    p.add_argument("--sp-mode", default="ring",
                   choices=["ring", "ulysses"],
                   help="Sequence-parallel attention flavor when the "
                        "strategy has sp > 1.")
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="Steps between checkpoints (0 = only at end).")
    p.add_argument("--resume", action="store_true", default=True)
    p.add_argument("--no-resume", dest="resume", action="store_false")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--profile-at", type=int, default=0,
                   help="Capture a torch.profiler trace starting at this "
                        "step (0 = off).")
    p.add_argument("--profile-steps", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init-hf", default=None, metavar="STATE_DICT",
                   help="Initialize params from a torch state_dict "
                        "file (HF checkpoint) instead of random init: "
                        "the fine-tuning path, through the family's "
                        "models/import_hf loader; dims must match "
                        "--model.")
    p.add_argument("--data-dir", default=None,
                   help="Directory of inputs.npy/labels.npy (else "
                        "synthetic).")
    p.add_argument("--dataset", default=None,
                   choices=["synthetic", "digits", "npy", "tokens",
                            "span-corruption"],
                   help="Input source (default: npy when --data-dir is "
                        "given, else synthetic).  'digits' is the real "
                        "offline 10-class image set with a held-out "
                        "split; 'tokens' samples LM windows from "
                        "tokens.npy/tokens.bin under --data-dir.")
    p.add_argument("--seq-len", type=int, default=None,
                   help="Window length for --dataset tokens (default: "
                        "the model's synthetic batch seq length).")
    p.add_argument("--eval-every", type=int, default=0,
                   help="Steps between held-out evals (0 = end only; "
                        "needs a dataset with an eval split).")
    p.add_argument("--prefetch", type=int, default=2,
                   help="Device-prefetch depth (0 disables).")
    p.add_argument("--cpu", action="store_true",
                   help="Run on the CPU instead of the CUDA card.")
    p.add_argument("--target-metric", default=None,
                   help="name>=value or name<=value (plain name=value "
                        "infers direction: loss/error/perplexity-like "
                        "names minimize, everything else maximizes); "
                        "exit once the metric reaches value.")
    return p


_MINIMIZE_HINTS = ("loss", "error", "err", "perplexity", "ppl", "nll",
                   "mse", "mae", "rmse")


def parse_target_metric(spec):
    """``name>=value`` / ``name<=value`` / ``name=value`` -> (name, value,
    op).  A plain ``=`` infers direction from the metric name: a
    minimizing target like ``loss=0.1`` must NOT be satisfied by the
    (large) initial loss."""
    if not spec or "=" not in spec:
        return None
    if ">=" in spec:
        name, _, val = spec.partition(">=")
        op = ">="
    elif "<=" in spec:
        name, _, val = spec.partition("<=")
        op = "<="
    else:
        name, _, val = spec.partition("=")
        lowered = name.strip().lower()
        op = "<=" if any(h in lowered for h in _MINIMIZE_HINTS) else ">="
    return (name.strip(), float(val), op)


def target_reached(value, target) -> bool:
    _, threshold, op = target
    return value <= threshold if op == "<=" else value >= threshold


def make_optimizer(name: str, lr: float):
    """A factory ``params -> torch.optim.Optimizer`` computing optax's
    update: ``adamw(lr, weight_decay=0.01)``, ``adam(lr)``,
    ``sgd(lr, momentum=0.9)`` (betas 0.9/0.999 and eps 1e-8 are both
    libraries' defaults)."""
    import torch

    if name == "sgd":
        return lambda params: torch.optim.SGD(params, lr=lr, momentum=0.9)
    if name == "adam":
        return lambda params: torch.optim.Adam(params, lr=lr)
    return lambda params: torch.optim.AdamW(params, lr=lr,
                                            weight_decay=0.01)


def load_hf_init(model_name: str, model, path: str) -> None:
    """Fine-tuning init: a torch ``state_dict`` file (an HF checkpoint)
    mapped onto ``model`` by the family's ``models.import_hf`` loader.
    The checkpoint's dims must match the zoo config: a mismatch raises
    naming the tensor."""
    import torch

    from .convert import load_state_dict
    from .models import import_hf

    loader_name = _HF_LOADER_BY_FAMILY.get(model_name.split("-")[0])
    if loader_name is None:
        raise SystemExit(
            f"--init-hf supports the {sorted(_HF_LOADER_BY_FAMILY)} "
            f"families, not {model_name!r}")
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    load_state_dict(model, getattr(import_hf, loader_name)(state_dict,
                                                           model.cfg))


_HF_LOADER_BY_FAMILY = {
    "bert": "load_hf_bert",
    "gpt2": "load_hf_gpt2",
    "llama": "load_hf_llama",
    "tinyllama": "load_hf_llama",
    "mistral": "load_hf_llama",  # same block layout
    "vit": "load_hf_vit",
    "t5": "load_hf_t5",
}

# Config overrides a family needs for HF-parity fine-tuning, applied to
# the model when --init-hf is set.  bert/vit: HF uses the exact (erf)
# GELU; the zoo default is tanh.
_HF_MODEL_KW = {
    "bert": {"gelu_approximate": False},
    "vit": {"gelu_approximate": False},
}


def make_datasets(args, spec, batch_size: int):
    """(train dataset, eval dataset or None)."""
    from . import data

    kind = args.dataset or ("npy" if args.data_dir else "synthetic")
    if kind == "span-corruption":
        # T5-style denoising pretraining over a token stream.
        if not args.data_dir:
            raise SystemExit("--dataset span-corruption requires "
                             "--data-dir")
        # The config and seq2seq-ness, from a model with no storage.
        model = spec.make_model(device="meta")
        if not hasattr(model, "encode"):
            raise SystemExit(
                f"--dataset span-corruption requires a seq2seq "
                f"(encoder-decoder) model; {args.model!r} is not "
                f"(use a t5-* model)")
        cfg = model.cfg
        seq_len = args.seq_len or \
            spec.make_batch(1)["inputs"].shape[-1]
        stream = data.token_dataset(args.data_dir, batch_size, seq_len,
                                    seed=args.seed)
        return data.SpanCorruptionDataset(
            stream.tokens, batch_size, inputs_length=seq_len,
            targets_length=max(32, seq_len // 4),
            vocab_size=cfg.vocab_size, pad_id=cfg.pad_id,
            seed=args.seed), None
    if kind == "npy":
        if not args.data_dir:
            raise SystemExit("--dataset npy requires --data-dir")
        return data.npy_dataset(args.data_dir, batch_size,
                                seed=args.seed), None
    if kind == "tokens":
        if not args.data_dir:
            raise SystemExit("--dataset tokens requires --data-dir")
        seq_len = args.seq_len or \
            spec.make_batch(1)["inputs"].shape[-1]
        return data.token_dataset(args.data_dir, batch_size, seq_len,
                                  seed=args.seed), None
    if kind == "digits":
        return (data.digits_dataset(batch_size, split="train",
                                    seed=args.seed),
                data.digits_dataset(batch_size, split="eval",
                                    seed=args.seed))
    return data.synthetic_dataset(spec, batch_size, seed=args.seed), None


def make_eval_fn(model, mesh=None):
    """``evaluate(dataset)``: held-out accuracy of ``model`` (the state's
    ``params``) over every batch of ``dataset``'s epoch 0, the remainder
    batch counted exactly.  It runs in eval mode (batch norms on their
    running averages) with no gradients, then puts the model back in
    train mode.

    Over a data-parallel ``mesh`` each rank scores its rows of every
    batch: the final partial batch is padded up to the data-axes
    divisor and the padding masked out of the count, as the reference
    does, and the counts are all-reduced, so every rank returns the
    one-process accuracy."""
    import numpy as np
    import torch

    from .parallel.collectives import data_all_reduce
    from .parallel.mesh import DataSharding, data_sharding

    device = model.device
    sharding = data_sharding(mesh) if mesh is not None else \
        DataSharding(device)

    def evaluate(dataset) -> float:
        correct = torch.zeros((), dtype=torch.int64, device=device)
        total = 0
        model.eval()
        try:
            with torch.no_grad():
                for batch in dataset.epoch(0):
                    n = len(batch["labels"])
                    pad = (-n) % sharding.count
                    if pad:
                        batch = {k: np.concatenate(
                            [v, np.repeat(v[-1:], pad, axis=0)])
                            for k, v in batch.items()}
                    valid = np.arange(n + pad) < n
                    x, y, valid = (torch.as_tensor(sharding.shard(a),
                                                   device=device)
                                   for a in (batch["inputs"],
                                             batch["labels"], valid))
                    correct += ((model(x).argmax(-1) == y) & valid).sum()
                    total += n
        finally:
            model.train()
        if mesh is not None:
            correct = data_all_reduce(correct, mesh)
        return int(correct) / max(total, 1)

    return evaluate


# --strategy keys whose values are selectors, not mesh-axis sizes.
_STRATEGY_STR_KEYS = ("pp_schedule",)


def parse_strategy(raw):
    """``--strategy`` accepts JSON or ``axis:size[,axis:size...]``.

    Values parse as ints except the selector keys (e.g.
    ``pp:2,pp_schedule:gpipe``), which stay strings."""
    if not raw:
        return {}
    try:
        parsed = json.loads(raw)
    except ValueError:
        pass
    else:
        if not isinstance(parsed, dict):
            raise SystemExit(
                f"--strategy: expected an object of axis sizes, got "
                f"{raw!r}; use JSON ('{{\"dp\": 2, \"ep\": 4}}') or "
                '"dp:2,ep:4"')
        return parsed
    out = {}
    for part in raw.split(","):
        part = part.strip()
        sep = ":" if ":" in part else ("=" if "=" in part else None)
        if not sep:
            raise SystemExit(
                f"--strategy: cannot parse {raw!r}; use JSON "
                '(\'{"dp": 2, "ep": 4}\') or "dp:2,ep:4"')
        name, _, value = part.partition(sep)
        name = name.strip()
        if name in _STRATEGY_STR_KEYS:
            out[name] = value.strip()
            continue
        try:
            out[name] = int(value)
        except ValueError:
            raise SystemExit(
                f"--strategy: axis size {value!r} is not an integer "
                f"in {raw!r}") from None
    return out


def _refuse_unported(strategy) -> dict:
    """The mesh axes of ``strategy``, after refusing a pp axis above 1
    beside sp or ep with the reference's message
    (``strategies.pipeline_refusal``)."""
    from .parallel.strategies import pipeline_refusal

    axes = {k: v for k, v in strategy.items()
            if k not in _STRATEGY_STR_KEYS}
    refusal = pipeline_refusal({k: int(v) for k, v in axes.items()})
    if refusal is not None:
        raise SystemExit(f"--strategy {axes}: {refusal}")
    return axes


def _pipeline_loss(args, strategy, spec, mesh):
    """The pipelined loss factory a pp axis above 1 trains through
    (``pp_schedule``: 1f1b, the default, or gpipe), else None; the
    reference's refusals of another schedule and of a model outside the
    scanned GPT-2 and Llama families, before any weight is built."""
    if mesh.shape["pp"] <= 1:
        return None
    from .models.gpt2 import GPT2Model
    from .models.llama import LlamaModel
    from .parallel.pipeline import (pipelined_lm_loss,
                                    pipelined_lm_loss_1f1b)

    model = spec.make_model(device="meta")
    if not (isinstance(model, (GPT2Model, LlamaModel)) and
            model.cfg.scan_layers):
        raise SystemExit("strategy pp>1 supports the scanned GPT-2 and "
                         f"Llama families, not {args.model}")
    schedule = str(strategy.get("pp_schedule", "1f1b")).lower()
    if schedule not in ("1f1b", "gpipe"):
        raise SystemExit(f"pp_schedule must be '1f1b' or 'gpipe', got "
                         f"{schedule!r}")
    return pipelined_lm_loss if schedule == "gpipe" \
        else pipelined_lm_loss_1f1b


_OUTPUT_KEYS = ("accuracy", "loss", "perplexity", "eval_accuracy")


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    strategy = parse_strategy(args.strategy
                              or os.environ.get("PTPU_STRATEGY"))
    axes = _refuse_unported(strategy)

    from . import default_device
    from .parallel import bootstrap

    device = default_device("cpu" if args.cpu else None)
    # 1. multi-process bootstrap from the injected topology env (a no-op
    #    for one process): this rank's card, or gloo on the CPU.
    topology = bootstrap.initialize_from_env(device=device)
    try:
        return _main(args, strategy, axes, device, topology)
    finally:
        from .ops.attention import deactivate_sequence_parallel

        deactivate_sequence_parallel()
        if topology is not None and topology.is_distributed:
            bootstrap.shutdown()


def _main(args, strategy, axes, device, topology) -> int:
    import torch

    from . import prng, tracking
    from .checkpoint import CheckpointManager
    from .data import prefetch_to_device
    from .models.registry import get_model
    from .parallel import MeshSpec, build_mesh, make_train_step

    # 1b. slice health gate: prove the gang computes and communicates
    #     BEFORE restoring checkpoints.  Unhealthy -> exit nonzero so the
    #     operator reschedules the gang.
    if topology is not None and topology.is_distributed:
        from .parallel.health import check_slice_health

        health = check_slice_health(
            timeout_s=float(os.environ.get(
                "PTPU_SLICE_HEALTH_TIMEOUT", "120")))
        print(f"slice health: {health.detail}", flush=True)
        if not health.ok:
            raise SystemExit(f"unhealthy slice: {health.detail}")

    # 2. the mesh from the strategy spec, over the gang (or this device).
    mesh = build_mesh(MeshSpec.from_dict(axes), device=device)
    device = mesh.device
    n_chips = int(mesh.devices.size)

    # sp > 1: every model's attention routes through ring / Ulysses
    # attention for the whole run, activated before the step is built.
    from .ops.attention import activate_sequence_parallel

    if mesh.shape["sp"] > 1:
        activate_sequence_parallel(mesh, args.sp_mode)

    try:
        spec = get_model(args.model)
    except KeyError as e:
        raise SystemExit(e.args[0]) from None
    if mesh.shape["tp"] > 1 or mesh.shape["ep"] > 1:
        # Heads and experts against tp / ep, before any weight is built.
        from .parallel.strategies import check_model_axes

        check_model_axes(spec.make_model(device="meta").cfg, mesh)
    pipelined = _pipeline_loss(args, strategy, spec, mesh)
    batch_size = args.batch_size or spec.default_batch_size
    # The global batch shards over the data axes, and a pipelined run's
    # into 2 * pp microbatches of as many rows on each data rank: round
    # it down to a multiple of their product, as the reference does.
    data_axes = max(1, mesh.shape["dp"] * mesh.shape["fsdp"])
    granularity = data_axes * 2 * mesh.shape["pp"] if pipelined \
        else data_axes
    if batch_size % granularity:
        batch_size = granularity * max(1, batch_size // granularity)
    train_ds, eval_ds = make_datasets(args, spec, batch_size)
    sample = train_ds.sample(2)
    # Data defines the input shapes (digits are 8x8x1 where the
    # classifiers' synthetic batches are larger), and --init-hf the
    # GELU form.
    model_kw = spec.input_overrides(sample["inputs"]) \
        if spec.input_overrides else {}
    if args.init_hf:
        model_kw.update(_HF_MODEL_KW.get(args.model.split("-")[0], {}))
        # The checkpoint replaces every parameter: no random init.
        model = spec.make_model(device=device, param_dtype=torch.float32,
                                **model_kw).train()
        load_hf_init(args.model, model, args.init_hf)
    else:
        model = spec.init_params(seed=args.seed, device=device,
                                 train=True, **model_kw)
    # Counted before a tp / ep mesh keeps each rank's shards.
    n_params = sum(p.numel() for p in model.parameters())
    loss_fn = pipelined(model, mesh) if pipelined else spec.loss_fn(model)
    step_fn = make_train_step(loss_fn,
                              make_optimizer(args.optimizer, args.lr),
                              mesh, grad_accum=args.grad_accum)
    state = step_fn.init_state(model)
    print(f"train {args.model} on {device} "
          f"({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}): "
          f"batch {batch_size}, {n_params}"
          f" params, optimizer {args.optimizer} lr {args.lr}", flush=True)

    # 3. tracking: attaches to the managed run (env) or registers one
    #    (the chief's, shared by an unmanaged gang).
    run = tracking.init(name=f"train-{args.model}")
    run.log_inputs(model=args.model, lr=args.lr, batch_size=batch_size,
                   strategy=strategy or {"dp": -1}, n_chips=n_chips,
                   backend=device.type)

    # 4. checkpointing with auto-resume, under the run's outputs when
    #    the env names a run; a gang saves collectively.
    ckpt = CheckpointManager()
    start_step = 0
    if args.resume:
        state, restored = ckpt.restore_or_init(state)
        start_step = int(restored or 0)
        if restored is not None:
            print(f"resuming from checkpoint step {start_step}",
                  flush=True)
    ckpt.install_preemption_hook()

    synthetic = (args.dataset or
                 ("npy" if args.data_dir else "synthetic")) == "synthetic"
    steps_per_epoch = args.steps_per_epoch or \
        (100 if synthetic else train_ds.steps_per_epoch)
    total_steps = args.steps or args.epochs * steps_per_epoch
    # Endless reshuffled-per-epoch stream, RESUMED at the restored step:
    # the datasets are deterministic in (seed, epoch), so a resumed run
    # continues through the schedule where the stopped run left off.
    # Every rank draws the same global batches and keeps its rows.
    batches = train_ds.epochs(None, start_step=start_step)
    if args.prefetch:
        batches = prefetch_to_device(batches, step_fn.batch_sharding,
                                     depth=args.prefetch)
    else:
        batches = ({k: torch.as_tensor(step_fn.batch_sharding.shard(v),
                                       device=device)
                    for k, v in b.items()} for b in batches)
    # The reference's key chain: each step splits off its key.
    rng = prng.PRNGKey(args.seed, device=device)
    target = parse_target_metric(args.target_metric)
    evaluate = make_eval_fn(model, mesh) if eval_ds is not None else None
    # Evals ride the logging steps (metrics are only published there);
    # snap --eval-every up to the next log step so no eval is lost to
    # the log cadence.
    eval_steps = set()
    if evaluate and args.eval_every:
        for due in range(args.eval_every, total_steps + 1,
                         args.eval_every):
            snapped = -(-due // args.log_every) * args.log_every
            eval_steps.add(min(snapped, total_steps))
    unit = "tok" if sample["inputs"].ndim == 2 else "img"
    per_batch = batch_size * sample["inputs"].shape[1] \
        if unit == "tok" else batch_size
    profile_dir = os.path.join(os.path.dirname(ckpt.directory), "profile")

    last_metrics = {}
    t_block = time.perf_counter()
    block_start = start_step
    for step in range(start_step, total_steps):
        if args.profile_at and step == args.profile_at:
            run.start_profiler_trace(profile_dir)
        rng, step_rng = prng.split(rng)
        batch = next(batches)
        state, metrics = step_fn(state, batch, step_rng)
        if args.profile_at and step + 1 == args.profile_at + \
                args.profile_steps:
            _stop_profile(run, step + 1)
        if ckpt.preemption_agreed():
            # SIGTERM arrived (at any rank of a gang): save the state
            # after this step and exit within the operator's grace
            # period (checkpoint.py).
            ckpt.save(step + 1, state)
            ckpt.wait()
            print("preempted: checkpoint flushed, exiting", flush=True)
            break
        if args.checkpoint_every and (step + 1) % args.checkpoint_every == 0:
            ckpt.save(step + 1, state)  # written off the step path
        if (step + 1) % args.log_every == 0 or step + 1 == total_steps:
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t_block
            done = step + 1 - block_start
            metrics[f"{unit}_per_sec_per_chip"] = round(
                per_batch * done / dt / n_chips, 2)
            if (step + 1) in eval_steps:
                metrics["eval_accuracy"] = evaluate(eval_ds)
            run.log_metrics(step=step + 1, **metrics)
            print(f"step {step + 1}/{total_steps} "
                  + " ".join(f"{k}={v:.4g}" for k, v in metrics.items()),
                  flush=True)
            last_metrics = metrics
            t_block = time.perf_counter()
            block_start = step + 1
            if target and target[0] in metrics and \
                    target_reached(metrics[target[0]], target):
                print(f"target {target[0]}{target[2]}{target[1]} reached",
                      flush=True)
                break

    # A profile window reaching past the last step still finalizes.
    _stop_profile(run, state["step"])
    ckpt.save(state["step"], state)
    ckpt.wait()
    ckpt.close()
    if evaluate:
        final_eval = evaluate(eval_ds)
        run.log_metrics(step=state["step"], eval_accuracy=final_eval)
        last_metrics["eval_accuracy"] = final_eval
        print(f"final eval_accuracy={final_eval:.4f}", flush=True)
    run.log_outputs(**{k: v for k, v in last_metrics.items()
                       if k in _OUTPUT_KEYS})
    run.end("succeeded")
    return 0


def _stop_profile(run, step: int) -> None:
    path = run.stop_profiler_trace(step=step)
    if path:
        print(f"profile trace written to {path}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
