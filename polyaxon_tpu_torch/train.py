"""Training driver: ``python -m polyaxon_tpu_torch.train --model NAME``.

Port of ``polyaxon_tpu/train.py`` on one device: the same flags, data
stream, resume-at-the-restored-step, checkpoint cadence, preemption save,
``--target-metric`` early exit and ``step i/N k=v ...`` log lines.  It
runs on ``cuda`` unless ``--cpu`` asks for the CPU, and never drops to
the CPU on its own.  Parameters are float32 master weights cast to the
model's compute dtype at their use; the optimizers are torch's AdamW,
Adam and SGD, which compute optax's updates.

Not ported yet, refused with a message naming their slice: meshes of
more than one device (``--strategy``, ``--sp-mode``), ``--init-hf``, the
digits and span-corruption datasets and held-out eval
(``--eval-every``).  Run tracking is not ported either:
the loop prints its metrics.
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
                   help="Mesh axes as JSON or 'dp:1'; the port trains on "
                        "one device.")
    p.add_argument("--sp-mode", default=None, choices=["ring", "ulysses"],
                   help="Sequence-parallel attention (not ported yet).")
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
                   help="Initialize from a HF state_dict (not ported yet).")
    p.add_argument("--data-dir", default=None,
                   help="Directory of inputs.npy/labels.npy (else "
                        "synthetic).")
    p.add_argument("--dataset", default=None,
                   choices=["synthetic", "digits", "npy", "tokens",
                            "span-corruption"],
                   help="Input source (default: npy when --data-dir is "
                        "given, else synthetic); 'tokens' samples LM "
                        "windows from tokens.npy/tokens.bin under "
                        "--data-dir.")
    p.add_argument("--seq-len", type=int, default=None,
                   help="Window length for --dataset tokens (default: "
                        "the model's synthetic batch seq length).")
    p.add_argument("--eval-every", type=int, default=0,
                   help="Steps between held-out evals (not ported yet).")
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


_NOT_PORTED = {
    "digits": "the digits dataset comes with the zoo slice of the port",
    "span-corruption": "the span-corruption dataset comes with the T5 "
                       "(zoo) slice of the port",
}


def make_datasets(args, spec, batch_size: int):
    """(train dataset, eval dataset or None)."""
    from . import data

    kind = args.dataset or ("npy" if args.data_dir else "synthetic")
    if kind in _NOT_PORTED:
        raise SystemExit(f"--dataset {kind}: {_NOT_PORTED[kind]}")
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
    return data.synthetic_dataset(spec, batch_size, seed=args.seed), None


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


def _refuse_unported(args, strategy) -> dict:
    """The mesh axes of ``strategy``, after refusing what is not ported."""
    if args.sp_mode is not None:
        raise SystemExit("--sp-mode: sequence parallelism comes with the "
                         "parallelism slice of the port")
    axes = {k: v for k, v in strategy.items()
            if k not in _STRATEGY_STR_KEYS}
    if any(int(v) not in (1, -1) for v in axes.values()):
        raise SystemExit(f"--strategy {axes}: the port trains on one "
                         f"device; meshes come with the parallelism slice "
                         f"of the port")
    if args.init_hf:
        raise SystemExit("--init-hf: loading HF checkpoints comes with the "
                         "zoo (import_hf) slice of the port")
    if args.eval_every:
        raise SystemExit("--eval-every: held-out eval comes with the zoo "
                         "slice of the port (its digits dataset is the "
                         "one with an eval split)")
    return axes


class _Profiler:
    """``--profile-at``: a torch.profiler window over ``steps`` steps,
    written as a Chrome trace beside the checkpoints."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self.prof = None

    def start(self, device) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()

    def stop(self, step: int) -> None:
        if self.prof is None:
            return
        self.prof.__exit__(None, None, None)
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"trace_step{step}.json")
        self.prof.export_chrome_trace(path)
        print(f"profile trace written to {path}", flush=True)
        self.prof = None


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    strategy = parse_strategy(args.strategy
                              or os.environ.get("PTPU_STRATEGY"))
    mesh = _refuse_unported(args, strategy)

    import torch

    from . import default_device
    from .checkpoint import CheckpointManager
    from .data import prefetch_to_device
    from .models.registry import get_model
    from .parallel import make_train_step

    device = default_device("cpu" if args.cpu else None)
    spec = get_model(args.model)
    batch_size = args.batch_size or spec.default_batch_size
    train_ds, _ = make_datasets(args, spec, batch_size)
    sample = train_ds.sample(2)
    model = spec.init_params(seed=args.seed, device=device, train=True)
    step_fn = make_train_step(spec.loss_fn(model),
                              make_optimizer(args.optimizer, args.lr),
                              mesh, grad_accum=args.grad_accum)
    state = step_fn.init_state(model)
    print(f"train {args.model} on {device} "
          f"({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}): "
          f"batch {batch_size}, {sum(p.numel() for p in model.parameters())}"
          f" params, optimizer {args.optimizer} lr {args.lr}", flush=True)

    # Checkpointing with auto-resume.
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
    batches = train_ds.epochs(None, start_step=start_step)
    if args.prefetch:
        batches = prefetch_to_device(batches, device, depth=args.prefetch)
    target = parse_target_metric(args.target_metric)
    unit = "tok" if sample["inputs"].ndim == 2 else "img"
    per_batch = batch_size * sample["inputs"].shape[1] \
        if unit == "tok" else batch_size
    profiler = _Profiler(os.path.join(os.path.dirname(ckpt.directory),
                                      "profile"))

    t_block = time.perf_counter()
    block_start = start_step
    for step in range(start_step, total_steps):
        if args.profile_at and step == args.profile_at:
            profiler.start(device)
        batch = next(batches)
        state, metrics = step_fn(state, batch)
        if args.profile_at and step + 1 == args.profile_at + \
                args.profile_steps:
            profiler.stop(step + 1)
        if ckpt.preempt_requested:
            # SIGTERM arrived: save the state after this step and exit
            # within the operator's grace period (checkpoint.py).
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
                per_batch * done / dt, 2)
            print(f"step {step + 1}/{total_steps} "
                  + " ".join(f"{k}={v:.4g}" for k, v in metrics.items()),
                  flush=True)
            t_block = time.perf_counter()
            block_start = step + 1
            if target and target[0] in metrics and \
                    target_reached(metrics[target[0]], target):
                print(f"target {target[0]}{target[2]}{target[1]} reached",
                      flush=True)
                break

    # A profile window reaching past the last step still finalizes.
    profiler.stop(state["step"])
    ckpt.save(state["step"], state)
    ckpt.wait()
    ckpt.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
