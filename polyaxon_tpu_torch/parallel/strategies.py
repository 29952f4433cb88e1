"""The train step, on one device.

Port of ``TrainStep`` and ``make_train_step`` of
``polyaxon_tpu/parallel/strategies.py``.  The reference jits a pure
``step(state, batch, rng) -> (state, metrics)`` over a mesh with donated
state; here the state's parameters live in an ``nn.Module`` and its
optimizer state in a ``torch.optim.Optimizer``, both updated in place
(the eager counterpart of donation: no second copy of either).  A mesh
of more than one device, and ``precompile`` (AOT compilation has no
eager counterpart), are not ported: the sharding strategies come with
the parallelism slice of the port.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch


def _check_one_device(mesh) -> None:
    """``mesh``: None, or axis sizes ({"dp": -1}, ...) that name one
    device; anything larger raises."""
    sizes = dict(mesh or {})
    if any(int(v) not in (1, -1) for v in sizes.values()):
        raise NotImplementedError(
            f"mesh {sizes}: the port trains on one device; data, fsdp, "
            f"tensor, pipeline and sequence parallelism come with the "
            f"parallelism slice of the port")


class TrainStep:
    """``loss_fn(batch, rng) -> (loss, aux)`` into
    ``step(state, batch, rng) -> (state, metrics)``; ``state`` is a dict
    {params: the model, opt_state: its optimizer, step: int}.

    ``optimizer`` is a factory ``params -> torch.optim.Optimizer``
    (``train.make_optimizer``), bound to the model by :meth:`init_state`.
    With ``grad_accum`` k the batch splits into k micro-batches along its
    first axis; loss, gradients and aux are averaged over them, as the
    reference's scan does.  Metrics are the loss, ``grad_norm`` (the
    global L2 norm of the gradients before the update, optax's
    ``global_norm``) and the aux, as device scalars."""

    def __init__(self, loss_fn: Callable, optimizer: Callable,
                 mesh: Optional[Dict[str, int]] = None, *,
                 grad_accum: int = 1):
        _check_one_device(mesh)
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1; got {grad_accum}")
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.grad_accum = grad_accum

    def init_state(self, model: torch.nn.Module) -> Dict[str, Any]:
        params = [p for p in model.parameters() if p.requires_grad]
        return {"params": model, "opt_state": self.optimizer(params),
                "step": 0}

    def __call__(self, state: Dict[str, Any], batch, rng=None):
        model, opt = state["params"], state["opt_state"]
        opt.zero_grad(set_to_none=True)
        accum = self.grad_accum
        if accum > 1:
            micro = {k: torch.as_tensor(v).reshape(
                (accum, v.shape[0] // accum) + tuple(v.shape[1:]))
                for k, v in batch.items()}
            loss, aux = 0.0, {}
            for i in range(accum):
                l, a = self.loss_fn({k: v[i] for k, v in micro.items()}, rng)
                (l / accum).backward()
                loss = loss + l.detach() / accum
                for k, v in a.items():
                    aux[k] = aux.get(k, 0.0) + v.detach() / accum
        else:
            loss, aux = self.loss_fn(batch, rng)
            loss.backward()
            loss = loss.detach()
        grads = [p.grad for group in opt.param_groups
                 for p in group["params"] if p.grad is not None]
        grad_norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads]))
        opt.step()
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": grad_norm, **aux}


def make_train_step(loss_fn: Callable, optimizer: Callable,
                    mesh: Optional[Dict[str, int]] = None,
                    **kwargs) -> TrainStep:
    return TrainStep(loss_fn, optimizer, mesh, **kwargs)
