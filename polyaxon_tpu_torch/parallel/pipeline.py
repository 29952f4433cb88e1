"""Pipeline parallelism: GPipe and 1F1B schedules over the ``pp`` axis.

Port of ``polyaxon_tpu/parallel/pipeline.py``.  The reference runs each
schedule as one ``lax.scan`` over ticks inside ``shard_map``: every
stage computes on every tick (an inactive slot masked) and activations
move one stage right by ``ppermute``.  Here each pp rank is a process
that runs its own stage eagerly.  Tick by tick it runs the slots that
are active for it, then moves activations right and cotangents left in
ONE ``all_to_all_single`` over the pp group (:meth:`_Stages.exchange`),
which gloo and NCCL both take for a card's tensors.  Every rank issues
that collective on every tick on which any stage of the group sends,
also where its own slots are idle, so the ranks stay in step; a slot
the reference masks is skipped here (its compute, never its exchange).

- :func:`pipeline_apply`: a homogeneous stage stack; stage 0 injects
  micro t, the last stage's outputs are broadcast over pp.
- :func:`pipelined_lm_loss` (GPipe): every forward tick keeps its
  stage's graph (what autodiff through the reference's scan keeps), the
  last stage runs the head and the loss of each micro, and the backward
  runs the ticks in reverse.
- :func:`pipelined_lm_loss_1f1b`: one forward and one backward slot a
  tick; the backward slot re-runs the stage forward from a stash ring of
  ``min(2S - 1, m)`` stage inputs.  The node's forward runs the whole
  forward and backward program and its backward scales the result by
  the incoming gradient (the reference's ``custom_vjp``).

Each schedule is one autograd node.  The stage's and the head's
backward run as nested ``torch.autograd.backward`` calls, which
accumulate into the parameters' ``.grad`` as any backward does (FSDP2's
hooks included), and the embedding's gradient flows through the node's
input: the micro activations' cotangent, on stage 0 only.  So each pp
rank holds its share of a parameter replicated over pp (stage 0 the
embedding's, the last stage the head's, GPT-2's tied table both) and
the train step sums the shares over pp (``strategies.TrainStep``); a
block's gradient lives on the stage that owns the block.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
from torch.utils import _pytree as pytree


class _Stages:
    """This rank's place in a pipeline over ``axis_name``: ``n`` stages,
    this one ``s``, and the axis's process group (one stage and no
    group without a mesh or with the axis at 1)."""

    def __init__(self, mesh, axis_name: str = "pp"):
        self.n = mesh.shape.get(axis_name, 1) if mesh is not None else 1
        self.s = mesh.coordinate(axis_name) if self.n > 1 else 0
        self.group = mesh.group(axis_name) if self.n > 1 else None
        self.first, self.last = self.s == 0, self.s == self.n - 1

    def exchange(self, t: int, plan: Callable, like: torch.Tensor,
                 act=None, grad=None):
        """Tick ``t``'s collective: ``act`` to the next stage, ``grad``
        to the previous one.  ``plan(t, j)`` -> (whether stage j sends an
        activation, whether it sends a cotangent) at tick t, the same on
        every rank; the last stage sends no activation and stage 0 no
        cotangent.  Returns (the activation from the previous stage, the
        cotangent from the next one), each None where none comes; no
        collective at all on a tick where no stage sends."""
        import torch.distributed as dist

        n, s = self.n, self.s
        links = [(a and j < n - 1, g and j > 0)
                 for j, (a, g) in enumerate(plan(t, j) for j in range(n))]
        if not any(a or g for a, g in links):
            return None, None
        size = like.numel()
        out = {}
        if links[s][0]:
            out[s + 1] = act
        if links[s][1]:
            out[s - 1] = grad
        recv_act = s > 0 and links[s - 1][0]
        recv_grad = s < n - 1 and links[s + 1][1]
        in_sizes = [size if j in out else 0 for j in range(n)]
        out_sizes = [size if (recv_act and j == s - 1) or
                     (recv_grad and j == s + 1) else 0 for j in range(n)]
        send = torch.cat([out[j].reshape(-1).to(like.dtype)
                          for j in sorted(out)]) if out else \
            like.new_empty(0)
        got = like.new_empty(sum(out_sizes))
        dist.all_to_all_single(got, send, out_sizes, in_sizes,
                               group=self.group)
        parts = got.split(out_sizes)
        return (parts[s - 1].view_as(like) if recv_act else None,
                parts[s + 1].view_as(like) if recv_grad else None)

    def forward_ticks(self, x_micro, stage, keep: bool = True) -> list:
        """GPipe's forward: ``m + n - 1`` ticks, tick t running micro
        ``t - s`` through ``stage`` (stage 0 injects it, the others take
        what the previous stage sent).  Returns (stage input, output) of
        each micro, the input a leaf and the output's graph kept when
        ``keep``."""
        m = x_micro.shape[0]
        act, graphs = None, [None] * m

        def plan(t, j):
            return 0 <= t - j < m, False

        for t in range(m + self.n - 1):
            i, y = t - self.s, None
            if 0 <= i < m:
                x_in = x_micro[i] if self.first else act
                with torch.set_grad_enabled(keep):
                    x_in = x_in.detach().requires_grad_(keep)
                    y = stage(x_in)
                graphs[i] = (x_in, y)
            act, _ = self.exchange(t, plan, x_micro[0], act=y)
        return graphs

    def backward_ticks(self, graphs, roots: Callable) -> list:
        """GPipe's backward: the forward ticks in reverse, tick t taking
        micro ``t - s`` back through its kept graph, from ``roots(i)``
        (a (tensor, cotangent) pair) on the last stage and from the
        cotangent the next stage sent elsewhere.  Returns each micro's
        input cotangent."""
        m = len(graphs)
        like, grad, dx = graphs[0][0], None, [None] * m

        def plan(t, j):
            return False, 0 <= t - j < m

        for t in reversed(range(m + self.n - 1)):
            i, d = t - self.s, None
            if 0 <= i < m:
                x_in, y = graphs[i]
                root, g = roots(i) if self.last else (y, grad)
                torch.autograd.backward([root], [g])
                d = dx[i] = x_in.grad
            _, grad = self.exchange(t, plan, like, grad=d)
        return dx

    def one_f_one_b(self, x_micro, stage, head_loss, seed):
        """The 1F1B program (the reference's ``schedule``): ``m +
        2(n - 1)`` ticks, tick t running the forward slot of micro
        ``t - s`` (its input stashed) and the backward slot of micro
        ``t - 2(n - 1) + s``, which re-runs the stage from the stashed
        input and backpropagates the next stage's cotangent (on the last
        stage, d(head) of the micro it just forwarded, the head's
        backward seeded with ``seed``).  Returns (the sum of the last
        stage's micro losses, each micro's input cotangent on stage 0)."""
        m, n, s = x_micro.shape[0], self.n, self.s
        depth = min(2 * n - 1, m)
        stash: List[Optional[torch.Tensor]] = [None] * depth
        act = grad = dy_head = None
        loss = torch.zeros((), dtype=torch.float32, device=x_micro.device)
        dx: List[Optional[torch.Tensor]] = [None] * m

        def plan(t, j):
            return 0 <= t - j < m, 0 <= t - 2 * (n - 1) + j < m

        for t in range(m + 2 * (n - 1)):
            i_f, y = t - s, None
            if 0 <= i_f < m:
                x_in = x_micro[i_f] if self.first else act
                stash[i_f % depth] = x_in
                with torch.no_grad():
                    y = stage(x_in)
                if self.last:
                    with torch.enable_grad():
                        y_in = y.detach().requires_grad_(True)
                        loss_i = head_loss(y_in, i_f)
                    torch.autograd.backward([loss_i], [seed])
                    loss = loss + loss_i.detach()
                    dy_head = y_in.grad
            i_b, d = t - 2 * (n - 1) + s, None
            if 0 <= i_b < m:
                with torch.enable_grad():
                    x_in = stash[i_b % depth].detach().requires_grad_(True)
                    out = stage(x_in)
                torch.autograd.backward([out], [dy_head if self.last
                                                else grad])
                d = x_in.grad
                if self.first:
                    dx[i_b] = d
            act, grad = self.exchange(t, plan, x_micro[0], act=y, grad=d)
        return loss, dx

    def all_reduce(self, x):
        """``x`` summed over the pipeline (itself with one stage)."""
        import torch.distributed as dist

        if self.n > 1:
            dist.all_reduce(x, group=self.group)
        return x


def _micro(x, m: int):
    return x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))


class _Apply(torch.autograd.Function):
    """:func:`pipeline_apply` as one node: the forward ticks with their
    graphs, the last stage's outputs broadcast (its rows summed over pp,
    zeros elsewhere); the backward ticks from the last stage's own
    output cotangent (every pp rank computes the same of the broadcast
    output), the input's cotangent on stage 0, the stage parameters'."""

    @staticmethod
    def forward(ctx, anchor, x, run, *local):
        stages, stage_fn, spec, m, keep = run
        leaves = [p.detach().requires_grad_(keep and p.requires_grad)
                  for p in local]
        params = pytree.tree_unflatten(leaves, spec)
        graphs = stages.forward_ticks(
            _micro(x, m), lambda h: stage_fn(stages.s, params, h), keep)
        out = torch.stack([y.detach() for _, y in graphs]) \
            if stages.last else torch.zeros_like(_micro(x, m))
        out = stages.all_reduce(out)
        ctx.run = (stages, m)
        ctx.save_for_backward(*[t for g in graphs for t in g], *leaves)
        return out.reshape((x.shape[0],) + tuple(out.shape[2:]))

    @staticmethod
    def backward(ctx, dout):
        stages, m = ctx.run
        saved = ctx.saved_tensors
        graphs = [saved[2 * i:2 * i + 2] for i in range(m)]
        leaves = saved[2 * m:]
        dout = _micro(dout, m)
        dx = stages.backward_ticks(graphs, lambda i: (graphs[i][1],
                                                      dout[i]))
        dx = torch.cat(dx) if stages.first else None
        return (None, dx, None, *[p.grad for p in leaves])


def pipeline_apply(stage_fn: Callable[[int, Any, torch.Tensor],
                                      torch.Tensor],
                   params_stacked: Any, x: torch.Tensor, mesh, *,
                   axis_name: str = "pp", n_micro: int = 4,
                   batch_axes=("dp", "fsdp")) -> torch.Tensor:
    """Run a homogeneous pipeline.

    ``stage_fn(stage_index, stage_params, x) -> y`` (y shaped as x);
    ``params_stacked``: a pytree whose leaves have a leading [n_stages]
    axis (stage i's slice is the one pp rank i uses).  ``x``: this
    rank's rows of the batch over ``batch_axes`` (the train step's
    ``batch_sharding``), the same on every pp rank; its rows must split
    into ``n_micro`` microbatches.  Returns y, the last stage's result,
    on every pp rank.  Differentiable for a caller that computes the
    same of y on every pp rank: x's cotangent comes out on stage 0
    (None elsewhere) and each stage's slice of the parameters gets its
    gradient on its own rank (a stacked parameter's gradient sums over
    pp)."""
    del batch_axes      # x is already this rank's rows
    stages = _Stages(mesh, axis_name)
    batch = x.shape[0]
    if batch % n_micro:
        raise ValueError(f"Batch {batch} must divide into {n_micro} "
                         f"microbatches")
    leaves, spec = pytree.tree_flatten(params_stacked)
    local = [p[stages.s] for p in leaves]
    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in [x] + local)
    anchor = torch.zeros((), requires_grad=keep)
    return _Apply.apply(anchor, x, (stages, stage_fn, spec, n_micro, keep),
                        *local)


class _GPipeLoss(torch.autograd.Function):
    """GPipe's loss as one node: the forward ticks with their graphs and
    the last stage's head and loss on each micro (summed over pp: the
    mean of the micros' losses on every pp rank); the backward seeds each
    micro's loss with g / m and runs the ticks in reverse."""

    @staticmethod
    def forward(ctx, anchor, x, run):
        stages, stage, head_loss, m = run
        graphs = stages.forward_ticks(_micro(x, m), stage)
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        losses = []
        if stages.last:
            with torch.enable_grad():
                losses = [head_loss(y, i) for i, (_, y) in enumerate(graphs)]
            loss = loss + sum(l.detach() for l in losses)
        ctx.run = (stages, m, len(losses))
        ctx.save_for_backward(*[t for g in graphs for t in g], *losses)
        return stages.all_reduce(loss / m)

    @staticmethod
    def backward(ctx, g):
        stages, m, _ = ctx.run
        saved = ctx.saved_tensors
        graphs = [saved[2 * i:2 * i + 2] for i in range(m)]
        losses = saved[2 * m:]
        dx = stages.backward_ticks(graphs, lambda i: (losses[i], g / m))
        return None, torch.cat(dx) if stages.first else None, None


class _OneFOneBLoss(torch.autograd.Function):
    """1F1B's loss as one node (the reference's ``custom_vjp`` ``sched``):
    the forward runs the whole program with this rank's parameter
    gradients set aside, keeps the gradients it produced (the stage's
    blocks and, on the last stage, the head's) and the micro input
    cotangents; the backward adds them scaled by the incoming gradient."""

    @staticmethod
    def forward(ctx, anchor, x, run):
        from .strategies import local_block

        stages, stage, head_loss, m, params = run
        held = [p.grad for p in params]
        for p in params:
            p.grad = None
        try:
            # d(mean micro loss)/d(loss_i): the micros' mean over this
            # rank's rows; the train step averages over the data ranks.
            seed = torch.full((), 1.0 / m, dtype=torch.float32,
                              device=x.device)
            loss, dx = stages.one_f_one_b(_micro(x, m), stage, head_loss,
                                          seed)
            grads = [p.grad for p in params]
        finally:
            for p, h in zip(params, held):
                p.grad = h
        ctx.grads = [(p, local_block(d), d) for p, d in zip(params, grads)
                     if d is not None]
        ctx.save_for_backward(*(dx if stages.first else []))
        ctx.first = stages.first
        return stages.all_reduce(loss / m)

    @staticmethod
    def backward(ctx, g):
        from .strategies import local_block

        for p, block, d in ctx.grads:
            block.mul_(g)
            if p.grad is None:
                p.grad = d
            else:
                local_block(p.grad).add_(block)
        del ctx.grads
        dx = torch.cat(ctx.saved_tensors) * g if ctx.first else None
        return None, dx, None


def stage_blocks(model, mesh, axis_name: str = "pp") -> list:
    """The blocks of ``model.h`` that this pp rank's stage runs: block i
    lives on pp rank ``i // (num_layers / pp)``."""
    stages = _Stages(mesh, axis_name)
    per = len(model.h) // stages.n
    return [model.h[i] for i in range(stages.s * per, (stages.s + 1) * per)]


def _pipelined_loss(model, mesh, n_micro: int, schedule: str):
    from ..models.layers import run_stack
    from ..models.registry import softmax_xent
    from .collectives import data_all_reduce_mean

    cfg = model.cfg
    stages = _Stages(mesh)
    if cfg.num_layers % stages.n:
        raise ValueError(f"pp={stages.n} must divide "
                         f"num_layers={cfg.num_layers}")
    micro = n_micro or 2 * stages.n

    def stage(h):
        # Each layer recomputed in its backward under cfg.remat (a
        # forward under no_grad runs plain).
        return run_stack(stage_blocks(model, mesh), cfg, h)

    def loss(batch, rng=None):
        tokens = torch.as_tensor(batch["inputs"], device=model.device)
        b = tokens.shape[0]
        if b % micro:
            raise ValueError(f"batch {b} must divide into {micro} "
                             f"microbatches")
        x = model.embed_tokens(tokens).to(cfg.dtype)
        targets = _micro(tokens, micro)

        def head_loss(y, i):
            logits = model.head(y)
            return softmax_xent(logits[:, :-1], targets[i][:, 1:])

        anchor = torch.zeros((), device=x.device, requires_grad=True)
        if schedule == "gpipe":
            l = _GPipeLoss.apply(anchor, x, (stages, stage, head_loss,
                                             micro))
        else:
            params = [p for p in model.parameters() if p.requires_grad]
            l = _OneFOneBLoss.apply(anchor, x, (stages, stage, head_loss,
                                                micro, params))
        return l, {"perplexity": torch.exp(data_all_reduce_mean(
            l.detach()))}

    return loss


def pipelined_lm_loss(model, mesh, *, n_micro: int = 0) -> Callable:
    """GPipe train-step loss of a decoder with ``embed_tokens`` /
    ``h`` / ``head`` (GPT-2, the Llama family): ``loss(batch, rng) ->
    (loss, {"perplexity"})``, the next-token cross-entropy of this
    rank's rows.  The embedding runs on every pp rank, this rank's
    blocks (:func:`stage_blocks`) through the forward ticks, the head on
    the last stage; ``n_micro`` microbatches (default ``2 * pp``)."""
    return _pipelined_loss(model, mesh, n_micro, "gpipe")


def pipelined_lm_loss_1f1b(model, mesh, *, n_micro: int = 0) -> Callable:
    """The same loss on the 1F1B schedule: activation memory a stage is
    the stash ring of ``min(2 pp - 1, n_micro)`` micro inputs, whatever
    ``n_micro``.  A train-only loss: its forward runs the backward too."""
    return _pipelined_loss(model, mesh, n_micro, "1f1b")
