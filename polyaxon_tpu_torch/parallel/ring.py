"""Ring attention: sequence parallelism over the ``sp`` axis.

Port of ``polyaxon_tpu/parallel/ring.py``.  Each rank of the sp group
owns one sequence block of Q/K/V; the K/V blocks rotate around the
group (``collectives.ring_permute``) while each rank accumulates its
local Q's attention with a running log-sum-exp, so no rank holds the
[S, S] scores.

The layout is the reference's: outside attention the activations are
replicated over sp (every sp rank holds the same rows of the batch).
:func:`ring_attention` takes the global q / k / v, gives each rank its
S/sp rows (``split_to_region``), runs the per-shard ring and joins the
output (``gather_from_region``), where the reference's ``shard_map``
does the same with ``P(batch, "sp")``.  Every rank then holds the same
output and, after the backward, the same parameter gradients, so sp
needs no gradient reduction.

The per-shard ring is one autograd node (:class:`_Ring`): its forward
rotates the K/V blocks and records the local attention's graph over
them; its backward takes each block's gradient from that graph and
sends it back around the ring (the reverse permutes, in rotation order).
So every rank issues the same collectives in the same order, also where
a rank skips a block's kernels (a causal ring's future blocks, a
windowed ring's wrapped ones): an autodiff over the permutes themselves
would skip the unused block's reverse permute on that rank alone.
"""

from __future__ import annotations

from typing import Optional

import torch

from .collectives import gather_from_region, ring_permute, split_to_region

BIG_NEG = -1e30


def _ring_flash_eligible(q, s_blk: int, mask) -> bool:
    """Run the per-rotation blocks through the flash kernels?  The
    kernels see s_blk-long q / kv blocks while the key-padding mask keeps
    the FULL kv columns (sliced per rotation), hence ``mask_kv_len``."""
    from ..ops.flash import flash_eligible

    return flash_eligible(s_blk, s_blk, q.shape[-1], mask,
                          mask_kv_len=q.shape[1])


def _block_attend(q, k, v, *, scale, q_offset, kv_offset, causal,
                  mask_blk=None, window=None):
    """One blockwise contribution: q [B, Sq, H, D], k / v [B, Sk, H, D]
    -> the unnormalized (p @ v) [B, Sq, H, D], the row max m and the row
    sum l [B, Sq, H], all f32.  ``mask_blk``: optional boolean
    broadcastable to [B, H, Sq, Sk] (True = attend) covering exactly
    this KV block."""
    scores = torch.einsum("bqhd,bkhd->bqhk", q.float(), k.float()) * scale
    if causal:  # a window implies causal (checked by every entry)
        sq, sk = q.shape[1], k.shape[1]
        q_ids = q_offset + torch.arange(sq, device=q.device)[:, None]
        k_ids = kv_offset + torch.arange(sk, device=q.device)[None, :]
        allowed = q_ids >= k_ids
        if window is not None:
            allowed = allowed & (q_ids - k_ids <= window)
        scores = torch.where(allowed[None, :, None, :], scores, BIG_NEG)
    if mask_blk is not None:
        # [B, H, Sq, Sk] (broadcast dims allowed) -> scores' B, Sq, H, Sk.
        scores = torch.where(mask_blk.to(torch.bool).permute(0, 2, 1, 3),
                             scores, BIG_NEG)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    # Fully masked rows contribute nothing (m stays BIG_NEG, and their
    # p of 1.0 must not enter the sum).
    valid = m > BIG_NEG / 2
    p = torch.where(valid[..., None], p, 0.0)
    l = p.sum(dim=-1)
    pv = torch.einsum("bqhk,bkhd->bqhd", p, v.float())
    return pv, m, l


def _plain_ring(q, blocks, mask, *, my_idx, n, causal, scale, window):
    """The plain ring's accumulation over the rotated blocks (``blocks[r]``
    the stacked K/V that came from rank ``my_idx - r``): running max and
    sum, BIG_NEG guards, fully masked rows -> zeros."""
    s_blk = q.shape[1]
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full(q.shape[:3], BIG_NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)
    for r, kv in enumerate(blocks):
        k_cur, v_cur = kv[0], kv[1]
        src = (my_idx - r) % n
        mask_blk = None
        if mask is not None:
            kv_len = k_cur.shape[1]
            if mask.shape[-1] in (1, kv_len):
                mask_blk = mask  # broadcast kv, or per-block (sp == 1)
            else:
                mask_blk = mask.narrow(3, src * s_blk, kv_len)
        pv, m_blk, l_blk = _block_attend(
            q, k_cur, v_cur, scale=scale, q_offset=my_idx * s_blk,
            kv_offset=src * s_blk, causal=causal, mask_blk=mask_blk,
            window=window)
        new_m = torch.maximum(m, m_blk)
        # exp(BIG_NEG - BIG_NEG) = 1 on never-touched rows: guard with
        # the validity of each side instead.
        corr_old = torch.where(m > BIG_NEG / 2, torch.exp(m - new_m), 0.0)
        corr_new = torch.where(m_blk > BIG_NEG / 2,
                               torch.exp(m_blk - new_m), 0.0)
        o = o * corr_old[..., None] + pv * corr_new[..., None]
        l = l * corr_old + l_blk * corr_new
        m = new_m
    l = torch.where(l == 0.0, 1.0, l)  # fully masked rows -> zeros
    return (o / l[..., None]).to(q.dtype)


def _flash_ring(q, blocks, kv_mask, *, my_idx, n, causal, scale, window):
    """The flash ring's combination: each block through
    ``flash_attention_lse`` and the normalized outputs merged exactly by
    their log-sum-exp, o = sum_r o_r * exp(lse_r - lse).  ``kv_mask``:
    None or the key-padding mask [B, S_full] (sliced per rotation).

    Causal: a past block attends fully, the diagonal block causally, and
    a future block launches no kernel (the causal saving).  ``window``
    (causal only): rotation r's block sits r * s_blk positions behind
    the local q block, so it runs with the raw window ``window - r *
    s_blk`` (possibly <= 0), and ``blocks`` stops after
    ceil(window / s_blk) rotations."""
    from ..ops.flash import flash_attention_lse

    s_blk = q.shape[1]

    def block(kv, src, diag: bool, win=None):
        kvm = None if kv_mask is None else \
            kv_mask.narrow(1, src * s_blk, s_blk)
        o, lse = flash_attention_lse(q, kv[0], kv[1], causal=diag,
                                     scale=scale, kv_mask=kvm, window=win)
        # The kernel's lse is [B, H, Sq]; the ring's rows are [B, Sq, H].
        return o.float(), lse.transpose(1, 2)

    def skipped():
        return (torch.zeros(q.shape, dtype=torch.float32, device=q.device),
                torch.full(q.shape[:3], BIG_NEG, dtype=torch.float32,
                           device=q.device))

    def combine(acc, o_r, lse_r):
        o, lse_acc = acc
        new_lse = torch.logaddexp(lse_acc, lse_r)
        w_old = torch.where(lse_acc > BIG_NEG / 2,
                            torch.exp(lse_acc - new_lse), 0.0)
        w_new = torch.where(lse_r > BIG_NEG / 2,
                            torch.exp(lse_r - new_lse), 0.0)
        o = o * w_old[..., None] + o_r * w_new[..., None]
        return o, torch.where(new_lse > BIG_NEG / 2, new_lse, BIG_NEG)

    if window is not None:
        acc = block(blocks[0], my_idx, diag=True, win=window)
        for r in range(1, len(blocks)):
            # my_idx < r: the source wrapped round to a FUTURE block.
            o_r, lse_r = block(blocks[r], (my_idx - r) % n, diag=False,
                               win=window - r * s_blk) \
                if my_idx >= r else skipped()
            acc = combine(acc, o_r, lse_r)
        return acc[0].to(q.dtype)

    acc = skipped()
    for r, kv in enumerate(blocks):
        src = (my_idx - r) % n
        if not causal or src < my_idx:
            contrib = block(kv, src, diag=False)
        elif src == my_idx:
            contrib = block(kv, src, diag=True)
        else:
            contrib = skipped()
        acc = combine(acc, *contrib)
    return acc[0].to(q.dtype)


def _rotate(kv, rotations: int, axis_name: str, mesh) -> list:
    """[kv, its first rotation, ...]: ``rotations`` hops of the stacked
    K/V block to the next rank of the ring."""
    blocks = [kv]
    for _ in range(rotations):
        blocks.append(ring_permute(blocks[-1], axis_name, mesh=mesh))
    return blocks


class _Source(torch.autograd.Function):
    """``x`` again, as an input of the ring's local graph whose node
    keeps no tensor: holding that graph then holds none of the blocks
    (a detached leaf's gradient accumulator would keep it)."""

    @staticmethod
    def forward(ctx, anchor, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, None


class _Ring(torch.autograd.Function):
    """The per-shard ring as one autograd node (module docstring).

    The local graph's saved tensors go through this node's own
    ``save_for_backward`` (each packed as its index), so a recomputed
    (remat) block drops them with the block's others and its recompute,
    which reruns this forward, restores them in the same order; the node
    itself keeps only the graph's gradient edges."""

    @staticmethod
    def forward(ctx, q, k, v, attend, rotations, axis_name, mesh):
        blocks = _rotate(torch.stack((k, v)), rotations, axis_name, mesh)
        saved, restored = [], []

        def pack(t):
            saved.append(t)
            return len(saved) - 1

        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                pack, restored.__getitem__):
            anchor = torch.zeros((), requires_grad=True)
            ins = [_Source.apply(anchor, t) for t in [q] + blocks]
            o = attend(ins[0], ins[1:])
        ctx.save_for_backward(*saved)
        saved.clear()
        edge = torch.autograd.graph.get_gradient_edge
        ctx.graph = (edge(o), [edge(t) for t in ins], restored)
        ctx.ring = (axis_name, mesh, blocks[0].shape, blocks[0].dtype)
        return o.detach()

    @staticmethod
    def backward(ctx, do):
        o, ins, restored = ctx.graph
        axis_name, mesh, shape, dtype = ctx.ring
        del ctx.graph
        restored.extend(ctx.saved_tensors)
        grads = torch.autograd.grad([o], ins, [do], allow_unused=True)
        restored.clear()
        dblocks = [torch.zeros(shape, dtype=dtype, device=do.device)
                   if g is None else g for g in grads[1:]]
        # Block r came r hops round the ring: its gradient goes back the
        # same way, gathering each earlier rotation's on the way.
        d = dblocks[-1]
        for r in range(len(dblocks) - 1, 0, -1):
            d = ring_permute(d, axis_name, shift=-1, mesh=mesh) \
                + dblocks[r - 1]
        return grads[0], d[0], d[1], None, None, None, None


def _ring_attention_shard(q, k, v, mask, *, mesh, axis_name: str,
                          causal: bool, scale: Optional[float],
                          axis_size: int, use_flash: bool = False,
                          window=None):
    """Per-shard body: q / k / v are this rank's sequence blocks
    [B, S_blk, H, D].

    ``mask``: None; on the plain ring a boolean broadcastable to
    [B, H, S_blk, S_full] whose kv dim is FULL (each rotation slices the
    arriving block's columns); on the flash ring (``use_flash``, decided
    by :func:`ring_attention`) the key-padding mask [B, S_full]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    n = axis_size
    my_idx = mesh.coordinate(axis_name)
    s_blk = q.shape[1]
    if use_flash:
        rotations = n - 1 if window is None else \
            min(n - 1, (window + s_blk - 1) // s_blk)

        def attend(q_, blocks):
            return _flash_ring(q_, blocks, mask, my_idx=my_idx, n=n,
                               causal=causal, scale=scale, window=window)
    else:
        rotations = n - 1

        def attend(q_, blocks):
            return _plain_ring(q_, blocks, mask, my_idx=my_idx, n=n,
                               causal=causal, scale=scale, window=window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Ring.apply(q, k, v, attend, rotations, axis_name, mesh)
    return attend(q, _rotate(torch.stack((k, v)), rotations, axis_name,
                             mesh))


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    *,
    mask: Optional[torch.Tensor] = None,
    axis_name: str = "sp",
    causal: bool = True,
    scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Ring attention over a mesh axis.

    q / k / v: GLOBAL [B, S, H, D], the same on every rank of the axis
    (its batch rows are this rank's over the data axes); S must divide
    by ``mesh.shape[axis_name]``.  ``mask``: optional boolean
    broadcastable to [B, H, S, S] (True = attend); its q dim splits with
    q when full-size, its kv dim stays full and is sliced per rotation.
    Returns the whole output [B, S, H, D] on every rank.

    ``window`` (sliding window >= 1; requires causal): the flash ring
    stops rotating after ceil(window / block) hops, so communication is
    O(W), not O(S)."""
    from ..ops.flash import narrow_kv_mask

    if window is not None:
        if not causal:
            raise ValueError("sliding window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1; got {window}")
    sp = mesh.shape.get(axis_name, 1)
    use_flash = _ring_flash_eligible(q, q.shape[1] // max(sp, 1), mask)
    if mask is not None:
        if mask.ndim != 4:
            raise ValueError(
                f"mask must be 4-d [B,H,Sq,Sk]; got {tuple(mask.shape)}")
        if use_flash:
            # The flash body takes the narrow [B, S] form, kv dim whole
            # on every rank.
            mask = narrow_kv_mask(mask, q.shape[0], k.shape[1])
        elif mask.shape[2] > 1:
            rows = mask.shape[2] // sp
            mask = mask.narrow(2, mesh.coordinate(axis_name) * rows, rows)
    local = [split_to_region(t, axis_name, dim=1, mesh=mesh)
             for t in (q, k, v)]
    o = _ring_attention_shard(*local, mask, mesh=mesh, axis_name=axis_name,
                              causal=causal, scale=scale, axis_size=sp,
                              use_flash=use_flash, window=window)
    return gather_from_region(o, axis_name, dim=1, mesh=mesh)
