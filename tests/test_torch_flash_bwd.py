"""The port's flash backward against the JAX reference.

``jax.grad`` runs through the reference's Pallas backward kernels in
interpret mode on the CPU (blocks of 128, so the window remap and block
skips run); the port's autograd, given CPU tensors, runs
``_flash_backward_reference``, the plain version of its dq / dkv
kernels.  Inputs and cotangents come from numpy with a seed and feed
both.  Tolerance: float32 on both sides, so only summation order differs
— atol 2e-5 on dQ, dK and dV (gradients of magnitude up to ~6).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polyaxon_tpu.ops.flash as jfl
from polyaxon_tpu_torch.ops import flash as tfl

torch.set_num_threads(2)

ATOL = 2e-5


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("POLYAXON_TPU_FLASH_INTERPRET", "1")
    monkeypatch.setattr(jfl, "BLOCK_Q", 128)
    monkeypatch.setattr(jfl, "BLOCK_KV", 128)
    # The port's side runs on the calling thread: torch's CPU exp has been
    # seen to lose precision (1.5e-4 relative) on an intra-op worker thread
    # after XLA:CPU ran in the process (see test_torch_flash.py).
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        torch.set_num_threads(threads)


def _grads(q, k, v, *, causal, window=None, kv_mask=None, lse_ct=False,
           seed=0):
    """(reference grads, port grads) of sum(O * g) [+ sum(LSE * gl) over
    rows that are not fully masked] with respect to q, k, v."""
    rng = np.random.RandomState(seed + 100)
    g = rng.randn(*q.shape).astype(np.float32)
    gl = rng.randn(q.shape[0], q.shape[2], q.shape[1]).astype(np.float32)
    scale = q.shape[-1] ** -0.5

    def jloss(q, k, v):
        o, lse = jfl.flash_attention_lse(
            q, k, v, causal=causal, scale=scale, window=window,
            kv_mask=None if kv_mask is None else jnp.asarray(kv_mask))
        loss = jnp.sum(o * g)
        if lse_ct:
            loss = loss + jnp.sum(jnp.where(lse > tfl.NEG_INF / 2, lse, 0.0)
                                  * gl)
        return loss

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    o, lse = tfl.flash_attention_lse(
        tq, tk, tv, causal=causal, scale=scale, window=window,
        kv_mask=None if kv_mask is None else torch.from_numpy(kv_mask))
    loss = (o * torch.from_numpy(g)).sum()
    if lse_ct:
        loss = loss + (torch.where(lse > tfl.NEG_INF / 2, lse,
                                   torch.zeros_like(lse))
                       * torch.from_numpy(gl)).sum()
    loss.backward()
    return ([np.asarray(w) for w in want],
            [t.grad.numpy() for t in (tq, tk, tv)])


def _inputs(b, sq, sk, h, d, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, s, h, d).astype(np.float32)
                 for s in (sq, sk, sk))


# The forward's cases (tests/test_torch_flash.py).
# name: (B, Sq, Sk, H, D, causal, window)
CASES = {
    "causal": (1, 256, 256, 2, 64, True, None),
    "non_causal": (1, 256, 256, 2, 64, False, None),
    "sk_gt_sq_causal": (1, 128, 384, 2, 64, True, None),
    "window_remap": (1, 512, 512, 1, 64, True, 128),
    "raw_window_non_causal": (1, 256, 256, 1, 64, False, -64),
    "head_dim_128": (1, 128, 128, 2, 128, True, None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_grads_match_reference(name, interpret):
    b, sq, sk, h, d, causal, window = CASES[name]
    want, got = _grads(*_inputs(b, sq, sk, h, d), causal=causal,
                       window=window)
    for w, t in zip(want, got):
        assert t.shape == w.shape
        np.testing.assert_allclose(t, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_grads_with_fully_masked_rows(causal, interpret):
    q, k, v = _inputs(2, 256, 256, 2, 64, seed=1)
    mask = np.random.RandomState(2).rand(2, 256) > 0.3
    mask[1, :] = False  # batch 1: every row fully masked
    mask[0, :128] = False  # causal: rows 0..127 of batch 0 fully masked
    want, got = _grads(q, k, v, causal=causal, kv_mask=mask)
    for w, t in zip(want, got):
        assert np.isfinite(t).all()
        np.testing.assert_allclose(t, w, atol=ATOL, rtol=0)
    dq, dk, dv = got
    assert (dq[1] == 0).all() and (dk[1] == 0).all() and (dv[1] == 0).all()
    assert (dk[~mask] == 0).all() and (dv[~mask] == 0).all()
    if causal:
        assert (dq[0, :128] == 0).all()


def test_flash_lse_cotangent_matches_reference(interpret):
    """flash_attention_lse with both cotangents: dlse folds into delta."""
    want, got = _grads(*_inputs(1, 256, 256, 2, 64, seed=3), causal=True,
                       lse_ct=True)
    for w, t in zip(want, got):
        np.testing.assert_allclose(t, w, atol=ATOL, rtol=0)


def test_flash_lse_cotangent_alone(interpret):
    """Only the LSE is used: dO is zero and the gradient is the dlse
    term alone (dS = P * dlse * scale)."""
    q, k, v = _inputs(1, 128, 128, 1, 64, seed=4)
    gl = np.random.RandomState(5).randn(1, 1, 128).astype(np.float32)
    scale = 0.125
    want = jax.grad(lambda q: jnp.sum(jfl.flash_attention_lse(
        q, jnp.asarray(k), jnp.asarray(v), causal=True,
        scale=scale)[1] * gl))(jnp.asarray(q))
    tq = torch.from_numpy(q).requires_grad_(True)
    _, lse = tfl.flash_attention_lse(tq, torch.from_numpy(k),
                                     torch.from_numpy(v), causal=True,
                                     scale=scale)
    (lse * torch.from_numpy(gl)).sum().backward()
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


def test_plain_parts_compose():
    """The dq and dkv plain versions are the two halves of the plain
    backward, exactly."""
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 128, 256, 2, 64))
    o, lse = tfl._flash_forward_reference(q, k, v, None, True, 0.125)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(0))
    args = (q, k, v, None, o, lse, do, True, 0.125)
    dq, dk, dv = tfl._flash_backward_reference(*args)
    assert torch.equal(dq, tfl._bwd_dq_reference(*args))
    dk2, dv2 = tfl._bwd_dkv_reference(*args)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
