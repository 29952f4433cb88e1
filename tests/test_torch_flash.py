"""The port's flash forward against the JAX reference.

The reference's Pallas kernel runs in interpret mode on the CPU (as
tests/test_ops.py runs it); the port, given CPU tensors, runs its plain
version.  Inputs come from numpy with a seed and feed both.  Tolerance:
float32 on both sides, so only summation order differs — atol 2e-5 on O
and on LSE.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polyaxon_tpu.ops.flash as jfl
from polyaxon_tpu_torch.ops import flash as tfl

torch.set_num_threads(2)

ATOL = 2e-5


def _inputs(b, sq, sk, h, d, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, s, h, d).astype(np.float32)
                 for s in (sq, sk, sk))


def _both(q, k, v, *, causal, window=None, kv_mask=None):
    scale = q.shape[-1] ** -0.5
    jo, jl = jfl.flash_attention_lse(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal, scale=scale,
        window=window,
        kv_mask=None if kv_mask is None else jnp.asarray(kv_mask))
    to, tl = tfl.flash_attention_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        scale=scale, window=window,
        kv_mask=None if kv_mask is None else torch.from_numpy(kv_mask))
    return (np.asarray(jo), np.asarray(jl)), (to.numpy(), tl.numpy())


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("POLYAXON_TPU_FLASH_INTERPRET", "1")
    # Small blocks so the reference's window remap and block skips run.
    monkeypatch.setattr(jfl, "BLOCK_Q", 128)
    monkeypatch.setattr(jfl, "BLOCK_KV", 128)
    # The comparison is of full-float32 numerics: ask the reference for
    # full-precision dots explicitly, not for DEFAULT precision.
    with jax.default_matmul_precision("highest"), _calling_thread_only():
        yield


@contextlib.contextmanager
def _calling_thread_only():
    """Run the port's plain version on the calling thread.  On a loaded
    host, torch's CPU exp has been seen to lose precision on an intra-op
    worker thread in a process that had just run XLA:CPU (about one run
    in ten with six processes at once): a relative error of 1.5e-4 on
    that thread's half of the scores, so O and LSE off by up to 6e-5
    against an atol of 2e-5.  The calling thread never was."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


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
def test_flash_lse_matches_reference(name, interpret):
    b, sq, sk, h, d, causal, window = CASES[name]
    q, k, v = _inputs(b, sq, sk, h, d)
    (jo, jl), (to, tl) = _both(q, k, v, causal=causal, window=window)
    assert to.shape == jo.shape and tl.shape == jl.shape == (b, h, sq)
    np.testing.assert_allclose(to, jo, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_kv_mask_with_fully_masked_row(causal, interpret):
    q, k, v = _inputs(2, 256, 256, 2, 64, seed=1)
    mask = np.random.RandomState(2).rand(2, 256) > 0.3
    mask[1, :] = False  # batch 1: every row fully masked
    mask[0, :128] = False  # causal: rows 0..127 of batch 0 fully masked
    (jo, jl), (to, tl) = _both(q, k, v, causal=causal, kv_mask=mask)
    np.testing.assert_allclose(to, jo, atol=ATOL, rtol=0)
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)
    assert (to[1] == 0).all() and (tl[1] == tfl.NEG_INF).all()
    if causal:
        assert (tl[0, :, :128] == tfl.NEG_INF).all()


def test_flash_attention_matches_reference(interpret):
    q, k, v = _inputs(1, 256, 256, 2, 64, seed=3)
    scale = 0.125
    jo = jfl.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                             causal=True, scale=scale, window=100)
    to = tfl.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             causal=True, scale=scale, window=100)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL,
                               rtol=0)


def _mask4(b, kv):
    return np.ones((b, 1, 1, kv), bool)


# (Sq, Sk, head_dim, mask, mask_kv_len)
ELIGIBILITY = [
    (128, 128, 64, None, None),
    (256, 384, 128, None, None),
    (64, 128, 64, None, None),
    (128, 200, 64, None, None),
    (128, 128, 32, None, None),
    (128, 128, 96, None, None),
    (128, 128, 64, "pad", None),
    (128, 256, 64, "pad", None),
    (128, 128, 64, "decode", None),
    (128, 128, 64, "heads", None),
    (128, 128, 64, "ring", 512),
]


def _eligibility_mask(kind, sk, mask_kv_len):
    if kind is None:
        return None
    kv = mask_kv_len or sk
    return {"pad": np.ones((2, 1, 1, kv), bool),
            "decode": np.ones((1, 1, 128, kv), bool),
            "heads": np.ones((2, 4, 1, kv), bool),
            "ring": np.ones((2, 1, 1, kv), bool)}[kind]


@pytest.mark.parametrize("case", range(len(ELIGIBILITY)))
def test_flash_eligible_matches_reference(case, monkeypatch):
    monkeypatch.setenv("POLYAXON_TPU_FLASH_INTERPRET", "1")
    sq, sk, d, kind, kv_len = ELIGIBILITY[case]
    m = _eligibility_mask(kind, sk, kv_len)
    want = jfl.flash_eligible(sq, sk, d, None if m is None else
                              jnp.asarray(m), mask_kv_len=kv_len)
    got = tfl.flash_eligible(sq, sk, d, None if m is None else
                             torch.from_numpy(m), mask_kv_len=kv_len)
    assert got == want


def test_flash_argument_checks():
    q = torch.zeros(1, 128, 1, 64)
    with pytest.raises(ValueError, match="causal=True"):
        tfl.flash_attention(q, q, q, window=4)
    with pytest.raises(ValueError, match="window must be >= 1"):
        tfl.flash_attention(q, q, q, causal=True, window=0)
    r = torch.zeros(1, 64, 1, 64)
    with pytest.raises(ValueError, match="divisible by 128"):
        tfl.flash_attention(r, r, r)


def test_flash_refuses_grad_and_cpu_never_counts_launches():
    """Gradients are no longer refused: on CPU tensors they flow through
    the plain backward, and no kernel counter moves (the counters count
    kernel launches only)."""
    before = (tfl.launch_count, tfl.dq_launch_count, tfl.dkv_launch_count)
    q = torch.randn(1, 128, 1, 64, requires_grad=True)
    tfl.flash_attention(q, q, q, causal=True).sum().backward()
    assert q.grad.shape == q.shape and bool(torch.isfinite(q.grad).all())
    with torch.no_grad():
        tfl.flash_attention(q, q, q, causal=True)
    assert (tfl.launch_count, tfl.dq_launch_count,
            tfl.dkv_launch_count) == before  # CPU tensors: plain path
