"""The port's RoPE (``ops/rotary.py``) against the reference's.

Inputs from numpy seeds; float32 on both sides.  Tolerance: atol 2e-5
on values of magnitude ~4 (the angle tables agree to an ulp or two of
float32; sin/cos of angles up to ~3000 rad round apart there).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.ops.rotary import apply_rotary as j_apply_rotary
from polyaxon_tpu_torch.ops.rotary import apply_rotary, rotate

torch.set_num_threads(2)

ATOL = 2e-5


def _qk(b, s, h, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, h, d).astype(np.float32),
            rng.randn(b, s, h, d).astype(np.float32))


def _ref(q, k, **kw):
    jq, jk = j_apply_rotary(jnp.asarray(q), jnp.asarray(k), **kw)
    return np.asarray(jq), np.asarray(jk)


@pytest.mark.parametrize("offset", [0, 5, 3000])
@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_offset_positions_match_reference(offset, theta):
    q, k = _qk(2, 7, 3, 16)
    want = _ref(q, k, theta=theta, position_offset=offset)
    got = apply_rotary(torch.from_numpy(q), torch.from_numpy(k),
                       theta=theta, position_offset=offset)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0)


def test_explicit_positions_match_reference():
    q, k = _qk(2, 5, 2, 8, seed=1)
    pos = np.asarray([9, 2, 40, 7, 100])
    want = _ref(q, k, positions=jnp.asarray(pos))
    got = apply_rotary(torch.from_numpy(q), torch.from_numpy(k),
                       positions=torch.from_numpy(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, rtol=0)


def test_per_row_positions_match_reference_row_by_row():
    """[B, S] positions (the slot pool's): row b equals the reference's
    call on row b alone at that row's positions."""
    q, k = _qk(4, 3, 2, 8, seed=2)
    pos = np.asarray([[0, 1, 2], [17, 18, 19], [5, 6, 7], [250, 251, 252]])
    got = apply_rotary(torch.from_numpy(q), torch.from_numpy(k),
                       positions=torch.from_numpy(pos))
    one = rotate(torch.from_numpy(k), torch.from_numpy(pos))
    for b in range(4):
        want = _ref(q[b:b + 1], k[b:b + 1], positions=jnp.asarray(pos[b]))
        np.testing.assert_allclose(got[0][b:b + 1].numpy(), want[0],
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(got[1][b:b + 1].numpy(), want[1],
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(one[b:b + 1].numpy(), want[1],
                                   atol=ATOL, rtol=0)


def test_rotate_equals_apply_rotary():
    q, k = _qk(1, 6, 2, 8, seed=3)
    pos = torch.arange(6) + 11
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    both = apply_rotary(tq, tk, positions=pos)
    assert torch.equal(rotate(tq, pos), both[0])
    assert torch.equal(rotate(tk, pos), both[1])


def test_bf16_in_bf16_out_rotated_in_f32():
    q, k = _qk(1, 4, 2, 8, seed=4)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tk = torch.from_numpy(k).to(torch.bfloat16)
    gq, gk = apply_rotary(tq, tk, position_offset=3)
    assert gq.dtype == gk.dtype == torch.bfloat16
    # The rotation runs on the bf16 values in f32 and rounds once: each
    # output is within half a bf16 ulp (2**-8 relative) of the f32
    # rotation of the same inputs (atol covers the f32 references'
    # own last-bit differences).
    wq, wk = _ref(tq.float().numpy(), tk.float().numpy(),
                  position_offset=3)
    np.testing.assert_allclose(gq.float().numpy(), wq, rtol=2 ** -8,
                               atol=1e-6)
    np.testing.assert_allclose(gk.float().numpy(), wk, rtol=2 ** -8,
                               atol=1e-6)


def test_refusals_match_reference():
    q, k = _qk(1, 4, 2, 7)
    with pytest.raises(ValueError, match="even head dim"):
        apply_rotary(torch.from_numpy(q), torch.from_numpy(k))
    with pytest.raises(ValueError, match="even head dim"):
        rotate(torch.from_numpy(q), torch.arange(4))
    with pytest.raises(ValueError, match="even head dim"):
        j_apply_rotary(jnp.asarray(q), jnp.asarray(k))
    q, _ = _qk(1, 4, 2, 8)
    _, k = _qk(1, 6, 2, 8)
    with pytest.raises(ValueError, match="matching q/k seq lengths"):
        apply_rotary(torch.from_numpy(q), torch.from_numpy(k))
    with pytest.raises(ValueError, match="matching q/k seq lengths"):
        j_apply_rotary(jnp.asarray(q), jnp.asarray(k))
