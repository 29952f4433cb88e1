"""The port's ``dot_product_attention`` against the JAX reference's, on
the masks the serving path hands it.  float32 on both sides: atol 1e-5.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu.ops.attention import (
    dot_product_attention as j_attention)
from polyaxon_tpu_torch.ops import attention as tat
from polyaxon_tpu_torch.ops.attention import (
    dot_product_attention as t_attention)

torch.set_num_threads(2)

ATOL = 1e-5


def _inputs(b, sq, sk, h=2, d=16, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, s, h, d).astype(np.float32)
                 for s in (sq, sk, sk))


def _compare(q, k, v, **kw):
    jkw = {key: (jnp.asarray(val) if isinstance(val, np.ndarray) else val)
           for key, val in kw.items()}
    tkw = {key: (torch.from_numpy(val) if isinstance(val, np.ndarray)
                 else val) for key, val in kw.items()}
    want = j_attention(*(jnp.asarray(x) for x in (q, k, v)), **jkw)
    got = t_attention(*(torch.from_numpy(x) for x in (q, k, v)), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("idx,s", [(0, 5), (7, 1), (3, 4)])
def test_decode_mask_matches_reference(idx, s):
    """The [1, 1, S, cap] mask ``append_kv_cache`` returns: key j is
    admissible to new row i iff j <= idx + i."""
    cap = 16
    q, k, v = _inputs(2, s, cap)
    mask = (np.arange(cap)[None, :] <= (idx + np.arange(s))[:, None])
    _compare(q, k, v, mask=mask[None, None])


@pytest.mark.parametrize("window", [1, 3])
def test_windowed_causal_matches_reference(window):
    q, k, v = _inputs(1, 12, 12, seed=1)
    _compare(q, k, v, causal=True, window=window)


def test_bias_matches_reference():
    q, k, v = _inputs(2, 6, 6, seed=2)
    bias = np.random.RandomState(3).randn(1, 2, 6, 6).astype(np.float32)
    _compare(q, k, v, bias=bias, causal=True)


def test_cross_length_causal_matches_reference():
    """Sq < Sk: the causal offset is sk - sq (queries are the last rows)."""
    q, k, v = _inputs(2, 4, 10, seed=4)
    _compare(q, k, v, causal=True)
    _compare(q, k, v, causal=False, scale=0.3)


def test_routes_eligible_shapes_to_flash(monkeypatch):
    calls = []
    real = tat.flash_attention

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(tat, "flash_attention", spy)
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 128, 128, d=64))
    t_attention(q, k, v, causal=True)
    assert len(calls) == 1
    decode = torch.ones(1, 1, 128, 128, dtype=torch.bool)
    t_attention(q, k, v, mask=decode)  # a decode mask takes the plain path
    assert len(calls) == 1


def test_window_validation_messages():
    q = torch.zeros(1, 4, 1, 8)
    with pytest.raises(ValueError, match="requires causal=True"):
        t_attention(q, q, q, window=2)
    with pytest.raises(ValueError, match="window must be >= 1"):
        t_attention(q, q, q, causal=True, window=0)
