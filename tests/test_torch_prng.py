"""The port's threefry random numbers (``polyaxon_tpu_torch/prng.py``)
against ``jax.random`` on the same seeds.

Keys, ``fold_in``, ``split`` and the random bits are held BITWISE, so
are uniforms on [0, 1) in every float type.  Uniforms scaled into
another range are held to 1 ulp (XLA may fuse the scale and shift into
one rounding).  Gumbel noise goes through two ``log`` calls, which
differ by an ulp between libms, so it is held to 4 ulps of float32
(relative 4.8e-7) and categorical draws to equality.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyaxon_tpu_torch import prng as P

torch.set_num_threads(2)

SEEDS = [0, 1, 7, 123456, 2 ** 31 - 1, -1]
SHAPES = [(1,), (5,), (3, 7), (2, 3, 4), (1000,), (4, 4097)]


def _np(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_fold_in_and_split_are_bitwise(seed):
    jk, tk = jax.random.PRNGKey(seed), P.PRNGKey(seed)
    assert np.array_equal(_np(jk), tk.numpy())
    for d in (0, 1, 5, 31, 12345678, 2 ** 32 - 1):
        assert np.array_equal(_np(jax.random.fold_in(jk, d)),
                              P.fold_in(tk, d).numpy()), d
    for n in (2, 3, 8):
        assert np.array_equal(_np(jax.random.split(jk, n)),
                              P.split(tk, n).numpy()), n
    # Chained: split of a split, fold_in of a fold_in.
    a = jax.random.split(jax.random.split(jk)[1])[0]
    b = P.split(P.split(tk)[1])[0]
    assert np.array_equal(_np(a), b.numpy())
    a = jax.random.fold_in(jax.random.fold_in(jk, 3), 9)
    assert np.array_equal(_np(a), P.fold_in(P.fold_in(tk, 3), 9).numpy())


def test_batched_fold_in_equals_vmap():
    jk, tk = jax.random.PRNGKey(11), P.PRNGKey(11)
    want = jax.vmap(lambda r: jax.random.fold_in(jk, r))(jnp.arange(6))
    got = P.fold_in(tk.expand(6, 2), torch.arange(6))
    assert np.array_equal(_np(want), got.numpy())
    keys = jax.random.split(jk, 4)
    want = jax.vmap(jax.random.fold_in)(keys, jnp.asarray([0, 5, 9, 2]))
    got = P.fold_in(torch.from_numpy(_np(keys)),
                    torch.tensor([0, 5, 9, 2]))
    assert np.array_equal(_np(want), got.numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_random_bits_are_bitwise(seed, shape):
    want = jax.random.bits(jax.random.PRNGKey(seed), shape)
    got = P.random_bits(P.PRNGKey(seed), shape)
    assert got.shape == tuple(shape)
    assert np.array_equal(_np(want), got.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("shape", SHAPES[:5], ids=str)
def test_uniform_is_bitwise(shape, dtype):
    for seed in (0, 7):
        want = jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                  getattr(jnp, dtype))
        got = P.uniform(P.PRNGKey(seed), shape, getattr(torch, dtype))
        assert got.dtype == getattr(torch, dtype)
        assert np.array_equal(np.asarray(want.astype(jnp.float32)),
                              got.float().numpy())


def test_uniform_in_a_range_within_one_ulp():
    for seed in (0, 3):
        want = np.asarray(jax.random.uniform(
            jax.random.PRNGKey(seed), (4096,), minval=0.25, maxval=3.0))
        got = P.uniform(P.PRNGKey(seed), (4096,), minval=0.25,
                        maxval=3.0).numpy()
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert np.all(np.abs(got - want) <= ulp)
        assert got.min() >= 0.25 and got.max() < 3.0


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gumbel_within_four_ulps(shape):
    for seed in (0, 5, 2 ** 31 - 1):
        want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed),
                                            shape))
        got = P.gumbel(P.PRNGKey(seed), shape).numpy()
        ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
        assert np.all(np.abs(got - want) <= 4 * ulp)


@pytest.mark.parametrize("vocab", [32, 257, 4096])
def test_categorical_equals_jax(vocab):
    rng = np.random.RandomState(vocab)
    for seed in (0, 1, 9):
        logits = (rng.randn(6, vocab) * 2).astype(np.float32)
        jk, tk = jax.random.PRNGKey(seed), P.PRNGKey(seed)
        # One key over the whole [B, V] (jax's own batching).
        want = jax.random.categorical(jk, jnp.asarray(logits))
        got = P.categorical(tk, torch.from_numpy(logits))
        assert got.tolist() == np.asarray(want).tolist()
        # A batch of keys, one per row (jax.vmap over rows).
        keys = jax.vmap(lambda r: jax.random.fold_in(jk, r))(
            jnp.arange(6))
        want = jax.vmap(jax.random.categorical)(keys, jnp.asarray(logits))
        got = P.categorical(torch.from_numpy(_np(keys)),
                            torch.from_numpy(logits))
        assert got.tolist() == np.asarray(want).tolist()


def test_categorical_refuses_mismatched_key_batch():
    with pytest.raises(ValueError, match="batch of keys"):
        P.categorical(torch.zeros((3, 2), dtype=torch.int64),
                      torch.zeros((4, 10)))
