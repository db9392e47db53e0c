"""port_tools/threefry_chain.py, the JAX mapper's RANSAC key chain in numpy
(for runs of the port where JAX is not installed), against jax.random and
against tests/test_torch_mapper_rep.py's JaxKeyChain on the CPU: keys and
splits bit for bit, Gumbel noise within an ulp of float32's log, and the
draws index for index."""
import os
import sys

import jax
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "port_tools"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import threefry_chain as tc  # noqa: E402
from test_torch_mapper_rep import JaxKeyChain  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("seed", [0, 2, 42])
def test_keys_and_splits_bit_for_bit(seed):
    k = jax.random.PRNGKey(seed)
    assert np.array_equal(np.asarray(k), tc.prng_key(seed))
    for n in (2, 3, 8):
        assert np.array_equal(np.asarray(jax.random.split(k, n)),
                              tc.split(tc.prng_key(seed), n))


def test_gumbel_within_an_ulp():
    k = jax.random.PRNGKey(42)
    shape = (16, 8, 37)
    want = np.asarray(jax.random.gumbel(k, shape))
    got = tc.gumbel(tc.prng_key(42), shape)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, want, rtol=4e-7, atol=4e-7)


@pytest.mark.parametrize("case", range(6))
def test_draws_equal_jax_key_chain(case):
    """A chain of draws of the mapper's shapes: 2-8 directions, 20-600
    matches with a share valid, 128 hypotheses of 8."""
    rng = np.random.default_rng(case)
    a, b = JaxKeyChain(), tc.KeyChain()
    for _ in range(3):
        n, m = 2 * int(rng.integers(1, 5)), int(rng.integers(20, 600))
        valid = rng.random((n, m)) < rng.uniform(0.05, 0.9)
        valid[:, 0] = True
        v = torch.from_numpy(valid)
        x, y = a(v, 128), b(v, 128)
        assert y.shape == (n, 128, 8)
        np.testing.assert_array_equal(x, y)
        assert valid[np.arange(n)[:, None, None], y].all()
    assert a.calls == b.calls == 3


@pytest.mark.parametrize("seed", [0, 5, 12])
def test_uniform_bit_for_bit(seed):
    for k, t in zip(jax.random.split(jax.random.PRNGKey(seed), 8),
                    tc.split(tc.prng_key(seed), 8)):
        for lo, hi in ((0.0, 1.0), (-0.3, 0.7), (0.6, 1.7)):
            want = np.asarray(jax.random.uniform(k, (7, 32), minval=lo,
                                                 maxval=hi))
            np.testing.assert_array_equal(tc.uniform(t, (7, 32), lo, hi),
                                          want)


@pytest.mark.parametrize("seed", [0, 5, 12])
def test_normal_within_ulps(seed):
    """The training step's noise: one normal(k, (CS,)) per sample, k from
    split(key, B). erfinv is float64 here and a float32 polynomial in XLA:
    over 20 keys x 8 samples x 32 they differ by <= 9.6e-7 (4 ulp) where
    |x| < 3 and by <= 2.7e-6 of |x| in the tails (|x| up to 3.9); the
    limits are 1e-6 and 4e-6."""
    want = np.stack([np.asarray(jax.random.normal(k, (32,))) for k in
                     jax.random.split(jax.random.PRNGKey(seed), 8)])
    got = np.stack([tc.normal(k, (32,))
                    for k in tc.split(tc.prng_key(seed), 8)])
    assert got.dtype == np.float32 and got.shape == (8, 32)
    core = np.abs(want) < 3.0
    assert np.abs(got - want)[core].max() <= 1e-6
    assert (np.abs(got - want) <= 4e-6 * np.abs(want) + 1e-6).all()
