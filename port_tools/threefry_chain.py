"""The JAX mapper's RANSAC key chain in numpy, for machines without JAX.

``tests/test_torch_mapper_rep.py``'s ``JaxKeyChain`` replays the JAX
mapper's draws through ``jax.random``; this module computes the same draws
with numpy alone, so that a run of the port on the card (which has no JAX)
can take JAX's draws too. It reproduces, for the default threefry PRNG with
``jax_threefry_partitionable`` on (the default since JAX 0.5):

  - ``PRNGKey(seed)``: the key (seed >> 32, seed & 0xffffffff);
  - ``split(key, n)``: threefry2x32 of the counters (0, i), i < n, one key
    per (x0, x1) pair;
  - ``uniform`` and ``normal`` (float32; ``normal`` within a few ulp:
    its erfinv is float64 here, XLA's a float32 polynomial), which give
    the noise of the decoder's training step (one ``normal(k, (CS,))`` per
    sample, k from ``split(key, B)``);
  - ``categorical(key, logits, shape=(I, 8))`` with replacement and the
    "low" Gumbel mode: 32 random bits a sample (x0 ^ x1 of the threefry
    of the flat index), a uniform float32 in [tiny, 1) from the top 23
    bits, ``-log(-log(u))`` in float32, plus the logits, argmax over the
    last axis (the first of equal maxima). numpy's float32 ``log`` and
    XLA's differ by an ulp at some inputs, so a draw could differ only
    where two valid matches' noise ties within that ulp.

``KeyChain`` is a drop-in ``Mapper.ransac_draw``: the chain starts at
``PRNGKey(42)`` (the JAX mapper's own, or ``seed``) and splits once per
draw, and a draw splits its key into one key per direction, each drawing
over logits 0 (a valid match) or -1e9 (``Mapper._rep_pair_fn``). It does
not replay the geometric sample points (``geo_draw``): no configuration run
through it uses them. ``tests/test_torch_threefry_chain.py`` holds it against
``jax.random`` on the CPU.
"""
from __future__ import annotations

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = np.finfo(np.float32).tiny


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter pairs (x0, x1) under
    ``key`` (two uint32); returns the two output words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int):
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def split(key, n: int = 2):
    """``jax.random.split(key, n)``: [n, 2] uint32."""
    lo = np.arange(n, dtype=np.uint32)
    b0, b1 = threefry2x32(key, np.zeros_like(lo), lo)
    return np.stack([b0, b1], axis=-1)


def random_bits(key, shape):
    """32 random bits a sample (partitionable threefry)."""
    n = int(np.prod(shape))
    lo = np.arange(n, dtype=np.uint64)
    b0, b1 = threefry2x32(key, (lo >> np.uint64(32)).astype(np.uint32),
                          (lo & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return (b0 ^ b1).reshape(shape)


def gumbel(key, shape):
    """``jax.random.gumbel(key, shape)`` in float32, mode "low"."""
    bits = random_bits(key, shape)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    u = np.maximum(np.float32(_TINY),
                   (f - np.float32(1.0)) * np.float32(1.0 - _TINY)
                   + np.float32(_TINY))
    with np.errstate(divide="ignore"):
        return -np.log(-np.log(u))


def uniform(key, shape, minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top
    23 random bits as a float in [1, 2), minus 1, times (maxval - minval)
    plus minval in one rounding (XLA fuses the two into a multiply-add:
    the float64 product of two float32 is exact), held at ``minval``."""
    bits = random_bits(key, shape)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    lo, hi = np.float32(minval), np.float32(maxval)
    fma = ((f - np.float32(1.0)).astype(np.float64) * np.float64(hi - lo)
           + np.float64(lo))
    return np.maximum(lo, fma.astype(np.float32))


def normal(key, shape):
    """``jax.random.normal(key, shape)`` in float32: a uniform in
    (-1, 1) (``minval`` the float32 just above -1), then sqrt(2) *
    erfinv. erfinv runs in float64 here and XLA's is a float32
    polynomial, so a value may differ from JAX's by a few ulp."""
    from scipy.special import erfinv

    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (np.sqrt(2.0) * erfinv(u.astype(np.float64))).astype(np.float32)


def categorical(key, logits, shape):
    """``jax.random.categorical(key, logits, shape=shape)`` over the last
    axis of the 1-D ``logits``, with replacement."""
    logits = np.asarray(logits, np.float32)
    g = gumbel(key, (*shape, logits.shape[-1]))
    return np.argmax(g + logits, axis=-1)


class KeyChain:
    """A ``Mapper.ransac_draw`` that replays the JAX mapper's draws."""

    def __init__(self, seed: int = 42):
        self.key = prng_key(seed)
        self.calls = 0

    def _next_key(self):
        self.key, k = split(self.key)
        return k

    def __call__(self, valids, iterations):
        self.calls += 1
        k = self._next_key()
        v = np.asarray(valids.cpu() if hasattr(valids, "cpu") else valids)
        ks = split(k, v.shape[0])
        return np.stack([
            categorical(ks[d], np.where(v[d], np.float32(0.0),
                                        np.float32(-1e9)),
                        (iterations, 8)) for d in range(v.shape[0])])
