"""JAX's counter-based PRNG written out in numpy: the Threefry-2x32 hash,
``PRNGKey``, ``fold_in``, ``split``, float32 ``uniform``, int32 ``randint``
and ``gumbel`` / ``categorical`` of ``jax.random``, in the scheme JAX 0.9
uses by default (``jax_threefry_partitionable``: element i of a draw hashes
the 64-bit counter i, split into a high and a low 32-bit word, and keeps the
two output words' xor). Keys, bits, uniforms and integers are bit for bit
JAX's; the Gumbel noise takes its logarithms in float64, rounded to float32
(XLA's float32 ``log`` on the CPU is within a unit in the last place).

The rearrangement env's reach task draws its per-episode goal from
``fold_in(PRNGKey(4321), episode)``; ``reach_goal_offsets`` gives those
draws for a table of episodes, on the host, once. The deployable
``PPOAgent`` splits its key at every act and samples with ``categorical``;
``NnSkill`` samples from ``PRNGKey(0)``.

Keys are (..., 2) uint32 arrays; every function is vectorised over the
leading axes.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter words (x1, x2)
    under the key (k1, k2); uint32 arrays that broadcast together."""
    k1, k2, x1, x2 = (np.asarray(v, np.uint32) for v in (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    with np.errstate(over="ignore"):
        x = [x1 + ks[0], x2 + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` without 64-bit mode: the seed as an
    int32, so the key is (0, seed mod 2**32)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def fold_in(key, data) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for (2,) or (..., 2) keys and
    integer data (broadcast): the hash of the counter (0, data)."""
    key = np.asarray(key, np.uint32)
    data = np.asarray(data).astype(np.uint32)
    h1, h2 = threefry2x32(key[..., 0], key[..., 1], np.zeros_like(data), data)
    return np.stack([h1, h2], axis=-1)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` for (..., 2) keys -> (..., num, 2):
    key i is the hash of the counter (0, i), i.e. ``fold_in(key, i)``."""
    key = np.asarray(key, np.uint32)
    return fold_in(key[..., None, :], np.arange(num))


def random_bits(key, n: int) -> np.ndarray:
    """32-bit draws of shape (..., n) from (..., 2) keys (the partitionable
    scheme: counter i as the words (i >> 32, i & 0xFFFFFFFF))."""
    key = np.asarray(key, np.uint32)
    i = np.arange(n, dtype=np.uint64)
    hi, lo = (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None], hi, lo)
    return b1 ^ b2


def _shaped_bits(key, shape) -> np.ndarray:
    """``random_bits`` of a shape: (..., *shape), counters in row-major order."""
    key = np.asarray(key, np.uint32)
    shape = tuple(int(d) for d in shape)
    return random_bits(key, int(np.prod(shape, dtype=np.int64))).reshape(key.shape[:-1] + shape)


def uniform(key, n: int, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` for
    (..., 2) keys -> (..., n) float32: the top 23 bits as the mantissa of a
    float in [1, 2), less 1, times (maxval - minval) plus minval, floored at
    ``minval``. XLA on the CPU fuses that multiply-add into one rounding;
    here the product is exact in float64 and the sum rounds once to float32
    (twice where the exact sum needs more than 53 bits, i.e. |minval| some
    2**29 times the product, which no caller's range comes near)."""
    bits = random_bits(key, n)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    fused = f.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)
    return np.maximum(lo, fused.astype(np.float32))


def randint(key, shape, minval, maxval) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) for
    (..., 2) keys -> (..., *shape): two 32-bit draws from ``split(key)``
    combined modulo the span, in uint32 arithmetic that wraps as XLA's
    does; ``maxval <= minval`` gives ``minval``."""
    key = np.asarray(key, np.uint32)
    shape = tuple(int(d) for d in shape)
    i32 = np.iinfo(np.int32)
    lo64 = np.broadcast_to(np.asarray(minval, np.int64), shape)
    hi64 = np.broadcast_to(np.asarray(maxval, np.int64), shape)
    out_of_range = hi64 > i32.max
    lo = np.clip(lo64, i32.min, i32.max).astype(np.int32)
    hi = np.clip(hi64, i32.min, i32.max).astype(np.int32)
    keys = split(key)
    higher, lower = _shaped_bits(keys[..., 0, :], shape), _shaped_bits(keys[..., 1, :], shape)
    with np.errstate(over="ignore"):
        span = (hi.astype(np.int64) - lo.astype(np.int64)).astype(np.uint32)
        span = np.where(hi <= lo, np.uint32(1), span)
        span = np.where(out_of_range & (hi > lo), span + np.uint32(1), span).astype(np.uint32)
        mult = np.uint32(2 ** 16) % span
        mult = (mult * mult) % span
        offset = ((higher % span) * mult + (lower % span)) % span
        return (lo.astype(np.uint32) + offset).astype(np.uint32).view(np.int32)


TINY = float(np.finfo(np.float32).tiny)


def gumbel(key, shape) -> np.ndarray:
    """``jax.random.gumbel(key, shape)`` (float32, the default low mode) for
    (..., 2) keys -> (..., *shape): -log(-log(u)) of ``uniform`` over
    [tiny, 1). The uniforms are JAX's bit for bit; each log is taken in
    float64 and rounded to float32."""
    key = np.asarray(key, np.uint32)
    shape = tuple(int(d) for d in shape)
    u = uniform(key, int(np.prod(shape, dtype=np.int64)), TINY, 1.0).reshape(key.shape[:-1] + shape)
    inner = np.log(u.astype(np.float64)).astype(np.float32)
    return -(np.log(-inner.astype(np.float64)).astype(np.float32))


def categorical(key, logits) -> np.ndarray:
    """``jax.random.categorical(key, logits)`` over the last axis of a
    float32 array (one key): argmax of ``gumbel(key, logits.shape) +
    logits``, the first index on ties."""
    logits = np.asarray(logits, np.float32)
    return np.argmax(gumbel(key, logits.shape) + logits, axis=-1).astype(np.int32)


REACH_SEED = 4321
REACH_RANGE = 0.2


def reach_goal_offsets(num_episodes: int) -> np.ndarray:
    """(E, 3) float32: episode e's reach goal less the resting end effector
    (agent frame), ``uniform(fold_in(PRNGKey(4321), e), (3,), -1, 1) * 0.2``
    as the JAX env draws it."""
    keys = fold_in(prng_key(REACH_SEED), np.arange(num_episodes))
    return uniform(keys, 3, -1.0, 1.0) * np.float32(REACH_RANGE)
