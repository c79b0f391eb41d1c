"""jax.random's threefry keys and draws, and flax's make_rng, on the host
in numpy uint32 (no torch, no device work), so that the port draws the
DropPath masks the JAX package draws.

As JAX 0.9 computes them with jax_threefry_partitionable on (its
default) and 32-bit integers:
  * threefry2x32: the 20-round Threefry-2x32 hash (prng.py
    _threefry2x32_lowering), broadcast over its four operands;
  * key(seed): (0, seed mod 2^32), the seed cut to 32 bits;
  * fold_in(key, data): threefry2x32(key, (0, data));
  * random_bits(key, shape): for the flat index i, the two words of
    threefry2x32(key, (i >> 32, i & 0xFFFFFFFF)) xor-ed;
  * uniform(key, shape): the bits' top 23 as a float32 mantissa of
    [1, 2), minus 1;
  * bernoulli(key, p, shape): uniform < p, p rounded to float32.

flax 0.12's Scope.make_rng(name) (flax/core/scope.py) folds into the
apply's key, for the n-th draw of a name in one module scope, the SHA-1
of the module path under the root and then n: fold_static(key, path +
(n,)).  A key is a (..., 2) uint32 array."""

from __future__ import annotations

import hashlib
from typing import Sequence

import numpy as np

U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v: np.ndarray, d: int) -> np.ndarray:
    return (v << U32(d)) | (v >> U32(32 - d))


def threefry2x32(k1, k2, x1, x2) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the counts (x1, x2) under the key (k1, k2), all
    uint32 and broadcast together."""
    k1, k2, x1, x2 = np.broadcast_arrays(
        *(np.asarray(v, U32) for v in (k1, k2, x1, x2)))
    ks = (k1, k2, k1 ^ k2 ^ U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [x1 + ks[0], x2 + ks[1]]
        for r in range(5):
            for rot in _ROTATIONS[r % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], rot) ^ x[0]
            x[0] = x[0] + ks[(r + 1) % 3]
            x[1] = x[1] + ks[(r + 2) % 3] + U32(r + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """jax.random.key(seed) as its (2,) uint32 data."""
    return np.array([0, int(seed) & 0xFFFFFFFF], U32)


def fold_in(k, data) -> np.ndarray:
    """jax.random.fold_in(k, data) of uint32 data (broadcast with k's
    leading dims)."""
    k = np.asarray(k, U32)
    y1, y2 = threefry2x32(k[..., 0], k[..., 1], U32(0),
                          np.asarray(data, np.int64).astype(U32))
    return np.stack([y1, y2], -1)


def random_bits(k, shape: Sequence[int]) -> np.ndarray:
    """jax.random.bits(k, shape) (uint32), k a (2,) key or (..., 2) keys
    drawn over at once: (...,) + shape."""
    k = np.asarray(k, U32)
    idx = np.arange(int(np.prod(shape)), dtype=np.uint64)
    lead = k.shape[:-1]
    k1 = k[..., 0].reshape(lead + (1,))
    k2 = k[..., 1].reshape(lead + (1,))
    y1, y2 = threefry2x32(k1, k2, (idx >> np.uint64(32)).astype(U32),
                          idx.astype(U32))
    return (y1 ^ y2).reshape(lead + tuple(shape))


def uniform(k, shape: Sequence[int]) -> np.ndarray:
    """jax.random.uniform(k, shape) in float32 on [0, 1)."""
    bits = (random_bits(k, shape) >> U32(9)) | U32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def bernoulli(k, p: float, shape: Sequence[int]) -> np.ndarray:
    """jax.random.bernoulli(k, p, shape): uniform < p in float32."""
    return uniform(k, shape) < np.float32(p)


def static_hash(path: Sequence) -> int:
    """flax's _fold_in_static digest of a suffix of names and counts: each
    str as UTF-8 and each int big-endian in its fewest bytes, one SHA-1,
    its first 4 bytes big-endian (flax_fix_rng_separator off)."""
    m = hashlib.sha1()
    for x in path:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, "big"))
        else:
            raise ValueError(f"expected int or str, got {x!r}")
    return int.from_bytes(m.digest()[:4], "big")


def fold_static(k, path: Sequence) -> np.ndarray:
    """flax's LazyRng(k, path).as_jax_rng(): k itself for an empty path."""
    return np.asarray(k, U32) if not path else fold_in(k, static_hash(path))
