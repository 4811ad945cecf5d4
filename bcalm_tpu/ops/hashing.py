"""Vectorized 32-bit mixing hashes over k-mer lanes.

Used for partition routing (the device-mesh analog of the reference's
minimizer->partition repartition table, gatb kmer/impl/Repartitor —
SURVEY.md §3.2) and for load-balanced all_to_all exchanges.  Murmur3-style
finalizer; uint32 arithmetic wraps, which is exactly what we want.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_C1 = np.uint32(0x85EBCA6B)
_C2 = np.uint32(0xC2B2AE35)
_SEED = np.uint32(0x9747B28C)
_GOLD = np.uint32(0x9E3779B1)


def mix32(x: jnp.ndarray) -> jnp.ndarray:
    x = x ^ (x >> np.uint32(16))
    x = x * _C1
    x = x ^ (x >> np.uint32(13))
    x = x * _C2
    x = x ^ (x >> np.uint32(16))
    return x


def hash_lanes(lanes: jnp.ndarray) -> jnp.ndarray:
    """Lane-major (L, ...) uint32 lanes -> (...) uint32 hash."""
    h = jnp.full(lanes.shape[1:], _SEED, dtype=jnp.uint32)
    for j in range(lanes.shape[0]):
        h = mix32((h * _GOLD) ^ lanes[j])
    return h
