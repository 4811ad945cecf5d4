"""Minimizers + frequency-balanced repartition (ModelMinimizer/Repartitor).

The reference partitions k-mer space by m-mer minimizers with a
frequency-based minimizer order and KMC2-style balanced bin packing
(gatb kmer/impl/Model.hpp ModelMinimizer + RepartitionAlgorithm/Repartitor
— reconstructed, SURVEY.md §3.2; defaults minimizer-type=1
repartition-type=1 forced at /root/reference/src/bcalm_1.cpp:40-41;
KMC2/MSP lineage in PAPERS.md).

Device mapping: partitions are mesh devices (or per-device sub-partitions).
The minimizer of a canonical k-mer is computed on-device with a static
unrolled scan over its k-m+1 m-mers; the repartition table (4^m entries)
lives in device memory and routing is a single gather.

Minimizer order:
  type 0 (lexicographic): order by m-mer value.
  type 1 (frequency):     order by sampled m-mer frequency (ascending,
                          ties by value) — rare minimizers win, which
                          spreads hot m-mers' k-mers across partitions.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from bcalm_tpu.models import lanes as ln

_U32 = jnp.uint32


def mmer_count(k: int, m: int) -> int:
    return k - m + 1


def extract_mmers(lanes: jnp.ndarray, k: int, m: int) -> jnp.ndarray:
    """All m-mers of each k-mer: lane-major (L, ...) -> (k-m+1, ...) uint32.

    m <= 16 so each m-mer fits one lane.  m-mer j covers bases [j, j+m).
    """
    if m > 16:
        raise ValueError("minimizer size must be <= 16")
    n = mmer_count(k, m)
    mask = np.uint32((1 << (2 * m)) - 1)
    out = []
    for j in range(n):
        # shift so that bases [j, j+m) land in the low 2m bits:
        # total bases k, drop k - (j+m) trailing bases
        shifted = ln.shift_right_bits(lanes, 2 * (k - (j + m)))
        out.append(shifted[-1] & mask)
    return jnp.stack(out, axis=0)


@partial(jax.jit, static_argnames=("k", "m"))
def minimizers(lanes: jnp.ndarray, k: int, m: int,
               freq_rank: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Minimizer m-mer of each canonical k-mer (lexicographic or
    frequency-ordered when freq_rank (4^m,) uint32 is given)."""
    mm = extract_mmers(lanes, k, m)
    if freq_rank is None:
        return jnp.min(mm, axis=0)
    ranked = freq_rank[mm]
    best = jnp.argmin(ranked, axis=0)
    return jnp.take_along_axis(mm, best[None], axis=0)[0]


@partial(jax.jit, static_argnames=("k", "m"))
def mmer_histogram(lanes: jnp.ndarray, valid: jnp.ndarray, k: int, m: int):
    """Sampled m-mer frequency histogram over a k-mer set: (4^m,) int32."""
    mm = extract_mmers(lanes, k, m)
    w = jnp.broadcast_to(valid[None], mm.shape).astype(jnp.int32)
    return jnp.bincount(
        mm.reshape(-1).astype(jnp.int32), weights=w.reshape(-1),
        length=4 ** m,
    ).astype(jnp.int32)


def frequency_rank(histogram: np.ndarray) -> np.ndarray:
    """Rank m-mers by ascending frequency (ties by value): rank 0 = rarest.

    The returned (4^m,) uint32 array is the order used by frequency-based
    minimizers (minimizer-type 1)."""
    histogram = np.asarray(histogram)
    order = np.lexsort((np.arange(histogram.size), histogram))
    rank = np.empty_like(order, dtype=np.uint32)
    rank[order] = np.arange(order.size, dtype=np.uint32)
    return rank


def build_repartition(minimizer_load: np.ndarray, n_partitions: int,
                      repartition_type: int = 1) -> np.ndarray:
    """Minimizer -> partition table ((4^m,) int32).

    type 0: uniform (minimizer mod n_partitions).
    type 1: greedy balanced bin packing by observed minimizer load
            (largest-first into least-loaded partition, the KMC2-style
            scheme of gatb's Repartitor).
    """
    n_min = minimizer_load.shape[0]
    if repartition_type == 0:
        return (np.arange(n_min) % n_partitions).astype(np.int32)
    order = np.argsort(-minimizer_load.astype(np.int64), kind="stable")
    # snake (boustrophedon) assignment over the load-sorted minimizers:
    # 0..n-1, n-1..0, ... — an LPT-style balanced packing, fully vectorized
    snake = np.concatenate(
        [np.arange(n_partitions), np.arange(n_partitions - 1, -1, -1)]
    )
    assign = snake[np.arange(n_min) % (2 * n_partitions)]
    table = np.empty(n_min, dtype=np.int32)
    table[order] = assign.astype(np.int32)
    return table


@partial(jax.jit, static_argnames=("k", "m"))
def partition_of(lanes: jnp.ndarray, k: int, m: int, table: jnp.ndarray,
                 freq_rank: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Partition id of each canonical k-mer via its minimizer."""
    mini = minimizers(lanes, k, m, freq_rank)
    return table[mini.astype(jnp.int32)]
