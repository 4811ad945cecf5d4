"""K-mer counting: sort + segment-reduce (device-side DSK replacement).

The reference counts k-mers out-of-core (gatb kmer/impl/SortingCountAlgorithm,
"DSK": disk-staged (pass x partition) radix sort + run-length count,
reconstructed — SURVEY.md §3.2/§4.2).  Here the disk is replaced by
device memory and the per-partition sort becomes a single dense
multi-operand `lax.sort` over the uint32 lane tuple followed by
vectorized run-length reduction.
All shapes are static: "number of unique k-mers" is carried as a scalar
alongside fixed-capacity arrays, the standard XLA idiom for data-dependent
sizes.

Layout + performance notes:
- k-mer sets are LANE-MAJOR (L, N) uint32 (see models.lanes): each lane is
  a contiguous (N,) vector, which sorts/scatters at memory speed,
- validity is FOLDED into the key: invalid slots become the all-ones
  sentinel, which is never a canonical k-mer (rc(G^k) = C^k < G^k), so the
  sort carries exactly L key operands,
- group ids double as compaction destinations (segment_sum output is
  already compacted), so counting costs one sort + one cumsum + one
  segment-sum + L scatters,
- callers should re-slice capacity to the (much smaller) distinct count
  before running the solidity filter (engine.count_and_filter does).

Solidity filtering (-abundance-min / -abundance-max, README.md:23-25 and
hidden options at /root/reference/src/bcalm_1.cpp:34-37) and the abundance
histogram (gatb CountProcessorHistogram) are applied on-device.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

_U32 = jnp.uint32
SENTINEL = np.uint32(0xFFFFFFFF)


def fold_sentinel(lanes: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Set invalid columns of a lane-major (L, N) set to the all-ones
    sentinel (sorts after every canonical k-mer; all-ones = G^k whose
    canonical form is C^k)."""
    return jnp.where(valid[None], lanes, SENTINEL)


def row_starts(sorted_lanes: jnp.ndarray, sorted_valid: jnp.ndarray) -> jnp.ndarray:
    """First-occurrence mask among valid sorted columns of (L, N)."""
    diff = jnp.any(sorted_lanes[:, 1:] != sorted_lanes[:, :-1], axis=0)
    first = jnp.concatenate([jnp.ones((1,), bool), diff])
    return sorted_valid & first


def compact(mask: jnp.ndarray, arrays, fill=0):
    """Stable-compact entries where mask is True to the front of each array
    (1-D arrays or lane-major (L, N) arrays, compacting along the last axis).

    Returns (compacted_arrays, count).  Entries past `count` are `fill`.
    """
    N = mask.shape[0]
    # a cumsum over mask: in-bounds destinations are unique
    dest = jnp.cumsum(mask.astype(jnp.int32)) - 1
    dest = jnp.where(mask, dest, N)  # out-of-range drops in scatter
    outs = []
    for arr in arrays:
        out = jnp.full(arr.shape, fill, dtype=arr.dtype)
        if arr.ndim == 1:
            outs.append(out.at[dest].set(arr, mode="drop"))
        else:  # lane-major: scatter each lane vector
            for j in range(arr.shape[0]):
                out = out.at[j, dest].set(arr[j], mode="drop")
            outs.append(out)
    return tuple(outs), jnp.sum(mask.astype(jnp.int32))


@partial(jax.jit, static_argnames=("weighted", "with_pos"))
def count_canonical(lanes: jnp.ndarray, valid: jnp.ndarray, weights=None,
                    weighted=False, pos=None, with_pos=False):
    """Count occurrences of canonical k-mers.

    Args:
      lanes: lane-major (L, N) uint32 canonical k-mers (unsorted, may
        contain invalid/sentinel slots)
      valid: (N,) bool
      weights: optional (N,) int32 per-occurrence weights (used when merging
        partial (kmer, count) runs: weighted=True)
      pos: optional (N,) uint32 per-occurrence first-occurrence keys
        ((stream index << 1) | rc-strand); with_pos=True returns the MIN
        key per distinct k-mer.  Implemented by appending pos as the
        lowest-priority sort key: stable + ascending means every group
        head carries the group minimum for free.  Positions feed
        ops.runchains' locality-ordered compaction; they affect only
        performance there, never correctness, so u32 stream-index
        wraparound on >4G-occurrence datasets is benign.

    Returns:
      unique: (L, N) unique k-mers compacted to the front, sorted ascending
      counts: (N,) int32 occurrence counts aligned with `unique`
      n_unique: () int32
      [minpos: (N,) uint32 aligned with `unique` — only if with_pos]

    Implementation note (counting by sort rather than by scatter): the
    dedup-compaction is a SECOND sort by (group id | sentinel) carrying
    the key lanes and the exclusive weight-cumsum as payloads; group
    counts are adjacent differences of the compacted cumsums, so the hot
    path has no scatter at occurrence scale.  Both sorts go through
    ops.sort.  Total: 2 sorts + 1 cumsum + elementwise.
    """
    from bcalm_tpu.ops import sort

    L, N = lanes.shape
    folded = fold_sentinel(lanes, valid)
    ops = [folded[j] for j in range(L)]
    nk = L
    if with_pos:
        ops.append(pos)
        nk = L + 1
    if weighted:
        ops.append(weights.astype(jnp.uint32))
    out = sort.sort_ops(ops, num_keys=nk)
    s_lanes = jnp.stack(out[:L], axis=0)
    s_valid = ~jnp.all(s_lanes == SENTINEL, axis=0)
    starts = row_starts(s_lanes, s_valid)
    gid = jnp.cumsum(starts.astype(jnp.int32)) - 1

    w = out[nk].astype(jnp.int32) if weighted else s_valid.astype(jnp.int32)
    w = jnp.where(s_valid, w, 0)
    cumw = jnp.cumsum(w)
    excl = (cumw - w).astype(jnp.uint32)  # weight strictly before position

    # compaction sort: heads keyed by gid (ascending = key order), all
    # non-heads and sentinel slots pushed to the tail
    key2 = jnp.where(starts, gid.astype(jnp.uint32), SENTINEL)
    ops2 = [key2] + [s_lanes[j] for j in range(L)] + [excl]
    if with_pos:
        ops2.append(out[L])  # group-head pos = group min (pos is a key)
    out2 = sort.sort_ops(ops2, num_keys=1)
    n_unique = jnp.sum(starts.astype(jnp.int32))
    idx = jnp.arange(N, dtype=jnp.int32)
    valid_g = idx < n_unique
    unique = jnp.where(valid_g[None], jnp.stack(out2[1:L + 1], axis=0), 0)
    ex = out2[L + 1].astype(jnp.int32)
    # count of group g = excl at next head - excl at this head (the last
    # head closes against the grand total)
    nxt = jnp.concatenate([ex[1:], jnp.zeros((1,), jnp.int32)])
    total = cumw[N - 1]
    cnt = jnp.where(idx == n_unique - 1, total - ex, nxt - ex)
    counts = jnp.where(valid_g, cnt, 0)
    if with_pos:
        minpos = jnp.where(valid_g, out2[L + 2], SENTINEL)
        return unique, counts, n_unique, minpos
    return unique, counts, n_unique


@jax.jit
def filter_abundance(unique, counts, n_unique, abundance_min, abundance_max):
    """Solidity filter (gatb CountProcessorSolidity, 'sum' solidity kind):
    keep abundance_min <= count <= abundance_max."""
    N = unique.shape[1]
    idx = jnp.arange(N, dtype=jnp.int32)
    keep = (
        (idx < n_unique)
        & (counts >= abundance_min)
        & (counts <= abundance_max)
    )
    (solid, solid_counts), n_solid = compact(keep, (unique, counts))
    return solid, solid_counts, n_solid


@jax.jit
def filter_abundance_fold(unique, counts, minpos, n_unique, abundance_min,
                          abundance_max):
    """Elementwise solidity filter: non-solid columns are FOLDED to the
    sentinel (lanes + pos) instead of scatter-compacted.  The downstream
    locality reorder (ops.runchains.reorder_by_pos) sorts by pos anyway,
    which pushes folded columns past the valid prefix for free — so the
    scatter compaction and one host round-trip are both avoided.
    Returns (unique', counts', pos', nn) with nn a stacked
    (2,) int32 of [n_unique, n_solid]: ONE fetch serves both scalars."""
    N = unique.shape[1]
    idx = jnp.arange(N, dtype=jnp.int32)
    keep = (
        (idx < n_unique)
        & (counts >= abundance_min)
        & (counts <= abundance_max)
    )
    solid = jnp.where(keep[None], unique, SENTINEL)
    solid_counts = jnp.where(keep, counts, 0)
    solid_pos = jnp.where(keep, minpos, SENTINEL)
    n_solid = jnp.sum(keep.astype(jnp.int32))
    return solid, solid_counts, solid_pos, jnp.stack([n_unique, n_solid])


@jax.jit
def filter_abundance_pos(unique, counts, minpos, n_unique, abundance_min,
                         abundance_max):
    """filter_abundance carrying the first-occurrence keys through."""
    N = unique.shape[1]
    idx = jnp.arange(N, dtype=jnp.int32)
    keep = (
        (idx < n_unique)
        & (counts >= abundance_min)
        & (counts <= abundance_max)
    )
    (solid, solid_counts, solid_pos), n_solid = compact(
        keep, (unique, counts, minpos))
    # dropped slots must sort LAST in the position reorder, not first
    solid_pos = jnp.where(idx < n_solid, solid_pos, SENTINEL)
    return solid, solid_counts, solid_pos, n_solid


@partial(jax.jit, static_argnames=("histo_max",))
def abundance_histogram(counts, n_unique, histo_max: int = 10000):
    """Histogram of k-mer abundances (gatb CountProcessorHistogram;
    STR_HISTOGRAM_MAX hidden option, /root/reference/src/bcalm_1.cpp:35).

    Returns (histo_max+1,) int32; bin i = #distinct k-mers with count i
    (counts > histo_max accumulate into the last bin).
    """
    N = counts.shape[0]
    idx = jnp.arange(N, dtype=jnp.int32)
    valid = idx < n_unique
    binned = jnp.clip(counts, 0, histo_max)
    return jnp.bincount(
        jnp.where(valid, binned, 0),
        weights=valid.astype(jnp.int32),
        length=histo_max + 1,
    ).astype(jnp.int32)


def sort_by_lanes(lanes: jnp.ndarray, valid: jnp.ndarray, payloads=()):
    """Sort lane-major (L, N) k-mers lexicographically, invalid entries
    last (sentinel folding).  Returns (sorted_lanes, sorted_valid,
    sorted_payloads)."""
    L, N = lanes.shape
    folded = fold_sentinel(lanes, valid)
    operands = [folded[j] for j in range(L)] + list(payloads)
    out = jax.lax.sort(operands, num_keys=L)
    sorted_lanes = jnp.stack(out[:L], axis=0)
    sorted_valid = ~jnp.all(sorted_lanes == SENTINEL, axis=0)
    return sorted_lanes, sorted_valid, tuple(out[L:])
