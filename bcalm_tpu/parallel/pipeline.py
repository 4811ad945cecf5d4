"""Sharded multi-chip pipeline: distributed k-mer counting over a Mesh.

Device-side replacement for the reference's (pass x partition) disk staging
(gatb SortingCountAlgorithm — SURVEY.md §3.3/§4.2): the minimizer
partition space maps onto mesh devices, and superkmer routing to disk
partitions becomes an `all_to_all` over the interconnect.  The
production path
(`distributed_build`) is STREAMED and MINIMIZER-PARTITIONED:

1. a sampling round builds the m-mer frequency order + the
   frequency-balanced minimizer->device repartition table
   (models.minimizer; gatb RepartitionAlgorithm/Repartitor — defaults
   minimizer-type=1 repartition-type=1 forced at
   /root/reference/src/bcalm_1.cpp:40-41),
2. each round, every device forms SUPERKMERS (maximal same-minimizer
   k-mer runs, ops.superkmer) from its read shard and routes the packed
   base runs — not individual k-mers — through a fixed-capacity
   all_to_all (the ~span/(W+1)-fold traffic cut that superkmer binning
   buys the reference on disk I/O),
3. the receiver re-extracts canonical k-mers (a superkmer is just a short
   read) and counts its round-local share (ops.count); k-mer space is
   disjoint across devices so no further reduction is needed,
4. per-device distinct runs stream to the host and merge in bounded key
   ranges (engine.merge_host_runs — shared with the single-chip
   out-of-core path), so device memory is O(round), not O(dataset),
5. compaction runs fully sharded on the mesh (parallel.distcompact).

All exchanges are fixed-capacity with psum'd overflow detection (never
silent).  The per-k-mer hash-routing primitives (distributed_count) are
kept below as building blocks and for the overflow/equality unit tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Iterable, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from bcalm_tpu.models import lanes as ln
from bcalm_tpu.ops import count as count_op
from bcalm_tpu.ops import extract as extract_op
from bcalm_tpu.ops import hashing

AXIS = "kspace"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (AXIS,))


def _route_to_buckets(stacked, valid, owner, n_dev: int, cap: int,
                      with_slots: bool = False):
    """Scatter entries into per-destination fixed buckets by owner id.

    stacked: channel-major (C, N) uint32 (lane rows + packed payload rows).
    Returns (buckets (C, n_dev, cap), bucket_valid (n_dev, cap),
    n_dropped scalar[, slots (N,)]).  Overflow within a destination bucket
    is counted, never silent.

    with_slots: also return each input entry's flat bucket slot
    (owner*cap + within; n_dev*cap for dropped/invalid entries) — the
    request/response exchange pattern uses it to match answers that come
    back in the same bucket layout to their original entries.
    """
    C, N = stacked.shape
    owner = jnp.where(valid, owner, n_dev)
    # stable sort by owner keeps determinism
    order = jnp.argsort(owner, stable=True)
    s_owner = owner[order]
    s_stack = stacked[:, order]
    s_valid = valid[order]
    # position within each owner run
    idx = jnp.arange(N, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), s_owner[1:] != s_owner[:-1]]
    )
    run_start = jax.lax.associative_scan(
        jnp.maximum, jnp.where(is_start, idx, 0)
    )
    within = idx - run_start
    ok = s_valid & (within < cap) & (s_owner < n_dev)
    # (owner, within) pairs are distinct: in-bounds destinations are unique
    dest = jnp.where(ok, s_owner * cap + within, n_dev * cap)
    bl = jnp.zeros((C, n_dev * cap), dtype=stacked.dtype)
    for c in range(C):
        bl = bl.at[c, dest].set(jnp.where(ok, s_stack[c], 0), mode="drop")
    bv = jnp.zeros((n_dev * cap,), dtype=bool)
    bv = bv.at[dest].set(ok, mode="drop")
    n_dropped = jnp.sum((s_valid & ~ok).astype(jnp.int32))
    out = (bl.reshape(C, n_dev, cap), bv.reshape(n_dev, cap), n_dropped)
    if with_slots:
        # unsort: slot of ORIGINAL entry i = dest at sorted position of i
        slots = jnp.zeros((N,), jnp.int32).at[order].set(dest)
        out = out + (slots,)
    return out


def _local_shard_count(words, lengths, k: int, n_dev: int, cap: int):
    """Per-device body: extract, route, exchange, count. Runs under shard_map."""
    canon, valid = extract_op.extract_canonical(words, lengths, k)
    L = canon.shape[0]
    lanes = canon.reshape(L, -1)
    flat_valid = valid.reshape(-1)
    owner = (hashing.hash_lanes(lanes) % np.uint32(n_dev)).astype(jnp.int32)
    bl, bv, dropped = _route_to_buckets(lanes, flat_valid, owner, n_dev, cap)
    # exchange: bucket i goes to device i; we receive one from every device
    recv_l = jax.lax.all_to_all(bl, AXIS, split_axis=1, concat_axis=1)
    recv_v = jax.lax.all_to_all(bv, AXIS, split_axis=0, concat_axis=0)
    mine_l = recv_l.reshape(L, -1)
    mine_v = recv_v.reshape(-1)
    unique, counts, n_unique = count_op.count_canonical(mine_l, mine_v)
    total_dropped = jax.lax.psum(dropped, AXIS)
    return unique, counts, n_unique[None], total_dropped


def distributed_count_fn(mesh: Mesh, k: int, cap_per_dest: int):
    """Build the jitted sharded counting step for a mesh.

    Input:  words (B, W) uint32, lengths (B,) — B sharded over the mesh.
    Output: per-device unique/counts/n_unique (sharded), dropped (replicated).
    """
    n_dev = mesh.devices.size

    fn = shard_map(
        partial(_local_shard_count, k=k, n_dev=n_dev, cap=cap_per_dest),
        mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS)),
        out_specs=(P(None, AXIS), P(AXIS), P(AXIS), P()),
        check_vma=False,
    )
    return jax.jit(fn)


@dataclass
class DistributedCountResult:
    unique: jax.Array     # (L, n_dev * cap_total) axis-1-sharded, per-device sorted
    counts: jax.Array
    n_unique: np.ndarray  # (n_dev,) per-device unique counts
    dropped: int


def distributed_count(mesh, words, lengths, k, cap_per_dest):
    fn = distributed_count_fn(mesh, k, cap_per_dest)
    unique, counts, n_unique, dropped = fn(words, lengths)
    return DistributedCountResult(
        unique=unique,
        counts=counts,
        n_unique=np.asarray(n_unique),
        dropped=int(dropped),
    )


def solid_per_device(result: DistributedCountResult, abundance_min: int,
                     abundance_max: int):
    """Host-side: per-device solid (kmer, count) shards after solidity."""
    n_dev = result.n_unique.shape[0]
    uniq = np.asarray(result.unique)
    cnts = np.asarray(result.counts)
    per = uniq.shape[1] // n_dev
    parts_k, parts_c = [], []
    for d in range(n_dev):
        n = int(result.n_unique[d])
        u = uniq[:, d * per : d * per + n]
        c = cnts[d * per : d * per + n]
        keep = (c >= abundance_min) & (c <= abundance_max)
        parts_k.append(u[:, keep])
        parts_c.append(c[keep])
    return parts_k, parts_c


def gather_solid(result: DistributedCountResult, abundance_min: int,
                 abundance_max: int):
    """Host-side: gather per-device solid sets into one global sorted array.

    K-mer spaces are disjoint across devices; the global solid set is the
    concatenation, re-sorted for the downstream junction stage.
    """
    parts_k, parts_c = solid_per_device(result, abundance_min, abundance_max)
    uniq = np.asarray(result.unique)
    solid = (np.concatenate(parts_k, axis=1) if parts_k
             else np.zeros((uniq.shape[0], 0), np.uint32))
    counts = np.concatenate(parts_c) if parts_c else np.zeros((0,), np.int32)
    # global sort (lexicographic over lanes, most-significant first)
    order = np.lexsort(tuple(solid[j] for j in range(solid.shape[0] - 1, -1, -1)))
    return solid[:, order], counts[order]


def pack_global_blocks(seqs: Iterable[str], k: int, n_dev: int,
                       block_reads: int = 1024, max_len: int = 512):
    """Pack all reads into one global (B, W) array with B % n_dev == 0."""
    from bcalm_tpu.io import packing

    blocks = list(packing.iter_blocks(seqs, k, block_reads=block_reads,
                                      max_len=max_len))
    if not blocks:
        W = max(1, (max(max_len, k, 16) + 15) // 16)
        return (np.zeros((n_dev, W), np.uint32), np.zeros((n_dev,), np.int32))
    words = np.concatenate([b.words for b in blocks])
    lengths = np.concatenate([b.lengths for b in blocks])
    B = words.shape[0]
    pad = (-B) % n_dev
    if pad:
        words = np.concatenate([words, np.zeros((pad, words.shape[1]), np.uint32)])
        lengths = np.concatenate([lengths, np.zeros((pad,), np.int32)])
    return words, lengths


def iter_global_blocks(seqs: Iterable[str], k: int, n_dev: int,
                       block_reads: int, max_len: int):
    """Stream (words, lengths) rounds with exactly n_dev * block_reads rows
    each — host memory O(round), never the whole input (pack_global_blocks
    materializes everything)."""
    from bcalm_tpu.io import packing

    acc_w, acc_l = [], []
    width = None
    for b in packing.iter_blocks(seqs, k, block_reads=block_reads,
                                 max_len=max_len):
        acc_w.append(b.words)
        acc_l.append(b.lengths)
        width = b.words.shape[1]
        if len(acc_w) == n_dev:
            yield np.concatenate(acc_w), np.concatenate(acc_l)
            acc_w, acc_l = [], []
    if acc_w:
        pad = n_dev - len(acc_w)
        acc_w += [np.zeros((block_reads, width), np.uint32)] * pad
        acc_l += [np.zeros((block_reads,), np.int32)] * pad
        yield np.concatenate(acc_w), np.concatenate(acc_l)


# rounds buffered for the repartition sampling pass (each round is
# n_dev blocks of reads; ~8 rounds bounds the bias a sorted-genome
# prefix can inject while keeping the buffer a few MB)
SAMPLE_ROUNDS = 8


@dataclass
class MinimizerConfig:
    """Minimizer routing knobs (reference flag surface: -minimizer-size,
    -minimizer-type, -repartition-type — defaults 1/1 forced at
    /root/reference/src/bcalm_1.cpp:40-41, legacy m=8 at :19)."""
    m: int = 8
    minimizer_type: int = 1     # 0 lexicographic, 1 frequency
    repartition_type: int = 1   # 0 uniform, 1 balanced bin packing
    max_span: Optional[int] = None  # k-mers/superkmer cap (None = per-k)
    cap_per_dest: Optional[int] = None  # superkmer exchange capacity


def effective_m(k: int, m: int) -> int:
    """m must leave at least one m-mer per k-mer and fit one lane."""
    return max(1, min(m, k - 1, 16))


def sample_tables(words: np.ndarray, lengths: np.ndarray, k: int,
                  mcfg: MinimizerConfig, n_parts: int):
    """Single-round convenience wrapper around sample_tables_multi."""
    return sample_tables_multi([(words, lengths)], k, mcfg, n_parts)


def sample_tables_multi(sample_rounds, k: int, mcfg: MinimizerConfig,
                        n_parts: int):
    """Build the canonical-m-mer frequency order + the balanced
    minimizer->partition table from SEVERAL rounds of reads (gatb
    RepartitionAlgorithm runs a dedicated sampling pass over the input —
    SURVEY.md §3.2; one-round sampling skews the whole run on
    locally-biased prefixes like position-sorted reads).

    Two passes over the buffered sample: (1) accumulate the canonical
    m-mer histogram and derive the frequency rank, (2) accumulate the
    per-minimizer-KEY k-mer load under that rank, then bin-pack.

    Returns (freq_rank or None, table, load) indexed by the window-min
    KEY (the frequency rank for minimizer-type 1, else the m-mer value).
    """
    from bcalm_tpu.models import minimizer as mz
    from bcalm_tpu.ops import superkmer as skm

    m = effective_m(k, mcfg.m)
    if mcfg.minimizer_type == 1:
        histo = np.zeros((4 ** m,), np.int64)
        for words, lengths in sample_rounds:
            histo += np.asarray(skm.sample_cmmer_histogram(
                jnp.asarray(words), jnp.asarray(lengths), k, m))
        freq_rank = mz.frequency_rank(
            np.minimum(histo, 2**31 - 1).astype(np.int32))
        rank_d = jnp.asarray(freq_rank)
        use_rank = True
    else:
        freq_rank = None
        rank_d = None
        use_rank = False
    load = np.zeros((4 ** m,), np.int64)
    for words, lengths in sample_rounds:
        load += np.asarray(skm.sample_minimizer_load(
            jnp.asarray(words), jnp.asarray(lengths), k, m, rank_d,
            use_rank=use_rank))
    load = np.minimum(load, 2**31 - 1).astype(np.int32)
    table = mz.build_repartition(load, n_parts, mcfg.repartition_type)
    return freq_rank, table, load


def _local_skm_count(words, lengths, table, freq_rank, round_base, *, k: int,
                     m: int, n_dev: int, cap: int, max_span: int,
                     use_rank: bool):
    """Per-device round body: superkmer formation -> routed exchange ->
    receiver re-extraction -> local count.  Runs under shard_map.

    Each superkmer carries its global stream START slot (+1 exchange word);
    re-extracted occurrences get first-occurrence keys
    ((slot << 1) | rc-strand) so the sharded counting emits the same
    minpos column as the single-chip path (ops.runchains locality)."""
    from bcalm_tpu.ops import superkmer as skm

    me = jax.lax.axis_index(AXIS)
    B, W = words.shape
    P_grid = W * 16
    pos_base = (round_base.astype(jnp.uint32)
                + me.astype(jnp.uint32) * np.uint32(B * P_grid))
    skm_words, owner, start, n_kmers = skm.form_superkmers(
        words, lengths, k, m, table, freq_rank,
        max_span=max_span, use_rank=use_rank,
        with_pos=True, pos_base=pos_base)
    Wp = skm_words.shape[0]                               # Wn + 1 (pos)
    Wn = Wp - 1
    bl, bv, dropped = _route_to_buckets(skm_words, start, owner, n_dev, cap)
    recv_l = jax.lax.all_to_all(bl, AXIS, split_axis=1, concat_axis=1)
    recv_v = jax.lax.all_to_all(bv, AXIS, split_axis=0, concat_axis=0)
    ent = recv_l.reshape(Wp, -1)
    ev = recv_v.reshape(-1)
    r_words = jnp.transpose(ent[:Wn])                     # (S, Wn)
    span = skm.decode_span(ent[Wn - 1], max_span)
    r_len = jnp.where(ev, span + (k - 1), 0)
    canon, valid, use_rc = extract_op.extract_canonical(
        r_words, r_len, k, with_strand=True)
    P_eff = max(1, canon.shape[2] - (k - 1))
    canon = canon[:, :, :P_eff]
    valid = valid[:, :P_eff]
    use_rc = use_rc[:, :P_eff]
    skm_pos = ent[Wn]                                     # (S,) start slots
    occ_slot = (skm_pos[:, None]
                + jnp.arange(P_eff, dtype=jnp.uint32)[None, :])
    occ_pos = ((occ_slot & np.uint32(0x3FFFFFFF)) << np.uint32(1)) \
        | use_rc.astype(jnp.uint32)
    L = canon.shape[0]
    unique, counts, n_unique, minpos = count_op.count_canonical(
        canon.reshape(L, -1), valid.reshape(-1),
        pos=occ_pos.reshape(-1), with_pos=True)
    stats = (
        jax.lax.psum(dropped, AXIS),
        jax.lax.psum(n_kmers, AXIS),
        jax.lax.psum(jnp.sum(start.astype(jnp.int32)), AXIS),
        jax.lax.psum(jnp.sum(valid.astype(jnp.int32)), AXIS),
    )
    return unique, counts, minpos, n_unique[None], jnp.stack(stats)


def skm_count_fn(mesh: Mesh, k: int, m: int, cap: int, max_span: int,
                 use_rank: bool):
    """Jitted streamed superkmer counting round over the mesh."""
    n_dev = mesh.devices.size
    fn = shard_map(
        partial(_local_skm_count, k=k, m=m, n_dev=n_dev, cap=cap,
                max_span=max_span, use_rank=use_rank),
        mesh=mesh,
        in_specs=(P(AXIS, None), P(AXIS), P(None), P(None), P()),
        out_specs=(P(None, AXIS), P(AXIS), P(AXIS), P(AXIS), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def _lex_lt_sh(lanes, bound):
    """Columnwise lexicographic lanes[:, i] < bound over L uint32 lanes."""
    L = lanes.shape[0]
    lt = jnp.zeros(lanes.shape[1], bool)
    eq = jnp.ones(lanes.shape[1], bool)
    for j in range(L):
        lt = lt | (eq & (lanes[j] < bound[j]))
        eq = eq & (lanes[j] == bound[j])
    return lt


def stack_trim_fn(mesh: Mesh, L: int, cap_out: int, ranged: bool = False):
    """Sharded per-device trim of a counting round's output into ONE
    stacked (L+2, n_dev*cap_out) run (lanes + counts-as-u32 + pos), tails
    sentinel-folded.  Device-resident replacement for the per-round host
    fetch (which funneled every round's distinct runs through host
    RAM).

    ranged=True additionally folds entries whose key lies outside the
    global [lo, hi) lex range — the mesh analog of the single-chip
    multi-pass key-range fold (engine._count_chunk_ranged).  Counting a
    range-folded trim yields a SHORTER valid prefix than n_u, so the
    stacked n is recomputed from the fold."""
    def local(unique, counts, minpos, n_u, lo, hi):
        idx = jnp.arange(cap_out, dtype=jnp.int32)
        keep = idx < n_u[0]
        lanes = unique[:, :cap_out]
        if ranged:
            keep = keep & ~_lex_lt_sh(lanes, lo) & _lex_lt_sh(lanes, hi)
        lanes = jnp.where(keep[None], lanes, count_op.SENTINEL)
        c = jnp.where(keep, counts[:cap_out], 0).astype(jnp.uint32)
        p = jnp.where(keep, minpos[:cap_out], count_op.SENTINEL)
        stk = jnp.concatenate([lanes, c[None], p[None]], axis=0)
        return stk, jnp.sum(keep.astype(jnp.int32))[None]

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(None, AXIS), P(AXIS), P(AXIS), P(AXIS), P(None),
                  P(None)),
        out_specs=(P(None, AXIS), P(AXIS)), check_vma=False))


def sharded_merge_fn(mesh: Mesh, L: int, cap_out: int):
    """Per-device weighted merge of two stacked runs (no collectives —
    each device merges its own shard).  Returns (merged stacked at
    cap_out per device, n (n_dev,))."""
    def local(a, b):
        lanes = jnp.concatenate([a[:L], b[:L]], axis=1)
        weights = jnp.concatenate([a[L], b[L]]).astype(jnp.int32)
        mpos = jnp.concatenate([a[L + 1], b[L + 1]])
        pad = cap_out - lanes.shape[1]
        if pad > 0:
            lanes = jnp.concatenate(
                [lanes, jnp.full((L, pad), count_op.SENTINEL, jnp.uint32)],
                axis=1)
            weights = jnp.concatenate([weights, jnp.zeros((pad,), jnp.int32)])
            mpos = jnp.concatenate(
                [mpos, jnp.full((pad,), count_op.SENTINEL, jnp.uint32)])
        valid = ~jnp.all(lanes == count_op.SENTINEL, axis=0)
        u, c, n, p = count_op.count_canonical(
            lanes, valid, weights=weights, weighted=True,
            pos=mpos, with_pos=True)
        idx = jnp.arange(u.shape[1], dtype=jnp.int32)
        keep = idx < n
        u = jnp.where(keep[None], u, count_op.SENTINEL)
        p = jnp.where(keep, p, count_op.SENTINEL)
        stk = jnp.concatenate([u, c.astype(jnp.uint32)[None], p[None]],
                              axis=0)
        return stk, n[None]

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(None, AXIS), P(None, AXIS)),
        out_specs=(P(None, AXIS), P(AXIS)), check_vma=False))


def trim_stacked_fn(mesh: Mesh, cap_out: int):
    """Per-device slice of a stacked run to a smaller capacity class
    (entries past each device's n are already sentinel-folded)."""
    def local(stk):
        return stk[:, :cap_out]

    return jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P(None, AXIS),),
        out_specs=P(None, AXIS), check_vma=False))


def finish_count_fn(mesh: Mesh, L: int, histo_max: int):
    """Final sharded counting epilogue: abundance histogram (psum'd,
    replicated) + elementwise solidity fold + per-device solid count."""
    def local(stk, n_loc, amin, amax):
        cap = stk.shape[1]
        idx = jnp.arange(cap, dtype=jnp.int32)
        counts = stk[L].astype(jnp.int32)
        valid = idx < n_loc[0]
        binned = jnp.clip(jnp.where(valid, counts, 0), 0, histo_max)
        histo = jnp.zeros((histo_max + 1,), jnp.int32).at[
            jnp.where(valid, binned, histo_max + 1)].add(
            1, mode="drop")
        histo = jax.lax.psum(histo, AXIS)
        keep = valid & (counts >= amin) & (counts <= amax)
        lanes = jnp.where(keep[None], stk[:L], count_op.SENTINEL)
        c = jnp.where(keep, counts, 0).astype(jnp.uint32)
        p = jnp.where(keep, stk[L + 1], count_op.SENTINEL)
        out = jnp.concatenate([lanes, c[None], p[None]], axis=0)
        return out, jnp.sum(keep.astype(jnp.int32))[None], histo

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(None, AXIS), P(AXIS), P(), P()),
        out_specs=(P(None, AXIS), P(AXIS), P(None)), check_vma=False))


def superkmer_capacity(block_reads: int, max_len: int, k: int, m: int,
                       n_dev: int, max_span: int, slack: float = 3.0,
                       max_share: Optional[float] = None) -> int:
    """Per-destination superkmer bucket capacity for one round.

    max_share: observed worst per-device k-mer load share from the
    sampling rounds (None = assume uniform 1/n_dev).  Sizing the capacity
    to the measured skew makes overflow retries rare instead of merely
    recoverable."""
    from bcalm_tpu.ops import superkmer as skm

    occ = max(1, max_len - k + 1)
    per_read = occ / skm.est_span(k, m) + 1.0
    share = max(1.0 / n_dev, max_share if max_share else 1.0 / n_dev)
    return int(max(64, np.ceil(block_reads * n_dev * per_read
                               * slack * share)))


class _CapacityLadder:
    """Background AOT compiles of the next exchange-capacity rung.

    An overflow retry would otherwise rebuild + compile the shard_map jit
    mid-run, paid at the worst moment.  The ladder compiles cap*2 in a
    daemon thread as soon as the round shapes are known, so the retry
    path swaps in an already-compiled executable."""

    def __init__(self, make_fn):
        self._make_fn = make_fn
        self._compiled: dict = {}
        self._threads: dict = {}
        self.hits = 0

    def prefetch(self, cap: int, arg_shapes):
        import threading

        if cap in self._compiled or cap in self._threads:
            return

        def work():
            try:
                self._compiled[cap] = \
                    self._make_fn(cap).lower(*arg_shapes).compile()
            except Exception as e:  # noqa: BLE001 — retry falls back
                self._compiled[cap] = e

        t = threading.Thread(target=work, daemon=True)
        self._threads[cap] = t
        t.start()

    def get(self, cap: int):
        """Compiled fn for cap, or None (caller compiles blocking)."""
        t = self._threads.pop(cap, None)
        if t is not None:
            t.join()
        got = self._compiled.pop(cap, None)
        if got is None or isinstance(got, Exception):
            return None
        self.hits += 1
        return got


def distributed_build(seqs, cfg, mesh: Mesh,
                      mcfg: Optional[MinimizerConfig] = None,
                      auto_amin_cap: Optional[int] = None,
                      store=None, reread=None):
    """Streamed, minimizer-partitioned multi-chip build.

    Per round: superkmer routing + exchange + per-device counting on the
    mesh; per-device distinct runs stream to the host and merge in bounded
    key ranges (device memory O(round)).  Compaction runs sharded
    (distcompact).  Produces the same UnitigSet as engine.build_from_seqs
    (validated by tests/test_parallel.py).

    auto_amin_cap: when set, the abundance cutoff is derived from the
    merged histogram (`-abundance-min auto`, same valley rule as the
    single-device path) and cfg.abundance_min is updated in place.

    store: optional storage.Store — persists the merged solid counts,
    histogram, first-occurrence keys AND the minimizer repartition table
    (the reference's `minimizers/repartition` .h5 group, SURVEY.md §3.2),
    so a crashed/resumed multi-chip run restarts from counting output via
    `-skip-bcalm` exactly like the single-device path.
    """
    from bcalm_tpu import engine as eng
    from bcalm_tpu.parallel import distcompact

    from bcalm_tpu.ops import superkmer as skm_mod

    mcfg = mcfg or MinimizerConfig()
    n_dev = mesh.devices.size
    k = cfg.k
    m = effective_m(k, mcfg.m)
    max_span = mcfg.max_span or skm_mod.default_max_span(k)
    block_reads = min(cfg.block_reads, 1024)
    cap = mcfg.cap_per_dest or superkmer_capacity(
        block_reads, cfg.max_len, k, m, n_dev, max_span)

    import itertools

    rounds = iter_global_blocks(seqs, k, n_dev, block_reads, cfg.max_len)
    # buffer the first rounds as the repartition SAMPLE (a dedicated-pass
    # analog of gatb RepartitionAlgorithm; one-round sampling mis-balances
    # position-sorted inputs); the buffered
    # rounds are then counted first, so nothing is read twice
    sample = list(itertools.islice(rounds, SAMPLE_ROUNDS))
    if not sample:
        return eng.UnitigSet(
            k=k, seqs=[], kc=np.zeros(0, np.int64), abundances=[],
            circular=np.zeros(0, bool), links=[], stats={"solid_kmers": 0})
    freq_rank, table, load = sample_tables_multi(sample, k, mcfg, n_dev)
    # inputs go straight to their mesh placement (read rows split over
    # the devices, tables replicated): nothing lands whole on one device
    # first and is resharded by every call
    rows_sh = jax.sharding.NamedSharding(mesh, P(AXIS, None))
    vec_sh = jax.sharding.NamedSharding(mesh, P(AXIS))
    repl_sh = jax.sharding.NamedSharding(mesh, P())
    table_d = jax.device_put(table, repl_sh)
    rank_d = jax.device_put(
        freq_rank if freq_rank is not None
        else np.zeros((4 ** m,), np.uint32), repl_sh)

    # skew-aware capacity: size to the sampled worst per-device load share
    # so overflow retries are rare, not just recoverable
    load_per_dev = np.bincount(table, weights=load.astype(np.float64),
                               minlength=n_dev)
    max_share = (float(load_per_dev.max()) / max(1.0, load_per_dev.sum()))
    if mcfg.cap_per_dest is None:
        cap = superkmer_capacity(block_reads, cfg.max_len, k, m, n_dev,
                                 max_span, max_share=max_share)

    use_rank = freq_rank is not None

    def make_fn(c):
        return skm_count_fn(mesh, k, m, c, max_span, use_rank=use_rank)

    fn = make_fn(cap)
    ladder = _CapacityLadder(make_fn)
    totals = np.zeros((4,), np.int64)       # dropped, kmers, skms, routed
    retries = 0
    round_base = 0
    arg_shapes = None

    # device-resident per-device distinct runs: [stacked (L+2, n_dev*c),
    # n (n_dev,) host, gen] with LSM generation merging — the counting
    # output never round-trips through host RAM
    L = ln.num_lanes(k)
    dev_partials: list = []
    _stack_cache: dict = {}
    _merge_cache: dict = {}
    _trim_cache: dict = {}

    zeros_L = jnp.zeros((L,), jnp.uint32)
    ones_L = jnp.full((L,), count_op.SENTINEL, jnp.uint32)

    def _stacked(u, c, p, n_dev_arr, cap_out, lo_d, hi_d, ranged):
        key = (cap_out, ranged)
        f = _stack_cache.get(key)
        if f is None:
            f = _stack_cache[key] = stack_trim_fn(mesh, L, cap_out,
                                                  ranged=ranged)
        return f(u, c, p, n_dev_arr, lo_d, hi_d)

    def merge_two_dev(a, b):
        cap_a = a[0].shape[1] // n_dev
        cap_b = b[0].shape[1] // n_dev
        cap_out = eng._round_capacity(cap_a + cap_b)
        key = (cap_a, cap_b, cap_out)
        f = _merge_cache.get(key)
        if f is None:
            f = _merge_cache[key] = sharded_merge_fn(mesh, L, cap_out)
        stk, n_d = f(a[0], b[0])
        n_np = np.asarray(n_d)
        cap_t = eng._round_capacity(max(1, int(n_np.max())))
        if cap_t < cap_out:
            ft = _trim_cache.get((cap_out, cap_t))
            if ft is None:
                ft = _trim_cache[(cap_out, cap_t)] = trim_stacked_fn(
                    mesh, cap_t)
            stk = ft(stk)
        return [stk, n_np, max(a[2], b[2]) + 1]

    # per-device residency budget (slots of settled distinct runs): the
    # mesh analog of EngineConfig.resident_kmers; when any device's
    # resident distinct exceeds it on pass 1, counting restarts as
    # MULTI-PASS over global key ranges (reread required)
    budget_dev = max(cfg.resident_kmers // max(1, n_dev), 1024)

    def run_mesh_pass(round_iter, lo_np, hi_np, ranged, first_pass,
                      watch_budget):
        """One full pass over the input for one key range.  Returns
        (final [stk, n_np] or None-if-empty, 'overflow' flag)."""
        nonlocal fn, cap, retries, arg_shapes, totals
        lo_d = jnp.asarray(lo_np) if lo_np is not None else zeros_L
        hi_d = jnp.asarray(hi_np) if hi_np is not None else ones_L
        dev_partials.clear()
        round_base = 0
        resident = np.zeros((n_dev,), np.int64)
        for words, lengths in round_iter:
            w_d = jax.device_put(words, rows_sh)
            l_d = jax.device_put(lengths, vec_sh)
            rb = jax.device_put(np.uint32(round_base & 0x3FFFFFFF), repl_sh)
            if arg_shapes is None:
                arg_shapes = tuple(
                    jax.ShapeDtypeStruct(x.shape, x.dtype,
                                         sharding=x.sharding)
                    for x in (w_d, l_d, table_d, rank_d, rb))
                # next rung compiles in the background from round 1, so
                # an overflow retry never waits on the compile service
                ladder.prefetch(2 * cap, arg_shapes)
            while True:
                unique, counts, minpos, n_unique, rstats = fn(
                    w_d, l_d, table_d, rank_d, rb)
                st = np.asarray(rstats)
                if st[0] == 0:
                    break
                # exchange overflow: double the capacity, re-run round
                cap *= 2
                retries += 1
                if cap > (1 << 24):
                    raise RuntimeError(
                        f"superkmer exchange overflow persists at {cap}")
                fn = ladder.get(cap) or make_fn(cap)
                ladder.prefetch(2 * cap, arg_shapes)
            if first_pass:
                totals += st
            round_base += words.shape[0] * words.shape[1] * 16
            nu = np.asarray(n_unique)
            per = unique.shape[1] // n_dev
            cap_d = min(per, eng._round_capacity(max(1, int(nu.max()))))
            stk, n_d = _stacked(unique, counts, minpos, n_unique, cap_d,
                                lo_d, hi_d, ranged)
            n_np = np.asarray(n_d)
            dev_partials.append([stk, n_np, 0])
            resident += n_np.astype(np.int64)
            while (len(dev_partials) >= 2
                   and dev_partials[-1][2] == dev_partials[-2][2]):
                b = dev_partials.pop()
                a = dev_partials.pop()
                merged = merge_two_dev(a, b)
                resident += merged[1].astype(np.int64) \
                    - a[1].astype(np.int64) - b[1].astype(np.int64)
                dev_partials.append(merged)
            if watch_budget and int(resident.max()) > budget_dev:
                return None, True
        if first_pass:
            assert totals[1] == totals[3], \
                "routed k-mers != extracted k-mers"
        while len(dev_partials) > 1:
            b = dev_partials.pop()
            a = dev_partials.pop()
            dev_partials.append(merge_two_dev(a, b))
        if not dev_partials:
            return None, False
        final = dev_partials.pop()
        return [final[0], final[1]], False

    def pivots_from_partials(final):
        """Global key-range pivots: per-device quantile keys of the
        (force-merged) resident runs, merged on host (tiny fetch)."""
        stk, n_np = final[0], final[1]
        Q = 256   # >= 4x the max range count (64): pivots never run short
        capF = stk.shape[1] // n_dev

        def qlocal(s, n_loc):
            qi = jnp.clip(((jnp.arange(Q, dtype=jnp.int32) + 1)
                           * n_loc[0]) // (Q + 1), 0, capF - 1)
            return s[:L, qi]

        qf = jax.jit(shard_map(
            qlocal, mesh=mesh, in_specs=(P(None, AXIS), P(AXIS)),
            out_specs=P(None, AXIS), check_vma=False))
        qs = np.asarray(qf(stk, jnp.asarray(n_np.astype(np.int32))))
        cols = sorted({tuple(qs[:, j]) for j in range(qs.shape[1])})
        return cols

    # ---- pass 1: device-resident, watching the residency budget ----
    first_rounds = itertools.chain(sample, rounds)
    final, overflow = run_mesh_pass(first_rounds, None, None, False, True,
                                    watch_budget=reread is not None)
    finish = finish_count_fn(mesh, L, cfg.histo_max)
    histo_acc = np.zeros((cfg.histo_max + 1,), np.int64)

    def finish_range(final_pair, amin_val):
        stk, n_np = final_pair
        s_stk, n_sol_d, h_d = finish(
            stk, jnp.asarray(n_np.astype(np.int32)),
            jnp.asarray(amin_val, jnp.int32),
            jnp.asarray(cfg.abundance_max, jnp.int32))
        return s_stk, np.asarray(n_sol_d), np.asarray(h_d)

    if overflow:
        # ---- multi-pass key ranges (the mesh OOC path): force-merge
        # what's resident, sample global pivots, restart with P ranges
        # re-read from the input ----
        while len(dev_partials) > 1:
            b = dev_partials.pop()
            a = dev_partials.pop()
            dev_partials.append(merge_two_dev(a, b))
        part = dev_partials.pop()
        d_now = int(part[1].sum())
        seen = max(1, int(totals[1]))
        total_est = max(cfg.est_total_occ, 2 * seen, seen)
        proj = d_now * (total_est / seen)
        n_ranges = int(np.clip(
            np.ceil(1.5 * proj / (budget_dev * n_dev)), 2, 64))
        cols = pivots_from_partials(part)
        dev_partials.clear()
        del part
        step = max(1, len(cols) // n_ranges)
        pivots = [np.asarray(cols[j], np.uint32)
                  for j in range(step - 1, len(cols) - 1, step)][:n_ranges - 1]
        bounds = ([np.zeros((L,), np.uint32)] + pivots
                  + [np.full((L,), count_op.SENTINEL, np.uint32)])
        totals[:] = 0   # recounted from scratch on the ranged passes
        per_dev_solid = [[] for _ in range(n_dev)]
        for r in range(len(bounds) - 1):
            rounds_r = iter_global_blocks(reread(), k, n_dev, block_reads,
                                          cfg.max_len)
            final_r, over_r = run_mesh_pass(
                rounds_r, bounds[r], bounds[r + 1], True, r == 0,
                watch_budget=False)
            if final_r is None:
                continue
            n_res = int(final_r[1].max())
            if n_res > 2 * budget_dev:
                raise RuntimeError(
                    f"mesh key range still exceeds 2x the per-device "
                    f"residency budget ({n_res} > 2*{budget_dev}); "
                    f"raise -max-memory or use fewer ranges/devices")
            s_stk, n_sol, h_np = finish_range(final_r, cfg.abundance_min)
            histo_acc += h_np.astype(np.int64)
            stk_np = np.asarray(s_stk)
            capF = stk_np.shape[1] // n_dev
            for d in range(n_dev):
                sl = stk_np[:, d * capF:(d + 1) * capF]
                keep = sl[L].astype(np.int32) >= max(1, cfg.abundance_min)
                per_dev_solid[d].append(sl[:, keep])
            del s_stk, stk_np
        per_dev = [np.concatenate(parts, axis=1) if parts
                   else np.zeros((L + 2, 0), np.uint32)
                   for parts in per_dev_solid]
        histo = np.minimum(histo_acc, 2**31 - 1).astype(np.int32)
        if auto_amin_cap is not None:
            # auto cutoff with multi-pass: derived from the accumulated
            # histogram, applied on host (ranges already fetched)
            cfg.abundance_min = eng.auto_abundance_min(histo, auto_amin_cap)
            for d in range(n_dev):
                keepd = per_dev[d][L].astype(np.int32) >= cfg.abundance_min
                per_dev[d] = per_dev[d][:, keepd]
        n_solid_np = np.asarray([p.shape[1] for p in per_dev], np.int64)
        # rebuild the sharded stacked layout for device-side compaction
        capS = eng._round_capacity(max(16, int(n_solid_np.max())))
        stk_host = np.zeros((L + 2, n_dev * capS), np.uint32)
        stk_host[:L] = count_op.SENTINEL
        stk_host[L + 1] = count_op.SENTINEL
        for d in range(n_dev):
            n_d = per_dev[d].shape[1]
            stk_host[:, d * capS: d * capS + n_d] = per_dev[d]
        solid_stk = jax.device_put(
            stk_host, jax.sharding.NamedSharding(mesh, P(None, AXIS)))
        amin = cfg.abundance_min
    else:
        if final is None:
            return eng.UnitigSet(
                k=k, seqs=[], kc=np.zeros(0, np.int64), abundances=[],
                circular=np.zeros(0, bool), links=[],
                stats={"solid_kmers": 0})
        amin = cfg.abundance_min
        if auto_amin_cap is not None:
            # histogram first (amin=1 pass), derive the cutoff, re-finish
            _, _, histo_d = finish(
                final[0], jnp.asarray(final[1].astype(np.int32)),
                jnp.asarray(1, jnp.int32),
                jnp.asarray(2**31 - 1, jnp.int32))
            cfg.abundance_min = eng.auto_abundance_min(
                np.asarray(histo_d), auto_amin_cap)
            amin = cfg.abundance_min
        solid_stk, n_solid_np, histo = finish_range(final, amin)
        histo = histo.astype(np.int32)

    if store is not None:
        # ONE host fetch of the folded solid run (store checkpoint only)
        stk_np = np.asarray(solid_stk)
        counts_np = stk_np[L].astype(np.int32)
        keep = counts_np >= max(1, amin)
        store.write_counts(
            stk_np[:L, keep], counts_np[keep],
            k, histogram=histo, minpos=stk_np[L + 1, keep],
            config={"abundance_min": cfg.abundance_min,
                    "abundance_max": cfg.abundance_max,
                    "solidity_kind": "sum"})
        store.write_repartition(table, freq_rank, m)

    sizes = [int(x) for x in n_solid_np]
    mean_sz = max(1.0, float(np.mean(sizes)))
    stats = {
        "devices": n_dev,
        "device_load_imbalance": float(max(sizes)) / mean_sz,
        "minimizer_size": m,
        "minimizer_type": mcfg.minimizer_type,
        "repartition_type": mcfg.repartition_type,
        "exchange_cap_retries": retries,
        "ooc_ranges": (len(bounds) - 1) if overflow else 1,
        "ooc_passes": (len(bounds)) if overflow else 1,
        "exchange_ladder_hits": ladder.hits,
        "exchange_max_share": round(max_share, 4),
        "abundance_min": cfg.abundance_min,
        "kmer_occurrences": int(totals[1]),
        "superkmers": int(totals[2]),
        "mean_superkmer_span": (float(totals[1]) / max(1, int(totals[2]))),
        # exchange words per routed k-mer occurrence: packed superkmer
        # words + span word + position word vs. the L+1 words/occurrence
        # of per-k-mer routing — the traffic cut superkmers buy
        "exchange_words_per_kmer": (
            float(int(totals[2]) * (skm_span_words(k, max_span) + 1))
            / max(1, int(totals[1]))),
    }
    n_solid = int(n_solid_np.sum())
    if n_solid == 0:
        return eng.UnitigSet(
            k=k, seqs=[], kc=np.zeros(0, np.int64), abundances=[],
            circular=np.zeros(0, bool), links=[],
            stats=dict(stats, solid_kmers=0), histogram=histo)
    us = distcompact.distributed_compact_dev(mesh, solid_stk, n_solid_np, k)
    us.histogram = histo
    us.stats.update(stats)
    us.stats["unitigs"] = len(us.seqs)
    return us


def skm_span_words(k: int, max_span: int) -> int:
    from bcalm_tpu.ops import superkmer as skm

    return skm.span_words(k, max_span)
