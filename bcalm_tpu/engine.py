"""Single-chip end-to-end pipeline: reads -> compacted unitigs + links.

The accelerator analog of GraphUnitigsTemplate<span>::create(input, false)
(/root/reference/src/bcalm_1.cpp:52-57), which in the reference drives
bank -> DSK counting -> bcalm2 -> bglue -> links (SURVEY.md §4).  Here the
stages are:

  1. host packing (io.packing)        ~ gatb bank + Sequence2SuperKmer
  2. device extraction (ops.extract)  ~ ModelCanonical/ModelMinimizer loops
  3. device counting  (ops.count)     ~ SortingCountAlgorithm (DSK)
  4. device junctions (ops.junctions) ~ bcalm2 bucket compaction decisions
  5. device chains    (ops.chains)    ~ bglue union-find + chain walking
  6. host assembly + link join        ~ glue concatenation + LinkTigs

Stages 4-5 use fixed capacities: the host reads back the solid-k-mer count
and re-slices device arrays to the next power of two, bounding the set of
compiled shapes (the analog of the reference's KSIZE_LIST/partition-count
static configuration).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from bcalm_tpu.io import packing
from bcalm_tpu.models import lanes as ln
from bcalm_tpu.ops import chains as chains_op
from bcalm_tpu.ops import count as count_op
from bcalm_tpu.ops import extract as extract_op
from bcalm_tpu.ops import junctions as junctions_op
from bcalm_tpu.utils import dna


class CompactionOOM(RuntimeError):
    """Device allocator exhausted during compaction AFTER the counted
    solid set was checkpointed to the store — the run is resumable with
    `-skip-bcalm` in a fresh process (clean allocator)."""


def _is_resource_exhausted(e: BaseException) -> bool:
    # PJRT surfaces allocator death as a runtime error whose message
    # starts with the status code RESOURCE_EXHAUSTED (the GPU allocator:
    # "RESOURCE_EXHAUSTED: Out of memory while trying to allocate ...");
    # match on text so no backend-specific exception types are imported
    s = f"{type(e).__name__}: {e}"
    return "RESOURCE_EXHAUSTED" in s or "ResourceExhausted" in s


@dataclass
class EngineConfig:
    k: int = 31
    abundance_min: int = 2
    abundance_max: int = 2**31 - 1
    block_reads: int = 4096
    max_len: int = 512
    histo_max: int = 10000
    # counting chunk size in k-mer slots: bounds device memory (the analog
    # of the reference's -max-memory driven pass/partition sizing, gatb
    # ConfigurationAlgorithm).  lax.sort cost per slot grows with the
    # chunk, so the chunk stays far under device memory limits.
    chunk_kmers: int = 8 * 1024 * 1024
    # device-resident budget (in k-mer SLOTS) for settled distinct runs.
    # Datasets whose distinct set exceeds it are counted in MULTIPLE
    # PASSES over the input, one key range per pass, each range fully
    # device-resident (the device analog of DSK's pass x partition disk
    # staging, gatb ConfigurationAlgorithm; legacy -dsk-memory/-dsk-disk
    # at /root/reference/src/bcalm_1.cpp:22-23).  Ranges split adaptively
    # at the live median key when residency overflows mid-pass.
    resident_kmers: int = 64 * 1024 * 1024
    # multi-pass input staging: when re-reading the input is impossible
    # (one-shot block iterator) the packed blocks are cached — in host RAM,
    # or memmap-backed under spill_dir when set (the `-max-disk` disk
    # staging analog, /root/reference/README.md:103).  max_disk_mb bounds
    # the staging file (0 = unbounded).
    spill_dir: Optional[str] = None
    max_disk_mb: int = 0
    # caller's estimate of total k-mer occurrences (bank estimator / file
    # sizes); sharpens the rarefaction-based partition-count choice on
    # pass 1 (0 = unknown: assume twice the stream seen so far)
    est_total_occ: int = 0
    # multi-pass device-side packed-block cache budget (MB): later passes
    # re-read the input from device memory instead of re-crossing the
    # host link.  0 disables.  Packed reads are ~0.27 B/base, so the
    # default covers ~1.9 Gbp of input.
    dev_block_cache_mb: int = 512


@dataclass
class UnitigSet:
    """Engine output: the compacted bi-directed de Bruijn graph."""

    k: int
    seqs: List[str]
    kc: np.ndarray                # (U,) total k-mer abundance per unitig
    abundances: List[np.ndarray]  # per-k-mer abundances along each unitig
    circular: np.ndarray          # (U,) bool
    links: List[Tuple[int, str, int, str]] = field(default_factory=list)
    histogram: Optional[np.ndarray] = None
    stats: Dict = field(default_factory=dict)
    chain_info: Optional[Dict] = None  # raw chain decomposition (checkpoint)

    @property
    def km(self) -> np.ndarray:
        return self.kc / np.maximum(1, np.array([len(a) for a in self.abundances]))


def configure_chunk(cfg: EngineConfig, max_memory_mb: int) -> int:
    """Derive the counting chunk size from a device-memory budget — the
    analog of gatb ConfigurationAlgorithm turning -max-memory/-max-disk
    into pass/partition counts (SURVEY.md §3.2).

    Budget model: half the budget buys chunk workspace (a chunk slot costs
    L u32 for the key plus ~4x workspace: sort double-buffering, group ids,
    segment sums, scatter output).  The residency budget must ALSO
    reserve the LSM merge transient: merging two runs of capacity c
    sorts a 2c concat with L+2 u32 operands double-buffered — ~(L+2)*16
    bytes per slot of the larger run, on top of the (L+1)*4 the resident
    rows themselves hold (with <=2x pow2 slack).  Runs past the
    residency budget go multi-pass (out-of-core key ranges).
    """
    if max_memory_mb and max_memory_mb > 0:
        L = ln.num_lanes(cfg.k)
        budget = max_memory_mb * 1_000_000
        # the multi-pass device block cache holds HBM through every
        # pass-end merge transient: reserve it out of the budget (or
        # shrink it to fit small budgets) before sizing slots
        cache_bytes = cfg.dev_block_cache_mb * 1_000_000
        if cache_bytes > budget // 4:
            cfg.dev_block_cache_mb = (budget // 4) // 1_000_000
            cache_bytes = cfg.dev_block_cache_mb * 1_000_000
        budget -= cache_bytes
        bytes_per_slot = 4 * L * 4  # lanes * workspace factor * sizeof(u32)
        slots = (budget // 2) // bytes_per_slot
        # cap at 2^24: sort cost is superlinear per slot, and larger
        # chunks stop paying once LSM merge traffic is amortized
        cfg.chunk_kmers = int(max(1 << 20, min(slots, 1 << 24)))
        # x80/slot: (L+1)*4 resident bytes with <=2x pow2 slack, plus the
        # final-merge transient of ~2x-the-range concat sorted with L+2
        # operands double-buffered; x40 ran out of memory at pass-end
        # merges, x80 leaves headroom
        res_slots = budget // ((L + 2) * 80)
        # the residency floor is 2 chunks (a chunk's distinct must fit);
        # if the budget sits below two chunks, SHRINK the chunk class
        # instead of silently raising residency past the budget (the
        # raised floor re-created the over-budget merge transients)
        while (cfg.chunk_kmers > (1 << 21)
               and res_slots < 2 * _round_capacity(cfg.chunk_kmers)):
            cfg.chunk_kmers //= 2
        cfg.resident_kmers = int(
            max(2 * _round_capacity(cfg.chunk_kmers),
                min(res_slots, 1 << 31))
        )
    return cfg.chunk_kmers


def _round_capacity(n: int) -> int:
    """Round up to the next power of two (>= 16) to bound compiled shapes."""
    c = 16
    while c < n:
        c *= 2
    return c


from functools import partial as _partial


@jax.jit
def _refold_tail(unique, n_u):
    """Re-sentinel columns at index >= n_u (compact() zero-fills them)."""
    idx = jnp.arange(unique.shape[1], dtype=jnp.int32)
    return jnp.where((idx < n_u)[None], unique, count_op.SENTINEL)


@jax.jit
def _refold_tail1(arr, n_u):
    """1-D variant of _refold_tail (for the first-occurrence key row)."""
    idx = jnp.arange(arr.shape[0], dtype=jnp.int32)
    return jnp.where(idx < n_u, arr, count_op.SENTINEL)


@_partial(jax.jit, donate_argnums=(0,))
def _chunk_insert(buf, piece, offset):
    """Write a fixed-size folded block into the chunk buffer at a traced
    offset (single compiled shape regardless of fill level).

    The buffer is DONATED: XLA updates it in place instead of copying the
    whole (L, chunk_cap) allocation per block insert (the caller always
    rebinds its reference to the result)."""
    return jax.lax.dynamic_update_slice(buf, piece, (0, offset))


@_partial(jax.jit, static_argnames=("k",))
def _extract_fold(words, lengths, k, slot_base=np.uint32(0)):
    """One-jit per-block frontend: extract + canonicalize + sentinel-fold.

    Keeping this a single compiled call matters: eager per-op dispatch
    pays host overhead per primitive.

    The last folded row is the first-occurrence key of each slot,
    ((slot_base + stream slot index) << 1) | rc-strand: chain-adjacent
    k-mers get adjacent keys, which ops.runchains turns into contraction
    locality.  Key wraparound past 2^31 slots only degrades that locality,
    never correctness."""
    canon, valid, use_rc = extract_op.extract_canonical(
        words, lengths, k, with_strand=True)
    # positions past W*16-k can never hold a k-mer: slice them off so the
    # chunk sorts never see those sentinel slots (k-1 columns, ~20% at
    # typical short-read lengths)
    P_eff = max(1, canon.shape[2] - (k - 1))
    canon = canon[:, :, :P_eff]
    valid = valid[:, :P_eff]
    use_rc = use_rc[:, :P_eff]
    L = canon.shape[0]
    F = canon.shape[1] * P_eff
    slot = slot_base + jnp.arange(F, dtype=jnp.uint32)
    pos = (slot << np.uint32(1)) | use_rc.reshape(-1).astype(jnp.uint32)
    # the all-ones value is the fold sentinel: a genuine first-occurrence
    # key must never equal it (slot wraparound at >2^31 stream slots
    # could otherwise silently drop one solid k-mer via the fold filter)
    pos = jnp.minimum(pos, np.uint32(0xFFFFFFFE))
    rows = jnp.concatenate([canon.reshape(L, -1), pos[None]], axis=0)
    folded = count_op.fold_sentinel(rows, valid.reshape(-1))
    return folded, jnp.sum(valid.astype(jnp.int32))


def block_slots(words_shape, k: int) -> int:
    """Folded slots _extract_fold emits for a (B, W) block (host-side
    mirror of its P_eff slicing, so callers can track chunk fill without
    a device round trip)."""
    B, W = words_shape
    return B * max(1, W * packing.BASES_PER_WORD - (k - 1))


@_partial(jax.jit, static_argnames=("k",), donate_argnums=(0,))
def _extract_insert(buf, words, lengths, k, slot_base, offset):
    """Fused per-block frontend: extract + fold + chunk insert in ONE
    dispatch (the two-call extract/insert pair cost a second dispatch per
    block).  The chunk buffer is DONATED: XLA updates it in place."""
    canon, valid, use_rc = extract_op.extract_canonical(
        words, lengths, k, with_strand=True)
    P_eff = max(1, canon.shape[2] - (k - 1))
    canon = canon[:, :, :P_eff]
    valid = valid[:, :P_eff]
    use_rc = use_rc[:, :P_eff]
    L = canon.shape[0]
    F = canon.shape[1] * P_eff
    slot = slot_base + jnp.arange(F, dtype=jnp.uint32)
    pos = (slot << np.uint32(1)) | use_rc.reshape(-1).astype(jnp.uint32)
    # the all-ones value is the fold sentinel: a genuine first-occurrence
    # key must never equal it (slot wraparound at >2^31 stream slots
    # could otherwise silently drop one solid k-mer via the fold filter)
    pos = jnp.minimum(pos, np.uint32(0xFFFFFFFE))
    rows = jnp.concatenate([canon.reshape(L, -1), pos[None]], axis=0)
    folded = count_op.fold_sentinel(rows, valid.reshape(-1))
    return jax.lax.dynamic_update_slice(buf, folded, (0, offset))


def _lanes_to_records(lanes_np: np.ndarray) -> np.ndarray:
    """Lane-major (L, N) uint32 -> (N,) structured array whose record
    compare is the lexicographic k-mer order (numpy compares structured
    dtypes field by field, so sorted runs stay sorted and searchsorted
    gives exact key-range boundaries)."""
    L = lanes_np.shape[0]
    rec = np.empty(lanes_np.shape[1],
                   dtype=np.dtype([(f"l{j}", np.uint32) for j in range(L)]))
    for j in range(L):
        rec[f"l{j}"] = lanes_np[j]
    return rec


def _host_range_merge(lanes_np: np.ndarray, counts_np: np.ndarray,
                      pos_np: Optional[np.ndarray] = None):
    """Merge one key-range's concatenated run slices on the HOST (weighted
    dedup via lexsort + reduceat).

    The out-of-core data already lives in host RAM; a device round-trip
    per range would move every range over the host link twice.  numpy
    lexsort at <= chunk-size ranges touches no device."""
    L, n = lanes_np.shape
    order = np.lexsort(tuple(lanes_np[j] for j in reversed(range(L))))
    lanes = lanes_np[:, order]
    counts = counts_np[order]
    pos = pos_np[order] if pos_np is not None else None
    first = np.ones(n, bool)
    if n > 1:
        first[1:] = np.any(lanes[:, 1:] != lanes[:, :-1], axis=0)
    starts = np.nonzero(first)[0]
    agg = np.add.reduceat(counts.astype(np.int64), starts)
    out_c = np.minimum(agg, 2**31 - 1).astype(np.int32)
    out_p = (np.minimum.reduceat(pos, starts) if pos is not None else None)
    return lanes[:, starts], out_c, out_p


def merge_host_runs(runs, merge_cap: int):
    """Out-of-core merge: sorted distinct (lanes, counts) host runs ->
    one globally sorted distinct (lanes, counts) host pair, merging
    duplicates across runs by summing counts.

    The analog of DSK's multi-pass partition merge (gatb
    SortingCountAlgorithm pass x partition staging — SURVEY.md §3.2): the
    key space is split into ranges small enough that each range's slices
    (contiguous in every sorted run) fit one bounded host merge.  Exact
    pivots via structured-dtype searchsorted; a range is unsplittable only
    when every entry shares one full key, which is capped by the run count
    (each run holds distinct k-mers), so termination is guaranteed.

    Runs may be (lanes, counts) pairs or (lanes, counts, pos) triples; the
    first-occurrence keys are merged by min (the pos sort-key trick in
    count_canonical) when every run carries them.

    Returns (lanes_np (L, n), counts_np (n,), pos_np-or-None, n_ranges).
    """
    runs = [r for r in runs if r[1].size]
    if not runs:
        return None, None, None, 0
    has_pos = all(len(r) >= 3 and r[2] is not None for r in runs)
    runs = [(r[0], r[1], r[2] if has_pos else None) for r in runs]
    L = runs[0][0].shape[0]
    recs = [_lanes_to_records(u) for u, _, _ in runs]
    merge_cap = max(1 << 10, merge_cap)
    out_l: list = []
    out_c: list = []
    out_p: list = []
    n_ranges = 0
    # stack of ranges (per-run [lo, hi) boundaries), rightmost key range
    # pushed first so ranges are emitted in ascending key order
    stack = [[(0, r.size) for r in recs]]
    while stack:
        bounds = stack.pop()
        size = sum(hi - lo for lo, hi in bounds)
        if size == 0:
            continue
        if size > merge_cap:
            # sample keys across the range, pick a splitting pivot
            samples = []
            for r, (lo, hi) in zip(recs, bounds):
                if hi > lo:
                    step = max(1, (hi - lo) // 64)
                    samples.append(r[lo:hi:step])
            cand = np.unique(np.concatenate(samples))
            if cand.size < 2:
                # sampling found one key; scan the range exactly (rare)
                cand = np.unique(
                    np.concatenate([r[lo:hi] for r, (lo, hi)
                                    in zip(recs, bounds) if hi > lo]))
            if cand.size >= 2:
                pivot = cand[cand.size // 2]
                if pivot == cand[0]:
                    pivot = cand[1]
                left, right = [], []
                for r, (lo, hi) in zip(recs, bounds):
                    mid = lo + int(np.searchsorted(r[lo:hi], pivot,
                                                   side="left"))
                    left.append((lo, mid))
                    right.append((mid, hi))
                stack.append(right)
                stack.append(left)
                continue
            # cand.size == 1: every entry shares one key (size <= n_runs
            # <= merge_cap in practice); fall through and merge as-is
        lanes_np = np.concatenate(
            [u[:, lo:hi] for (u, _, _), (lo, hi) in zip(runs, bounds)],
            axis=1)
        counts_np = np.concatenate(
            [c[lo:hi] for (_, c, _), (lo, hi) in zip(runs, bounds)])
        pos_np = (np.concatenate(
            [p[lo:hi] for (_, _, p), (lo, hi) in zip(runs, bounds)])
            if has_pos else None)
        ml, mc, mp = _host_range_merge(lanes_np, counts_np, pos_np)
        out_l.append(ml)
        out_c.append(mc)
        out_p.append(mp)
        n_ranges += 1
    lanes = (np.concatenate(out_l, axis=1) if out_l
             else np.zeros((L, 0), np.uint32))
    counts = (np.concatenate(out_c) if out_c else np.zeros((0,), np.int32))
    pos = (np.concatenate(out_p) if (has_pos and out_p) else None)
    return lanes, counts, pos, n_ranges


def _lex_lt(lanes, bound):
    """Columnwise lexicographic lanes[:, i] < bound over L uint32 lanes."""
    L = lanes.shape[0]
    lt = jnp.zeros(lanes.shape[1], bool)
    eq = jnp.ones(lanes.shape[1], bool)
    for j in range(L):
        lt = lt | (eq & (lanes[j] < bound[j]))
        eq = eq & (lanes[j] == bound[j])
    return lt


@jax.jit
def _count_chunk_ranged(body, lo, hi):
    """One fused chunk-count program: sentinel-fold columns whose key
    lanes fall outside [lo, hi), then count (a separate fold program
    would cost one extra dispatch per chunk).  body is (L+1, N): L key
    lanes + the pos row.
    The sentinel key is all-ones which is >= any hi, so already-invalid
    slots stay folded.

    Returns (unique, counts, n_and_occ, minpos) with n_and_occ a stacked
    (2,) int32 of [n_unique, in-range occurrence count] — one host fetch
    serves both the capacity trim and the rarefaction estimator."""
    L = body.shape[0] - 1
    keys = body[:-1]
    keep = ~_lex_lt(keys, lo) & _lex_lt(keys, hi)
    body = jnp.where(keep[None], body, count_op.SENTINEL)
    valid = ~jnp.all(body[:L] == count_op.SENTINEL, axis=0)
    unique, counts, n_unique, minpos = count_op.count_canonical(
        body[:L], valid, pos=body[L], with_pos=True)
    occ = jnp.sum(valid.astype(jnp.int32))
    return unique, counts, jnp.stack([n_unique, occ]), minpos


@jax.jit
def _count_chunk_plain(body):
    """Chunk count with NO range fold — the resident fast path.  The
    identity fold in _count_chunk_ranged (two lexicographic comparisons
    plus a (L+1, N) where) is a full pass over the chunk; flush() only
    pays it once a key-range constraint is actually active."""
    L = body.shape[0] - 1
    valid = ~jnp.all(body[:L] == count_op.SENTINEL, axis=0)
    unique, counts, n_unique, minpos = count_op.count_canonical(
        body[:L], valid, pos=body[L], with_pos=True)
    occ = jnp.sum(valid.astype(jnp.int32))
    return unique, counts, jnp.stack([n_unique, occ]), minpos


@jax.jit
def _count_lt(lanes, bound):
    """Number of (sorted, sentinel-tailed) run columns with key < bound."""
    return jnp.sum(_lex_lt(lanes, bound).astype(jnp.int32))


@jax.jit
def _settle_n(unique, n_dev, hi):
    """Valid-prefix length of a freshly counted run under a (possibly
    just-shrunk) exclusive hi bound.  The run is sorted ascending over its
    first n_dev columns with a ZERO tail (count_canonical zero-fills), so
    the index mask is required — zeros compare < hi."""
    idx = jnp.arange(unique.shape[1], dtype=jnp.int32)
    keep = (idx < n_dev) & _lex_lt(unique, hi)
    return jnp.sum(keep.astype(jnp.int32))


def _fetch_capacity(n: int) -> int:
    """Fetch-buffer capacity class: next power of two, or 3*2^(j-1) when
    that suffices (<=33% transfer overhead vs <=100% for pure pow2, at
    the cost of one extra compiled copy-program class per size)."""
    c = _round_capacity(n)
    if c >= 32 and 3 * (c // 4) >= n:
        return 3 * (c // 4)
    return c


@_partial(jax.jit, static_argnames=("capf",))
def _pack_fetch(u, c, p, capf: int):
    """Stack a trimmed run into one (L+2, capf) uint32 buffer for a single
    device->host transfer (counts are non-negative, so the uint32 view is
    lossless)."""
    return jnp.concatenate(
        [u[:, :capf], c[:capf].astype(jnp.uint32)[None], p[:capf][None]],
        axis=0)


class _BlockCache:
    """Staging for multi-pass re-reads of packed blocks: host RAM, or a
    memmap-backed file under spill_dir (the `-max-disk` staging analog of
    the reference's _gatb/ temp partitions, /root/reference/README.md:103).
    max_disk_mb bounds the staging file size (0 = unbounded)."""

    def __init__(self, spill_dir: Optional[str] = None, max_disk_mb: int = 0):
        self.spill_dir = spill_dir
        self.max_disk_mb = max_disk_mb
        self._mem: list = []
        self._meta: list = []       # (B, W, offset) per block
        self._file = None
        self._path = None
        self._bytes = 0

    def add(self, words: np.ndarray, lengths: np.ndarray):
        if self.spill_dir is None:
            self._mem.append((words, lengths))
            return
        if self._file is None:
            import os
            import tempfile
            os.makedirs(self.spill_dir, exist_ok=True)
            fd, self._path = tempfile.mkstemp(
                suffix=".blocks", dir=self.spill_dir)
            self._file = os.fdopen(fd, "wb")
        B, W = words.shape
        self._meta.append((B, W, self._bytes))
        data = words.astype(np.uint32).tobytes() \
            + lengths.astype(np.int32).tobytes()
        self._bytes += len(data)
        if self.max_disk_mb and self._bytes > self.max_disk_mb * 1_000_000:
            raise RuntimeError(
                f"-max-disk exceeded: block staging needs "
                f">{self._bytes >> 20} MB (limit {self.max_disk_mb} MB)")
        self._file.write(data)

    def blocks(self) -> Iterator[packing.ReadBlock]:
        if self.spill_dir is None:
            for words, lengths in self._mem:
                yield packing.ReadBlock(words, lengths)
            return
        self._file.flush()
        mm = np.memmap(self._path, dtype=np.uint8, mode="r")
        for B, W, off in self._meta:
            nw = B * W * 4
            words = np.frombuffer(
                mm, np.uint32, count=B * W, offset=off).reshape(B, W)
            lengths = np.frombuffer(mm, np.int32, count=B, offset=off + nw)
            yield packing.ReadBlock(words, lengths)

    def close(self):
        if self._file is not None:
            import os
            self._file.close()
            try:
                os.unlink(self._path)
            except OSError:
                pass
            self._file = None


def count_blocks(blocks: Iterable[packing.ReadBlock], cfg: EngineConfig,
                 reread=None):
    """Extract + count canonical k-mers over all blocks, chunked.

    Memory-bounded streaming: extraction output accumulates into
    fixed-size chunks of cfg.chunk_kmers occurrence slots; each full chunk
    is counted/deduped on-device (one compiled shape, reused); the
    per-chunk distinct runs LSM-merge on-device so residency tracks the
    distinct set.

    Out-of-core (the device analog of DSK's pass x partition disk
    staging, gatb SortingCountAlgorithm/ConfigurationAlgorithm —
    SURVEY.md §3.2): when the distinct set outgrows cfg.resident_kmers
    device slots, counting becomes MULTI-PASS over key ranges.  The
    current range splits at the live median key of its largest resident
    run (dropping the upper half and queueing it for a later pass), so
    every range ends fully device-resident and every distinct k-mer
    crosses the host link exactly once, as an exact-size ASYNC fetch that
    overlaps the next pass's compute.  Later passes re-read the input:
    via reread()
    when given, else from a packed-block cache (host RAM, or memmap under
    cfg.spill_dir honoring cfg.max_disk_mb — the `-max-disk` analog).

    Every distinct k-mer also carries its FIRST-OCCURRENCE key
    ((stream slot << 1) | rc-strand, min over occurrences): the locality
    order ops.runchains compacts in.  It rides the sorts as one extra
    operand; see count_canonical.

    Returns (unique, counts, minpos, n_unique, stats) — device arrays
    sorted and compacted to the front (globally sorted host arrays of
    exact size on the multi-pass path; stats carries "ooc_passes").
    """
    L = ln.num_lanes(cfg.k)
    chunk_buf = None   # (L+1, chunk_cap + block_F) device buffer (+pos row)
    chunk_cap = None   # power-of-two counting capacity
    block_F = None     # folded slots per block (fixed block geometry)
    chunk_fill = 0
    slot_base = 0                     # global stream slot counter (pos keys)
    partials = []            # (unique, counts, minpos, n, gen) per chunk
    pending = None                # last chunk's (unique, counts, minpos, n)
    resident_slots = 0                # sum of pow2 caps held in `partials`
    n_reads = 0
    n_bases = 0
    n_occ = 0

    # ---- multi-pass key-range state ----
    lo_np = np.zeros((L,), np.uint32)
    hi_np = np.full((L,), count_op.SENTINEL, np.uint32)
    lo_d = jnp.asarray(lo_np)
    hi_d = jnp.asarray(hi_np)
    range_stack: list = []   # pending (lo, hi) ranges, ascending on pop
    results: list = []       # finished ranges: (fetch buf | np triple, n)
    cache = _BlockCache(cfg.spill_dir, cfg.max_disk_mb) if reread is None \
        else None
    pass_no = 0
    did_split = False
    # stage-timing accumulators (seconds) — surfaced as stats["timing"],
    # the per-stage observability the OOC path needs (A1: TimeInfo analog)
    import time as _time
    tm = {"settle_wait": 0.0, "split": 0.0, "final_merge": 0.0,
          "fetch_wait": 0.0, "passes": []}

    def trim(unique, counts, minpos, n_u):
        """Slice a distinct run to a POWER-OF-2 capacity (bounded compile
        shapes — a :n_u slice would compile per distinct count) and refill
        the tail with the sentinel so downstream validity tests hold."""
        cap = _round_capacity(max(1, n_u))
        n_d = jnp.asarray(n_u, jnp.int32)
        u = _refold_tail(unique[:, :cap], n_d)
        p = _refold_tail1(minpos[:cap], n_d)
        return u, counts[:cap], p, n_u

    def merge_two(a, b):
        """Weighted merge of two settled distinct runs on-device."""
        lanes = jnp.concatenate([a[0], b[0]], axis=1)
        weights = jnp.concatenate([a[1], b[1]])
        mpos = jnp.concatenate([a[2], b[2]])
        cap = _round_capacity(lanes.shape[1])
        pad = cap - lanes.shape[1]
        if pad:
            lanes = jnp.concatenate(
                [lanes, jnp.full((L, pad), count_op.SENTINEL, jnp.uint32)],
                axis=1)
            weights = jnp.concatenate(
                [weights, jnp.zeros((pad,), jnp.int32)])
            mpos = jnp.concatenate(
                [mpos, jnp.full((pad,), count_op.SENTINEL, jnp.uint32)])
        valid = ~jnp.all(lanes == count_op.SENTINEL, axis=0)
        unique, counts, n_unique, minpos = count_op.count_canonical(
            lanes, valid, weights=weights, weighted=True,
            pos=mpos, with_pos=True)
        return trim(unique, counts, minpos, int(n_unique))

    def merge_generations():
        """LSM-style compaction of the settled runs: merge equal-
        generation runs as the stream progresses, so residency tracks the
        DISTINCT set (O(log chunks) runs) instead of chunks x distinct."""
        nonlocal resident_slots
        while (len(partials) >= 2
               and partials[-1][4] == partials[-2][4]):
            b = partials.pop()
            a = partials.pop()
            resident_slots -= a[0].shape[1] + b[0].shape[1]
            merged = merge_two(a, b)
            partials.append(merged + (a[4] + 1,))
            resident_slots += merged[0].shape[1]

    refilter_pending = False   # a split happened since the last settle:
    # the in-flight pending chunk was counted under the OLD hi and must be
    # re-filtered when settled (else its upper-half keys double-count)
    t_seen = 0        # in-range occurrences settled this pass
    pass_occ_seen = 0  # ALL occurrences streamed so far this pass
    total_occ_known = 0  # exact stream total, known after pass 1

    def resident_n():
        return sum(r[3] for r in partials)

    def force_merge_all():
        """Merge ALL resident runs into one (exact distinct-so-far: the
        rarefaction estimate must not see cross-run duplicates, and the
        quantile pivots want the full key sample)."""
        nonlocal resident_slots
        while len(partials) > 1:
            b = partials.pop()
            a = partials.pop()
            resident_slots -= a[0].shape[1] + b[0].shape[1]
            merged = merge_two(a, b)
            partials.append(merged + (max(a[4], b[4]) + 1,))
            resident_slots += merged[0].shape[1]

    def _solve_G(m: float, t: float) -> float:
        """Effective key-universe size from m distinct at t occurrences:
        solve m = G*(1 - exp(-t/G)) ((1-e^-x)/x = m/t, decreasing in x)."""
        ratio = m / t
        lo_x, hi_x = 1e-6, 50.0
        for _ in range(60):
            mid = 0.5 * (lo_x + hi_x)
            if (1.0 - np.exp(-mid)) / mid > ratio:
                lo_x = mid
            else:
                hi_x = mid
        return t / (0.5 * (lo_x + hi_x))

    # saturation anchor for the CURRENT range: exact distinct + in-range
    # occ at the last full merge, plus the LEARNED dedup ratio rho =
    # (new distinct) / (new raw run mass) observed across that merge —
    # lets the overflow trigger use duplicate-corrected estimates
    # instead of the raw run-sum
    anchor = [0, 0, 1.0]   # [m_exact, t_at_merge, rho]

    def projected_distinct() -> int:
        """Duplicate-corrected estimate of the range's current distinct
        count.  resident_n() sums per-run distincts, which double-counts
        k-mers shared across runs; once a range saturates, that raw sum
        crosses the budget at EVERY settle and a raw-sum trigger would
        re-run the full merge after every chunk.  Anchored at the last
        exact merge (m0 at t0), project
        m(t) = G*(1-exp(-t/G)) and clamp to [m0, m0 + sum of new runs]
        (the true bounds)."""
        raw = resident_n()
        m0, t0 = anchor[0], anchor[1]
        if m0 <= 0 or t_seen <= t0:
            return raw
        if m0 >= 0.98 * t0:
            return raw           # duplicate-free so far: sum is exact-ish
        G = _solve_G(m0, t0)
        m_proj = G * (1.0 - np.exp(-t_seen / G))
        return int(min(max(m_proj, m0), raw))

    def split_current_range():
        """Partition the current key range when residency exceeds budget.

        The partition count comes from a saturation-model rarefaction
        estimate, not from reactive halving (which over-split 12x on the
        bigk51 bench — every new chunk re-triggered a median split):
        merge the residents (exact in-range distinct m at t in-range
        occurrences seen), solve m = G*(1 - exp(-t/G)) for the effective
        key-universe size G — exact for uniform sampling of a genome,
        and degrading to D ~ T for duplicate-free streams — project the
        final distinct count D = G*(1 - exp(-T/G)) at the estimated
        total in-range load T, choose P = ceil(D*slack/budget), and
        split ONCE at P-1 equal-distinct quantile keys of the merged run
        (the adaptive analog of DSK's sampling-based
        ConfigurationAlgorithm pass sizing).  Re-runs reactively if the
        kept range still overflows later.

        Triggers for the FULL merge + exact check:
        (1) the duplicate-corrected projection (projected_distinct)
            crossing the distinct budget;
        (2) the LEARNED-dedup estimate m0 + 1.2*rho*(raw - m0) crossing
            the budget, where rho is the (new distinct)/(new raw mass)
            ratio observed across the previous exact merge — this covers
            streams that defeat the i.i.d. rarefaction projection
            (positional genome scans look locally saturated, so the
            model can converge BELOW the true distinct count): a
            duplicate-free adversary keeps rho ~ 1 and re-checks right
            at the budget line, while a saturated range drives rho to
            the 2% floor and re-checks only once per ~budget/0.024 of
            new mass;
        (3) resident SLOTS crossing 8x the budget — a pure memory
            backstop.  It almost never fires: the LSM generation ladder
            (merge_generations) bounds steady-state slots at a few
            saturated run capacities (~4-6x budget) on its own, and the
            80 B/slot memory model (configure_chunk) covers that.
        A slots-based 3x valve here re-merged the dominant run once per
        ~chunk at 100M-distinct scale — the learned-dedup spacing keeps
        the exact checks amortized against the LSM ladder instead."""
        nonlocal hi_np, hi_d, resident_slots, did_split, refilter_pending
        nonlocal t_seen
        budget = max(cfg.resident_kmers, 2 * (chunk_cap or 0))
        if not partials:
            return
        raw = resident_n()
        m0 = anchor[0]
        est = m0 + 1.2 * anchor[2] * max(0, raw - m0)
        # 1.2x hysteresis on the re-check thresholds: once a range's
        # exact distinct sits just under the budget (the normal steady
        # state — split sizing fills ranges to ~87%), a threshold AT the
        # budget re-triggers the full merge on almost every settle.  Tolerating
        # a 20% overshoot before re-checking costs bounded memory (the
        # 80 B/slot model absorbs 2x) and keeps checks amortized; the
        # split condition itself stays at the budget.
        if (projected_distinct() <= 1.2 * budget
                and est <= 1.2 * budget
                and resident_slots <= 8 * budget):
            return
        _tm0 = _time.time()
        force_merge_all()
        tm["split_merge"] = round(
            tm.get("split_merge", 0.0) + _time.time() - _tm0, 3)
        tm["n_force_merges"] = tm.get("n_force_merges", 0) + 1
        m_new = resident_n()
        new_mass = max(1, raw - m0)
        anchor[2] = float(np.clip((m_new - m0) / new_mass, 0.02, 1.0))
        anchor[0] = m_new
        anchor[1] = t_seen
        if m_new <= 1.2 * budget:
            # under the tolerated overshoot (cross-run duplicate
            # inflation, or a range that sized slightly past the
            # budget): no split — the memory model absorbs 1.2x
            return
        tm["n_splits"] = tm.get("n_splits", 0) + 1
        # ---- project the range's final distinct count ----
        m2 = resident_n()
        t2 = max(1, t_seen)
        total_est = (total_occ_known or cfg.est_total_occ
                     or 2 * pass_occ_seen)
        total_est = max(total_est, pass_occ_seen)
        # in-range share of the remaining stream matches the share seen
        t_final = t2 * (total_est / max(1, pass_occ_seen))
        if m2 >= 0.98 * t2:
            d_est = t_final          # duplicate-free so far: D ~ T
        else:
            G = _solve_G(m2, t2)
            d_est = G * (1.0 - np.exp(-t_final / G))
        P = int(np.ceil(d_est * 1.15 / budget))
        if P <= 1 and resident_n() <= budget:
            return    # projection says the range fits after all
        P = max(2, min(256, P))
        # ---- quantile pivots from the (single) merged resident run ----
        biggest = max(partials, key=lambda r: r[3])
        u, _, _, n, _ = biggest
        qidx = np.unique(np.asarray(
            [(j * n) // P for j in range(1, P)], np.int64))
        qidx = qidx[(qidx > 0) & (qidx < n)]
        if qidx.size == 0:
            qidx = np.asarray([n // 2], np.int64)
        pivots_np = np.asarray(u[:, jnp.asarray(qidx)])   # (L, P-1) fetch
        pivots = []
        prev = tuple(lo_np)
        for j in range(pivots_np.shape[1]):
            cand = pivots_np[:, j]
            if tuple(cand) > prev and tuple(cand) < tuple(hi_np):
                pivots.append(cand.copy())
                prev = tuple(cand)
        if not pivots:
            # every resident key equals lo: a single distinct key cannot
            # exceed the budget; nothing to split
            return
        did_split = True
        refilter_pending = True
        bounds = pivots + [hi_np.copy()]
        for i in reversed(range(len(pivots))):
            range_stack.append((bounds[i], bounds[i + 1]))
        hi_np = pivots[0].copy()
        hi_d = jnp.asarray(hi_np)
        new_partials = []
        resident_slots = 0
        for (ru, rc, rp, rn, rgen) in partials:
            n_new = int(_count_lt(ru, hi_d))
            run = trim(ru, rc, rp, n_new)
            new_partials.append(run + (rgen,))
            resident_slots += run[0].shape[1]
        partials[:] = new_partials
        # the anchor referred to the pre-split range; re-anchor on the
        # kept range (its distinct is exact: one merged run, just
        # trimmed).  t_seen counted PRE-SPLIT in-range occurrences;
        # rescale it by the kept share so the saturation ratio and all
        # future (in-new-range) increments stay in one scope.
        anchor[0] = resident_n()
        t_seen = max(1, int(t_seen * anchor[0] / max(1, m2)))
        anchor[1] = t_seen
        anchor[2] = 1.0   # fresh learning for the narrowed range

    def settle_pending():
        """Materialize the PREVIOUS chunk's distinct count and trim it.

        Lagged by one chunk so the scalar fetch (a host<->device sync)
        overlaps with the next chunk's queued device work instead of
        stalling the pipeline after every chunk."""
        nonlocal pending, resident_slots, refilter_pending, t_seen
        if pending is not None:
            unique, counts, minpos, nw_dev = pending
            _t0 = _time.time()
            nw = np.asarray(nw_dev)
            tm["settle_wait"] += _time.time() - _t0
            n_eff = int(nw[0])
            t_seen += int(nw[1])
            if refilter_pending:
                n_eff = int(_settle_n(unique, nw[0], hi_d))
                refilter_pending = False
            run = trim(unique, counts, minpos, n_eff)
            partials.append(run + (0,))
            resident_slots += run[0].shape[1]
            pending = None
            merge_generations()
            _t0 = _time.time()
            split_current_range()
            tm["split"] += _time.time() - _t0

    def fresh_buf():
        # chunk_cap is a power of two (the sort's shape class); the extra
        # F columns are slack so block inserts never straddle — a flush
        # counts exactly [:chunk_cap] and carries the tail over
        return jnp.full((L + 1, chunk_cap + block_F), count_op.SENTINEL,
                        jnp.uint32)

    def range_active() -> bool:
        """A key-range constraint narrower than the full space is live."""
        return bool(np.any(lo_np != 0)
                    or np.any(hi_np != count_op.SENTINEL))

    def flush():
        nonlocal chunk_buf, chunk_fill, pending
        if chunk_fill == 0:
            return
        # partially-filled chunks (stream tail) count at the smallest
        # power-of-two capacity covering the fill — bounded shape classes
        body_cap = min(chunk_cap, _round_capacity(chunk_fill))
        if range_active():
            unique, counts, nw, minpos = _count_chunk_ranged(
                chunk_buf[:, :body_cap], lo_d, hi_d)
        else:
            unique, counts, nw, minpos = _count_chunk_plain(
                chunk_buf[:, :body_cap])
        # start the scalar transfer now: by the time settle_pending reads
        # it (next flush), the count has long finished — the read is free
        nw.copy_to_host_async()
        settle_pending()
        pending = (unique, counts, minpos, nw)
        leftover = max(0, chunk_fill - chunk_cap)
        tail = chunk_buf[:, chunk_cap:]
        chunk_buf = fresh_buf()
        if leftover:
            keep = (jnp.arange(block_F, dtype=jnp.int32)
                    < jnp.asarray(leftover, jnp.int32))
            tail = jnp.where(keep[None], tail, count_op.SENTINEL)
            chunk_buf = jax.lax.dynamic_update_slice(chunk_buf, tail, (0, 0))
        chunk_fill = leftover

    # device-side packed-block cache: (words_d, lengths_d, F, occ) per
    # block, filled on pass 1 while under budget.  Later passes then
    # re-read the input from HBM — no host-link crossing, no repacking.
    dev_cache: list = []
    dev_cache_bytes = 0
    dev_cache_ok = cfg.dev_block_cache_mb > 0

    def run_pass(block_iter, first_pass: bool):
        nonlocal chunk_buf, chunk_cap, block_F, chunk_fill, slot_base
        nonlocal n_reads, n_bases, n_occ, t_seen, pass_occ_seen
        nonlocal dev_cache_bytes, dev_cache_ok
        slot_base = 0
        chunk_fill = 0
        t_seen = 0
        pass_occ_seen = 0
        if chunk_buf is not None:
            chunk_buf = fresh_buf()

        def insert(words_d, lengths_d, F: int, occ: int):
            nonlocal chunk_buf, chunk_cap, block_F, chunk_fill, slot_base
            nonlocal pass_occ_seen
            if chunk_buf is None or F != block_F:
                if chunk_buf is not None:  # geometry change: drain buffer
                    flush()
                block_F = F
                # power-of-two capacity: the bitonic sort's shape class
                chunk_cap = _round_capacity(max(cfg.chunk_kmers, F))
                chunk_buf = fresh_buf()
                chunk_fill = 0
            pass_occ_seen += occ
            chunk_buf = _extract_insert(
                chunk_buf, words_d, lengths_d, cfg.k,
                np.uint32(slot_base & 0x7FFFFFFF),
                jnp.asarray(chunk_fill, jnp.int32))
            slot_base += F
            chunk_fill += F
            if chunk_fill >= chunk_cap:
                flush()

        if not first_pass and dev_cache_ok and dev_cache:
            for words_d, lengths_d, F, occ in dev_cache:
                insert(words_d, lengths_d, F, occ)
            flush()
            return
        for block in block_iter:
            if first_pass and cache is not None:
                cache.add(block.words, block.lengths)
            F = block_slots(block.words.shape, cfg.k)
            lens = block.lengths.astype(np.int64)
            occ = int(np.maximum(0, lens - cfg.k + 1).sum())
            if first_pass:
                n_reads += int((lens > 0).sum())
                n_bases += int(lens.sum())
                n_occ += occ
            words_d = jnp.asarray(block.words)
            lengths_d = jnp.asarray(block.lengths)
            if first_pass and dev_cache_ok:
                dev_cache_bytes += block.words.nbytes + block.lengths.nbytes
                if dev_cache_bytes > cfg.dev_block_cache_mb * 1_000_000:
                    dev_cache.clear()
                    dev_cache_ok = False
                else:
                    dev_cache.append((words_d, lengths_d, F, occ))
            insert(words_d, lengths_d, F, occ)
        flush()

    def final_range_run():
        """Merge this range's partials into one distinct run.  Returns
        (unique, counts, minpos, n_dev_or_int) — n left un-synced (device
        scalar) where the caller doesn't need it on host."""
        if pending is not None and not partials:
            unique, counts, minpos, nw_dev = pending
            return unique, counts, minpos, nw_dev[0]
        settle_pending()
        if not partials:
            empty = jnp.zeros((L, 16), dtype=jnp.uint32)
            return (empty, jnp.zeros((16,), jnp.int32),
                    jnp.full((16,), count_op.SENTINEL, jnp.uint32),
                    jnp.asarray(0, jnp.int32))
        group = [p[:4] for p in partials]
        partials.clear()
        if len(group) == 1:
            unique, counts, minpos, n_u = group[0]
            return unique, counts, minpos, jnp.asarray(n_u, jnp.int32)
        # merge the distinct runs with one weighted count (hierarchically
        # if the concatenation would exceed the chunk budget)
        while True:
            take = []
            acc = 0
            rest = []
            for p in group:
                # always take at least two (guarantees progress), then
                # respect the chunk budget
                if len(take) >= 2 and acc + p[3] > cfg.chunk_kmers:
                    rest.append(p)
                else:
                    take.append(p)
                    acc += p[3]
            lanes = jnp.concatenate([p[0] for p in take], axis=1)
            weights = jnp.concatenate([p[1] for p in take])
            mpos = jnp.concatenate([p[2] for p in take])
            cap = _round_capacity(lanes.shape[1])
            pad = cap - lanes.shape[1]
            if pad:
                lanes = jnp.concatenate(
                    [lanes,
                     jnp.full((L, pad), count_op.SENTINEL, jnp.uint32)],
                    axis=1)
                weights = jnp.concatenate(
                    [weights, jnp.zeros((pad,), jnp.int32)])
                mpos = jnp.concatenate(
                    [mpos, jnp.full((pad,), count_op.SENTINEL, jnp.uint32)])
            valid = ~jnp.all(lanes == count_op.SENTINEL, axis=0)
            unique, counts, n_unique, minpos = count_op.count_canonical(
                lanes, valid, weights=weights, weighted=True,
                pos=mpos, with_pos=True)
            if not rest:
                return unique, counts, minpos, n_unique
            merged = trim(unique, counts, minpos, int(n_unique))
            group = rest + [merged]

    def start_fetch(unique, counts, minpos, n: int):
        """Exact-class async device->host fetch of a finished range (one
        stacked buffer; the transfer overlaps the next pass's compute)."""
        capf = _fetch_capacity(max(1, n))
        cap_have = unique.shape[1]
        if cap_have < capf:  # single-chunk pending path: pad via trim
            u2, c2, p2, _ = trim(unique, counts, minpos, n)
            unique, counts, minpos = u2, c2, p2
        buf = _pack_fetch(unique, counts, minpos, capf)
        buf.copy_to_host_async()
        return buf

    def materialize(buf, n: int):
        arr = np.asarray(buf)
        return (arr[:L, :n].copy(),
                arr[L, :n].astype(np.int32),
                arr[L + 1, :n].copy())

    # ---- pass loop (try/finally: the block-staging file must not leak
    # when -max-disk aborts or any error escapes mid-pass) ----
    block_iter = iter(blocks)
    stats: Dict = {}
    try:
        while True:
            pass_no += 1
            first = pass_no == 1
            _tp = _time.time()
            if first:
                run_pass(block_iter, True)
            elif reread is not None:
                run_pass(reread(), False)
            else:
                run_pass(cache.blocks(), False)
            tm["passes"].append(round(_time.time() - _tp, 3))
            try:   # live HBM at pass end (allocator-wall diagnosis)
                ms = jax.local_devices()[0].memory_stats() or {}
                tm.setdefault("hbm_mb", []).append(
                    int(ms.get("bytes_in_use", 0)) >> 20)
            except Exception:   # noqa: BLE001 — backend may not expose it
                pass
            if first and not did_split and not range_stack:
                # everything resident: the single-pass fast path returns
                # device arrays with n un-synced (callers fetch it)
                unique, counts, minpos, n_dev = final_range_run()
                stats = {"reads": n_reads, "bases": n_bases,
                         "kmer_occurrences": n_occ}
                return unique, counts, minpos, n_dev, stats
            _t0 = _time.time()
            unique, counts, minpos, n_dev = final_range_run()
            n = int(n_dev)
            tm["final_merge"] += _time.time() - _t0
            total_occ_known = n_occ  # pass 1 done: exact total known
            # materialize the PREVIOUS range's fetch now: its transfer
            # had a whole pass to complete, and freeing it bounds device
            # memory to two in-flight fetch buffers
            _t0 = _time.time()
            if results and not isinstance(results[-1][0], tuple):
                buf_prev, n_prev = results[-1]
                results[-1] = (materialize(buf_prev, n_prev), n_prev)
            results.append((start_fetch(unique, counts, minpos, n), n))
            tm["fetch_wait"] += _time.time() - _t0
            del unique, counts, minpos
            if not range_stack:
                break
            lo_np, hi_np = range_stack.pop()
            lo_d = jnp.asarray(lo_np)
            hi_d = jnp.asarray(hi_np)
            # fresh range: no saturation anchor, fresh rho learning
            anchor[0] = anchor[1] = 0
            anchor[2] = 1.0
    finally:
        dev_cache.clear()   # release the HBM block cache
        if cache is not None:
            cache.close()

    # ---- host assembly (ranges are ascending, so concatenation is the
    # globally sorted distinct table) ----
    _t0 = _time.time()
    triples = []
    for buf, n in results:
        triples.append(buf if isinstance(buf, tuple)
                       else materialize(buf, n))
    tm["fetch_wait"] += _time.time() - _t0
    total = sum(t[1].shape[0] for t in triples)
    lanes_np = np.zeros((L, total), np.uint32)
    counts_np = np.zeros((total,), np.int32)
    pos_np = np.zeros((total,), np.uint32)
    off = 0
    for u, c, p in triples:
        m = c.shape[0]
        lanes_np[:, off:off + m] = u
        counts_np[off:off + m] = c
        pos_np[off:off + m] = p
        off += m
    tm["settle_wait"] = round(tm["settle_wait"], 3)
    tm["split"] = round(tm["split"], 3)
    tm["final_merge"] = round(tm["final_merge"], 3)
    tm["fetch_wait"] = round(tm["fetch_wait"], 3)
    stats = {"reads": n_reads, "bases": n_bases, "kmer_occurrences": n_occ,
             "ooc_passes": pass_no, "ooc_ranges": len(results),
             "timing": tm}
    return lanes_np, counts_np, pos_np, total, stats


@_partial(jax.jit, static_argnames=("k", "variant"))
def _compact_solid_jit(solid, counts, n_solid, k, variant="auto"):
    C = solid.shape[1]
    succ, out_deg = junctions_op.successor_arrays(solid, n_solid, k)
    oid = jnp.arange(2 * C, dtype=jnp.int32)
    valid_oriented = jnp.where(oid >= C, oid - C, oid) < n_solid
    info = chains_op.chain_decompose(succ, valid_oriented, variant=variant)
    return succ, out_deg, info


def compact_solid(solid: jnp.ndarray, counts: jnp.ndarray, n_solid: int, k: int):
    """Junction + chain stages on a (C, L) solid set (C = padded capacity).

    One fused jit program (junctions sort-join + chain decomposition):
    one dispatch and no host sync between the two stages.

    A negative n_unitigs signals the (astronomically unlikely) hierarchical
    level-capacity overflow; retry once with the plain doubling loop.  The
    check rides the n_unitigs fetch callers do anyway."""
    succ, out_deg, info = _compact_solid_jit(
        solid, counts, jnp.asarray(n_solid, jnp.int32), k)
    if int(info["n_unitigs"]) < 0:
        succ, out_deg, info = _compact_solid_jit(
            solid, counts, jnp.asarray(n_solid, jnp.int32), k,
            variant="plain")
    return succ, out_deg, info


def compact_solid_pos(solid: jnp.ndarray, counts: jnp.ndarray,
                      minpos: jnp.ndarray, n_solid: int, k: int):
    """Locality-ordered junction + chain stages (ops.runchains): reorder
    the solid set by first-occurrence key, contract consecutive runs with
    scans, and pointer-jump only the contracted run graph.

    Returns (solid_r, counts_r, succ, info): the REORDERED table the info
    arrays refer to, which callers must also use for assembly.  One host
    sync fetches the exact run count so the contracted capacity never
    overflows."""
    from bcalm_tpu.ops import runchains

    n_dev = jnp.asarray(n_solid, jnp.int32)
    solid_r, counts_r = runchains.reorder_by_pos(solid, counts, minpos, k)
    # the input may be sentinel-FOLDED rather than compacted
    # (count_op.filter_abundance_fold): the reorder just pushed all folded
    # columns past the valid prefix, so the junction stage only needs the
    # covering power-of-two capacity
    cap2 = _round_capacity(max(1, n_solid))
    if cap2 < solid_r.shape[1]:
        solid_r = solid_r[:, :cap2]
        counts_r = counts_r[:cap2]
    succ, scan = runchains.junction_runs(solid_r, n_dev, k)
    R = int(scan["R"])
    R_cap = _round_capacity(max(1, R))
    args = (succ, n_dev, scan["is_head"], scan["rid"], scan["head_pos"],
            scan["end_pos"], scan["R"])
    info = runchains.run_decompose(*args, R_cap=R_cap)
    # the overflow retry check costs a host sync; the plain contracted
    # jump cannot overflow, so only pay it when hier actually ran
    if (2 * R_cap >= chains_op._HIER_MIN
            and int(info["n_unitigs"]) < 0):
        info = runchains.run_decompose(*args, R_cap=R_cap, variant="plain")
    return solid_r, counts_r, succ, info


def _decode_kmers_np(lanes_np: np.ndarray, k: int) -> np.ndarray:
    """(L, U) uint32 big-endian packed k-mers -> (U, k) uint8 base codes."""
    L, U = lanes_np.shape
    r = ln.top_lane_bases(k)
    out = np.empty((U, k), dtype=np.uint8)
    for j in range(k):
        if j < r:
            lane, shift = 0, 2 * (r - 1 - j)
        else:
            t = j - r
            lane, shift = 1 + t // 16, 2 * (15 - t % 16)
        out[:, j] = (lanes_np[lane] >> np.uint32(shift)) & 3
    return out


def assemble_unitigs(
    solid: jnp.ndarray,
    counts: jnp.ndarray,
    info: dict,
    k: int,
) -> Tuple[List[str], np.ndarray, List[np.ndarray], np.ndarray]:
    """Host-side spelling of unitigs from chain assignments (vectorized:
    one flat base-code array is built with numpy scatters — no per-unitig
    python loop except the final string slicing).

    Returns (seqs, kc, abundance_vectors, circular).
    """
    C = solid.shape[1]
    uid = np.asarray(info["uid"])
    rank = np.asarray(info["rank"])
    n_unitigs = int(info["n_unitigs"])
    length = np.asarray(info["length"])[:n_unitigs].astype(np.int64)
    start_oid = np.asarray(info["start_oid"])[:n_unitigs]
    circular = np.asarray(info["circular"])[:n_unitigs]

    solid_np = np.asarray(solid)
    counts_np = np.asarray(counts)

    if n_unitigs == 0:
        return [], np.zeros(0, np.int64), [], circular

    member = uid >= 0
    m_uid = uid[member]
    m_rank = rank[member]
    m_oid = np.nonzero(member)[0]
    m_vertex = np.where(m_oid >= C, m_oid - C, m_oid)
    m_orient = m_oid >= C

    order = np.lexsort((m_rank, m_uid))
    m_uid, m_rank, m_vertex, m_orient = (
        m_uid[order], m_rank[order], m_vertex[order], m_orient[order]
    )
    # last base of each oriented k-mer spelling
    last_b = np.where(
        m_orient,
        ((solid_np[0, m_vertex] >> np.uint32(2 * (ln.top_lane_bases(k) - 1))) & 3) ^ 2,
        solid_np[-1, m_vertex] & 3,
    ).astype(np.uint8)
    m_count = counts_np[m_vertex]

    # flat code array: unitig u spells k + length[u] - 1 bases
    seq_len = length + (k - 1)
    offsets = np.concatenate([[0], np.cumsum(seq_len)])
    total = int(offsets[-1])
    codes = np.empty(total, dtype=np.uint8)

    # every member writes the last base of its oriented k-mer
    run_bounds = np.concatenate([[0], np.cumsum(length)])
    codes[offsets[m_uid] + (k - 1) + m_rank] = last_b

    # each unitig's start k-mer writes its full spelling
    v0 = start_oid
    vert0 = np.where(v0 >= C, v0 - C, v0)
    start_codes = _decode_kmers_np(solid_np[:, vert0], k)
    rev = v0 >= C
    if rev.any():
        start_codes[rev] = (start_codes[rev] ^ 2)[:, ::-1]
    pos = offsets[:-1, None] + np.arange(k)[None, :]
    codes[pos.reshape(-1)] = start_codes.reshape(-1)

    ascii_all = dna.CODE_TO_ASCII[codes].tobytes()
    seqs = [
        ascii_all[offsets[u]: offsets[u + 1]].decode()
        for u in range(n_unitigs)
    ]
    kc = np.add.reduceat(m_count.astype(np.int64), run_bounds[:-1])
    abund = np.split(m_count, run_bounds[1:-1])
    return seqs, kc, abund, circular


@_partial(jax.jit, static_argnames=("k", "total_cap", "mem_cap", "u_cap"))
def _assemble_dev(solid, counts, uid, rank, length, start_oid, n_u,
                  k: int, total_cap: int, mem_cap: int, u_cap: int):
    """Device-side unitig spelling (assemble_unitigs' scatter phase).

    The host version fetched uid/rank (2C,) plus the solid table to spell
    unitigs in numpy — ~500 MB device->host at E. coli scale.  Spelling
    on device reduces
    the fetch to the 2-bit-decoded byte string (u8, ~n_solid bytes), the
    member-ordered counts (u32, n_solid), and per-unitig scalars.

    Returns (codes u8 (total_cap,), counts_sorted u32 (mem_cap,),
    len_u (u_cap,), start_u (u_cap,), circ_u handled by caller).
    """
    L, C = solid.shape[0], solid.shape[1]
    M = uid.shape[0]          # 2C oriented nodes
    idx2 = jnp.arange(M, dtype=jnp.int32)
    member = uid >= 0
    vertex = jnp.where(idx2 >= C, idx2 - C, idx2)
    orient = idx2 >= C

    # ---- per-unitig sequence offsets ----
    iu = jnp.arange(u_cap, dtype=jnp.int32)
    valid_u = iu < n_u
    len_u = jnp.where(valid_u, length[:u_cap], 0)
    seq_len = jnp.where(valid_u, len_u + (k - 1), 0)
    offsets = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(seq_len)])

    # ---- member writes: last base of each oriented k-mer ----
    r = ln.top_lane_bases(k)
    v = jnp.clip(vertex, 0, C - 1)
    first_b = ((solid[0, v] >> np.uint32(2 * (r - 1))) & 3).astype(jnp.uint8)
    last_b_f = (solid[L - 1, v] & 3).astype(jnp.uint8)
    last_b = jnp.where(orient, first_b ^ 2, last_b_f)
    uid_c = jnp.clip(uid, 0, u_cap - 1)
    # (uid, rank) is unique per member, so in-bounds destinations are too
    dest = jnp.where(member,
                     jnp.take(offsets, uid_c) + (k - 1) + rank,
                     total_cap)
    codes = jnp.zeros((total_cap,), jnp.uint8).at[dest].set(
        last_b, mode="drop")

    # ---- start k-mer spelling (k bases per unitig) ----
    so = start_oid[:u_cap]
    sv = jnp.clip(jnp.where(so >= C, so - C, so), 0, C - 1)
    s_lanes = solid[:, sv]                      # (L, u_cap) gather
    fwd = []
    for j in range(k):
        if j < r:
            lane, shift = 0, 2 * (r - 1 - j)
        else:
            t = j - r
            lane, shift = 1 + t // 16, 2 * (15 - t % 16)
        fwd.append(((s_lanes[lane] >> np.uint32(shift)) & 3)
                   .astype(jnp.uint8))
    rev = [b ^ 2 for b in reversed(fwd)]
    s_rev = so >= C
    start_codes = [jnp.where(s_rev, rv, fw) for fw, rv in zip(fwd, rev)]
    # offsets grow by >= k per unitig: base_dest + j never collides
    base_dest = jnp.where(valid_u, offsets[:u_cap], total_cap)
    for j in range(k):
        codes = codes.at[base_dest + j].set(start_codes[j], mode="drop")

    # ---- member-ordered counts (abundance vectors + KC sums, host
    # reduceat): sort members by (uid, rank) ----
    from bcalm_tpu.ops import sort
    key_u = jnp.where(member, uid.astype(jnp.uint32), count_op.SENTINEL)
    key_r = rank.astype(jnp.uint32)
    w = jnp.take(counts, v).astype(jnp.uint32)
    out = sort.sort_ops([key_u, key_r, w], num_keys=2)
    counts_sorted = out[2][:mem_cap]
    return codes, counts_sorted, len_u, offsets[:u_cap]


def assemble_unitigs_device(solid, counts, info, k: int, n_unitigs: int,
                            n_solid: int):
    """Device-side assembly wrapper: spells unitigs on device, fetches
    only bytes + member counts + per-unitig scalars, and finishes the
    string slicing in numpy.  Drop-in for assemble_unitigs when the
    inputs are device arrays."""
    if n_unitigs == 0:
        return [], np.zeros(0, np.int64), [], np.zeros(0, bool)
    u_cap = _round_capacity(max(1, n_unitigs))
    u_cap = min(u_cap, int(np.asarray(info["length"]).shape[0]))
    mem_cap = min(_round_capacity(max(1, n_solid)), int(info["uid"].shape[0]))
    total = n_solid + (k - 1) * n_unitigs
    total_cap = _round_capacity(max(1, total))
    codes_d, counts_d, len_d, _ = _assemble_dev(
        solid, counts, info["uid"], info["rank"], info["length"],
        info["start_oid"], jnp.asarray(n_unitigs, jnp.int32),
        k, total_cap, mem_cap, u_cap)
    codes_d.copy_to_host_async()
    counts_d.copy_to_host_async()
    codes = np.asarray(codes_d)
    mcounts = np.asarray(counts_d)[:n_solid].astype(np.int64)
    length = np.asarray(len_d)[:n_unitigs].astype(np.int64)
    circular = np.asarray(info["circular"])[:n_unitigs]
    seq_len = length + (k - 1)
    offsets = np.concatenate([[0], np.cumsum(seq_len)])
    ascii_all = dna.CODE_TO_ASCII[codes[:offsets[-1]]].tobytes()
    seqs = [ascii_all[offsets[u]: offsets[u + 1]].decode()
            for u in range(n_unitigs)]
    run_bounds = np.concatenate([[0], np.cumsum(length)])
    kc = np.add.reduceat(mcounts, run_bounds[:-1])
    abund = np.split(mcounts.astype(np.int32), run_bounds[1:-1])
    return seqs, kc, abund, circular


def _pack_ends(codes: np.ndarray) -> np.ndarray:
    """(E, k-1) uint8 base codes -> (E, W) uint64 packed key columns."""
    E, m = codes.shape
    W = max(1, (m + 31) // 32)
    out = np.zeros((E, W), dtype=np.uint64)
    for j in range(m):
        out[:, j // 32] |= codes[:, j].astype(np.uint64) << np.uint64(
            2 * (31 - j % 32)
        )
    return out


def link_join(seqs: List[str], k: int) -> List[Tuple[int, str, int, str]]:
    """All (k-1)-overlap links between unitig extremities (LinkTigs analog,
    gatb debruijn/impl/LinkTigs — reconstructed; output grammar
    /root/reference/README.md:72, all mirror edges recorded per
    bidirected-graphs-in-bcalm2.md:101).

    Vectorized sort-join: the 4U extremity (k-1)-mers (prefix/suffix x
    orientation) are packed into integer key columns; out-ends and in-ends
    sharing a key produce the links via grouped cross products.
    """
    U = len(seqs)
    if U == 0:
        return []
    m = k - 1
    # prefix/suffix code matrices from one flat encode
    lut = np.zeros(256, dtype=np.uint8)
    lut[np.frombuffer(b"ACTG", np.uint8)] = np.arange(4, dtype=np.uint8)
    lut[np.frombuffer(b"actg", np.uint8)] = np.arange(4, dtype=np.uint8)
    pre_bytes = b"".join(s[:m].encode() for s in seqs)
    suf_bytes = b"".join(s[-m:].encode() for s in seqs)
    pre = lut[np.frombuffer(pre_bytes, np.uint8)].reshape(U, m)
    suf = lut[np.frombuffer(suf_bytes, np.uint8)].reshape(U, m)
    rc_pre = (pre ^ 2)[:, ::-1]
    rc_suf = (suf ^ 2)[:, ::-1]

    # out-ends: (i,+) -> suf, (i,-) -> rc(pre); in-ends: (i,+) -> pre,
    # (i,-) -> rc(suf)
    out_keys = _pack_ends(np.concatenate([suf, rc_pre]))
    in_keys = _pack_ends(np.concatenate([pre, rc_suf]))
    all_keys = np.concatenate([out_keys, in_keys])
    _, gid = np.unique(all_keys, axis=0, return_inverse=True)
    gid = gid.reshape(-1)
    g_out, g_in = gid[: 2 * U], gid[2 * U:]

    n_groups = int(gid.max()) + 1
    ci = np.bincount(g_in, minlength=n_groups)

    # entries sorted by group
    o_order = np.argsort(g_out, kind="stable")
    i_order = np.argsort(g_in, kind="stable")
    g_out_s = g_out[o_order]
    in_start = np.concatenate([[0], np.cumsum(ci)])

    rep = ci[g_out_s]                      # pairs contributed by each out-end
    P = int(rep.sum())
    if P == 0:
        return []
    out_rep = np.repeat(o_order, rep)
    g_rep = np.repeat(g_out_s, rep)
    first_slot = np.concatenate([[0], np.cumsum(rep)])[:-1]
    within = np.arange(P) - np.repeat(first_slot, rep)
    in_rep = i_order[in_start[g_rep] + within]

    src_id = (out_rep % U).astype(np.int64)
    src_sign = np.where(out_rep < U, "+", "-")
    dst_id = (in_rep % U).astype(np.int64)
    dst_sign = np.where(in_rep < U, "+", "-")
    order = np.lexsort((dst_sign, dst_id, src_sign, src_id))
    return [
        (int(src_id[t]), str(src_sign[t]), int(dst_id[t]), str(dst_sign[t]))
        for t in order
    ]


def compact_from_counts(solid_np: np.ndarray, counts_np: np.ndarray,
                        cfg: EngineConfig, only_uf: bool = False,
                        uf_stats: bool = False,
                        chain_info: Optional[Dict] = None,
                        minpos_np: Optional[np.ndarray] = None) -> UnitigSet:
    """Compaction + assembly + links from a host-side solid (kmer, count)
    table (resume entry point: the analog of re-entering
    GraphUnitigs::create with counting already in storage).

    only_uf / uf_stats mirror the reference's glue debug flags
    (`--only-uf`, `--uf-stats`, /root/reference/src/bcalm_1.cpp:26-27):
    only_uf stops after chain labeling (no assembly/links); uf_stats adds
    chain-class statistics to UnitigSet.stats.

    chain_info: a previously checkpointed chain decomposition (the
    `-skip-bglue` resume path — the glue-file analog).  Must have been
    computed for exactly this solid set (validated by array size).

    minpos_np: first-occurrence keys; when present, compaction uses the
    locality-ordered fast path (ops.runchains) and the table is
    deterministically REORDERED first, so a chain checkpoint saved with
    keys stays consistent on resume.
    """
    n_solid = int(solid_np.shape[1])
    if n_solid == 0:
        return UnitigSet(
            k=cfg.k, seqs=[], kc=np.zeros(0, np.int64), abundances=[],
            circular=np.zeros(0, bool), links=[], stats={"solid_kmers": 0},
        )
    cap = _round_capacity(n_solid)
    L = solid_np.shape[0]
    solid = jnp.asarray(np.concatenate(
        [solid_np.astype(np.uint32), np.zeros((L, cap - n_solid), np.uint32)],
        axis=1,
    ))
    counts = jnp.asarray(np.concatenate(
        [counts_np.astype(np.int32), np.zeros((cap - n_solid,), np.int32)]
    ))
    minpos = None
    if minpos_np is not None:
        minpos = jnp.asarray(np.concatenate(
            [minpos_np.astype(np.uint32),
             np.full((cap - n_solid,), count_op.SENTINEL, np.uint32)]))
    if chain_info is not None:
        if np.asarray(chain_info["uid"]).shape[0] != 2 * cap:
            raise ValueError(
                "chain checkpoint is stale (solid set size changed); "
                "rerun without -skip-bglue"
            )
        if minpos is not None:
            # the checkpoint was computed against the reordered table;
            # re-derive the (deterministic) order, skip the decompose
            from bcalm_tpu.ops import runchains
            solid, counts = runchains.reorder_by_pos(
                solid, counts, minpos, cfg.k)
        info = chain_info
    elif minpos is not None:
        solid, counts, succ, info = compact_solid_pos(
            solid, counts, minpos, n_solid, cfg.k)
    else:
        succ, out_deg, info = compact_solid(solid, counts, n_solid, cfg.k)
    stats = {"solid_kmers": n_solid}
    if uf_stats or only_uf:
        stats.update(chain_stats(info, n_solid))
    if only_uf:
        return UnitigSet(
            k=cfg.k, seqs=[], kc=np.zeros(0, np.int64), abundances=[],
            circular=np.zeros(0, bool), links=[], stats=stats,
            chain_info={key: np.asarray(val) for key, val in info.items()},
        )
    seqs, kc, abund, circular = assemble_unitigs_device(
        solid, counts, {key: jnp.asarray(np.asarray(val))
                        for key, val in info.items()},
        cfg.k, int(np.asarray(info["n_unitigs"])), n_solid)
    links = link_join(seqs, cfg.k)
    stats["unitigs"] = len(seqs)
    return UnitigSet(
        k=cfg.k, seqs=seqs, kc=kc, abundances=abund, circular=circular,
        links=links, stats=stats,
    )


def build_from_blocks(blocks: Iterator[packing.ReadBlock], cfg: EngineConfig,
                      reread=None, store=None, auto_amin_cap=None,
                      only_uf: bool = False,
                      uf_stats: bool = False,
                      solidity_kind: str = "sum") -> UnitigSet:
    """Device-resident end-to-end build (no host round-trip of the solid
    set between counting and compaction — the CLI previously staged the
    solid table through count_and_filter, ~2x its bytes over the host
    link).

    store: optional storage.Store — the filtered solid counts + histogram
    + first-occurrence keys persist for `-skip-bcalm` resume; the
    device->host fetch is ASYNC and overlaps the compaction dispatch.
    auto_amin_cap: resolve `-abundance-min auto` from the histogram
    (cfg.abundance_min updated in place).  only_uf / uf_stats mirror the
    reference glue debug flags (src/bcalm_1.cpp:26-27).

    On the out-of-core path (multi-pass counting, host-resident distinct
    table) the histogram + solidity filter run in numpy and compaction
    restarts from the (much smaller) solid set."""
    import time as _t
    _t0 = _t.time()
    unique, counts, minpos, n_unique, stats = count_blocks(
        blocks, cfg, reread=reread)
    stats["t_count_s"] = round(_t.time() - _t0, 2)

    def write_store(solid_np, counts_np, minpos_np, histo):
        if store is not None:
            store.write_counts(
                solid_np, counts_np, cfg.k, histogram=histo,
                minpos=minpos_np,
                config={"abundance_min": cfg.abundance_min,
                        "abundance_max": cfg.abundance_max,
                        "solidity_kind": solidity_kind})

    if isinstance(unique, np.ndarray):
        counts_np = np.asarray(counts)
        binned = np.minimum(counts_np, cfg.histo_max)
        histo = np.bincount(binned, minlength=cfg.histo_max + 1).astype(
            np.int32)
        if auto_amin_cap is not None:
            cfg.abundance_min = auto_abundance_min(histo, auto_amin_cap)
        keep = ((counts_np >= cfg.abundance_min)
                & (counts_np <= cfg.abundance_max))
        stats["distinct_kmers"] = int(counts_np.shape[0])
        solid_np = unique[:, keep]
        write_store(solid_np, counts_np[keep],
                    None if minpos is None else minpos[keep], histo)
        _t1 = _t.time()
        try:
            us = compact_from_counts(
                solid_np, counts_np[keep], cfg, only_uf=only_uf,
                uf_stats=uf_stats,
                minpos_np=None if minpos is None else minpos[keep])
        except Exception as e:  # noqa: BLE001 — classify allocator death
            # After a long multi-pass count the backend allocator can be
            # too fragmented for the contiguous multi-GB junction sort
            # even though a FRESH process compacts the same set fine
            # (docs/OOC.md).  The solid
            # set was checkpointed above, so a clean-allocator resume
            # loses nothing — signal it instead of dying.
            if store is not None and _is_resource_exhausted(e):
                raise CompactionOOM(
                    "device allocator exhausted during compaction; the "
                    "counted solid set is checkpointed — resume with "
                    "-skip-bcalm in a fresh process") from e
            raise
        stats["t_compact_s"] = round(_t.time() - _t1, 2)
        us.histogram = histo
        us.stats.update(stats)
        us.stats["unitigs"] = len(us.seqs)
        return us
    # ---- device-resident path: ONE stacked scalar fetch serves both
    # n_unique and n_solid; the solidity filter is a pure elementwise
    # fold (filter_abundance_fold) and the locality reorder inside
    # compact_solid_pos compacts the fold for free ----
    histo_dev = count_op.abundance_histogram(
        counts, n_unique, histo_max=cfg.histo_max)
    if auto_amin_cap is not None:
        # the cutoff depends on the histogram: sync it first (rare path)
        histo = np.asarray(histo_dev)
        cfg.abundance_min = auto_abundance_min(histo, auto_amin_cap)
        histo_dev = None
    else:
        histo_dev.copy_to_host_async()
        histo = None
    solidF, countsF, posF, nn_dev = count_op.filter_abundance_fold(
        unique, counts, minpos, n_unique,
        cfg.abundance_min, cfg.abundance_max)
    nn = np.asarray(nn_dev)
    n_u, n_solid = int(nn[0]), int(nn[1])
    if histo is None:
        histo = np.asarray(histo_dev)
    cap = _round_capacity(max(1, n_u))
    stats["distinct_kmers"] = n_u
    stats["solid_kmers"] = n_solid
    if n_solid == 0:
        us = UnitigSet(
            k=cfg.k, seqs=[], kc=np.zeros(0, np.int64), abundances=[],
            circular=np.zeros(0, bool), links=[], histogram=histo,
            stats=stats,
        )
        L = ln.num_lanes(cfg.k)
        write_store(np.zeros((L, 0), np.uint32), np.zeros((0,), np.int32),
                    np.zeros((0,), np.uint32), histo)
        return us
    solid_d = solidF[:, :cap]
    counts_d = countsF[:cap]
    pos_d = posF[:cap]
    fetch_buf = None
    if store is not None:
        # checkpoint fetch needs the COMPACTED canonical table (the fold
        # leaves solid entries scattered in the valid prefix): run the
        # scatter filter just for the store, its fetch rides behind the
        # compaction dispatch
        solidC, countsC, posC, _ = count_op.filter_abundance_pos(
            unique[:, :cap], counts[:cap], minpos[:cap],
            jnp.asarray(n_u, jnp.int32),
            cfg.abundance_min, cfg.abundance_max)
        capf = _fetch_capacity(n_solid)
        fetch_buf = _pack_fetch(solidC, countsC, posC, capf)
        fetch_buf.copy_to_host_async()
    _t1 = _t.time()
    solid_r, counts_r, succ, info = compact_solid_pos(
        solid_d, counts_d, pos_d, n_solid, cfg.k)
    stats["t_compact_s"] = round(_t.time() - _t1, 2)
    if fetch_buf is not None:
        arr = np.asarray(fetch_buf)
        L = ln.num_lanes(cfg.k)
        write_store(arr[:L, :n_solid], arr[L, :n_solid].astype(np.int32),
                    arr[L + 1, :n_solid], histo)
    if uf_stats or only_uf:
        stats.update(chain_stats(info, n_solid))
    if only_uf:
        return UnitigSet(
            k=cfg.k, seqs=[], kc=np.zeros(0, np.int64), abundances=[],
            circular=np.zeros(0, bool), links=[], histogram=histo,
            stats=stats,
            chain_info={key: np.asarray(val) for key, val in info.items()},
        )
    _t1 = _t.time()
    seqs, kc, abund, circular = assemble_unitigs_device(
        solid_r, counts_r, info, cfg.k, int(info["n_unitigs"]), n_solid)
    links = link_join(seqs, cfg.k)
    stats["t_assemble_s"] = round(_t.time() - _t1, 2)
    stats["unitigs"] = len(seqs)
    us = UnitigSet(
        k=cfg.k, seqs=seqs, kc=kc, abundances=abund, circular=circular,
        links=links, histogram=histo, stats=stats,
    )
    return us


def count_and_filter(blocks: Iterator[packing.ReadBlock], cfg: EngineConfig,
                     reread=None):
    """Counting phase -> host arrays (for storage/checkpoint + compaction).

    Returns (solid_np (L,n) uint32, counts_np (n,) int32, minpos_np (n,)
    uint32, histogram, stats).  The distinct run is trimmed on device,
    then fetched ONCE; the solidity filter and abundance histogram run in
    numpy — the distinct set is leaving the device here anyway
    (storage/checkpoint), and host masking is far cheaper than device
    scatter-compaction + a second transfer.
    """
    unique, counts, minpos, n_unique, stats = count_blocks(
        blocks, cfg, reread=reread)
    n_u = int(n_unique)
    if isinstance(unique, np.ndarray):   # multi-pass path: already exact
        unique_np, counts_np, minpos_np = unique, counts, minpos
    else:
        cap = _round_capacity(max(1, n_u))
        unique_np = np.asarray(unique[:, :cap])[:, :n_u]
        counts_np = np.asarray(counts[:cap])[:n_u]
        minpos_np = np.asarray(minpos[:cap])[:n_u]
    binned = np.minimum(counts_np, cfg.histo_max)
    histo = np.bincount(binned, minlength=cfg.histo_max + 1).astype(np.int32)
    keep = (counts_np >= cfg.abundance_min) & (counts_np <= cfg.abundance_max)
    solid_np = unique_np[:, keep]
    solid_counts_np = counts_np[keep]
    solid_pos_np = minpos_np[keep]
    stats["distinct_kmers"] = n_u
    stats["solid_kmers"] = int(solid_np.shape[1])
    return solid_np, solid_counts_np, solid_pos_np, histo, stats


def combine_sample_counts(runs, kind: str = "sum", k: Optional[int] = None):
    """Combine per-sample distinct (kmer, count) runs under a solidity kind
    (gatb CountProcessorSolidity over multiple banks; hidden option
    STR_SOLIDITY_KIND at /root/reference/src/bcalm_1.cpp:36):

      sum — aggregate count = total over samples,
      min — count in a sample where the k-mer is ABSENT is 0, so the min
            passes a threshold only if the k-mer appears in every sample,
      max — best count over samples.

    runs: list of (lanes_np (L, n_i) uint32, counts_np (n_i,) int32).
    Returns (lanes_np (L, n) sorted, counts_np (n,) int32).
    """
    runs = [r for r in runs if r[0].shape[1] > 0]
    if not runs:
        L = ln.num_lanes(k) if k is not None else 1
        return np.zeros((L, 0), np.uint32), np.zeros((0,), np.int32)
    n_samples = len(runs)
    lanes = np.concatenate([r[0] for r in runs], axis=1)
    counts = np.concatenate([r[1] for r in runs])
    L = lanes.shape[0]
    order = np.lexsort(tuple(lanes[j] for j in reversed(range(L))))
    lanes = lanes[:, order]
    counts = counts[order]
    first = np.ones(lanes.shape[1], bool)
    if lanes.shape[1] > 1:
        first[1:] = np.any(lanes[:, 1:] != lanes[:, :-1], axis=0)
    starts = np.nonzero(first)[0]
    sizes = np.diff(np.concatenate([starts, [lanes.shape[1]]]))
    if kind == "sum":
        agg = np.add.reduceat(counts.astype(np.int64), starts)
    elif kind == "max":
        agg = np.maximum.reduceat(counts, starts).astype(np.int64)
    elif kind == "min":
        agg = np.minimum.reduceat(counts, starts).astype(np.int64)
        agg = np.where(sizes < n_samples, 0, agg)  # absent in a sample -> 0
    else:
        raise ValueError(f"unknown solidity kind: {kind}")
    return lanes[:, starts], np.minimum(agg, 2**31 - 1).astype(np.int32)


def auto_abundance_min(histogram: np.ndarray, cap: int = 20) -> int:
    """Derive the abundance cutoff from the k-mer abundance histogram
    (gatb's `-abundance-min auto`: first valley between the sequencing-error
    peak at count 1 and the coverage peak, capped by
    `-abundance-min-threshold`)."""
    h = np.asarray(histogram, np.int64)
    if h.size < 4:
        return 2
    # first local minimum after the initial descent (skip bin 0)
    for i in range(2, min(h.size - 1, cap + 1)):
        if h[i] <= h[i - 1] and h[i] <= h[i + 1]:
            return max(2, min(i, cap))
    return 2 if cap >= 2 else max(1, cap)


def chain_stats(info: dict, n_solid: int) -> Dict:
    """Chain-decomposition diagnostics — the analog of the reference UF's
    `printStats` (`--uf-stats`, /root/reference/src/bcalm_1.cpp:27;
    example/uf/testUF.cpp:39-40): class counts and size distribution of
    the union-find replacement (pointer-jumped chains)."""
    n_unitigs = int(info["n_unitigs"])
    length = np.asarray(info["length"])[:n_unitigs].astype(np.int64)
    circular = np.asarray(info["circular"])[:n_unitigs]
    return {
        "uf_classes": n_unitigs,
        "uf_nodes": int(n_solid),
        "uf_singletons": int((length == 1).sum()),
        "uf_largest_class": int(length.max()) if n_unitigs else 0,
        "uf_mean_class": float(length.mean()) if n_unitigs else 0.0,
        "uf_circular_classes": int(circular.sum()),
    }


def build_from_seqs(seqs: Iterable[str], cfg: EngineConfig) -> UnitigSet:
    blocks = packing.iter_blocks(
        seqs, cfg.k, block_reads=cfg.block_reads, max_len=cfg.max_len
    )
    return build_from_blocks(blocks, cfg)
