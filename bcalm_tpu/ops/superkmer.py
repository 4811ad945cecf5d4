"""Superkmer formation + packing: minimizer-run routing units.

Device-side replacement for the reference's Sequence2SuperKmer /
SuperKmerBinFiles stage (gatb kmer/impl/SortingCountAlgorithm,
reconstructed — SURVEY.md §3.2): consecutive k-mers of a read that share a
minimizer form a *superkmer*, and the whole base run is routed to the
minimizer's partition as one unit instead of k-mer-by-k-mer — an
~L*span/(W+1)-fold cut of exchange traffic (the reference's motivation is
the same k-fold disk-I/O cut; here the interconnect replaces the disk).

Minimizer definition: the minimum CANONICAL m-mer of the k-mer window
(m-mer canonicalized independently, min over the k-m+1 read positions),
optionally ordered by sampled frequency rank (minimizer-type 1).  Because
canon(mmer) == canon(rc(mmer)), the minimizer is identical for a k-mer and
its reverse complement, so (a) both orientations route to the same
partition and (b) runs are NOT broken by canonical-strand flips along the
read — mean superkmer span stays ~(k-m+2)/2 (computing minimizers on the
canonical k-mer's own sequence instead breaks runs at every strand flip
and measured ~2x shorter spans).

Everything is computed at all read positions simultaneously:
per-position canonical m-mers (single-lane bit tricks), a log-doubling
sliding-window min over the m-mer keys, run breaks where the window key
changes (plus span cuts at `max_span` for a fixed packed width), and the
packed superkmer words are the forward window packs at start + 16*w —
no per-superkmer gather, just static rolls.

The receiver unpacks with the ordinary extraction kernel
(ops.extract.extract_canonical) — a superkmer is just a short read.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from bcalm_tpu.models import lanes as ln
from bcalm_tpu.ops import extract as extract_op

_U32 = jnp.uint32
_I32 = jnp.int32


def span_words(k: int, max_span: int) -> int:
    """uint32 words to hold a superkmer of <= max_span k-mers PLUS the
    embedded span field (see below)."""
    bits = max(1, int(np.ceil(np.log2(max_span + 1))))
    return (max_span + k - 1 + (bits + 1) // 2 + 15) // 16


def span_field_bits(max_span: int) -> int:
    return max(1, int(np.ceil(np.log2(max_span + 1))))


def default_max_span(k: int) -> int:
    """Largest span cap that fits the word count of a ~32-k-mer superkmer
    with room for the embedded span field (its low bits)."""
    Wn = (32 + k - 1 + 15) // 16
    ms = 16 * Wn - (k - 1)
    bits = max(1, int(np.ceil(np.log2(ms + 1))))
    return ms - (bits + 1) // 2


def est_span(k: int, m: int) -> int:
    """Conservative expected superkmer length (k-mers per superkmer) used
    for exchange-capacity sizing; actual runs are usually longer."""
    return max(1, (k - m + 1) // 2)


def canonical_mmers(fwd_pack: jnp.ndarray, m: int) -> jnp.ndarray:
    """Canonical m-mer starting at each read position, from the forward
    16-base window packs: min(mmer, revcomp(mmer)), single-lane bit ops."""
    if m > 16:
        raise ValueError("minimizer size must be <= 16")
    mm = fwd_pack >> np.uint32(2 * (16 - m))
    rev = ln._reverse_bases_in_lane(mm) >> np.uint32(2 * (16 - m))
    rc = rev ^ np.uint32(0xAAAAAAAA & ((1 << (2 * m)) - 1))
    return jnp.minimum(mm, rc)


def window_min_keys(keys: jnp.ndarray, w: int) -> jnp.ndarray:
    """Sliding-window minimum over [p, p+w) along the last axis, log-step
    doubling (sparse-table style: two overlapping power-of-two windows)."""
    t = 1
    r = keys
    while t * 2 <= w:
        r = jnp.minimum(r, extract_op._shift_pos(r, t))
        t *= 2
    if t < w:
        r = jnp.minimum(r, extract_op._shift_pos(r, w - t))
    return r


@partial(jax.jit,
         static_argnames=("k", "m", "max_span", "use_rank", "with_pos"))
def form_superkmers(words: jnp.ndarray, lengths: jnp.ndarray, k: int, m: int,
                    owner_by_key: jnp.ndarray,
                    rank: Optional[jnp.ndarray] = None,
                    max_span: int = 32, use_rank: bool = False,
                    with_pos: bool = False, pos_base=None):
    """Form + pack superkmers for a block of reads.

    Args:
      words:   (B, W) packed reads
      lengths: (B,) read lengths
      owner_by_key: (4^m,) int32 partition table indexed by the window-min
        KEY (the frequency rank when use_rank, else the canonical m-mer)
      rank: (4^m,) uint32 canonical-m-mer -> frequency rank (minimizer-type
        1); required when use_rank
      with_pos: append one word channel carrying the superkmer's global
        stream START slot (pos_base + flat position) — feeds the
        first-occurrence locality ordering (ops.runchains) through the
        distributed exchange at +1 word/superkmer
      pos_base: () uint32 stream slot of this block's first position
        (required when with_pos)

    Returns (flattened over B*P positions; entries valid at run starts):
      skm_words: (Wn [+1 with_pos], B*P) uint32 packed superkmer bases,
                 the SPAN (k-mer count, 1..max_span) embedded in the low
                 span_field_bits of word Wn-1 (decode with decode_span);
                 with_pos appends the stream-position channel last
      owner:     (B*P,) int32 destination partition
      start:     (B*P,) bool superkmer start mask
      n_kmers:   () int32 total valid k-mer positions (for stats)
    """
    B, W = words.shape
    bases = extract_op.decode_words(words)
    P = bases.shape[1]
    fwd_pack, _ = extract_op.window_packs(bases)
    pos = jnp.arange(P, dtype=_I32)[None, :]
    valid = pos <= (lengths[:, None] - k)             # (B, P) k-mer validity

    cm = canonical_mmers(fwd_pack, m)                 # (B, P)
    key = rank[cm.astype(_I32)] if use_rank else cm
    wmin = window_min_keys(key, k - m + 1)            # minimizer key per kmer
    owner = owner_by_key[wmin.astype(_I32)]           # (B, P) int32

    # run breaks: invalid->valid edge or changed minimizer key
    prev_key = jnp.concatenate([wmin[:, :1], wmin[:, :-1]], axis=1)
    prev_valid = jnp.concatenate(
        [jnp.zeros((B, 1), bool), valid[:, :-1]], axis=1)
    change = valid & (~prev_valid | (wmin != prev_key))

    # positions within the change-run via a per-row max scan, then span
    # cuts every max_span positions
    idx = jnp.broadcast_to(pos, (B, P))
    run_start0 = jax.lax.associative_scan(
        jnp.maximum, jnp.where(change, idx, 0), axis=1)
    within0 = idx - run_start0
    start = change | (valid & (within0 > 0) & (within0 % max_span == 0))

    # run end (exclusive): first later position that is a change-start or
    # invalid — reverse min scan over terminator positions
    term = jnp.where(change | ~valid, idx, P)
    rev_min = jax.lax.associative_scan(
        jnp.minimum, term[:, ::-1], axis=1)[:, ::-1]
    end0 = jnp.concatenate([rev_min[:, 1:], jnp.full((B, 1), P, _I32)],
                           axis=1)
    span = jnp.minimum(jnp.asarray(max_span, _I32), end0 - idx)

    # packed words: word w of a superkmer starting at p = fwd_pack[p + 16w];
    # the last word's low bits (base slots the <= max_span + k - 1 payload
    # never uses) carry the span
    Wn = span_words(k, max_span)
    bits = span_field_bits(max_span)
    rows = [extract_op._shift_pos(fwd_pack, 16 * w) for w in range(Wn)]
    rows[-1] = ((rows[-1] >> np.uint32(bits)) << np.uint32(bits)) \
        | span.astype(_U32)
    if with_pos:
        flat = (jnp.arange(B * P, dtype=_U32).reshape(B, P)
                + jnp.asarray(pos_base, _U32))
        rows.append(flat)
    skm_words = jnp.stack(rows, axis=0)                # (Wn[+1], B, P)

    return (
        skm_words.reshape(len(rows), B * P),
        owner.reshape(B * P).astype(_I32),
        start.reshape(B * P),
        jnp.sum(valid.astype(_I32)),
    )


def decode_span(last_word: jnp.ndarray, max_span: int) -> jnp.ndarray:
    """Span (k-mer count) embedded in a received superkmer's last word."""
    bits = span_field_bits(max_span)
    return (last_word & np.uint32((1 << bits) - 1)).astype(_I32)


@partial(jax.jit, static_argnames=("k", "m"))
def sample_cmmer_histogram(words: jnp.ndarray, lengths: jnp.ndarray,
                           k: int, m: int):
    """Canonical m-mer frequency histogram over a sample block's read
    positions (the RepartitionAlgorithm sampling pass — SURVEY.md §3.2)."""
    B, W = words.shape
    bases = extract_op.decode_words(words)
    P = bases.shape[1]
    fwd_pack, _ = extract_op.window_packs(bases)
    cm = canonical_mmers(fwd_pack, m)
    pos = jnp.arange(P, dtype=_I32)[None, :]
    v = (pos <= (lengths[:, None] - m)).reshape(-1)
    return jnp.bincount(
        jnp.where(v, cm.reshape(-1).astype(_I32), 0),
        weights=v.astype(_I32), length=4 ** m).astype(jnp.int32)


@partial(jax.jit, static_argnames=("k", "m", "use_rank"))
def sample_minimizer_load(words: jnp.ndarray, lengths: jnp.ndarray,
                          k: int, m: int,
                          rank: Optional[jnp.ndarray] = None,
                          use_rank: bool = False):
    """Per-minimizer-KEY k-mer load over a sample block (drives the
    balanced repartition, gatb Repartitor).  Indexed by the window-min key
    (rank when use_rank, else canonical m-mer value)."""
    B, W = words.shape
    bases = extract_op.decode_words(words)
    P = bases.shape[1]
    fwd_pack, _ = extract_op.window_packs(bases)
    cm = canonical_mmers(fwd_pack, m)
    key = rank[cm.astype(_I32)] if use_rank else cm
    wmin = window_min_keys(key, k - m + 1)
    pos = jnp.arange(P, dtype=_I32)[None, :]
    v = (pos <= (lengths[:, None] - k)).reshape(-1)
    return jnp.bincount(
        jnp.where(v, wmin.reshape(-1).astype(_I32), 0),
        weights=v.astype(_I32), length=4 ** m).astype(jnp.int32)
