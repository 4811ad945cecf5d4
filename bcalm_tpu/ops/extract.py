"""Device kernel: canonical k-mer extraction from packed read blocks.

Device-side replacement for the reference's HOT LOOP 1 (per-base rolling
k-mer + canonicalization inside gatb kmer/impl/Sequence2SuperKmer /
Model.hpp, reconstructed — SURVEY.md §4.2).  Instead of a sequential
rolling hash per read, every k-mer of every read in a block is produced
simultaneously with O(log 16) vector ops:

1. decode 2-bit packed words to a (B, P) base plane,
2. build a forward "window pack" M(p)  = bases[p..p+15] (big-endian) and a
   reverse-complement pack     rcM(p) = sum_i comp(bases[p+i]) * 4^i
   via shift-and-or doubling (4 steps each, elementwise only),
3. slice the window packs at static lane offsets to materialize all L
   lanes of both the forward k-mer and its reverse complement at every
   position, then select the canonical orientation lane-lexicographically.

Everything is static-shape; invalid positions (p > len-k) are masked.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from bcalm_tpu.models import lanes as ln

_U32 = jnp.uint32
_COMP = np.uint32(0xAAAAAAAA)


def decode_words(words: jnp.ndarray) -> jnp.ndarray:
    """(B, W) packed uint32 -> (B, W*16) uint32 base codes (0..3)."""
    shifts = jnp.asarray(
        2 * (ln.BASES_PER_LANE - 1 - np.arange(ln.BASES_PER_LANE)), dtype=_U32
    )
    b = (words[:, :, None] >> shifts[None, None, :]) & np.uint32(3)
    return b.reshape(words.shape[0], -1)


def _shift_pos(x: jnp.ndarray, off: int) -> jnp.ndarray:
    """x[:, p+off] with wraparound (wrapped values always land on masked
    positions: valid p satisfies p+off <= p+k-1 < len <= P)."""
    if off == 0:
        return x
    return jnp.roll(x, -off, axis=1)


def window_packs(bases: jnp.ndarray):
    """Forward and reverse-complement 16-base window packs, both (B, P).

    M(p)   = sum_{i<16} bases[p+i] * 4**(15-i)   (big-endian window)
    rcM(p) = sum_{i<16} (bases[p+i]^2) * 4**i    (reversed complement window)
    """
    f = bases.astype(_U32)
    r = f ^ np.uint32(2)
    # doubling: combine window of size w with window at p+w
    w = 1
    while w < ln.BASES_PER_LANE:
        f = (f << np.uint32(2 * w)) | _shift_pos(f, w)
        r = r | (_shift_pos(r, w) << np.uint32(2 * w))
        w *= 2
    return f, r


def kmer_lanes_from_packs(fwd_pack: jnp.ndarray, rc_pack: jnp.ndarray, k: int):
    """All-position k-mer lanes: returns (fwd, rc), each lane-major
    (L, B, P).

    Derivation (V = forward value, rcV = reverse-complement value, r = bases
    in the top lane, lane j=0 most significant):
      fwd lane j>0 covers bases [r+16(j-1), r+16j)      -> M(p + r + 16(j-1))
      fwd lane 0   covers bases [0, r)                  -> M(p) >> 2(16-r)
      rc  lane j   covers rcV exponents [16(L-1-j), ..) -> rcM(p + 16(L-1-j)),
                   top lane masked to its 2r low bits.
    """
    L = ln.num_lanes(k)
    r = ln.top_lane_bases(k)  # bases in top lane, 1..16
    fwd = []
    rc = []
    for j in range(L):
        if j == 0:
            f = fwd_pack >> np.uint32(2 * (ln.BASES_PER_LANE - r))
        else:
            f = _shift_pos(fwd_pack, r + 16 * (j - 1))
        rcl = _shift_pos(rc_pack, 16 * (L - 1 - j))
        if j == 0:
            rcl = rcl & np.uint32((1 << (2 * r)) - 1)
        fwd.append(f)
        rc.append(rcl)
    return jnp.stack(fwd, axis=0), jnp.stack(rc, axis=0)


def extract_canonical(words: jnp.ndarray, lengths: jnp.ndarray, k: int,
                      with_strand: bool = False):
    """Canonical k-mers at every read position.

    Args:
      words:   (B, W) uint32 packed reads (io.packing layout)
      lengths: (B,) int32 read lengths
      k:       static k-mer size
      with_strand: also return which orientation was canonical

    Returns:
      canon: lane-major (L, B, P) uint32 canonical k-mer lanes (P = W*16)
      valid: (B, P) bool — position p holds a real k-mer (p + k <= length)
      [use_rc: (B, P) bool — canonical = reverse complement of the as-read
       orientation (the strand bit first-occurrence ordering records so
       compaction can restore as-read orientation; ops.runchains)]
    """
    bases = decode_words(words)
    P = bases.shape[1]
    fwd_pack, rc_pack = window_packs(bases)
    fwd, rc = kmer_lanes_from_packs(fwd_pack, rc_pack, k)
    use_rc = ln.less(rc, fwd)
    canon = jnp.where(use_rc[None], rc, fwd)
    pos = jnp.arange(P, dtype=jnp.int32)[None, :]
    valid = pos <= (lengths[:, None] - k)
    if with_strand:
        return canon, valid, use_rc
    return canon, valid
