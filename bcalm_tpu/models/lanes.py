"""Multi-lane 2-bit k-mer arithmetic (replacement for gatb LargeInt).

The reference supports arbitrary k via compile-time multi-limb integers
(gatb tools/math/LargeInt, instantiated per KSIZE_LIST — see
/root/reference/README.md:93-99 and the runtime span dispatch at
/root/reference/src/bcalm_1.cpp:95).  Here the native integer width is
32 bits, so a k-mer is represented as ``L = ceil(k/16)`` uint32 lanes,
16 bases per lane, **most-significant lane first**:

    value(kmer) = sum_i base_i * 4**(k-1-i)      (base-4 big-endian)

with the value right-aligned in the 2*16*L bit field.  Because every k-mer
in a run has the same k, integer order == lexicographic string order, so
multi-operand `lax.sort` over the lane tuple sorts k-mers lexicographically.

LAYOUT: device arrays are **lane-major**: shape (L, ...batch...), lane 0
first.  The batch axis stays the minor (contiguous) dimension, so each
lane is one contiguous (N,) vector that sorts, gathers and streams at
memory speed; a lane-minor (N, L) layout with L=2..4 would interleave
the lanes and make every per-lane pass strided.

Base encoding follows gatb's convention A=0, C=1, T=2, G=3 so that
complement(b) == b XOR 2 (independently re-derived; the same packing is
used by the reference's own oracle, /root/reference/scripts/unitigEvaluator.cpp:70-82).

`L` and `k` are static Python ints — each (k, L) combination
traces/compiles once, the analog of the reference's KSIZE_LIST template
instantiation.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# Base codes (gatb convention): complement = code ^ 2.
BASE_A, BASE_C, BASE_T, BASE_G = 0, 1, 2, 3
BASE_TO_CHAR = np.array(list("ACTG"))
CHAR_TO_BASE = {"A": 0, "C": 1, "T": 2, "G": 3, "a": 0, "c": 1, "t": 2, "g": 3}

BASES_PER_LANE = 16
_U32 = jnp.uint32

# 2-bit-group reversal masks (per 32-bit lane).
_M2 = np.uint32(0x33333333)
_M4 = np.uint32(0x0F0F0F0F)
_M8 = np.uint32(0x00FF00FF)
_COMP = np.uint32(0xAAAAAAAA)  # XOR '10' per base == complement every base
_FULL = np.uint32(0xFFFFFFFF)


def num_lanes(k: int) -> int:
    """Lanes needed for a k-mer: ceil(k / 16)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    return (k + BASES_PER_LANE - 1) // BASES_PER_LANE


def top_lane_bases(k: int) -> int:
    """Number of bases stored in the most-significant lane (in 1..16)."""
    r = k % BASES_PER_LANE
    return BASES_PER_LANE if r == 0 else r


def lane_mask(k: int) -> np.ndarray:
    """Per-lane AND-mask zeroing bits above the k-mer's 2k-bit field, shape (L,)."""
    L = num_lanes(k)
    r = top_lane_bases(k)
    m = np.full((L,), _FULL, dtype=np.uint32)
    if r < BASES_PER_LANE:
        m[0] = np.uint32((1 << (2 * r)) - 1)
    return m


def _bmask(mask_1d: np.ndarray, ndim: int) -> jnp.ndarray:
    """Reshape a per-lane (L,) mask for broadcasting over (L, ...batch)."""
    return jnp.asarray(mask_1d.reshape((mask_1d.shape[0],) + (1,) * (ndim - 1)))


# ---------------------------------------------------------------------------
# python-int <-> lanes (host-side helpers, used by tests/oracle/IO)
# ---------------------------------------------------------------------------

def int_to_lanes(x: int, k: int) -> np.ndarray:
    """Python big-int k-mer value -> (L,) uint32 lanes (numpy, host-side)."""
    L = num_lanes(k)
    out = np.zeros((L,), dtype=np.uint32)
    for j in range(L - 1, -1, -1):
        out[j] = np.uint32(x & 0xFFFFFFFF)
        x >>= 32
    return out


def ints_to_lanes(xs, k: int) -> np.ndarray:
    """Iterable of big-ints -> lane-major (L, N) uint32."""
    rows = [int_to_lanes(int(x), k) for x in xs]
    if not rows:
        return np.zeros((num_lanes(k), 0), np.uint32)
    return np.stack(rows, axis=1)


def lanes_to_int(lanes) -> int:
    """(L,) lanes -> python big-int (host-side)."""
    arr = np.asarray(lanes, dtype=np.uint32)
    if arr.ndim != 1:
        raise ValueError("lanes_to_int expects a single k-mer (1-D lanes)")
    x = 0
    for j in range(arr.shape[0]):
        x = (x << 32) | int(arr[j])
    return x


def lanes_to_ints(lanes) -> np.ndarray:
    """Lane-major (L, N) lanes -> (N,) array of python big-ints."""
    arr = np.asarray(lanes, dtype=np.uint32)
    x = np.zeros(arr.shape[1:], dtype=object)
    for j in range(arr.shape[0]):
        x = (x << 32) | arr[j].astype(object)
    return x


def string_to_int(s: str) -> int:
    """DNA string -> base-4 big-endian integer."""
    x = 0
    for ch in s:
        x = (x << 2) | CHAR_TO_BASE[ch]
    return x


def int_to_string(x: int, k: int) -> str:
    out = []
    for i in range(k):
        out.append("ACTG"[(x >> (2 * (k - 1 - i))) & 3])
    return "".join(out)


# ---------------------------------------------------------------------------
# lane-field bit shifts (static shift amounts); lanes shape (L, ...batch)
# ---------------------------------------------------------------------------

def shift_right_bits(lanes: jnp.ndarray, s: int) -> jnp.ndarray:
    """Logical right shift of the whole multi-lane field by `s` bits (static)."""
    if s == 0:
        return lanes
    L = lanes.shape[0]
    lane_move, bit = divmod(s, 32)
    if lane_move:
        pad = jnp.zeros((lane_move,) + lanes.shape[1:], dtype=_U32)
        lanes = jnp.concatenate([pad, lanes[: L - lane_move]], axis=0)
    if bit:
        hi = jnp.concatenate(
            [jnp.zeros((1,) + lanes.shape[1:], dtype=_U32), lanes[:-1]], axis=0
        )
        lanes = (lanes >> np.uint32(bit)) | (hi << np.uint32(32 - bit))
    return lanes


def shift_left_bits(lanes: jnp.ndarray, s: int) -> jnp.ndarray:
    """Logical left shift of the whole multi-lane field by `s` bits (static).

    Bits shifted beyond the top lane are lost (callers mask with lane_mask).
    """
    if s == 0:
        return lanes
    L = lanes.shape[0]
    lane_move, bit = divmod(s, 32)
    if lane_move:
        pad = jnp.zeros((lane_move,) + lanes.shape[1:], dtype=_U32)
        lanes = jnp.concatenate([lanes[lane_move:], pad], axis=0)
    if bit:
        lo = jnp.concatenate(
            [lanes[1:], jnp.zeros((1,) + lanes.shape[1:], dtype=_U32)], axis=0
        )
        lanes = (lanes << np.uint32(bit)) | (lo >> np.uint32(32 - bit))
    return lanes


# ---------------------------------------------------------------------------
# reverse complement / canonicalization
# ---------------------------------------------------------------------------

def _reverse_bases_in_lane(x: jnp.ndarray) -> jnp.ndarray:
    """Reverse the 16 2-bit base fields inside each uint32 (elementwise
    bit tricks)."""
    x = ((x >> np.uint32(2)) & _M2) | ((x & _M2) << np.uint32(2))
    x = ((x >> np.uint32(4)) & _M4) | ((x & _M4) << np.uint32(4))
    x = ((x >> np.uint32(8)) & _M8) | ((x & _M8) << np.uint32(8))
    x = (x >> np.uint32(16)) | (x << np.uint32(16))
    return x


def revcomp(lanes: jnp.ndarray, k: int) -> jnp.ndarray:
    """Reverse complement of (L, ...) k-mers.

    Reverse all 2-bit groups of the 32L-bit field (per-lane base reversal +
    lane-order reversal), complement, then realign right by 32L - 2k bits.
    """
    L = lanes.shape[0]
    rev = _reverse_bases_in_lane(lanes ^ _COMP)[::-1]
    return shift_right_bits(rev, 32 * L - 2 * k)


def less(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Lexicographic a < b over the lane axis; returns bool of batch shape."""
    L = a.shape[0]
    lt = a[L - 1] < b[L - 1]
    for j in range(L - 2, -1, -1):
        lt = (a[j] < b[j]) | ((a[j] == b[j]) & lt)
    return lt


def equal(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.all(a == b, axis=0)


def canonical(lanes: jnp.ndarray, k: int):
    """Canonical form min(kmer, revcomp) (reference semantics:
    /root/reference/README.md:84-85).

    Returns (canon_lanes, was_rc) where was_rc is True where the reverse
    complement was strictly smaller.
    """
    rc = revcomp(lanes, k)
    was_rc = less(rc, lanes)
    canon = jnp.where(was_rc[None], rc, lanes)
    return canon, was_rc


def is_palindrome(lanes: jnp.ndarray, k: int) -> jnp.ndarray:
    """kmer == revcomp(kmer).  Only possible for even k (spec:
    bidirected-graphs-in-bcalm2.md:57 — odd-length strings are never their
    own reverse complement)."""
    if k % 2 == 1:
        return jnp.zeros(lanes.shape[1:], dtype=bool)
    return equal(lanes, revcomp(lanes, k))


# ---------------------------------------------------------------------------
# affix extraction (the (k-1)-mer junction keys of the compaction stage)
# ---------------------------------------------------------------------------

def suffix_kminus1(lanes: jnp.ndarray, k: int) -> jnp.ndarray:
    """Last k-1 bases as a right-aligned (k-1)-mer (drops the top base)."""
    L2 = num_lanes(k - 1)
    out = lanes[lanes.shape[0] - L2 :]
    return out & _bmask(lane_mask(k - 1), out.ndim)


def prefix_kminus1(lanes: jnp.ndarray, k: int) -> jnp.ndarray:
    """First k-1 bases as a right-aligned (k-1)-mer (value >> 2)."""
    L2 = num_lanes(k - 1)
    out = shift_right_bits(lanes, 2)
    return out[lanes.shape[0] - L2 :]


def first_base(lanes: jnp.ndarray, k: int) -> jnp.ndarray:
    """Most-significant base code, shape = batch shape, uint32."""
    r = top_lane_bases(k)
    return (lanes[0] >> np.uint32(2 * (r - 1))) & np.uint32(3)


def last_base(lanes: jnp.ndarray, k: int) -> jnp.ndarray:
    """Least-significant base code."""
    return lanes[-1] & np.uint32(3)


def append_base(lanes: jnp.ndarray, base, k: int) -> jnp.ndarray:
    """(kmer << 2 | base) mod 4^k — the rolling-extension step."""
    out = shift_left_bits(lanes, 2)
    out = out.at[-1].set(out[-1] | jnp.asarray(base, _U32))
    return out & _bmask(lane_mask(k), out.ndim)
