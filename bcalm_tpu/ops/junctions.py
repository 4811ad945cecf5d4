"""Junction classification: vectorized (k-1)-overlap matching.

Device-side replacement for the reference's bucket compaction + glue
machinery (gatb bcalm2/ograph.cpp hash-chaining, bcalm2/bglue_algo.cpp +
unionFind.hpp — reconstructed, SURVEY.md §3.2/§4.3-4.4).  Instead of
pointer-chasing hash tables and a concurrent union-find, the bi-directed
degree conditions of the unitig definition
(/root/reference/bidirected-graphs-in-bcalm2/bidirected-graphs-in-bcalm2.md:83-88)
are evaluated for ALL nodes at once with one sort over (k-1)-mer junction
keys plus neighbor comparisons.

Model
-----
Node i = canonical solid k-mer, oriented nodes (i,+)=i and (i,-)=i+N.
Each oriented node (i,o) has an out-end (its suffix (k-1)-mer) and an
in-end (its prefix).  Two oriented nodes are linked by an edge iff the
out-end string of one equals the in-end string of the other
(bidirected-graphs-in-bcalm2.md:39-46).  Each physical side of a k-mer
(suffix / prefix) yields TWO entries, one OUT and one IN, for the two
orientations:

    suffix s_i -> (key=canon(s_i), strand=sigma,   OUT, oid=i)
                  (key=canon(s_i), strand=1-sigma, IN,  oid=i+N)
    prefix p_i -> (key=canon(p_i), strand=tau,     IN,  oid=i)
                  (key=canon(p_i), strand=1-tau,   OUT, oid=i+N)

Palindromic (k-1)-mers (k odd => k-1 even: exactly the self-mirror edges,
bidirected-graphs-in-bcalm2.md:30,57) match BOTH strands; their strand is
forced to 0 so all their entries share one group.

A unitig edge (i,o)->(j,q) requires out-degree((i,o)) == 1 AND
in-degree((j,q)) == 1.  Since a (key,strand) group contains ONLY the
matching OUT and IN ends, that is equivalent to: the group has EXACTLY two
entries, one OUT and one IN.  After sorting the entries this is a pure
neighbor comparison — no segment reductions, no gathers:

    sort by (key, strand)  ->  [.. | OUT_a IN_b | ..]  =>  succ[a] = b

plus the vertex-inequality check (a path cannot repeat a vertex; this also
breaks self-loops and self-mirror hairpins).  The successor array is a
mirror-symmetric functional graph of paths and cycles, consumed by
ops.chains.

Key packing (performance): the strand bit is folded into spare high bits
of the most-significant key lane when (k-1) % 16 != 0, else carried as one
extra lane; (role, oid) pack into a single uint32 payload.  Sort cost is
thus L2(+1) keys + 1 payload.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from bcalm_tpu.models import lanes as ln

_U32 = jnp.uint32
SENTINEL = np.uint32(0xFFFFFFFF)
ROLE_OUT = 0
ROLE_IN = 1
_ROLE_SHIFT = np.uint32(30)
_OID_MASK = np.uint32((1 << 30) - 1)


def strand_folded(k: int) -> bool:
    """True when the strand bit fits in spare bits of key lane 0."""
    return ln.top_lane_bases(k - 1) < 16


def exact_key_ops(k: int) -> int:
    """Sort operand count of the exact-key junction sort: key lanes + 1
    payload.  (The halved-entry design emits only strand-0
    representatives, so the strand bit is NOT among the sort keys —
    successor_arrays' docstring.)"""
    return ln.num_lanes(k - 1) + 1


def use_hash_keys(k: int) -> bool:
    """Engage the 96-bit hashed junction keys when they reduce the sort
    operand count (k-1 > 48 bases).  The hash sort is 4 operands for ANY
    k (3 hash words + payload) vs L2+1(+1) for exact keys — at k=51 that
    is a 20% sort-memory cut and at k=127 a 55% cut, which raises the
    single-device junction-stage ceiling (docs/OOC.md 'Single-chip
    compaction ceiling').

    Exactness: two distinct (key, strand) sides colliding in all 96 bits
    happens with probability ~n^2/2^97 (~5e-13 at n=2^28 entries) — far
    below ambient soft-error rates; the exact path remains the default
    whenever it is no wider than the hash sort."""
    return exact_key_ops(k) > 4


_H1 = np.uint32(0x85EBCA6B)
_H2 = np.uint32(0xC2B2AE35)
_H3 = np.uint32(0x27D4EB2F)
_F1 = np.uint32(0x7FEB352D)
_F2 = np.uint32(0x846CA68B)


def _mix32(h: jnp.ndarray) -> jnp.ndarray:
    """xorshift-multiply finalizer (murmur3/lowbias32 style)."""
    h = h ^ (h >> np.uint32(16))
    h = h * _F1
    h = h ^ (h >> np.uint32(15))
    h = h * _F2
    return h ^ (h >> np.uint32(16))


def _hash96(keys: jnp.ndarray):
    """(L2, N) key lanes -> three independent u32 hash words
    (multiplicative chains with distinct odd constants, every lane step
    finalized by _mix32).

    The per-step mix is load-bearing: in a bare (h ^ lane) * C + j chain
    a flip of bit 31 only flips bit 31 of the product, so keys whose
    lanes j and j+1 BOTH differ in bit 31 (the top base of each lane
    complemented, A<->T or C<->G) collide in all three words at once —
    a structural collision that real reads with substitution errors
    produce, and that merges two junction groups into one."""
    h0 = jnp.full(keys.shape[1], np.uint32(0x9E3779B1), _U32)
    h1 = jnp.full(keys.shape[1], np.uint32(0x61C88647), _U32)
    h2 = jnp.full(keys.shape[1], np.uint32(0x2545F491), _U32)
    for j in range(keys.shape[0]):
        lane = keys[j]
        h0 = _mix32((h0 ^ lane) * _H1 + np.uint32(j + 1))
        h1 = _mix32((h1 ^ lane) * _H2 + np.uint32(2 * j + 1))
        h2 = _mix32((h2 ^ lane) * _H3 + np.uint32(3 * j + 1))
    return h0, h1, h2


def _make_keys(keys: jnp.ndarray, strand: jnp.ndarray, valid, k: int):
    """Fold strand (and validity sentinel) into lane-major key lanes.

    keys: (L2, N); returns (K, N) uint32 where K = L2 (+1 if no spare bits).
    """
    if strand_folded(k):
        r = ln.top_lane_bases(k - 1)
        lane0 = keys[0] | (strand << np.uint32(2 * r))
        out = jnp.concatenate([lane0[None], keys[1:]], axis=0)
    else:
        out = jnp.concatenate([strand[None], keys], axis=0)
    return jnp.where(valid[None], out, SENTINEL)


@partial(jax.jit, static_argnames=("k",))
def successor_arrays(solid: jnp.ndarray, n_solid: jnp.ndarray, k: int):
    """Successor array over the 2N oriented nodes.

    Halved entry set (2N instead of 4N): each (key, strand=1) group is the
    exact mirror image of the (key, strand=0) group, so only the strand-0
    representative of each physical side is emitted and every found edge
    (src -> dst) also sets its mirror edge mirror(dst) -> mirror(src).
    Palindromic sides are dropped outright: a palindromic key's group can
    only contain entries from palindromic sides, so it pairs either two
    entries of one side (the hairpin succ[i] = i+N, rejected by the
    vertex-inequality rule) or >= 4 entries (a junction) — never a unitig
    edge.  This also removes the strand bit from the sort keys entirely.

    Returns:
      succ: (2N,) int32 — unitig-successor oriented id, -1 if none
    """
    N = solid.shape[1]
    suf = ln.suffix_kminus1(solid, k)
    pre = ln.prefix_kminus1(solid, k)
    suf_c, sig = ln.canonical(suf, k - 1)
    pre_c, tau = ln.canonical(pre, k - 1)
    suf_pal = ln.is_palindrome(suf, k - 1)
    pre_pal = ln.is_palindrome(pre, k - 1)

    ids = jnp.arange(N, dtype=jnp.int32)
    valid1 = ids < n_solid

    # strand-0 representatives:
    #   suffix side: sig=0 -> OUT(i),   sig=1 -> IN(i+N)
    #   prefix side: tau=0 -> IN(i),    tau=1 -> OUT(i+N)
    L2 = suf_c.shape[0]
    oid_s = jnp.where(sig, ids + N, ids).astype(_U32)
    oid_p = jnp.where(tau, ids + N, ids).astype(_U32)
    role_s = sig.astype(_U32)        # ROLE_OUT=0 when sig=0
    role_p = (~tau).astype(_U32)     # ROLE_IN=1 when tau=0
    payload = jnp.concatenate([
        oid_s | (role_s << _ROLE_SHIFT),
        oid_p | (role_p << _ROLE_SHIFT),
    ])

    from bcalm_tpu.ops import sort

    if use_hash_keys(k):
        # 96-bit hashed keys: 4 sort operands for any k (see use_hash_keys)
        vs = valid1 & ~suf_pal
        vp = valid1 & ~pre_pal
        hs = _hash96(suf_c)
        hp = _hash96(pre_c)
        kw = [jnp.concatenate([jnp.where(vs, hs[i], SENTINEL),
                               jnp.where(vp, hp[i], SENTINEL)])
              for i in range(3)]
        out = sort.sort_ops(kw + [payload], num_keys=3)
        s_keys = jnp.stack(out[:3], axis=0)
        s_pay = out[3]
        s_valid = ~jnp.all(s_keys == SENTINEL, axis=0)
    else:
        keys = jnp.concatenate([
            jnp.where((valid1 & ~suf_pal)[None], suf_c, SENTINEL),
            jnp.where((valid1 & ~pre_pal)[None], pre_c, SENTINEL),
        ], axis=1)
        out = sort.sort_ops(
            [keys[j] for j in range(L2)] + [payload], num_keys=L2)
        s_keys = jnp.stack(out[:L2], axis=0)
        s_pay = out[L2]
        s_valid = s_keys[0] != SENTINEL
    eq_prev = jnp.concatenate([
        jnp.zeros((1,), bool),
        jnp.all(s_keys[:, 1:] == s_keys[:, :-1], axis=0),
    ])
    eq_next = jnp.concatenate([eq_prev[1:], jnp.zeros((1,), bool)])

    # group of exactly two entries: [i, i+1] with eq only between them
    pair_head = s_valid & ~eq_prev & eq_next & ~jnp.concatenate(
        [eq_next[1:], jnp.zeros((1,), bool)]
    )
    nxt_pay = jnp.concatenate([s_pay[1:], jnp.zeros((1,), _U32)])

    role_a = (s_pay >> _ROLE_SHIFT).astype(jnp.int32)
    role_b = (nxt_pay >> _ROLE_SHIFT).astype(jnp.int32)
    oid_a = (s_pay & _OID_MASK).astype(jnp.int32)
    oid_b = (nxt_pay & _OID_MASK).astype(jnp.int32)
    vert_a = jnp.where(oid_a >= N, oid_a - N, oid_a)
    vert_b = jnp.where(oid_b >= N, oid_b - N, oid_b)

    ok = pair_head & (role_a != role_b) & (vert_a != vert_b)
    src = jnp.where(role_a == ROLE_OUT, oid_a, oid_b)
    dst = jnp.where(role_a == ROLE_OUT, oid_b, oid_a)

    # each pair writes twice: the head slot writes succ[src] = dst, the
    # partner slot (one to the right) writes the mirror edge
    ok_t = jnp.concatenate([jnp.zeros((1,), bool), ok[:-1]])
    src_t = jnp.concatenate([jnp.zeros((1,), jnp.int32), src[:-1]])
    dst_t = jnp.concatenate([jnp.zeros((1,), jnp.int32), dst[:-1]])
    mirror = lambda x: jnp.where(x >= N, x - N, x + N)
    widx = jnp.where(ok, src, jnp.where(ok_t, mirror(dst_t), 2 * N))
    wval = jnp.where(ok, dst, mirror(src_t))

    # in-bounds widx are unique: each oriented node's out-end is ONE
    # physical side, emitted once (as OUT(v) or as IN(mirror(v))), and a
    # pair's two writes differ because vert_a != vert_b
    succ = jnp.full((2 * N,), -1, dtype=jnp.int32)
    succ = succ.at[widx].set(wval, mode="drop")
    return succ, None
