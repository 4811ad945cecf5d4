"""Chain extraction: pointer-jumping unitig assembly over successor arrays.

Device-side replacement for the reference's glue phase (gatb
bcalm2/bglue_algo.cpp: MPHF + concurrent union-find + per-class chain
walking — reconstructed, SURVEY.md §4.4) and for its sequential bucket
chain-walking.  The successor array from ops.junctions defines a
mirror-symmetric functional graph of paths and cycles over the 2N oriented
nodes; unitigs are recovered with ONE fused pointer-doubling loop.

Fused state per oriented node v (all propagated along predecessor jumps):

  ptr  — current ancestor (doubles every round; fixes at the chain start)
  dist — #pred-steps from v to ptr (saturates at the path rank)
  mn   — minimal oriented id among {v} ∪ visited ancestors
  dmn  — #pred-steps from v back to mn

After convergence:
  * path nodes:  ptr = chain start, dist = rank.
  * cycle nodes: ancestors cover the whole cycle, so mn = the cycle's
    minimal node b (the deterministic break point — circular unitigs come
    out as one contig, the behavior example/circular_unitigs_unittests
    asks for), and because pred is the inverse of succ, dmn (backward
    steps to b) equals the FORWARD rank from b.  No separate cycle-break
    or re-ranking pass is needed.

Mirror deduplication: every unitig appears as a chain and its mirror
chain (bidirected-graphs-in-bcalm2.md:79); keep the one whose start has
the smaller oriented id (deterministic, unlike the reference —
README.md:87 documents its orientation instability).

The mirror chain's start (needed for mirror dedup) is NOT propagated:
for a broken cycle it is the mirror cycle's minimum, which after
convergence is simply mn[mirror(v)] — the mirror node sits in the
mirror cycle.

Performance: each round gathers the packed (M, 4) int32 state with ONE
16-byte-aligned row gather instead of six scalar gathers — gathers are
index-rate-bound, so one row gather moves the state for a fraction of
the index traffic of separate gathers, and the single fused loop
replaces the previous three (cycle detect / min propagate / rank) loops.  Rounds run under lax.while_loop
with a convergence test, so the count adapts to the longest chain
rather than log2(N) when there are no cycles.
"""

from __future__ import annotations

from functools import partial as _partial

import numpy as np
import jax
import jax.numpy as jnp

from bcalm_tpu.ops.count import compact

# packed state columns (16-byte rows -> aligned row gathers)
_PTR, _DIST, _MN, _DMN = 0, 1, 2, 3
_COLS = 4


def _mirror(x: jnp.ndarray, N: int) -> jnp.ndarray:
    return jnp.where(x >= N, x - N, x + N)


def _max_rounds(M: int) -> int:
    """Doubling rounds that cover any chain/cycle length (window 2^t >= M).

    The iteration CAP is load-bearing: on a cycle, ptr never reaches a
    fixpoint, so convergence alone would spin forever."""
    return max(1, int(np.ceil(np.log2(max(M, 2)))) + 1)


def init_state(pred: jnp.ndarray, valid: jnp.ndarray,
               gidx: jnp.ndarray, big: int) -> jnp.ndarray:
    """Initial (n, 4) pointer-jumping state rows for nodes with global ids
    `gidx` (pred values are global ids too; `big` pads invalid mn)."""
    has_pred = pred >= 0
    return jnp.stack(
        [
            jnp.where(has_pred, pred, gidx),
            has_pred.astype(jnp.int32),
            jnp.where(valid, gidx, big),
            jnp.zeros(pred.shape, jnp.int32),  # dmn starts at 0 (mn = self)
        ],
        axis=1,
    )


def round_update(state: jnp.ndarray, anc: jnp.ndarray) -> jnp.ndarray:
    """One doubling round given each node's current-ancestor rows `anc`
    (anc = state-table rows at state[:, _PTR]; the lookup is the caller's —
    a local row gather, or an all_gather + gather when the table is
    sharded over a mesh)."""
    dist = state[:, _DIST]
    mn = state[:, _MN]
    better = anc[:, _MN] < mn
    return jnp.stack(
        [
            anc[:, _PTR],
            dist + anc[:, _DIST],
            jnp.minimum(mn, anc[:, _MN]),
            jnp.where(better, dist + anc[:, _DMN], state[:, _DMN]),
        ],
        axis=1,
    )


def build_pred(succ: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Predecessor array (unique by construction: in-degree <= 1).

    Scatter-free: the successor graph is mirror-symmetric (edge v->w
    exists iff edge mirror(w)->mirror(v) exists), so
    pred(v) = mirror(succ(mirror(v))) — a half-rotation (static
    slice-concat) plus elementwise mirror of the values, with no
    scatter at all."""
    M = succ.shape[0]
    N = M // 2
    succ = jnp.where(valid, succ, -1)
    s_m = jnp.concatenate([succ[N:], succ[:N]])  # succ[mirror(v)]
    return jnp.where(s_m >= 0, _mirror(s_m, N), -1)


def finish(succ: jnp.ndarray, pred: jnp.ndarray, valid: jnp.ndarray,
           state: jnp.ndarray):
    """Chain bookkeeping after the doubling loop converged (global layout:
    oriented ids [0, N) = + strand, [N, 2N) = - strand)."""
    M = succ.shape[0]
    N = M // 2
    idx = jnp.arange(M, dtype=jnp.int32)
    succ = jnp.where(valid, succ, -1)
    has_pred = pred >= 0

    ptr = state[:, _PTR]
    dist = state[:, _DIST]
    mn = state[:, _MN]
    dmn = state[:, _DMN]
    # mirror cycle's minimum, read off the converged mn of the mirror node
    # (the mirror node sits in the mirror cycle) — no propagated column
    mmn = mn[_mirror(idx, N)]

    # a path node's ptr settles at a start (pred = -1); cycle nodes never do
    in_cycle = valid & (pred[ptr] >= 0)
    break_node = in_cycle & (mn == idx)

    start = jnp.where(in_cycle, mn, ptr)
    rank = jnp.where(in_cycle, dmn, dist)

    is_start = valid & (~has_pred | break_node)
    # chain terminal: no successor, or (broken cycle) the node feeding the
    # break node
    is_end = valid & ((succ < 0) | (in_cycle & (succ == mn)))
    end_of = jnp.full((M,), -1, dtype=jnp.int32)
    # one end per chain start: in-bounds destinations are unique
    end_of = end_of.at[jnp.where(is_end, start, M)].set(
        jnp.where(is_end, idx, -1), mode="drop"
    )

    # mirror dedupe: keep the chain whose start id < mirror chain's start id.
    # For a path chain the mirror chain starts at mirror(end); for a broken
    # cycle it starts at the mirror cycle's own minimal node (mmn).
    mirror_start = jnp.where(
        break_node, mmn, _mirror(jnp.where(end_of >= 0, end_of, idx), N)
    )
    keep = is_start & (end_of >= 0) & (idx < mirror_start)

    # dense unitig ids in start-id order
    uid_at_start = jnp.cumsum(keep.astype(jnp.int32)) - 1
    n_unitigs = jnp.sum(keep.astype(jnp.int32))

    kept_start = keep[start]
    uid = jnp.where(valid & kept_start, uid_at_start[start], -1)
    length_at_start = jax.ops.segment_max(
        jnp.where(valid, rank, -1) + 1,
        jnp.where(valid, start, M - 1),
        num_segments=M,
    )
    circular_at_start = break_node  # a kept broken node starts a circular chain

    (start_oid, length, circular), _ = compact(
        keep, (idx, length_at_start, circular_at_start)
    )
    return {
        "uid": uid,
        "rank": jnp.where(uid >= 0, rank, 0),
        "n_unitigs": n_unitigs,
        "start_oid": start_oid,
        "length": length,
        "circular": circular,
    }


def jump_loop(pred: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Run the doubling loop to convergence on one device."""
    M = pred.shape[0]
    idx = jnp.arange(M, dtype=jnp.int32)
    state0 = init_state(pred, valid, idx, M)
    R = _max_rounds(M)

    def cond(carry):
        state, changed, t = carry
        return changed & (t < R)

    def body(carry):
        state, _, t = carry
        anc = jnp.take(state, state[:, _PTR], axis=0)  # one row gather
        new = round_update(state, anc)
        # convergence: for paths everything settles at coverage; cycles run
        # to the cap R (ptr keeps orbiting)
        return new, jnp.any(new != state), t + 1

    state, _, _ = jax.lax.while_loop(
        cond, body, (state0, jnp.asarray(True), jnp.asarray(0))
    )
    return state


# ---------------------------------------------------------------------------
# Fast path: rooted-flag pointer jumping + hierarchical sampled contraction.
#
# Motivation: random gathers are index-rate-bound rather than
# byte-bound, so the doubling loop's cost is (rounds x live indices).
# Two levers:
#   1. a ROOTED flag propagated through composition makes rows absorbing
#      once their span reaches a chain start — removing finish()'s
#      pred[ptr] gather and letting the while_loop freeze settled rows;
#   2. hierarchical contraction: sample ~1/8 of nodes as level-fixpoints
#      (served as identity rows so other queries STOP there), converge the
#      short gaps in <=R_A rounds, then recurse on the contracted list
#      (capacity /4 per level).  Long chains pay R_A full-size rounds +
#      geometrically shrinking levels instead of log2(M) full-size rounds.
#      Composition state is a monoid, so spans accumulated per level
#      compose exactly on the way back up; cycles survive contraction
#      (their min/dmn columns accumulate over whole wraps) and resolve at
#      the deepest level exactly as in the plain loop.
#
# Flags are PACKED into the high bits of the dist column (state rows stay
# 4 x int32 = 16 bytes: wider rows fall off XLA's fast row-gather path):
# ROOTED (span reaches a chain start: absorbing, final), FIX (this SERVED
# row is a level-fixpoint identity), SETTLED (query's target served
# identity — no further level-local progress needed).  Distances are
# exact in the low 28 bits (any M fits: 2N <= 2^28 k-mers is more than
# one device's memory holds).
# ---------------------------------------------------------------------------

_DSF = _DIST            # dist-plus-flags column (alias for readability)
_F_SETTLED = np.int32(1 << 28)
_F_FIX = np.int32(1 << 29)
_F_ROOTED = np.int32(1 << 30)
_DMASK = np.int32((1 << 28) - 1)

_HIER_MIN = 1 << 18     # below this, plain doubling wins (fewer passes)
_FINAL_CAP = 1 << 15    # deepest level size: plain doubling there
_SAMPLE_DIV = 8         # fixpoint sampling rate 1/8
_LEVEL_SHRINK = 4       # static capacity per level
_R_A = 5                # phase-A round cap (covers gaps <= 32; at sample
                        # rate 1/8, P(gap>32) = (7/8)^32 ~ 1.4%, and the
                        # unresolved targets are contracted anyway via
                        # tmask, well inside the S/4 level capacity)


def _composeF(q: jnp.ndarray, anc: jnp.ndarray) -> jnp.ndarray:
    """Span composition (v..q.ptr] o (q.ptr..anc.ptr]; ROOTED rows absorb."""
    qd = q[:, _DSF]
    ad = anc[:, _DSF]
    rooted_q = (qd & _F_ROOTED) != 0
    dq = qd & _DMASK
    # SATURATE: on a cycle dist doubles every round across contraction
    # levels and would wrap into the flag bits (a >= 4-level cycle would
    # end phase A spuriously SETTLED and be dropped).  Path spans are
    # exact (<= M < 2^28, never saturate); cycle rank uses dmn, whose
    # final better-update happens while the window is < 2x the cycle
    # length, so dmn stays exact for cycles up to 2^27 nodes.
    dist = jnp.minimum(dq + (ad & _DMASK), _DMASK)
    stop = (ad & (_F_FIX | _F_ROOTED)) != 0
    flg = ((qd | ad) & _F_ROOTED) | jnp.where(stop, _F_SETTLED,
                                              np.int32(0))
    better = anc[:, _MN] < q[:, _MN]
    new = jnp.stack(
        [
            anc[:, _PTR],
            dist | flg,
            jnp.minimum(q[:, _MN], anc[:, _MN]),
            jnp.where(better, dq + anc[:, _DMN], q[:, _DMN]),
        ],
        axis=1,
    )
    return jnp.where(rooted_q[:, None], q, new)


def _identity_rows(local_idx, gid, flg_rooted):
    z = jnp.zeros_like(local_idx)
    return jnp.stack(
        [local_idx,
         _F_FIX | jnp.where(flg_rooted, _F_ROOTED | _F_SETTLED,
                            np.int32(0)),
         gid, z],
        axis=1,
    )


def _phase(Q0: jnp.ndarray, fix: jnp.ndarray, gid: jnp.ndarray,
           rounds: int, converge: bool = True) -> jnp.ndarray:
    """Doubling rounds with fixpoint identity serving, to convergence or cap.

    converge=False runs exactly `rounds` rounds under fori_loop, skipping
    the full-table compare the while_loop convergence test costs per round
    — right for short capped phases (phase A) where early exit is rare."""
    S = Q0.shape[0]
    local = jnp.arange(S, dtype=jnp.int32)
    rooted0 = (Q0[:, _DSF] & _F_ROOTED) != 0
    ident = _identity_rows(local, gid, rooted0)

    def step(Q):
        rooted = (Q[:, _DSF] & _F_ROOTED) != 0
        T = jnp.where((fix & ~rooted)[:, None], ident, Q)
        # rooted rows may carry original-space ptrs (absorbing, composed
        # result discarded by the guard) — clip keeps the gather in-bounds
        anc = jnp.take(T, Q[:, _PTR], axis=0, mode="clip")
        return _composeF(Q, anc)

    if not converge:
        return jax.lax.fori_loop(0, rounds, lambda t, Q: step(Q), Q0)

    def cond(carry):
        Q, changed, t = carry
        return changed & (t < rounds)

    def body(carry):
        Q, _, t = carry
        new = step(Q)
        return new, jnp.any(new != Q), t + 1

    Q, _, _ = jax.lax.while_loop(
        cond, body, (Q0, jnp.asarray(True), jnp.asarray(0))
    )
    return Q


def _sampled(gid: jnp.ndarray, salt: int) -> jnp.ndarray:
    """Murmur-style mix: the salt must decorrelate levels (level-l+1 gids
    are exactly those sampled at level l, so an additive salt over one
    multiplicative hash would re-select almost nothing)."""
    h = gid.astype(jnp.uint32) ^ np.uint32(salt & 0xFFFFFFFF)
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    h = h ^ (h >> np.uint32(16))
    return (h % np.uint32(_SAMPLE_DIV)) == 0


def _absorbing_filler(S: int, big: int):
    """Static filler rows for unused level slots: rooted identity, mn=big."""
    z = jnp.zeros((S,), jnp.int32)
    return jnp.stack(
        [jnp.arange(S, dtype=jnp.int32),
         jnp.full((S,), int(_F_ROOTED | _F_SETTLED), jnp.int32),
         jnp.full((S,), big, jnp.int32), z],
        axis=1,
    )


def _init_Q(pred: jnp.ndarray, valid: jnp.ndarray,
            dist0: jnp.ndarray | None = None) -> jnp.ndarray:
    """Initial packed-flag state.  dist0 (optional) is the WEIGHT of the
    edge v -> pred(v) (= weight of pred(v)); defaults to 1.  Weighted
    jumping makes ranks/lengths come out in original-node units when the
    graph being jumped is a contraction (ops.runchains)."""
    M = pred.shape[0]
    idx = jnp.arange(M, dtype=jnp.int32)
    has_pred = (pred >= 0) & valid
    d0 = np.int32(1) if dist0 is None else dist0
    return jnp.stack(
        [
            jnp.where(has_pred, pred, idx),
            jnp.where(has_pred, d0,
                      np.int32(_F_ROOTED | _F_SETTLED)),
            jnp.where(valid, idx, M),
            jnp.zeros((M,), jnp.int32),
        ],
        axis=1,
    )


def hier_jump(pred: jnp.ndarray, valid: jnp.ndarray,
              dist0: jnp.ndarray | None = None):
    """Hierarchical pointer jumping.  Returns (state, ok) where state is
    the fully-converged packed-flag state in the original node space and
    `ok` is False if a level overflowed its static capacity
    (astronomically unlikely; the caller falls back to the plain loop)."""
    M = pred.shape[0]
    idx = jnp.arange(M, dtype=jnp.int32)
    Q = _init_Q(pred, valid, dist0)
    gid = idx
    lvl_valid = valid
    ok = jnp.asarray(True)

    # static level schedule
    sizes = [M]
    while sizes[-1] // _LEVEL_SHRINK >= _FINAL_CAP:
        sizes.append(sizes[-1] // _LEVEL_SHRINK)

    stack = []  # per level: (Q_phaseA, did, S)
    for li in range(len(sizes) - 1):
        S, S1 = sizes[li], sizes[li + 1]
        fix = _sampled(gid, 0x85EBCA6B * (li + 1)) & lvl_valid
        Q = _phase(Q, fix, gid, _R_A, converge=False)

        flg = Q[:, _DSF]
        settled = (flg & _F_SETTLED) != 0
        rooted = (flg & _F_ROOTED) != 0
        unres = lvl_valid & ~settled & ~rooted
        tmask = jnp.zeros((S,), bool).at[
            jnp.where(unres, Q[:, _PTR], S)
        ].set(True, mode="drop")
        cmask = (fix | tmask) & lvl_valid
        did = jnp.cumsum(cmask.astype(jnp.int32)) - 1
        n_c = jnp.sum(cmask.astype(jnp.int32))
        ok = ok & (n_c <= S1)
        did = jnp.where(cmask, did, S1)  # drop slot for non-contracted

        # build level li+1 by sort-based selection (a 1-column sort of the
        # selected indices + an S1-sized row gather instead of a full-size
        # scatter)
        lidx = jnp.arange(S, dtype=jnp.int32)
        sel = jnp.sort(
            jnp.where(cmask, lidx.astype(jnp.uint32), np.uint32(0xFFFFFFFF))
        )[:S1]
        pos = jnp.minimum(sel, np.uint32(S - 1)).astype(jnp.int32)
        valid1 = jnp.arange(S1, dtype=jnp.int32) < n_c
        Q1 = jnp.where(valid1[:, None], jnp.take(Q, pos, axis=0),
                       _absorbing_filler(S1, M))
        gid1 = jnp.where(valid1, jnp.take(gid, pos), M)
        # remap ptr into the contracted space (rooted rows keep their
        # ORIGINAL root id — absorbing, never dereferenced)
        rooted1 = (Q1[:, _DSF] & _F_ROOTED) != 0
        ptr_new = jnp.take(did, jnp.where(rooted1, 0, Q1[:, _PTR]),
                           mode="clip")
        Q1 = Q1.at[:, _PTR].set(jnp.where(rooted1, Q1[:, _PTR], ptr_new))
        # a level hop clears SETTLED/FIX (they were level-local)
        Q1 = Q1.at[:, _DSF].set(Q1[:, _DSF] & (_DMASK | _F_ROOTED))

        stack.append((Q, did, S))
        Q, gid, lvl_valid = Q1, gid1, valid1

    # deepest level: plain doubling (no fixpoints), cap covers any cycle
    S_last = sizes[-1]
    F = _phase(Q, jnp.zeros((S_last,), bool), gid,
               _max_rounds(S_last) + 1)

    # upward composition
    for (Qd, did, S) in reversed(stack):
        rooted_hi = (F[:, _DSF] & _F_ROOTED) != 0
        # convert F ptrs back to this level's local ids (rooted rows carry
        # original root ids already; cycle rows' ptr is unused by finish)
        parent = jnp.full((F.shape[0],), 0, jnp.int32)
        # in-bounds did values are a cumsum over cmask: unique
        parent = parent.at[did].set(jnp.arange(S, dtype=jnp.int32),
                                    mode="drop")
        Fp = jnp.where(rooted_hi, F[:, _PTR],
                       jnp.take(parent, F[:, _PTR], mode="clip"))
        F_conv = F.at[:, _PTR].set(Fp)
        rooted_q = (Qd[:, _DSF] & _F_ROOTED) != 0
        tgt = jnp.take(did, jnp.where(rooted_q, 0, Qd[:, _PTR]),
                       mode="clip")
        anc = jnp.take(F_conv, tgt, axis=0, mode="clip")
        F = _composeF(Qd, anc)
    return F, ok


def plain_jumpF(pred: jnp.ndarray, valid: jnp.ndarray,
                dist0: jnp.ndarray | None = None) -> jnp.ndarray:
    """Plain doubling in the packed-flag representation."""
    M = pred.shape[0]
    idx = jnp.arange(M, dtype=jnp.int32)
    return _phase(_init_Q(pred, valid, dist0), jnp.zeros((M,), bool), idx,
                  _max_rounds(M) + 1)


def finish_fast(succ: jnp.ndarray, pred: jnp.ndarray, valid: jnp.ndarray,
                state: jnp.ndarray, wlen: jnp.ndarray | None = None):
    """finish() on a packed-flag state: 1 gather + 2 row scatters total
    (vs 4 gathers + 3 scatters + segment_max of the original).

    wlen (optional): per-node weights; with the matching weighted jump
    (dist0 = wlen[pred]) ranks and chain lengths come out in weight units
    (chain length = rank(end) + wlen(end) instead of rank + 1)."""
    M = succ.shape[0]
    N = M // 2
    idx = jnp.arange(M, dtype=jnp.int32)
    succ = jnp.where(valid, succ, -1)
    has_pred = pred >= 0

    ptr = state[:, _PTR]
    dist = state[:, _DSF] & _DMASK
    mn = state[:, _MN]
    dmn = state[:, _DMN]
    rooted = (state[:, _DSF] & _F_ROOTED) != 0

    in_cycle = valid & ~rooted
    break_node = in_cycle & (mn == idx)
    start = jnp.where(in_cycle, mn, ptr)
    rank = jnp.where(in_cycle, dmn, dist)

    is_start = valid & (~has_pred | break_node)
    is_end = valid & ((succ < 0) | (in_cycle & (succ == mn)))

    # end id + chain length land at the start node.  Every chain has one
    # start and one end, so in-bounds destinations are unique (the scatter
    # winner is defined).  Each column is scattered separately.
    w_end = np.int32(1) if wlen is None else wlen
    e_dst = jnp.where(is_end, start, M)
    end_of = jnp.full((M,), -1, jnp.int32).at[e_dst].set(idx, mode="drop")
    length_at_start = jnp.full((M,), -1, jnp.int32).at[e_dst].set(
        rank + w_end, mode="drop")

    # mirror of mn is a half-rotation, not a gather
    mmn = jnp.roll(mn, N)
    mirror_start = jnp.where(
        break_node, mmn, _mirror(jnp.where(end_of >= 0, end_of, idx), N)
    )
    keep = is_start & (end_of >= 0) & (idx < mirror_start)

    uid_at_start = jnp.cumsum(keep.astype(jnp.int32)) - 1
    n_unitigs = jnp.sum(keep.astype(jnp.int32))

    # one gather resolves both "is my start kept" and "its unitig id"
    ks = jnp.where(keep, uid_at_start, -1)
    val = jnp.take(ks, start, mode="clip")
    uid = jnp.where(valid & (val >= 0), val, -1)

    # compacted per-unitig outputs (destinations: a cumsum over keep,
    # unique; circular flag packed into bit 30 of the length word;
    # length <= M < 2^30)
    pk = length_at_start | jnp.where(break_node, np.int32(1 << 30),
                                     np.int32(0))
    u_dst = jnp.where(keep, uid_at_start, M)
    start_oid = jnp.zeros((M,), jnp.int32).at[u_dst].set(idx, mode="drop")
    lenw = jnp.zeros((M,), jnp.int32).at[u_dst].set(pk, mode="drop")
    return {
        "uid": uid,
        "rank": jnp.where(uid >= 0, rank, 0),
        "n_unitigs": n_unitigs,
        "start_oid": start_oid,
        "length": lenw & np.int32((1 << 30) - 1),
        "circular": (lenw & np.int32(1 << 30)) != 0,
    }


@_partial(jax.jit, static_argnames=("variant",))
def chain_decompose(succ: jnp.ndarray, valid: jnp.ndarray,
                    variant: str = "auto"):
    """Decompose the successor graph into deduplicated unitig chains.

    Args:
      succ:  (2N,) int32 oriented successor ids (-1 = none); mirror-symmetric
      valid: (2N,) bool — oriented node is backed by a real solid k-mer
      variant: "auto" (hierarchical above _HIER_MIN), "plain", or "hier"

    Returns dict with:
      uid:      (2N,) int32 unitig id per oriented node (-1 if node's chain
                was dropped as a mirror duplicate or node invalid)
      rank:     (2N,) int32 position of the node within its unitig
      n_unitigs: () int32 — NEGATIVE iff the hierarchical path overflowed a
                level capacity (astronomically unlikely); the caller must
                rerun with variant="plain" (engine.compact_solid does).
                A data-dependent lax.cond fallback here would compile BOTH
                jump loops into every program, so the rare retry is
                host-driven instead.
      start_oid:(2N,) int32 per-unitig start oriented node (compacted)
      length:   (2N,) int32 per-unitig k-mer count (compacted)
      circular: (2N,) bool per-unitig circular flag (compacted)
    """
    pred = build_pred(succ, valid)
    M = succ.shape[0]
    use_hier = variant == "hier" or (variant == "auto" and M >= _HIER_MIN)
    if use_hier:
        state, ok = hier_jump(pred, valid)
    else:
        state = plain_jumpF(pred, valid)
        ok = jnp.asarray(True)
    info = finish_fast(succ, pred, valid, state)
    info["n_unitigs"] = jnp.where(ok, info["n_unitigs"], -1)
    return info
