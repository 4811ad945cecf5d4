"""Locality-ordered chain decomposition: contract consecutive runs first.

The speedup over plain pointer jumping (ops.chains): random row gathers —
the doubling loop's primitive — are index-rate-bound, while sequential
scans/elementwise passes run at memory speed.  So instead of jumping
over all 2N oriented nodes, exploit the stream order of the input reads:

1. counting tracks each distinct k-mer's FIRST-OCCURRENCE stream key
   ((slot << 1) | rc-strand; ops.count.count_canonical pos operand),
2. the solid table is reordered by that key and each k-mer flipped to its
   as-read orientation (reorder_by_pos) — consecutive k-mers of a read
   now sit at consecutive table indices in matching orientation,
3. chain edges v -> v+1 ("consecutive links") therefore cover the vast
   majority of all unitig edges; maximal consecutive RUNS are contracted
   with pure segmented scans (cumulative max/min — no gathers at all),
4. pointer jumping (ops.chains, weighted by run length) runs only on the
   contracted run graph, typically 20-60x smaller,
5. per-node unitig ids/ranks are broadcast back over the runs with
   forward/backward fills (associative scans), again gather-free.

Positions are a pure performance hint: any position array (including a
wrapped-around or constant one) yields correct output — runs just get
shorter and more work lands on the contracted jump.  The contracted
capacity is chosen from the EXACT run count (one host sync), so there is
no overflow path.

Mirror-half structure: with oriented ids [0, C) = as-stored (+ strand)
and [C, 2C) = reverse complement, a + run over vertices [a..b] (edges
i -> i+1) has its mirror run over [C+b .. C+a] (edges i -> i-1), entered
at C+b and left at C+a.  Both orientations' runs are derived from ONE
forward scan over the + half.

This module replaces the reference's bucket-local compaction idea (gatb
bcalm2/bcalm_algo.cpp routes k-mers to minimizer buckets so most
compaction is bucket-local, SURVEY.md §4.3) with stream-locality blocks:
the "bucket" is the read stream itself, and the cross-bucket glue is the
contracted run graph instead of glue files.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from bcalm_tpu.models import lanes as ln
from bcalm_tpu.ops import chains as chains_op
from bcalm_tpu.ops import junctions as junctions_op

_BIG = np.uint32(0xFFFFFFFF)


@partial(jax.jit, static_argnames=("k",))
def reorder_by_pos(solid: jnp.ndarray, counts: jnp.ndarray,
                   minpos: jnp.ndarray, k: int):
    """Sort the solid set by first-occurrence key and flip each k-mer to
    its as-read orientation (strand bit = key LSB).

    Invalid slots carry the all-ones key and sort last, so the `index <
    n_solid` validity convention is preserved.  Returns
    (solid_r, counts_r) with solid_r NO LONGER canonical — downstream
    junction finding canonicalizes (k-1)-mer sides itself and never needs
    whole-k-mer canonicality.
    """
    from bcalm_tpu.ops import sort

    L = solid.shape[0]
    out = sort.sort_ops(
        [minpos] + [solid[j] for j in range(L)]
        + [counts.astype(jnp.uint32)],
        num_keys=1,
    )
    pos_s = out[0]
    lanes = jnp.stack(out[1:L + 1], axis=0)
    counts_r = out[L + 1].astype(jnp.int32)
    strand = (pos_s & np.uint32(1)) == 1
    lanes_r = jnp.where(strand[None], ln.revcomp(lanes, k), lanes)
    return lanes_r, counts_r


def _shift_fill(x: jnp.ndarray, d: int, fill) -> jnp.ndarray:
    """x shifted right by d (x[i-d] at i), front filled."""
    return jnp.concatenate([jnp.full((d,), fill, x.dtype), x[:-d]])


def _cummax(x: jnp.ndarray, lo) -> jnp.ndarray:
    """Inclusive running maximum via log-doubling shifts (O(log n)
    elementwise passes; kept instead of jax.lax.associative_scan, whose
    compile time grew badly with size on the backend this was written
    for — whether that still holds is an open measurement)."""
    n = x.shape[0]
    d = 1
    while d < n:
        x = jnp.maximum(x, _shift_fill(x, d, lo))
        d *= 2
    return x


def _cummin_rev(x: jnp.ndarray, hi) -> jnp.ndarray:
    """Reverse (suffix) running minimum via log-doubling shifts."""
    n = x.shape[0]
    d = 1
    while d < n:
        shifted = jnp.concatenate([x[d:], jnp.full((d,), hi, x.dtype)])
        x = jnp.minimum(x, shifted)
        d *= 2
    return x


@partial(jax.jit, static_argnames=("k",))
def junction_runs(solid_r: jnp.ndarray, n_solid: jnp.ndarray, k: int):
    """Successor array plus consecutive-run structure of the + half.

    Returns (succ, scan) where scan holds (C,)-shaped device arrays:
      is_head:  + run heads (no consecutive link from i-1)
      rid:      dense run id per vertex (cumsum of heads)
      head_pos: position of the run head covering each vertex
      end_pos:  position of the run tail covering each vertex
      R:        () int32 — number of runs (host-fetched for capacity)
    """
    C = solid_r.shape[1]
    succ, _ = junctions_op.successor_arrays(solid_r, n_solid, k)
    idx = jnp.arange(C, dtype=jnp.int32)
    vplus = idx < n_solid
    nxt = vplus & (succ[:C] == idx + 1) & (idx + 1 < C)
    is_head = vplus & ~jnp.concatenate([jnp.zeros((1,), bool), nxt[:-1]])
    is_tail = vplus & ~nxt
    rid = jnp.cumsum(is_head.astype(jnp.int32)) - 1
    head_pos = _cummax(jnp.where(is_head, idx, -1), -1)
    end_pos = _cummin_rev(jnp.where(is_tail, idx, C), C)
    R = jnp.sum(is_head.astype(jnp.int32))
    return succ, {
        "is_head": is_head, "rid": rid, "head_pos": head_pos,
        "end_pos": end_pos, "R": R,
    }


def _ffill(have: jnp.ndarray, vals, reverse: bool = False):
    """Segmented fill: each position takes the most recent (or, when
    reverse, the next) position's values where `have` is set.  Log-
    doubling shifts, not associative_scan (see _cummax)."""
    if reverse:
        have = jnp.flip(have)
        vals = tuple(jnp.flip(v) for v in vals)
    n = have.shape[0]
    vals = tuple(vals)
    d = 1
    while d < n:
        pv = tuple(_shift_fill(v, d, 0) for v in vals)
        ph = _shift_fill(have, d, False)
        vals = tuple(jnp.where(have, v, p) for v, p in zip(vals, pv))
        have = have | ph
        d *= 2
    if reverse:
        vals = tuple(jnp.flip(v) for v in vals)
    return vals


@partial(jax.jit, static_argnames=("variant",))
def contracted_jump(csucc: jnp.ndarray, cvalid: jnp.ndarray,
                    wlen2: jnp.ndarray, variant: str = "auto"):
    """Weighted pointer jump + finish over a contracted run graph
    (2*R_cap oriented run nodes; mirror(r) = r +- R_cap).  Shared by the
    single-chip positioned path and the distributed glue
    (parallel.distcompact.distributed_compact_pos).  Returns the
    finish_fast dict in contracted space; n_unitigs negative iff the
    hierarchical jump overflowed (caller retries variant="plain")."""
    R2 = csucc.shape[0]
    cpred = chains_op.build_pred(csucc, cvalid)
    dist0 = jnp.take(wlen2, jnp.clip(cpred, 0, R2 - 1))
    use_hier = variant == "hier" or (
        variant == "auto" and R2 >= chains_op._HIER_MIN)
    if use_hier:
        state, ok = chains_op.hier_jump(cpred, cvalid, dist0)
    else:
        state = chains_op.plain_jumpF(cpred, cvalid, dist0)
        ok = jnp.asarray(True)
    cinfo = chains_op.finish_fast(csucc, cpred, cvalid, state, wlen=wlen2)
    cinfo["n_unitigs"] = jnp.where(ok, cinfo["n_unitigs"], -1)
    return cinfo


@partial(jax.jit, static_argnames=("R_cap", "variant"))
def run_decompose(succ: jnp.ndarray, n_solid: jnp.ndarray, is_head, rid,
                  head_pos, end_pos, R, R_cap: int, variant: str = "auto"):
    """Chain decomposition over the contracted run graph.

    Output contract matches ops.chains.chain_decompose, except the
    per-unitig arrays (start_oid/length/circular) are (2*R_cap,) instead
    of (2C,) — callers slice [:n_unitigs] anyway.  n_unitigs is negative
    iff the contracted hierarchical jump overflowed (host retries with
    variant="plain")."""
    M = succ.shape[0]
    C = M // 2
    idx = jnp.arange(C, dtype=jnp.int32)
    vplus = idx < n_solid

    # ---- run representative selection (sort-based compaction) ----
    sel = jnp.sort(
        jnp.where(is_head, idx.astype(jnp.uint32), _BIG))[:R_cap]
    hpos = jnp.minimum(sel, np.uint32(C - 1)).astype(jnp.int32)
    rvalid = jnp.arange(R_cap, dtype=jnp.int32) < R
    epos = jnp.take(end_pos, hpos)
    rlen = jnp.where(rvalid, epos - hpos + 1, 0)

    # ---- contracted successor graph (2*R_cap oriented run nodes) ----
    def xlate(w):
        wv = jnp.where(w >= C, w - C, w)
        r_t = jnp.take(rid, jnp.clip(wv, 0, C - 1))
        c = jnp.where(w >= C, r_t + R_cap, r_t)
        return jnp.where((w >= 0) & rvalid, c, -1)

    w_plus = jnp.take(succ, jnp.clip(epos, 0, C - 1))       # + run tail
    w_minus = jnp.take(succ, jnp.clip(hpos + C, 0, M - 1))  # - run tail
    csucc = jnp.concatenate([xlate(w_plus), xlate(w_minus)])
    cvalid = jnp.concatenate([rvalid, rvalid])
    wlen2 = jnp.concatenate([rlen, rlen])

    # ---- weighted jump on the contracted graph ----
    cinfo = contracted_jump(csucc, cvalid, wlen2, variant=variant)
    ok = cinfo["n_unitigs"] >= 0

    # ---- per-unitig start translated to original oriented ids ----
    cstart = cinfo["start_oid"]
    csv = jnp.clip(jnp.where(cstart >= R_cap, cstart - R_cap, cstart),
                   0, R_cap - 1)
    orig_start = jnp.where(
        cstart >= R_cap, C + jnp.take(epos, csv), jnp.take(hpos, csv))

    # ---- broadcast uid/rank over run members (scatter R rows + fills;
    # distinct runs have distinct heads and tails, so every in-bounds
    # destination below is unique) ----
    cuid = cinfo["uid"]
    crank = cinfo["rank"]
    hdst = jnp.where(rvalid, hpos, C)
    a_uid = jnp.full((C,), -1, jnp.int32).at[hdst].set(
        cuid[:R_cap], mode="drop")
    a_rank = jnp.zeros((C,), jnp.int32).at[hdst].set(
        crank[:R_cap], mode="drop")
    uid_p, rank_p = _ffill(is_head, (a_uid, a_rank))
    uid_plus = jnp.where(vplus, uid_p, -1)
    rank_plus = rank_p + (idx - head_pos)

    is_tail = end_pos == idx
    edst = jnp.where(rvalid, epos, C)
    b_uid = jnp.full((C,), -1, jnp.int32).at[edst].set(
        cuid[R_cap:], mode="drop")
    b_rank = jnp.zeros((C,), jnp.int32).at[edst].set(
        crank[R_cap:], mode="drop")
    uid_m, rank_m = _ffill(is_tail, (b_uid, b_rank), reverse=True)
    uid_minus = jnp.where(vplus, uid_m, -1)
    rank_minus = rank_m + (end_pos - idx)

    uid = jnp.concatenate([uid_plus, uid_minus])
    rank = jnp.where(uid >= 0,
                     jnp.concatenate([rank_plus, rank_minus]), 0)
    n_unitigs = jnp.where(ok, cinfo["n_unitigs"], -1)
    return {
        "uid": uid,
        "rank": rank,
        "n_unitigs": n_unitigs,
        "start_oid": orig_start,
        "length": cinfo["length"],
        "circular": cinfo["circular"],
    }
