"""Distributed compaction: sharded junction matching + pointer jumping.

Replaces the reference's shared-memory glue (bglue concurrent union-find,
SURVEY.md §4.4) with mesh collectives, completing the story started by
parallel.pipeline (sharded counting):

1. each device owns a shard of the solid k-mer set (global slot ids
   assigned per device: device d owns [d*cap, (d+1)*cap)),
2. junction entries (suffix/prefix ends) are routed to the device owning
   hash(junction key) via the fixed-capacity all_to_all bucket exchange,
3. each device classifies its key groups (ops.junctions pair rule) and
   emits unitig edges (src_oid -> dst_oid),
4. edges route back to the device owning src's slot, building a sharded
   successor array,
5. chain extraction = distributed pointer jumping: each doubling round
   resolves remote jump targets with a request/response all_to_all pair
   (log(longest chain) rounds over the interconnect — the collective
   analog of the
   reference's log-free but lock-contended union-find).

All exchanges are fixed-capacity with psum'd overflow detection (never
silent).  This module provides the building blocks + a host-driven
`distributed_compact`; the CLI routes through it via `-devices N`
(pipeline.distributed_build).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax import shard_map

from bcalm_tpu.models import lanes as ln
from bcalm_tpu.ops import hashing
from bcalm_tpu.ops import junctions as junc
from bcalm_tpu.parallel.pipeline import AXIS, _route_to_buckets

_U32 = jnp.uint32
SENTINEL = np.uint32(0xFFFFFFFF)


def _exchange(bl, bv):
    """all_to_all channel-major buckets: bl (C, n_dev, cap), bv (n_dev, cap)."""
    recv_l = jax.lax.all_to_all(bl, AXIS, split_axis=1, concat_axis=1)
    recv_v = jax.lax.all_to_all(bv, AXIS, split_axis=0, concat_axis=0)
    return recv_l, recv_v


def _local_succ_shard(solid, n_local, k: int, n_dev: int, cap_entries: int,
                      slot_cap: int):
    """Per-device body: build entries, exchange by key owner, classify,
    route edges back to src owners.  Returns local succ shard (2*slot_cap,)
    plus dropped counts."""
    me = jax.lax.axis_index(AXIS)
    N = solid.shape[1]  # == slot_cap

    suf = ln.suffix_kminus1(solid, k)
    pre = ln.prefix_kminus1(solid, k)
    suf_c, sig = ln.canonical(suf, k - 1)
    pre_c, tau = ln.canonical(pre, k - 1)
    suf_pal = ln.is_palindrome(suf, k - 1)
    pre_pal = ln.is_palindrome(pre, k - 1)
    one = np.uint32(1)
    sig = jnp.where(suf_pal, False, sig).astype(_U32)
    tau = jnp.where(pre_pal, False, tau).astype(_U32)
    inv_sig = jnp.where(suf_pal, np.uint32(0), one - sig)
    inv_tau = jnp.where(pre_pal, np.uint32(0), one - tau)

    ids = jnp.arange(N, dtype=jnp.int32)
    valid1 = ids < n_local
    # GLOBAL oriented ids: + strand = global slot, - strand = slot + n_dev*cap
    gslot = me.astype(jnp.int32) * slot_cap + ids
    tot = n_dev * slot_cap
    keys = jnp.concatenate([
        junc._make_keys(suf_c, sig, valid1, k),
        junc._make_keys(suf_c, inv_sig, valid1, k),
        junc._make_keys(pre_c, tau, valid1, k),
        junc._make_keys(pre_c, inv_tau, valid1, k),
    ], axis=1)
    oid = jnp.concatenate([gslot, gslot + tot, gslot, gslot + tot]).astype(_U32)
    role = jnp.concatenate([
        jnp.zeros((N,), _U32), jnp.ones((N,), _U32),
        jnp.ones((N,), _U32), jnp.zeros((N,), _U32),
    ])
    payload = oid | (role << junc._ROLE_SHIFT)
    valid = jnp.concatenate([valid1] * 4)

    owner = (hashing.hash_lanes(keys) % np.uint32(n_dev)).astype(jnp.int32)
    stacked = jnp.concatenate([keys, payload[None]], axis=0)
    bl, bv, drop1 = _route_to_buckets(stacked, valid, owner, n_dev, cap_entries)
    recv, recv_v = _exchange(bl, bv)
    K = keys.shape[0]
    ent = recv.reshape(K + 1, -1)
    ent_valid = recv_v.reshape(-1)

    e_keys = jnp.where(ent_valid[None], ent[:K], SENTINEL)
    e_pay = jnp.where(ent_valid, ent[K], 0)

    out = jax.lax.sort(
        [e_keys[j] for j in range(K)] + [e_pay], num_keys=K
    )
    s_keys = jnp.stack(out[:K], axis=0)
    s_pay = out[K]
    s_valid = s_keys[0] != SENTINEL

    eq_prev = jnp.concatenate([
        jnp.zeros((1,), bool), jnp.all(s_keys[:, 1:] == s_keys[:, :-1], axis=0)
    ])
    eq_next = jnp.concatenate([eq_prev[1:], jnp.zeros((1,), bool)])
    pair_head = s_valid & ~eq_prev & eq_next & ~jnp.concatenate(
        [eq_next[1:], jnp.zeros((1,), bool)]
    )
    nxt_pay = jnp.concatenate([s_pay[1:], jnp.zeros((1,), _U32)])
    role_a = (s_pay >> junc._ROLE_SHIFT).astype(jnp.int32)
    role_b = (nxt_pay >> junc._ROLE_SHIFT).astype(jnp.int32)
    oid_a = (s_pay & junc._OID_MASK).astype(jnp.int32)
    oid_b = (nxt_pay & junc._OID_MASK).astype(jnp.int32)
    vert_a = jnp.where(oid_a >= tot, oid_a - tot, oid_a)
    vert_b = jnp.where(oid_b >= tot, oid_b - tot, oid_b)
    ok = pair_head & (role_a != role_b) & (vert_a != vert_b)
    src = jnp.where(role_a == junc.ROLE_OUT, oid_a, oid_b)
    dst = jnp.where(role_a == junc.ROLE_OUT, oid_b, oid_a)

    def scatter_edges(a, b, mask):
        """Route (a -> b) pairs to the owner of a's slot and scatter b into
        a local table indexed by a's local oriented id."""
        a_slot = jnp.where(a >= tot, a - tot, a)
        a_owner = a_slot // slot_cap
        edge = jnp.stack([a.astype(_U32), b.astype(_U32)], axis=0)
        bl, bv, drop = _route_to_buckets(edge, mask, a_owner, n_dev,
                                         cap_entries)
        recv, recv_v = _exchange(bl, bv)
        edges = recv.reshape(2, -1)
        ev = recv_v.reshape(-1)
        ea = edges[0].astype(jnp.int32)
        eb = edges[1].astype(jnp.int32)
        eslot = jnp.where(ea >= tot, ea - tot, ea) - me * slot_cap
        lidx = jnp.where(ea >= tot, eslot + slot_cap, eslot)
        # in- and out-degree <= 1: each a appears in at most one edge, so
        # in-bounds destinations are unique
        table = jnp.full((2 * slot_cap,), -1, dtype=jnp.int32)
        table = table.at[jnp.where(ev, lidx, 2 * slot_cap)].set(
            jnp.where(ev, eb, -1), mode="drop"
        )
        return table, drop

    # successor shard (edges routed to src owners) and predecessor shard
    # (same edges routed to dst owners) — pred is succ's inverse and feeds
    # the sharded pointer-jumping loop directly
    succ, drop2 = scatter_edges(src, dst, ok)
    pred, drop3 = scatter_edges(dst, src, ok)
    dropped = jax.lax.psum(drop1 + drop2 + drop3, AXIS)
    return succ, pred, dropped


def succ_shard_fn(mesh, k: int, n_dev: int, cap_entries: int, slot_cap: int):
    fn = shard_map(
        partial(_local_succ_shard, k=k, n_dev=n_dev, cap_entries=cap_entries,
                slot_cap=slot_cap),
        mesh=mesh,
        in_specs=(P(None, AXIS), P(AXIS)),
        out_specs=(P(AXIS), P(AXIS), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def distributed_succ(mesh, solid_sharded, n_local, k, cap_entries, slot_cap):
    """Compute the sharded successor + predecessor arrays on the mesh."""
    fn = succ_shard_fn(mesh, k, mesh.devices.size, cap_entries, slot_cap)
    succ, pred, dropped = fn(solid_sharded, n_local)
    return succ, pred, int(dropped)


def _respond(ans_rows, n_dev: int, qcap: int):
    """Return answers computed in the received-bucket layout to their
    senders.  The receive buffer's bucket j came from device j, so one
    all_to_all along the bucket axis puts every answer back at its
    querying device, at the flat slot the query was routed from — the
    `slots` array from _route_to_buckets(with_slots=True) indexes it
    directly."""
    C = ans_rows.shape[0]
    return jax.lax.all_to_all(
        ans_rows.reshape(C, n_dev, qcap), AXIS,
        split_axis=1, concat_axis=1).reshape(C, -1)


def _glue_shard(succ_l, n_loc, *, n_dev: int, slot_cap: int, run_cap: int,
                qcap: int):
    """Per-device glue body: run detection, contracted-graph construction
    via request/response rid lookups, sharded weighted pointer jumping
    over the contracted run graph, and finish — everything device-side.

    The device-side replacement for bglue's shared-memory union-find
    (gatb bcalm2/bglue_algo.cpp, example/uf/testUF.cpp:22-63): per-device
    memory is O(slot_cap + run_cap + n_dev*qcap) = O(N/n_dev) with
    bounded exchange capacities (overflow counted, host retries bigger).

    Returns per-device run arrays + per-run chain labels (see
    distributed_compact_pos for the host assembly contract).
    """
    from bcalm_tpu.ops import chains as chains_op
    from bcalm_tpu.ops.runchains import _cummax, _cummin_rev

    me = jax.lax.axis_index(AXIS).astype(jnp.int32)
    tot = n_dev * slot_cap
    C_tot = n_dev * run_cap
    lidx = jnp.arange(slot_cap, dtype=jnp.int32)
    vplus = lidx < n_loc[0]
    succ_p = succ_l[:slot_cap]
    gslot = me * slot_cap + lidx

    # ---- consecutive-run detection (local scans; shard boundaries break
    # runs, adding <= 1 run per device — the contracted graph still links
    # them through csucc) ----
    nxt = vplus & (succ_p == gslot + 1) & (lidx + 1 < slot_cap)
    is_head = vplus & ~jnp.concatenate([jnp.zeros((1,), bool), nxt[:-1]])
    is_tail = vplus & ~nxt
    rid_loc = jnp.cumsum(is_head.astype(jnp.int32)) - 1
    n_runs = jnp.sum(is_head.astype(jnp.int32))
    head_pos_v = _cummax(jnp.where(is_head, lidx, -1), -1)
    end_pos_v = _cummin_rev(jnp.where(is_tail, lidx, slot_cap), slot_cap)
    sel = jnp.sort(jnp.where(is_head, lidx.astype(jnp.uint32), SENTINEL)
                   )[:run_cap]
    hpos = jnp.minimum(sel, np.uint32(max(0, slot_cap - 1))).astype(jnp.int32)
    rvalid = jnp.arange(run_cap, dtype=jnp.int32) < n_runs
    epos = jnp.take(end_pos_v, jnp.clip(hpos, 0, slot_cap - 1))
    rlen = jnp.where(rvalid, epos - hpos + 1, 0)
    run_overflow = jax.lax.psum(
        (n_runs > run_cap).astype(jnp.int32), AXIS)

    def gq_owner(g):
        s = jnp.where(g >= C_tot, g - C_tot, g)
        return s // run_cap

    def gq_local(g):
        s = jnp.where(g >= C_tot, g - C_tot, g)
        return s % run_cap + jnp.where(g >= C_tot, run_cap, 0)

    def mirror_g(g):
        return jnp.where(g >= C_tot, g - C_tot, g + C_tot)

    # ---- contracted successors: rid + weight lookups at w's owner ----
    w_plus = jnp.take(succ_p, jnp.clip(epos, 0, slot_cap - 1))
    w_minus = jnp.take(succ_l,
                       jnp.clip(slot_cap + hpos, 0, 2 * slot_cap - 1))
    w = jnp.concatenate([w_plus, w_minus])
    rvalid2 = jnp.concatenate([rvalid, rvalid])
    q_ok = rvalid2 & (w >= 0)
    wv = jnp.where(w >= tot, w - tot, w)
    own = jnp.where(q_ok, wv // slot_cap, n_dev)
    bl, bv, drop1, slots = _route_to_buckets(
        wv.astype(jnp.uint32)[None], q_ok, own, n_dev, qcap,
        with_slots=True)
    recv_l, recv_v = _exchange(bl, bv)
    rv = recv_v.reshape(-1)
    lv = jnp.clip(recv_l.reshape(-1).astype(jnp.int32) - me * slot_cap,
                  0, slot_cap - 1)
    ans_rid = jnp.where(rv, me * run_cap + jnp.take(rid_loc, lv), -1)
    ans_w = jnp.where(
        rv, jnp.take(end_pos_v, lv) - jnp.take(head_pos_v, lv) + 1, 0)
    back = _respond(jnp.stack([ans_rid.astype(jnp.uint32),
                               ans_w.astype(jnp.uint32)]), n_dev, qcap)
    slots_c = jnp.clip(slots, 0, n_dev * qcap - 1)
    a_rid = jnp.where(q_ok, jnp.take(back[0], slots_c).astype(jnp.int32), -1)
    a_w = jnp.where(q_ok, jnp.take(back[1], slots_c).astype(jnp.int32), 0)
    csucc = jnp.where(a_rid >= 0,
                      jnp.where(w >= tot, a_rid + C_tot, a_rid), -1)
    wsucc = a_w
    cvalid = rvalid2
    wlen2 = jnp.concatenate([rlen, rlen])

    # pred via mirror symmetry: mirror of local (+ run i) is local (- run
    # i) — a half-rotation, so pred and its edge weight are LOCAL
    succ_m = jnp.concatenate([csucc[run_cap:], csucc[:run_cap]])
    w_m = jnp.concatenate([wsucc[run_cap:], wsucc[:run_cap]])
    pred = jnp.where(succ_m >= 0, mirror_g(succ_m), -1)

    # ---- sharded weighted flagged doubling over the contracted graph:
    # each round routes ancestor-row REQUESTS to their owners and routes
    # the 4-int rows back (per-device traffic O(run_cap), never a gather
    # of the whole table) ----
    two_rc = 2 * run_cap
    gidx2 = jnp.concatenate([
        me * run_cap + jnp.arange(run_cap, dtype=jnp.int32),
        C_tot + me * run_cap + jnp.arange(run_cap, dtype=jnp.int32)])
    has_pred = (pred >= 0) & cvalid
    Q0 = jnp.stack([
        jnp.where(has_pred, pred, gidx2),
        jnp.where(has_pred, w_m,
                  np.int32(chains_op._F_ROOTED | chains_op._F_SETTLED)),
        jnp.where(cvalid, gidx2, 2 * C_tot),
        jnp.zeros((two_rc,), jnp.int32),
    ], axis=1)
    R_rounds = chains_op._max_rounds(2 * C_tot)

    def cond(carry):
        _, changed, t, _ = carry
        return changed & (t < R_rounds)

    def body(carry):
        Q, _, t, drops = carry
        rooted = (Q[:, chains_op._DSF] & chains_op._F_ROOTED) != 0
        need = cvalid & ~rooted
        qg = Q[:, chains_op._PTR]
        ow = jnp.where(need, gq_owner(qg), n_dev)
        qbl, qbv, dr, qslots = _route_to_buckets(
            qg.astype(jnp.uint32)[None], need, ow, n_dev, qcap,
            with_slots=True)
        rl_, rv_ = _exchange(qbl, qbv)
        rloc = jnp.clip(gq_local(rl_.reshape(-1).astype(jnp.int32)),
                        0, two_rc - 1)
        rows = jnp.take(Q, rloc, axis=0)                # (n_dev*qcap, 4)
        back_rows = _respond(
            jnp.transpose(rows).astype(jnp.uint32), n_dev, qcap)
        anc = jnp.transpose(
            jnp.take(back_rows, jnp.clip(qslots, 0, n_dev * qcap - 1),
                     axis=1)).astype(jnp.int32)
        new = jnp.where(need[:, None], chains_op._composeF(Q, anc), Q)
        changed = jax.lax.psum(
            jnp.any(new != Q).astype(jnp.int32), AXIS) > 0
        return new, changed, t + 1, drops + jax.lax.psum(dr, AXIS)

    F, _, _, loop_drops = jax.lax.while_loop(
        cond, body, (Q0, jnp.asarray(True), jnp.asarray(0),
                     jnp.asarray(0, jnp.int32)))

    # ---- finish (local flags + two more exchanges) ----
    rooted = (F[:, chains_op._DSF] & chains_op._F_ROOTED) != 0
    dist = F[:, chains_op._DSF] & chains_op._DMASK
    mn = F[:, chains_op._MN]
    dmn = F[:, chains_op._DMN]
    ptr = F[:, chains_op._PTR]
    in_cycle = cvalid & ~rooted
    break_node = in_cycle & (mn == gidx2)
    start_g = jnp.where(in_cycle, mn, ptr)
    rank = jnp.where(in_cycle, dmn, dist)
    is_start = cvalid & (~has_pred | break_node)
    is_end = cvalid & ((csucc < 0) | (in_cycle & (csucc == mn)))

    # route (end id, weighted length) to the start's owner
    own_e = jnp.where(is_end, gq_owner(start_g), n_dev)
    ebl, ebv, drop2, _ = _route_to_buckets(
        jnp.stack([start_g.astype(jnp.uint32), gidx2.astype(jnp.uint32),
                   (rank + wlen2).astype(jnp.uint32)]),
        is_end, own_e, n_dev, qcap, with_slots=True)
    erl, erv = _exchange(ebl, ebv)
    ent = erl.reshape(3, -1)
    ev = erv.reshape(-1)
    erow = jnp.clip(gq_local(ent[0].astype(jnp.int32)), 0, two_rc - 1)
    # one end per chain start: in-bounds destinations are unique
    edst = jnp.where(ev, erow, two_rc)
    end_of = jnp.full((two_rc,), -1, jnp.int32).at[edst].set(
        jnp.where(ev, ent[1].astype(jnp.int32), -1), mode="drop")
    len_at = jnp.zeros((two_rc,), jnp.int32).at[edst].set(
        jnp.where(ev, ent[2].astype(jnp.int32), 0), mode="drop")

    mmn = jnp.concatenate([mn[run_cap:], mn[:run_cap]])
    mirror_start = jnp.where(break_node, mmn,
                             mirror_g(jnp.where(end_of >= 0, end_of, gidx2)))
    keep = is_start & (end_of >= 0) & (gidx2 < mirror_start)

    # dense unitig ids: device-prefix + local cumsum (deterministic)
    local_kept = jnp.sum(keep.astype(jnp.int32))
    kept_all = jax.lax.all_gather(local_kept, AXIS)
    dev_off = jnp.sum(jnp.where(jnp.arange(n_dev) < me, kept_all, 0))
    uid_at = jnp.where(keep,
                       dev_off + jnp.cumsum(keep.astype(jnp.int32)) - 1, -1)
    n_unitigs = jax.lax.psum(local_kept, AXIS)

    # per-run uid: look up uid_at[start_g] at the start's owner
    own_u = jnp.where(cvalid, gq_owner(start_g), n_dev)
    ubl, ubv, drop3, uslots = _route_to_buckets(
        start_g.astype(jnp.uint32)[None], cvalid, own_u, n_dev, qcap,
        with_slots=True)
    url, urv = _exchange(ubl, ubv)
    urow = jnp.clip(gq_local(url.reshape(-1).astype(jnp.int32)),
                    0, two_rc - 1)
    ans_uid = jnp.where(urv.reshape(-1), jnp.take(uid_at, urow), -1)
    uback = _respond(ans_uid.astype(jnp.uint32)[None], n_dev, qcap)
    uid2 = jnp.where(cvalid,
                     jnp.take(uback[0],
                              jnp.clip(uslots, 0, n_dev * qcap - 1)
                              ).astype(jnp.int32), -1)

    dropped = (jax.lax.psum(drop1 + drop2 + drop3, AXIS) + loop_drops)
    return (n_runs[None], hpos, epos, rlen, uid2,
            jnp.where(uid2 >= 0, rank, 0), keep, uid_at, len_at,
            break_node, n_unitigs, dropped, run_overflow)


def glue_fn(mesh, n_dev: int, slot_cap: int, run_cap: int, qcap: int):
    fn = shard_map(
        partial(_glue_shard, n_dev=n_dev, slot_cap=slot_cap,
                run_cap=run_cap, qcap=qcap),
        mesh=mesh,
        in_specs=(P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
                   P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(), P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)


def reshard_pos_fn(mesh, L: int, k: int, slot_cap: int, route_cap: int,
                   n_dev: int, Q: int = 64):
    """Device-side global sort-by-position + re-shard (the host funnel
    replacement: distributed_compact_pos previously concatenated every
    device's solid run in host RAM, argsorted, and re-uploaded — O(N)
    per-host memory and 2x the table over the link).

    Per device: local sort by first-occurrence key, sampled global
    quantile pivots (all_gather of Q local quantiles), bucket exchange
    by pivot range (all_to_all), local re-sort, and the as-read
    orientation flip.  Output shards are position-contiguous in pivot
    order — exactly the gid = d*slot_cap + i layout the sharded glue
    expects.  Overflow (route or slot) is psum-counted, never silent."""
    from bcalm_tpu.ops import sort

    def local(stk, n_loc):
        lanes = stk[:L]
        counts = stk[L]
        pos = stk[L + 1]
        out = sort.sort_ops(
            [pos] + [lanes[j] for j in range(L)] + [counts], num_keys=1)
        pos_s = out[0]
        valid = pos_s != count_op_SENTINEL
        n_sol = jnp.sum(valid.astype(jnp.int32))
        # global pivots from per-device quantiles
        qi = jnp.clip(((jnp.arange(Q, dtype=jnp.int32) + 1) * n_sol)
                      // (Q + 1), 0, stk.shape[1] - 1)
        qs = jnp.where(n_sol > 0, jnp.take(pos_s, qi), count_op_SENTINEL)
        allq = jax.lax.all_gather(qs, AXIS).reshape(-1)
        allq = jnp.sort(allq)
        pidx = [((j + 1) * n_dev * Q) // n_dev for j in range(n_dev - 1)]
        pivots = jnp.take(allq, jnp.asarray(pidx, jnp.int32)) \
            if n_dev > 1 else jnp.zeros((0,), jnp.uint32)
        owner = jnp.zeros(pos_s.shape[0], jnp.int32)
        for j in range(n_dev - 1):
            owner = owner + (pos_s >= pivots[j]).astype(jnp.int32)
        stk_s = jnp.concatenate(
            [jnp.stack(out[1:L + 1], axis=0), out[L + 1][None],
             pos_s[None]], axis=0)
        buckets, bvalid, dropped = _route_to_buckets(
            stk_s, valid, owner, n_dev, route_cap)
        recv = jax.lax.all_to_all(buckets, AXIS, split_axis=1,
                                  concat_axis=1)
        rvalid = jax.lax.all_to_all(bvalid, AXIS, split_axis=0,
                                    concat_axis=0).reshape(-1)
        ent = recv.reshape(L + 2, -1)
        ent = jnp.where(rvalid[None], ent, count_op_SENTINEL)
        out2 = sort.sort_ops(
            [ent[L + 1]] + [ent[j] for j in range(L)] + [ent[L]],
            num_keys=1)
        n_recv = jnp.sum(rvalid.astype(jnp.int32))
        overflow = jnp.maximum(0, n_recv - slot_cap)
        pos2 = out2[0][:slot_cap]
        lanes2 = jnp.stack(out2[1:L + 1], axis=0)[:, :slot_cap]
        counts2 = out2[L + 1][:slot_cap]
        strand = (pos2 & np.uint32(1)) == 1
        in_slot = pos2 != count_op_SENTINEL
        lanes2 = jnp.where((strand & in_slot)[None],
                           ln.revcomp(lanes2, k), lanes2)
        counts2 = jnp.where(in_slot, counts2, 0)
        bad = jax.lax.psum(dropped + overflow, AXIS)
        n_here = jnp.minimum(n_recv, slot_cap)
        return (lanes2, counts2.astype(jnp.int32), n_here[None], bad)

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(None, AXIS), P(AXIS)),
        out_specs=(P(None, AXIS), P(AXIS), P(AXIS), P()),
        check_vma=False))


count_op_SENTINEL = np.uint32(0xFFFFFFFF)


def distributed_compact_dev(mesh, stacked, n_np, k: int, extra_stats=None):
    """Device-entry distributed compaction: takes the SHARDED stacked
    solid run ((L+2, n_dev*cap): lanes + counts + first-occurrence keys,
    per-device entries solidity-folded) straight from the device-resident
    mesh counting (pipeline.finish_count_fn) — the solid table never
    round-trips through host RAM between counting and compaction.

    n_np: per-device solid counts (host (n_dev,)).  Output assembly is
    host-side (it writes the FASTA anyway)."""
    from bcalm_tpu import engine as eng

    n_dev = mesh.devices.size
    L = stacked.shape[0] - 2
    N = int(n_np.sum())
    if N == 0:
        return eng.UnitigSet(
            k=k, seqs=[], kc=np.zeros(0, np.int64), abundances=[],
            circular=np.zeros(0, bool), links=[],
            stats={"devices": n_dev, "solid_kmers": 0})
    slot_cap = eng._round_capacity(
        max(16, int(np.ceil(1.3 * N / n_dev))))
    route_cap = max(64, -(-int(1.5 * slot_cap) // n_dev))
    while True:
        solid_sh, counts_sh, n_loc_d, bad = reshard_pos_fn(
            mesh, L, k, slot_cap, route_cap, n_dev)(
                stacked, jnp.asarray(n_np.astype(np.int32)))
        if int(bad) == 0:
            break
        route_cap *= 2
        if route_cap > 4 * slot_cap:
            slot_cap *= 2
            route_cap = max(64, -(-int(1.5 * slot_cap) // n_dev))
        if slot_cap > (1 << 28):
            raise RuntimeError("reshard overflow persists")
    n_local = np.asarray(n_loc_d)
    cap_entries = 4 * slot_cap
    succ_sh, _pred_sh, dropped = distributed_succ(
        mesh, solid_sh, jnp.asarray(n_local), k, cap_entries, slot_cap)
    if dropped:
        raise RuntimeError(f"junction exchange overflow: {dropped} entries")
    run_cap = max(16, slot_cap // 4)
    qcap = max(64, (4 * 2 * run_cap) // n_dev)
    n_local_d = jnp.asarray(n_local)
    while True:
        out = glue_fn(mesh, n_dev, slot_cap, run_cap, qcap)(
            succ_sh, n_local_d)
        (n_runs_sh, hpos_sh, epos_sh, rlen_sh, uid2_sh, rank2_sh, keep_sh,
         uid_at_sh, len_at_sh, circ_sh, n_unitigs_d, g_dropped,
         run_over) = out
        if int(run_over) > 0:
            run_cap = min(slot_cap, run_cap * 4)
            qcap = max(qcap, (4 * 2 * run_cap) // n_dev)
            continue
        if int(g_dropped) > 0:
            qcap *= 2
            if qcap > 2 * run_cap * n_dev:
                raise RuntimeError(
                    f"glue exchange overflow persists at qcap {qcap}")
            continue
        break
    outs_np = tuple(np.asarray(o) for o in out[:10])
    us = assemble_from_glue(outs_np, int(n_unitigs_d),
                            np.asarray(solid_sh), np.asarray(counts_sh),
                            n_local, slot_cap, run_cap, n_dev, k)
    if extra_stats:
        us.stats.update(extra_stats)
    return us


def distributed_compact_pos(mesh, solid_per_dev, counts_per_dev,
                            pos_per_dev, k: int):
    """Position-ordered distributed compaction — the fully device-side
    glue (the bglue analog, gatb bcalm2/bglue_algo.cpp + unionFind.hpp,
    example/uf/testUF.cpp:22-63 — SURVEY.md §4.4):

    1. host: order the merged solid set by first-occurrence key, flip to
       as-read orientation, re-shard into POSITION-CONTIGUOUS device
       slots (gid = d*slot_cap + i preserves stream adjacency),
    2. mesh: sharded junction matching (entry exchange by key hash, edges
       routed back to slot owners) — per-device memory O(N/n_dev),
    3. mesh (_glue_shard): per-shard consecutive-run detection (local
       scans; shard boundaries break runs, adding O(n_dev) extra runs),
       contracted-graph construction via request/response rid lookups,
       a SHARDED weighted pointer jump over the contracted run graph
       (per-round ancestor-row request/response all_to_alls — no device
       ever holds the full table), and chain finish with exchanged
       end/uid lookups.  Degenerate position quality only grows the
       contracted graph (worst case = the node count); output is correct
       for ANY positions,
    4. host: broadcast per-run labels over run members with np.repeat +
       assembly (host memory O(N), as assembly always was).

    Exchange capacities are bounded with psum'd overflow counters; on
    overflow (or run_cap exhaustion under degenerate positions) the host
    retries with doubled capacities.

    Args:
      solid_per_dev / counts_per_dev / pos_per_dev: per-device host arrays
        ((L, n_d) uint32 / (n_d,) int32 / (n_d,) uint32 first-occurrence
        keys, disjoint k-mer sets)
    Returns engine.UnitigSet.
    """
    from bcalm_tpu import engine as eng

    n_dev = mesh.devices.size
    L = solid_per_dev[0].shape[0]
    lanes = np.concatenate(solid_per_dev, axis=1)
    counts = np.concatenate(counts_per_dev)
    pos = np.concatenate(pos_per_dev)
    order = np.argsort(pos, kind="stable")
    lanes = lanes[:, order]
    counts = counts[order]
    pos = pos[order]
    N = lanes.shape[1]
    if N == 0:
        return eng.UnitigSet(
            k=k, seqs=[], kc=np.zeros(0, np.int64), abundances=[],
            circular=np.zeros(0, bool), links=[],
            stats={"devices": n_dev, "solid_kmers": 0})
    # flip to as-read orientation (strand bit = key LSB)
    strand = (pos & 1).astype(bool)
    lanes = np.asarray(jnp.where(
        jnp.asarray(strand)[None], ln.revcomp(jnp.asarray(lanes), k),
        jnp.asarray(lanes)))

    slot_cap = eng._round_capacity(max(1, -(-N // n_dev)))
    tot = n_dev * slot_cap
    solid_global = np.zeros((L, tot), np.uint32)
    counts_global = np.zeros((tot,), np.int32)
    n_local = np.zeros((n_dev,), np.int32)
    off = 0
    for d in range(n_dev):
        n_d = min(slot_cap, N - off) if off < N else 0
        solid_global[:, d * slot_cap: d * slot_cap + n_d] = \
            lanes[:, off: off + n_d]
        counts_global[d * slot_cap: d * slot_cap + n_d] = \
            counts[off: off + n_d]
        n_local[d] = n_d
        off += n_d

    cap_entries = 4 * slot_cap
    succ_sh, _pred_sh, dropped = distributed_succ(
        mesh, jnp.asarray(solid_global), jnp.asarray(n_local), k,
        cap_entries, slot_cap)
    if dropped:
        raise RuntimeError(f"junction exchange overflow: {dropped} entries")

    # ---- device-side glue with capacity escalation (stream-ordered
    # positions contract >= 4x in practice; degenerate positions escalate
    # run_cap to slot_cap, which can never overflow) ----
    run_cap = max(16, slot_cap // 4)
    qcap = max(64, (4 * 2 * run_cap) // n_dev)
    n_local_d = jnp.asarray(n_local)
    while True:
        out = glue_fn(mesh, n_dev, slot_cap, run_cap, qcap)(
            succ_sh, n_local_d)
        (n_runs_sh, hpos_sh, epos_sh, rlen_sh, uid2_sh, rank2_sh, keep_sh,
         uid_at_sh, len_at_sh, circ_sh, n_unitigs_d, g_dropped,
         run_over) = out
        if int(run_over) > 0:
            run_cap = min(slot_cap, run_cap * 4)
            qcap = max(qcap, (4 * 2 * run_cap) // n_dev)
            continue
        if int(g_dropped) > 0:
            qcap *= 2
            if qcap > 2 * run_cap * n_dev:
                raise RuntimeError(
                    f"glue exchange overflow persists at qcap {qcap}")
            continue
        break

    outs_np = tuple(np.asarray(o) for o in out[:10])
    return assemble_from_glue(outs_np, int(n_unitigs_d), solid_global,
                              counts_global, n_local, slot_cap, run_cap,
                              n_dev, k)


def assemble_from_glue(outs_np, n_unitigs: int, solid_global, counts_global,
                       n_local, slot_cap: int, run_cap: int, n_dev: int,
                       k: int):
    """Host assembly from gathered _glue_shard outputs: broadcast per-run
    labels over run members (np.repeat) and spell unitigs.  Shared with
    the multi-process smoke (tests/multihost_worker.py), which gathers
    the sharded outputs with multihost_utils instead of np.asarray."""
    from bcalm_tpu import engine as eng

    (n_runs_sh, hpos_sh, epos_sh, rlen_sh, uid2_sh, rank2_sh, keep_sh,
     uid_at_sh, len_at_sh, circ_sh) = outs_np
    tot = n_dev * slot_cap
    n_runs = n_runs_sh.reshape(n_dev)
    hpos = hpos_sh.reshape(n_dev, run_cap)
    epos = epos_sh.reshape(n_dev, run_cap)
    rlen = rlen_sh.reshape(n_dev, run_cap)
    uid2 = uid2_sh.reshape(n_dev, 2 * run_cap)
    rank2 = rank2_sh.reshape(n_dev, 2 * run_cap)
    keep = keep_sh.reshape(n_dev, 2 * run_cap)
    uid_at = uid_at_sh.reshape(n_dev, 2 * run_cap)
    len_at = len_at_sh.reshape(n_dev, 2 * run_cap)
    circ_at = circ_sh.reshape(n_dev, 2 * run_cap)
    R_total = int(n_runs.sum())

    # global per-run views (ascending device, ascending run): heads/tails
    # as global slot indices
    rmask = (np.arange(run_cap)[None, :] < n_runs[:, None])
    heads_g = (np.arange(n_dev)[:, None] * slot_cap + hpos)[rmask]
    tails_g = (np.arange(n_dev)[:, None] * slot_cap + epos)[rmask]
    rlen_g = rlen[rmask]
    uid_p = uid2[:, :run_cap][rmask]
    uid_m = uid2[:, run_cap:][rmask]
    rank_p = rank2[:, :run_cap][rmask]
    rank_m = rank2[:, run_cap:][rmask]

    uid = np.full((2 * tot,), -1, np.int32)
    rank = np.zeros((2 * tot,), np.int32)
    members = np.repeat(heads_g, rlen_g) + (
        np.arange(rlen_g.sum()) -
        np.repeat(np.concatenate([[0], np.cumsum(rlen_g)[:-1]]), rlen_g))
    uid[members] = np.repeat(uid_p, rlen_g)
    rank[members] = np.repeat(rank_p, rlen_g) + (
        members - np.repeat(heads_g, rlen_g))
    uid[tot + members] = np.repeat(uid_m, rlen_g)
    rank[tot + members] = np.repeat(rank_m, rlen_g) + (
        np.repeat(tails_g, rlen_g) - members)
    rank = np.where(uid >= 0, rank, 0)

    # per-unitig arrays in uid order (uid_at is densely numbered in
    # device-major, row-major order — exactly this mask's order)
    kmask = keep
    dev_of = np.repeat(np.arange(n_dev)[:, None], 2 * run_cap, axis=1)
    row_of = np.repeat(np.arange(2 * run_cap)[None, :], n_dev, axis=0)
    kd = dev_of[kmask]
    kr = row_of[kmask]
    is_minus = kr >= run_cap
    ri = np.where(is_minus, kr - run_cap, kr)
    start_oid = np.where(
        is_minus,
        tot + kd * slot_cap + epos[kd, ri],
        kd * slot_cap + hpos[kd, ri]).astype(np.int64)
    length = len_at[kmask].astype(np.int32)
    circular = circ_at[kmask]
    # sanity: uid_at numbering must match this order
    assert np.array_equal(uid_at[kmask], np.arange(n_unitigs))

    info = {
        "uid": uid,
        "rank": rank,
        "n_unitigs": n_unitigs,
        "start_oid": start_oid,
        "length": length,
        "circular": circular,
    }
    seqs, kc, abund, circular_u = eng.assemble_unitigs(
        solid_global, counts_global, info, k)
    links = eng.link_join(seqs, k)
    n_solid = int(np.asarray(n_local).sum())
    return eng.UnitigSet(
        k=k, seqs=seqs, kc=kc, abundances=abund, circular=circular_u,
        links=links, stats={
            "devices": n_dev,
            "solid_kmers": n_solid,
            "glue_runs": int(R_total),
            "glue_contraction": float(n_solid) / max(1, R_total),
        },
    )


def distributed_compact(mesh, solid_per_dev, counts_per_dev, k: int):
    """Distributed compaction without first-occurrence keys: runs the
    position-ordered glue with constant positions — correct for any
    positions, it just degenerates to per-node runs (worst-case
    contraction), which doubles as a stress test of the sharded jump."""
    zeros = [np.zeros((c.shape[0],), np.uint32) for c in counts_per_dev]
    return distributed_compact_pos(mesh, solid_per_dev, counts_per_dev,
                                   zeros, k)
