"""Multi-host worker: one process of a 2-process jax.distributed run.

Launched by tests/test_multihost.py (and usable standalone) to prove the
PRODUCTION mesh pipeline runs across PROCESS boundaries — the DCN axis of
SURVEY.md §8 step 7.  The reference has no multi-host analog at all
(single node, filesystem transport — SURVEY.md §3.3).

Two production phases run over one 2-process global mesh (4 virtual CPU
devices per process):

1. the streamed superkmer counting round (pipeline.skm_count_fn):
   minimizer table + frequency rank replicated, superkmers formed from
   process-local read rows, routed through the cross-process all_to_all,
   counted per device WITH first-occurrence keys; the global distinct
   total is checked against the python oracle.
2. the sharded junction exchange (distcompact.distributed_succ): the
   solid set sharded over the global mesh, entry/edge all_to_alls crossing
   the process boundary; the reassembled edge set is checked against the
   single-device ops.junctions result.
3. the DEVICE-SIDE distributed glue (distcompact.glue_fn): run detection,
   contracted-graph request/response exchanges, the sharded weighted
   pointer jump, and chain finish — all across the process boundary —
   with unitig content equality against the single-device engine.

Env: MH_NPROCS, MH_PID, MH_PORT.
Prints "MULTIHOST_OK <n_distinct> <n_edges>" on success.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np  # noqa: E402
import jax  # noqa: E402


def main():
    nprocs = int(os.environ["MH_NPROCS"])
    pid = int(os.environ["MH_PID"])
    port = int(os.environ["MH_PORT"])
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nprocs,
        process_id=pid,
    )
    assert jax.process_count() == nprocs
    n_local = jax.local_device_count()
    n_global = jax.device_count()
    assert n_global == nprocs * n_local

    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from jax.experimental import multihost_utils

    from bcalm_tpu.io import packing
    from bcalm_tpu.parallel import pipeline

    k = 21
    block_reads = 32  # rows per device

    # identical reads in every process (same seed); each process feeds the
    # rows belonging to its local devices
    rng = np.random.RandomState(7)
    genome = rng.randint(0, 4, size=600)
    reads = []
    for _ in range(block_reads * n_global):
        i = rng.randint(0, 600 - 70)
        reads.append("".join("ACTG"[c] for c in genome[i : i + 70]))

    blocks = list(packing.iter_blocks(reads, k, block_reads=block_reads,
                                      max_len=70))
    assert len(blocks) == n_global
    words = np.concatenate([b.words for b in blocks])
    lengths = np.concatenate([b.lengths for b in blocks])

    mesh = Mesh(np.asarray(jax.devices()).reshape(n_global), (pipeline.AXIS,))
    sh_w = NamedSharding(mesh, P(pipeline.AXIS, None))
    sh_l = NamedSharding(mesh, P(pipeline.AXIS))
    sh_r = NamedSharding(mesh, P())  # replicated
    lo = pid * n_local * block_reads
    hi = (pid + 1) * n_local * block_reads
    g_words = jax.make_array_from_process_local_data(sh_w, words[lo:hi])
    g_lengths = jax.make_array_from_process_local_data(sh_l, lengths[lo:hi])

    # ---- phase 1: PRODUCTION superkmer counting round ----
    mcfg = pipeline.MinimizerConfig()
    m = pipeline.effective_m(k, mcfg.m)
    freq_rank, table, _ = pipeline.sample_tables(words, lengths, k, mcfg,
                                                 n_global)
    from bcalm_tpu.ops import superkmer as skm_mod

    max_span = skm_mod.default_max_span(k)
    cap = pipeline.superkmer_capacity(block_reads, 70, k, m, n_global,
                                      max_span)
    # replicated inputs (same bytes in every process) pass as plain numpy
    fn = pipeline.skm_count_fn(mesh, k, m, cap, max_span, use_rank=True)
    with mesh:
        unique, counts, minpos, n_unique, stats = fn(
            g_words, g_lengths, np.asarray(table),
            np.asarray(freq_rank, np.uint32), np.uint32(0))
    st = np.asarray(stats)
    assert int(st[0]) == 0, "superkmer exchange overflow in multihost run"

    nu = multihost_utils.process_allgather(n_unique, tiled=True)
    total = int(np.sum(nu))

    from bcalm_tpu.oracle import brute

    want = len(brute.count_kmers(reads, k))
    assert total == want, f"distinct {total} != oracle {want}"

    # ---- phase 2: sharded junction exchange across the process boundary ----
    from bcalm_tpu import engine
    from bcalm_tpu.parallel import distcompact

    cfg = engine.EngineConfig(k=k, abundance_min=1, block_reads=block_reads,
                              max_len=70)
    solid, scounts, sminpos, _, _ = engine.count_and_filter(
        iter(packing.iter_blocks(reads, k, block_reads=block_reads,
                                 max_len=70)), cfg)
    N = solid.shape[1]
    slot_cap = engine._round_capacity(max(1, -(-N // n_global)))
    tot = n_global * slot_cap
    L = solid.shape[0]
    solid_global = np.zeros((L, tot), np.uint32)
    n_local_arr = np.zeros((n_global,), np.int32)
    off = 0
    for d in range(n_global):
        n_d = min(slot_cap, N - off) if off < N else 0
        solid_global[:, d * slot_cap: d * slot_cap + n_d] = \
            solid[:, off: off + n_d]
        n_local_arr[d] = n_d
        off += n_d
    g_solid = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(None, pipeline.AXIS)),
        solid_global[:, pid * n_local * slot_cap:
                     (pid + 1) * n_local * slot_cap])
    g_nloc = jax.make_array_from_process_local_data(
        sh_l, n_local_arr[pid * n_local: (pid + 1) * n_local])
    succ_sh, pred_sh, dropped = distcompact.distributed_succ(
        mesh, g_solid, g_nloc, k, 4 * slot_cap, slot_cap)
    assert int(dropped) == 0

    succ_all = np.asarray(
        multihost_utils.process_allgather(succ_sh, tiled=True))
    # device-block shards (n_global, 2*slot_cap) -> global strand-major
    sh2 = succ_all.reshape(n_global, 2 * slot_cap)
    succ_g = np.concatenate([
        sh2[:, :slot_cap].reshape(tot), sh2[:, slot_cap:].reshape(tot)])

    # oracle: single-device junctions on the DENSE solid set, translated
    # into the slot layout (padding slots must never look like poly-A
    # k-mers, so the oracle never sees them)
    from bcalm_tpu.ops import junctions as junc

    capD = engine._round_capacity(max(1, N))
    dense = np.zeros((L, capD), np.uint32)
    dense[:, :N] = solid
    succ_d = np.asarray(junc.successor_arrays(
        jnp.asarray(dense), jnp.asarray(N, jnp.int32), k)[0])

    # dense index j -> slot id (contiguous fill per device)
    dense2slot = np.full((capD,), -1, np.int64)
    off = 0
    for d in range(n_global):
        n_d = n_local_arr[d]
        dense2slot[off: off + n_d] = d * slot_cap + np.arange(n_d)
        off += n_d

    def xl(w, half):
        wv = np.where(w >= half, w - half, w)
        ws = dense2slot[np.clip(wv, 0, capD - 1)]
        return np.where(w >= 0, np.where(w >= half, ws + tot, ws), -1)

    exp = np.full((2 * tot,), -1, np.int64)
    j = np.arange(N)
    s = dense2slot[j]
    exp[s] = xl(succ_d[:capD][j], capD)
    exp[tot + s] = xl(succ_d[capD:][j], capD)
    assert (succ_g == exp).all(), "sharded junction edges != single-device"
    n_edges = int((succ_g >= 0).sum())

    # ---- phase 3: DISTRIBUTED GLUE across the process boundary — the
    # full device-side compaction (run detection, contracted-graph
    # request/response exchanges, sharded weighted pointer jump, finish)
    # with content equality against the single-device engine ----
    run_cap = slot_cap            # cannot overflow (runs <= slots)
    qcap = 2 * run_cap            # cannot overflow (<= 2*run_cap queries)
    counts_global = np.zeros((tot,), np.int32)
    off = 0
    for d in range(n_global):
        n_d = n_local_arr[d]
        counts_global[d * slot_cap: d * slot_cap + n_d] = \
            scounts[off: off + n_d]
        off += n_d
    gfn = distcompact.glue_fn(mesh, n_global, slot_cap, run_cap, qcap)
    with mesh:
        gout = gfn(succ_sh, g_nloc)
    assert int(gout[12]) == 0 and int(gout[11]) == 0
    outs_np = tuple(
        np.asarray(multihost_utils.process_allgather(o, tiled=True))
        for o in gout[:10])
    us = distcompact.assemble_from_glue(
        outs_np, int(gout[10]), solid_global, counts_global, n_local_arr,
        slot_cap, run_cap, n_global, k)
    expect = engine.compact_from_counts(solid, scounts, cfg)
    assert (brute.canonical_unitig_set(us.seqs)
            == brute.canonical_unitig_set(expect.seqs)), \
        "distributed glue unitigs != single-device"

    if pid == 0:
        print(f"MULTIHOST_OK {total} {n_edges} {len(us.seqs)}", flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
