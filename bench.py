"""Benchmark: per-config throughput of the build on the GPU.

Configs (synthetic read sets at the scales BASELINE.json names; no
network, so real E. coli / C. elegans downloads are replaced by seeded
random genomes of the corresponding size/coverage):

  headline   1 Mbp x24, k=31    — counting + compaction device metrics
  ecoli50x   4.6 Mbp x50, k=31  — E. coli-class scale, counting + compact
  e2e        CLI run on a gzipped FASTA on disk (ingest -> unitigs.fa
             with links), wall-clock + peak RSS
  e2e_warm   the same CLI build twice in one process: the second wall is
             the steady state (backend start-up and compilation paid once)
  bigk63     20 Mbp x8, k=63    — multi-lane k, hashed junction keys
  spill31    12 Mbp x15, k=31   — out-of-core (distinct set > device
             residency budget -> multi-pass key-range counting)
  bigk51     20 Mbp x8, k=51    — multi-lane k through the same path
  BENCH_SCALE=1 adds C. elegans-class CLI configs with the sampled
             content oracle (scripts/sampled_check.py)

Process model: this parent imports no JAX.  Each config runs in a child
process of its own (`python bench.py --config NAME`), one at a time, so
exactly one JAX process holds the card at any moment.  A child that finds
no GPU fails; it never falls back to the CPU.  Every result names the
device (platform, device kind, count) and the card's name and power limit
as nvidia-smi reports them.

Prints ONE JSON line.  The primary metric is canonical k-mers
counted/sec/device on the headline config; glued/sec, per-config numbers
and compile (warmup) times are carried as extra keys.  vs_baseline: ratio
against 1e7 canonical k-mers/s/node, a documented assumption for
reference-class DSK counting throughput on a commodity CPU node (the
repository publishes no numbers — BASELINE.md).

Env knobs: BENCH_SKIP (comma list of config names to skip),
BENCH_BUDGET_S (wall budget, default 600; checked before every config),
BENCH_SCALE=1 (adds the C. elegans-class configs), BENCH_K/BENCH_GENOME/
BENCH_COVERAGE/BENCH_READ_LEN/BENCH_CHUNK override the headline config,
BENCH_CACHE_DIR (generated-input cache, default under the temp dir).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

BASELINE_KMERS_PER_SEC = 1.0e7


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def gen_reads(genome_len: int, read_len: int, coverage: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    genome = rng.randint(0, 4, size=genome_len).astype(np.uint8)
    n_reads = genome_len * coverage // read_len
    starts = rng.randint(0, genome_len - read_len, size=n_reads)
    return genome[starts[:, None] + np.arange(read_len)[None, :]]


def pack_uniform(reads: np.ndarray) -> np.ndarray:
    """(R, len) uint8 codes -> (R, W) uint32 big-endian packed."""
    R, n = reads.shape
    W = (n + 15) // 16
    padded = np.zeros((R, W * 16), dtype=np.uint32)
    padded[:, :n] = reads
    shifts = (2 * (15 - np.arange(16))).astype(np.uint32)
    return (padded.reshape(R, W, 16) << shifts[None, None, :]).sum(
        axis=2, dtype=np.uint32
    )


def make_blocks(words, read_len, block_reads):
    from bcalm_tpu.io.packing import ReadBlock

    R = words.shape[0]
    blocks = []
    for i in range(0, R, block_reads):
        chunk = words[i : i + block_reads]
        if chunk.shape[0] < block_reads:  # pad final block (empty reads)
            pad = np.zeros((block_reads - chunk.shape[0], words.shape[1]),
                           np.uint32)
            chunk = np.concatenate([chunk, pad])
        lengths = np.full((block_reads,), read_len, np.int32)
        lengths[min(R - i, block_reads):] = 0
        blocks.append(ReadBlock(chunk, lengths))
    return blocks


def device_config(name, k, genome_len, coverage, read_len, chunk,
                  runs=3, seed=0, resident=None):
    """Count + compact a synthetic read set on-device; returns metrics.

    resident: k-mer slots resident on device before multi-pass key-range
    counting engages (exercises the beyond-HBM out-of-core path at real
    scale when set below the distinct count)."""
    import jax.numpy as jnp

    from bcalm_tpu import engine
    from bcalm_tpu.ops import count as count_op

    cfg = engine.EngineConfig(k=k, abundance_min=2, block_reads=8192,
                              max_len=read_len, chunk_kmers=chunk)
    if resident:
        cfg.resident_kmers = resident
    reads = gen_reads(genome_len, read_len, coverage, seed)
    words = pack_uniform(reads)
    blocks = make_blocks(words, read_len, cfg.block_reads)
    n_occ = int(reads.shape[0] * (read_len - k + 1))
    cfg.est_total_occ = n_occ
    log(f"[{name}] {reads.shape[0]} reads, {len(blocks)} blocks, "
        f"{n_occ} k-mer occ, k={k}")

    def count_device(blocks_iter):
        unique, counts, minpos, n_unique, stats = engine.count_blocks(
            blocks_iter, cfg, reread=lambda: iter(blocks))
        if isinstance(unique, np.ndarray):
            # multi-pass path: host-resident exact table; filter in numpy
            # (the table just crossed the link — masking is free)
            keep = ((counts >= cfg.abundance_min)
                    & (counts <= cfg.abundance_max))
            return (unique[:, keep], counts[keep], minpos[keep],
                    int(keep.sum()), int(n_unique), stats)
        # elementwise fold filter + ONE stacked scalar fetch (the
        # production build_from_blocks path)
        solidF, countsF, posF, nn_dev = count_op.filter_abundance_fold(
            unique, counts, minpos, n_unique,
            cfg.abundance_min, cfg.abundance_max)
        nn = np.asarray(nn_dev)
        n_u, n_solid = int(nn[0]), int(nn[1])
        cap = engine._round_capacity(max(1, n_u))
        return (solidF[:, :cap], countsF[:cap], posF[:cap],
                n_solid, n_u, stats)

    # warmup = one FULL run: compiles/loads every shape class the timed
    # runs touch (full chunk, LSM merge ladder, final merge, fetch
    # programs) — a 1-block warmup would leave those to compile INSIDE
    # the timed region
    t0 = time.time()
    count_device(iter(blocks))
    count_warm = time.time() - t0
    log(f"[{name}] count warmup (compile) {count_warm:.1f}s")

    times = []
    result = None
    for _ in range(runs):
        t0 = time.time()
        result = count_device(iter(blocks))
        times.append(time.time() - t0)
    t_count = min(times)
    solid_f, counts_f, pos_f, n_solid, n_distinct, stats = result
    kmers_per_sec = n_occ / t_count
    log(f"[{name}] count {t_count*1e3:.1f}ms for {n_occ} occ "
        f"({n_distinct} distinct, {n_solid} solid, "
        f"{stats.get('ooc_passes', 1)} passes) = "
        f"{kmers_per_sec/1e6:.1f}M/s")
    if "timing" in stats:
        log(f"[{name}] count timing {stats['timing']}")

    if isinstance(solid_f, np.ndarray):
        cap = engine._round_capacity(max(1, n_solid))
        L = solid_f.shape[0]
        solid_d = jnp.asarray(np.concatenate(
            [solid_f, np.zeros((L, cap - n_solid), np.uint32)], axis=1))
        counts_d = jnp.asarray(np.concatenate(
            [counts_f, np.zeros((cap - n_solid,), np.int32)]))
        pos_d = jnp.asarray(np.concatenate(
            [pos_f, np.full((cap - n_solid,), count_op.SENTINEL,
                            np.uint32)]))
    else:
        # device path: folded arrays already sliced to cap(n_distinct);
        # compact_solid_pos' reorder compacts the fold
        solid_d, counts_d, pos_d = solid_f, counts_f, pos_f
    t0 = time.time()
    _, _, _, info = engine.compact_solid_pos(
        solid_d, counts_d, pos_d, n_solid, k)
    nu = int(info["n_unitigs"])
    compact_warm = time.time() - t0
    log(f"[{name}] compact warmup {compact_warm:.1f}s -> {nu} unitigs")
    times = []
    for _ in range(runs):
        t0 = time.time()
        _, _, _, info = engine.compact_solid_pos(
            solid_d, counts_d, pos_d, n_solid, k)
        nu = int(info["n_unitigs"])
        times.append(time.time() - t0)
    t_compact = min(times)
    glued_per_sec = n_solid / max(t_compact, 1e-9)
    log(f"[{name}] compact {t_compact*1e3:.1f}ms = "
        f"{glued_per_sec/1e6:.2f}M glued/s ({nu} unitigs)")
    return {
        "k": k,
        "kmer_occ": n_occ,
        "n_solid": n_solid,
        "ooc_passes": stats.get("ooc_passes", 1),
        "count_ms": round(t_count * 1e3, 1),
        "kmers_per_sec": round(kmers_per_sec, 1),
        "compact_ms": round(t_compact * 1e3, 1),
        "glued_per_sec": round(glued_per_sec, 1),
        "count_warmup_s": round(count_warm, 1),
        "compact_warmup_s": round(compact_warm, 1),
        "n_unitigs": nu,
    }


def make_genome(genome_len, rng, repeat_frac=0.0):
    """Random genome, optionally seeded with duplicated segments so the
    de Bruijn graph has real junctions (repeat_frac of the length is
    covered by copies of earlier segments, 500-5000 bp each — a
    uniform-random genome compacts to ONE unitig, exercising no glue
    machinery at scale)."""
    genome = rng.randint(0, 4, size=genome_len).astype(np.uint8)
    target = int(genome_len * repeat_frac)
    placed = 0
    while placed < target:
        seg_len = int(rng.randint(500, 5001))
        src = int(rng.randint(0, genome_len - seg_len))
        dst = int(rng.randint(0, genome_len - seg_len))
        genome[dst:dst + seg_len] = genome[src:src + seg_len]
        placed += seg_len
    return genome


def sample_reads(genome, n_reads, read_len, rng, err_rate=0.0,
                 dup_frac=0.0):
    """(n_reads, read_len) uint8 codes; substitution errors at err_rate
    (error k-mers inflate the distinct set ~k-fold per error — the
    realistic counting load real Illumina data presents).

    dup_frac: fraction of reads emitted twice (PCR duplicates).  Errors
    in duplicated reads reach count 2 and SURVIVE -abundance-min 2 —
    the realistic mechanism that gives deep short-read assemblies their
    millions of error-bubble/tip unitigs."""
    n_orig = int(n_reads / (1.0 + dup_frac)) if dup_frac else n_reads
    starts = rng.randint(0, genome.shape[0] - read_len, size=n_orig)
    reads = genome[starts[:, None] + np.arange(read_len)[None, :]].copy()
    if err_rate > 0:
        n_err = rng.binomial(n_orig * read_len, err_rate)
        pos_r = rng.randint(0, n_orig, size=n_err)
        pos_c = rng.randint(0, read_len, size=n_err)
        shift = rng.randint(1, 4, size=n_err).astype(np.uint8)
        reads[pos_r, pos_c] = (reads[pos_r, pos_c] + shift) % 4
    if dup_frac:
        n_dup = n_reads - n_orig
        dup_idx = rng.randint(0, n_orig, size=n_dup)
        reads = np.concatenate([reads, reads[dup_idx]], axis=0)
        perm = rng.permutation(reads.shape[0])
        reads = reads[perm]
    return reads


def write_reads(path, seed, genome_len, coverage, read_len, repeat_frac=0.0,
                err_rate=0.0, dup_frac=0.0, chunk_reads=500_000):
    """Write a seeded synthetic read set (make_genome + sample_reads) as
    gzipped FASTA; returns the read count.  Reads are drawn in chunks so
    host memory stays bounded at any scale."""
    import gzip

    rng = np.random.RandomState(seed)
    genome = make_genome(genome_len, rng, repeat_frac)
    lut = np.frombuffer(b"ACTG", np.uint8)
    n_reads = genome_len * coverage // read_len
    with gzip.open(path, "wb", compresslevel=1) as f:
        for base in range(0, n_reads, chunk_reads):
            m = min(chunk_reads, n_reads - base)
            codes = lut[sample_reads(genome, m, read_len, rng, err_rate,
                                     dup_frac=dup_frac)]
            f.write(b"".join(b">r%d\n%s\n" % (base + i, codes[i].tobytes())
                             for i in range(m)))
    return n_reads


def _cached_reads_gz(genome_len, coverage, read_len, seed,
                     repeat_frac=0.0, err_rate=0.0, dup_frac=0.0):
    """Generate (once) and cache a CLI config's input FASTA."""
    cache_dir = os.environ.get(
        "BENCH_CACHE_DIR", os.path.join(tempfile.gettempdir(),
                                        "btpu_bench_cache"))
    os.makedirs(cache_dir, exist_ok=True)
    tag = ""
    if repeat_frac or err_rate or dup_frac:
        tag = f"_r{repeat_frac:g}_e{err_rate:g}"
        if dup_frac:
            tag += f"_d{dup_frac:g}"
    path = os.path.join(
        cache_dir,
        f"reads_g{genome_len}_c{coverage}_l{read_len}_s{seed}{tag}.fa.gz")
    if os.path.exists(path) and os.path.getsize(path) > 0:
        log(f"[input] cached {path} ({os.path.getsize(path)>>20} MB)")
        return path
    t0 = time.time()
    tmp = path + ".tmp"
    n_reads = write_reads(tmp, seed, genome_len, coverage, read_len,
                          repeat_frac, err_rate, dup_frac)
    os.replace(tmp, path)
    log(f"[input] wrote {n_reads} reads ({os.path.getsize(path)>>20} MB gz) "
        f"in {time.time()-t0:.1f}s")
    return path


def run_cli_inprocess(argv):
    """One CLI run inside this process (the process that owns the card);
    returns (rc, stdout text, wall seconds)."""
    from bcalm_tpu import cli

    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    return rc, buf.getvalue(), time.time() - t0


def _cli_metrics(name, out, wall, occ):
    peak_mb = None
    n_unitigs = None
    vals = {}
    for line in out.splitlines():
        if "peak_rss_mb" in line:
            peak_mb = int(line.split()[-1])
        if line.startswith("wrote "):
            n_unitigs = int(line.split()[1])
        if "[time:" in line:
            log(f"[{name}] {line.strip()}")
        for key in ("t_count_s", "t_compact_s", "t_assemble_s",
                    "solid_kmers", "distinct_kmers"):
            if f"[{key}]" in line:
                vals[key] = float(line.split()[-1])
    res = {
        "kmer_occ": occ,
        "wall_s": round(wall, 3),
        "kmers_per_sec_e2e": round(occ / wall, 1),
        "peak_rss_mb": peak_mb,
        "n_unitigs": n_unitigs,
    }
    if vals.get("t_compact_s") and vals.get("solid_kmers"):
        res["n_solid"] = int(vals["solid_kmers"])
        res["glued_per_sec"] = round(
            vals["solid_kmers"] / vals["t_compact_s"], 1)
    if vals.get("t_count_s"):
        res["kmers_per_sec_count"] = round(occ / vals["t_count_s"], 1)
    return res


def cli_config(name, genome_len, coverage, read_len, k, seed,
               extra_args=(), check=False, repeat_frac=0.0, err_rate=0.0,
               dup_frac=0.0, runs=1):
    """Full CLI build, in this process: gzipped FASTA on disk ->
    unitigs.fa (ingest, counting, compaction, links, write).  Wall-clock
    + peak RSS + stage-derived glued/s.  runs=2 repeats the build in the
    same process: run 1 pays backend start-up and compilation, run 2 is
    the steady state.

    check=True: run the sampled k-mer-content oracle
    (scripts/sampled_check.py, numpy only — no second JAX process) on the
    output and carry its verdict in the metrics."""
    import shutil

    reads_path = _cached_reads_gz(genome_len, coverage, read_len, seed,
                                  repeat_frac=repeat_frac,
                                  err_rate=err_rate, dup_frac=dup_frac)
    occ = genome_len * coverage // read_len * (read_len - k + 1)
    d = tempfile.mkdtemp(prefix="btpu_bench_")
    try:
        walls = []
        for r in range(runs):
            prefix = os.path.join(d, f"run{r}")
            rc, out, wall = run_cli_inprocess(
                ["-in", reads_path, "-out", prefix, "-kmer-size", str(k),
                 "-abundance-min", "2", "-verbose", "1", *extra_args])
            if rc != 0:
                log(f"[{name}] CLI FAILED rc={rc}\n{out[-2000:]}")
                return {"error": rc}
            walls.append(wall)
        res = dict(_cli_metrics(name, out, wall, occ), k=k)
        if runs > 1:
            res["wall_first_s"] = round(walls[0], 3)
            res["wall_warm_s"] = round(walls[-1], 3)
        log(f"[{name}] walls {walls} -> {res.get('n_unitigs')} unitigs")
        out_path = prefix + ".unitigs.fa"
        if check and os.path.exists(out_path):
            chk = subprocess.run(
                [sys.executable,
                 os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "scripts", "sampled_check.py"),
                 out_path, reads_path, str(k), "5000", "2"],
                capture_output=True, text=True, timeout=3600)
            verdict = (chk.stdout.strip().splitlines()
                       or ["(no output)"])[-1]
            log(f"[{name}] {verdict}")
            res["oracle"] = verdict if chk.returncode == 0 else \
                f"FAILED: {chk.stderr[-200:]}"
        return res
    finally:
        shutil.rmtree(d, ignore_errors=True)


def card_info():
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable: {e!r}"
    return smi.stdout.strip() or f"unavailable: rc {smi.returncode}"


def _configs():
    """name -> zero-argument callable run inside the config's child."""
    k = int(os.environ.get("BENCH_K", 31))
    genome_len = int(os.environ.get("BENCH_GENOME", 1_000_000))
    read_len = int(os.environ.get("BENCH_READ_LEN", 150))
    coverage = int(os.environ.get("BENCH_COVERAGE", 24))
    chunk = int(os.environ.get("BENCH_CHUNK", 8 * 1024 * 1024))
    e2e_genome = int(os.environ.get("BENCH_E2E_GENOME", 4_600_000))
    e2e_cov = int(os.environ.get("BENCH_E2E_COVERAGE", 50))
    cfgs = {
        "headline": lambda: device_config(
            "headline", k, genome_len, coverage, read_len, chunk),
        # 2^24 chunks amortize merge traffic at >=64M-occurrence scale
        "ecoli50x": lambda: device_config(
            "ecoli50x", 31, 4_600_000, 50, 150, 16 * 1024 * 1024, runs=2,
            seed=2),
        "e2e": lambda: cli_config("e2e", e2e_genome, e2e_cov, 150, 31,
                                  seed=1),
        "e2e_warm": lambda: cli_config("e2e_warm", e2e_genome, e2e_cov,
                                       150, 31, seed=1, runs=2),
        # resident-path counting + hashed-junction-key compaction at L=4
        "bigk63": lambda: device_config(
            "bigk63", 63, 20_000_000, 8, 150, chunk, runs=2, seed=5),
        # out-of-core configs: resident=1 clamps the device budget to the
        # 2-chunk floor, engaging the key-range machinery (host-resident
        # table, exactly-once fetch); spill31's 12M distinct exceeds the
        # floor even with the 1.2x split-trigger hysteresis -> >= 2 passes
        "spill31": lambda: device_config(
            "spill31", 31, 12_000_000, 15, 150, 4 * 1024 * 1024, runs=1,
            seed=4, resident=1),
        "bigk51": lambda: device_config(
            "bigk51", 51, 20_000_000, 8, 150, chunk, runs=1, seed=3,
            resident=1),
    }
    if os.environ.get("BENCH_SCALE"):
        # C. elegans-class scale (BASELINE.md configs) with realistic
        # inputs: duplicated segments make junction-rich graphs,
        # substitution errors inflate the distinct set, and PCR
        # duplicates let error k-mers survive -abundance-min 2 (the
        # mechanism behind deep short-read assemblies' unitig counts)
        cfgs.update({
            "celegans": lambda: cli_config(
                "celegans", 100_000_000, 30, 150, 31, seed=7,
                extra_args=("-max-memory", "6000"), check=True,
                repeat_frac=0.05, err_rate=0.0001),
            "realistic2g": lambda: cli_config(
                "realistic2g", 30_000_000, 70, 150, 31, seed=9,
                extra_args=("-max-memory", "8000"), check=True,
                repeat_frac=0.08, err_rate=0.0005),
            "errorgraph2g": lambda: cli_config(
                "errorgraph2g", 30_000_000, 70, 150, 31, seed=10,
                extra_args=("-max-memory", "6000"), check=True,
                repeat_frac=0.05, err_rate=0.0013, dup_frac=0.2),
            "bigk51_3g": lambda: cli_config(
                "bigk51_3g", 50_000_000, 60, 150, 51, seed=8,
                extra_args=("-max-memory", "8000"), check=True,
                repeat_frac=0.05, err_rate=0.0002),
        })
    return cfgs


def run_child(name):
    """Child process body: run one config on the GPU, print its JSON."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        log(f"[{name}] backend is {devs[0].platform!r}, not the GPU")
        return 1
    from bcalm_tpu.utils.jaxcache import enable_cache

    enable_cache()
    res = _configs()[name]()
    res["device"] = {"platform": devs[0].platform,
                     "kind": devs[0].device_kind, "count": len(devs)}
    res["card"] = card_info()
    print(json.dumps(res), flush=True)
    return 0


def main():
    skip = set(os.environ.get("BENCH_SKIP", "").split(","))
    # wall budget: later configs are skipped once it is spent (reported
    # in the JSON) rather than timing out with no output
    budget = float(os.environ.get("BENCH_BUDGET_S", 600))
    t_start = time.time()
    out = {}
    skipped = []
    for name in _configs():
        if name in skip:
            continue
        if time.time() - t_start > budget:
            skipped.append(name)
            log(f"[{name}] skipped: bench budget exhausted "
                f"({time.time()-t_start:.0f}s > {budget:.0f}s)")
            continue
        # one child per config, one at a time: the child is the only
        # process that holds the card; a failure degrades the report
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--config", name],
            stdout=subprocess.PIPE, text=True, timeout=7200)
        lines = proc.stdout.strip().splitlines()
        try:
            out[name] = json.loads(lines[-1]) if proc.returncode == 0 \
                else {"error": proc.returncode}
        except (IndexError, ValueError):
            out[name] = {"error": "no result line"}
        log(f"[partial] {json.dumps(out[name])}")
    if skipped:
        out["skipped_over_budget"] = skipped

    head = out.get("headline", {})
    print(json.dumps({
        "metric": "canonical_kmers_counted_per_sec_per_device",
        "value": head.get("kmers_per_sec", 0),
        "unit": "kmers/s",
        "vs_baseline": round(
            head.get("kmers_per_sec", 0) / BASELINE_KMERS_PER_SEC, 3),
        "glued_per_sec": head.get("glued_per_sec", 0),
        "configs": out,
    }))


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--config":
        sys.exit(run_child(sys.argv[2]))
    main()
