"""Bring-up check: the BCALM build on one GPU, end to end through the CLI.

    python chip_smoke.py [--seed N]          # one GPU: all phases below
    python chip_smoke.py --devices 4 [...]   # the 4-GPU mesh phase only

Every build goes through the normal entry point, `bcalm_tpu.cli.main`,
inside this one process (a JAX process reserves most of a card's memory,
so no second JAX process is ever started).  Inputs are generated from
--seed by bench.write_reads (bench.make_genome + bench.sample_reads) as
gzipped FASTA; nothing is downloaded.  Phases, in order (any failure exits
non-zero and prints no `ok` line):

  device     the backend must be the GPU (never a CPU fallback); prints
             the device kind and count, the card's name and power limit
             (nvidia-smi) and whether ingest uses the native library
  exact      a branching 30 kbp genome (5% repeats, 0.2% substitution
             errors, 20% PCR duplicates, 30x of 150 bp reads) at k=31 and
             k=63, -abundance-min 2; unitig set, per-unitig KC and link
             set must equal the brute-force oracle (oracle.brute)
  scale      the E. coli-class configuration (BASELINE.json configs[2]:
             4.6 Mbp, 5% repeats, 0.1% errors, 20% duplicates, 50x of
             150 bp reads, k=31, ~184M k-mer occurrences), built twice:
             scripts/sampled_check.py must pass and both unitigs.fa files
             must be byte-identical
  multipass  the same input under a -max-memory that forces >= 2
             counting passes; must equal the scale result
  --devices  (only with the option) the scale input on a 4-device mesh
             (-devices 4) and on one device, exactly equal; the mesh's
             per-device peak memory must stay balanced (no array lands
             whole on device 0)

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import tempfile
import time

import bench

ROOT = os.path.dirname(os.path.abspath(__file__))

EXACT = dict(genome_len=30_000, coverage=30, read_len=150,
             repeat_frac=0.05, err_rate=0.002, dup_frac=0.2)
SCALE = dict(genome_len=4_600_000, coverage=50, read_len=150,
             repeat_frac=0.05, err_rate=0.001, dup_frac=0.2)
# device-memory budget (MB) whose residency floor sits well below the
# scale input's ~10M distinct k-mers: counting must take >= 2 passes
MULTIPASS_MAX_MEMORY_MB = 1000


class PhaseError(RuntimeError):
    """A phase's check failed."""


def log(msg: str) -> None:
    print(msg, flush=True)


def read_seqs(path: str):
    """Sequences of a gzipped FASTA written by bench.write_reads."""
    with gzip.open(path, "rt") as f:
        return [line.strip() for line in f if not line.startswith(">")]


# ---------------------------------------------------------------------------
# comparison helpers
# ---------------------------------------------------------------------------

def mark_circular(graph):
    """Flag circular unitigs the same way for every graph: a circular
    unitig carries its (k-1) wrap suffix and links + to itself.  (The
    unitigs.fa header has no circular field; applying one rule to both
    sides keeps the rotation normalization of oracle.brute symmetric.)"""
    k = graph.k
    self_plus = {i for (i, si, j, sj) in graph.links
                 if i == j and si == sj == "+"}
    for i, u in enumerate(graph.unitigs):
        u.is_circular = (i in self_plus and len(u.seq) >= k
                         and u.seq[:k - 1] == u.seq[-(k - 1):])
    return graph


def graph_from_fasta(path: str, k: int):
    """Parse a unitigs.fa (sequence, KC, L: links) into an oracle graph."""
    from bcalm_tpu.io import fasta_writer
    from bcalm_tpu.oracle import brute

    seqs, headers = fasta_writer.parse_unitigs_fasta(path)
    unitigs, links = [], []
    for i, (s, h) in enumerate(zip(seqs, headers)):
        kc = 0
        for tok in h.split():
            if tok.startswith("KC:i:"):
                kc = int(tok[5:])
            elif tok.startswith("L:"):
                _, su, v, sv = tok.split(":")
                links.append((i, su, int(v), sv))
        unitigs.append(brute.Unitig(seq=s, kc=kc, abundances=[]))
    return mark_circular(brute.CompactedGraph(k=k, unitigs=unitigs,
                                              links=sorted(links)))


def summarize(graph) -> dict:
    """Orientation/ID-invariant content of a graph: unitig set, per-unitig
    KC and link set."""
    from bcalm_tpu.oracle import brute

    keys = [brute.content_key(u.seq, graph.k, u.is_circular)
            for u in graph.unitigs]
    return {"unitigs": sorted(keys),
            "kc": sorted(zip(keys, (int(u.kc) for u in graph.unitigs))),
            "links": brute.canonical_link_set(graph)}


def differences(got: dict, want: dict, fields=("unitigs", "kc", "links")):
    """Names of the summary fields that differ."""
    return [f for f in fields if got[f] != want[f]]


def branch_points(graph) -> int:
    """Unitig ends (unitig, side) with two or more links: junctions."""
    from collections import Counter

    return sum(1 for c in Counter((i, si) for (i, si, _, _)
                                  in graph.links).values() if c >= 2)


# ---------------------------------------------------------------------------
# CLI driving
# ---------------------------------------------------------------------------

def stat_lines(out: str):
    """The CLI's per-stage wall lines ([time:*])."""
    return [line.strip() for line in out.splitlines()
            if line.startswith("    [time:")]


def stat_value(out: str, key: str):
    for line in out.splitlines():
        if line.strip().startswith(f"[{key}] "):
            return line.split("] ", 1)[1].strip()
    return None


def build(reads: str, prefix: str, k: int, extra=()):
    """One in-process CLI build at -abundance-min 2; returns (unitigs.fa
    path, stdout text, wall seconds)."""
    argv = ["-in", reads, "-kmer-size", str(k), "-abundance-min", "2",
            "-out", prefix, "-verbose", "1", *extra]
    rc, out, wall = bench.run_cli_inprocess(argv)
    if rc != 0:
        raise PhaseError(f"cli {' '.join(argv)} exited {rc}:\n{out[-2000:]}")
    return prefix + ".unitigs.fa", out, wall


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    """Returns the device dict of the last line; exits 1 off the GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        log(f"device: backend is {devs[0].platform!r}, not the GPU")
        sys.exit(1)
    log(f"device: kind={devs[0].device_kind} count={len(devs)}")
    card = bench.card_info()
    if card.startswith("unavailable"):
        raise PhaseError(f"device: nvidia-smi {card}")
    for line in card.splitlines():
        log(line.strip())
    from bcalm_tpu.io import native

    log(f"device: ingest={'native' if native.available() else 'python'}")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def phase_exact(workdir: str, seed: int, ks=(31, 63), **shape):
    """The CLI against the brute-force oracle on a small branching input."""
    from bcalm_tpu.oracle import brute

    cfg = dict(EXACT, **shape)
    reads = os.path.join(workdir, "exact.fa.gz")
    n = bench.write_reads(reads, seed, **cfg)
    seqs = read_seqs(reads)
    for k in ks:
        path, out, wall = build(reads, os.path.join(workdir, f"exact{k}"), k)
        got = summarize(graph_from_fasta(path, k))
        want_g = brute.build(seqs, k, abundance_min=2)
        want = summarize(mark_circular(want_g))
        bad = differences(got, want)
        if bad:
            raise PhaseError(f"exact k={k}: {bad} differ from the oracle")
        n_branch = branch_points(want_g)
        log(f"exact: k={k} reads={n} unitigs={len(got['unitigs'])} "
            f"links={len(got['links'])} branch_points={n_branch} equal to "
            f"oracle.brute (unitig set, KC, links) wall={wall:.3f}s")
        if n_branch == 0:
            raise PhaseError(f"exact k={k}: input graph does not branch")


def peak_bytes(device) -> int:
    return int((device.memory_stats() or {}).get("peak_bytes_in_use", 0))


def phase_scale(workdir: str, reads: str):
    """Two builds of the E. coli-class input: sampled oracle + bytes."""
    import jax

    paths = []
    for run in (1, 2):
        path, out, wall = build(reads, os.path.join(workdir, f"scale{run}"),
                                31)
        paths.append(path)
        log(f"scale: run {run} wall={wall:.3f}s "
            f"n_unitigs={stat_value(out, 'unitigs')} "
            f"solid_kmers={stat_value(out, 'solid_kmers')} "
            f"distinct_kmers={stat_value(out, 'distinct_kmers')} "
            f"t_count_s={stat_value(out, 't_count_s')} "
            f"t_compact_s={stat_value(out, 't_compact_s')} "
            f"t_assemble_s={stat_value(out, 't_assemble_s')} "
            f"ingest_mbps={stat_value(out, 'ingest_mbps')}")
        for line in stat_lines(out):
            log(f"scale: run {run} {line}")
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        if a.read() != b.read():
            raise PhaseError("scale: the two runs' unitigs.fa differ")
    log("scale: unitigs.fa byte-identical across the two runs")
    chk = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "sampled_check.py"),
         paths[0], reads, "31", "5000", "2"],
        capture_output=True, text=True, timeout=900)
    verdict = (chk.stdout.strip().splitlines() or ["(no output)"])[-1]
    if chk.returncode != 0 or not verdict.startswith("SAMPLED_OK"):
        raise PhaseError(f"scale: sampled_check failed: {verdict}\n"
                         f"{chk.stderr[-2000:]}")
    log(f"scale: {verdict}")
    log(f"scale: peak_bytes_in_use={peak_bytes(jax.devices()[0])}")
    return paths[0]


def phase_multipass(workdir: str, reads: str, scale_path: str):
    """Out-of-core counting (>= 2 key-range passes) equals the scale run."""
    path, out, wall = build(
        reads, os.path.join(workdir, "multipass"), 31,
        extra=("-max-memory", str(MULTIPASS_MAX_MEMORY_MB)))
    passes = int(stat_value(out, "ooc_passes") or 1)
    log(f"multipass: -max-memory {MULTIPASS_MAX_MEMORY_MB} "
        f"passes={passes} wall={wall:.3f}s")
    if passes < 2:
        raise PhaseError(f"multipass: only {passes} counting pass")
    bad = differences(summarize(graph_from_fasta(path, 31)),
                      summarize(graph_from_fasta(scale_path, 31)))
    if bad:
        raise PhaseError(f"multipass: {bad} differ from the scale run")
    log("multipass: unitig set, KC and links equal to the scale run")


def phase_devices(workdir: str, reads: str, n_dev: int):
    """The mesh build on n_dev devices against the one-device build."""
    import jax

    devs = jax.devices()
    if len(devs) < n_dev:
        raise PhaseError(f"--devices {n_dev}: only {len(devs)} devices")
    # the mesh build runs first, so device 0's peak is the mesh's own
    mesh_path, out, wall = build(reads, os.path.join(workdir, "mesh"), 31,
                                 extra=("-devices", str(n_dev)))
    peaks = [peak_bytes(d) for d in devs[:n_dev]]
    log(f"devices: -devices {n_dev} wall={wall:.3f}s "
        f"n_unitigs={stat_value(out, 'unitigs')} peaks={peaks}")
    for line in stat_lines(out):
        log(f"devices: {line}")
    if min(peaks) <= 0 or max(peaks) > 2 * min(peaks):
        raise PhaseError(f"devices: unbalanced per-device peak memory "
                         f"{peaks} (an array landed whole on one device)")
    one_path, out1, wall1 = build(reads, os.path.join(workdir, "one"), 31)
    log(f"devices: one device wall={wall1:.3f}s")
    bad = differences(summarize(graph_from_fasta(mesh_path, 31)),
                      summarize(graph_from_fasta(one_path, 31)))
    if bad:
        raise PhaseError(f"devices: {bad} differ between -devices {n_dev} "
                         f"and one device")
    log(f"devices: -devices {n_dev} equal to one device "
        f"(unitig set, KC, links)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--devices", type=int, default=1,
                    help="run only the N-device mesh phase (N > 1)")
    args = ap.parse_args(argv)

    device = phase_device()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        t0 = time.time()
        if args.devices > 1:
            reads = os.path.join(workdir, "scale.fa.gz")
            bench.write_reads(reads, args.seed, **SCALE)
            phase_devices(workdir, reads, args.devices)
        else:
            phase_exact(workdir, args.seed)
            t1 = time.time()
            reads = os.path.join(workdir, "scale.fa.gz")
            n = bench.write_reads(reads, args.seed, **SCALE)
            log(f"scale: input {n} reads ({os.path.getsize(reads) >> 20} MB "
                f"gz) generated in {time.time() - t1:.3f}s")
            scale_path = phase_scale(workdir, reads)
            phase_multipass(workdir, reads, scale_path)
        log(f"total wall={time.time() - t0:.3f}s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        log(f"FAILED: {e}")
        sys.exit(1)
