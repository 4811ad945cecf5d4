"""CLI + banks + writers end-to-end (the analog of test/simple_test.sh +
example/run-tiny.sh, self-contained without network)."""

import gzip
import io
import os

import numpy as np
import pytest

from bcalm_tpu import cli, engine
from bcalm_tpu.io import bank, fasta_writer, gfa
from bcalm_tpu.oracle import brute

TINY = "ACTGCTGACTGAGTCATGTGTGGGT"

def _canon(s):
    from bcalm_tpu.utils.dna import revcomp
    return min(s, revcomp(s))



def write_fasta_file(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">read{i}\n{s}\n")


def test_run_tiny(tmp_path, capsys):
    """run-tiny.sh: bcalm -in tiny_read.fa -kmer-size 13 -abundance-min 1."""
    fa = tmp_path / "tiny_read.fa"
    write_fasta_file(fa, [TINY])
    rc = cli.main(["-in", str(fa), "-kmer-size", "13", "-abundance-min", "1",
                   "-out", str(tmp_path / "tiny")])
    assert rc == 0
    out = tmp_path / "tiny.unitigs.fa"
    seqs, headers = fasta_writer.parse_unitigs_fasta(str(out))
    assert len(seqs) == 1
    assert brute.unitig_key(seqs[0]) == brute.unitig_key(TINY)
    assert headers[0].split(" ")[0] == "0"
    assert "LN:i:25" in headers[0]
    assert "KC:i:13" in headers[0]
    assert "km:f:1.0" in headers[0]
    # intermediate store removed after success (reference removes .h5)
    assert not os.path.exists(str(tmp_path / "tiny") + "_btpu")


def test_fastq_gz_and_album(tmp_path):
    fq = tmp_path / "reads.fastq.gz"
    with gzip.open(fq, "wt") as f:
        for i in range(3):
            f.write(f"@r{i}\n{TINY}\n+\n{'I' * len(TINY)}\n")
    fa = tmp_path / "reads2.fa"
    write_fasta_file(fa, [TINY])
    album = tmp_path / "list_reads"
    album.write_text("reads.fastq.gz\nreads2.fa\n")

    b = bank.Bank.open(str(album))
    seqs = list(b.sequences())
    assert seqs == [TINY] * 4
    n, total = b.estimate()
    assert n == 4 and total == 4 * len(TINY)

    rc = cli.main(["-in", str(album), "-kmer-size", "13", "-abundance-min", "4",
                   "-out", str(tmp_path / "album")])
    assert rc == 0
    seqs, headers = fasta_writer.parse_unitigs_fasta(
        str(tmp_path / "album.unitigs.fa"))
    assert len(seqs) == 1
    assert "KC:i:52" in headers[0]  # 13 k-mers x 4 copies


def test_all_abundance_counts(tmp_path):
    fa = tmp_path / "r.fa"
    write_fasta_file(fa, [TINY] * 2)
    rc = cli.main(["-in", str(fa), "-kmer-size", "13", "-abundance-min", "1",
                   "-out", str(tmp_path / "r"), "-all-abundance-counts"])
    assert rc == 0
    _, headers = fasta_writer.parse_unitigs_fasta(str(tmp_path / "r.unitigs.fa"))
    assert "ab:Z:" + " ".join(["2"] * 13) in headers[0]


def test_redo_links(tmp_path):
    seqs = ["ACTAATCATTACATGAGATCAGGCAATG",
            "CAGGCAATGAGATGATAACATGATAGATGAGACCAATT",
            "AATTGGTCTGGTTGGATTGTACTCATGATG"]
    fa = tmp_path / "refs.fa"
    write_fasta_file(fa, seqs)
    rc = cli.main(["-in", str(fa), "-kmer-size", "9", "-abundance-min", "1",
                   "-out", str(tmp_path / "refs")])
    assert rc == 0
    upath = str(tmp_path / "refs.unitigs.fa")
    before_seqs, before_headers = fasta_writer.parse_unitigs_fasta(upath)
    # the canonical resume command printed by pufferize.py:143
    rc = cli.main(["-in", str(tmp_path / "refs"), "-skip-bcalm", "-skip-bglue",
                   "-redo-links", "-kmer-size", "9",
                   "-out", str(tmp_path / "refs")])
    assert rc == 0
    after_seqs, after_headers = fasta_writer.parse_unitigs_fasta(upath)
    assert after_seqs == before_seqs
    link = lambda hs: sorted(
        (i, t) for i, h in enumerate(hs) for t in h.split(" ")
        if t.startswith("L:"))
    assert link(after_headers) == link(before_headers)


def test_gfa_conversion(tmp_path):
    fa = tmp_path / "c.fa"
    write_fasta_file(fa, ["ACTTAGCGGACTTAGC"])
    rc = cli.main(["-in", str(fa), "-kmer-size", "7", "-abundance-min", "1",
                   "-out", str(tmp_path / "c")])
    assert rc == 0
    out = io.StringIO()
    gfa.fasta_to_gfa(str(tmp_path / "c.unitigs.fa"), out, 7)
    lines = out.getvalue().splitlines()
    assert lines[0] == "H\tVN:Z:1.0\tks:i:7"
    s_lines = [l for l in lines if l.startswith("S\t")]
    l_lines = [l for l in lines if l.startswith("L\t")]
    assert len(s_lines) == 1
    # circular unitig: self-links on both strands, overlap k-1=6M
    assert "L\t0\t+\t0\t+\t6M" in l_lines
    assert "L\t0\t-\t0\t-\t6M" in l_lines
    # single-directed drops the -/- self-link (convertToGFA.py:106-110)
    out2 = io.StringIO()
    gfa.fasta_to_gfa(str(tmp_path / "c.unitigs.fa"), out2, 7,
                     single_directed=True)
    l2 = [l for l in out2.getvalue().splitlines() if l.startswith("L\t")]
    assert "L\t0\t+\t0\t+\t6M" in l2
    assert "L\t0\t-\t0\t-\t6M" not in l2


def test_version_and_errors(tmp_path, capsys):
    assert cli.main(["-version"]) == 0
    assert "bcalm-tpu" in capsys.readouterr().out
    assert cli.main(["-bogus"]) == 1
    assert cli.main(["-in", str(tmp_path / "missing.fa")]) == 1


def test_solid_kmers_out(tmp_path):
    fa = tmp_path / "r.fa"
    write_fasta_file(fa, [TINY])
    sk = tmp_path / "solid.txt"
    rc = cli.main(["-in", str(fa), "-kmer-size", "13", "-abundance-min", "1",
                   "-out", str(tmp_path / "r"), "-solid-kmers-out", str(sk)])
    assert rc == 0
    lines = sk.read_text().strip().splitlines()
    assert len(lines) == 13
    got = {l.split("\t")[0]: int(l.split("\t")[1]) for l in lines}
    expect = brute.count_kmers([TINY], 13)
    assert {brute.str2num(s): c for s, c in got.items()} == expect


def test_only_uf_and_uf_stats(tmp_path, capsys):
    """--only-uf / --uf-stats analogs (src/bcalm_1.cpp:26-27): stop after
    chain labeling, print class stats; no unitigs file is written."""
    fa = tmp_path / "r.fa"
    write_fasta_file(fa, [TINY])
    out = tmp_path / "r"
    rc = cli.main(["-in", str(fa), "-kmer-size", "13", "-abundance-min", "1",
                   "-out", str(out), "-only-uf", "-uf-stats"])
    assert rc == 0
    assert not os.path.exists(str(out) + ".unitigs.fa")
    text = capsys.readouterr().out
    assert "uf_classes" in text and "only-uf" in text
    # full run with -uf-stats still writes output + stats
    rc = cli.main(["-in", str(fa), "-kmer-size", "13", "-abundance-min", "1",
                   "-out", str(out), "-uf-stats"])
    assert rc == 0
    assert os.path.exists(str(out) + ".unitigs.fa")
    assert "uf_classes" in capsys.readouterr().out


def test_solidity_kinds(tmp_path):
    """Multi-sample solidity (hidden STR_SOLIDITY_KIND, bcalm_1.cpp:36):
    min = k-mer must be solid across ALL samples, max = best sample."""
    s1 = "ACTGCTGACTGAGTCA"   # sample 1 only
    s2 = "GGTCATCGGCATATAG"   # sample 2 only
    both = "TTTACGCATCGAATCC"  # in both samples
    f1 = tmp_path / "s1.fa"
    f2 = tmp_path / "s2.fa"
    write_fasta_file(f1, [s1, both])
    write_fasta_file(f2, [s2, both])
    album = tmp_path / "album.txt"
    album.write_text(f"{f1}\n{f2}\n")

    def run(kind, tag):
        out = tmp_path / f"out_{tag}"
        rc = cli.main(["-in", str(album), "-kmer-size", "13",
                       "-abundance-min", "1", "-solidity-kind", kind,
                       "-out", str(out)])
        assert rc == 0
        seqs, _ = fasta_writer.parse_unitigs_fasta(str(out) + ".unitigs.fa")
        return set().union(*[
            {_canon(seq[i:i + 13]) for i in range(len(seq) - 12)}
            for seq in seqs
        ]) if seqs else set()

    def kmers(seq):
        return {_canon(seq[i:i + 13]) for i in range(len(seq) - 12)}

    assert run("min", "min") == kmers(both)
    assert run("max", "max") == kmers(s1) | kmers(s2) | kmers(both)
    assert run("sum", "sum") == kmers(s1) | kmers(s2) | kmers(both)


def test_abundance_min_auto(tmp_path):
    """`-abundance-min auto` picks the histogram valley (gatb auto cutoff,
    capped by -abundance-min-threshold)."""
    # noise k-mers at abundance 1, signal at abundance 8
    signal = "ACTGCTGACTGAGTCATGTGTGGGT"
    noise = "GGTCATCGGCATATAGCCATTGAC"
    fa = tmp_path / "r.fa"
    write_fasta_file(fa, [signal] * 8 + [noise])
    out = tmp_path / "auto"
    rc = cli.main(["-in", str(fa), "-kmer-size", "13",
                   "-abundance-min", "auto", "-out", str(out)])
    assert rc == 0
    seqs, _ = fasta_writer.parse_unitigs_fasta(str(out) + ".unitigs.fa")
    got = set()
    for seq in seqs:
        got |= {_canon(seq[i:i + 13]) for i in range(len(seq) - 12)}
    want = {_canon(signal[i:i + 13]) for i in range(len(signal) - 12)}
    assert got == want  # noise filtered, signal kept


def test_devices_flag_distributed_build(tmp_path):
    """-devices N > 1 routes through the mesh-sharded build (the conftest
    provides 8 virtual CPU devices) and produces oracle-equal output."""
    import random
    rng = random.Random(3)
    genome = "".join(rng.choice("ACTG") for _ in range(300))
    reads = [genome[i:i + 60] for i in range(0, 240, 9)]
    fa = tmp_path / "r.fa"
    write_fasta_file(fa, reads)
    out1 = tmp_path / "single"
    out4 = tmp_path / "mesh"
    for out, dev in ((out1, []), (out4, ["-devices", "4"])):
        rc = cli.main(["-in", str(fa), "-kmer-size", "21",
                       "-abundance-min", "1", "-out", str(out)] + dev)
        assert rc == 0
    s1, _ = fasta_writer.parse_unitigs_fasta(str(out1) + ".unitigs.fa")
    s4, _ = fasta_writer.parse_unitigs_fasta(str(out4) + ".unitigs.fa")
    assert brute.canonical_unitig_set(s1) == brute.canonical_unitig_set(s4)


def test_legacy_flags_accepted(tmp_path):
    """Legacy/hidden reference flags parse and run (parity acceptance:
    -nb-glue-partitions, -max-disk, -histo-max, -minimizer-type...)."""
    fa = tmp_path / "r.fa"
    write_fasta_file(fa, [TINY])
    rc = cli.main([
        "-in", str(fa), "-kmer-size", "13", "-abundance-min", "1",
        "-out", str(tmp_path / "o"),
        "-nb-glue-partitions", "200", "-max-disk", "3000",
        "-histo-max", "500", "-minimizer-type", "1",
        "-minimizer-size", "5", "-repartition-type", "1",
        "-nb-cores", "2", "-abundance-min-threshold", "5",
    ])
    assert rc == 0
    assert os.path.exists(str(tmp_path / "o") + ".unitigs.fa")


def test_skip_bcalm_resume(tmp_path, capsys):
    """Resume workflow (scripts/pufferize.py:143 analog): a run stopped
    after counting (-only-uf keeps the store) is resumed from stored
    counts without re-reading the input."""
    fa = tmp_path / "r.fa"
    write_fasta_file(fa, [TINY])
    out = tmp_path / "r"
    rc = cli.main(["-in", str(fa), "-kmer-size", "13", "-abundance-min", "1",
                   "-out", str(out), "-only-uf"])
    assert rc == 0
    capsys.readouterr()
    # delete the input: resume must come from the store alone
    os.unlink(fa)
    rc = cli.main(["-in", str(fa), "-kmer-size", "13", "-abundance-min", "1",
                   "-out", str(out), "-skip-bcalm"])
    assert rc == 0
    assert "reusing stored counts" in capsys.readouterr().out
    seqs, _ = fasta_writer.parse_unitigs_fasta(str(out) + ".unitigs.fa")
    assert brute.unitig_key(seqs[0]) == brute.unitig_key(TINY)


# ---------------------------------------------------------------------------
# resume correctness: stored counting parameters are validated on reuse
# (round-1 VERDICT confirmed bug: implicit reuse ignored -abundance-min)
# ---------------------------------------------------------------------------

# minitip-style fixture: two abundant overlapping reads + one single-copy
# tip read, so -abundance-min 1 and 3 give different unitig sets
_AB_SEQS = (["CAGGCAATGAGATGATAACATGATAGA"] * 3
            + ["ATGATAACATGATAGATGAGACCAATT"] * 3
            + ["TAACATGATAGATCCCGGGTTTAAACC"])


def _amin_build(tmp_path, name, amin, extra=()):
    fa = tmp_path / f"{name}.fa"
    write_fasta_file(fa, _AB_SEQS)
    out = tmp_path / name
    rc = cli.main(["-in", str(fa), "-kmer-size", "13", "-abundance-min",
                   str(amin), "-out", str(out)] + list(extra))
    return rc, str(out) + ".unitigs.fa", out


def _unitig_set(path):
    seqs, _ = fasta_writer.parse_unitigs_fasta(path)
    return sorted(_canon(s) for s in seqs)


def test_no_implicit_store_reuse(tmp_path):
    """A leftover store must NOT be reused without -skip-bcalm: rerunning
    with a different -abundance-min must recount (round-1 repro: reuse
    produced abundance-1 unitigs under -abundance-min 3)."""
    rc, _, out = _amin_build(tmp_path, "a", 1, extra=["-only-uf"])
    assert rc == 0
    assert os.path.isdir(str(out) + "_btpu")  # store kept by -only-uf
    # fresh ground truth at amin=3 from a separate prefix
    rc, truth_path, _ = _amin_build(tmp_path, "truth", 3)
    assert rc == 0
    # rerun over the stale store WITHOUT -skip-bcalm: must recount
    rc, upath, _ = _amin_build(tmp_path, "a", 3)
    assert rc == 0
    assert _unitig_set(upath) == _unitig_set(truth_path)


def test_skip_bcalm_refilters_higher_amin(tmp_path):
    """-skip-bcalm with a HIGHER cutoff re-filters the stored counts."""
    rc, _, out = _amin_build(tmp_path, "b", 1, extra=["-only-uf"])
    assert rc == 0
    rc, truth_path, _ = _amin_build(tmp_path, "truth2", 3)
    assert rc == 0
    fa = tmp_path / "b.fa"
    os.unlink(fa)  # resume must not need the input
    rc = cli.main(["-in", str(fa), "-kmer-size", "13", "-abundance-min", "3",
                   "-out", str(out), "-skip-bcalm"])
    assert rc == 0
    assert _unitig_set(str(out) + ".unitigs.fa") == _unitig_set(truth_path)


def test_skip_bcalm_lower_amin_refused(tmp_path, capsys):
    """-skip-bcalm with a LOWER cutoff cannot be served from post-filter
    counts: refuse loudly instead of producing wrong output."""
    rc, _, out = _amin_build(tmp_path, "c", 3, extra=["-only-uf"])
    assert rc == 0
    fa = tmp_path / "c.fa"
    rc = cli.main(["-in", str(fa), "-kmer-size", "13", "-abundance-min", "1",
                   "-out", str(out), "-skip-bcalm"])
    assert rc == 1
    assert "cannot widen" in capsys.readouterr().err


def test_skip_bcalm_wrong_k_refused(tmp_path, capsys):
    rc, _, out = _amin_build(tmp_path, "d", 1, extra=["-only-uf"])
    assert rc == 0
    rc = cli.main(["-in", str(tmp_path / "d.fa"), "-kmer-size", "15",
                   "-abundance-min", "1", "-out", str(out), "-skip-bcalm"])
    assert rc == 1
    assert "k=13" in capsys.readouterr().err


def test_skip_bglue_resume(tmp_path, capsys):
    """-only-uf checkpoints the chain decomposition; -skip-bcalm
    -skip-bglue resumes from it (the glue-file stage boundary)."""
    rc, _, out = _amin_build(tmp_path, "e", 1, extra=["-only-uf"])
    assert rc == 0
    rc, truth_path, _ = _amin_build(tmp_path, "truth3", 1)
    assert rc == 0
    capsys.readouterr()
    os.unlink(tmp_path / "e.fa")
    rc = cli.main(["-in", str(tmp_path / "e.fa"), "-kmer-size", "13",
                   "-abundance-min", "1", "-out", str(out),
                   "-skip-bcalm", "-skip-bglue"])
    assert rc == 0
    assert "reusing stored chain decomposition" in capsys.readouterr().out
    assert _unitig_set(str(out) + ".unitigs.fa") == _unitig_set(truth_path)


def test_skip_bglue_stale_checkpoint_refused(tmp_path, capsys):
    """Raising -abundance-min changes the solid set, so the chain
    checkpoint is stale: -skip-bglue must refuse."""
    rc, _, out = _amin_build(tmp_path, "f", 1, extra=["-only-uf"])
    assert rc == 0
    rc = cli.main(["-in", str(tmp_path / "f.fa"), "-kmer-size", "13",
                   "-abundance-min", "3", "-out", str(out),
                   "-skip-bcalm", "-skip-bglue"])
    assert rc == 1
    assert "stale" in capsys.readouterr().err


def test_skip_bglue_without_checkpoint_refused(tmp_path, capsys):
    rc, _, out = _amin_build(tmp_path, "g", 1)
    assert rc == 0  # full run removes the store
    rc = cli.main(["-in", str(tmp_path / "g.fa"), "-kmer-size", "13",
                   "-abundance-min", "1", "-out", str(out),
                   "-skip-bcalm", "-skip-bglue"])
    assert rc == 1
    assert "no stored counts" in capsys.readouterr().err


def test_devices_auto_abundance_matches_single(tmp_path):
    """`-abundance-min auto -devices N` resolves the same cutoff and
    output as the single-device auto path (round-2 VERDICT item 4: the
    distributed branch used to silently run at amin=1)."""
    import random
    rng = random.Random(9)
    genome = "".join(rng.choice("ACTG") for _ in range(400))
    reads = []
    for _ in range(6):
        for i in range(0, 360, 15):
            reads.append(genome[i:i + 40])
    for _ in range(30):  # singleton error reads form the histogram valley
        reads.append("".join(rng.choice("ACTG") for _ in range(40)))
    fa = tmp_path / "r.fa"
    write_fasta_file(fa, reads)
    outs = {}
    for name, extra in (("single", []), ("mesh", ["-devices", "4"])):
        out = tmp_path / name
        rc = cli.main(["-in", str(fa), "-kmer-size", "15",
                       "-abundance-min", "auto", "-out", str(out)] + extra)
        assert rc == 0
        seqs, _ = fasta_writer.parse_unitigs_fasta(str(out) + ".unitigs.fa")
        outs[name] = brute.canonical_unitig_set(seqs)
    assert outs["single"] == outs["mesh"]
    # auto must have filtered the error k-mers: no unitig is a pure
    # singleton fragment (all reads at coverage >= 6 survive)
    assert len(outs["single"]) >= 1


def test_devices_refuses_min_max_solidity(tmp_path):
    """Multi-sample min/max solidity on the mesh path would silently
    behave as 'sum'; the CLI must refuse instead of diverging."""
    fa = tmp_path / "r.fa"
    write_fasta_file(fa, [TINY])
    rc = cli.main(["-in", str(fa), "-kmer-size", "13",
                   "-abundance-min", "1", "-out", str(tmp_path / "o"),
                   "-devices", "4", "-solidity-kind", "min"])
    assert rc == 1


class _Execed(Exception):
    """Stands in for os.execve, which never returns."""


def _oom_build(monkeypatch, tmp_path):
    """A build whose compaction dies with CompactionOOM, and a recorder
    in place of os.execve.  Returns (args, calls)."""
    fa = tmp_path / "r.fa"
    write_fasta_file(fa, [TINY] * 3)

    def boom(*a, **kw):
        try:
            raise RuntimeError("RESOURCE_EXHAUSTED: Out of memory while "
                               "trying to allocate 17179869184 bytes.")
        except RuntimeError as e:
            raise engine.CompactionOOM(
                "device allocator exhausted during compaction; the "
                "counted solid set is checkpointed — resume with "
                "-skip-bcalm in a fresh process") from e

    monkeypatch.setattr(engine, "build_from_blocks", boom)
    monkeypatch.delenv("BTPU_NO_RESPAWN", raising=False)
    calls = []

    def fake_execve(path, argv, env):
        calls.append((path, argv, env))
        raise _Execed()

    monkeypatch.setattr(os, "execve", fake_execve)
    args = ["-in", str(fa), "-kmer-size", "13", "-abundance-min", "1",
            "-verbose", "0"]
    return args, calls


def test_compaction_oom_respawns_skip_bcalm(tmp_path, monkeypatch, capsys):
    """A CompactionOOM from the build (allocator death after the counting
    checkpoint) REPLACES the process (exec, so the device reservation goes
    with it) by the identical command plus -skip-bcalm, after printing
    the original traceback; a respawned process (BTPU_NO_RESPAWN=1) or an
    explicit -skip-bcalm run never loops."""
    args, calls = _oom_build(monkeypatch, tmp_path)
    with pytest.raises(_Execed):
        cli.main(args)
    assert len(calls) == 1
    path, argv, env = calls[0]
    assert path == argv[0]
    assert argv[1:3] == ["-m", "bcalm_tpu"]
    assert argv[3:-1] == args and argv[-1] == "-skip-bcalm"
    assert env["BTPU_NO_RESPAWN"] == "1"
    # the package stays importable from any working directory
    root = os.path.dirname(os.path.dirname(os.path.abspath(cli.__file__)))
    assert env["PYTHONPATH"].split(os.pathsep)[0] == root
    err = capsys.readouterr().err
    assert "Traceback" in err and "RESOURCE_EXHAUSTED" in err

    # respawned process must not respawn again: the OOM propagates
    monkeypatch.setenv("BTPU_NO_RESPAWN", "1")
    calls.clear()
    with pytest.raises(engine.CompactionOOM):
        cli.main(args)
    assert not calls

    # nor does a run the user already started with -skip-bcalm
    monkeypatch.delenv("BTPU_NO_RESPAWN")
    assert cli._respawn_skip_bcalm(args + ["-skip-bcalm"],
                                   RuntimeError("x")) is None
    assert not calls


def test_compaction_oom_no_exec_under_server(tmp_path, monkeypatch, capsys):
    """The -server process must keep serving: a compaction OOM answers
    rc 1 with the resume hint and never replaces the process."""
    args, calls = _oom_build(monkeypatch, tmp_path)
    assert cli.main(args, allow_exec=False) == 1
    assert not calls
    assert "-skip-bcalm" in capsys.readouterr().err


def test_server_never_execs(tmp_path, monkeypatch):
    """End to end through the socket: the server answers the OOM'd
    request with rc 1 and keeps serving the next one."""
    import json
    import socket as socket_mod
    import threading

    args, calls = _oom_build(monkeypatch, tmp_path)
    sock = str(tmp_path / "s.sock")
    t = threading.Thread(target=cli.serve, args=(sock,), daemon=True)
    t.start()
    for _ in range(200):
        if os.path.exists(sock):
            break
        t.join(0.05)

    def request(payload):
        c = socket_mod.socket(socket_mod.AF_UNIX, socket_mod.SOCK_STREAM)
        c.settimeout(60)
        c.connect(sock)
        c.sendall(json.dumps(payload).encode() + b"\n")
        data = b""
        while not data.endswith(b"\n"):
            chunk = c.recv(1 << 16)
            if not chunk:
                break
            data += chunk
        c.close()
        return json.loads(data)

    assert request({"argv": args})["rc"] == 1
    assert request({"argv": ["-version"]})["rc"] == 0
    assert request({"op": "shutdown"})["rc"] == 0
    t.join(10)
    assert not t.is_alive()
    assert not calls


def test_is_resource_exhausted_classifier():
    # the GPU allocator's status texts (XLA's BFC allocator)
    assert engine._is_resource_exhausted(RuntimeError(
        "RESOURCE_EXHAUSTED: Out of memory while trying to allocate "
        "17179869184 bytes."))
    assert engine._is_resource_exhausted(RuntimeError(
        "ResourceExhausted: failed to allocate request for 16.00GiB on "
        "device ordinal 0"))
    assert not engine._is_resource_exhausted(ValueError("shape mismatch"))
