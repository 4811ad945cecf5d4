"""chip_smoke.py on the CPU: it refuses to run off the GPU, and its
generator, comparison helpers and exact phase are checked at tiny sizes
(the full run needs the card)."""

import gzip
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402
import chip_smoke as cs  # noqa: E402

TINY = dict(genome_len=8000, coverage=8, read_len=100, repeat_frac=0.05,
            err_rate=0.002, dup_frac=0.2)


def test_refuses_cpu_backend(tmp_path):
    """On the CPU backend the script fails at the device phase and prints
    no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "not the GPU" in proc.stdout


def test_fails_without_the_repo(tmp_path):
    """Alone in a directory, the script cannot import the program."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(open(os.path.join(ROOT, "chip_smoke.py"), "rb").read())
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_generator_deterministic_and_branching(tmp_path):
    from bcalm_tpu.oracle import brute

    a, b, c = (str(tmp_path / f"{n}.fa.gz") for n in "abc")
    n = bench.write_reads(a, 5, **TINY)
    bench.write_reads(b, 5, **TINY)
    bench.write_reads(c, 6, **TINY)
    assert n == TINY["genome_len"] * TINY["coverage"] // TINY["read_len"]
    raw = [gzip.open(p).read() for p in (a, b, c)]
    assert raw[0] == raw[1]
    assert raw[0] != raw[2]
    seqs = cs.read_seqs(a)
    assert len(seqs) == n and all(len(s) == TINY["read_len"] for s in seqs)
    g = brute.build(seqs, 21, abundance_min=2)
    assert len(g.unitigs) > 1
    assert cs.branch_points(g) > 0


def _write_unitigs(path, entries):
    with open(path, "w") as f:
        for i, (seq, kc, links) in enumerate(entries):
            ls = " ".join(f"L:{su}:{v}:{sv}" for su, v, sv in links)
            f.write(f">{i} LN:i:{len(seq)} KC:i:{kc} km:f:1.0 {ls}\n{seq}\n")


@pytest.mark.parametrize("change", ["kc", "unitigs", "links"])
def test_comparison_catches_changes(tmp_path, change):
    """A changed KC, unitig or link shows up as that field differing;
    orientation and id order do not."""
    from bcalm_tpu.utils.dna import revcomp

    k = 5
    a, b = "ACGTTGCA", "TTGCAGGC"   # a's suffix TGCA is b's prefix
    base = [(a, 8, [("+", 1, "+")]), (b, 6, [("-", 0, "-")])]
    # same graph, other ids and orientation
    same = [(revcomp(b), 6, [("+", 1, "-")]), (a, 8, [("+", 0, "-")])]
    _write_unitigs(tmp_path / "base.fa", base)
    _write_unitigs(tmp_path / "same.fa", same)
    want = cs.summarize(cs.graph_from_fasta(str(tmp_path / "base.fa"), k))
    got = cs.summarize(cs.graph_from_fasta(str(tmp_path / "same.fa"), k))
    assert cs.differences(got, want) == []

    if change == "kc":
        bad = [(a, 9, [("+", 1, "+")]), (b, 6, [("-", 0, "-")])]
    elif change == "unitigs":
        bad = [(a, 8, [("+", 1, "+")]), (b[:-1] + "A", 6, [("-", 0, "-")])]
    else:
        bad = [(a, 8, []), (b, 6, [])]
    _write_unitigs(tmp_path / "bad.fa", bad)
    got = cs.summarize(cs.graph_from_fasta(str(tmp_path / "bad.fa"), k))
    assert change in cs.differences(got, want)


def test_circular_rule_is_symmetric():
    """A circular unitig is recognized from sequence + self-link alone, so
    two break points of one cycle compare equal."""
    from bcalm_tpu.oracle import brute

    k = 5
    core = "ACGGTCATTG"
    one = core + core[:k - 1]
    two = core[3:] + core[:3] + core[3:3 + k - 1]
    graphs = []
    for s in (one, two):
        g = brute.CompactedGraph(
            k=k, unitigs=[brute.Unitig(seq=s, kc=10, abundances=[])],
            links=[(0, "+", 0, "+"), (0, "-", 0, "-")])
        graphs.append(cs.summarize(cs.mark_circular(g)))
        assert g.unitigs[0].is_circular
    assert cs.differences(graphs[0], graphs[1]) == []


def test_exact_phase_matches_brute_tiny(tmp_path, capsys):
    cs.phase_exact(str(tmp_path), 3, ks=(15,), **TINY)
    out = capsys.readouterr().out
    assert "equal to oracle.brute" in out


def test_exact_phase_detects_wrong_build(tmp_path, monkeypatch):
    """A build that loses a k-mer's count is caught by the oracle check."""
    real = cs.graph_from_fasta

    def tampered(path, k):
        g = real(path, k)
        g.unitigs[0].kc += 1
        return g

    monkeypatch.setattr(cs, "graph_from_fasta", tampered)
    with pytest.raises(cs.PhaseError, match="kc"):
        cs.phase_exact(str(tmp_path), 3, ks=(15,), **TINY)
