"""bcalm-tpu: a JAX/XLA compacted de Bruijn graph engine.

A from-scratch re-design of the capabilities of BCALM 2 / GATB-core
(reference: /root/reference, BCALM v2.2.3) for accelerators:

- k-mer counting as dense sort/segment-reduce over 2-bit-packed uint32
  lanes (replaces GATB's disk-staged DSK, kmer/impl/SortingCountAlgorithm),
- compaction as vectorized junction-table classification + pointer-jumping
  (replaces gatb bcalm2/bcalm_algo.cpp + bglue_algo.cpp + unionFind.hpp),
- multi-chip scaling via jax.sharding Mesh + shard_map collectives
  (replaces the reference's disk partitions and thread pools).

Output semantics follow the bi-directed graph contract in
/root/reference/bidirected-graphs-in-bcalm2/bidirected-graphs-in-bcalm2.md.
"""

from bcalm_tpu.version import __version__, version_string

__all__ = ["__version__", "version_string"]
