"""Sort backend for the counting/junction engines.

`sort_ops` is the single sort entry point: every counting, junction,
reorder and assembly sort goes through it, so a different backend (a
packed-key sort, a radix pass) can slot in behind one call site.  Today
it is XLA's own multi-operand `lax.sort`.

Replaces the reference's per-partition k-mer radix sort (gatb
SortingCountAlgorithm's PartitionsByVectorCommand, reconstructed —
SURVEY.md §4.2) as the counting engine's workhorse.
"""

from __future__ import annotations

import jax


def sort_ops(operands, num_keys: int):
    """Sort uint32 operand tuples lexicographically by the first num_keys
    operands (drop-in for jax.lax.sort on flat uint32 arrays)."""
    return jax.lax.sort(operands, num_keys=num_keys)
