"""Hashed (96-bit) vs exact junction sort keys: identical successor
arrays (ops.junctions.use_hash_keys — the single-chip compaction-ceiling
lift, docs/OOC.md)."""
import random

import numpy as np
import jax.numpy as jnp
import pytest

from bcalm_tpu.models import lanes as ln
from bcalm_tpu.ops import junctions as junc


def _random_solid(seed, n, k, cap=None):
    """Distinct canonical k-mers from a random genome's k-mer walk (so
    the successor graph has real chains + junctions)."""
    rng = random.Random(seed)
    genome = "".join(rng.choice("ACGT") for _ in range(n + k - 1))
    seen = {}
    for i in range(n):
        kmer = genome[i:i + k]
        x = ln.string_to_int(kmer)
        rc = ln.string_to_int(
            kmer[::-1].translate(str.maketrans("ACGT", "TGCA")))
        seen[min(x, rc)] = True
    keys = sorted(seen)
    lanes = ln.ints_to_lanes(keys, k)
    n_solid = lanes.shape[1]
    cap = cap or 1
    while cap < n_solid:
        cap *= 2
    pad = np.zeros((lanes.shape[0], cap - n_solid), np.uint32)
    return jnp.asarray(np.concatenate([lanes, pad], axis=1)), n_solid


@pytest.mark.parametrize("k", [51, 63, 127])
def test_hash_keys_match_exact(monkeypatch, k):
    assert junc.use_hash_keys(k)
    solid, n_solid = _random_solid(5, 400, k)
    # bypass the jit cache (same shapes+k would reuse the first trace)
    fn = junc.successor_arrays.__wrapped__
    succ_hash, _ = fn(solid, jnp.asarray(n_solid, jnp.int32), k)
    monkeypatch.setattr(junc, "use_hash_keys", lambda _k: False)
    succ_exact, _ = fn(solid, jnp.asarray(n_solid, jnp.int32), k)
    assert np.array_equal(np.asarray(succ_hash), np.asarray(succ_exact))


def test_hash_not_engaged_small_k():
    for k in (13, 21, 31, 33, 47):
        assert not junc.use_hash_keys(k)


def test_hash96_no_collisions_on_distinct_keys():
    # 200k distinct keys -> expected 96-bit collisions ~ 1e-19
    rng = np.random.RandomState(0)
    lanes = jnp.asarray(
        rng.randint(0, 2**31, size=(4, 200_000)).astype(np.uint32))
    h0, h1, h2 = junc._hash96(lanes)
    h = (np.asarray(h0).astype(np.uint64) << np.uint64(32)) \
        | np.asarray(h1).astype(np.uint64)
    pairs = np.stack([h, np.asarray(h2).astype(np.uint64)], axis=1)
    uniq = np.unique(pairs, axis=0)
    assert uniq.shape[0] == 200_000


def test_hash96_no_collisions_on_structured_keys():
    """Keys that differ only in bit 31 of two or more lanes (the top base
    of each lane complemented, as substitution errors produce) must not
    collide: a bare xor-multiply chain maps all such pairs together."""
    rng = np.random.RandomState(1)
    base = rng.randint(0, 2**31, size=(4, 2000)).astype(np.uint32)
    top = np.uint32(1 << 31)
    variants = [base]
    for mask in range(1, 16):
        v = base.copy()
        for j in range(4):
            if mask >> j & 1:
                v[j] ^= top
        variants.append(v)
    lanes = np.concatenate(variants, axis=1)
    h = np.stack([np.asarray(x) for x in junc._hash96(jnp.asarray(lanes))],
                 axis=1)
    assert np.unique(h, axis=0).shape[0] == lanes.shape[1]
