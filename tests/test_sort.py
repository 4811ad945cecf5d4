"""sort_ops contract: lexicographic multi-key sort with payload carry."""

import numpy as np

import jax.numpy as jnp

from bcalm_tpu.ops import sort


def test_sort_ops_multikey_with_payload():
    rng = np.random.RandomState(0)
    n = 4096
    k0 = rng.randint(0, 8, size=n).astype(np.uint32)
    k1 = rng.randint(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    pay = np.arange(n, dtype=np.uint32)
    out = sort.sort_ops(
        [jnp.asarray(k0), jnp.asarray(k1), jnp.asarray(pay)], num_keys=2)
    o0, o1, op = (np.asarray(x) for x in out)
    order = np.lexsort((k1, k0))
    assert (o0 == k0[order]).all()
    assert (o1 == k1[order]).all()
    # payloads move with their keys (set equality per key pair)
    got = sorted(zip(o0.tolist(), o1.tolist(), op.tolist()))
    want = sorted(zip(k0.tolist(), k1.tolist(), pay.tolist()))
    assert got == want


def test_sort_ops_single_key():
    rng = np.random.RandomState(1)
    x = rng.randint(0, 2**32, size=1000, dtype=np.uint64).astype(np.uint32)
    out = sort.sort_ops([jnp.asarray(x)], num_keys=1)
    assert (np.asarray(out[0]) == np.sort(x)).all()
