"""Driver contract: __graft_entry__.entry() jits; dryrun_multichip runs."""

import sys
import os

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_entry_jits():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert int(out["n_unitigs"]) >= 1
    assert int(out["n_solid"]) > 0


def test_dryrun_multichip_8():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_dryrun_multichip_too_few_devices_raises():
    """Asking for more devices than the backend has raises; the backend
    is never switched underneath the caller."""
    import pytest

    import __graft_entry__ as g

    before = (jax.devices()[0].platform, len(jax.devices()))
    with pytest.raises(RuntimeError, match="backend exposes"):
        g.dryrun_multichip(len(jax.devices()) + 1)
    assert (jax.devices()[0].platform, len(jax.devices())) == before
