"""Driver entry-point smoke tests (single-chip compile path; the
multi-chip dryrun is covered in tests/test_parallel.py)."""

import numpy as np

import jax


def test_entry_compiles_and_runs():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    out = np.asarray(out)
    assert out.shape == (32, 10)
    np.testing.assert_allclose(out.sum(axis=1), 1.0, atol=1e-5)  # softmax rows


def test_dryrun_refuses_too_few_devices():
    """No silent switch to another platform: too few devices is an error
    that says how to get a virtual CPU mesh."""
    import pytest

    import __graft_entry__ as g

    with pytest.raises(RuntimeError, match="xla_force_host_platform"):
        g.dryrun_multichip(len(jax.devices()) + 1)
