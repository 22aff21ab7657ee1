"""Driver entry points must stay callable (compile check + multichip dryrun)."""

import jax


def test_entry_and_dryrun():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert float(out[1]) < 10.0  # primres after one iteration is finite/sane
    g.dryrun_multichip(4, devices=jax.devices("cpu"))


def test_dryrun_refuses_too_few_devices():
    """No silent fallback: a dry run over more devices than it is given
    fails instead of running somewhere else."""
    import pytest

    import __graft_entry__ as g

    with pytest.raises(RuntimeError, match="need 4 devices"):
        g.dryrun_multichip(4, devices=jax.devices("cpu")[:2])
