"""Golden one-iteration parity tests against the reference implementation.

The expected vectors are the hard-coded values the reference asserts for one
ADMM iteration on case9 with rho_pq=4e2, rho_va=4e4
(/root/reference/test/algorithms/acopf_update_cpu.jl:28-166). Closed-form
kernels (generator, bus, z, l, lz) must match to ~1e-6; the branch TRON
values are solver-termination-dependent, so they get a slightly looser
tolerance (both solvers stop at projected-gradient 1e-6 on the scaled
objective, which bounds the iterate difference near 1e-5).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from exaadmm_tpu.models.acopf import model as M
from exaadmm_tpu.utils.environment import Parameters
from exaadmm_tpu.utils.opfdata import opf_loaddata

RHO_PQ, RHO_VA = 4e2, 4e4

U_GEN = np.array([[0.1, 0.0], [0.238095, 0.0], [0.161403, 0.0]])
U_BR = np.array([
    [0.0, 0.0, 0.0, 0.0, 1.01, 1.01, 0.0, 0.0],
    [0.0, -0.079790, 0.0, -0.079790, 1.01, 1.01, 0.0, 0.0],
    [0.0, -0.180790, 0.0, -0.180790, 1.01, 1.01, 0.0, 0.0],
    [0.0, 0.0, 0.0, 0.0, 1.01, 1.01, 0.0, 0.0],
    [0.0, -0.105545, 0.0, -0.105545, 1.01, 1.01, 0.0, 0.0],
    [0.0, -0.075245, 0.0, -0.075245, 1.01, 1.01, 0.0, 0.0],
    [0.0, 0.0, 0.0, 0.0, 1.01, 1.01, 0.0, 0.0],
    [0.0, -0.154530, 0.0, -0.154530, 1.01, 1.01, 0.0, 0.0],
    [0.0, -0.088880, 0.0, -0.088880, 1.01, 1.01, 0.0, 0.0],
])
V_GEN = np.array([[0.05, 0.0], [0.119047, 0.0], [0.080701, 0.0]])
V_BR = np.array([
    [0.05, 0.0, 0.0, 0.056223, 1.01, 1.01, 0.0, 0.0],
    [0.0, -0.023566, -0.45, -0.099499, 1.01, 1.01, 0.0, 0.0],
    [-0.45, -0.200500, 0.0, -0.085345, 1.01, 1.01, 0.0, 0.0],
    [0.080701, 0.0, 0.0, 0.095445, 1.01, 1.01, 0.0, 0.0],
    [0.0, -0.010100, -0.5, -0.190150, 1.01, 1.01, 0.0, 0.0],
    [-0.5, -0.159849, 0.0, 0.001346, 1.01, 1.01, 0.0, 0.0],
    [0.0, 0.076591, 0.119047, 0.0, 1.01, 1.01, 0.0, 0.0],
    [0.0, -0.077938, -0.625, -0.282825, 1.01, 1.01, 0.0, 0.0],
    [-0.625, -0.217174, 0.0, -0.032656, 1.01, 1.01, 0.0, 0.0],
])
Z_GEN = np.array([[-0.014285, 0.0], [-0.034013, 0.0], [-0.023057, 0.0]])
Z_BR = np.array([
    [0.014285, 0.0, 0.0, 0.016063, 0.0, 0.0, 0.0, 0.0],
    [0.0, 0.016063, -0.128571, -0.005631, 0.0, 0.0, 0.0, 0.0],
    [-0.128571, -0.005631, 0.0, 0.027270, 0.0, 0.0, 0.0, 0.0],
    [0.023057, 0.0, 0.0, 0.027270, 0.0, 0.0, 0.0, 0.0],
    [0.0, 0.027270, -0.142857, -0.024172, 0.0, 0.0, 0.0, 0.0],
    [-0.142857, -0.024172, 0.0, 0.021883, 0.0, 0.0, 0.0, 0.0],
    [0.0, 0.021883, 0.034013, 0.0, 0.0, 0.0, 0.0, 0.0],
    [0.0, 0.021883, -0.178571, -0.036655, 0.0, 0.0, 0.0, 0.0],
    [-0.178571, -0.036655, 0.0, 0.016063, 0.0, 0.0, 0.0, 0.0],
])
L_GEN = np.array([[14.285714, 0.0], [34.013605, 0.0], [23.057644, 0.0]])
L_BR = np.array([
    [-14.285714, 0.0, 0.0, -16.063809, 0.0, 0.0, 0.0, 0.0],
    [0.0, -16.063809, 128.571428, 5.631428, 0.0, 0.0, 0.0, 0.0],
    [128.571428, 5.631428, 0.0, -27.270000, 0.0, 0.0, 0.0, 0.0],
    [-23.057644, 0.0, 0.0, -27.270000, 0.0, 0.0, 0.0, 0.0],
    [0.0, -27.270000, 142.857142, 24.172856, 0.0, 0.0, 0.0, 0.0],
    [142.857142, 24.172856, 0.0, -21.883333, 0.0, 0.0, 0.0, 0.0],
    [0.0, -21.883333, -34.013605, 0.0, 0.0, 0.0, 0.0, 0.0],
    [0.0, -21.883333, 178.571428, 36.655713, 0.0, 0.0, 0.0, 0.0],
    [178.571428, 36.655713, 0.0, -16.063809, 0.0, 0.0, 0.0, 0.0],
])


@pytest.fixture(scope="module")
def one_iter(case9_path):
    data = opf_loaddata(case9_path, verbose=0)
    par = Parameters(verbose=0, scale=1e-4, initial_beta=1e3, beta=1e3)
    model = M.build_model(data, par)
    sol0 = M.init_solution(model, RHO_PQ, RHO_VA)
    beta = 1e3

    sol = sol0.replace(z_prev=sol0.z)
    sol_x, _ = M.update_x(model, sol, inner_iter=1)
    sol_xbar = M.update_xbar(model, sol_x)
    sol_z = M.update_z(model, sol_xbar, beta)
    sol_l = M.update_l(model, sol_z, beta)
    sol_r, scalars = M.update_residual(model, sol_l, beta)
    sol_lz = M.update_lz(model, sol_r, beta)
    return dict(model=model, sol0=sol0, x=sol_x, xbar=sol_xbar, z=sol_z,
                l=sol_l, r=sol_r, lz=sol_lz, scalars=scalars, beta=beta)


def test_x_update_gen(one_iter):
    np.testing.assert_allclose(np.asarray(one_iter["x"].u.gen), U_GEN, atol=1e-6)


def test_x_update_branch(one_iter):
    np.testing.assert_allclose(np.asarray(one_iter["x"].u.line), U_BR, atol=2e-5)


def test_xbar_update(one_iter):
    np.testing.assert_allclose(np.asarray(one_iter["xbar"].v.gen), V_GEN, atol=5e-5)
    np.testing.assert_allclose(np.asarray(one_iter["xbar"].v.line), V_BR, atol=5e-5)


def test_z_update(one_iter):
    np.testing.assert_allclose(np.asarray(one_iter["z"].z.gen), Z_GEN, atol=5e-5)
    np.testing.assert_allclose(np.asarray(one_iter["z"].z.line), Z_BR, atol=5e-5)


def test_l_update(one_iter):
    np.testing.assert_allclose(np.asarray(one_iter["l"].l.gen), L_GEN, atol=5e-4)
    np.testing.assert_allclose(np.asarray(one_iter["l"].l.line), L_BR, atol=5e-4)


def test_residual_identities(one_iter):
    s = one_iter["r"]
    np.testing.assert_allclose(
        np.asarray(s.rp.gen), np.asarray(s.u.gen - s.v.gen + s.z.gen), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(s.rp.line), np.asarray(s.u.line - s.v.line + s.z.line), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(s.rd.gen), np.asarray(s.z.gen - s.z_prev.gen), atol=1e-12)


def test_lz_update(one_iter):
    s_prev, s = one_iter["r"], one_iter["lz"]
    np.testing.assert_allclose(
        np.asarray(s.lz.gen),
        np.asarray(s_prev.lz.gen + one_iter["beta"] * s_prev.z.gen), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(s.lz.line),
        np.asarray(s_prev.lz.line + one_iter["beta"] * s_prev.z.line), atol=1e-12)


def test_closed_form_kernels_exact_from_golden_u(one_iter):
    """Feed the reference's golden U into the bus kernel: output must match
    the golden V tightly (isolates bus kernel accuracy from branch-solver
    termination differences)."""
    from exaadmm_tpu.models.acopf import kernels
    from exaadmm_tpu.utils.environment import Blocks

    model = one_iter["model"]
    sol0 = one_iter["sol0"]
    u_gold = Blocks(gen=jnp.asarray(U_GEN), line=jnp.asarray(U_BR))
    v = kernels.bus_update(u_gold, sol0.z, sol0.l, sol0.rho, model.grid)
    np.testing.assert_allclose(np.asarray(v.gen), V_GEN, atol=2e-6)
    np.testing.assert_allclose(np.asarray(v.line), V_BR, atol=2e-6)


def test_kr_windowed_scatter_matches_segsum():
    """Windowed KR scatter (large-grid bus backend) is fp32-exact against
    segment_sum, including the padded-arc tail and slot-boundary combine."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from exaadmm_tpu.models.acopf.kernels import (build_kr_window_setup,
                                                  kr_scatter_windowed)

    rng = np.random.default_rng(11)
    N, NBUS = 7321, 4999  # deliberately non-multiples of the tile/slot sizes
    fr = rng.integers(0, NBUS, N).astype(np.int32)
    to = rng.integers(0, NBUS, N).astype(np.int32)
    setup = build_kr_window_setup(fr, to, NBUS)
    assert setup is not None
    vf = jnp.asarray(rng.standard_normal((N, 8)) * 1e3, jnp.float32)
    vt = jnp.asarray(rng.standard_normal((N, 8)) * 1e3, jnp.float32)

    got = np.asarray(jax.jit(
        lambda a, b: kr_scatter_windowed(a, b, setup, NBUS))(vf, vt))
    ref = np.zeros((NBUS, 8))
    np.add.at(ref, fr, np.asarray(vf, np.float64))
    np.add.at(ref, to, np.asarray(vt, np.float64))
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel < 1e-6


def test_kr_windowed_scatter_wide_window():
    """Sparse arcs over many buses force the window past 2*S (W doubles to
    2048 here); the multi-chunk slot combine must stay exact (advisor r4:
    the 2-half combine crashed at trace time for W != 2*S)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from exaadmm_tpu.models.acopf.kernels import (build_kr_window_setup,
                                                  kr_scatter_windowed)

    rng = np.random.default_rng(7)
    N, NBUS = 4000, 11000
    fr = rng.integers(0, NBUS, N).astype(np.int32)
    to = rng.integers(0, NBUS, N).astype(np.int32)
    setup = build_kr_window_setup(fr, to, NBUS)
    assert setup is not None and setup["W"] > 2 * setup["S"]
    vf = jnp.asarray(rng.standard_normal((N, 8)) * 1e3, jnp.float32)
    vt = jnp.asarray(rng.standard_normal((N, 8)) * 1e3, jnp.float32)

    got = np.asarray(jax.jit(
        lambda a, b: kr_scatter_windowed(a, b, setup, NBUS))(vf, vt))
    ref = np.zeros((NBUS, 8))
    np.add.at(ref, fr, np.asarray(vf, np.float64))
    np.add.at(ref, to, np.asarray(vt, np.float64))
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel < 1e-6
