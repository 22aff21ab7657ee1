"""GPU tests in the production configuration: fp32, the fused TRON kernel,
two-pass straggler compaction.

These are the hardware-gated tests the reference runs when
``CUDA.functional()`` is true (ExaAdmm.jl's test/runtests.jl:23). They
are marked ``gpu`` and skip where JAX's first device is not a GPU; run them
on the card (one process) with

    EXAADMM_TEST_PLATFORM=gpu python -m pytest -m gpu tests/test_gpu_device.py
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu

CASE9 = os.path.join(os.path.dirname(__file__), "..", "data", "case9.m")


@pytest.fixture(autouse=True)
def _needs_gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (EXAADMM_TEST_PLATFORM=gpu)")


@pytest.fixture(scope="module")
def synth300():
    from exaadmm_tpu.utils.synthetic import synthetic_case
    return synthetic_case(300, seed=3)


def _branch_inputs(data, *, backend, two_pass, tile=32):
    from exaadmm_tpu.models.acopf import model as M
    from exaadmm_tpu.utils.environment import Parameters

    par = Parameters(verbose=0, tron_step_cap=24, branch_backend=backend,
                     pallas_tile=tile, branch_two_pass=two_pass,
                     branch_pass1_cap=2, scale=1e-4)
    model = M.build_model(data, par, dtype=jnp.float32)
    sol = M.init_solution(model, 400.0, 40000.0)
    # perturb prox targets so lanes have a spread of difficulties
    rng = np.random.default_rng(0)
    v_line = sol.v.line + jnp.asarray(
        rng.normal(0, 0.05, sol.v.line.shape), jnp.float32)
    sol = sol.replace(v=sol.v.replace(line=v_line))
    return model, sol, par


def test_tron_kernel_matches_xla_on_device(synth300):
    """The compiled kernel and the XLA while-loop path run the same lockstep
    state machine (tests/test_tron_pallas.py checks it in interpret mode).
    On the card the two compilers round fp32 differently, which can flip
    data-dependent TRON branch decisions on a small fraction of lanes — so
    this bounds the trajectory-divergence rate and checks agreement of the
    solutions, not bit identity. Under the lockstep cap of 24 steps a lane
    cut off mid-solve stops wherever its trajectory was; with no effective
    cap (2000 steps) every lane finishes and all lanes must agree."""
    from exaadmm_tpu.models.acopf.branch import branch_update

    model, sol, par = _branch_inputs(synth300, backend="auto",
                                     two_pass=False)
    inner = jnp.asarray(2, jnp.int32)
    nl = model.grid.nline
    out = {}
    for cap in (24, 2000):
        for backend in ("auto", "xla"):
            p = dataclasses.replace(par, tron_step_cap=cap,
                                    branch_backend=backend)
            u, alm, st = branch_update(sol, model.grid, p, inner)
            out[cap, backend] = (np.asarray(u)[:nl],
                                 np.asarray(alm.lam1)[:nl],
                                 np.asarray(st["lane_steps"])[:nl],
                                 float(st["max_cviol"]))

    u_p, lam_p, steps_p, cv_p = out[24, "auto"]
    u_x, lam_x, steps_x, cv_x = out[24, "xla"]
    assert np.mean(steps_p != steps_x) < 0.10
    same = steps_p == steps_x
    np.testing.assert_allclose(u_p[same], u_x[same], rtol=0, atol=1e-3)
    # every lane that finished within the cap in both paths (the same step
    # count as uncapped) lands on the same subproblem solution
    done = (steps_p == out[2000, "auto"][2]) & (
        steps_x == out[2000, "xla"][2])
    np.testing.assert_allclose(u_p[done], u_x[done], rtol=0, atol=5e-3)
    # the ALM multiplier is path-dependent: compare same-trajectory lanes
    np.testing.assert_allclose(lam_p[same], lam_x[same],
                               rtol=1e-1, atol=5e-2)
    assert cv_p < 0.1 and cv_x < 0.1
    assert abs(cv_p - cv_x) <= 0.05 * max(cv_p, cv_x) + 1e-5
    # no effective cap: all lanes, all eight columns of u
    np.testing.assert_allclose(out[2000, "auto"][0], out[2000, "xla"][0],
                               rtol=0, atol=5e-3)


def test_two_pass_lane_identity_on_device():
    """Two-pass compaction is lane-exact with the kernel — the on-device
    counterpart of tests/test_branch_two_pass.py."""
    from exaadmm_tpu.models.acopf.branch import branch_update
    from exaadmm_tpu.utils.synthetic import synthetic_case

    model, sol, par = _branch_inputs(synthetic_case(400, seed=3),
                                     backend="auto", two_pass=True,
                                     tile=32)
    par = dataclasses.replace(par, branch_tail_lanes=128, branch_pass1_cap=6)
    assert model.grid.nline_padded >= 4 * par.branch_tail_lanes
    inner = jnp.asarray(2, jnp.int32)
    u2, alm2, st2 = branch_update(sol, model.grid, par, inner)
    par1 = dataclasses.replace(par, branch_two_pass=False)
    u1, alm1, st1 = branch_update(sol, model.grid, par1, inner)

    assert int(st2["tail_overflow"]) == 0
    np.testing.assert_array_equal(np.asarray(st1["lane_steps"]),
                                  np.asarray(st2["lane_steps"]))
    np.testing.assert_allclose(np.asarray(u1), np.asarray(u2),
                               rtol=0, atol=2e-6)


def test_case9_converges_fp32_production():
    from exaadmm_tpu import solve_acopf

    # fp32 residual floor sits above the fp64 outer_eps=2e-5 band; 2e-4 is
    # the fp32 production tolerance
    res = solve_acopf(CASE9, rho_pq=4e2, rho_va=4e4, outer_eps=2e-4,
                      outer_iterlim=25, verbose=0, dtype=jnp.float32,
                      branch_backend="auto")
    assert res.info.status == "Solved"
    # fp64 CPU at the same eps stops at 5286.65 (tests/test_parser.py pglib
    # run); the band covers the eps=2e-4..2e-5 iterate range up to the optimum
    assert 5280.0 <= res.info.objval <= 5305.0
    assert res.info.mismatch <= np.sqrt(2 * res.model.grid.ngen
                                        + 8 * res.model.grid.nline) * 2e-4


def test_synth300_converges_fp32_production(synth300):
    from exaadmm_tpu.algorithms.admm_two_level import admm_two_level_fused
    from exaadmm_tpu.models.acopf import model as M
    from exaadmm_tpu.utils.environment import Parameters

    par = Parameters(verbose=0, tron_step_cap=24, branch_backend="auto",
                     outer_iterlim=20, outer_eps=2e-4, scale=1e-4)
    model = M.build_model(synth300, par, dtype=jnp.float32)
    sol = M.init_solution(model, 400.0, 40000.0)
    sol, info = admm_two_level_fused(model, sol)
    assert info.status == "Solved"
    assert info.mismatch <= np.sqrt(2 * model.grid.ngen
                                    + 8 * model.grid.nline) * par.outer_eps


def test_kr_scatter_precision_survives_jit_on_device():
    """The bf16 three-term split of kernels.kr_scatter must survive the GPU
    compiler's simplifier: under jit an excess-precision pass may treat
    f32->bf16->f32 round-trips as value-preserving and cancel the split
    residuals (`D - f32(bf16(D))` -> 0), silently degrading the scatter to
    one bf16 pass while eager checks stay clean. The optimization_barrier in
    kernels.kr_scatter pins the split."""
    from exaadmm_tpu.models.acopf.kernels import kr_scatter

    rng = np.random.default_rng(3)
    N, NBUS = 4096, 900
    vals = jnp.asarray(rng.standard_normal((N, 8)) * 1e4, jnp.float32)
    ids = jnp.asarray(rng.integers(0, NBUS, N), jnp.int32)
    got = np.asarray(jax.jit(lambda v: kr_scatter(v, ids, NBUS))(vals))
    ref = np.zeros((NBUS, 8))
    np.add.at(ref, np.asarray(ids), np.asarray(vals, np.float64))
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel < 1e-6, f"KR scatter precision degraded under jit: {rel:.2e}"


def test_mixed_precision_kernel_on_device():
    """fp64 solve with the fp32 kernel branch batch (Parameters.
    mixed_precision) compiles and converges on the card with x64 on, in
    this process (a second process could not open the card)."""
    from exaadmm_tpu.algorithms.admm_two_level import admm_two_level_fused
    from exaadmm_tpu.models.acopf import model as M
    from exaadmm_tpu.utils.environment import IterationInformation, Parameters
    from exaadmm_tpu.utils.synthetic import synthetic_case

    with jax.enable_x64(True):
        data = synthetic_case(300, seed=3)
        par = Parameters(verbose=0, tron_step_cap=12,
                         branch_backend="auto", scale=1e-4,
                         outer_iterlim=30, outer_eps=2e-4,
                         mixed_precision=True)
        model = M.build_model(data, par, dtype=jnp.float64)
        sol = M.init_solution(model, 3e3, 3e5)
        sol, info = admm_two_level_fused(model, sol, IterationInformation())
        assert sol.u.line.dtype == jnp.float64
    assert info.status == "Solved", (info.status, info.mismatch)


def test_mpacopf_fused_fp32_on_device():
    """Multi-period solve in the fp32 production config on the card: the
    ramp-generator ALM batch ((T-1)*ngen 3-var lanes) runs through the
    kernel inside the fused whole-solve dispatch."""
    from exaadmm_tpu.algorithms.admm_two_level import admm_two_level_fused
    from exaadmm_tpu.models.mpacopf import model as mp_M
    from exaadmm_tpu.utils.environment import IterationInformation, Parameters
    from exaadmm_tpu.utils.synthetic import synthetic_case

    data = synthetic_case(300, seed=3)
    T = 3
    rng = np.random.default_rng(1)
    profile = 1.0 + 0.03 * rng.standard_normal(T)
    pd_mat = np.outer(np.asarray(data.Pd), profile)
    qd_mat = np.outer(np.asarray(data.Qd), profile)
    par = Parameters(verbose=0, tron_step_cap=12, branch_backend="auto",
                     scale=1e-4, outer_iterlim=30, outer_eps=2e-4)
    model = mp_M.build_model(data, par, pd_mat, qd_mat,
                             start_period=1, end_period=T, dtype=jnp.float32)
    sol = mp_M.init_solution(model, 3e3, 3e5)
    sol, info = admm_two_level_fused(model, sol, IterationInformation())
    assert info.status == "Solved", (info.status, info.mismatch)
    assert mp_M.check_ramp_violations(model, sol) <= 1e-2


def test_qpsub_fused_fp32_on_device():
    """One-level qpsub solve in the fp32 production config on the card: the
    solve-constant QP cache (solve_prep hook) composed with the kernel's
    reduced-QP batch, on the reference's own case9 QP (fp64 parity lands
    5107 iters / obj -21.92744641968529; fp32 meets its looser tolerance
    earlier along the trajectory)."""
    from exaadmm_tpu.interface.solve_qpsub import solve_qpsub
    from tests.test_qpsub import qp_inputs as _fixture

    qp = _fixture.__wrapped__(CASE9)
    res = solve_qpsub(
        CASE9,
        qp["Hs"], qp["LH_1h"], qp["RH_1h"],
        qp["LH_1i"], qp["RH_1i"],
        qp["LH_1j"], qp["RH_1j"],
        qp["LH_1k"], qp["RH_1k"],
        qp["ls"], qp["us"],
        qp["pgmax"], qp["pgmin"], qp["qgmax"], qp["qgmin"],
        qp["c1"], qp["c2"], qp["Pd"], qp["Qd"],
        1e5,
        outer_iterlim=20000, inner_iterlim=1, scale=1e-4, obj_scale=1.0,
        rho_pq=4000.0, rho_va=4000.0, verbose=0, outer_eps=2e-5,
        onelevel=True, dtype=jnp.float32, branch_backend="auto",
    )
    assert res.info.status == "Solved", (res.info.status, res.info.mismatch)
    assert -30.0 < res.info.objval < -5.0
