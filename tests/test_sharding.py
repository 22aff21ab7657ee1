"""Multi-device partition tests on a virtual 8-device CPU mesh.

The missing layer of the reference's test suite (its MPI path is untested,
SURVEY.md §4): sharded line partition + psum-coupled bus/residual updates
must reproduce the single-device solve.
"""

import jax
import numpy as np
import pytest

from exaadmm_tpu import solve_acopf
from exaadmm_tpu.parallel.sharding import make_mesh


@pytest.fixture(scope="module")
def cpu_mesh():
    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs >=2 devices")
    return make_mesh(devices=devs[:8])


def test_case9_sharded_matches_single(case9_path, cpu_mesh):
    kw = dict(rho_pq=4e2, rho_va=4e4, outer_eps=2e-5, outer_iterlim=6, verbose=0)
    res1 = solve_acopf(case9_path, **kw)
    resN = solve_acopf(case9_path, mesh=cpu_mesh, **kw)
    assert resN.info.cumul == res1.info.cumul
    assert resN.info.objval == pytest.approx(res1.info.objval, rel=1e-8)
    assert resN.info.primres == pytest.approx(res1.info.primres, rel=1e-6)
    np.testing.assert_allclose(
        np.asarray(resN.solution.u.gen), np.asarray(res1.solution.u.gen),
        atol=1e-8,
    )
    # line block: padded lanes differ (8-dev pad vs none); compare real lines
    np.testing.assert_allclose(
        np.asarray(resN.solution.u.line)[:9], np.asarray(res1.solution.u.line),
        atol=1e-6,
    )


def test_case9_sharded_full_solve(case9_path, cpu_mesh):
    res = solve_acopf(case9_path, mesh=cpu_mesh, rho_pq=4e2, rho_va=4e4,
                      outer_eps=2e-5, outer_iterlim=25, verbose=0)
    assert res.info.status == "Solved"
    assert 5296.0 <= res.info.objval <= 5304.5


def test_mpacopf_sharded_matches_single(case9_path, cpu_mesh):
    """Sharded mpacopf inner loop reproduces the single-device solve."""
    import os
    import jax.numpy as jnp
    from exaadmm_tpu.models.mpacopf import model as mp_M
    from exaadmm_tpu.utils.environment import Parameters, IterationInformation
    from exaadmm_tpu.utils.opfdata import load_time_series, opf_loaddata
    from exaadmm_tpu.algorithms.admm_two_level import admm_two_level
    from exaadmm_tpu.parallel.sharding import make_sharded_inner_loop
    from exaadmm_tpu.utils.grid_data import build_grid_data
    import dataclasses

    data = opf_loaddata(case9_path, verbose=0)
    prefix = os.path.join(os.path.dirname(case9_path), "case9_demand")
    pd_mat, qd_mat = load_time_series(prefix)

    def build(pad):
        par = Parameters(verbose=0, outer_iterlim=4, outer_eps=2e-4)
        m = mp_M.build_model(data, par, pd_mat, qd_mat,
                             start_period=1, end_period=3)
        if pad > 1:
            gd = build_grid_data(data, pad_lines_to=pad)
            m = dataclasses.replace(m, grid=gd, grid_T=None)
        return m

    m1 = build(1)
    s1 = mp_M.init_solution(m1, 4e2, 4e4)
    s1, i1 = admm_two_level(m1, s1, IterationInformation())

    ndev = len(cpu_mesh.devices.flat)
    mN = build(ndev)
    sN = mp_M.init_solution(mN, 4e2, 4e4)
    run = make_sharded_inner_loop(mN, cpu_mesh, mN.par.inner_iterlim)
    sN, iN = admm_two_level(mN, sN, IterationInformation(), run_inner=run)

    assert iN.cumul == i1.cumul
    assert iN.objval == pytest.approx(i1.objval, rel=1e-6)
    np.testing.assert_allclose(np.asarray(sN.acopf.u.gen),
                               np.asarray(s1.acopf.u.gen), atol=1e-7)


def test_mpacopf_fused_sharded(case9_path, cpu_mesh):
    """Whole mpacopf solve as ONE sharded dispatch (make_sharded_fused_solver
    driving ModelMpacopf) — VERDICT r2 next-step #6."""
    import os
    import dataclasses
    from exaadmm_tpu.algorithms.admm_two_level import (admm_two_level_fused)
    from exaadmm_tpu.models.mpacopf import model as mp_M
    from exaadmm_tpu.parallel.sharding import make_sharded_fused_solver
    from exaadmm_tpu.utils.environment import IterationInformation, Parameters
    from exaadmm_tpu.utils.grid_data import build_grid_data
    from exaadmm_tpu.utils.opfdata import load_time_series, opf_loaddata

    data = opf_loaddata(case9_path, verbose=0)
    prefix = os.path.join(os.path.dirname(case9_path), "case9_demand")
    pd_mat, qd_mat = load_time_series(prefix)

    def build(pad):
        par = Parameters(verbose=0, outer_iterlim=6, outer_eps=2e-4)
        m = mp_M.build_model(data, par, pd_mat, qd_mat,
                             start_period=1, end_period=3)
        if pad > 1:
            gd = build_grid_data(data, pad_lines_to=pad)
            m = dataclasses.replace(m, grid=gd, grid_T=None)
        return m

    m1 = build(1)
    s1 = mp_M.init_solution(m1, 4e2, 4e4)
    s1, i1 = admm_two_level_fused(m1, s1, IterationInformation())

    ndev = len(cpu_mesh.devices.flat)
    mN = build(ndev)
    sN = mp_M.init_solution(mN, 4e2, 4e4)
    run = make_sharded_fused_solver(mN, cpu_mesh)
    sN, iN = admm_two_level_fused(mN, sN, IterationInformation(), run=run)

    assert iN.cumul == i1.cumul
    assert iN.outer == i1.outer
    assert iN.objval == pytest.approx(i1.objval, rel=1e-6)
    np.testing.assert_allclose(np.asarray(sN.acopf.u.gen),
                               np.asarray(s1.acopf.u.gen), atol=1e-7)


def test_sharded_fused_solve_kr_bus_backend(case9_path):
    """The KR-matmul bus scatter composes with the shard_map line partition:
    per-shard KR aggregates + one psum give the same solve as segsum."""
    import jax.numpy as jnp
    from exaadmm_tpu.algorithms.admm_two_level import admm_two_level_fused
    from exaadmm_tpu.models.acopf import model as M
    from exaadmm_tpu.parallel.sharding import make_mesh, make_sharded_fused_solver
    from exaadmm_tpu.utils.environment import IterationInformation, Parameters
    from exaadmm_tpu.utils.opfdata import opf_loaddata

    data = opf_loaddata(case9_path, verbose=0)
    results = {}
    for bb in ("segsum", "kr"):
        par = Parameters(verbose=0, outer_iterlim=12, outer_eps=2e-4,
                         scale=1e-4, bus_backend=bb)
        model = M.build_model(data, par, pad_lines_to=8, dtype=jnp.float32)
        sol = M.init_solution(model, 4e2, 4e4)
        mesh = make_mesh(8)
        run = make_sharded_fused_solver(model, mesh)
        sol, info = admm_two_level_fused(model, sol, IterationInformation(),
                                         run=run)
        results[bb] = info
    a, b = results["segsum"], results["kr"]
    assert a.outer == b.outer
    # fp32 reduction orders differ between backends; trajectories must stay
    # in lockstep at the iteration level and land on the same objective
    assert abs(a.cumul - b.cumul) <= 0.02 * a.cumul + 2
    assert abs(a.objval - b.objval) <= 1e-3 * abs(a.objval)


def test_bus_backend_auto_resolution():
    """auto: exact segment_sum (the H100 A/B at synth-9241 fp32: segsum
    3995.6 vs kr_win 3431.9 steady-state it/s, chip_smoke phase d);
    explicit backends pass through."""
    from exaadmm_tpu.models.acopf.model import resolve_bus_backend
    from exaadmm_tpu.utils.environment import Parameters

    assert resolve_bus_backend(Parameters()) == "segsum"
    for bb in ("segsum", "kr", "kr_win"):
        assert resolve_bus_backend(Parameters(bus_backend=bb)) == bb


def test_auto_bus_backend_builds_no_window_setup(case9_path):
    """Only an explicit kr_win model pays for the static windowed-KR setup
    at build; auto (segsum) and dense kr do not."""
    import jax.numpy as jnp
    from exaadmm_tpu.models.acopf import model as M
    from exaadmm_tpu.utils.environment import Parameters
    from exaadmm_tpu.utils.opfdata import opf_loaddata

    data = opf_loaddata(case9_path, verbose=0)
    for bb, expect in (("auto", False), ("kr", False), ("kr_win", True)):
        model = M.build_model(data, Parameters(verbose=0, bus_backend=bb),
                              dtype=jnp.float32)
        has = getattr(model, "_kr_win_setup", None) is not None
        assert has == expect, bb


def test_auto_kr_win_full_solve_matches_segsum(case9_path):
    """The windowed-KR bus backend (auto's choice before the H100 A/B)
    reproduces the segsum trajectory on a full fp32 fused solve (lockstep
    iteration counts, same objective)."""
    import jax.numpy as jnp
    from exaadmm_tpu.algorithms.admm_two_level import admm_two_level_fused
    from exaadmm_tpu.models.acopf import model as M
    from exaadmm_tpu.utils.environment import IterationInformation, Parameters
    from exaadmm_tpu.utils.opfdata import opf_loaddata

    data = opf_loaddata(case9_path, verbose=0)
    results = {}
    for bb in ("segsum", "kr_win"):
        par = Parameters(verbose=0, outer_iterlim=12, outer_eps=2e-4,
                         scale=1e-4, bus_backend=bb)
        model = M.build_model(data, par, dtype=jnp.float32)
        if bb == "kr_win":
            assert getattr(model, "_kr_win_setup", None) is not None
        sol = M.init_solution(model, 4e2, 4e4)
        sol, info = admm_two_level_fused(model, sol, IterationInformation())
        results[bb] = info
    a, b = results["segsum"], results["kr_win"]
    assert abs(a.cumul - b.cumul) <= 0.02 * a.cumul + 2
    assert abs(a.objval - b.objval) <= 1e-3 * abs(a.objval)


def test_sort_lines_with_auto_kr_win(case9_path):
    """sort_lines permutes the line batch per outer round, which invalidates
    the static windowed-KR arc order; the sorted path must fall back to a
    permutation-safe backend (the sorted local model drops _kr_win_setup,
    update_xbar then uses dense kr) and still reproduce the unsorted solve."""
    import jax.numpy as jnp
    from exaadmm_tpu.algorithms.admm_two_level import admm_two_level_fused
    from exaadmm_tpu.models.acopf import model as M
    from exaadmm_tpu.utils.environment import IterationInformation, Parameters
    from exaadmm_tpu.utils.opfdata import opf_loaddata

    data = opf_loaddata(case9_path, verbose=0)
    results = {}
    for sort in (False, True):
        par = Parameters(verbose=0, outer_iterlim=12, outer_eps=2e-4,
                         scale=1e-4, bus_backend="kr_win", sort_lines=sort)
        model = M.build_model(data, par, dtype=jnp.float32)
        sol = M.init_solution(model, 4e2, 4e4)
        sol, info = admm_two_level_fused(model, sol, IterationInformation())
        results[sort] = info
    a, b = results[False], results[True]
    assert abs(a.cumul - b.cumul) <= 0.05 * a.cumul + 3
    assert abs(a.objval - b.objval) <= 1e-3 * abs(a.objval)
