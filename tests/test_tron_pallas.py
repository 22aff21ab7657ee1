"""The fused TRON/ALM GPU kernel (ops/tron_pallas.py) on the CPU.

The compiled kernel needs a GPU (tests/test_gpu_device.py); here the same
kernel runs in Pallas interpret mode against the XLA path, each call site is
lowered for CUDA (which produces the Triton IR without a card — how a
lowering fault such as an unsupported primitive shows up here), and the
wrapper's padding, shapes and backend choice are checked.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exaadmm_tpu.models.acopf import model as M
from exaadmm_tpu.models.acopf.branch import (
    _branch_params, _warm_start_x0, branch_alm_delta, branch_cons_linelimit,
    branch_fgh_linelimit, branch_obj_linelimit)
from exaadmm_tpu.ops.tron import tron_alm_batched, tron_batched
from exaadmm_tpu.ops.tron_pallas import (
    select_tron_solver, tron_alm_batched_pallas)
from exaadmm_tpu.utils.environment import Parameters
from exaadmm_tpu.utils.opfdata import opf_loaddata


def test_pallas_matches_xla_interpret(case9_path):
    data = opf_loaddata(case9_path, verbose=0)
    par = Parameters(verbose=0)
    model = M.build_model(data, par, dtype=jnp.float32)
    sol = M.init_solution(model, 4e2, 4e4)
    params = _branch_params(sol, model.grid, par)
    x0, xl, xu = _warm_start_x0(sol.u.line, model.grid, True)
    alm = sol.branch_alm
    lam0 = jnp.stack([alm.lam1, alm.lam2])
    eps = float(jnp.finfo(jnp.float32).eps)
    kw = dict(gtol=40 * eps, frtol=10 * eps, ctol=300 * eps,
              max_minor=200, max_auglag=50, fgh_fn=branch_fgh_linelimit,
              alm_delta_fn=branch_alm_delta)

    r1 = tron_alm_batched(branch_obj_linelimit, branch_cons_linelimit,
                          x0, xl, xu, params, lam0, alm.mu, **kw)
    # 9 lanes in tiles of 4: the last tile carries 3 padded lanes
    r2 = tron_alm_batched_pallas(branch_obj_linelimit, branch_cons_linelimit,
                                 x0, xl, xu, params, lam0, alm.mu,
                                 tile=4, interpret=True, **kw)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r2.x), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(r1.minor_iters),
                                  np.asarray(r2.minor_iters))


def test_pallas_wrapper_padding_and_shapes():
    """A lane count that is not a multiple of the tile, an inactive lane,
    nested parameter leaves and no constraints (plain TRON, autodiff
    derivatives): the kernel pads to whole tiles, returns unpadded
    results of the XLA path's shapes, and leaves inactive lanes alone."""
    rng = np.random.default_rng(0)
    n, B = 3, 13
    A = jnp.asarray(rng.uniform(1.0, 3.0, (n, n, B)), jnp.float32)
    A = 0.5 * (A + jnp.transpose(A, (1, 0, 2))) + 4.0 * jnp.eye(
        n, dtype=jnp.float32)[:, :, None]
    b = jnp.asarray(rng.standard_normal((n, B)), jnp.float32)
    params = {"A": A, "b": b}

    def obj(x, p):
        Ax = [sum(p["A"][i][j] * x[j] for j in range(n)) for i in range(n)]
        return sum(0.5 * x[i] * Ax[i] - p["b"][i] * x[i] for i in range(n))

    x0 = jnp.zeros((n, B), jnp.float32)
    xl = jnp.full((n, B), -0.2, jnp.float32)
    xu = jnp.full((n, B), 0.3, jnp.float32)
    active = jnp.arange(B) != 5

    ref = tron_batched(obj, x0, xl, xu, params, gtol=1e-5, active0=active)

    def obj_alm(x, p, lam, mu):
        return obj(x, p)

    lam0 = jnp.zeros((0, B), jnp.float32)
    mu0 = jnp.full((B,), 10.0, jnp.float32)
    got = tron_alm_batched_pallas(
        obj_alm, lambda x, p: (), x0, xl, xu, params, lam0, mu0,
        tile=8, interpret=True, gtol=1e-5, max_auglag=1, active0=active)

    assert got.x.shape == ref.x.shape == (n, B)
    assert got.lam.shape == ref.lam.shape == (0, B)
    for f in ("mu", "minor_iters", "alm_iters", "cviol"):
        assert getattr(got, f).shape == (B,), f
    assert got.minor_iters.dtype == jnp.int32
    np.testing.assert_allclose(np.asarray(got.x), np.asarray(ref.x),
                               atol=1e-6)
    np.testing.assert_array_equal(np.asarray(got.minor_iters),
                                  np.asarray(ref.minor_iters))
    assert int(got.minor_iters[5]) == 0
    np.testing.assert_array_equal(np.asarray(got.x[:, 5]), 0.0)
    with pytest.raises(ValueError, match="power of two"):
        tron_alm_batched_pallas(obj_alm, lambda x, p: (), x0, xl, xu,
                                params, lam0, mu0, tile=12, interpret=True)
    with pytest.raises(ValueError, match="fp32-only"):
        tron_alm_batched_pallas(obj_alm, lambda x, p: (),
                                x0.astype(jnp.float64), xl, xu, params, lam0,
                                mu0, interpret=True)


def test_select_tron_solver(monkeypatch):
    """"auto" picks the kernel for fp32 batches on a GPU and XLA otherwise;
    "xla" always takes XLA; other names are refused."""
    def pick(backend, dtype):
        solver, extra = select_tron_solver(
            Parameters(branch_backend=backend, pallas_tile=64), dtype)
        return solver, extra

    assert pick("auto", jnp.float32) == (tron_alm_batched, {})
    assert pick("xla", jnp.float32) == (tron_alm_batched, {})
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert pick("auto", jnp.float32) == (tron_alm_batched_pallas,
                                         {"tile": 64})
    assert pick("auto", jnp.float64) == (tron_alm_batched, {})
    assert pick("xla", jnp.float32) == (tron_alm_batched, {})
    for name in ("pallas", "mosaic"):
        with pytest.raises(ValueError, match="branch_backend"):
            pick(name, jnp.float32)


def _acopf_site():
    from exaadmm_tpu.models.acopf.branch import branch_update
    from exaadmm_tpu.utils.synthetic import synthetic_case

    par = Parameters(verbose=0, tron_step_cap=12)
    model = M.build_model(synthetic_case(60, seed=1), par, dtype=jnp.float32)
    sol = M.init_solution(model, 3e3, 3e5)
    return (lambda s: branch_update(s, model.grid, par,
                                    jnp.asarray(2, jnp.int32))), sol


def _mpacopf_site():
    from exaadmm_tpu.models.mpacopf import model as mp_M
    from exaadmm_tpu.utils.synthetic import synthetic_case

    data = synthetic_case(60, seed=1)
    T = 3
    pd_mat = np.outer(np.asarray(data.Pd), np.ones(T))
    qd_mat = np.outer(np.asarray(data.Qd), np.ones(T))
    par = Parameters(verbose=0, tron_step_cap=12)
    model = mp_M.build_model(data, par, pd_mat, qd_mat, start_period=1,
                             end_period=T, dtype=jnp.float32)
    sol = mp_M.init_solution(model, 3e3, 3e5)
    return (lambda s: model._ramp_alm_update(s, jnp.asarray(2, jnp.int32))
            ), sol


def _qpsub_site(case9_path):
    from exaadmm_tpu.models.qpsub import model as Q
    from exaadmm_tpu.models.qpsub.sqp import SqpBasePoint, build_qp_inputs
    from exaadmm_tpu.utils.grid_data import build_grid_data

    data = opf_loaddata(case9_path, verbose=0)
    base = SqpBasePoint.from_power_flow(data)
    qp = build_qp_inputs(data, build_grid_data(data), base)
    par = Parameters(verbose=0, tron_step_cap=12)
    model = Q.build_model(data, par, qp, dtype=jnp.float32)
    sol = Q.init_solution(model, 4e3, 4e3)
    model = model.solve_prep(sol)
    return (lambda s: model.update_x(s, jnp.asarray(2, jnp.int32))), sol


@pytest.mark.parametrize("site", ["acopf", "mpacopf", "qpsub"])
def test_kernel_call_sites_lower_for_cuda(site, case9_path, monkeypatch):
    """Every model call site of the fused kernel lowers for CUDA: the
    Triton lowering accepts the traced state machine (a primitive it lacks,
    such as a slice or a boolean reduction, fails here). The call sites
    are traced as on a GPU host, where "auto" picks the kernel."""
    fn, sol = {"acopf": _acopf_site, "mpacopf": _mpacopf_site,
               "qpsub": lambda: _qpsub_site(case9_path)}[site]()
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    lowered = jax.jit(fn).trace(sol).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "tron_alm" in text
    assert text.count("__gpu$xla.gpu.triton") >= 1


def test_closed_form_fgh_matches_autodiff():
    """branch_fgh_linelimit (hand-derived f/grad/Hessian) vs autodiff on
    random data, fp64."""
    rng = np.random.default_rng(7)
    B = 64
    p = {k: jnp.asarray(rng.normal(0, 2, B)) for k in
         ("YffR", "YffI", "YftR", "YftI", "YttR", "YttI", "YtfR", "YtfI")}
    p["l"] = jnp.asarray(rng.normal(0, 50, (8, B)))
    p["rho"] = jnp.asarray(rng.uniform(1, 4e4, (8, B)))
    p["t"] = jnp.asarray(rng.normal(0, 1, (8, B)))
    p["scale"] = jnp.asarray(rng.uniform(1e-5, 1e-3, B))
    x = jnp.asarray(np.concatenate([rng.uniform(0.9, 1.1, (2, B)),
                                    rng.uniform(-0.5, 0.5, (2, B)),
                                    rng.uniform(-5, 0, (2, B))]))
    lam = jnp.asarray(rng.normal(0, 10, (2, B)))
    mu = jnp.asarray(rng.uniform(1, 1e6, B))

    f, g, H = branch_fgh_linelimit(x, p, lam, mu)
    f_ad = branch_obj_linelimit(x, p, lam, mu)
    grad_fn = jax.grad(lambda X: jnp.sum(branch_obj_linelimit(X, p, lam, mu)))
    g_ad = grad_fn(x)
    np.testing.assert_allclose(np.asarray(f), np.asarray(f_ad), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ad),
                               rtol=1e-8, atol=1e-8)
    for j in range(6):
        tang = jnp.zeros_like(x).at[j].set(1.0)
        _, hj = jax.jvp(grad_fn, (x,), (tang,))
        for i in range(6):
            np.testing.assert_allclose(
                np.asarray(H[i][j]), np.asarray(hj[i]),
                rtol=1e-7, atol=1e-7 * float(jnp.max(jnp.abs(hj[i])) + 1))
