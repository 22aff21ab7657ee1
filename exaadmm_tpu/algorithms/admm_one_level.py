"""Classic one-level ADMM driver (used by the qpsub model).

Reference: ``/root/reference/src/algorithms/admm_one_level.jl``: the two-level
machinery is disabled (z = lz = 0, beta = 0, one inner iteration per outer),
each iteration runs x -> xbar -> l += rho (u - v) -> residual, and the solve
terminates when

    ||u - v|| <= sqrt(d) outer_eps   and   dualres <= outer_eps ||rho||

(admm_one_level.jl:65, with dualres = rho*(v - v_prev), Boyd's single-level
dual residual). Unlike the reference's per-iteration host loop with norm
readbacks, the WHOLE solve runs as one jitted ``lax.while_loop`` — qpsub
solves take thousands of cheap iterations (the reference regression does
5107), so staying on device matters more here than anywhere else.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.environment import IterationInformation
from ..utils.pytree import pytree_dataclass


@pytree_dataclass
class OneLevelCarry:
    sol: object
    it: jnp.ndarray
    primres: jnp.ndarray
    dualres: jnp.ndarray
    mismatch: jnp.ndarray
    objval: jnp.ndarray
    auglag: jnp.ndarray


def _one_iteration(model, c: OneLevelCarry, axis_name=None) -> OneLevelCarry:
    s = c.sol
    it = c.it + 1
    s, _ = model.update_x(s, it, axis_name=axis_name)
    s = model.update_xbar(s, axis_name=axis_name)   # saves v_prev internally
    s = model.update_l_single(s)
    s, scalars = model.update_residual(s, 0.0, axis_name=axis_name)
    return OneLevelCarry(
        sol=s, it=it,
        primres=scalars["primres"],
        dualres=scalars["dualres"],
        mismatch=scalars["mismatch"],
        objval=scalars["objval"],
        auglag=scalars["auglag"],
    )


def _carry0(sol, dtype) -> OneLevelCarry:
    return OneLevelCarry(
        sol=sol,
        it=jnp.zeros((), jnp.int32),
        primres=jnp.asarray(jnp.inf, dtype),
        dualres=jnp.asarray(jnp.inf, dtype),
        mismatch=jnp.asarray(jnp.inf, dtype),
        objval=jnp.asarray(0.0, dtype),
        auglag=jnp.asarray(0.0, dtype),
    )


def _one_level_while(model, sol, outer_tol, dual_tol, outer_iterlim,
                     axis_name=None) -> OneLevelCarry:
    """The whole one-level solve as a single while-loop (shared by the
    single-device and the shard_map drivers)."""
    if hasattr(model, "solve_prep"):
        # model-specific loop-invariant precomputation from the actual
        # solve inputs (e.g. qpsub's rho-only QP constants) — traced here,
        # OUTSIDE the while_loop, so XLA hoists it
        model = model.solve_prep(sol)
    dtype = sol.base.u.gen.dtype if hasattr(sol, "base") else sol.u.gen.dtype

    def cond(c):
        converged = (c.mismatch <= outer_tol) & (c.dualres <= dual_tol)
        return (c.it < outer_iterlim) & ~converged

    return lax.while_loop(
        cond, lambda c: _one_iteration(model, c, axis_name=axis_name),
        _carry0(sol, dtype))


def admm_one_level(model, sol, info: IterationInformation | None = None,
                   run=None):
    """Run one-level ADMM fully on device; returns (sol, info).

    ``run`` may be a pre-built sharded solver
    (parallel.sharding.make_sharded_one_level); it receives the
    reset solution and returns the final OneLevelCarry.
    """
    par = model.par
    info = info or IterationInformation()
    sqrt_d = float(model.nvar) ** 0.5
    outer_tol = sqrt_d * par.outer_eps
    dtype = sol.base.u.gen.dtype if hasattr(sol, "base") else sol.u.gen.dtype

    rho_norm = model.rho_norm(sol)
    dual_tol = outer_tol * rho_norm / sqrt_d
    outer_iterlim = par.outer_iterlim

    sol = model.one_level_reset(sol)

    def one_iteration(c: OneLevelCarry) -> OneLevelCarry:
        return _one_iteration(model, c)

    external_run = run is not None
    if run is None:
        @jax.jit
        def run(sol, dual_tol):
            return _one_level_while(model, sol, outer_tol, dual_tol,
                                    outer_iterlim)

    t0 = time.perf_counter()
    if par.verbose > 0 and not external_run:
        # host-stepped loop for visibility (one readback per iteration)
        if outer_iterlim > 500:
            # one-level solves routinely run thousands of iterations
            # (reference qpsub case9: 5107); one dispatch per iteration
            # costs far more than the fused on-device loop
            print(" [admm_one_level] verbose>0 steps the solver one dispatch "
                  "per iteration for visibility; use verbose=0 for the fused "
                  "single-dispatch production path")
        step = jax.jit(one_iteration)
        c = _carry0(sol, dtype)
        print(f"{'Iter':>8} {'Objval':>12} {'AugLag':>12} {'PrimRes':>10} "
              f"{'PrimTol':>10} {'DualRes':>10} {'DualTol':>10}")
        while True:
            converged = (float(c.mismatch) <= outer_tol
                         and float(c.dualres) <= dual_tol)
            if converged or int(c.it) >= outer_iterlim:
                break
            c = step(c)
            if int(c.it) % 50 == 1 or par.verbose > 1:
                print(f"{int(c.it):>8d} {float(c.objval):>12.5e} "
                      f"{float(c.auglag):>12.5e} {float(c.primres):>10.3e} "
                      f"{outer_tol:>10.3e} {float(c.dualres):>10.3e} "
                      f"{dual_tol:>10.3e}")
    else:
        c = run(sol, jnp.asarray(dual_tol, dtype))
        jax.block_until_ready(c)

    info.time_overall = time.perf_counter() - t0
    info.outer = info.cumul = int(c.it)
    info.inner = 1
    info.primres = float(c.primres)
    info.dualres = float(c.dualres)
    info.mismatch = float(c.mismatch)
    info.objval = float(c.objval)
    info.auglag = float(c.auglag)
    converged = info.mismatch <= outer_tol and info.dualres <= dual_tol
    info.status = "Solved" if converged else "IterationLimit"
    return c.sol, info
