"""Generic two-level ADMM driver.

Reference: ``/root/reference/src/algorithms/admm_two_level.jl``. The outer
augmented-Lagrangian loop stays on the host (<= ``outer_iterlim`` trips, a few
scalars read back per trip); the entire inner ADMM loop runs on-device as one
jitted ``lax.while_loop`` — the replacement for the reference's
per-iteration kernel launches with device->host norm readbacks.

Inner iteration order (admm_two_level.jl:34-63):
    z_prev <- z;  x;  xbar;  z;  l;  residual
with the adaptive inner tolerance eps_pri = sqrt(nvar)/(2500*outer) and break
when primres <= eps_pri. Outer: converged when ||u - v|| <= sqrt(nvar)*
outer_eps; otherwise lz <- clamp(lz + beta z) and beta <- min(inc_c*beta,
1e24) when ||z|| > theta*||z_prev||.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.environment import (IterationInformation, Solution,
                                 permute_solution_lines)
from ..utils.grid_data import permute_lines
from ..utils.pytree import pytree_dataclass


@pytree_dataclass
class InnerCarry:
    sol: Solution
    inner: jnp.ndarray     # i32
    primres: jnp.ndarray
    dualres: jnp.ndarray
    norm_z: jnp.ndarray
    mismatch: jnp.ndarray
    objval: jnp.ndarray
    auglag: jnp.ndarray
    avg_auglag_it: jnp.ndarray
    avg_minor_it: jnp.ndarray
    # solver-health scalars of the LAST inner iteration: worst line-limit
    # constraint violation left by the branch ALM (the reference warns per
    # line on ALM non-convergence, acopf_auglag_linelimit_kernel_cpu.jl:
    # 150-153) and the number of two-pass stragglers beyond tail capacity
    max_cviol: jnp.ndarray
    tail_overflow: jnp.ndarray  # i32
    pass1_unfinished: jnp.ndarray  # i32 lanes out of pass-1 budget last iter
    # line-sorting state (Parameters.sort_lines): per-lane lockstep steps of
    # the LAST inner iteration (the difficulty signal) and the composed
    # current-position -> original-line-id map. Models without per-lane
    # stats carry 0-size placeholders through unchanged.
    lane_steps: jnp.ndarray  # i32 (nline_padded,) or (0,)
    line_ids: jnp.ndarray    # i32 (nline_padded,) or (0,)


def _beta_cap(dtype) -> float:
    """Dtype-aware ceiling for the outer penalty beta.

    The reference caps beta at 1e24 (admm_two_level.jl:75) — harmless in
    fp64, where no practical escalation schedule reaches it. In fp32 an
    uncapped beta ratchets past ~1e6 whenever ||z|| stalls and then destroys
    the z/l/lz updates (z = -(lz+l+rho(u-v))/(beta+rho) underflows against
    rho, lz clamps, primres grows — measured divergence at synth-9241:
    primres 4.5e-2 at beta 3.6e4 -> 3.7e2 at beta 3.6e11). Sub-fp64 dtypes
    cap at 0.1/eps, the same conditioning rule used for the branch ALM
    mu_max (models/acopf/branch.py); fp64 keeps the reference constant
    exactly so fp64 trajectories stay pinned."""
    if jnp.finfo(dtype).eps <= jnp.finfo(jnp.float64).eps:
        return 1e24
    return 0.1 / float(jnp.finfo(dtype).eps)


def _one_inner_iteration(model, carry: InnerCarry, beta, axis_name=None,
                         Pd=None, Qd=None, pg_bounds=None) -> InnerCarry:
    # models implement the hook protocol (the analogue of the reference's
    # 11-hook multiple-dispatch protocol, docs/src/dev.md)
    sol = carry.sol
    sol = model.inner_prestep(sol)                      # z_prev <- z
    inner = carry.inner + 1
    sol, stats = model.update_x(sol, inner, axis_name=axis_name,
                                pg_bounds=pg_bounds)
    sol = model.update_xbar(sol, Pd=Pd, Qd=Qd, axis_name=axis_name)
    sol = model.update_z(sol, beta)
    sol = model.update_l(sol, beta)
    sol, scalars = model.update_residual(sol, beta, axis_name=axis_name)
    return InnerCarry(
        sol=sol,
        inner=inner,
        primres=scalars["primres"],
        dualres=scalars["dualres"],
        norm_z=scalars["norm_z_curr"],
        mismatch=scalars["mismatch"],
        objval=scalars["objval"],
        auglag=scalars["auglag"],
        avg_auglag_it=stats["avg_auglag_it"],
        avg_minor_it=stats["avg_minor_it"],
        max_cviol=stats.get("max_cviol", carry.max_cviol),
        tail_overflow=stats.get("tail_overflow", carry.tail_overflow),
        pass1_unfinished=stats.get("pass1_unfinished", carry.pass1_unfinished),
        lane_steps=stats.get("lane_steps", carry.lane_steps),
        line_ids=carry.line_ids,
    )


def make_inner_loop(model, inner_iterlim: int):
    """Build the jitted on-device inner loop for a model instance.

    The returned callable is
    ``run_inner(sol, beta, outer, Pd, Qd, pgmin, pgmax,
                line_ids=None, lane_steps=None)``.
    When the model supports it and ``par.sort_lines`` is on, passing the
    previous carry's ``line_ids``/``lane_steps`` difficulty-sorts the line
    batch at the start of the dispatch (stragglers cluster into the last
    Pallas tiles, easy tiles exit their lockstep loop early). The returned
    ``carry.sol`` is in the sorted order; invert with
    ``restore_line_order`` once at the end of the solve.
    """
    sqrt_d = float(model.nvar) ** 0.5
    grid0 = getattr(model, "grid", None)
    sorting = (getattr(model, "supports_line_sort", False)
               and model.par.sort_lines and grid0 is not None)

    @jax.jit
    def run_inner(sol: Solution, beta, outer, Pd, Qd, pgmin_curr, pgmax_curr,
                  line_ids=None, lane_steps=None):
        nlp = grid0.nline_padded if grid0 is not None else 0
        if line_ids is None:
            line_ids = jnp.arange(nlp, dtype=jnp.int32)
        if lane_steps is None:
            lane_steps = jnp.zeros((nlp,), jnp.int32)
        return _sorted_inner_while(
            model, sorting, sqrt_d, inner_iterlim,
            sol, beta, outer, Pd, Qd, pgmin_curr, pgmax_curr,
            line_ids, lane_steps)

    run_inner.line_sort = sorting
    run_inner.nline_padded = grid0.nline_padded if grid0 is not None else 0
    return run_inner


def make_timed_inner_loop(model, inner_iterlim: int):
    """Per-hook stepping inner loop (``verbose >= 2`` debug path).

    Each hook runs as its OWN jitted dispatch, timed with block_until_ready,
    so the per-phase ``IterationInformation.time_{x,xbar,z,l}_update`` fields
    can be populated the way the reference fills them every iteration
    (environment.jl:341-347, printed by print_statistics.jl:7-19). This
    executes ~6 dispatches per inner iteration instead of one per SOLVE —
    far slower; it exists for observability, not production. No line
    sorting (debug path).

    The returned callable matches make_inner_loop's signature and returns an
    InnerCarry; pass an IterationInformation as ``run_inner.info`` target via
    the ``timings`` dict attribute, read back by admm_two_level.
    """
    sqrt_d = float(model.nvar) ** 0.5
    grid0 = getattr(model, "grid", None)
    nlp = grid0.nline_padded if grid0 is not None else 0

    prestep = jax.jit(model.inner_prestep)
    upd_x = jax.jit(lambda s, it, pb: model.update_x(s, it, pg_bounds=pb))
    upd_xbar = jax.jit(lambda s, Pd, Qd: model.update_xbar(s, Pd=Pd, Qd=Qd))
    upd_z = jax.jit(model.update_z)
    upd_l = jax.jit(model.update_l)
    upd_res = jax.jit(model.update_residual)

    timings = {"x": 0.0, "xbar": 0.0, "z": 0.0, "l": 0.0}

    def _timed(key, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        timings[key] = timings[key] + (time.perf_counter() - t0)
        return out

    def run_inner(sol, beta, outer, Pd, Qd, pgmin_curr, pgmax_curr,
                  line_ids=None, lane_steps=None):
        eps_pri = sqrt_d / (2500.0 * float(outer))
        inner = 0
        scalars = stats = None
        while inner < inner_iterlim:
            sol = prestep(sol)
            inner += 1
            it = jnp.asarray(inner, jnp.int32)
            sol, stats = _timed("x", upd_x, sol, it,
                                (pgmin_curr, pgmax_curr))
            sol = _timed("xbar", upd_xbar, sol, Pd, Qd)
            sol = _timed("z", upd_z, sol, beta)
            sol = _timed("l", upd_l, sol, beta)
            sol, scalars = upd_res(sol, beta)
            if float(scalars["primres"]) <= eps_pri:
                break
        dt = sol.u.gen.dtype if hasattr(sol, "u") else (
            jax.tree_util.tree_leaves(sol)[0].dtype)
        zero = jnp.zeros((), dt)
        return InnerCarry(
            sol=sol, inner=jnp.asarray(inner, jnp.int32),
            primres=scalars["primres"], dualres=scalars["dualres"],
            norm_z=scalars["norm_z_curr"], mismatch=scalars["mismatch"],
            objval=scalars["objval"], auglag=scalars["auglag"],
            avg_auglag_it=stats.get("avg_auglag_it", zero),
            avg_minor_it=stats.get("avg_minor_it", zero),
            max_cviol=stats.get("max_cviol", zero),
            tail_overflow=stats.get("tail_overflow", jnp.zeros((), jnp.int32)),
            pass1_unfinished=stats.get("pass1_unfinished",
                                       jnp.zeros((), jnp.int32)),
            lane_steps=stats.get("lane_steps", jnp.zeros((nlp,), jnp.int32)),
            line_ids=jnp.arange(nlp, dtype=jnp.int32),
        )

    run_inner.line_sort = False
    run_inner.nline_padded = nlp
    run_inner.timings = timings
    return run_inner


def _sorted_inner_while(model, sorting, sqrt_d, inner_iterlim,
                        sol, beta, outer, Pd, Qd, pgmin_curr, pgmax_curr,
                        line_ids, lane_steps, axis_name=None) -> InnerCarry:
    """(Optionally sort lines by difficulty, then) run the inner ADMM loop."""
    mod = model
    if sorting:
        # stable ascending sort: padded lanes (0 steps) lead, stragglers
        # trail; identity when lane_steps is all-zero (first dispatch)
        reorder = jnp.argsort(lane_steps)
        line_ids = line_ids[reorder]
        mod = dataclasses.replace(
            model, grid=permute_lines(model.grid, line_ids))
        sol = permute_solution_lines(sol, reorder)

    eps_pri = sqrt_d / (2500.0 * outer)

    def cond(c: InnerCarry):
        return (c.inner < inner_iterlim) & (c.primres > eps_pri)

    def body(c: InnerCarry):
        return _one_inner_iteration(mod, c, beta, axis_name=axis_name,
                                    Pd=Pd, Qd=Qd,
                                    pg_bounds=(pgmin_curr, pgmax_curr))

    dt = sol.u.gen.dtype
    c0 = InnerCarry(
        sol=sol,
        inner=jnp.zeros((), jnp.int32),
        primres=jnp.asarray(jnp.inf, dt),
        dualres=jnp.asarray(jnp.inf, dt),
        norm_z=jnp.asarray(jnp.inf, dt),
        mismatch=jnp.asarray(jnp.inf, dt),
        objval=jnp.asarray(0.0, dt),
        auglag=jnp.asarray(0.0, dt),
        avg_auglag_it=jnp.asarray(0.0, dt),
        avg_minor_it=jnp.asarray(0.0, dt),
        max_cviol=jnp.asarray(0.0, dt),
        tail_overflow=jnp.zeros((), jnp.int32),
        pass1_unfinished=jnp.zeros((), jnp.int32),
        lane_steps=lane_steps,
        line_ids=line_ids,
    )
    return lax.while_loop(cond, body, c0)


def restore_line_order(sol: Solution, line_ids) -> Solution:
    """Undo the driver's difficulty sort: scatter line rows back to their
    original positions (line_ids[i] = original id now at position i)."""
    inv = jnp.argsort(line_ids)
    return permute_solution_lines(sol, inv)


@pytree_dataclass
class OuterCarry:
    sol: Solution
    beta: jnp.ndarray
    outer: jnp.ndarray        # i32
    cumul: jnp.ndarray        # i32 total inner iterations
    inner_last: jnp.ndarray   # i32
    norm_z_prev: jnp.ndarray
    norm_z: jnp.ndarray
    mismatch: jnp.ndarray
    primres: jnp.ndarray
    dualres: jnp.ndarray
    objval: jnp.ndarray
    auglag: jnp.ndarray
    max_cviol: jnp.ndarray
    tail_overflow: jnp.ndarray  # i32
    pass1_unfinished: jnp.ndarray  # i32
    lane_steps: jnp.ndarray
    line_ids: jnp.ndarray


def make_fused_solver(model, par=None):
    """Entire two-level ADMM as ONE jitted dispatch (silent path).

    The reference keeps the outer augmented-Lagrangian loop on the host for
    per-iteration printing (admm_two_level.jl:29-77); a dispatch plus the
    outer-loop scalar readbacks per outer iteration cost host round trips,
    so the production path fuses the outer loop on device too:
    outer ``lax.while_loop`` {inner while_loop; lz update; beta escalation}.
    Identical update order and break conditions to :func:`admm_two_level`
    (which remains the verbose/debug path).

    Returns ``run(sol, beta0, Pd, Qd, pgmin, pgmax) -> OuterCarry`` with the
    solution already restored to canonical line order.
    """
    par = par or model.par
    sqrt_d = float(model.nvar) ** 0.5
    sorting = getattr(model, "supports_line_sort", False) and par.sort_lines

    @jax.jit
    def run(sol: Solution, beta0, Pd, Qd, pgmin_curr, pgmax_curr) -> OuterCarry:
        out = _fused_outer_while(model, sorting, sqrt_d, par,
                                 sol, beta0, Pd, Qd, pgmin_curr, pgmax_curr)
        if sorting:
            out = out.replace(sol=restore_line_order(out.sol, out.line_ids))
        return out

    return run


def _fused_outer_while(model, sorting, sqrt_d, par,
                       sol, beta0, Pd, Qd, pgmin_curr, pgmax_curr,
                       axis_name=None) -> OuterCarry:
    """The fused outer loop body, shared by the single-device and the
    shard_map solvers. Leaves ``sol`` in sorted order when sorting is on."""
    outer_tol = sqrt_d * par.outer_eps
    inner_iterlim = par.inner_iterlim
    outer_iterlim = par.outer_iterlim
    dt = sol.u.gen.dtype if hasattr(sol, "u") else (
        jax.tree_util.tree_leaves(sol)[0].dtype)
    # local line count (differs from the static global under shard_map)
    nlp = model.grid.YffR.shape[0]

    def cond(c: OuterCarry):
        return (c.outer < outer_iterlim) & (c.mismatch > outer_tol)

    def body(c: OuterCarry):
        outer = c.outer + 1
        ic = _sorted_inner_while(
            model, sorting, sqrt_d, inner_iterlim,
            c.sol, c.beta, outer.astype(dt), Pd, Qd,
            pgmin_curr, pgmax_curr, c.line_ids, c.lane_steps,
            axis_name=axis_name)
        solved = ic.mismatch <= outer_tol
        # lz <- clamp(lz + beta z) only when continuing (host driver
        # breaks before the lz step on convergence)
        sol_lz = model.update_lz(ic.sol, c.beta)
        sol2 = jax.tree_util.tree_map(
            lambda a, b: jnp.where(solved, a, b), ic.sol, sol_lz)
        beta = jnp.where(
            (~solved) & (ic.norm_z > par.theta * c.norm_z),
            jnp.minimum(par.inc_c * c.beta, _beta_cap(dt)), c.beta)
        return OuterCarry(
            sol=sol2, beta=beta, outer=outer,
            cumul=c.cumul + ic.inner, inner_last=ic.inner,
            norm_z_prev=c.norm_z, norm_z=ic.norm_z,
            mismatch=ic.mismatch, primres=ic.primres,
            dualres=ic.dualres, objval=ic.objval, auglag=ic.auglag,
            max_cviol=ic.max_cviol, tail_overflow=ic.tail_overflow,
            pass1_unfinished=ic.pass1_unfinished,
            lane_steps=ic.lane_steps, line_ids=ic.line_ids,
        )

    c0 = OuterCarry(
        sol=sol,
        # clamp a user-supplied beta0 too — escalation clamps alone would let
        # an out-of-range initial beta run the z/l/lz updates in exactly the
        # degenerate regime the cap exists to prevent
        beta=jnp.minimum(jnp.asarray(beta0, dt), _beta_cap(dt)),
        outer=jnp.zeros((), jnp.int32),
        cumul=jnp.zeros((), jnp.int32),
        inner_last=jnp.zeros((), jnp.int32),
        norm_z_prev=jnp.asarray(jnp.inf, dt),
        norm_z=jnp.asarray(jnp.inf, dt),
        mismatch=jnp.asarray(jnp.inf, dt),
        primres=jnp.asarray(jnp.inf, dt),
        dualres=jnp.asarray(jnp.inf, dt),
        objval=jnp.asarray(0.0, dt),
        auglag=jnp.asarray(0.0, dt),
        max_cviol=jnp.asarray(0.0, dt),
        tail_overflow=jnp.zeros((), jnp.int32),
        pass1_unfinished=jnp.zeros((), jnp.int32),
        lane_steps=jnp.zeros((nlp,), jnp.int32),
        line_ids=jnp.arange(nlp, dtype=jnp.int32),
    )
    return lax.while_loop(cond, body, c0)


def admm_two_level_fused(model, sol: Solution,
                         info: IterationInformation | None = None,
                         run=None, Pd=None, Qd=None,
                         pgmin_curr=None, pgmax_curr=None):
    """Single-dispatch counterpart of :func:`admm_two_level` (verbose=0)."""
    par = model.par
    info = info or IterationInformation()
    if run is None:
        run = make_fused_solver(model)
    t0 = time.perf_counter()
    out = run(sol,
              par.initial_beta,
              model.default_Pd() if Pd is None else Pd,
              model.default_Qd() if Qd is None else Qd,
              model.pgmin_curr if pgmin_curr is None else pgmin_curr,
              model.pgmax_curr if pgmax_curr is None else pgmax_curr)
    jax.block_until_ready(out)
    info.time_overall = time.perf_counter() - t0
    info.outer = int(out.outer)
    info.inner = int(out.inner_last)
    info.cumul = int(out.cumul)
    info.primres = float(out.primres)
    info.dualres = float(out.dualres)
    info.norm_z_curr = float(out.norm_z)
    info.norm_z_prev = float(out.norm_z_prev)
    info.mismatch = float(out.mismatch)
    info.objval = float(out.objval)
    info.auglag = float(out.auglag)
    info.max_cviol = float(out.max_cviol)
    info.tail_overflow = int(out.tail_overflow)
    info.pass1_unfinished = int(out.pass1_unfinished)
    sqrt_d = float(model.nvar) ** 0.5
    info.eps_pri = sqrt_d / (2500.0 * max(info.outer, 1))
    info.status = ("Solved" if info.mismatch <= sqrt_d * par.outer_eps
                   else "IterationLimit")
    par.beta = float(out.beta)
    return out.sol, info


def admm_two_level(model, sol: Solution, info: IterationInformation | None = None,
                   run_inner=None, Pd=None, Qd=None,
                   pgmin_curr=None, pgmax_curr=None):
    """Run the two-level ADMM; returns (sol, info).

    ``run_inner`` may be a pre-built (possibly sharded) inner-loop callable
    (see parallel.sharding.make_sharded_inner_loop); defaults to the
    single-device jitted loop. Pd/Qd and the (possibly ramp-tightened) pg
    bounds are runtime arguments so rolling-horizon re-solves reuse one
    compiled loop (reference re-solves mutate grid_data in place,
    acopf_admm_rolling_cpu.jl:33-47).
    """
    par = model.par
    info = info or IterationInformation()
    sqrt_d = float(model.nvar) ** 0.5
    outer_tol = sqrt_d * par.outer_eps

    if run_inner is None:
        if par.verbose >= 2:
            # per-hook stepping with block_until_ready timing: populates the
            # reference's per-phase time_* fields (environment.jl:341-347) at
            # the cost of ~6 dispatches per inner iteration instead of one
            # per outer round — observability mode only
            run_inner = make_timed_inner_loop(model, par.inner_iterlim)
        else:
            run_inner = make_inner_loop(model, par.inner_iterlim)
    if Pd is None:
        Pd = model.default_Pd()
    if Qd is None:
        Qd = model.default_Qd()
    if pgmin_curr is None:
        pgmin_curr = model.pgmin_curr
    if pgmax_curr is None:
        pgmax_curr = model.pgmax_curr
    lz_step = jax.jit(lambda s, b: model.update_lz(s, b))

    beta = min(par.initial_beta, _beta_cap(sol.u.gen.dtype))
    info.status = "IterationLimit"
    info.norm_z_curr = info.norm_z_prev = float("inf")

    if par.verbose > 0:
        print(f"{'Outer':>6} {'Inner':>6} {'Objval':>12} {'AugLag':>12} "
              f"{'PrimRes':>10} {'EpsPrim':>10} {'DualRes':>10} {'||z||':>10} "
              f"{'Mismatch':>10} {'OuterTol':>10} {'Beta':>10}")

    # line-difficulty sorting state (only when the loop was built with it)
    sort_active = bool(getattr(run_inner, "line_sort", False))
    nlp = int(getattr(run_inner, "nline_padded", 0))
    line_ids = jnp.arange(nlp, dtype=jnp.int32) if sort_active else None
    lane_steps = jnp.zeros((nlp,), jnp.int32) if sort_active else None

    t0 = time.perf_counter()
    while info.outer < par.outer_iterlim:
        info.outer += 1
        info.norm_z_prev = info.norm_z_curr  # outer prestep: save ||z||

        if sort_active:
            carry = run_inner(sol, jnp.asarray(beta, sol.u.gen.dtype),
                              jnp.asarray(float(info.outer), sol.u.gen.dtype),
                              Pd, Qd, pgmin_curr, pgmax_curr,
                              line_ids, lane_steps)
            line_ids, lane_steps = carry.line_ids, carry.lane_steps
        else:
            carry = run_inner(sol, jnp.asarray(beta, sol.u.gen.dtype),
                              jnp.asarray(float(info.outer), sol.u.gen.dtype),
                              Pd, Qd, pgmin_curr, pgmax_curr)
        sol = carry.sol
        info.inner = int(carry.inner)
        info.cumul += info.inner
        info.primres = float(carry.primres)
        info.dualres = float(carry.dualres)
        info.norm_z_curr = float(carry.norm_z)
        info.mismatch = float(carry.mismatch)
        info.objval = float(carry.objval)
        info.auglag = float(carry.auglag)
        info.max_cviol = float(carry.max_cviol)
        info.tail_overflow = int(carry.tail_overflow)
        info.pass1_unfinished = int(carry.pass1_unfinished)
        info.eps_pri = sqrt_d / (2500.0 * info.outer)

        if par.verbose > 0:
            print(f"{info.outer:>6d} {info.inner:>6d} {info.objval:>12.5e} "
                  f"{info.auglag:>12.5e} {info.primres:>10.3e} "
                  f"{info.eps_pri:>10.3e} {info.dualres:>10.3e} "
                  f"{info.norm_z_curr:>10.3e} {info.mismatch:>10.3e} "
                  f"{outer_tol:>10.3e} {beta:>10.3e}")

        if info.mismatch <= outer_tol:
            info.status = "Solved"
            break

        t_lz = time.perf_counter()
        sol = lz_step(sol, jnp.asarray(beta, sol.u.gen.dtype))
        if hasattr(run_inner, "timings"):
            jax.block_until_ready(sol)
            info.time_lz_update += time.perf_counter() - t_lz

        if info.norm_z_curr > par.theta * info.norm_z_prev:
            beta = min(par.inc_c * beta, _beta_cap(sol.u.gen.dtype))

    if sort_active:
        # hand the solution back in canonical line order
        sol = jax.jit(restore_line_order)(sol, line_ids)

    if hasattr(run_inner, "timings"):
        t = run_inner.timings
        info.time_x_update += t["x"]
        info.time_xbar_update += t["xbar"]
        info.time_z_update += t["z"]
        info.time_l_update += t["l"]

    info.time_overall = time.perf_counter() - t0
    par.beta = beta
    return sol, info
