"""Multi-chip sharding: lines partitioned over a device mesh.

Completion of the reference's MPI scaffolding (nline padded to a
rank multiple + ``shift_lines`` windows but NO collectives anywhere —
SURVEY.md §2.7.3; acopf_model.jl:50-53, environment.jl:22-23):

- lines are sharded on one mesh axis (contiguous chunks, padded by
  ``build_grid_data(pad_lines_to=n_devices)``),
- generators and buses are replicated (they are ~10x smaller than the line
  block and their updates are cheap),
- the branch TRON/ALM solver runs with zero communication — and since
  ``shard_map`` gives each device its own ``while_loop`` trip count, a device
  whose lines converge early stops early (unlike the global lockstep of the
  single-chip path),
- the bus consensus update needs one stacked (nbus, 8) ``psum``; the residual
  norms one (7,) ``psum``; branch stats one (2,) ``psum`` per inner
  iteration. XLA hands them to NCCL; the cards of one host are joined all
  to all, so the 1-D line mesh follows the algorithm alone.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..utils.environment import Blocks, BranchALMState, Solution
from ..utils.grid_data import GridData

AXIS = "lines"

_LINE_FIELDS = {
    "YffR", "YffI", "YttR", "YttI", "YftR", "YftI", "YtfR", "YtfI",
    "rate_a", "line_from", "line_to",
    "fr_vm_bound", "to_vm_bound", "fr_va_bound", "to_va_bound", "line_mask",
}


def make_mesh(n_devices: int | None = None, devices=None, axis: str = AXIS) -> Mesh:
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    import numpy as np
    return Mesh(np.array(devices), (axis,))


def grid_specs(gd: GridData, axis: str = AXIS) -> GridData:
    """A GridData-shaped PartitionSpec tree: line arrays sharded, rest replicated."""
    reps = {}
    for f in dataclasses.fields(GridData):
        if f.metadata.get("static", False):
            continue
        reps[f.name] = P(axis) if f.name in _LINE_FIELDS else P()
    return dataclasses.replace(gd, **reps)


def blocks_specs(axis: str = AXIS) -> Blocks:
    return Blocks(gen=P(), line=P(axis))


def solution_specs(axis: str = AXIS) -> Solution:
    b = blocks_specs(axis)
    return Solution(
        u=b, v=b, l=b, rho=b, z=b, z_prev=b, lz=b, rp=b, rd=b,
        branch_alm=BranchALMState(lam1=P(axis), lam2=P(axis), mu=P(axis)),
    )


def make_sharded_inner_loop(model, mesh: Mesh, inner_iterlim: int, axis: str = AXIS):
    """Sharded counterpart of admm_two_level.make_inner_loop.

    Returns run_inner(sol, beta, outer, Pd, Qd, pgmin, pgmax) with the full
    inner ADMM loop inside one jitted shard_map: per-device branch solves,
    psum-coupled bus/residual updates, identical loop-break decisions on
    every device (the break scalar is a psum result).

    Works for any model implementing the hook protocol plus two sharding
    hooks: ``solution_spec(axis)`` (PartitionSpec tree for its solution
    pytree) and ``local_model(gd_local, pgmin, pgmax)`` (rebuild itself
    around a device-local GridData). ModelAcopf gets defaults here.
    """
    from ..algorithms.admm_two_level import InnerCarry, _one_inner_iteration

    sqrt_d = float(model.nvar) ** 0.5
    gd = model.grid
    assert gd.nline_padded % mesh.devices.size == 0, (
        f"nline_padded={gd.nline_padded} not divisible by mesh size "
        f"{mesh.devices.size}; build the model with pad_lines_to=n_devices"
    )

    if hasattr(model, "solution_spec"):
        sol_sp = model.solution_spec(axis)
    else:
        sol_sp = solution_specs(axis)
    carry_sp = InnerCarry(
        sol=sol_sp, inner=P(), primres=P(), dualres=P(), norm_z=P(),
        mismatch=P(), objval=P(), auglag=P(),
        avg_auglag_it=P(), avg_minor_it=P(),
        max_cviol=P(), tail_overflow=P(), pass1_unfinished=P(),
        lane_steps=P(axis), line_ids=P(axis),
    )

    def inner(gd_local, sol, beta, outer, Pd, Qd, pgmin_curr, pgmax_curr):
        if hasattr(model, "local_model"):
            model_local = model.local_model(gd_local, pgmin_curr, pgmax_curr)
        else:
            model_local = dataclasses.replace(
                model, grid=gd_local,
                pgmin_curr=pgmin_curr, pgmax_curr=pgmax_curr)
        eps_pri = sqrt_d / (2500.0 * outer)

        def cond(c):
            return (c.inner < inner_iterlim) & (c.primres > eps_pri)

        def body(c):
            return _one_inner_iteration(model_local, c, beta, axis_name=axis,
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
            # local-shard placeholders (line sorting is a single-device
            # optimization; each shard's own while_loop already exits early)
            lane_steps=jnp.zeros(gd_local.YffR.shape, jnp.int32),
            line_ids=jnp.zeros(gd_local.YffR.shape, jnp.int32),
        )
        return lax.while_loop(cond, body, c0)

    sharded = jax.shard_map(
        inner,
        mesh=mesh,
        in_specs=(grid_specs(gd, axis), sol_sp, P(), P(), P(), P(), P(), P()),
        out_specs=carry_sp,
        check_vma=False,
    )

    @jax.jit
    def run_inner(sol, beta, outer, Pd, Qd, pgmin_curr, pgmax_curr):
        return sharded(gd, sol, beta, outer, Pd, Qd, pgmin_curr, pgmax_curr)

    return run_inner


def make_sharded_one_level(model, mesh: Mesh, axis: str = AXIS):
    """Sharded one-level ADMM (qpsub): the whole solve as one shard_map
    dispatch, lines + the per-line SQP inputs partitioned over the mesh.

    Completes the reference's MPI scaffolding for qpsub (line padding at
    qpsub_model.jl:139-142, no collectives upstream). The model must list its
    line-indexed arrays in ``LINE_FIELDS`` and provide ``solution_spec``.

    Returns ``run(sol, dual_tol) -> OneLevelCarry`` (pass the reset solution;
    admm_one_level does this when given ``run=``).
    """
    from jax.sharding import PartitionSpec as P  # noqa: F811 (local alias)

    from ..algorithms.admm_one_level import OneLevelCarry, _one_level_while

    gd = model.grid
    par = model.par
    assert gd.nline_padded % mesh.devices.size == 0, (
        f"nline_padded={gd.nline_padded} not divisible by mesh size "
        f"{mesh.devices.size}; build the model with pad_lines_to=n_devices"
    )
    sqrt_d = float(model.nvar) ** 0.5
    outer_tol = sqrt_d * par.outer_eps

    sol_sp = model.solution_spec(axis)
    line_fields = model.LINE_FIELDS
    line_arrs = {f: getattr(model, f) for f in line_fields}
    arrs_sp = {f: P(axis) for f in line_fields}
    carry_sp = OneLevelCarry(
        sol=sol_sp, it=P(), primres=P(), dualres=P(), mismatch=P(),
        objval=P(), auglag=P(),
    )

    def solve(gd_local, arrs, sol, dual_tol):
        model_local = dataclasses.replace(model, grid=gd_local, **arrs)
        return _one_level_while(model_local, sol, outer_tol, dual_tol,
                                par.outer_iterlim, axis_name=axis)

    sharded = jax.shard_map(
        solve,
        mesh=mesh,
        in_specs=(grid_specs(gd, axis), arrs_sp, sol_sp, P()),
        out_specs=carry_sp,
        check_vma=False,
    )

    @jax.jit
    def run(sol, dual_tol):
        return sharded(gd, line_arrs, sol, dual_tol)

    return run


def make_sharded_fused_solver(model, mesh: Mesh, axis: str = AXIS):
    """Sharded counterpart of admm_two_level.make_fused_solver: the WHOLE
    two-level solve (outer + inner loops, lz updates, beta escalation) as a
    single jitted shard_map dispatch.

    All loop-break decisions derive from psum'd scalars, so every device
    takes identical trip counts and the collectives stay aligned. When the
    model supports line sorting and ``par.sort_lines`` is on, each device
    difficulty-sorts its OWN line shard between inner loops (local argsort,
    no communication) — the per-shard version of the single-device sort, so
    stragglers cluster into the same Pallas tiles within every shard; the
    solution is restored to canonical local order before returning.

    Returns ``run(sol, beta0, Pd, Qd, pgmin, pgmax) -> OuterCarry``.
    """
    import dataclasses as _dc

    from ..algorithms.admm_two_level import (OuterCarry, _fused_outer_while,
                                             restore_line_order)

    sqrt_d = float(model.nvar) ** 0.5
    gd = model.grid
    par = model.par
    assert gd.nline_padded % mesh.devices.size == 0, (
        f"nline_padded={gd.nline_padded} not divisible by mesh size "
        f"{mesh.devices.size}; build the model with pad_lines_to=n_devices"
    )

    if hasattr(model, "solution_spec"):
        sol_sp = model.solution_spec(axis)
    else:
        sol_sp = solution_specs(axis)
    carry_sp = OuterCarry(
        sol=sol_sp, beta=P(), outer=P(), cumul=P(), inner_last=P(),
        norm_z_prev=P(), norm_z=P(), mismatch=P(), primres=P(),
        dualres=P(), objval=P(), auglag=P(),
        max_cviol=P(), tail_overflow=P(), pass1_unfinished=P(),
        lane_steps=P(axis), line_ids=P(axis),
    )

    sorting = getattr(model, "supports_line_sort", False) and par.sort_lines

    def solve(gd_local, sol, beta0, Pd, Qd, pgmin_curr, pgmax_curr):
        if hasattr(model, "local_model"):
            model_local = model.local_model(gd_local, pgmin_curr, pgmax_curr)
        else:
            model_local = _dc.replace(
                model, grid=gd_local,
                pgmin_curr=pgmin_curr, pgmax_curr=pgmax_curr)
        out = _fused_outer_while(
            model_local, sorting, sqrt_d, par,
            sol, beta0, Pd, Qd, pgmin_curr, pgmax_curr, axis_name=axis)
        if sorting:
            out = out.replace(sol=restore_line_order(out.sol, out.line_ids))
        return out

    sharded = jax.shard_map(
        solve,
        mesh=mesh,
        in_specs=(grid_specs(gd, axis), sol_sp, P(), P(), P(), P(), P()),
        out_specs=carry_sp,
        check_vma=False,
    )

    @jax.jit
    def run(sol, beta0, Pd, Qd, pgmin_curr, pgmax_curr):
        return sharded(gd, sol, beta0, Pd, Qd, pgmin_curr, pgmax_curr)

    return run
