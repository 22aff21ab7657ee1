"""User-facing single-period ACOPF solve.

Reference: ``/root/reference/src/interface/solve_acopf.jl``. Device selection
collapses to JAX platform choice (``backend=`` kwarg) — there is a single
implementation instead of CPU/CUDA/KA triplicates.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..algorithms.admm_two_level import admm_two_level, admm_two_level_fused
from ..models.acopf import model as M
from ..utils.environment import AdmmEnv, IterationInformation, Parameters, Solution
from ..utils.opfdata import OPFData, opf_loaddata


@dataclasses.dataclass
class SolveResult:
    data: OPFData
    model: "M.ModelAcopf"
    solution: Solution
    info: IterationInformation
    env: AdmmEnv | None = None


def _default_dtype():
    return jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32


def solve_acopf(
    case: str,
    *,
    case_format: str = "matpower",
    outer_iterlim: int = 20,
    inner_iterlim: int = 1000,
    rho_pq: float = 400.0,
    rho_va: float = 40000.0,
    obj_scale: float = 1.0,
    scale: float = 1e-4,
    use_linelimit: bool = True,
    use_projection: bool = False,
    tight_factor: float = 1.0,
    outer_eps: float = 2e-4,
    verbose: int = 1,
    dtype=None,
    pad_lines_to: int = 1,
    backend: str | None = None,
    mesh=None,
    tron_step_cap: int | None = None,
    branch_backend: str = "auto",
    pallas_tile: int = 32,
    bus_backend: str = "auto",
    mixed_precision: bool = False,
    initial_beta: float = 1e3,
    # outer-penalty escalation threshold (reference theta=0.8,
    # admm_two_level.jl:74). Iteration counts are sensitive to where the
    # per-outer ||z|| contraction ratio lands relative to theta: on case9
    # this solver contracts at ~0.71/outer, just BELOW 0.8, so beta never
    # escalates and the solve takes 25 outer / 1087 cumul; theta=0.72
    # reproduces the reference's 20-outer shape (739 cumul, obj 5303.2 vs
    # its 705 / 5303.4). See PARITY.md.
    theta: float = 0.8,
    inc_c: float = 6.0,
) -> SolveResult:
    """Solve a single-period ACOPF with two-level ADMM.

    Pass ``mesh`` (a 1-D jax.sharding.Mesh) to shard lines across devices;
    ``pad_lines_to`` then defaults to the mesh size.
    """
    dtype = dtype or _default_dtype()
    if mixed_precision and dtype != jnp.float64:
        # without this the flag is a silent no-op: branch_update only
        # activates mixed mode on fp64 state, so an fp32 session would run
        # a plain fp32 solve while reporting mixed-precision quality
        raise ValueError(
            "mixed_precision=True needs an fp64 solve (the branch batch is "
            "cast DOWN to fp32): enable jax_enable_x64 or pass "
            "dtype=jnp.float64")
    data = opf_loaddata(case, case_format=case_format, verbose=verbose)
    if mesh is not None and pad_lines_to == 1:
        pad_lines_to = int(mesh.devices.size)

    par = Parameters(
        outer_iterlim=outer_iterlim,
        inner_iterlim=inner_iterlim,
        obj_scale=obj_scale,
        scale=scale,
        outer_eps=outer_eps,
        initial_beta=initial_beta,
        beta=initial_beta,
        theta=theta,
        inc_c=inc_c,
        verbose=verbose,
        tron_step_cap=tron_step_cap,
        branch_backend=branch_backend,
        pallas_tile=pallas_tile,
        bus_backend=bus_backend,
        mixed_precision=mixed_precision,
    )

    device_ctx = (
        jax.default_device(jax.devices(backend)[0]) if backend else _nullcontext()
    )
    with device_ctx:
        model = M.build_model(
            data, par,
            use_linelimit=use_linelimit,
            tight_factor=tight_factor,
            pad_lines_to=pad_lines_to,
            dtype=dtype,
        )
        sol = init_sol = M.init_solution(model, rho_pq, rho_va)
        if mesh is not None and verbose == 0:
            # multi-chip production path: whole solve in one sharded dispatch
            from ..parallel.sharding import make_sharded_fused_solver
            run = make_sharded_fused_solver(model, mesh)
            sol, info = admm_two_level_fused(model, sol, run=run)
        elif mesh is not None:
            from ..parallel.sharding import make_sharded_inner_loop
            run_inner = make_sharded_inner_loop(model, mesh, par.inner_iterlim)
            sol, info = admm_two_level(model, sol, run_inner=run_inner)
        elif verbose > 0:
            # host outer loop: one line per outer iteration
            sol, info = admm_two_level(model, sol)
        else:
            # production path: entire solve in one dispatch
            sol, info = admm_two_level_fused(model, sol)

        if use_projection:
            from ..models.pf.projection import pf_projection
            sol, proj_info = pf_projection(data, model, sol, verbose=verbose)
            info.time_projection = proj_info.get("time", 0.0)
            info.pf_residual = proj_info.get("pf_residual")

    del init_sol
    env = AdmmEnv(case=case, data=data, initial_rho_pq=rho_pq,
                  initial_rho_va=rho_va, params=par,
                  tight_factor=tight_factor, use_linelimit=use_linelimit,
                  use_projection=use_projection)
    return SolveResult(data=data, model=model, solution=sol, info=info, env=env)


class _nullcontext:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


def solve_acopf_from_env(env, **overrides):
    """Re-run a solve from a recorded :class:`AdmmEnv`.

    AdmmEnv is the provenance record every interface attaches to its result
    (reference AdmmEnv, environment.jl:85-158); this makes it runnable —
    ``solve_acopf_from_env(res.env)`` reproduces ``res`` (same case, rho
    seeds, flags, and Parameters), with keyword ``overrides`` applied on
    top."""
    par = env.params
    kwargs = dict(
        rho_pq=env.initial_rho_pq,
        rho_va=env.initial_rho_va,
        use_linelimit=env.use_linelimit,
        use_projection=env.use_projection,
        tight_factor=env.tight_factor,
        outer_iterlim=par.outer_iterlim,
        inner_iterlim=par.inner_iterlim,
        obj_scale=par.obj_scale,
        scale=par.scale,
        outer_eps=par.outer_eps,
        initial_beta=par.initial_beta,
        theta=par.theta,
        inc_c=par.inc_c,
        verbose=par.verbose,
        # backend/cap knobs change the trajectory (truncation, reduction
        # order) — a recorded run with non-default values must re-solve with
        # the same ones
        tron_step_cap=par.tron_step_cap,
        branch_backend=par.branch_backend,
        pallas_tile=par.pallas_tile,
        bus_backend=par.bus_backend,
        mixed_precision=par.mixed_precision,
    )
    kwargs.update(overrides)
    return solve_acopf(env.case, **kwargs)
