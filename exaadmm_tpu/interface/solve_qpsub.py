"""QP-subproblem solve (SQP inner iteration) — reference solve_qpsub.jl.

Takes the SQP-supplied QP data (Hs, linearized constraint rows 1h/1i/1j/1k,
delta bounds, shifted costs, residual loads) and runs one-level ADMM.
"""

from __future__ import annotations

import dataclasses

from ..algorithms.admm_one_level import admm_one_level
from ..models.qpsub import model as Q
from ..utils.environment import IterationInformation, Parameters
from ..utils.opfdata import opf_loaddata
from .solve_acopf import _default_dtype


@dataclasses.dataclass
class QpsubResult:
    data: object
    model: "Q.ModelQpsub"
    solution: "Q.SolutionQpsub"
    info: IterationInformation
    sqp_out: dict  # dpg/dqg/dline_var/dline_fl/dw/dtheta, dual_infeas, lambda


def solve_qpsub(
    case: str,
    Hs, LH_1h, RH_1h, LH_1i, RH_1i, LH_1j, RH_1j, LH_1k, RH_1k,
    ls, us, pgmax, pgmin, qgmax, qgmin, c1, c2, Pd, Qd,
    initial_beta: float = 1e5,
    *,
    case_format: str = "matpower",
    outer_iterlim: int = 20,
    inner_iterlim: int = 1000,
    rho_pq: float = 400.0,
    rho_va: float = 40000.0,
    obj_scale: float = 1.0,
    scale: float = 1e-4,
    use_linelimit: bool = True,
    tight_factor: float = 1.0,
    outer_eps: float = 2e-4,
    verbose: int = 1,
    onelevel: bool = True,
    use_projection: bool = False,
    dtype=None,
    mesh=None,
    pad_lines_to: int = 1,
    branch_backend: str = "auto",
    pallas_tile: int = 32,
    tron_step_cap: int | None = None,
    bus_backend: str = "auto",
) -> QpsubResult:
    """Pass ``mesh`` (a 1-D jax.sharding.Mesh) to shard the line batch and
    the per-line SQP data across devices (one-level solve in one shard_map
    dispatch)."""
    if not onelevel:
        raise NotImplementedError(
            "two-level ADMM is not implemented in QPsub (matches reference)")
    dtype = dtype or _default_dtype()
    data = opf_loaddata(case, case_format=case_format, verbose=verbose)
    if mesh is not None and pad_lines_to == 1:
        pad_lines_to = int(mesh.devices.size)

    par = Parameters(
        outer_iterlim=outer_iterlim, inner_iterlim=inner_iterlim,
        obj_scale=obj_scale, scale=scale, outer_eps=outer_eps,
        verbose=verbose, initial_beta=initial_beta, beta=initial_beta,
        branch_backend=branch_backend, pallas_tile=pallas_tile,
        tron_step_cap=tron_step_cap, bus_backend=bus_backend,
    )
    qp_inputs = dict(
        Hs=Hs, LH_1h=LH_1h, RH_1h=RH_1h, LH_1i=LH_1i, RH_1i=RH_1i,
        LH_1j=LH_1j, RH_1j=RH_1j, LH_1k=LH_1k, RH_1k=RH_1k,
        ls=ls, us=us, pgmax=pgmax, pgmin=pgmin, qgmax=qgmax, qgmin=qgmin,
        c1=c1, c2=c2, Pd=Pd, Qd=Qd,
    )
    model = Q.build_model(data, par, qp_inputs, use_linelimit=use_linelimit,
                          tight_factor=tight_factor,
                          pad_lines_to=pad_lines_to, dtype=dtype)
    sol = Q.init_solution(model, rho_pq, rho_va)
    run = None
    if mesh is not None:
        from ..parallel.sharding import make_sharded_one_level
        run = make_sharded_one_level(model, mesh)
    sol, info = admm_one_level(model, sol, run=run)
    sqp_out = Q.poststep(model, sol)
    if use_projection:
        # the reference's qpsub admm_poststep hooks the SAME generic
        # pf_projection as acopf (qpsub_admm_prepoststep_cpu.jl:16-19),
        # run on the final solution with the qpsub residual loads
        import numpy as np

        from ..models.pf.projection import pf_projection

        base, proj_info = pf_projection(
            data, model, sol.base,
            Pd=np.asarray(model.Pd), Qd=np.asarray(model.Qd),
            verbose=verbose)
        sol = sol.replace(base=base)
        info.time_projection = proj_info.get("time", 0.0)
        info.pf_residual = proj_info.get("pf_residual")
    return QpsubResult(data=data, model=model, solution=sol, info=info,
                       sqp_out=sqp_out)
