"""ACOPF model: variable layout, initial solution, and the iteration hooks.

Equivalent of reference ``ModelAcopf`` + ``init_solution!``
(``/root/reference/src/models/acopf/acopf_model.jl``,
``acopf_init_solution_cpu.jl``) in functional form. The flat interleaved
nvar-vector becomes the structured :class:`~exaadmm_tpu.utils.environment.
Blocks` pytree; ``nvar`` (2 ngen + 8 nline, unpadded) is kept for the
tolerance scalings sqrt(nvar)*eps used by the drivers.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from ...utils.environment import Blocks, BranchALMState, Parameters, Solution
from ...utils.grid_data import GridData, build_grid_data
from ...utils.opfdata import OPFData
from . import kernels
from .branch import branch_update


@dataclasses.dataclass
class ModelAcopf:
    # the driver may difficulty-sort the line batch between outer iterations
    # (all line state is permuted consistently; see Parameters.sort_lines)
    supports_line_sort = True

    grid: GridData
    par: Parameters
    use_linelimit: bool = True
    # ramp-tightened bounds for rolling horizon (acopf_model.jl:60-63)
    pgmin_curr: jnp.ndarray | None = None
    pgmax_curr: jnp.ndarray | None = None

    def __post_init__(self):
        if self.pgmin_curr is None:
            self.pgmin_curr = self.grid.pgmin
        if self.pgmax_curr is None:
            self.pgmax_curr = self.grid.pgmax

    @property
    def nvar(self) -> int:
        return 2 * self.grid.ngen + 8 * self.grid.nline

    # effective (obj_scale-multiplied) cost coefficients used by kernels
    @property
    def c2_eff(self):
        return self.grid.c2 * self.par.obj_scale

    @property
    def c1_eff(self):
        return self.grid.c1 * self.par.obj_scale

    # ---- hook protocol used by the ADMM drivers ----
    def default_Pd(self):
        return self.grid.Pd

    def default_Qd(self):
        return self.grid.Qd

    def inner_prestep(self, sol):
        return sol.replace(z_prev=sol.z)

    def update_x(self, sol, inner_iter, axis_name=None, pg_bounds=None):
        return update_x(self, sol, inner_iter, axis_name=axis_name,
                        pg_bounds=pg_bounds)

    def update_xbar(self, sol, Pd=None, Qd=None, axis_name=None):
        return update_xbar(self, sol, Pd=Pd, Qd=Qd, axis_name=axis_name)

    def update_z(self, sol, beta):
        return update_z(self, sol, beta)

    def update_l(self, sol, beta):
        return update_l(self, sol, beta)

    def update_lz(self, sol, beta):
        return update_lz(self, sol, beta)

    def update_residual(self, sol, beta, axis_name=None):
        return update_residual(self, sol, beta, axis_name=axis_name)


def build_model(
    data: OPFData,
    par: Parameters,
    *,
    use_linelimit: bool = True,
    tight_factor: float = 1.0,
    pad_lines_to: int = 1,
    sort_lines_static: bool = False,
    dtype=jnp.float64,
) -> ModelAcopf:
    gd = build_grid_data(
        data, tight_factor=tight_factor, pad_lines_to=pad_lines_to,
        sort_lines_static=sort_lines_static, dtype=dtype
    )
    model = ModelAcopf(grid=gd, par=par, use_linelimit=use_linelimit)
    if resolve_bus_backend(par) == "kr_win":
        # static windowed-KR setup needs concrete ids: compute at build time
        # (inside a jit trace they are tracers; replaced/sharded models fall
        # back to the dense kr form via update_xbar)
        model._kr_win_setup = kernels.build_kr_window_setup(
            gd.line_from, gd.line_to, gd.nbus)
    return model


def init_solution(model: ModelAcopf, rho_pq: float, rho_va: float) -> Solution:
    """Flat start (acopf_init_solution_cpu.jl:8-58).

    rho = rho_pq everywhere except the line (wi, wj, thi, thj) rows = rho_va;
    v gens at bound midpoints; v lines from w0 = (Vmax^2+Vmin^2)/2 pushed
    through the branch admittances.
    """
    gd = model.grid
    dtype = gd.pgmin.dtype
    sol = Solution.zeros(gd.ngen, gd.nline_padded, dtype)

    rho_line = jnp.concatenate(
        [
            jnp.full((gd.nline_padded, 4), rho_pq, dtype),
            jnp.full((gd.nline_padded, 4), rho_va, dtype),
        ],
        axis=-1,
    )
    rho = Blocks(gen=jnp.full((gd.ngen, 2), rho_pq, dtype), line=rho_line)

    v_gen = jnp.stack(
        [0.5 * (gd.pgmin + gd.pgmax), 0.5 * (gd.qgmin + gd.qgmax)], axis=-1
    )

    wij0 = 0.5 * (gd.Vmax[gd.line_from] ** 2 + gd.Vmin[gd.line_from] ** 2)
    wji0 = 0.5 * (gd.Vmax[gd.line_to] ** 2 + gd.Vmin[gd.line_to] ** 2)
    wR0 = jnp.sqrt(wij0 * wji0)
    zero = jnp.zeros_like(wij0)
    v_line = jnp.stack(
        [
            gd.YffR * wij0 + gd.YftR * wR0,
            -gd.YffI * wij0 - gd.YftI * wR0,
            gd.YttR * wji0 + gd.YtfR * wR0,
            -gd.YttI * wji0 - gd.YtfI * wR0,
            wij0,
            wji0,
            zero,
            zero,
        ],
        axis=-1,
    ) * gd.line_mask[:, None]

    return sol.replace(
        rho=rho,
        v=Blocks(gen=v_gen, line=v_line),
        branch_alm=BranchALMState.zeros(gd.nline_padded, dtype),
    )


# ---------------------------------------------------------------------------
# iteration hooks (the "11-hook protocol" of the reference, docs/src/dev.md),
# here as pure functions composed by the drivers
# ---------------------------------------------------------------------------

def update_x(model: ModelAcopf, sol: Solution, inner_iter, axis_name=None,
             pg_bounds=None):
    """x update: closed-form generators + batched branch TRON/ALM."""
    gd = model.grid
    pgmin, pgmax = pg_bounds if pg_bounds is not None else (
        model.pgmin_curr, model.pgmax_curr)
    u_gen = kernels.generator_update(
        sol.u.gen, sol.v.gen, sol.z.gen, sol.l.gen, sol.rho.gen,
        pgmin, pgmax, gd.qgmin, gd.qgmax,
        model.c2_eff, model.c1_eff, gd.baseMVA,
    )
    u_line, alm, stats = branch_update(
        sol, gd, model.par, inner_iter, use_linelimit=model.use_linelimit,
        axis_name=axis_name,
    )
    return sol.replace(u=Blocks(gen=u_gen, line=u_line), branch_alm=alm), stats


def resolve_bus_backend(par):
    """The bus scatter backend of ``Parameters.bus_backend``: "auto"
    resolves to the exact ``segment_sum`` scatter ("segsum"); explicit
    "kr" / "kr_win" select the Khatri-Rao matmul forms.

    On an H100 (700 W) the fused solver at synth-9241 fp32 ran 3995.6
    steady-state inner it/s with segsum against 3431.9 with the windowed KR
    form (chip_smoke phase d): the GPU's atomic scatter-add is one pass over
    the 2 x nline x 8 contributions, where the windowed form pays a 2N-row
    gather and three bf16 matmul passes. Callers without a precomputed
    static window setup (sharded local models, vmapped multi-period bus
    updates) fall back from "kr_win" to the dense "kr" form at the call
    site."""
    bb = getattr(par, "bus_backend", "auto")
    return "segsum" if bb == "auto" else bb


def update_xbar(model: ModelAcopf, sol: Solution, Pd=None, Qd=None, axis_name=None):
    bb = resolve_bus_backend(model.par)
    setup = getattr(model, "_kr_win_setup", None)
    if bb == "kr_win" and setup is not None and not (
            setup.get("_fr_ref") is model.grid.line_from
            and setup.get("_to_ref") is model.grid.line_to):
        # the static arc order was built for DIFFERENT line arrays (the
        # grid was permuted — sort_lines — or swapped since build): using
        # it would silently corrupt the bus aggregates
        setup = None
    if bb == "kr_win" and setup is None:
        # no (valid) precomputed static window setup (sharded local model,
        # permuted grid, or a degree spike at build): dense-KR fallback
        bb = "kr"
    v = kernels.bus_update(
        sol.u, sol.z, sol.l, sol.rho, model.grid,
        Pd=Pd, Qd=Qd, axis_name=axis_name,
        bus_backend=bb, kr_win_setup=setup)
    return sol.replace(v=v)


def update_z(model: ModelAcopf, sol: Solution, beta):
    z = kernels.z_update(sol.u, sol.v, sol.l, sol.rho, sol.lz, beta)
    return sol.replace(z=z)


def update_l(model: ModelAcopf, sol: Solution, beta):
    l = kernels.l_update(sol.z, sol.lz, beta)
    return sol.replace(l=l)


def update_lz(model: ModelAcopf, sol: Solution, beta):
    lz = kernels.lz_update(sol.z, sol.lz, beta, model.par.MAX_MULTIPLIER)
    return sol.replace(lz=lz)


def update_residual(model: ModelAcopf, sol: Solution, beta, axis_name=None):
    rp, rd, scalars = kernels.residual_update(sol, model.grid, beta,
                                              axis_name=axis_name)
    return sol.replace(rp=rp, rd=rd), scalars
