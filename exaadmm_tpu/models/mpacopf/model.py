"""Multi-period ACOPF (mpacopf): time periods coupled by generator ramping.

Reference: ``/root/reference/src/models/mpacopf/`` (ModelMpacopf,
mpacopf_model.jl:57-107). Structure: T single-period ACOPF problems plus, for
each t >= 2, per-generator ramp-coupling variables

    phat_{t-1,g}  — consensus copy of period (t-1)'s bus-side p_g
    s_{t,g}       — ramp slack in [-r_g, r_g]

with consensus  phat_{t-1} - vbar_{t-1}[pg] + z_r = 0  and the generator-local
equality  p_t - phat_{t-1} - s_t = 0  handled by a per-generator ALM
(mpacopf_auglag_generator_kernel_cpu.jl:18-131).

Design: the period axis is a BATCH axis. Within one inner ADMM iteration
every period's update reads only previous-iteration values of its neighbours
(the reference's sequential loop over t has no intra-iteration dependency), so:

- all T*nline branch NLPs solve as ONE flat TRON/ALM batch,
- all (T-1)*ngen 3-var ramp generator NLPs solve as a second flat batch,
- the bus update vmaps over periods (ramp terms enter via the optional
  ``ramp`` argument of the shared bus kernel),
- z/l/lz/residual are elementwise with a (T, ...) leading axis; the scalar
  aggregation is the reference's max-over-periods of per-period 2-norms
  (mpacopf_admm_update_residual_cpu.jl:42-48).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ...ops.tron_pallas import select_tron_solver
from ...utils.environment import (Blocks, BranchALMState, Parameters, Solution)
from ...utils.grid_data import GridData
from ...utils.opfdata import OPFData
from ...utils.pytree import pytree_dataclass
from ..acopf import kernels
from ..acopf import model as acopf_model
from ..acopf.branch import branch_update


@pytree_dataclass
class RampState:
    """Per-period ramp coupling state; all arrays (T, ngen), row 0 inert.

    Mirrors the reference ``SolutionRamping`` (mpacopf_model.jl:1-38) plus the
    per-generator ALM state the reference keeps in gen_membuf rows 7 (linear
    multiplier mu) and 8 (penalty xi).
    """

    u: jnp.ndarray       # phat_{t-1}
    l: jnp.ndarray
    rho: jnp.ndarray
    z: jnp.ndarray
    z_prev: jnp.ndarray
    lz: jnp.ndarray
    s: jnp.ndarray       # ramp slack
    alm_mu: jnp.ndarray  # ALM linear multiplier (gen_membuf row 7)
    alm_xi: jnp.ndarray  # ALM penalty (gen_membuf row 8)

    @staticmethod
    def zeros(T, ngen, dtype):
        z = lambda: jnp.zeros((T, ngen), dtype)  # noqa: E731
        return RampState(u=z(), l=z(), rho=z(), z=z(), z_prev=z(), lz=z(),
                         s=z(), alm_mu=z(),
                         alm_xi=jnp.full((T, ngen), 10.0, dtype))


@pytree_dataclass
class SolutionMpacopf:
    acopf: Solution      # Blocks with leading (T,) axis
    ramp: RampState

    # aliases used by the generic driver (z_prev handling & lz step go
    # through the model hooks, not these)
    @property
    def u(self):
        return self.acopf.u


@dataclasses.dataclass
class ModelMpacopf:
    grid: GridData
    par: Parameters
    T: int
    Pd: jnp.ndarray      # (T, nbus)
    Qd: jnp.ndarray
    use_linelimit: bool = True
    grid_T: GridData | None = None  # line arrays tiled T times (branch batch)
    pgmin_curr: jnp.ndarray | None = None
    pgmax_curr: jnp.ndarray | None = None

    def __post_init__(self):
        if self.pgmin_curr is None:
            self.pgmin_curr = self.grid.pgmin
        if self.pgmax_curr is None:
            self.pgmax_curr = self.grid.pgmax
        if self.grid_T is None:
            g = self.grid
            tile = lambda a: jnp.tile(a, (self.T,) + (1,) * (a.ndim - 1))  # noqa: E731
            self.grid_T = dataclasses.replace(
                g,
                nline=g.nline * self.T,
                nline_padded=g.nline_padded * self.T,
                YffR=tile(g.YffR), YffI=tile(g.YffI),
                YttR=tile(g.YttR), YttI=tile(g.YttI),
                YftR=tile(g.YftR), YftI=tile(g.YftI),
                YtfR=tile(g.YtfR), YtfI=tile(g.YtfI),
                rate_a=tile(g.rate_a),
                line_from=tile(g.line_from), line_to=tile(g.line_to),
                fr_vm_bound=tile(g.fr_vm_bound), to_vm_bound=tile(g.to_vm_bound),
                fr_va_bound=tile(g.fr_va_bound), to_va_bound=tile(g.to_va_bound),
                line_mask=tile(g.line_mask),
            )

    @property
    def nvar(self) -> int:
        base = 2 * self.grid.ngen + 8 * self.grid.nline
        return base + (self.grid.ngen if self.T > 1 else 0)

    # ---- sharding hooks (lines sharded on dim 1 of the (T, nline, 8) blocks)
    def solution_spec(self, axis):
        from jax.sharding import PartitionSpec as P
        lineP = P(None, axis)
        b = Blocks(gen=P(), line=P(None, axis, None))
        ac = Solution(
            u=b, v=b, l=b, rho=b, z=b, z_prev=b, lz=b, rp=b, rd=b,
            branch_alm=BranchALMState(lam1=lineP, lam2=lineP, mu=lineP),
        )
        rampP = P()
        ramp = RampState(u=rampP, l=rampP, rho=rampP, z=rampP, z_prev=rampP,
                         lz=rampP, s=rampP, alm_mu=rampP, alm_xi=rampP)
        return SolutionMpacopf(acopf=ac, ramp=ramp)

    def local_model(self, gd_local, pgmin, pgmax):
        return dataclasses.replace(
            self, grid=gd_local, grid_T=None,
            pgmin_curr=pgmin, pgmax_curr=pgmax)

    @property
    def c2_eff(self):
        return self.grid.c2 * self.par.obj_scale

    @property
    def c1_eff(self):
        return self.grid.c1 * self.par.obj_scale

    # ---- hook protocol ----
    def default_Pd(self):
        return self.Pd

    def default_Qd(self):
        return self.Qd

    def inner_prestep(self, sol: SolutionMpacopf):
        ac = sol.acopf.replace(z_prev=sol.acopf.z)
        return sol.replace(acopf=ac, ramp=sol.ramp.replace(z_prev=sol.ramp.z))

    # -- x update ---------------------------------------------------------
    def _ramp_alm_update(self, sol: SolutionMpacopf, inner_iter):
        """Batched 3-var ramp generator ALM for periods 2..T
        (mpacopf_auglag_generator_kernel_cpu.jl:18-131), x=(p_t, phat_{t-1},
        s_t) with the generator-local equality p_t - phat - s = 0.

        Runs through the same backend selection and lockstep step budget as
        the branch batch: unbounded XLA lockstep on this (T-1)*ngen batch was
        the mpacopf throughput cliff — each inner iteration dragged the whole
        batch through max-over-lanes ALM rounds of tiny (3, B) ops while the
        39k-line branch batch sat idle (~60ms of the measured 72ms/iter at
        synth-2869 T=8). fp64 (parity) runs keep the unbounded XLA path:
        step caps default to None and Pallas is fp32-only.
        """
        gd = self.grid
        T, ngen = self.T, gd.ngen
        ac, rp = sol.acopf, sol.ramp
        dtype = ac.u.gen.dtype
        B = (T - 1) * ngen

        def flat(a):  # (T-1, ngen) slices for t>=2
            return a[1:].reshape(B)

        lam_p = flat(ac.l.gen[..., 0])
        rho_p = flat(ac.rho.gen[..., 0])
        t_p = flat(ac.v.gen[..., 0] - ac.z.gen[..., 0])
        # consensus target for phat: previous period's v (mpacopf_auglag_
        # generator_kernel_cpu.jl:52 indexes r_v at the pg position)
        t_h = (ac.v.gen[:-1, :, 0].reshape(B) - flat(rp.z))
        lam_h = flat(rp.l)
        rho_h = flat(rp.rho)

        tile = lambda a: jnp.tile(a, (T - 1,))  # noqa: E731
        gparams = {
            "c2": tile(self.c2_eff), "c1": tile(self.c1_eff),
            "lam_p": lam_p, "rho_p": rho_p, "t_p": t_p,
            "lam_h": lam_h, "rho_h": rho_h, "t_h": t_h,
            "baseMVA": jnp.broadcast_to(jnp.asarray(gd.baseMVA, dtype), (B,)),
        }

        def gen_obj(x, p, lam, mu):
            f = p["c2"] * (x[0] * p["baseMVA"]) ** 2 + p["c1"] * (x[0] * p["baseMVA"])
            f = f + p["lam_p"] * (x[0] - p["t_p"]) + 0.5 * p["rho_p"] * (x[0] - p["t_p"]) ** 2
            f = f + p["lam_h"] * (x[1] - p["t_h"]) + 0.5 * p["rho_h"] * (x[1] - p["t_h"]) ** 2
            c = x[0] - x[1] - x[2]
            return f + lam[0] * c + 0.5 * mu * c * c

        def gen_cons(x, p):
            del p
            return (x[0] - x[1] - x[2],)

        xl = jnp.stack([tile(gd.pgmin), tile(gd.pgmin), -tile(gd.ramp_rate)], 0)
        xu = jnp.stack([tile(gd.pgmax), tile(gd.pgmax), tile(gd.ramp_rate)], 0)
        x0 = jnp.stack([
            jnp.clip(flat(ac.u.gen[..., 0]), xl[0], xu[0]),
            jnp.clip(flat(rp.u), xl[1], xu[1]),
            jnp.clip(flat(rp.s), xl[2], xu[2]),
        ], 0)

        eps = float(jnp.finfo(dtype).eps)
        xi0 = jnp.where(inner_iter <= 1, jnp.full((B,), 10.0, dtype),
                        flat(rp.alm_xi))
        _solver, extra = select_tron_solver(self.par, dtype)
        return _solver(
            gen_obj, gen_cons, x0, xl, xu, gparams,
            flat(rp.alm_mu)[None, :], xi0,
            gtol=max(self.par.tron_gtol, 40 * eps),
            frtol=max(self.par.tron_frtol, 10 * eps),
            ctol=max(self.par.alm_ctol, 300 * eps),
            # same dtype-aware conditioning cap as the branch batch
            # (models/acopf/branch.py): no-op in fp64 (0.1/eps ~ 4.5e14)
            mu_max=min(self.par.mu_max, 0.1 / eps),
            max_minor=self.par.tron_max_minor,
            max_auglag=self.par.max_auglag,
            step_cap=self.par.tron_step_cap,
            **extra,
        )

    def update_x(self, sol: SolutionMpacopf, inner_iter, axis_name=None,
                 pg_bounds=None):
        gd = self.grid
        T, ngen = self.T, gd.ngen
        ac, rp = sol.acopf, sol.ramp
        dtype = ac.u.gen.dtype

        # qg: closed form for ALL periods (reference does it inside both the
        # plain and the ALM generator kernels)
        lq, rq = ac.l.gen[..., 1], ac.rho.gen[..., 1]
        qg = jnp.clip((-(lq + rq * (-ac.v.gen[..., 1] + ac.z.gen[..., 1]))) / rq,
                      gd.qgmin, gd.qgmax)

        # pg period 1: plain closed form (standard ModelMpacopf dispatches the
        # single-period generator kernel for t=1)
        lp0, rp0 = ac.l.gen[0, :, 0], ac.rho.gen[0, :, 0]
        pg0 = jnp.clip(
            (-(self.c1_eff * gd.baseMVA + lp0
               + rp0 * (-ac.v.gen[0, :, 0] + ac.z.gen[0, :, 0])))
            / (2.0 * self.c2_eff * gd.baseMVA**2 + rp0),
            gd.pgmin, gd.pgmax,
        )

        # pg periods 2..T: batched 3-var ALM x=(p_t, phat_{t-1}, s_t)
        res = self._ramp_alm_update(sol, inner_iter)
        pg_rest = res.x[0].reshape(T - 1, ngen)
        phat = res.x[1].reshape(T - 1, ngen)
        s_new = res.x[2].reshape(T - 1, ngen)

        pg = jnp.concatenate([pg0[None], pg_rest], axis=0)
        u_gen = jnp.stack([pg, qg], axis=-1)

        pad0 = lambda a: jnp.concatenate(  # noqa: E731
            [jnp.zeros((1, ngen), dtype), a], axis=0)
        ramp_new = rp.replace(
            u=pad0(phat), s=pad0(s_new),
            alm_mu=pad0(res.lam[0].reshape(T - 1, ngen)),
            alm_xi=jnp.concatenate([rp.alm_xi[:1],
                                    res.mu.reshape(T - 1, ngen)], axis=0),
        )

        # lines: one flat (T*nline) TRON/ALM batch over the tiled grid
        # (local line count under shard_map differs from the static global
        # gd.nline_padded -> take it from the array)
        nlp = ac.u.line.shape[1]
        flat_sol = Solution(
            u=Blocks(gen=ac.u.gen[0], line=ac.u.line.reshape(T * nlp, 8)),
            v=Blocks(gen=ac.v.gen[0], line=ac.v.line.reshape(T * nlp, 8)),
            l=Blocks(gen=ac.l.gen[0], line=ac.l.line.reshape(T * nlp, 8)),
            rho=Blocks(gen=ac.rho.gen[0], line=ac.rho.line.reshape(T * nlp, 8)),
            z=Blocks(gen=ac.z.gen[0], line=ac.z.line.reshape(T * nlp, 8)),
            z_prev=Blocks(gen=ac.z_prev.gen[0],
                          line=ac.z_prev.line.reshape(T * nlp, 8)),
            lz=Blocks(gen=ac.lz.gen[0], line=ac.lz.line.reshape(T * nlp, 8)),
            rp=Blocks(gen=ac.rp.gen[0], line=ac.rp.line.reshape(T * nlp, 8)),
            rd=Blocks(gen=ac.rd.gen[0], line=ac.rd.line.reshape(T * nlp, 8)),
            branch_alm=BranchALMState(
                lam1=ac.branch_alm.lam1.reshape(T * nlp),
                lam2=ac.branch_alm.lam2.reshape(T * nlp),
                mu=ac.branch_alm.mu.reshape(T * nlp),
            ),
        )
        u_line_flat, alm_flat, stats = branch_update(
            flat_sol, self.grid_T, self.par, inner_iter,
            use_linelimit=self.use_linelimit, axis_name=axis_name,
        )
        # (T*nline,)-shaped; this model doesn't do line sorting — drop it so
        # the carry keeps its (possibly empty) placeholder shape
        stats = {k: v for k, v in stats.items() if k != "lane_steps"}
        ac_new = ac.replace(
            u=Blocks(gen=u_gen, line=u_line_flat.reshape(T, nlp, 8)),
            branch_alm=BranchALMState(
                lam1=alm_flat.lam1.reshape(T, nlp),
                lam2=alm_flat.lam2.reshape(T, nlp),
                mu=alm_flat.mu.reshape(T, nlp),
            ),
        )
        return sol.replace(acopf=ac_new, ramp=ramp_new), stats

    # -- xbar -------------------------------------------------------------
    def update_xbar(self, sol: SolutionMpacopf, Pd=None, Qd=None, axis_name=None):
        gd = self.grid
        ac, rp = sol.acopf, sol.ramp
        if Pd is None:
            Pd = self.Pd
        if Qd is None:
            Qd = self.Qd
        T, ngen = self.T, gd.ngen
        dtype = ac.u.gen.dtype

        # ramp terms for bus period t come from period t+1's coupling
        # (mpacopf_admm_update_xbar_cpu.jl: sol_ramp = mod.solution[i+1]);
        # period T gets zeros => plain bus kernel
        z1 = jnp.zeros((1, ngen), dtype)
        shift = lambda a: jnp.concatenate([a[1:], z1], axis=0)  # noqa: E731
        ramp_args = {
            "u": shift(rp.u), "z": shift(rp.z),
            "l": shift(rp.l), "rho": shift(rp.rho),
        }

        from ..acopf.model import resolve_bus_backend
        bb = resolve_bus_backend(self.par)
        if bb == "kr_win":
            bb = "kr"  # vmapped over periods; no static window setup here

        def one_period(u, z, l, rho, pd, qd, ramp):
            return kernels.bus_update(u, z, l, rho, gd, Pd=pd, Qd=qd, ramp=ramp,
                                      axis_name=axis_name, bus_backend=bb)

        v = jax.vmap(one_period)(ac.u, ac.z, ac.l, ac.rho, Pd, Qd, ramp_args)
        return sol.replace(acopf=ac.replace(v=v))

    # -- z / l / lz -------------------------------------------------------
    def _v_pg_prev(self, ac):
        """v[pg] of the previous period, aligned to ramp row t (t>=1)."""
        ngen = self.grid.ngen
        dtype = ac.v.gen.dtype
        return jnp.concatenate(
            [jnp.zeros((1, ngen), dtype), ac.v.gen[:-1, :, 0]], axis=0)

    def _ramp_mask(self, dtype):
        m = jnp.ones((self.T, 1), dtype)
        return m.at[0, 0].set(0.0)

    def update_z(self, sol: SolutionMpacopf, beta):
        ac, rp = sol.acopf, sol.ramp
        z_ac = kernels.z_update(ac.u, ac.v, ac.l, ac.rho, ac.lz, beta)
        vprev = self._v_pg_prev(ac)
        safe_rho = jnp.where(rp.rho > 0, rp.rho, 1.0)
        z_r = (-(rp.lz + rp.l + safe_rho * (rp.u - vprev))) / (beta + safe_rho)
        z_r = z_r * self._ramp_mask(z_r.dtype)
        return sol.replace(acopf=ac.replace(z=z_ac), ramp=rp.replace(z=z_r))

    def update_l(self, sol: SolutionMpacopf, beta):
        ac, rp = sol.acopf, sol.ramp
        l_ac = kernels.l_update(ac.z, ac.lz, beta)
        l_r = -(rp.lz + beta * rp.z) * self._ramp_mask(rp.z.dtype)
        return sol.replace(acopf=ac.replace(l=l_ac), ramp=rp.replace(l=l_r))

    def update_lz(self, sol: SolutionMpacopf, beta):
        ac, rp = sol.acopf, sol.ramp
        lz_ac = kernels.lz_update(ac.z, ac.lz, beta, self.par.MAX_MULTIPLIER)
        lz_r = jnp.clip(rp.lz + beta * rp.z,
                        -self.par.MAX_MULTIPLIER, self.par.MAX_MULTIPLIER)
        return sol.replace(acopf=ac.replace(lz=lz_ac), ramp=rp.replace(lz=lz_r))

    # -- residual ---------------------------------------------------------
    def update_residual(self, sol: SolutionMpacopf, beta, axis_name=None):
        gd = self.grid
        ac, rp = sol.acopf, sol.ramp
        m = gd.line_mask

        rp_b = jax.tree.map(lambda u, v, z: u - v + z, ac.u, ac.v, ac.z)
        rd_b = jax.tree.map(lambda zc, zp: zc - zp, ac.z, ac.z_prev)
        ax_by = jax.tree.map(lambda a, b: a - b, rp_b, ac.z)

        def per_period_sq(b: Blocks):
            line_sq = jnp.sum(b.line**2 * m[None, :, None], axis=(1, 2))
            if axis_name is not None:
                line_sq = jax.lax.psum(line_sq, axis_name)
            return jnp.sum(b.gen**2, axis=(1, 2)) + line_sq

        mask = self._ramp_mask(rp.z.dtype)
        vprev = self._v_pg_prev(ac)
        rp_r = (rp.u - vprev + rp.z) * mask
        rd_r = (rp.z - rp.z_prev) * mask
        z_r = rp.z * mask

        # per-period 2-norms with ramp coupling folded into the later period,
        # aggregated by max over periods (mpacopf_admm_update_residual_cpu.jl)
        primres = jnp.max(jnp.sqrt(per_period_sq(rp_b) + jnp.sum(rp_r**2, 1)))
        dualres = jnp.max(jnp.sqrt(per_period_sq(rd_b) + jnp.sum(rd_r**2, 1)))
        norm_z = jnp.max(jnp.sqrt(per_period_sq(ac.z) + jnp.sum(z_r**2, 1)))
        mismatch = jnp.max(jnp.sqrt(per_period_sq(ax_by)
                                    + jnp.sum((rp_r - z_r)**2, 1)))

        pg = gd.baseMVA * ac.u.gen[..., 0]
        objval = jnp.sum(gd.c2[None] * pg**2 + gd.c1[None] * pg + gd.c0[None])

        scalars = {
            "primres": primres, "dualres": dualres,
            "norm_z_curr": norm_z, "mismatch": mismatch,
            "objval": objval, "auglag": objval,
        }
        return sol.replace(acopf=ac.replace(rp=rp_b, rd=rd_b)), scalars


def build_model(
    data: OPFData, par: Parameters, pd_mat, qd_mat, *,
    start_period=1, end_period=1, use_linelimit=True,
    tight_factor=1.0, dtype=jnp.float64,
) -> ModelMpacopf:
    from ...utils.grid_data import build_grid_data

    gd = build_grid_data(data, tight_factor=tight_factor, dtype=dtype)
    T = end_period - start_period + 1
    Pd = jnp.asarray(pd_mat[:, start_period - 1:end_period].T, dtype)
    Qd = jnp.asarray(qd_mat[:, start_period - 1:end_period].T, dtype)
    return ModelMpacopf(grid=gd, par=par, T=T, Pd=Pd, Qd=Qd,
                        use_linelimit=use_linelimit)


def init_solution(model: ModelMpacopf, rho_pq, rho_va,
                  warm=None) -> SolutionMpacopf:
    """Flat start per period + ramp state (mpacopf_init_solution_cpu.jl:1-19).

    ``warm``: optional list/stack of per-period single-period Solutions from a
    warm-start pass; when given, the period states are KEPT (the reference
    resets them — see solve_mpacopf notes) and ramp vars derive from them.
    """
    gd = model.grid
    T = model.T
    dtype = gd.pgmin.dtype

    if warm is None:
        single = acopf_model.ModelAcopf(grid=gd, par=model.par,
                                        use_linelimit=model.use_linelimit)
        s1 = acopf_model.init_solution(single, rho_pq, rho_va)
        ac = jax.tree.map(lambda a: jnp.broadcast_to(a, (T,) + a.shape), s1)
    else:
        ac = jax.tree.map(lambda *xs: jnp.stack(xs, axis=0), *warm)

    ramp = RampState.zeros(T, gd.ngen, dtype)
    ramp = ramp.replace(rho=jnp.full((T, gd.ngen), rho_pq, dtype))
    # u_r[t] = v_{t-1}[pg]; s[t] = u_t[pg] - u_r[t]
    u_r = jnp.concatenate(
        [jnp.zeros((1, gd.ngen), dtype), ac.v.gen[:-1, :, 0]], axis=0)
    s = (ac.u.gen[:, :, 0] - u_r).at[0].set(0.0)
    ramp = ramp.replace(u=u_r, s=s)
    return SolutionMpacopf(acopf=ac, ramp=ramp)


def check_ramp_violations(model: ModelMpacopf, sol: SolutionMpacopf):
    """max over t>=2, g of (|pg_t - pg_{t-1}| - r_g)_+ (prepoststep :40-47)."""
    pg = sol.acopf.u.gen[:, :, 0]
    if model.T == 1:
        return 0.0
    viol = jnp.abs(pg[1:] - pg[:-1]) - model.grid.ramp_rate[None]
    return float(jnp.max(jnp.maximum(viol, 0.0)))
