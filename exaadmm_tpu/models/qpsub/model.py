"""QP subproblem model (qpsub) — ADMM as the QP solver inside an outer SQP.

Reference: ``/root/reference/src/models/qpsub/`` (structure documented at
qpsub_model.jl:8-31). Variables are deltas around an SQP base point; the
nonconvex line physics is replaced by:

- an SQP-supplied 6x6 Hessian ``Hs`` per line over
  (w_ijR, w_ijI, w_i, w_j, th_i, th_j),
- two linearized equalities 1h (voltage product) and 1i (angle consistency)
  with rows ``LH_1h/RH_1h``, ``LH_1i/RH_1i`` — eliminated exactly by solving
  the 2x2 system for (w_ijR, w_ijI), giving an affine lift y8 = C x + d onto
  the ExaTron ordering (t_ij, t_ji, w_ijR, w_ijI, w_i, w_j, th_i, th_j)
  (qpsub_eval_Ab_linelimit_kernel_cpu.jl: eval_*_red),
- linearized line limits 1j/1k with slacks t >= 0, handled by a per-line ALM
  (qpsub_auglag_Ab_linelimit_kernel_red_cpu.jl).

Uses ONE-LEVEL ADMM (solve_qpsub.jl:120-124). Design: the per-line box
QPs solve as one flat TRON/ALM batch over the reduced 6 variables — the
objective is quadratic, so the autodiff Hessian is exact and Newton steps
land in one TR iteration; the w elimination and the 1j/1k constraint rows are
precomputed (C, d, vec_1j, vec_1k) at model build.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ...ops.tron_pallas import select_tron_solver
from ...utils.environment import Blocks, Parameters, Solution
from ...utils.grid_data import GridData, build_grid_data
from ...utils.opfdata import OPFData
from ...utils.pytree import pytree_dataclass
from ..acopf import kernels


@pytree_dataclass
class SolutionQpsub:
    base: Solution            # u/v/l/rho/z/lz blocks (z unused: one-level)
    sqp_line: jnp.ndarray     # (nline, 6) line deltas in Hs ordering
    v_prev: Blocks            # for the Boyd dual residual
    alm_lam_j: jnp.ndarray    # (nline,) lambda_1j (membuf row 3)
    alm_lam_k: jnp.ndarray    # (nline,) lambda_1k (membuf row 4)
    alm_mu: jnp.ndarray       # (nline,) shared ALM penalty (membuf row 5)

    @property
    def u(self):
        return self.base.u


@dataclasses.dataclass
class ModelQpsub:
    grid: GridData
    par: Parameters
    # SQP inputs (jnp):
    Hs: jnp.ndarray          # (nline, 6, 6)
    LH_1h: jnp.ndarray       # (nline, 4)
    RH_1h: jnp.ndarray       # (nline,)
    LH_1i: jnp.ndarray
    RH_1i: jnp.ndarray
    LH_1j: jnp.ndarray       # (nline, 2)
    RH_1j: jnp.ndarray
    LH_1k: jnp.ndarray
    RH_1k: jnp.ndarray
    ls: jnp.ndarray          # (nline, 6)
    us: jnp.ndarray
    c1: jnp.ndarray          # shifted gen cost (qpsub_c1)
    c2: jnp.ndarray
    pgmin: jnp.ndarray       # delta bounds (qpsub_pgmin ...)
    pgmax: jnp.ndarray
    qgmin: jnp.ndarray
    qgmax: jnp.ndarray
    Pd: jnp.ndarray          # residual loads (qpsub_Pd/Qd)
    Qd: jnp.ndarray
    line_res: jnp.ndarray | None = None  # (nline, 4) flow residuals
    # use_linelimit=False drops the 1j/1k slack rows and their ALM loop —
    # the reference's n=4 branch kernel (qpsub_model.jl:135)
    use_linelimit: bool = True

    # derived (filled in __post_init__)
    C: jnp.ndarray | None = None       # (nline, 8, 6) elimination lift
    dvec: jnp.ndarray | None = None    # (nline, 8)
    supY8: jnp.ndarray | None = None   # (nline, 4, 8) flow rows
    vec_1j: jnp.ndarray | None = None  # (nline, 8)
    vec_1k: jnp.ndarray | None = None
    # solve-constant reduced-QP pieces (A_br, G, w, e depend only on model
    # data + rho, and one-level ADMM never changes rho): computed once by
    # one_level_reset so they sit OUTSIDE the solve's while_loop instead of
    # being rebuilt by every iteration's update_x (XLA cannot hoist them
    # itself — rho lives in the loop carry). None => inline recompute
    # (sharded local models guard on the batch size and recompute locally).
    _qp_cache: dict | None = dataclasses.field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        gd = self.grid
        nl = gd.nline_padded
        if self.line_res is None:
            self.line_res = jnp.zeros((nl, 4), self.Hs.dtype)
        if self.C is not None:
            # derived arrays supplied directly (dataclasses.replace inside a
            # sharded trace, where the numpy precompute below cannot run)
            return
        # supY in the 8-dim ExaTron ordering (eval_A_auglag_..., rows pij qij
        # pji qji over [t_ij t_ji wijR wijI wi wj thi thj])
        z = np.zeros(nl)
        Y = [np.asarray(a, np.float64) for a in
             (gd.YftR, gd.YftI, gd.YffR, gd.YffI, gd.YtfR, gd.YtfI,
              gd.YttR, gd.YttI)]
        YftR, YftI, YffR, YffI, YtfR, YtfI, YttR, YttI = Y
        supY8 = np.stack([
            np.stack([z, z, YftR, YftI, YffR, z, z, z], -1),
            np.stack([z, z, -YftI, YftR, -YffI, z, z, z], -1),
            np.stack([z, z, YtfR, -YtfI, z, YttR, z, z], -1),
            np.stack([z, z, -YtfI, -YtfR, z, -YttI, z, z], -1),
        ], axis=1)  # (nl, 4, 8)

        LH_1h = np.asarray(self.LH_1h, np.float64)
        LH_1i = np.asarray(self.LH_1i, np.float64)
        LH_1j = np.asarray(self.LH_1j, np.float64)
        LH_1k = np.asarray(self.LH_1k, np.float64)
        RH_1h = np.asarray(self.RH_1h, np.float64)
        RH_1i = np.asarray(self.RH_1i, np.float64)

        # 2x2 elimination of (w_ijR, w_ijI):
        #   [LH_1h[0] LH_1h[1]; LH_1i[0] LH_1i[1]] w = RH - LH[2:4] rest
        M = np.stack([LH_1h[:, :2], LH_1i[:, :2]], axis=1)  # (nl, 2, 2)
        det = M[:, 0, 0] * M[:, 1, 1] - M[:, 0, 1] * M[:, 1, 0]
        det = np.where(np.abs(det) > 1e-30, det, 1.0)
        Minv = (np.stack([
            np.stack([M[:, 1, 1], -M[:, 0, 1]], -1),
            np.stack([-M[:, 1, 0], M[:, 0, 0]], -1),
        ], axis=1) / det[:, None, None])
        # rest-dependence rows: 1h on (wi, wj) at cols 2,3 of the 6-var
        # reduced ordering (t_ij, t_ji, wi, wj, thi, thj); 1i on (thi, thj)
        R = np.zeros((nl, 2, 6))
        R[:, 0, 2] = LH_1h[:, 2]
        R[:, 0, 3] = LH_1h[:, 3]
        R[:, 1, 4] = LH_1i[:, 2]
        R[:, 1, 5] = LH_1i[:, 3]
        C_ij = -np.einsum("lab,lbk->lak", Minv, R)  # (nl, 2, 6)
        d_ij = np.einsum("lab,lb->la", Minv,
                         np.stack([RH_1h, RH_1i], -1))

        C = np.zeros((nl, 8, 6))
        C[:, 0, 0] = 1.0
        C[:, 1, 1] = 1.0
        C[:, 2:4, :] = C_ij
        C[:, 4, 2] = 1.0
        C[:, 5, 3] = 1.0
        C[:, 6, 4] = 1.0
        C[:, 7, 5] = 1.0
        d = np.zeros((nl, 8))
        d[:, 2:4] = d_ij

        e0 = np.zeros((nl, 8)); e0[:, 0] = 1.0
        e1 = np.zeros((nl, 8)); e1[:, 1] = 1.0
        vec_1j = e0 + LH_1j[:, 0:1] * supY8[:, 0] + LH_1j[:, 1:2] * supY8[:, 1]
        vec_1k = e1 + LH_1k[:, 0:1] * supY8[:, 2] + LH_1k[:, 1:2] * supY8[:, 3]

        dt = self.Hs.dtype
        self.C = jnp.asarray(C, dt)
        self.dvec = jnp.asarray(d, dt)
        self.supY8 = jnp.asarray(supY8, dt)
        self.vec_1j = jnp.asarray(vec_1j, dt)
        self.vec_1k = jnp.asarray(vec_1k, dt)

    @property
    def nvar(self) -> int:
        return 2 * self.grid.ngen + 8 * self.grid.nline

    # ---- sharding hooks ---------------------------------------------------
    # line-indexed model arrays (leading nline_padded axis), sharded with the
    # line partition by parallel.sharding.make_sharded_one_level
    LINE_FIELDS = ("Hs", "LH_1h", "RH_1h", "LH_1i", "RH_1i", "LH_1j", "RH_1j",
                   "LH_1k", "RH_1k", "ls", "us", "line_res",
                   "C", "dvec", "supY8", "vec_1j", "vec_1k")

    def solution_spec(self, axis):
        from jax.sharding import PartitionSpec as P

        from ...parallel.sharding import blocks_specs, solution_specs
        return SolutionQpsub(
            base=solution_specs(axis),
            sqp_line=P(axis),
            v_prev=blocks_specs(axis),
            alm_lam_j=P(axis), alm_lam_k=P(axis), alm_mu=P(axis),
        )

    # ---- hook protocol (one-level) --------------------------------------
    def rho_norm(self, sol: SolutionQpsub):
        from ...utils.environment import blocks_norm
        return float(blocks_norm(sol.base.rho, self.grid.line_mask))

    def one_level_reset(self, sol: SolutionQpsub) -> SolutionQpsub:
        zero = jax.tree.map(jnp.zeros_like, sol.base.z)
        return sol.replace(base=sol.base.replace(
            z=zero, z_prev=zero, lz=jax.tree.map(jnp.zeros_like, sol.base.lz)))

    def solve_prep(self, sol: SolutionQpsub) -> "ModelQpsub":
        """Driver hook (admm_one_level calls this INSIDE the jitted solve,
        before the while_loop): returns a model carrying the rho-only QP
        constants as loop-invariant values. Computing them from the actual
        solve's rho makes the cache correct for ANY runtime rho (a stale
        eager cache would silently solve the wrong QP if a pre-built run
        were reused with different rho); being outside the while_loop, XLA
        hoists them — ~2x measured on the fused qpsub solve at synth-9241.
        """
        return dataclasses.replace(
            self, _qp_cache=_qp_solve_constants(self, sol.base.rho.line))

    def update_x(self, sol: SolutionQpsub, inner_iter, axis_name=None,
                 pg_bounds=None):
        gd = self.grid
        b = sol.base
        u_gen = kernels.generator_update(
            b.u.gen, b.v.gen, b.z.gen, b.l.gen, b.rho.gen,
            self.pgmin, self.pgmax, self.qgmin, self.qgmax,
            self.c2, self.c1, gd.baseMVA,
        )

        # ---- batched reduced branch QP + ALM on 1j/1k ----
        # local line count (differs from gd.nline_padded under shard_map)
        nl = b.u.line.shape[0]
        dt = b.u.gen.dtype
        lL, rL = b.l.line, b.rho.line
        vz = b.v.line - b.z.line

        # b_br = sum_k (l_k - rho_k (v_k - z_k - res_k)) supY6_k + rows 4..7
        # (the only iteration-varying piece of the reduced QP)
        supY6 = self.supY8[:, :, 2:]            # (nl, 4, 6)
        coef = lL[:, :4] - rL[:, :4] * (vz[:, :4] - self.line_res)
        b_br = jnp.einsum("lk,lki->li", coef, supY6)
        b_br = b_br + jnp.concatenate(
            [jnp.zeros((nl, 2), dt), lL[:, 4:] - rL[:, 4:] * vz[:, 4:]], axis=1)

        # Reduced QP: with y = C x + d, z6 = y[2:],
        #   f0(x) = 1/2 z6' A z6 + b' z6 = 1/2 x' G x + h0' x + fc,
        # and the 1j/1k rows are AFFINE in x: c = w' x + e. The TRON solver
        # evaluates f/grad/Hessian in closed form (qp_fgh below) instead of
        # 1 reverse + 6 forward-over-reverse autodiff passes per TR step —
        # the same role as the reference's hand-coded QP evals
        # (qpsub_tron_linelimit_kernel.jl:125-170). G/Ad6/w/e depend only on
        # model data + rho (fixed through a one-level solve), so they come
        # from the one_level_reset cache when its batch matches; only
        # h0/fc fold in b_br per iteration.
        cache = self._qp_cache
        if cache is None or cache["GT"].shape[-1] != nl:
            cache = _qp_solve_constants(self, rL)
        params = _reduced_qp_params(self, cache, b_br, nl, dt)

        qp_obj, qp_cons, qp_fgh = _reduced_qp_fns()

        big = jnp.full((nl,), 200000.0, dt)
        zerov = jnp.zeros((nl,), dt)
        # Without line limits the slack vars t_ij/t_ji are pinned at 0 and the
        # 1j/1k ALM never runs — equivalent to the reference's 4-var kernel.
        t_hi = big if self.use_linelimit else zerov
        xl = jnp.concatenate([zerov[None], zerov[None], self.ls[:, 2:].T])
        xu = jnp.concatenate([t_hi[None], t_hi[None], self.us[:, 2:].T])
        x0 = jnp.concatenate([zerov[None], zerov[None], sol.sqp_line[:, 2:].T])
        x0 = jnp.clip(x0, xl, xu)

        eps = float(jnp.finfo(dt).eps)
        mu0 = jnp.where(inner_iter <= 1, jnp.full((nl,), 10.0, dt), sol.alm_mu)
        lam0 = jnp.stack([sol.alm_lam_j, sol.alm_lam_k])
        if not self.use_linelimit:
            mu0 = jnp.zeros_like(mu0)
            lam0 = jnp.zeros_like(lam0)
        active0 = gd.line_mask > 0.5
        _solver, extra = select_tron_solver(self.par, dt)
        from ..acopf.branch import branch_alm_delta
        res = _solver(
            qp_obj, qp_cons, x0, xl, xu, params, lam0, mu0, **extra,
            gtol=max(self.par.tron_gtol, 40 * eps),
            frtol=max(self.par.tron_frtol, 10 * eps),
            ctol=max(self.par.alm_ctol, 300 * eps),
            mu_max=self.par.mu_max, max_minor=self.par.tron_max_minor,
            max_auglag=self.par.max_auglag if self.use_linelimit else 1,
            # lockstep budget: without it one straggler lane drives the whole
            # batch to max_auglag x max_minor steps (same role as in the
            # acopf branch kernel; ADMM re-enters next iteration with warm
            # multipliers, so truncation self-corrects)
            step_cap=self.par.tron_step_cap,
            active0=active0,
            fgh_fn=qp_fgh,
            alm_delta_fn=branch_alm_delta,
        )
        x = res.x                                    # (6, B)
        # lift back to the 8-dim ordering for flow recovery
        y = jnp.einsum("lij,jl->il", self.C, x) + self.dvec.T  # (8, B)
        sqp_line = jnp.transpose(y[2:])              # (B, 6) Hs ordering
        flows = jnp.einsum("lki,il->lk",
                           self.supY8, y) + self.line_res  # (B, 4)
        u_line = jnp.concatenate([flows, jnp.transpose(x[2:])], axis=1)
        u_line = jnp.where(active0[:, None], u_line, b.u.line)

        new = sol.replace(
            base=b.replace(u=Blocks(gen=u_gen, line=u_line)),
            sqp_line=jnp.where(active0[:, None], sqp_line, sol.sqp_line),
            alm_lam_j=res.lam[0], alm_lam_k=res.lam[1], alm_mu=res.mu,
        )
        sums = jnp.stack([
            jnp.sum(res.alm_iters * gd.line_mask),
            jnp.sum(res.minor_iters * gd.line_mask),
        ])
        if axis_name is not None:
            sums = jax.lax.psum(sums, axis_name)
        stats = {
            "avg_auglag_it": sums[0] / gd.nline,
            "avg_minor_it": sums[1] / gd.nline,
        }
        return new, stats

    def update_xbar(self, sol: SolutionQpsub, Pd=None, Qd=None, axis_name=None):
        from ..acopf.model import resolve_bus_backend
        b = sol.base
        bb = resolve_bus_backend(self.par)
        if bb == "kr_win":
            bb = "kr"  # no static window setup on this model
        v = kernels.bus_update(b.u, b.z, b.l, b.rho, self.grid,
                               Pd=self.Pd if Pd is None else Pd,
                               Qd=self.Qd if Qd is None else Qd,
                               axis_name=axis_name,
                               bus_backend=bb)
        return sol.replace(base=b.replace(v=v), v_prev=b.v)

    def update_l_single(self, sol: SolutionQpsub):
        b = sol.base
        l = jax.tree.map(lambda ll, uu, vv, rr: ll + rr * (uu - vv),
                         b.l, b.u, b.v, b.rho)
        return sol.replace(base=b.replace(l=l))

    def update_residual(self, sol: SolutionQpsub, beta, axis_name=None):
        del beta
        gd = self.grid
        b = sol.base
        m = gd.line_mask
        rp = jax.tree.map(lambda uu, vv: uu - vv, b.u, b.v)
        rd = jax.tree.map(lambda rr, vv, vp: rr * (vv - vp),
                          b.rho, b.v, sol.v_prev)

        # line-block partial sums, one stacked psum under shard_map
        line_parts = jnp.stack([
            jnp.sum(rp.line**2 * m[:, None]),
            jnp.sum(rd.line**2 * m[:, None]),
            0.5 * jnp.sum(jnp.einsum("li,lij,lj->l",
                                     sol.sqp_line, self.Hs, sol.sqp_line) * m),
            jnp.sum(b.l.line * rp.line * m[:, None])
            + 0.5 * jnp.sum(b.rho.line * rp.line**2 * m[:, None]),
        ])
        if axis_name is not None:
            line_parts = jax.lax.psum(line_parts, axis_name)

        primres = jnp.sqrt(jnp.sum(rp.gen**2) + line_parts[0])
        dualres = jnp.sqrt(jnp.sum(rd.gen**2) + line_parts[1])

        pg = gd.baseMVA * b.u.gen[:, 0]
        objval = jnp.sum(self.c2 * pg**2 + self.c1 * pg) + line_parts[2]

        auglag = objval + (
            jnp.sum(b.l.gen * rp.gen)
            + 0.5 * jnp.sum(b.rho.gen * rp.gen**2)
            + line_parts[3])

        scalars = {
            "primres": primres, "dualres": dualres, "mismatch": primres,
            "objval": objval, "auglag": auglag,
        }
        return sol.replace(base=b.replace(rp=rp, rd=rd)), scalars


def _qp_solve_constants(model: ModelQpsub, rho_line):
    """Rho-only pieces of the reduced per-line QP, hoisted out of the solve.

    With y = C x + d and z6 = y[2:] (C6 = C[2:, :], d6 = d[2:]):
      A  = Hs + sum_k rho_k supY6_k supY6_k' + diag(rho[4:8]) on rows 2..5
      G  = C6' A C6;  Ad6 = A d6
      c3 = w3' x + e3 with w3 = C' v1j, e3 = v1j' d - r1j  (c4 analogous)
    One-level ADMM never changes rho, so these are constant across the whole
    solve (reference counterpart rebuilds A per TR step,
    qpsub_eval_Ab_linelimit_kernel_cpu.jl:27-58).
    """
    nl = rho_line.shape[0]
    dt = rho_line.dtype
    supY6 = model.supY8[:, :, 2:]            # (nl, 4, 6)
    A_br = model.Hs + jnp.einsum("lk,lki,lkj->lij",
                                 rho_line[:, :4], supY6, supY6)
    A_br = A_br + jnp.concatenate(
        [jnp.zeros((nl, 2), dt), rho_line[:, 4:]], axis=1)[:, :, None] * \
        jnp.eye(6, dtype=dt)[None]
    C6 = model.C[:, 2:, :]                                   # (nl, 6, 6)
    d6 = model.dvec[:, 2:]                                   # (nl, 6)
    Ad6 = jnp.einsum("lkm,lm->lk", A_br, d6)
    G = jnp.einsum("lki,lkm,lmj->lij", C6, A_br, C6)
    w3 = jnp.einsum("lki,lk->li", model.C, model.vec_1j)
    w4 = jnp.einsum("lki,lk->li", model.C, model.vec_1k)
    e3 = jnp.sum(model.vec_1j * model.dvec, axis=1) - model.RH_1j
    e4 = jnp.sum(model.vec_1k * model.dvec, axis=1) - model.RH_1k
    return {
        "GT": jnp.transpose(G, (1, 2, 0)),       # (6,6,B)
        "Ad6": Ad6,                              # (B,6)
        "fc0": 0.5 * jnp.sum(d6 * Ad6, axis=1),  # (B,)
        "w3T": w3.T, "w4T": w4.T,                # (6,B)
        "e3": e3, "e4": e4,
    }


def _reduced_qp_params(model: ModelQpsub, cache, b_br, nl, dt):
    """Combine the solve-constant cache with the iteration's b_br:
    h0 = C6' (A d6 + b), fc = 1/2 d6' A d6 + b' d6 (same two-term forms as
    the original inline build — bit-identical trajectories)."""
    C6 = model.C[:, 2:, :]
    d6 = model.dvec[:, 2:]
    h0 = jnp.einsum("lki,lk->li", C6, cache["Ad6"] + b_br)
    fc = cache["fc0"] + jnp.sum(b_br * d6, axis=1)
    return {
        "G": cache["GT"],
        "h0": h0.T, "w3": cache["w3T"], "w4": cache["w4T"],
        "fc": fc, "e3": cache["e3"], "e4": cache["e4"],
        "scale": jnp.full((nl,), model.par.scale, dt),
    }


def _reduced_qp_fns():
    """(obj, cons, fgh) over the reduced quadratic; all exact closed forms."""

    def cons(x, p):
        c3 = sum(p["w3"][i] * x[i] for i in range(6)) + p["e3"]
        c4 = sum(p["w4"][i] * x[i] for i in range(6)) + p["e4"]
        return c3, c4

    def obj(x, p, lam, mu):
        c3, c4 = cons(x, p)
        Gx = [sum(p["G"][i][j] * x[j] for j in range(6)) for i in range(6)]
        f = (sum((0.5 * Gx[i] + p["h0"][i]) * x[i] for i in range(6)) + p["fc"]
             + lam[0] * c3 + lam[1] * c4 + 0.5 * mu * (c3 * c3 + c4 * c4))
        return f * p["scale"]

    def fgh(x, p, lam, mu):
        c3, c4 = cons(x, p)
        kap3 = lam[0] + mu * c3
        kap4 = lam[1] + mu * c4
        Gx = [sum(p["G"][i][j] * x[j] for j in range(6)) for i in range(6)]
        f = (sum((0.5 * Gx[i] + p["h0"][i]) * x[i] for i in range(6)) + p["fc"]
             + lam[0] * c3 + lam[1] * c4
             + 0.5 * mu * (c3 * c3 + c4 * c4)) * p["scale"]
        g = tuple(
            (Gx[i] + p["h0"][i] + kap3 * p["w3"][i] + kap4 * p["w4"][i])
            * p["scale"]
            for i in range(6)
        )
        H = [[(p["G"][i][j]
               + mu * (p["w3"][i] * p["w3"][j] + p["w4"][i] * p["w4"][j]))
              * p["scale"]
              for j in range(6)] for i in range(6)]
        return f, g, H

    return obj, cons, fgh


def build_model(data_or_grid, par: Parameters, qp_inputs: dict, *,
                use_linelimit: bool = True, tight_factor: float = 1.0,
                pad_lines_to: int = 1, dtype=jnp.float64) -> ModelQpsub:
    """qp_inputs: Hs (6nline,6) or (nline,6,6), LH_1h, RH_1h, LH_1i, RH_1i,
    LH_1j, RH_1j, LH_1k, RH_1k, ls, us, pgmax, pgmin, qgmax, qgmin, c1, c2,
    Pd, Qd (reference solve_qpsub positional argument list).

    ``pad_lines_to``: pad the line batch to a multiple (mesh size) — the
    reference's MPI padding (qpsub_model.jl:139-142); padded lanes get inert
    well-conditioned QP data and are masked out everywhere."""
    if isinstance(data_or_grid, GridData):
        gd = data_or_grid
    else:
        gd = build_grid_data(data_or_grid, tight_factor=tight_factor,
                             pad_lines_to=pad_lines_to, dtype=dtype)
    q = {k: np.asarray(v, np.float64) for k, v in qp_inputs.items()}
    Hs = q["Hs"]
    if Hs.ndim == 2:
        Hs = Hs.reshape(gd.nline, 6, 6)
    npad = gd.nline_padded - gd.nline
    if npad > 0:
        def pad(a, fill=0.0):
            w = [(0, npad)] + [(0, 0)] * (a.ndim - 1)
            return np.pad(a, w, constant_values=fill)

        Hs = np.concatenate(
            [Hs, np.tile(np.eye(6)[None], (npad, 1, 1))], axis=0)
        # identity 2x2 elimination rows; zero constraint rows; unit box
        q["LH_1h"] = pad(q["LH_1h"]); q["LH_1h"][gd.nline:, 0] = 1.0
        q["LH_1i"] = pad(q["LH_1i"]); q["LH_1i"][gd.nline:, 1] = 1.0
        for k in ("RH_1h", "RH_1i", "LH_1j", "RH_1j", "LH_1k", "RH_1k", "ls"):
            q[k] = pad(q[k])
        q["us"] = pad(q["us"], 1.0)
    obj_scale = par.obj_scale
    f = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    return ModelQpsub(
        grid=gd, par=par,
        Hs=f(Hs * obj_scale),
        LH_1h=f(q["LH_1h"]), RH_1h=f(q["RH_1h"]),
        LH_1i=f(q["LH_1i"]), RH_1i=f(q["RH_1i"]),
        LH_1j=f(q["LH_1j"]), RH_1j=f(q["RH_1j"]),
        LH_1k=f(q["LH_1k"]), RH_1k=f(q["RH_1k"]),
        ls=f(q["ls"]), us=f(q["us"]),
        c1=f(q["c1"] * obj_scale), c2=f(q["c2"] * obj_scale),
        pgmin=f(q["pgmin"]), pgmax=f(q["pgmax"]),
        qgmin=f(q["qgmin"]), qgmax=f(q["qgmax"]),
        Pd=f(q["Pd"]), Qd=f(q["Qd"]),
        use_linelimit=use_linelimit,
    )


def init_solution(model: ModelQpsub, rho_pq: float, rho_va: float) -> SolutionQpsub:
    """qpsub flat start (qpsub_init_solution_cpu.jl:8-67): v gens at delta
    bound midpoints, sqp_line at (ls+us)/2 pushed through supY, rho = rho_pq
    for gens / flows with rho_va on ALL 8 line rows."""
    gd = model.grid
    dt = model.Hs.dtype
    nl = gd.nline_padded
    base = Solution.zeros(gd.ngen, nl, dt)

    rho = Blocks(
        gen=jnp.full((gd.ngen, 2), rho_pq, dt),
        line=jnp.full((nl, 8), rho_va, dt),
    )
    v_gen = jnp.stack([0.5 * (model.pgmin + model.pgmax),
                       0.5 * (model.qgmin + model.qgmax)], axis=-1)
    sqp0 = 0.5 * (model.ls + model.us)                     # (nl, 6)
    supY6 = model.supY8[:, :, 2:]                          # (nl, 4, 6)
    flows0 = jnp.einsum("lki,li->lk", supY6, sqp0)
    v_line = jnp.concatenate([flows0, sqp0[:, 2:]], axis=1) * gd.line_mask[:, None]

    base = base.replace(rho=rho, v=Blocks(gen=v_gen, line=v_line))
    return SolutionQpsub(
        base=base,
        sqp_line=sqp0,
        v_prev=base.v,
        alm_lam_j=jnp.zeros((nl,), dt),
        alm_lam_k=jnp.zeros((nl,), dt),
        alm_mu=jnp.full((nl,), 10.0, dt),
    )


def poststep(model: ModelQpsub, sol: SolutionQpsub):
    """Collect the SQP outputs (qpsub_admm_prepoststep_cpu.jl): d* solution
    blocks, per-bus consensus averages, the dual-infeasibility KKT vector,
    and the 14h/14i/14j/14k constraint multipliers."""
    gd = model.grid
    nl, nb, ng = gd.nline, gd.nbus, gd.ngen
    u_gen = np.asarray(sol.base.u.gen)
    u_line = np.asarray(sol.base.u.line)[:nl]
    sqp = np.asarray(sol.sqp_line)[:nl]
    Hs = np.asarray(model.Hs)[:nl]
    f, t = np.asarray(gd.line_from)[:nl], np.asarray(gd.line_to)[:nl]

    dpg_sol = u_gen[:, 0].copy()
    dqg_sol = u_gen[:, 1].copy()
    dline_var = sqp.T.copy()
    dline_fl = u_line[:, :4].T.copy()

    cnt = np.bincount(f, minlength=nb) + np.bincount(t, minlength=nb)
    cnt = np.maximum(cnt, 1)
    dw_sol = (np.bincount(f, weights=sqp[:, 2], minlength=nb)
              + np.bincount(t, weights=sqp[:, 3], minlength=nb)) / cnt
    dtheta_sol = (np.bincount(f, weights=sqp[:, 4], minlength=nb)
                  + np.bincount(t, weights=sqp[:, 5], minlength=nb)) / cnt

    # dual infeasibility: unscaled KKT stationarity pieces
    pg_di = 2.0 * np.asarray(model.c2) * float(gd.baseMVA) ** 2 * u_gen[:, 0]
    line_di = np.einsum("lij,lj->li", Hs, sqp).reshape(-1)
    dual_infeas = np.concatenate([pg_di, line_di])

    # multipliers for 14h/14i/14j/14k from the reduced-QP gradient at the
    # solution (qpsub_auglag_Ab_...red_cpu.jl:139-156)
    import jax as _jax
    # rebuild the final objective gradient wrt the reduced x
    b = sol.base
    lL, rL = b.l.line, b.rho.line
    vz = b.v.line - b.z.line
    supY6 = model.supY8[:, :, 2:]
    A_br = model.Hs + jnp.einsum("lk,lki,lkj->lij", rL[:, :4], supY6, supY6)
    dt = model.Hs.dtype
    A_br = A_br + jnp.concatenate(
        [jnp.zeros((gd.nline_padded, 2), dt), rL[:, 4:]], axis=1)[:, :, None] * \
        jnp.eye(6, dtype=dt)[None]
    coef = lL[:, :4] - rL[:, :4] * (vz[:, :4] - model.line_res)
    b_br = jnp.einsum("lk,lki->li", coef, supY6)
    b_br = b_br + jnp.concatenate(
        [jnp.zeros((gd.nline_padded, 2), dt),
         lL[:, 4:] - rL[:, 4:] * vz[:, 4:]], axis=1)

    x_red = jnp.concatenate([
        jnp.zeros((gd.nline_padded, 2), dt), sol.sqp_line[:, 2:]], axis=1)
    # t slacks recovered from u flows? The reference keeps tron.x; recompute
    # t from the 1j/1k rows: t = RH - LH.(flows)
    flows = sol.base.u.line[:, :4] - model.line_res
    t_ij = model.RH_1j - jnp.sum(model.LH_1j * flows[:, :2], axis=1)
    t_ji = model.RH_1k - jnp.sum(model.LH_1k * flows[:, 2:4], axis=1)
    x_red = x_red.at[:, 0].set(t_ij).at[:, 1].set(t_ji)

    params = {
        "C": jnp.transpose(model.C, (1, 2, 0)), "d": model.dvec.T,
        "A": jnp.transpose(A_br, (1, 2, 0)), "b": b_br.T,
        "v1j": model.vec_1j.T, "v1k": model.vec_1k.T,
        "r1j": model.RH_1j, "r1k": model.RH_1k,
        "scale": jnp.full((gd.nline_padded,), model.par.scale, dt),
    }

    def qp_obj_sum(X):
        def lift(x, p):
            return jnp.stack([
                sum(p["C"][i][j] * x[j] for j in range(6)) + p["d"][i]
                for i in range(8)
            ])
        y = lift(X, params)
        z6 = y[2:]
        Az = [sum(params["A"][i][j] * z6[j] for j in range(6)) for i in range(6)]
        fval = sum((0.5 * Az[i] + params["b"][i]) * z6[i] for i in range(6))
        c3 = sum(params["v1j"][i] * y[i] for i in range(8)) - params["r1j"]
        c4 = sum(params["v1k"][i] * y[i] for i in range(8)) - params["r1k"]
        fval = fval + sol.alm_lam_j * c3 + sol.alm_lam_k * c4 \
            + 0.5 * sol.alm_mu * (c3 * c3 + c4 * c4)
        return jnp.sum(fval * params["scale"])

    trg = np.asarray(_jax.grad(qp_obj_sum)(x_red.T)).T[:nl]  # (nl, 6)

    LH_1h = np.asarray(model.LH_1h)[:nl]
    LH_1i = np.asarray(model.LH_1i)[:nl]
    Yd = {k: np.asarray(getattr(gd, k))[:nl]
          for k in ("YftR", "YftI", "YtfR", "YtfI")}
    # Batched closed-form over all lines (one dispatch; the reference loops
    # per line on the host, qpsub_auglag_Ab_...red_cpu.jl:139-156).
    pij, qij, pji, qji = (u_line[:, k] for k in range(4))
    tmp14_i = np.stack([2 * pij * Yd["YftR"] - 2 * qij * Yd["YftI"],
                        2 * pij * Yd["YftI"] + 2 * qij * Yd["YftR"]], axis=1)
    tmp14_h = np.stack([2 * pji * Yd["YtfR"] - 2 * qji * Yd["YtfI"],
                        -2 * pji * Yd["YtfI"] - 2 * qji * Yd["YtfR"]], axis=1)
    rhs = (trg[:, :1] * tmp14_i + trg[:, 1:2] * tmp14_h
           + np.einsum("lij,lj->li", Hs[:, :2, :], sqp)
           + np.asarray(b_br)[:nl, :2])                       # (nl, 2)
    # inv([[h0, i0], [h1, i1]]) applied to rhs, closed form
    a, bb = LH_1h[:, 0], LH_1i[:, 0]
    c, dd = LH_1h[:, 1], LH_1i[:, 1]
    det = a * dd - bb * c
    lam = np.zeros((4, nl))
    lam[0] = -(dd * rhs[:, 0] - bb * rhs[:, 1]) / det
    lam[1] = -(-c * rhs[:, 0] + a * rhs[:, 1]) / det
    lam[2] = -np.abs(trg[:, 0])
    lam[3] = -np.abs(trg[:, 1])

    return {
        "dpg_sol": dpg_sol, "dqg_sol": dqg_sol,
        "dline_var": dline_var, "dline_fl": dline_fl,
        "dw_sol": dw_sol, "dtheta_sol": dtheta_sol,
        "dual_infeas": dual_infeas, "lambda": lam,
    }
