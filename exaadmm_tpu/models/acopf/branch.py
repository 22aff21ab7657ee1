"""Batched branch (transmission-line) subproblem solver — the hot kernel.

Re-design of the reference per-line CUDA-block kernel
``auglag_linelimit_two_level_alternative``
(``/root/reference/src/models/acopf/acopf_auglag_linelimit_kernel_{cpu,gpu}.jl``):
each line solves a 6-variable nonconvex NLP in polar coordinates

    x = (v_i, v_j, th_i, th_j, s_ij, s_ji)

with box bounds (Vm/Va bounds; slack in [-rateA, 0]) and the two line-limit
equalities  p^2 + q^2 + s = 0  handled by an inner augmented Lagrangian.
The objective is the ADMM proximal term: lam.flow + 0.5 rho (flow - (v-z))^2
over the 8 flow/voltage quantities of the line
(acopf_eval_linelimit_kernel_cpu.jl:1-46).

Instead of 32 CUDA threads per line with hand-derived gradients/Hessians in
shared memory, every line is a lane of the batched TRON/ALM solver
(:mod:`exaadmm_tpu.ops.tron`) — one thread per line inside the fused GPU
kernel; derivatives come from closed forms checked against autodiff.

The 4-variable no-line-limit variant mirrors the semantics of ExaTron's
``polar_kernel_two_level_alternative`` (referenced at
acopf_admm_update_x_cpu.jl:32-35; the implementation ships with ExaTron):
same proximal objective without slacks or ALM rounds.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ...ops.tron import TronALMResult, tron_batched
from ...ops.tron_pallas import select_tron_solver
from ...utils.environment import BranchALMState, Parameters, Solution
from ...utils.grid_data import GridData


def _flows(x, p):
    """Branch power flows in polar form (acopf_eval_linelimit_kernel_cpu.jl:11-16)."""
    vi, vj, thi, thj = x[0], x[1], x[2], x[3]
    cos_ij = jnp.cos(thi - thj)
    sin_ij = jnp.sin(thi - thj)
    vv_cos = vi * vj * cos_ij
    vv_sin = vi * vj * sin_ij
    pij = p["YffR"] * vi**2 + p["YftR"] * vv_cos + p["YftI"] * vv_sin
    qij = -p["YffI"] * vi**2 - p["YftI"] * vv_cos + p["YftR"] * vv_sin
    pji = p["YttR"] * vj**2 + p["YtfR"] * vv_cos - p["YtfI"] * vv_sin
    qji = -p["YttI"] * vj**2 - p["YtfI"] * vv_cos - p["YtfR"] * vv_sin
    return pij, qij, pji, qji


def _prox_terms(x, p, pij, qij, pji, qji):
    vi, vj, thi, thj = x[0], x[1], x[2], x[3]
    eight = (pij, qij, pji, qji, vi**2, vj**2, thi, thj)
    f = 0.0
    for k, w in enumerate(eight):
        f = f + p["l"][k] * w + 0.5 * p["rho"][k] * (w - p["t"][k]) ** 2
    return f


def branch_obj_linelimit(x, p, lam, mu):
    """Full ALM objective of the 6-var line-limit problem, times `scale`."""
    pij, qij, pji, qji = _flows(x, p)
    f = _prox_terms(x, p, pij, qij, pji, qji)
    c1 = pij**2 + qij**2 + x[4]
    c2 = pji**2 + qji**2 + x[5]
    f = f + lam[0] * c1 + lam[1] * c2 + 0.5 * mu * (c1**2 + c2**2)
    return f * p["scale"]


def branch_cons_linelimit(x, p):
    pij, qij, pji, qji = _flows(x, p)
    return (pij**2 + qij**2 + x[4], pji**2 + qji**2 + x[5])


def branch_alm_delta(c, lam_old, mu_old, lam_new, mu_new, p):
    """Exact objective change under an ALM multiplier/penalty update at
    fixed x: the objective is affine in (lam, mu), all times `scale`.
    ``c`` and the multipliers are tuples of (B,) rows."""
    dl = (lam_new[0] - lam_old[0]) * c[0]
    cc = c[0] * c[0]
    for k in range(1, len(c)):
        dl = (lam_new[k] - lam_old[k]) * c[k] + dl
        cc = c[k] * c[k] + cc
    dq = 0.5 * (mu_new - mu_old) * cc
    return (dl + dq) * p["scale"]


def branch_obj_polar(x, p):
    """4-var objective without line limits."""
    pij, qij, pji, qji = _flows(x, p)
    return _prox_terms(x, p, pij, qij, pji, qji) * p["scale"]


def branch_fgh_linelimit(x, p, lam, mu):
    """Closed-form (f, gradient, Hessian rows) of ``branch_obj_linelimit``.

    This is the hot-path replacement for autodiff (which needs 1 reverse pass
    + 6 forward-over-reverse passes per TRON step): the objective has
    Gauss-Newton structure over the basis u = (v_i^2, v_j^2, v_i v_j cos d,
    v_i v_j sin d) with the four flows linear in u, so

        H = J_u^T M J_u + sum_b a_b (grad^2 u_b) + direct terms,

    where M collapses to a diagonal plus two rank-one terms from the ALM
    quadratic. Serves the same purpose as the reference's hand-derived eval
    kernels (acopf_eval_linelimit_kernel_cpu.jl:48-605) — derived
    independently and verified against autodiff in tests.

    Returns (f (B,), g as a tuple of 6 (B,) rows, H as a 6x6 nested list of
    (B,) rows).
    """
    vi, vj, ti, tj, s1, s2 = x[0], x[1], x[2], x[3], x[4], x[5]
    l, rho, t, scale = p["l"], p["rho"], p["t"], p["scale"]
    c_ = jnp.cos(ti - tj)
    s_ = jnp.sin(ti - tj)
    u1, u2 = vi * vi, vj * vj
    u3 = vi * vj * c_
    u4 = vi * vj * s_

    # flow coefficient rows K_m over the basis (u1, u2, u3, u4)
    K = [
        (p["YffR"], 0.0, p["YftR"], p["YftI"]),
        (-p["YffI"], 0.0, -p["YftI"], p["YftR"]),
        (0.0, p["YttR"], p["YtfR"], -p["YtfI"]),
        (0.0, -p["YttI"], -p["YtfI"], -p["YtfR"]),
    ]
    u = (u1, u2, u3, u4)
    F = [sum(K[m][b] * u[b] for b in range(4)) for m in range(4)]

    c1 = F[0] * F[0] + F[1] * F[1] + s1
    c2v = F[2] * F[2] + F[3] * F[3] + s2
    kap1 = lam[0] + mu * c1
    kap2 = lam[1] + mu * c2v

    # objective
    f = jnp.zeros_like(vi)
    for m in range(4):
        f = f + l[m] * F[m] + 0.5 * rho[m] * (F[m] - t[m]) ** 2
    f = (f + l[4] * u1 + 0.5 * rho[4] * (u1 - t[4]) ** 2
         + l[5] * u2 + 0.5 * rho[5] * (u2 - t[5]) ** 2
         + l[6] * ti + 0.5 * rho[6] * (ti - t[6]) ** 2
         + l[7] * tj + 0.5 * rho[7] * (tj - t[7]) ** 2
         + lam[0] * c1 + 0.5 * mu * c1 * c1
         + lam[1] * c2v + 0.5 * mu * c2v * c2v) * scale

    # flow adjoints and direct terms
    gF = [
        l[0] + rho[0] * (F[0] - t[0]) + 2.0 * kap1 * F[0],
        l[1] + rho[1] * (F[1] - t[1]) + 2.0 * kap1 * F[1],
        l[2] + rho[2] * (F[2] - t[2]) + 2.0 * kap2 * F[2],
        l[3] + rho[3] * (F[3] - t[3]) + 2.0 * kap2 * F[3],
    ]
    h_u1 = l[4] + rho[4] * (u1 - t[4])
    h_u2 = l[5] + rho[5] * (u2 - t[5])
    h_ti = l[6] + rho[6] * (ti - t[6])
    h_tj = l[7] + rho[7] * (tj - t[7])

    # basis adjoints a_b = sum_m gF_m K[m][b] (+ direct u terms)
    a = [sum(gF[m] * K[m][b] for m in range(4)) for b in range(4)]
    a[0] = a[0] + h_u1
    a[1] = a[1] + h_u2

    g = tuple(gi * scale for gi in (
        2.0 * vi * a[0] + vj * c_ * a[2] + vj * s_ * a[3],
        2.0 * vj * a[1] + vi * c_ * a[2] + vi * s_ * a[3],
        -u4 * a[2] + u3 * a[3] + h_ti,
        u4 * a[2] - u3 * a[3] + h_tj,
        kap1,
        kap2,
    ))

    # --- Hessian ---
    # M over the basis: K^T diag(rho_m + 2 kap_blk) K
    #                   + mu (K^T w1)(K^T w1)^T + mu (K^T w2)(K^T w2)^T
    #                   + diag(rho4, rho5, 0, 0)
    rt = [rho[0] + 2.0 * kap1, rho[1] + 2.0 * kap1,
          rho[2] + 2.0 * kap2, rho[3] + 2.0 * kap2]
    kw1 = [2.0 * (F[0] * K[0][b] + F[1] * K[1][b]) for b in range(4)]
    kw2 = [2.0 * (F[2] * K[2][b] + F[3] * K[3][b]) for b in range(4)]
    M = [[None] * 4 for _ in range(4)]
    for b in range(4):
        for b2 in range(b, 4):
            m_val = sum(rt[m] * K[m][b] * K[m][b2] for m in range(4))
            m_val = m_val + mu * (kw1[b] * kw1[b2] + kw2[b] * kw2[b2])
            M[b][b2] = M[b2][b] = m_val
    M[0][0] = M[0][0] + rho[4]
    M[1][1] = M[1][1] + rho[5]

    # basis Jacobian rows (over vi, vj, ti, tj). Structure exploited below:
    # columns (variables) have <=3 structural nonzeros and column 3 is the
    # negative of column 2 over the basis rows, so T's column 3 and H4's
    # last row/col come for free — ~40% fewer madds than the dense
    # M @ Ju / Ju^T T products.
    zero = jnp.zeros_like(vi)
    jv0 = 2.0 * vi          # Ju[0][0]
    jv1 = 2.0 * vj          # Ju[1][1]
    jc0, jc1 = vj * c_, vi * c_   # Ju[2][0], Ju[2][1]
    js0, js1 = vj * s_, vi * s_   # Ju[3][0], Ju[3][1]
    Ju = [
        (jv0, zero, zero, zero),
        (zero, jv1, zero, zero),
        (jc0, jc1, -u4, u4),
        (js0, js1, u3, -u3),
    ]
    # T = M @ Ju with the sparse columns (T[b][3] = -T[b][2])
    T = [None] * 4
    for b in range(4):
        t0 = M[b][0] * jv0 + M[b][2] * jc0 + M[b][3] * js0
        t1 = M[b][1] * jv1 + M[b][2] * jc1 + M[b][3] * js1
        t2 = -M[b][2] * u4 + M[b][3] * u3
        T[b] = (t0, t1, t2)
    # H4 = Ju^T T, upper triangle only; column sparsity of Ju and
    # H4[i][3] = -H4[i][2] (Gauss-Newton part)
    H4 = [[None] * 4 for _ in range(4)]
    for j in range(3):
        H4[0][j] = jv0 * T[0][j] + jc0 * T[2][j] + js0 * T[3][j]
        H4[1][j] = jv1 * T[1][j] + jc1 * T[2][j] + js1 * T[3][j]
        H4[2][j] = -u4 * T[2][j] + u3 * T[3][j]
    H4[0][3] = -H4[0][2]
    H4[1][3] = -H4[1][2]
    H4[2][3] = -H4[2][2]
    H4[3][3] = H4[2][2]
    # symmetrize the computed block (entries above were J^T T columns)
    H4[1][0] = H4[0][1]
    H4[2][0] = H4[0][2]
    H4[2][1] = H4[1][2]
    H4[3][0] = H4[0][3]
    H4[3][1] = H4[1][3]
    H4[3][2] = H4[2][3]

    # curvature of the basis: sum_b a_b grad^2 u_b
    H4[0][0] = H4[0][0] + 2.0 * a[0]
    H4[1][1] = H4[1][1] + 2.0 * a[1]
    H4[0][1] = H4[0][1] + a[2] * c_ + a[3] * s_
    H4[0][2] = H4[0][2] - a[2] * vj * s_ + a[3] * vj * c_
    H4[0][3] = H4[0][3] + a[2] * vj * s_ - a[3] * vj * c_
    H4[1][2] = H4[1][2] - a[2] * vi * s_ + a[3] * vi * c_
    H4[1][3] = H4[1][3] + a[2] * vi * s_ - a[3] * vi * c_
    H4[2][2] = H4[2][2] - a[2] * u3 - a[3] * u4 + rho[6]
    H4[2][3] = H4[2][3] + a[2] * u3 + a[3] * u4
    H4[3][3] = H4[3][3] - a[2] * u3 - a[3] * u4 + rho[7]
    for i in range(4):
        for j in range(i):
            H4[i][j] = H4[j][i]

    # cross terms with the slacks: d kap_blk / dx = mu * Ju^T kw_blk
    cross1 = [mu * sum(Ju[b][i] * kw1[b] for b in range(4)) for i in range(4)]
    cross2 = [mu * sum(Ju[b][i] * kw2[b] for b in range(4)) for i in range(4)]

    H = [[None] * 6 for _ in range(6)]
    for i in range(4):
        for j in range(4):
            H[i][j] = H4[i][j] * scale
        H[i][4] = H[4][i] = cross1[i] * scale
        H[i][5] = H[5][i] = cross2[i] * scale
    H[4][4] = mu * scale
    H[5][5] = mu * scale
    H[4][5] = H[5][4] = zero
    return f, g, H


def _branch_params(sol: Solution, gd: GridData, par: Parameters):
    """Per-line parameters in the solver's rows layout (leaves (..., B))."""
    t = sol.v.line - sol.z.line  # prox target (membuf rows 17-24)
    return {
        "YffR": gd.YffR, "YffI": gd.YffI,
        "YftR": gd.YftR, "YftI": gd.YftI,
        "YttR": gd.YttR, "YttI": gd.YttI,
        "YtfR": gd.YtfR, "YtfI": gd.YtfI,
        "l": sol.l.line.T, "rho": sol.rho.line.T, "t": t.T,
        # shaped off a line array so it stays correct under shard_map,
        # where the local line count is nline_padded / n_devices
        "scale": jnp.full_like(t[:, 0], par.scale),
    }


def _warm_start_x0(u_line, gd: GridData, use_linelimit: bool):
    """Warm start from current u (auglag kernel :42-47) and bounds.

    Rows layout: returns (n, B) arrays for the batched solver."""
    vi0 = jnp.clip(jnp.sqrt(jnp.maximum(u_line[:, 4], 0.0)),
                   gd.fr_vm_bound[:, 0], gd.fr_vm_bound[:, 1])
    vj0 = jnp.clip(jnp.sqrt(jnp.maximum(u_line[:, 5], 0.0)),
                   gd.to_vm_bound[:, 0], gd.to_vm_bound[:, 1])
    ti0 = jnp.clip(u_line[:, 6], gd.fr_va_bound[:, 0], gd.fr_va_bound[:, 1])
    tj0 = jnp.clip(u_line[:, 7], gd.to_va_bound[:, 0], gd.to_va_bound[:, 1])
    cols = [vi0, vj0, ti0, tj0]
    lo = [gd.fr_vm_bound[:, 0], gd.to_vm_bound[:, 0],
          gd.fr_va_bound[:, 0], gd.to_va_bound[:, 0]]
    hi = [gd.fr_vm_bound[:, 1], gd.to_vm_bound[:, 1],
          gd.fr_va_bound[:, 1], gd.to_va_bound[:, 1]]
    if use_linelimit:
        sij0 = jnp.clip(-(u_line[:, 0] ** 2 + u_line[:, 1] ** 2), -gd.rate_a, 0.0)
        sji0 = jnp.clip(-(u_line[:, 2] ** 2 + u_line[:, 3] ** 2), -gd.rate_a, 0.0)
        cols += [sij0, sji0]
        lo += [-gd.rate_a, -gd.rate_a]
        hi += [jnp.zeros_like(gd.rate_a), jnp.zeros_like(gd.rate_a)]
    x0 = jnp.stack(cols, axis=0)
    xl = jnp.stack(lo, axis=0)
    xu = jnp.stack(hi, axis=0)
    return x0, xl, xu


def branch_update(
    sol: Solution, gd: GridData, par: Parameters, inner_iter,
    use_linelimit: bool = True, axis_name: str | None = None,
):
    """Solve all line subproblems; returns (new u line block, new ALM state, stats).

    ``inner_iter`` is the (1-based) inner-iteration counter: the ALM penalty
    restarts at 10 on the first inner iteration of each outer loop, matching
    membuf row 27 handling (auglag kernel :81-87); the multipliers lam1/lam2
    warm-start across all iterations.
    """
    params = _branch_params(sol, gd, par)
    u_line = sol.u.line
    alm = sol.branch_alm
    active0 = gd.line_mask > 0.5

    # mixed precision (Parameters.mixed_precision): fp64 solve, fp32 branch
    # batch — the solver inputs are cast down, the solver runs in fp32
    # (kernel-eligible), and the iterates are cast back up so the consensus/
    # residual accumulation stays fp64
    out_dtype = u_line.dtype
    mixed = par.mixed_precision and out_dtype == jnp.float64
    solve_dt = jnp.float32 if mixed else out_dtype

    # dtype-aware tolerances: the reference's fp64 targets (gtol 1e-6 on the
    # scaled objective, |c| <= 1e-6 with c = p^2+q^2+s ~ O(10..100)) sit below
    # fp32 rounding noise; chasing them makes every lane spin to the ALM/minor
    # caps (observed 100x lockstep waste). Floor them at a multiple of the
    # SOLVE dtype epsilon; fp64 values are unchanged.
    eps = float(jnp.finfo(solve_dt).eps)
    gtol = max(par.tron_gtol, 40.0 * eps)
    frtol = max(par.tron_frtol, 10.0 * eps)
    ctol = max(par.alm_ctol, 300.0 * eps)
    # large ALM penalties square into the Hessian; cap so the TR subproblem
    # conditioning stays within the dtype (1e8 is fine in fp64, ruinous in
    # fp32 where it makes tail lanes grind for hundreds of minor iterations)
    mu_max = min(par.mu_max, 0.1 / eps)

    def _down(tree):
        if not mixed:
            return tree
        return jax.tree.map(
            lambda a: a.astype(solve_dt)
            if a.dtype == jnp.float64 else a, tree)

    def _up(res):
        if not mixed:
            return res
        return TronALMResult(
            x=res.x.astype(out_dtype), lam=res.lam.astype(out_dtype),
            mu=res.mu.astype(out_dtype), minor_iters=res.minor_iters,
            alm_iters=res.alm_iters, cviol=res.cviol.astype(out_dtype))

    _solver, extra = select_tron_solver(par, solve_dt)
    # "auto": reference-faithful while-loop trial searches on every backend
    # (capped unrolls measured faster in steady state but cost convergence
    # on sensitive fp32 cases; see Parameters.tron_trial_unroll)
    trial_unroll = par.tron_trial_unroll
    if trial_unroll == "auto":
        trial_unroll = None

    if use_linelimit:
        x0, xl, xu = _warm_start_x0(u_line, gd, True)
        mu0 = jnp.where(inner_iter == 1, jnp.full_like(alm.mu, 10.0), alm.mu)
        lam0 = jnp.stack([alm.lam1, alm.lam2], axis=0)
        x0, xl, xu, params, lam0, mu0 = _down(
            (x0, xl, xu, params, lam0, mu0))
        kw = dict(
            gtol=gtol, frtol=frtol, ctol=ctol,
            mu_max=mu_max, max_minor=par.tron_max_minor,
            max_auglag=par.max_auglag,
            fgh_fn=branch_fgh_linelimit,
            trial_unroll=trial_unroll,
            alm_delta_fn=branch_alm_delta,
        )
        B = x0.shape[1]
        tail_cap = par.branch_tail_lanes
        if tail_cap is None:
            # ~1/16 of the batch, rounded up to whole 1024-lane blocks
            tail_cap = -(-B // (16 * 1024)) * 1024
        two_pass = (par.branch_two_pass
                    and par.tron_step_cap is not None
                    and par.tron_step_cap > par.branch_pass1_cap
                    and B >= 4 * tail_cap)
        if two_pass:
            res1 = _solver(
                branch_obj_linelimit, branch_cons_linelimit,
                x0, xl, xu, params, lam0, mu0,
                step_cap=par.branch_pass1_cap, active0=active0,
                **kw, **extra,
            )
            # a lane is finished iff its last ALM check passed ctol or it
            # exhausted its ALM rounds; anything else ran out of pass-1
            # budget mid-solve
            unfinished = active0 & ~((res1.cviol <= ctol)
                                     | (res1.alm_iters >= par.max_auglag))
            # compact the stragglers (stable: unfinished lanes first) and
            # re-solve them from scratch with the full budget — identical
            # per-lane trajectory to a single full-budget pass. All pass-2
            # traffic is packed into row-stacked arrays: one input gather,
            # one output gather, one output scatter.
            idx = jnp.argsort(jnp.where(unfinished, 0, 1))[:tail_cap]
            dtype = x0.dtype
            leaves, treedef = jax.tree_util.tree_flatten(params)
            rows_in = [x0, xl, xu, lam0, mu0[None, :],
                       unfinished.astype(dtype)[None, :]]
            rows_in += [leaf.reshape(-1, B) for leaf in leaves]
            pack = jnp.concatenate(rows_in, axis=0)
            sub = pack[:, idx]
            off = [0]
            for a in rows_in:
                off.append(off[-1] + a.shape[0])
            cut = lambda i: sub[off[i]:off[i + 1]]  # noqa: E731
            take = cut(5)[0] > 0.5
            leaf_subs = [
                cut(6 + i).reshape(leaf.shape[:-1] + (sub.shape[1],))
                for i, leaf in enumerate(leaves)
            ]
            params2 = jax.tree_util.tree_unflatten(treedef, leaf_subs)
            res2 = _solver(
                branch_obj_linelimit, branch_cons_linelimit,
                cut(0), cut(1), cut(2), params2,
                cut(3), cut(4)[0],
                step_cap=par.tron_step_cap, active0=take,
                **kw, **extra,
            )

            pass1_unfinished = jnp.sum(unfinished, dtype=jnp.int32)
            tail_overflow = jnp.maximum(
                pass1_unfinished - tail_cap, 0
            ).astype(jnp.int32)

            def out_pack(r):
                return jnp.concatenate([
                    r.x, r.lam, r.mu[None],
                    r.minor_iters.astype(dtype)[None],
                    r.alm_iters.astype(dtype)[None],
                    r.cviol[None],
                ], axis=0)

            out1 = out_pack(res1)
            upd = jnp.where(take[None, :], out_pack(res2), out1[:, idx])
            merged = out1.at[:, idx].set(upd)
            res = TronALMResult(
                x=merged[:6],
                lam=merged[6:8],
                mu=merged[8],
                minor_iters=merged[9].astype(jnp.int32),
                alm_iters=merged[10].astype(jnp.int32),
                cviol=merged[11],
            )
        else:
            tail_overflow = jnp.zeros((), jnp.int32)
            pass1_unfinished = jnp.zeros((), jnp.int32)
            res = _solver(
                branch_obj_linelimit, branch_cons_linelimit,
                x0, xl, xu, params, lam0, mu0,
                step_cap=par.tron_step_cap, active0=active0,
                **kw, **extra,
            )
        res = _up(res)
        new_alm = BranchALMState(lam1=res.lam[0], lam2=res.lam[1], mu=res.mu)
        x = res.x
    else:
        tail_overflow = jnp.zeros((), jnp.int32)
        pass1_unfinished = jnp.zeros((), jnp.int32)
        x0, xl, xu = _warm_start_x0(u_line, gd, False)
        x0, xl, xu, params = _down((x0, xl, xu, params))
        res = tron_batched(
            branch_obj_polar, x0, xl, xu, params,
            gtol=gtol, frtol=frtol,
            max_minor=par.tron_max_minor, step_cap=par.tron_step_cap,
            active0=active0, trial_unroll=trial_unroll,
        )
        res = _up(res)
        new_alm = alm
        x = res.x

    vi, vj, thi, thj = x[0], x[1], x[2], x[3]
    cos_ij = jnp.cos(thi - thj)
    sin_ij = jnp.sin(thi - thj)
    vv_cos = vi * vj * cos_ij
    vv_sin = vi * vj * sin_ij
    u_new = jnp.stack([
        gd.YffR * vi**2 + gd.YftR * vv_cos + gd.YftI * vv_sin,
        -gd.YffI * vi**2 - gd.YftI * vv_cos + gd.YftR * vv_sin,
        gd.YttR * vj**2 + gd.YtfR * vv_cos - gd.YtfI * vv_sin,
        -gd.YttI * vj**2 - gd.YtfI * vv_cos - gd.YtfR * vv_sin,
        vi**2,
        vj**2,
        thi,
        thj,
    ], axis=-1)
    # padded lanes keep their previous (zero) state
    u_new = jnp.where(active0[:, None], u_new, u_line)

    sums = jnp.stack([
        jnp.sum(res.alm_iters * gd.line_mask),
        jnp.sum(res.minor_iters * gd.line_mask),
    ])
    max_cv = jnp.max(jnp.where(active0, res.cviol, 0.0))
    if axis_name is not None:
        sums = jax.lax.psum(sums, axis_name)
        max_cv = jax.lax.pmax(max_cv, axis_name)
        counts = jax.lax.psum(
            jnp.stack([tail_overflow, pass1_unfinished]), axis_name)
        tail_overflow, pass1_unfinished = counts[0], counts[1]
    stats = {
        "avg_auglag_it": sums[0] / gd.nline,
        "avg_minor_it": sums[1] / gd.nline,
        "max_cviol": max_cv,
        # lanes that ran out of the pass-1 lockstep budget this dispatch —
        # the total inexactness signal (most are re-solved exactly by the
        # tail; see Parameters.branch_two_pass)
        "pass1_unfinished": pass1_unfinished,
        # stragglers beyond the two-pass tail capacity this call (they kept
        # their pass-1 iterate; persistent non-zero values mean
        # branch_tail_lanes should be raised)
        "tail_overflow": tail_overflow,
        # per-lane lockstep steps consumed — the difficulty signal for the
        # driver's line sorting (Parameters.sort_lines)
        "lane_steps": ((res.minor_iters + res.alm_iters)
                       * gd.line_mask.astype(jnp.int32)),
    }
    return u_new, new_alm, stats
