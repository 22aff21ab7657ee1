"""Batched trust-region Newton (TRON-style) with an augmented-Lagrangian wrapper.

This replaces the reference's device-resident ExaTron solver (the external
``ExaTron`` package: ``dtron``/``dcauchy``/``dspcg``/``dgpnorm``; call sites
at ExaAdmm.jl's ``src/models/acopf/acopf_tron_linelimit_kernel.jl:61-144``)
and the per-line ALM loop that wraps it
(``acopf_auglag_linelimit_kernel_cpu.jl:120-156``).

Design: ALL subproblems of a batch advance in lockstep through one flat state
machine inside one ``lax.while_loop`` whose body is fully batched. Each lane
(subproblem) carries its own phase (TRON minor iteration vs ALM multiplier
round vs done); the loop runs until every lane finishes — uniform control flow
at the cost of masked work for early finishers. The same state machine runs
over the whole batch in XLA (:func:`tron_alm_batched`) or over one small tile
per GPU thread block (``ops/tron_pallas.py``), where each block exits when
its own lanes are done — the reference's one-block-per-line design.

LAYOUT: "rows". Every n-vector is a tuple of n ``(B,)`` rows, the Hessian a
nested n x n list of rows, and lane parameters are rows (or nested tuples of
rows). All dense 6x6 algebra unrolls to elementwise ops on ``(B,)`` vectors,
so inside the GPU kernel each lane is one thread whose state lives in
registers, and no op ever slices or stacks along the small dimension (the
Triton lowering supports neither).

Derivatives: a model may pass closed forms (``fgh_fn``); otherwise they come
from autodiff in the same layout — the gradient as a VJP with unit cotangent
(exact per-lane gradients since f is elementwise over lanes), the Hessian as
n forward-over-reverse products.

Algorithm per lane (faithful to Lin & More's TRON as used by ExaTron):
  - Cauchy point along the projected gradient with sufficient decrease
    (mu0 = 0.01, interpolation x0.1 / extrapolation x10, warm-started step),
  - Newton step on the free variables via shifted dense Cholesky, clipped to
    the trust region, then a projected backtracking search,
  - actual/predicted reduction ratio tests with TRON's radius-update
    constants (eta0=1e-4, eta1=0.25, eta2=0.75, sigma1=0.25, sigma2=0.5,
    sigma3=4),
  - termination on projected-gradient inf-norm <= gtol, relative function
    reduction <= frtol, or the minor-iteration cap,
  - ALM round on TRON convergence: lambda += mu*c when ||c||_inf <= eta
    (Lancelot eta-ladder eta /= mu^0.9), else mu = min(10*mu, mu_max) with
    eta = mu^-0.1; a lane finishes when ||c||_inf <= ctol or the round cap.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

# TRON constants (Lin & More)
_MU0 = 0.01       # sufficient decrease for Cauchy/projected searches
_INTERPF = 0.1
_EXTRAPF = 10.0
_ETA0, _ETA1, _ETA2 = 1e-4, 0.25, 0.75
_SIGMA1, _SIGMA2, _SIGMA3 = 0.25, 0.5, 4.0
_CAUCHY_ITERS = 22
_EXTRAP_ITERS = 10
_PRSRCH_ITERS = 20


class TronALMResult(NamedTuple):
    x: jnp.ndarray       # (n, B) final iterates (a tuple of rows in-kernel)
    lam: jnp.ndarray     # (ncon, B) ALM multipliers (likewise)
    mu: jnp.ndarray      # (B,) ALM penalties
    minor_iters: jnp.ndarray  # (B,) total TR iterations
    alm_iters: jnp.ndarray    # (B,) ALM rounds taken
    cviol: jnp.ndarray   # (B,) final constraint inf-norm


class _State(NamedTuple):
    x: tuple
    f: jnp.ndarray
    delta: jnp.ndarray
    alpha_c: jnp.ndarray
    tron_it: jnp.ndarray
    tron_done: jnp.ndarray   # bool
    need_init: jnp.ndarray   # bool
    lam: tuple
    mu: jnp.ndarray
    eta: jnp.ndarray
    alm_it: jnp.ndarray
    active: jnp.ndarray      # bool
    minor_total: jnp.ndarray
    cviol: jnp.ndarray
    steps: jnp.ndarray


# ---- row algebra -----------------------------------------------------------

def _rmap(fn, *rows):
    return tuple(fn(*r) for r in zip(*rows))


def _dot(a, b):
    # the multiply-add order of XLA's reduce of a * b over the small axis
    acc = a[0] * b[0]
    for u, v in zip(a[1:], b[1:]):
        acc = u * v + acc
    return acc


def _any(mask):
    # the Triton lowering has no reduce_or: reduce an int32 view instead
    return jnp.max(mask.astype(jnp.int32)) > 0


def _gp_norm_inf(x, g, xl, xu):
    def gp(xi, gi, li, ui):
        p = jnp.where(xi <= li, jnp.minimum(gi, 0.0), gi)
        p = jnp.where(xi >= ui, jnp.maximum(p, 0.0), p)
        return jnp.abs(p)

    rows = _rmap(gp, x, g, xl, xu)
    out = rows[0]
    for r in rows[1:]:
        out = jnp.maximum(out, r)
    return out


def _norm2(s):
    return jnp.sqrt(_dot(s, s))


def _chol_solve_rows(H, rhs, tau):
    """Solve (H + tau*I) d = rhs per lane; H nested rows, rhs a tuple of rows.

    Unrolled dense Cholesky on (B,)-vector scalars; returns (d, ok) where ok
    marks lanes whose pivots stayed positive.
    """
    n = len(H)
    L = [[None] * n for _ in range(n)]
    inv_diag = [None] * n
    ok = None
    for j in range(n):
        s = H[j][j] + tau
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        ok = (s > 0) if ok is None else ok & (s > 0)
        piv = jnp.sqrt(jnp.where(s > 0, s, 1.0))
        inv_piv = 1.0 / piv
        inv_diag[j] = inv_piv
        for i in range(j + 1, n):
            t = H[i][j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t * inv_piv
    y = [None] * n
    for i in range(n):
        t = rhs[i]
        for k in range(i):
            t = t - L[i][k] * y[k]
        y[i] = t * inv_diag[i]
    d = [None] * n
    for i in reversed(range(n)):
        t = y[i]
        for k in range(i + 1, n):
            t = t - L[k][i] * d[k]
        d[i] = t * inv_diag[i]
    return tuple(d), ok


def _newton_dir_rows(H, rhs):
    """Smallest-shift Newton direction. Mirrors TRON's shifted incomplete
    Cholesky (dicfs); dense and exact here since n <= 6.

    The free-variable Hessian is PD at shift 0 for the vast majority of lanes
    (the proximal rho terms dominate), so the shift-0 factorization is
    peeled and the escalating-shift ladder runs as a while-loop that exits
    as soon as every lane is factorized — one factorization per TR step in
    the common case instead of six."""
    n = len(H)
    dmax = jnp.abs(H[0][0])
    for i in range(1, n):
        dmax = jnp.maximum(dmax, jnp.abs(H[i][i]))
    dmax = jnp.maximum(dmax, 1.0)
    # scalar selects rather than an indexed constant array: a kernel may not
    # capture a traced constant array
    LEVELS = (0.0, 1e-10, 1e-6, 1e-3, 1.0, 1e3)

    d0, ok0 = _chol_solve_rows(H, rhs, jnp.zeros_like(dmax))
    d0 = _rmap(lambda v: jnp.where(ok0, v, 0.0), d0)

    def cond(carry):
        d, solved, idx = carry
        return (idx < len(LEVELS)) & _any(~solved)

    def body(carry):
        d, solved, idx = carry
        lvl = jnp.zeros((), dmax.dtype)
        for k, v in enumerate(LEVELS):
            lvl = jnp.where(idx == k, v, lvl)
        cand, ok = _chol_solve_rows(H, rhs, dmax * lvl)
        take = ok & ~solved
        d = _rmap(lambda c, v: jnp.where(take, c, v), cand, d)
        return d, solved | ok, idx + 1

    d, solved, _ = lax.while_loop(
        cond, body, (d0, ok0, jnp.ones((), jnp.int32)))
    return d, solved


def tron_alm_rows(
    obj_fn: Callable,    # (x rows, params, lam rows, mu (B,)) -> (B,)
    cons_fn: Callable,   # (x rows, params) -> tuple of ncon rows
    x0: tuple,           # n rows of (B,)
    xl: tuple,
    xu: tuple,
    params,              # pytree of rows (or nested tuples of rows)
    lam0: tuple,         # ncon rows
    mu0: jnp.ndarray,    # (B,)
    *,
    gtol: float = 1e-6,
    frtol: float = 1e-12,
    ctol: float = 1e-6,
    mu_max: float = 1e8,
    max_minor: int = 200,
    max_auglag: int = 50,
    step_cap: int | None = None,
    active0: jnp.ndarray | None = None,
    fgh_fn: Callable | None = None,
    trial_unroll: tuple[int, int, int] | None = None,
    alm_delta_fn: Callable | None = None,
) -> TronALMResult:
    """Solve B independent bound-constrained ALM problems in lockstep, with
    every vector held as a tuple of ``(B,)`` rows (see the module docstring).
    Returns a :class:`TronALMResult` whose ``x`` and ``lam`` are tuples of
    rows. :func:`tron_alm_batched` is the array front end.

    ``obj_fn`` is the FULL augmented objective (base + lam.c + 0.5 mu |c|^2)
    written row-wise (x[0], x[1], ... are (B,) vectors); gradients and
    Hessians are derived from it by autodiff, replacing the reference's
    600-line hand-derived eval kernels (acopf_eval_linelimit_kernel_cpu.jl).
    Pass ``fgh_fn(x, params, lam, mu) -> (f, g rows, H nested rows)`` to
    override the autodiff evaluation with hand-derived closed forms on the
    hot path (Hessian autodiff costs ~5x the primal; the closed forms ~1.5x).

    ``trial_unroll=(k_interp, k_extrap, k_prsrch)`` replaces the three
    data-dependent trial-search while-loops inside each trust-region step
    (Cauchy interpolation/extrapolation, projected backtracking) with
    fixed-trip masked unrolled searches. With caps equal to the loop caps
    (22, 10, 20) results are bit-identical to the while-loop mode; smaller
    caps trade rare pathological-lane accuracy for uniform cost (the TR
    machinery absorbs a failed search by shrinking the radius).

    ``alm_delta_fn(c, lam_old, mu_old, lam_new, mu_new, params) -> (B,)``
    optionally supplies the exact objective change under a multiplier/penalty
    update (obj is affine in lam and mu at fixed x), replacing the full
    objective re-evaluation after each ALM round — the model knows its own
    scaling, the solver does not.
    """
    n = len(x0)
    B = x0[0].shape[0]
    dtype = x0[0].dtype
    ncon = len(lam0)

    def f_batched(X, lam, mu):
        return obj_fn(X, params, lam, mu)

    def grad_fn(X, lam, mu):
        f, vjp = jax.vjp(lambda Y: obj_fn(Y, params, lam, mu), X)
        return vjp(jnp.ones_like(f))[0]

    def grad_hess(X, lam, mu):
        if fgh_fn is not None:
            _, g, H = fgh_fn(X, params, lam, mu)
            return tuple(g), H
        g = grad_fn(X, lam, mu)
        zero, one = jnp.zeros_like(X[0]), jnp.ones_like(X[0])
        cols = []
        for j in range(n):
            tangent = tuple(one if i == j else zero for i in range(n))
            _, hj = jax.jvp(lambda Y: grad_fn(Y, lam, mu), (X,), (tangent,))
            cols.append(hj)
        # H[i][j] is a (B,) vector: row i of H e_j
        H = [[cols[j][i] for j in range(n)] for i in range(n)]
        return g, H

    def hmatvec(H, s):
        out = []
        for i in range(n):
            acc = H[i][0] * s[0]
            for j in range(1, n):
                acc = acc + H[i][j] * s[j]
            out.append(acc)
        return tuple(out)

    def cviol_inf(X):
        c = tuple(cons_fn(X, params))
        if ncon == 0:
            return jnp.zeros((B,), dtype), c
        cn = jnp.abs(c[0])
        for ci in c[1:]:
            cn = jnp.maximum(cn, jnp.abs(ci))
        return cn, c

    def select(mask, a, b):
        return _rmap(lambda u, v: jnp.where(mask, u, v), a, b)

    def tr_step(x, f, g, H, delta, alpha_c, lam, mu):
        def qval(s):
            return _dot(g, s) + 0.5 * _dot(s, hmatvec(H, s))

        def proj(y):
            return _rmap(jnp.clip, y, xl, xu)

        def s_of(a):
            return _rmap(jnp.subtract,
                         proj(_rmap(lambda xi, gi: xi - a * gi, x, g)), x)

        def cauchy_ok(a):
            s = s_of(a)
            return (_norm2(s) <= delta) & (qval(s) <= _MU0 * _dot(g, s))

        # --- Cauchy point (dcauchy): warm-started alpha ---
        a0 = jnp.maximum(alpha_c, 1e-30)
        need_interp = ~cauchy_ok(a0)

        if trial_unroll is not None:
            # Fixed-trip masked searches: every candidate evaluation is
            # independent. Candidates come from the same chained
            # multiplications as the loops, so with caps >= the loop caps
            # the results are bit-identical.
            k_interp, k_extrap, k_prsrch = trial_unroll

            cand = a0
            a_interp = a0
            have = jnp.zeros((B,), bool)
            for _ in range(k_interp):
                cand = cand * _INTERPF
                okk = cauchy_ok(cand)
                a_interp = jnp.where(have, a_interp, cand)
                have = have | okk

            cand = a0
            a_extrap = a0
            prefix = ~need_interp
            for _ in range(k_extrap):
                cand = cand * _EXTRAPF
                prefix = prefix & cauchy_ok(cand) & (cand < 1e12)
                a_extrap = jnp.where(prefix, cand, a_extrap)
        else:
            # Interpolation (a *= 0.1 until acceptable) and extrapolation
            # (a *= 10 while acceptable) are mutually exclusive per lane, so
            # run them as ONE lockstep loop with a per-lane factor: each
            # lane's candidate sequence is unchanged (bit-identical results)
            # but the trip count is max(interp, extrap) instead of their sum.
            factor = jnp.where(need_interp, _INTERPF, _EXTRAPF)

            def cauchy_cond(carry):
                a_best, cand, stop, k = carry
                return _any(~stop) & (k < _CAUCHY_ITERS)

            def cauchy_body(carry):
                a_best, cand, stop, k = carry
                cand2 = cand * factor
                ok = cauchy_ok(cand2)
                # interp lanes: track every candidate while searching (the
                # reference keeps the last trial even if the cap is hit),
                # stop at the first acceptable one
                take_i = need_interp & ~stop
                # extrap lanes: keep the LAST acceptable candidate, stop on
                # the first failure (or the growth cap / trip cap)
                good_e = ok & (cand2 < 1e12)
                take_e = ~need_interp & ~stop & good_e
                a_best = jnp.where(take_i | take_e, cand2, a_best)
                stop_i = stop | ok
                stop_e = stop | ~good_e | (k + 1 >= _EXTRAP_ITERS)
                stop2 = jnp.where(need_interp, stop_i, stop_e)
                return a_best, cand2, stop2, k + 1

            alpha0, _, _, _ = lax.while_loop(
                cauchy_cond, cauchy_body,
                (a0, a0, jnp.zeros((B,), bool), jnp.zeros((), jnp.int32)))
            a_interp = a_extrap = alpha0
        alpha = jnp.where(need_interp, a_interp, a_extrap)
        sc = s_of(alpha)
        xc = _rmap(jnp.add, x, sc)

        # --- Newton direction on free variables ---
        free = _rmap(lambda v, lo, hi: (v > lo) & (v < hi), xc, xl, xu)
        Hsc = hmatvec(H, sc)
        gc = _rmap(jnp.add, g, Hsc)
        gf = _rmap(lambda fr, v: -jnp.where(fr, v, 0.0), free, gc)
        # H restricted to the free set, identity on the fixed variables
        Hm = [
            [
                (jnp.where(free[i], H[i][i], 1.0) if i == j
                 else jnp.where(free[i] & free[j], H[i][j], 0.0))
                for j in range(n)
            ]
            for i in range(n)
        ]
        d, solved = _newton_dir_rows(Hm, gf)
        d = _rmap(lambda fr, v: jnp.where(fr & solved, v, 0.0), free, d)

        # clip the combined step to the trust region (dtrqsol)
        dd = _dot(d, d)
        sd = _dot(sc, d)
        ss = _dot(sc, sc)
        rad = jnp.maximum(sd * sd + dd * (delta * delta - ss), 0.0)
        safe_dd = jnp.where(dd > 0, dd, 1.0)
        tau = jnp.where(dd > 0,
                        jnp.minimum((jnp.sqrt(rad) - sd) / safe_dd, 1.0), 0.0)
        tau = jnp.maximum(tau, 0.0)
        d = _rmap(lambda v: v * tau, d)

        # --- projected backtracking from xc along d (dprsrch) ---
        # q_c via the cached H*sc (saves one hmatvec per step)
        q_c = _dot(g, sc) + 0.5 * _dot(sc, Hsc)

        def s_try_of(aw):
            return _rmap(jnp.subtract,
                         proj(_rmap(lambda c, v: c + aw * v, xc, d)), x)

        def decrease(s_try):
            dsc = _rmap(jnp.subtract, s_try, sc)
            return qval(s_try) <= q_c + _MU0 * jnp.minimum(_dot(gc, dsc), 0.0)

        if trial_unroll is not None:
            aw = jnp.ones((B,), dtype)
            s_best = sc
            found = jnp.zeros((B,), bool)
            for _ in range(k_prsrch):
                s_try = s_try_of(aw)
                decr = decrease(s_try)
                s_best = select(decr & ~found, s_try, s_best)
                found = found | decr
                aw = aw * 0.5
        else:
            def prs_cond(carry):
                aw, best_s, found, k = carry
                return _any(~found) & (k < _PRSRCH_ITERS)

            def prs_body(carry):
                aw, best_s, found, k = carry
                s_try = s_try_of(aw)
                decr = decrease(s_try)
                best_s = select(decr & ~found, s_try, best_s)
                return aw * 0.5, best_s, found | decr, k + 1

            _, s_best, found, _ = lax.while_loop(
                prs_cond, prs_body,
                (jnp.ones((B,), dtype), sc, jnp.zeros((B,), bool),
                 jnp.zeros((), jnp.int32)))
        s = select(found, s_best, sc)

        # --- ratio test & radius update (dtron) ---
        xt = _rmap(jnp.add, x, s)
        ft = f_batched(xt, lam, mu)
        predred = -qval(s)
        actred = f - ft
        gts = _dot(g, s)
        snorm = _norm2(s)

        denom = ft - f - gts
        alpha_q = jnp.where(
            denom <= 0.0, _SIGMA3,
            jnp.maximum(_SIGMA1, -0.5 * gts / jnp.where(denom == 0, 1.0, denom)))
        safe_pred = jnp.where(predred != 0.0, predred, 1.0)
        ratio = jnp.where(predred > 0.0, actred / safe_pred, 0.0)

        delta_new = jnp.where(
            ratio <= _ETA0,
            jnp.minimum(jnp.maximum(alpha_q, _SIGMA1) * snorm, _SIGMA2 * delta),
            jnp.where(
                ratio < _ETA1,
                jnp.maximum(_SIGMA1 * delta,
                            jnp.minimum(alpha_q * snorm, _SIGMA2 * delta)),
                jnp.where(
                    ratio < _ETA2,
                    jnp.maximum(_SIGMA1 * delta,
                                jnp.minimum(alpha_q * snorm, _SIGMA3 * delta)),
                    jnp.maximum(delta,
                                jnp.minimum(alpha_q * snorm, _SIGMA3 * delta)),
                ),
            ),
        )
        delta_new = jnp.maximum(delta_new, 1e-30)

        accept = ratio > _ETA0
        x_new = select(accept, xt, x)
        f_new = jnp.where(accept, ft, f)
        frtol_conv = (predred <= frtol * jnp.abs(f)) | (
            accept & (actred <= frtol * jnp.abs(f)))
        return x_new, f_new, delta_new, alpha, frtol_conv

    def body(st: _State) -> _State:
        g, H = grad_hess(st.x, st.lam, st.mu)

        gnorm = _norm2(g)
        delta = jnp.where(st.need_init, jnp.maximum(gnorm, 1e-12), st.delta)
        alpha_c = jnp.where(st.need_init, jnp.ones_like(st.alpha_c),
                            st.alpha_c)

        gpn = _gp_norm_inf(st.x, g, xl, xu)
        tron_conv = gpn <= gtol
        stepping = (st.active & ~st.tron_done & ~tron_conv
                    & (st.tron_it < max_minor))
        newly_done = st.active & ~st.tron_done & (
            tron_conv | (st.tron_it >= max_minor))

        x2, f2, delta2, ac2, frtol_conv = tr_step(
            st.x, st.f, g, H, delta, alpha_c, st.lam, st.mu)
        x = select(stepping, x2, st.x)
        f = jnp.where(stepping, f2, st.f)
        delta = jnp.where(stepping, delta2, delta)
        alpha_c = jnp.where(stepping, ac2, alpha_c)
        tron_it = st.tron_it + stepping.astype(jnp.int32)
        minor_total = st.minor_total + stepping.astype(jnp.int32)
        need_init = st.need_init & ~stepping

        tron_done = st.tron_done | newly_done | (stepping & frtol_conv)

        # --- ALM round for lanes whose TRON solve just finished ---
        do_alm = st.active & tron_done
        cnorm, c = cviol_inf(x)
        good = cnorm <= st.eta
        # reference nests the ctol test under the eta test
        # (acopf_auglag_linelimit_kernel_cpu.jl:128-137)
        line_solved = good & (cnorm <= ctol)

        upd_lam = do_alm & good & ~line_solved
        lam = _rmap(lambda lv, cv: jnp.where(upd_lam, lv + st.mu * cv, lv),
                    st.lam, c)
        eta = jnp.where(upd_lam, st.eta / st.mu**0.9, st.eta)

        upd_mu = do_alm & ~good
        mu = jnp.where(upd_mu, jnp.minimum(mu_max, st.mu * 10.0), st.mu)
        eta = jnp.where(upd_mu, 1.0 / mu**0.1, eta)

        alm_it = st.alm_it + do_alm.astype(jnp.int32)
        finished = do_alm & (line_solved | (alm_it >= max_auglag))
        active = st.active & ~finished

        restart = do_alm & ~finished
        tron_done = tron_done & ~restart
        tron_it = jnp.where(restart, 0, tron_it)
        need_init = need_init | restart
        if alm_delta_fn is not None and ncon > 0:
            f_fresh = f + alm_delta_fn(c, st.lam, st.mu, lam, mu, params)
        else:
            f_fresh = f_batched(x, lam, mu)
        f = jnp.where(restart, f_fresh, f)
        cviol = jnp.where(do_alm, cnorm, st.cviol)

        return _State(
            x=x, f=f, delta=delta, alpha_c=alpha_c, tron_it=tron_it,
            tron_done=tron_done, need_init=need_init,
            lam=lam, mu=mu, eta=eta, alm_it=alm_it, active=active,
            minor_total=minor_total, cviol=cviol, steps=st.steps + 1,
        )

    if step_cap is None:
        step_cap = max_minor * max_auglag

    def cond(st: _State):
        return _any(st.active) & (st.steps < step_cap)

    x0 = tuple(x0)
    lam0 = tuple(lam0)
    f0 = f_batched(x0, lam0, mu0)
    if active0 is None:
        active0 = jnp.ones((B,), bool)
    st0 = _State(
        x=x0,
        f=f0,
        delta=jnp.zeros((B,), dtype),
        alpha_c=jnp.ones((B,), dtype),
        tron_it=jnp.zeros((B,), jnp.int32),
        tron_done=jnp.zeros((B,), bool),
        need_init=jnp.ones((B,), bool),
        lam=lam0,
        mu=mu0,
        eta=1.0 / mu0**0.1,
        alm_it=jnp.zeros((B,), jnp.int32),
        active=active0,
        minor_total=jnp.zeros((B,), jnp.int32),
        cviol=jnp.full((B,), jnp.inf, dtype),
        steps=jnp.zeros((), jnp.int32),
    )
    st = lax.while_loop(cond, body, st0)
    return TronALMResult(
        x=st.x, lam=st.lam, mu=st.mu,
        minor_iters=st.minor_total, alm_iters=st.alm_it, cviol=st.cviol,
    )


def _to_rows(a):
    """Split the leading axes of a ``(..., B)`` array into nested tuples of
    ``(B,)`` rows (a ``(B,)`` array is returned as it is)."""
    if a.ndim == 1:
        return a
    return tuple(_to_rows(a[i]) for i in range(a.shape[0]))


def tron_alm_batched(obj_fn, cons_fn, x0, xl, xu, params, lam0, mu0,
                     **kwargs) -> TronALMResult:
    """Array front end of :func:`tron_alm_rows` for the XLA path: ``x0``,
    ``xl``, ``xu`` are ``(n, B)``, ``lam0`` ``(ncon, B)``, ``mu0`` ``(B,)``
    and every ``params`` leaf ``(..., B)``. The leaves are split into rows,
    so model functions see exactly what they see inside the GPU kernel.
    Returns ``x`` and ``lam`` stacked back to ``(n, B)`` and ``(ncon, B)``.
    """
    B = x0.shape[1]
    res = tron_alm_rows(
        obj_fn, cons_fn, _to_rows(x0), _to_rows(xl), _to_rows(xu),
        jax.tree.map(_to_rows, params), _to_rows(lam0), mu0, **kwargs)
    lam = (jnp.stack(res.lam) if res.lam
           else jnp.zeros((0, B), x0.dtype))
    return res._replace(x=jnp.stack(res.x), lam=lam)


def tron_batched(
    obj_fn: Callable,   # (x rows, params) -> (B,)
    x0, xl, xu, params, **kwargs
):
    """Plain bound-constrained batched TRON (no constraints/ALM), rows layout."""

    def obj_alm(x, p, lam, mu):
        del lam, mu
        return obj_fn(x, p)

    def cons(x, p):
        del x, p
        return ()

    B = x0.shape[1]
    lam0 = jnp.zeros((0, B), x0.dtype)
    mu0 = jnp.full((B,), 10.0, x0.dtype)
    kwargs.setdefault("max_auglag", 1)
    return tron_alm_batched(obj_alm, cons, x0, xl, xu, params, lam0, mu0,
                            **kwargs)
