"""Slope-timed cost attribution of one mpacopf inner iteration.

Chains N full iterations inside one jitted fori_loop on a warmed mid-solve
state, then ablates one component at a time (branch batch / ramp generator
ALM / vmapped bus update / z+l+residual) to attribute cost — the mpacopf
counterpart of tools/hook_bench.py, built for VERDICT r4 task #5 (13.8 it/s
at T=8 x 4,877 lines = ~5% of the flagship per-lane rate, unattributed).

Env: BENCH_NBUS (default 2869), BENCH_T (default 8), BENCH_N (chain length,
default 20), BENCH_STEP_CAP (default 12), BENCH_BACKEND (default auto).
Run on the GPU, in one process, so both sides of every comparison share one
card.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


def main():
    from exaadmm_tpu.models.mpacopf import model as mp_M
    from exaadmm_tpu.utils.environment import Parameters
    from exaadmm_tpu.utils.synthetic import synthetic_case

    nbus = int(os.environ.get("BENCH_NBUS", 2869))
    T = int(os.environ.get("BENCH_T", 8))
    N = int(os.environ.get("BENCH_N", 20))
    data = synthetic_case(nbus, seed=0)
    rng = np.random.default_rng(1)
    profile = 1.0 + 0.04 * rng.standard_normal((T,))
    pd_mat = np.asarray(data.Pd)[:, None] * profile[None, :]
    qd_mat = np.asarray(data.Qd)[:, None] * profile[None, :]

    par = Parameters(
        verbose=0,
        tron_step_cap=int(os.environ.get("BENCH_STEP_CAP", 12)),
        branch_backend=os.environ.get("BENCH_BACKEND", "auto"), scale=1e-4,
        inner_iterlim=20, outer_iterlim=3, outer_eps=0.0,
    )
    model = mp_M.build_model(data, par, pd_mat, qd_mat,
                             start_period=1, end_period=T)
    sol0 = mp_M.init_solution(model, 400.0, 40000.0)

    # warm up to a mid-solve state with the host-stepped driver
    from exaadmm_tpu.algorithms.admm_two_level import admm_two_level_fused
    from exaadmm_tpu.utils.environment import IterationInformation
    sol, info = admm_two_level_fused(model, sol0, IterationInformation())
    beta = jnp.asarray(par.beta, sol.acopf.u.gen.dtype)
    two = jnp.asarray(2, jnp.int32)

    def iter_fn(skip=None):
        def body(s):
            s = model.inner_prestep(s)
            if skip != "x":
                s, _ = model.update_x(s, two)
            if skip != "xbar":
                s = model.update_xbar(s)
            if skip != "zlr":
                s = model.update_z(s, beta)
                s = model.update_l(s, beta)
                s, _ = model.update_residual(s, beta)
            return s
        return body

    def timeit(name, body):
        f = jax.jit(lambda s: lax.fori_loop(0, N, lambda i, ss: body(ss), s))
        r = f(sol)
        jax.block_until_ready(r)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            r = f(sol)
            jax.block_until_ready(r)
            best = min(best, (time.perf_counter() - t0) / N)
        print(f"{name:16s} {best*1e6:9.1f} us/iter "
              f"({1.0/best:7.1f} it/s equivalent)")
        return best

    full = timeit("full", iter_fn())
    for skip in ["x", "xbar", "zlr"]:
        t = timeit(f"-{skip}", iter_fn(skip))
        print(f"   {skip:13s} contributes {max(full-t,0)*1e6:9.1f} us")

    # split update_x: ramp ALM alone (feeds the chain through ramp state)
    def ramp_only(s):
        s = model.inner_prestep(s)
        res = model._ramp_alm_update(s, two)
        ngen = model.grid.ngen
        rp = s.ramp.replace(
            u=jnp.concatenate([jnp.zeros((1, ngen), res.x.dtype),
                               res.x[1].reshape(T - 1, ngen)], 0))
        return s.replace(ramp=rp)
    t_ramp = timeit("ramp-alm only", ramp_only)
    print(f"   ramp ALM standalone cost ~ {t_ramp*1e6:9.1f} us")


if __name__ == "__main__":
    main()
