"""Honest on-device cost breakdown of one fused inner ADMM iteration.

Chains N full iterations inside one jitted fori_loop on a warmed mid-solve
state (so nothing is loop-invariant-hoisted away), then ablates one hook at a
time (replacing it with a pass-through that still feeds the chain) to
attribute cost. Run on the GPU, in one process, so both sides of every
comparison share one card and one compile cache.
"""

import sys
import os
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
from jax import lax


def main():
    from exaadmm_tpu.algorithms.admm_two_level import make_fused_solver
    from exaadmm_tpu.models.acopf import model as M
    from exaadmm_tpu.utils.environment import Parameters
    from exaadmm_tpu.utils.synthetic import synthetic_case

    nbus = int(os.environ.get("BENCH_NBUS", 9241))
    data = synthetic_case(nbus, seed=0)
    par = Parameters(verbose=0,
                     tron_step_cap=int(os.environ.get("BENCH_STEP_CAP", 12)),
                     sort_lines=os.environ.get("BENCH_SORT", "0") == "1",
                     bus_backend=os.environ.get("BENCH_BUS", "auto"),
                     inner_iterlim=20, outer_iterlim=5, outer_eps=0.0)
    model = M.build_model(data, par, dtype=jnp.float32)
    sol0 = M.init_solution(model, 400.0, 40000.0)
    par.scale = 1e-4
    run = make_fused_solver(model)
    gd = model.grid
    out = run(sol0, 1e3, gd.Pd, gd.Qd, gd.pgmin, gd.pgmax)
    jax.block_until_ready(out)
    sol = out.sol
    beta = jnp.asarray(float(out.beta), jnp.float32)
    one = jnp.asarray(2, jnp.int32)
    N = int(os.environ.get("BENCH_N", 50))

    def iter_fn(skip=None):
        def body(s):
            if skip != "prestep":
                s = model.inner_prestep(s)
            if skip != "x":
                s, _ = model.update_x(s, one)
            if skip != "xbar":
                s = model.update_xbar(s)
            if skip != "z":
                s = model.update_z(s, beta)
            if skip != "l":
                s = model.update_l(s, beta)
            if skip != "residual":
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
        print(f"{name:16s} {best*1e6:9.1f} us/iter")
        return best

    full = timeit("full", iter_fn())
    for skip in ["prestep", "x", "xbar", "z", "l", "residual"]:
        t = timeit(f"-{skip}", iter_fn(skip))
        print(f"   {skip:13s} contributes {max(full-t,0)*1e6:9.1f} us")


if __name__ == "__main__":
    main()
