"""Solo-hook microbenchmark: time each inner-iteration hook chained ALONE
inside one jitted fori_loop (complement to hook_bench.py's ablation — the
ablation underestimates hooks whose work fuses into neighbours).

Run on the GPU, in one process, so both sides of every comparison share one
card.
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
    par = Parameters(verbose=0, tron_step_cap=24, sort_lines=True,
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

    hooks = {
        "prestep": lambda s: s.replace(z=s.z_prev, z_prev=s.z),  # swap so not DCE'd
        "x": lambda s: model.update_x(s, one)[0],
        "xbar": lambda s: s.replace(u=model.update_xbar(s).v[..., :0] if False else s.u,
                                    v=model.update_xbar(s).v),
        "z": lambda s: s.replace(z=model.update_z(s, beta).z, z_prev=s.z),
        "l": lambda s: s.replace(l=model.update_l(s, beta).l),
        "residual": lambda s: model.update_residual(s, beta)[0],
    }
    # cleaner xbar: feed v back into u so the chain isn't constant-folded
    def xbar_chain(s):
        s2 = model.update_xbar(s)
        return s2.replace(u=s2.u.replace(line=s2.u.line + 1e-20 * s2.v.line))
    hooks["xbar"] = xbar_chain

    def zl_chain(s):
        s = model.update_z(s, beta)
        s = model.update_l(s, beta)
        s, _ = model.update_residual(s, beta)
        # feed residual back so nothing is dead
        return s.replace(z=s.z.replace(line=s.z.line + 1e-20 * s.rp.line))
    hooks["z+l+res"] = zl_chain

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
        print(f"{name:10s} {best*1e6:9.1f} us/iter")
        return best

    for name, body in hooks.items():
        timeit(name, body)


if __name__ == "__main__":
    main()
