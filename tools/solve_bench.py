"""Wall-time-to-tolerance benchmark: full fused solves from a flat start.

bench.py measures steady-state iterations/sec with convergence disabled
(fixed work per dispatch); this records the complementary end-to-end metric —
the BASELINE.md north star — so it/s cannot hide iteration-count inflation:

    {secs_to_tol, cumul, outer, obj, mismatch, tol, status}

per case, in the production configuration (fp32, the default solver
selection: the fused TRON kernel on a GPU), from a flat start to mismatch
<= sqrt(nvar) * outer_eps or the outer iteration limit. The solve runs ONCE
to compile, then re-runs from the same flat start on the cached executable
for the timed number (compile time is reported apart).

Env knobs: SOLVE_BENCH_CASES="9241,70000" (synthetic bus counts),
SOLVE_BENCH_OUTERS (default 40), SOLVE_BENCH_EPS (default 2e-4),
SOLVE_BENCH_DTYPE=fp32|fp64 (fp64 batches take the XLA path),
SOLVE_BENCH_RHO_PQ / SOLVE_BENCH_RHO_VA (default 4e2 / 4e4 — the reference
tunes rho per case, README.md:54-65: 9241pegase wants 5e1/5e3),
SOLVE_BENCH_TWO_PASS=0 to disable pass-1 truncation (full-budget control),
SOLVE_BENCH_LINE_RATIO (synthetic nline/nbus, default 1.7),
SOLVE_BENCH_DRIVER=fused|host (default fused; host steps the outer loop on
the host, one dispatch per outer round — bit-identical trajectory),
SOLVE_BENCH_OUT (write the JSON to a file as well as stdout).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

USE_F64 = (os.environ.get("SOLVE_BENCH_DTYPE", "fp32") == "fp64"
           or os.environ.get("SOLVE_BENCH_MIXED", "0") == "1")  # mixed = fp64 state
if USE_F64:
    import jax
    jax.config.update("jax_enable_x64", True)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def run_case(nbus: int, outers: int, eps: float):
    from exaadmm_tpu.algorithms.admm_two_level import (admm_two_level,
                                                       make_fused_solver,
                                                       make_inner_loop)
    from exaadmm_tpu.models.acopf import model as M
    from exaadmm_tpu.utils.environment import IterationInformation, Parameters
    from exaadmm_tpu.utils.synthetic import synthetic_case

    dtype = jnp.float64 if USE_F64 else jnp.float32
    mixed = os.environ.get("SOLVE_BENCH_MIXED", "0") == "1"  # implies fp64
    line_ratio = float(os.environ.get("SOLVE_BENCH_LINE_RATIO", 1.7))
    data = synthetic_case(nbus, seed=0, line_ratio=line_ratio)
    par = Parameters(
        mixed_precision=mixed,
        branch_two_pass=os.environ.get("SOLVE_BENCH_TWO_PASS", "1") == "1",
        verbose=0,
        tron_step_cap=int(os.environ.get("BENCH_STEP_CAP", 12)),
        branch_pass1_cap=int(os.environ.get("BENCH_P1CAP", 2)),
        sort_lines=os.environ.get("BENCH_SORT", "0") == "1",
        bus_backend=os.environ.get("BENCH_BUS", "auto"),
        tron_trial_unroll=(tuple(
            int(v) for v in os.environ["BENCH_UNROLL"].split(","))
            if "BENCH_UNROLL" in os.environ else "auto"),
        inner_iterlim=int(os.environ.get("BENCH_INNER", 1000)),
        outer_iterlim=outers,
        outer_eps=eps,
    )
    model = M.build_model(data, par, dtype=dtype)
    par.scale = 1e-4
    gd = model.grid
    sqrt_d = float(model.nvar) ** 0.5

    rho_pq = float(os.environ.get("SOLVE_BENCH_RHO_PQ", 4e2))
    rho_va = float(os.environ.get("SOLVE_BENCH_RHO_VA", 4e4))
    driver = os.environ.get("SOLVE_BENCH_DRIVER", "fused")

    if driver == "host":
        run_inner = make_inner_loop(model, par.inner_iterlim)

        def solve():
            sol = M.init_solution(model, rho_pq, rho_va)
            info = IterationInformation()
            t0 = time.perf_counter()
            sol, info = admm_two_level(model, sol, info, run_inner=run_inner)
            return info, time.perf_counter() - t0

        info, secs = solve()    # compile + first run
        if os.environ.get("SOLVE_BENCH_ONCE", "0") != "1":
            info, secs = solve()  # timed run on the cached executables
        cumul, outer = info.cumul, info.outer
        obj, mismatch = info.objval, info.mismatch
    else:
        run = make_fused_solver(model)
        args = (gd.Pd, gd.Qd, gd.pgmin, gd.pgmax)

        def solve():
            sol = M.init_solution(model, rho_pq, rho_va)
            t0 = time.perf_counter()
            out = run(sol, 1e3, *args)
            jax.block_until_ready(out)
            return out, time.perf_counter() - t0

        out, _ = solve()        # compile + first run
        out, secs = solve()     # timed run on the cached executable
        cumul, outer = int(out.cumul), int(out.outer)
        obj, mismatch = float(out.objval), float(out.mismatch)

    tol = sqrt_d * eps
    return {
        "case": f"synth{nbus}bus_{data.nline}line",
        "secs_to_tol": round(secs, 3),
        "cumul": cumul,
        "outer": outer,
        "obj": obj,
        "mismatch": mismatch,
        "tol": tol,
        "status": "Solved" if mismatch <= tol else "IterationLimit",
        "iters_per_sec_e2e": round(cumul / secs, 1),
    }


def main():
    cases = [int(c) for c in
             os.environ.get("SOLVE_BENCH_CASES", "9241").split(",")]
    outers = int(os.environ.get("SOLVE_BENCH_OUTERS", 40))
    eps = float(os.environ.get("SOLVE_BENCH_EPS", 2e-4))

    mixed = os.environ.get("SOLVE_BENCH_MIXED", "0") == "1"
    results = {
        "metric": "wall_secs_to_outer_tolerance_flat_start",
        "dtype": ("fp64+fp32branch" if mixed
                  else ("fp64" if USE_F64 else "fp32")),
        "outer_eps": eps,
        "outer_iterlim": outers,
        "config": {
            "tron_step_cap": int(os.environ.get("BENCH_STEP_CAP", 12)),
            "branch_pass1_cap": int(os.environ.get("BENCH_P1CAP", 2)),
            "inner_iterlim": int(os.environ.get("BENCH_INNER", 1000)),
            "sort_lines": os.environ.get("BENCH_SORT", "0") == "1",
            "bus_backend": os.environ.get("BENCH_BUS", "auto"),
            "trial_unroll": os.environ.get("BENCH_UNROLL"),
            "platform": jax.devices()[0].platform,
            "device_kind": jax.devices()[0].device_kind,
            "driver": os.environ.get("SOLVE_BENCH_DRIVER", "fused"),
            "rho_pq": float(os.environ.get("SOLVE_BENCH_RHO_PQ", 4e2)),
            "rho_va": float(os.environ.get("SOLVE_BENCH_RHO_VA", 4e4)),
            "branch_two_pass":
                os.environ.get("SOLVE_BENCH_TWO_PASS", "1") == "1",
            "line_ratio": float(os.environ.get("SOLVE_BENCH_LINE_RATIO", 1.7)),
        },
        "cases": [run_case(nbus, outers, eps) for nbus in cases],
    }
    line = json.dumps(results)
    print(line)
    out_path = os.environ.get("SOLVE_BENCH_OUT")
    if out_path:
        with open(out_path, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
