"""Throughput benchmarks for the secondary models: mpacopf and qpsub.

Complements bench.py (ACOPF). Prints one JSON line per model in the bench.py
format. The timed unit is the fused production dispatch with convergence
disabled (outer_eps=0 / tolerances 0), i.e. fixed work per repetition.

    python tools/model_bench.py qpsub      # ~16k-line one-level iterations/s
    python tools/model_bench.py mpacopf    # T x nline branch-batch iters/s
    python tools/model_bench.py all
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def bench_qpsub():
    """One-level ADMM iterations/s at pegase-9241 scale (15710 lines).

    The qpsub regime is thousands of cheap iterations (reference case9
    regression runs 5107); per-iteration cost is one reduced 6-var QP batch +
    bus/l/residual. SQP inputs derived from the NR power-flow base point via
    the packaged builder (models/qpsub/sqp.py)."""
    from exaadmm_tpu.algorithms.admm_one_level import _one_level_while
    from exaadmm_tpu.models.qpsub import model as Q
    from exaadmm_tpu.models.qpsub.sqp import SqpBasePoint, build_qp_inputs
    from exaadmm_tpu.utils.environment import Parameters
    from exaadmm_tpu.utils.grid_data import build_grid_data
    from exaadmm_tpu.utils.synthetic import synthetic_case

    nbus = int(os.environ.get("BENCH_NBUS", 9241))
    iters = int(os.environ.get("BENCH_QPSUB_ITERS", 200))
    reps = int(os.environ.get("BENCH_REPEATS", 3))
    dtype = jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32

    data = synthetic_case(nbus, seed=0)
    gd = build_grid_data(data, dtype=dtype)
    base = SqpBasePoint(pg=np.asarray(data.Pg0), qg=np.asarray(data.Qg0),
                        vm=np.asarray(data.Vm), va=np.asarray(data.Va))
    qp = build_qp_inputs(data, gd, base)

    par = Parameters(verbose=0, scale=1e-4, outer_iterlim=iters, outer_eps=0.0,
                     tron_step_cap=int(os.environ.get("BENCH_STEP_CAP", 24)),
                     branch_backend=os.environ.get("BENCH_BACKEND", "auto"))
    model = Q.build_model(gd, par, qp, dtype=dtype)
    sol = model.one_level_reset(Q.init_solution(model, 4e3, 4e3))

    @jax.jit
    def run(s):
        return _one_level_while(model, s, 0.0, 0.0, iters)

    c = run(sol)
    jax.block_until_ready(c)
    best = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        c = run(c.sol)
        jax.block_until_ready(c)
        best = max(best, iters / (time.perf_counter() - t0))
    print(json.dumps({
        "metric": f"qpsub_one_level_iters_per_sec_synth{nbus}bus_{data.nline}line",
        "value": round(best, 3),
        "unit": "iters/s",
        "vs_baseline": None,
    }))
    return best


def bench_mpacopf():
    """mpacopf inner iterations/s: the T x nline branch batch is the largest
    batch shape in the package (T periods solved simultaneously, coupled by
    per-generator ramp consensus)."""
    from exaadmm_tpu.algorithms.admm_two_level import (admm_two_level_fused,
                                                       make_fused_solver)
    from exaadmm_tpu.models.mpacopf import model as mp_M
    from exaadmm_tpu.utils.environment import Parameters
    from exaadmm_tpu.utils.synthetic import synthetic_case

    nbus = int(os.environ.get("BENCH_MP_NBUS", 2869))
    T = int(os.environ.get("BENCH_MP_T", 8))
    inner = int(os.environ.get("BENCH_INNER", 20))
    outers = int(os.environ.get("BENCH_MP_OUTERS", 5))
    reps = int(os.environ.get("BENCH_REPEATS", 3))
    dtype = jnp.float64 if jax.config.read("jax_enable_x64") else jnp.float32

    data = synthetic_case(nbus, seed=0)
    rng = np.random.default_rng(0)
    profile = 1.0 + 0.05 * rng.standard_normal(T)
    pd_mat = np.outer(np.asarray(data.Pd), profile)
    qd_mat = np.outer(np.asarray(data.Qd), profile)

    par = Parameters(verbose=0, scale=1e-4, outer_iterlim=outers,
                     inner_iterlim=inner, outer_eps=0.0,
                     tron_step_cap=int(os.environ.get("BENCH_STEP_CAP", 24)),
                     branch_backend=os.environ.get("BENCH_BACKEND", "auto"))
    model = mp_M.build_model(data, par, pd_mat, qd_mat,
                             start_period=1, end_period=T, dtype=dtype)
    sol = mp_M.init_solution(model, 4e2, 4e4)

    # ONE compiled solver reused across reps (admm_two_level_fused with
    # run=None builds a fresh jit closure per call — that recompiles every
    # rep and the round-4 13.8 it/s artifact was mostly compile time)
    run = make_fused_solver(model)
    sol, info = admm_two_level_fused(model, sol, run=run)  # compile + warm
    best = 0.0
    for _ in range(reps):
        sol2, info = admm_two_level_fused(model, sol, run=run)
        best = max(best, info.cumul / info.time_overall)
    print(json.dumps({
        "metric": (f"mpacopf_inner_iters_per_sec_synth{nbus}bus_"
                   f"{data.nline}line_T{T}"),
        "value": round(best, 3),
        "unit": "iters/s",
        "vs_baseline": None,
    }))
    return best


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("qpsub", "all"):
        bench_qpsub()
    if which in ("mpacopf", "all"):
        bench_mpacopf()


if __name__ == "__main__":
    main()
