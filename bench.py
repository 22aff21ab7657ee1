"""Benchmark: steady-state ADMM inner iterations/sec at case9241pegase scale.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
...}. Needs a GPU: it refuses to time anything on the CPU.

Grid: synthetic 9241-bus / ~16k-line case (pegase9241 dimensions; the real
MATPOWER artifact is not redistributable in this zero-egress image). The
timed unit is the fused production solver — batched branch TRON/ALM solves,
bus consensus, z/l/residual updates, lz/beta between inner loops — as ONE
dispatch of ``BENCH_OUTERS`` outer rounds x ``BENCH_INNER`` inner iterations,
continuing from a warmed-up mid-solve state (warm multipliers), matching how
the reference's per-iteration cost is dominated by its branch kernel
(SURVEY.md §3.2).

Baseline: the reference repo publishes no wall-clock numbers (BASELINE.md);
its papers report ~100 ADMM iterations/sec on 9241pegase on V100/A100-class
GPUs (arXiv:2110.06879 reports ~0.01 s/iteration at that scale).
vs_baseline is measured iters/sec divided by that 100 it/s proxy.

Knobs (environment): BENCH_NBUS, BENCH_BACKEND (branch_backend), BENCH_BUS
(bus_backend), BENCH_STEP_CAP, BENCH_INNER, BENCH_OUTERS, BENCH_REPEATS.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

BASELINE_ITERS_PER_SEC = 100.0


def steady_state_its(data, *, dtype=jnp.float32, inner_iters=20, outers=25,
                     repeats=3, rho=(400.0, 40000.0), **par_kwargs):
    """Best-of-``repeats`` inner iterations/s of the fused solver, one
    dispatch of ``outers`` x ``inner_iters`` iterations each, after a
    warm-up dispatch that compiles and reaches a steady mid-solve state.
    ``par_kwargs`` override :class:`Parameters` (``tron_step_cap`` defaults
    to the fp32 production value 12). Returns a dict with ``its``,
    ``compile_s`` (warm-up dispatch, compile included) and the last
    dispatch's two-pass counters."""
    from exaadmm_tpu.algorithms.admm_two_level import make_fused_solver
    from exaadmm_tpu.models.acopf import model as M
    from exaadmm_tpu.utils.environment import Parameters

    par_kwargs.setdefault("tron_step_cap", 12)
    par = Parameters(verbose=0, inner_iterlim=inner_iters,
                     outer_iterlim=outers,
                     outer_eps=0.0,  # never converge: fixed work per rep
                     **par_kwargs)
    model = M.build_model(data, par, dtype=dtype)
    sol = M.init_solution(model, *rho)
    run = make_fused_solver(model)
    gd = model.grid
    args = (gd.Pd, gd.Qd, gd.pgmin, gd.pgmax)

    t0 = time.perf_counter()
    out = run(sol, 1e3, *args)
    jax.block_until_ready(out)
    warm_s = time.perf_counter() - t0
    sol = out.sol

    best = 0.0
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = run(sol, float(out.beta), *args)
        jax.block_until_ready(out)
        best = max(best, int(out.cumul) / (time.perf_counter() - t0))
        sol = out.sol
    return {"its": best, "compile_s": warm_s,
            "pass1_unfinished": int(out.pass1_unfinished),
            "tail_overflow": int(out.tail_overflow),
            "branch_backend": par.branch_backend,
            "bus_backend": par.bus_backend}


def main():
    from exaadmm_tpu.utils.compile_cache import enable_compile_cache
    from exaadmm_tpu.utils.synthetic import synthetic_case

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py times the GPU; JAX found {dev.platform!r}")
    enable_compile_cache()
    nbus = int(os.environ.get("BENCH_NBUS", 9241))
    data = synthetic_case(nbus, seed=0, line_ratio=1.7)
    res = steady_state_its(
        data,
        inner_iters=int(os.environ.get("BENCH_INNER", 20)),
        outers=int(os.environ.get("BENCH_OUTERS", 25)),
        repeats=int(os.environ.get("BENCH_REPEATS", 3)),
        tron_step_cap=int(os.environ.get("BENCH_STEP_CAP", 12)),
        branch_backend=os.environ.get("BENCH_BACKEND", "auto"),
        bus_backend=os.environ.get("BENCH_BUS", "auto"))
    print(json.dumps({
        "metric": f"admm_inner_iters_per_sec_synth{nbus}bus_{data.nline}line",
        "value": res["its"],
        "unit": "iters/s",
        "vs_baseline": res["its"] / BASELINE_ITERS_PER_SEC,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        **{k: v for k, v in res.items() if k != "its"},
    }))


if __name__ == "__main__":
    main()
