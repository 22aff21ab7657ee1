"""Fused TRON/ALM kernel vs the XLA path on one GPU.

    python tools/kernel_ab.py [--out traces/kernel_ab.json]
                              [--sweep] [--trace]     # neither: both

1. ``--sweep``: times the synth-9241 branch batch (15,710 lanes, fp32, one
   pass, lockstep step cap 12, perturbed prox targets) through the kernel at
   several (tile, num_warps) and through the XLA path (best of 5 calls).
2. With ``--trace``: one profiler trace per path of a steady dispatch of the
   fused solver (bench.py's unit, 2 outer x 20 inner iterations; the trace
   files go to ``traces/`` in the checkout) and, from
   it, the device's idle share over the dispatch and the device ops that
   take the most time. Busy time is the union of the intervals of the
   events on the GPU plane's stream lines; the window is the host span of
   the traced dispatch.

Prints one JSON object (also written to ``--out``) with the card's name and
power limit beside every number.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SWEEP = ((32, 1), (64, 1), (64, 2), (128, 2), (128, 4), (256, 4), (256, 8))


def branch_batch(data):
    import jax.numpy as jnp

    from chip_smoke import _perturbed_branch_inputs, production_params
    from exaadmm_tpu.models.acopf.branch import (
        _branch_params, _warm_start_x0)

    par = production_params()
    model, sol = _perturbed_branch_inputs(data, par)
    x0, xl, xu = _warm_start_x0(sol.u.line, model.grid, True)
    params = _branch_params(sol, model.grid, par)
    lam0 = jnp.stack([sol.branch_alm.lam1, sol.branch_alm.lam2])
    eps = float(jnp.finfo(jnp.float32).eps)
    kw = dict(gtol=40 * eps, frtol=10 * eps, ctol=300 * eps,
              mu_max=0.1 / eps, max_minor=200, max_auglag=50, step_cap=12,
              active0=model.grid.line_mask > 0.5)
    return (x0, xl, xu, params, lam0, sol.branch_alm.mu), kw


def time_solver(solver, args, kw, reps=5):
    import jax

    from exaadmm_tpu.models.acopf.branch import (
        branch_alm_delta, branch_cons_linelimit, branch_fgh_linelimit,
        branch_obj_linelimit)

    fn = jax.jit(lambda *a: solver(
        branch_obj_linelimit, branch_cons_linelimit, *a,
        fgh_fn=branch_fgh_linelimit, alm_delta_fn=branch_alm_delta, **kw))
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    compile_s = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        best = min(best, time.perf_counter() - t0)
    return {"compile_s": compile_s, "best_ms": best * 1e3}


def sweep(data):
    from exaadmm_tpu.ops.tron import tron_alm_batched
    from exaadmm_tpu.ops.tron_pallas import tron_alm_batched_pallas

    args, kw = branch_batch(data)
    rows = [{"path": "xla", **time_solver(tron_alm_batched, args, kw)}]
    print(json.dumps(rows[-1]), flush=True)
    for tile, warps in SWEEP:
        res = time_solver(tron_alm_batched_pallas, args,
                          dict(kw, tile=tile, num_warps=warps))
        rows.append({"path": "kernel", "tile": tile, "num_warps": warps,
                     **res})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def _union_ns(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def idle_share(trace_dir, window_name):
    """Idle share of the GPU over the host span named ``window_name``."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    prof = ProfileData.from_file(path)
    window = None
    for plane in prof.planes:
        if plane.name.startswith("/host"):
            for line in plane.lines:
                for ev in line.events:
                    if ev.name == window_name:
                        window = (ev.start_ns, ev.end_ns)
    gpu = [p for p in prof.planes if p.name.startswith("/device:GPU")]
    lines = {ln.name: list(ln.events) for ln in gpu[0].lines}
    w0, w1 = window
    busy, per_op = [], {}
    for name, events in lines.items():
        if not name.startswith("Stream"):
            continue
        for ev in events:
            s, e = max(ev.start_ns, w0), min(ev.end_ns, w1)
            if e > s:
                busy.append((s, e))
                per_op[ev.name] = per_op.get(ev.name, 0) + (e - s)
    span = w1 - w0
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:12]
    return {"window_ms": span / 1e6,
            "busy_ms": _union_ns(busy) / 1e6,
            "idle_share": 1.0 - _union_ns(busy) / span,
            "device_lines": {k: len(v) for k, v in lines.items()},
            "top_ops_ms": [(k, v / 1e6) for k, v in top]}


def traces(data, out_dir):
    import jax

    from exaadmm_tpu.algorithms.admm_two_level import make_fused_solver
    from exaadmm_tpu.models.acopf import model as M
    from exaadmm_tpu.utils.environment import Parameters

    res = {}
    for backend in ("auto", "xla"):
        par = Parameters(verbose=0, tron_step_cap=12, inner_iterlim=20,
                         outer_iterlim=2, outer_eps=0.0,
                         branch_backend=backend)
        model = M.build_model(data, par, dtype=jax.numpy.float32)
        sol = M.init_solution(model, 400.0, 40000.0)
        run = make_fused_solver(model)
        gd = model.grid
        args = (gd.Pd, gd.Qd, gd.pgmin, gd.pgmax)
        out = jax.block_until_ready(run(sol, 1e3, *args))   # warm-up
        d = os.path.join(out_dir, f"trace_{backend}")
        with jax.profiler.trace(d):
            with jax.profiler.TraceAnnotation("steady_window"):
                out = jax.block_until_ready(
                    run(out.sol, float(out.beta), *args))
        res[backend] = {"iters": int(out.cumul),
                        **idle_share(d, "steady_window")}
        print(json.dumps({backend: res[backend]}), flush=True)
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "traces",
                                                  "kernel_ab.json"))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args()
    if not (args.sweep or args.trace):
        args.sweep = args.trace = True

    import jax

    from chip_smoke import card_line
    from exaadmm_tpu.utils.compile_cache import enable_compile_cache
    from exaadmm_tpu.utils.synthetic import synthetic_case

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"kernel_ab.py measures a GPU; JAX found {dev.platform!r}")
    enable_compile_cache()
    card = card_line()
    data = synthetic_case(9241, seed=0, line_ratio=1.7)
    summary = {"card": card, "device_kind": dev.device_kind}
    if args.sweep:
        summary["sweep"] = sweep(data)
    if args.trace:
        summary["trace"] = traces(data, os.path.join(ROOT, "traces"))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
