"""Smoke test of the solver's main path on NVIDIA GPUs.

    python chip_smoke.py            # phases (a)-(f) on one card
    python chip_smoke.py --chips 4  # the sharded fused solve on four cards

One process drives the card(s). The script refuses to run (non-zero exit, no
result line) unless JAX's first device is a GPU. Every phase raises on a
failed check, so any failure ends the run with a non-zero exit. Each phase
prints one line with its seconds (compile apart from run where both exist)
and the card's name and power limit; the last line of standard output is one
JSON object ``{"ok": true, "device": {...}}``.

Phases of the default run (synth-9241: ``synthetic_case(9241, seed=0,
line_ratio=1.7)``, 15,710 lines, fp32):

  a. compile the fused production solver (branch kernel included) at real
     widths and print its memory analysis;
  b. branch_update with the fused TRON kernel vs the XLA path, and the bf16
     split KR bus scatters under jit vs a float64 ``np.add.at``;
  c. the fp32 fused production solve to tolerance at rho (3e3, 3e5), with
     the kernel and with the XLA path, plus steady-state inner it/s of both;
  d. steady-state inner it/s with the bus scatter ``segsum`` vs ``kr_win``;
  f. one fp32 mpacopf and one fp32 qpsub fused solve;
  e. case118 in fp64 through ``solve_acopf`` (runs last: it turns x64 on).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TUNED_RHO = (3e3, 3e5)          # synth-9241 fp32 production rho
CASE118 = os.path.join(ROOT, "data", "case118.m")
CASE9 = os.path.join(ROOT, "data", "case9.m")


def card_line() -> str:
    """``name, power.limit`` of the first card, read by a child process
    that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Report:
    def __init__(self, card: str):
        self.card = card

    def __call__(self, phase: str, text: str, **secs):
        t = " ".join(f"{k}={v:.3f}" for k, v in secs.items())
        print(f"[{phase}] {text} {t} card=({self.card})", flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def production_params(**kw):
    from exaadmm_tpu.utils.environment import Parameters

    base = dict(verbose=0, tron_step_cap=12, outer_eps=2e-4,
                outer_iterlim=40, scale=1e-4)
    base.update(kw)
    return Parameters(**base)


def _compile(run, *args):
    """``(compiled, seconds, lowered)`` of a jitted function."""
    t0 = time.perf_counter()
    lowered = run.lower(*args)
    compiled = lowered.compile()
    return compiled, time.perf_counter() - t0, lowered


def _fused_args(model):
    return (model.par.initial_beta, model.default_Pd(), model.default_Qd(),
            model.pgmin_curr, model.pgmax_curr)


def build_production(data, **kw):
    import jax.numpy as jnp

    from exaadmm_tpu.algorithms.admm_two_level import make_fused_solver
    from exaadmm_tpu.models.acopf import model as M

    model = M.build_model(data, production_params(**kw), dtype=jnp.float32)
    sol = M.init_solution(model, *TUNED_RHO)
    compiled, compile_s, lowered = _compile(make_fused_solver(model), sol,
                                            *_fused_args(model))
    return model, sol, compiled, compile_s, lowered


def phase_compile(report, data, branch_backend):
    model, sol, compiled, compile_s, lowered = build_production(
        data, branch_backend=branch_backend)
    mem = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    text = " ".join(f"{f}={getattr(mem, f, None)}" for f in fields)
    report("a", f"fused solver compiled: nline={model.grid.nline} fp32 "
           f"branch_backend={branch_backend} memory_analysis: {text}",
           compile_s=compile_s)
    check("tron_alm" in lowered.as_text(),
          "the fused solver does not call the TRON kernel")
    return model, sol, compiled


def _perturbed_branch_inputs(data, par):
    import jax.numpy as jnp
    import numpy as np

    from exaadmm_tpu.models.acopf import model as M

    model = M.build_model(data, par, dtype=jnp.float32)
    sol = M.init_solution(model, 400.0, 40000.0)
    # perturb prox targets so lanes have a spread of difficulties
    rng = np.random.default_rng(0)
    v_line = sol.v.line + jnp.asarray(
        rng.normal(0, 0.05, sol.v.line.shape), jnp.float32)
    return model, sol.replace(v=sol.v.replace(line=v_line))


def phase_kernel_vs_reference(report, data, branch_backend):
    """The kernel and the XLA path run the same lockstep state machine; the
    two compilers round fp32 differently, which flips a few data-dependent
    TRON branches. At the lockstep cap of 24 steps a lane cut off mid-solve
    stops wherever its trajectory was, so there the checks are: under 10%
    of lanes with a different step count, lanes with the same trajectory
    within 1e-3, lanes that finished within the cap in both paths (same
    step count as uncapped) within 5e-3, and max_cviol within 5%. With no
    effective cap (2000 steps) every lane finishes, and all lanes agree
    within 5e-3 in all eight columns of u."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from exaadmm_tpu.models.acopf.branch import branch_update

    par = production_params(branch_two_pass=False,
                            branch_backend=branch_backend)
    model, sol = _perturbed_branch_inputs(data, par)
    inner = jnp.asarray(2, jnp.int32)
    nl = model.grid.nline
    outs, secs = {}, {}
    for cap in (24, 2000):
        for name, bb in (("kernel", branch_backend), ("xla", "xla")):
            p = dataclasses.replace(par, tron_step_cap=cap, branch_backend=bb)
            fn = jax.jit(lambda s, p=p: branch_update(s, model.grid, p, inner))
            compiled, secs[f"{name}{cap}_compile_s"], _ = _compile(fn, sol)
            t0 = time.perf_counter()
            u, _, st = jax.block_until_ready(compiled(sol))
            secs[f"{name}{cap}_run_s"] = time.perf_counter() - t0
            outs[name, cap] = (np.asarray(u)[:nl],
                               np.asarray(st["lane_steps"])[:nl],
                               float(st["max_cviol"]))

    (u_k, steps_k, cv_k), (u_x, steps_x, cv_x) = outs["kernel", 24], \
        outs["xla", 24]
    du = np.abs(u_k - u_x).max(axis=1)
    same = steps_k == steps_x
    done = (steps_k == outs["kernel", 2000][1]) & (
        steps_x == outs["xla", 2000][1])
    frac = 1.0 - same.mean()
    err_same, err_done = float(du[same].max()), float(du[done].max())
    err_cut = float(du[~done].max()) if (~done).any() else 0.0
    err_free = float(np.abs(outs["kernel", 2000][0]
                            - outs["xla", 2000][0]).max())
    report("b", f"branch kernel vs xla: lanes={nl} cap 24: "
           f"diverged={frac:.4f} max|du| same-trajectory={err_same:.3e} "
           f"finished-in-both ({done.mean():.4f} of lanes)={err_done:.3e} "
           f"cut-off={err_cut:.3e} max_cviol kernel={cv_k:.4e} "
           f"xla={cv_x:.4e}; cap 2000: max|du| all lanes={err_free:.3e}",
           **secs)
    check(frac < 0.10, f"{frac:.1%} of lanes took a different step count")
    check(err_same <= 1e-3, f"same-trajectory lanes differ by {err_same}")
    check(err_done <= 5e-3, f"finished lanes differ by {err_done}")
    check(abs(cv_k - cv_x) <= 0.05 * max(cv_k, cv_x) + 1e-5,
          f"max_cviol disagrees: kernel {cv_k} vs xla {cv_x}")
    check(err_free <= 5e-3, f"uncapped lanes differ by {err_free}")

    # the bf16 three-term split of the KR scatters must survive the GPU
    # compiler's simplifier (kernels.py keeps it with optimization barriers)
    from exaadmm_tpu.models.acopf.kernels import (
        build_kr_window_setup, kr_scatter, kr_scatter_windowed)

    gd = model.grid
    fr, to = np.asarray(gd.line_from), np.asarray(gd.line_to)
    rng = np.random.default_rng(3)
    vf = rng.standard_normal((fr.size, 8)) * 1e3
    vt = rng.standard_normal((to.size, 8)) * 1e3
    ref = np.zeros((gd.nbus, 8))
    np.add.at(ref, fr, vf)
    np.add.at(ref, to, vt)
    vf32, vt32 = jnp.asarray(vf, jnp.float32), jnp.asarray(vt, jnp.float32)
    ids = jnp.concatenate([gd.line_from, gd.line_to])
    dense = jax.jit(lambda a, b: kr_scatter(
        jnp.concatenate([a, b]), ids, gd.nbus))(vf32, vt32)
    setup = build_kr_window_setup(fr, to, gd.nbus)
    win = jax.jit(lambda a, b: kr_scatter_windowed(a, b, setup, gd.nbus))(
        vf32, vt32)
    scale = np.abs(ref).max()
    rel = {k: float(np.abs(np.asarray(v, np.float64) - ref).max() / scale)
           for k, v in (("kr", dense), ("kr_win", win))}
    report("b", f"KR bus scatter under jit vs float64 np.add.at: "
           f"rel kr={rel['kr']:.3e} kr_win={rel['kr_win']:.3e}")
    for k, v in rel.items():
        check(v < 1e-6, f"{k} scatter precision {v:.3e} >= 1e-6")


def solve_to_tolerance(model, sol, compiled):
    from exaadmm_tpu.algorithms.admm_two_level import admm_two_level_fused

    _, info = admm_two_level_fused(model, sol, run=compiled)
    tol = math.sqrt(model.nvar) * model.par.outer_eps
    check(info.status == "Solved" and info.mismatch <= tol,
          f"{info.status}: mismatch {info.mismatch:.4e} vs tol {tol:.4e}")
    return info


def phase_main_path(report, data, model, sol, compiled):
    """fp32 production solve from a flat start, kernel vs XLA path. At
    outer_eps 2e-4 the objective is still climbing when the solve stops, so
    the two paths stop at different points of it (98.1k to 105.0k over three
    runs of both on an H100); their objectives must agree within 10%, which
    that spread allows and a path that stopped far from the other does
    not."""
    import bench

    results = {}
    for name in ("kernel", "xla"):
        if name == "kernel":
            m, s, c, compile_s = model, sol, compiled, 0.0
            solve_to_tolerance(m, s, c)        # warm run (compiled in a)
        else:
            m, s, c, compile_s, _ = build_production(data,
                                                     branch_backend="xla")
        info = solve_to_tolerance(m, s, c)
        steady = bench.steady_state_its(
            data, branch_backend=m.par.branch_backend, outers=10)
        results[name] = (info, steady)
        report("c", f"fused solve {name}: status={info.status} "
               f"outer={info.outer} cumul={info.cumul} "
               f"objective={info.objval:.6f} mismatch={info.mismatch:.4e} "
               f"e2e_its={info.cumul / info.time_overall:.1f} "
               f"steady_its={steady['its']:.1f}",
               compile_s=compile_s, seconds_to_tolerance=info.time_overall,
               steady_compile_s=steady["compile_s"])
    obj_k, obj_x = results["kernel"][0].objval, results["xla"][0].objval
    rel = abs(obj_k - obj_x) / max(abs(obj_k), abs(obj_x))
    report("c", f"objective kernel vs xla: relative difference {rel:.4e}")
    check(rel <= 0.10, f"objectives disagree: kernel {obj_k} vs xla {obj_x}")
    return results


def phase_bus_policy(report, data, branch_backend):
    import bench

    its = {}
    for bb in ("segsum", "kr_win"):
        res = bench.steady_state_its(data, branch_backend=branch_backend,
                                     bus_backend=bb, outers=10)
        its[bb] = res["its"]
        report("d", f"bus_backend={bb}: steady_its={res['its']:.1f}",
               compile_s=res["compile_s"])
    return its


def phase_secondary(report, branch_backend):
    import jax.numpy as jnp
    import numpy as np

    from exaadmm_tpu.algorithms.admm_two_level import (
        admm_two_level_fused, make_fused_solver)
    from exaadmm_tpu.interface.solve_qpsub import solve_qpsub
    from exaadmm_tpu.models.mpacopf import model as mp_M
    from exaadmm_tpu.utils.synthetic import synthetic_case

    # mpacopf: synth-300, T=3, ramp-generator ALM batch through the kernel
    data = synthetic_case(300, seed=3)
    T = 3
    profile = 1.0 + 0.03 * np.random.default_rng(1).standard_normal(T)
    pd_mat = np.outer(np.asarray(data.Pd), profile)
    qd_mat = np.outer(np.asarray(data.Qd), profile)
    par = production_params(outer_iterlim=30, branch_backend=branch_backend)
    model = mp_M.build_model(data, par, pd_mat, qd_mat, start_period=1,
                             end_period=T, dtype=jnp.float32)
    sol = mp_M.init_solution(model, *TUNED_RHO)
    compiled, compile_s, _ = _compile(make_fused_solver(model), sol,
                                      *_fused_args(model))
    sol, info = admm_two_level_fused(model, sol, run=compiled)
    err = float(mp_M.check_ramp_violations(model, sol))
    report("f", f"mpacopf synth-300 T={T} fp32: status={info.status} "
           f"outer={info.outer} cumul={info.cumul} "
           f"objective={info.objval:.4f} ramp_violation={err:.3e}",
           compile_s=compile_s, run_s=info.time_overall)
    check(info.status == "Solved", f"mpacopf {info.status}")
    check(err <= 1e-2, f"mpacopf ramp violation {err}")

    # qpsub: the reference's case9 QP, one-level ADMM, reduced-QP batch
    from tests.test_qpsub import qp_inputs

    qp = qp_inputs.__wrapped__(CASE9)
    t0 = time.perf_counter()
    res = solve_qpsub(
        CASE9, qp["Hs"], qp["LH_1h"], qp["RH_1h"], qp["LH_1i"], qp["RH_1i"],
        qp["LH_1j"], qp["RH_1j"], qp["LH_1k"], qp["RH_1k"], qp["ls"],
        qp["us"], qp["pgmax"], qp["pgmin"], qp["qgmax"], qp["qgmin"],
        qp["c1"], qp["c2"], qp["Pd"], qp["Qd"], 1e5,
        outer_iterlim=20000, inner_iterlim=1, scale=1e-4, obj_scale=1.0,
        rho_pq=4000.0, rho_va=4000.0, verbose=0, outer_eps=2e-5,
        onelevel=True, dtype=jnp.float32, branch_backend=branch_backend)
    secs = time.perf_counter() - t0
    report("f", f"qpsub case9 fp32: status={res.info.status} "
           f"iterations={res.info.outer} objective={res.info.objval:.4f}",
           compile_and_run_s=secs)
    check(res.info.status == "Solved", f"qpsub {res.info.status}")
    check(-30.0 < res.info.objval < -5.0,
          f"qpsub objective {res.info.objval} outside (-30, -5)")


def phase_fp64(report):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    from exaadmm_tpu import solve_acopf

    secs = []
    for _ in range(2):   # first call compiles, second is timed alone
        t0 = time.perf_counter()
        res = solve_acopf(CASE118, dtype=jnp.float64, rho_pq=4e2,
                          rho_va=4e4, outer_eps=2e-5, outer_iterlim=25,
                          verbose=0)
        secs.append(time.perf_counter() - t0)
    info = res.info
    rel = abs(info.objval - 129645.676) / 129645.676
    report("e", f"case118 fp64 solve_acopf: status={info.status} "
           f"outer={info.outer} cumul={info.cumul} "
           f"objective={info.objval:.6f} rel_to_reference={rel:.3e}",
           compile_s=secs[0] - secs[1], run_s=secs[1])
    check(info.status == "Solved", f"case118 fp64 {info.status}")
    check(info.outer == 20, f"case118 fp64 took {info.outer} outer")
    # GPU segment_sum adds with atomics in a run-dependent order, so the
    # CPU suite's exact pins do not apply; the reference band does
    check(rel < 1e-4, f"case118 objective {info.objval} off by {rel:.2e}")


def run_one_card(report):
    from exaadmm_tpu.utils.synthetic import synthetic_case

    data = synthetic_case(9241, seed=0, line_ratio=1.7)
    model, sol, compiled = phase_compile(report, data, "auto")
    phase_kernel_vs_reference(report, data, "auto")
    results = phase_main_path(report, data, model, sol, compiled)
    backend = ("auto" if results["kernel"][0].time_overall
               < results["xla"][0].time_overall else "xla")
    phase_bus_policy(report, data, backend)
    phase_secondary(report, "auto")
    phase_fp64(report)


def run_four_cards(report):
    """Sharded fused solve over a 1-D line mesh of four cards."""
    import jax
    import jax.numpy as jnp

    from exaadmm_tpu.algorithms.admm_two_level import admm_two_level_fused
    from exaadmm_tpu.models.acopf import model as M
    from exaadmm_tpu.parallel.sharding import (
        make_mesh, make_sharded_fused_solver)
    from exaadmm_tpu.utils.synthetic import synthetic_case

    devs = jax.devices()
    check(len(devs) >= 4, f"--chips 4 needs four GPUs, found {len(devs)}")
    mesh = make_mesh(4)
    check(len({d.id for d in mesh.devices.flat}) == 4,
          "mesh does not span four distinct cards")

    # synth-9241 fp32, production config, lines sharded four ways
    data = synthetic_case(9241, seed=0, line_ratio=1.7)
    par = production_params()
    model = M.build_model(data, par, dtype=jnp.float32, pad_lines_to=4)
    sol = M.init_solution(model, *TUNED_RHO)
    compiled, compile_s, _ = _compile(
        make_sharded_fused_solver(model, mesh), sol, *_fused_args(model))
    out_sol, info = admm_two_level_fused(model, sol, run=compiled)
    shard_devs = {s.device.id for s in out_sol.u.line.addressable_shards}
    report("4", f"synth-9241 fp32 sharded x4: status={info.status} "
           f"outer={info.outer} cumul={info.cumul} "
           f"objective={info.objval:.4f} line shards on cards "
           f"{sorted(shard_devs)}",
           compile_s=compile_s, seconds_to_tolerance=info.time_overall)
    check(info.status == "Solved", f"sharded synth-9241 {info.status}")
    check(len(shard_devs) == 4, f"line shards sit on {sorted(shard_devs)}")

    # case118 fp64: sharded over four cards vs one of them
    jax.config.update("jax_enable_x64", True)
    from exaadmm_tpu import solve_acopf

    kw = dict(dtype=jnp.float64, rho_pq=4e2, rho_va=4e4, outer_eps=2e-5,
              outer_iterlim=25, verbose=0)
    t0 = time.perf_counter()
    one = solve_acopf(CASE118, **kw)
    t1 = time.perf_counter()
    four = solve_acopf(CASE118, mesh=mesh, **kw)
    t2 = time.perf_counter()
    rel = abs(four.info.objval - one.info.objval) / abs(one.info.objval)
    report("4", f"case118 fp64 sharded x4 vs one card: outer "
           f"{four.info.outer} vs {one.info.outer}, objective "
           f"{four.info.objval:.6f} vs {one.info.objval:.6f} (rel {rel:.2e})",
           one_card_s=t1 - t0, four_cards_s=t2 - t1)
    check(four.info.status == one.info.status == "Solved",
          f"case118 statuses {four.info.status} / {one.info.status}")
    check(four.info.outer == one.info.outer, "outer counts differ")
    check(rel < 1e-6, f"sharded objective off by {rel:.2e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded fused solve on four cards")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    from exaadmm_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = card_line()
    print(card, flush=True)
    report = Report(card)
    t0 = time.perf_counter()
    if args.chips == 4:
        run_four_cards(report)
    else:
        run_one_card(report)
    report("total", "all phases passed", seconds=time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
