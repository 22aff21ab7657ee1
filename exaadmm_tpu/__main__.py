"""Command-line entry point: ``python -m exaadmm_tpu <case.m> [options]``.

The reference exposes configuration only as keyword arguments on the
``solve_*`` functions (SURVEY.md §5: no CLI upstream); this thin CLI maps
those same knobs onto flags for production/batch use:

    python -m exaadmm_tpu data/case9.m --rho-pq 400 --rho-va 40000
    python -m exaadmm_tpu case.m --solver mpacopf --load-prefix demand \\
        --end-period 3
    python -m exaadmm_tpu case.m --mesh 4 --fp32
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m exaadmm_tpu",
        description="Two-level ADMM solver for ACOPF on GPUs "
                    "(capabilities of exanauts/ExaAdmm.jl)")
    p.add_argument("case", help="MATPOWER .m case file")
    p.add_argument("--solver", default="acopf",
                   choices=["acopf", "rolling", "mpacopf", "pf", "qpsub",
                            "mpec"])
    p.add_argument("--rho-pq", type=float, default=400.0)
    p.add_argument("--rho-va", type=float, default=40000.0)
    p.add_argument("--outer-iterlim", type=int, default=20)
    p.add_argument("--inner-iterlim", type=int, default=1000)
    p.add_argument("--outer-eps", type=float, default=2e-4)
    p.add_argument("--scale", type=float, default=1e-4,
                   help="branch objective scaling")
    p.add_argument("--obj-scale", type=float, default=1.0)
    p.add_argument("--tight-factor", type=float, default=1.0)
    p.add_argument("--no-linelimit", action="store_true")
    p.add_argument("--projection", action="store_true",
                   help="power-flow feasibility projection after the solve")
    p.add_argument("--fp32", action="store_true",
                   help="run in float32 (the default on accelerators)")
    p.add_argument("--fp64", action="store_true",
                   help="run in float64 (the default on CPU)")
    p.add_argument("--branch-backend", default="auto",
                   choices=["auto", "xla"],
                   help="TRON/ALM batch solver (auto = the fused GPU kernel "
                        "for fp32 on a GPU, xla otherwise)")
    p.add_argument("--tron-step-cap", type=int, default=None,
                   help="lockstep trust-region step budget per branch solve")
    p.add_argument("--bus-backend", default="auto",
                   choices=["auto", "segsum", "kr", "kr_win"],
                   help="line->bus scatter backend (auto: the exact "
                        "segment_sum scatter)")
    p.add_argument("--mixed-precision", action="store_true",
                   help="fp64 solve with the branch batch in fp32 "
                        "(kernel-eligible); consensus/residual stay fp64")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="shard lines over the first N devices")
    p.add_argument("--verbose", type=int, default=1)
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="write the final solution pytree (npz) here")
    p.add_argument("--json", action="store_true",
                   help="print the result summary as one JSON line")
    # rolling / multi-period
    p.add_argument("--load-prefix", default=None,
                   help="path prefix of the {prefix}.Pd/.Qd time series")
    p.add_argument("--start-period", type=int, default=1)
    p.add_argument("--end-period", type=int, default=1)
    p.add_argument("--ramp-ratio", type=float, default=0.02)
    # qpsub (SQP inner QP)
    p.add_argument("--qp-inputs", default=None, metavar="NPZ",
                   help="npz with the SQP QP arrays (Hs, LH_1h, ... Pd, Qd); "
                        "omitted: linearize about the NR power-flow point")
    p.add_argument("--initial-beta", type=float, default=1e5)
    # mpec (primary control + storage complementarity)
    p.add_argument("--storage-ratio", type=float, default=0.0)
    p.add_argument("--droop", type=float, default=0.04)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax

    if args.fp32 and args.fp64:
        print("--fp32 and --fp64 are mutually exclusive", file=sys.stderr)
        return 2
    if getattr(args, "mixed_precision", False) and args.fp32:
        print("--mixed-precision needs the fp64 state (it casts only the "
              "branch batch down); drop --fp32", file=sys.stderr)
        return 2
    # reference-grade fp64 by default on CPU; fp32 on accelerators, where
    # the fused TRON kernel runs (fp32-only) — opt in to fp64 with --fp64;
    # --mixed-precision implies the fp64 state
    if (args.fp64 or getattr(args, "mixed_precision", False)
            or (not args.fp32 and jax.default_backend() == "cpu")):
        jax.config.update("jax_enable_x64", True)

    import exaadmm_tpu as X
    from exaadmm_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    mesh = None
    if args.mesh > 0:
        from exaadmm_tpu.parallel.sharding import make_mesh
        mesh = make_mesh(args.mesh)

    common = dict(
        rho_pq=args.rho_pq, rho_va=args.rho_va,
        outer_iterlim=args.outer_iterlim, inner_iterlim=args.inner_iterlim,
        outer_eps=args.outer_eps, scale=args.scale, obj_scale=args.obj_scale,
        tight_factor=args.tight_factor,
        use_linelimit=not args.no_linelimit,
        verbose=args.verbose,
    )

    if args.solver == "acopf":
        res = X.solve_acopf(args.case, use_projection=args.projection,
                            mesh=mesh,
                            tron_step_cap=args.tron_step_cap,
                            branch_backend=args.branch_backend,
                            bus_backend=args.bus_backend,
                            mixed_precision=args.mixed_precision,
                            **common)
    elif args.solver == "rolling":
        if not args.load_prefix:
            print("--load-prefix is required for --solver rolling",
                  file=sys.stderr)
            return 2
        res, _infos = X.solve_acopf_rolling(
            args.case, args.load_prefix,
            start_period=args.start_period, end_period=args.end_period,
            ramp_ratio=args.ramp_ratio, **common)
    elif args.solver == "mpacopf":
        if not args.load_prefix:
            print("--load-prefix is required for --solver mpacopf",
                  file=sys.stderr)
            return 2
        res = X.solve_mpacopf(
            args.case, args.load_prefix,
            start_period=args.start_period, end_period=args.end_period,
            ramp_ratio=args.ramp_ratio, **common)
    elif args.solver == "qpsub":
        from exaadmm_tpu.interface.solve_qpsub import solve_qpsub
        if args.qp_inputs:
            import numpy as np
            qp = dict(np.load(args.qp_inputs))
        else:
            # one SQP linearization about the power-flow warm-start point
            from exaadmm_tpu.models.qpsub.sqp import (SqpBasePoint,
                                                      build_qp_inputs)
            from exaadmm_tpu.utils.grid_data import build_grid_data
            from exaadmm_tpu.utils.opfdata import opf_loaddata
            data = opf_loaddata(args.case, verbose=args.verbose)
            gd = build_grid_data(data, tight_factor=args.tight_factor)
            base = SqpBasePoint.from_power_flow(data, verbose=args.verbose)
            qp = build_qp_inputs(data, gd, base)
        res = solve_qpsub(
            args.case,
            qp["Hs"], qp["LH_1h"], qp["RH_1h"], qp["LH_1i"], qp["RH_1i"],
            qp["LH_1j"], qp["RH_1j"], qp["LH_1k"], qp["RH_1k"],
            qp["ls"], qp["us"], qp["pgmax"], qp["pgmin"],
            qp["qgmax"], qp["qgmin"], qp["c1"], qp["c2"],
            qp["Pd"], qp["Qd"], args.initial_beta,
            mesh=mesh, **common)
    elif args.solver == "mpec":
        from exaadmm_tpu.interface.solve_mpec import solve_acopf_mpec
        mpec_kw = dict(common)
        mpec_kw.pop("use_linelimit", None)
        res = solve_acopf_mpec(
            args.case, storage_ratio=args.storage_ratio, droop=args.droop,
            use_linelimit=not args.no_linelimit, **mpec_kw)
    else:  # pf
        pf = X.solve_pf(args.case, verbose=args.verbose)
        print(json.dumps({"solver": "pf", "converged": bool(pf.converged),
                          "iters": int(pf.iterations),
                          "residual": float(pf.residual)}))
        return 0 if pf.converged else 1

    info = res.info
    summary = {
        "solver": args.solver,
        "case": args.case,
        "status": info.status,
        "objval": info.objval,
        "outer": info.outer,
        "cumul": info.cumul,
        "primres": info.primres,
        "dualres": info.dualres,
        "mismatch": info.mismatch,
        "time_overall_s": round(info.time_overall, 4),
    }
    if args.checkpoint:
        X.save_solution(args.checkpoint, res.solution,
                        meta={"case": args.case, "outer": info.outer,
                              "objval": info.objval})
        summary["checkpoint"] = args.checkpoint
    if args.json:
        print(json.dumps(summary))
    else:
        for k, v in summary.items():
            print(f"{k:16s} {v}")
    return 0 if info.status == "Solved" else 1


if __name__ == "__main__":
    sys.exit(main())
