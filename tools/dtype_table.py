"""fp32-vs-fp64 quality table (PARITY.md dtype-honesty artifact).

Runs the fused two-level solve at the standard tolerance (outer_eps=2e-4,
outer_iterlim 20/25) on case9, case118, synth-1354 and synth-9241 in the
requested dtype and prints one JSON line per case:

    {case, dtype, platform, device_kind, status, outer, cumul, obj,
     mismatch, tol}

Run once per dtype (DTYPE_TABLE_CASES=case9,case118 limits the cases):
    DTYPE_TABLE=fp64 JAX_PLATFORMS=cpu python tools/dtype_table.py
    DTYPE_TABLE=fp32 python tools/dtype_table.py            # on a GPU
    DTYPE_TABLE=mixed python tools/dtype_table.py           # on a GPU
Every row uses the default solver selection (Parameters.branch_backend
"auto": the fused TRON kernel for fp32 branch batches on a GPU, XLA
otherwise); "mixed" = fp64 state with the fp32 branch batch
(Parameters.mixed_precision).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DT = os.environ.get("DTYPE_TABLE", "fp32")
import jax  # noqa: E402

if DT in ("fp64", "mixed"):
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402


def run_case(name, build):
    from exaadmm_tpu.algorithms.admm_two_level import admm_two_level_fused
    from exaadmm_tpu.models.acopf import model as M
    from exaadmm_tpu.utils.environment import Parameters

    dtype = jnp.float64 if DT in ("fp64", "mixed") else jnp.float32
    dev = jax.devices()[0]
    data, rho_pq, rho_va, outers = build()
    par = Parameters(
        verbose=0, outer_iterlim=outers, outer_eps=2e-4, scale=1e-4,
        mixed_precision=(DT == "mixed"),
    )
    model = M.build_model(data, par, dtype=dtype)
    sol = M.init_solution(model, rho_pq, rho_va)
    sol, info = admm_two_level_fused(model, sol)
    sqrt_d = float(model.nvar) ** 0.5
    print(json.dumps({
        "case": name, "dtype": DT, "platform": dev.platform,
        "device_kind": dev.device_kind,
        "status": info.status, "outer": info.outer, "cumul": info.cumul,
        "obj": round(info.objval, 4), "mismatch": float(info.mismatch),
        "tol": sqrt_d * par.outer_eps,
    }), flush=True)


def main():
    from exaadmm_tpu.utils.opfdata import opf_loaddata
    from exaadmm_tpu.utils.synthetic import synthetic_case

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cases = {
        "case9": lambda: (opf_loaddata(os.path.join(here, "data/case9.m"),
                                       verbose=0), 4e2, 4e4, 25),
        "case118": lambda: (opf_loaddata(os.path.join(here, "data/case118.m"),
                                         verbose=0), 4e2, 4e4, 25),
        "synth1354": lambda: (synthetic_case(1354, seed=0), 4e2, 4e4, 20),
        "synth9241": lambda: (synthetic_case(9241, seed=0), 4e2, 4e4, 20),
    }
    only = os.environ.get("DTYPE_TABLE_CASES")
    for name, build in cases.items():
        if only and name not in only.split(","):
            continue
        run_case(name, build)


if __name__ == "__main__":
    main()
