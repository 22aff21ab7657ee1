"""exaadmm_tpu — two-level ADMM solver for component-decomposed ACOPF on GPUs.

A from-scratch JAX/XLA re-design with the capabilities of exanauts/ExaAdmm.jl
(reference mounted at /root/reference): batched per-component proximal updates,
a batched trust-region-Newton (TRON-style) augmented-Lagrangian branch solver,
fully jitted inner ADMM loops, and jax.sharding-based multi-chip scaling.
"""

from .interface.solve_acopf import solve_acopf, solve_acopf_from_env
from .interface.solve_acopf_rolling import solve_acopf_rolling
from .interface.solve_mpacopf import solve_mpacopf
from .interface.solve_qpsub import solve_qpsub
from .interface.solve_pf import solve_pf
from .interface.solve_mpec import solve_acopf_mpec
from .utils.environment import AdmmEnv, Parameters, Solution, Blocks
from .utils.opfdata import opf_loaddata
from .utils.checkpoint import save_solution, load_solution

__version__ = "0.1.0"

__all__ = [
    "solve_acopf",
    "solve_acopf_from_env",
    "solve_acopf_rolling",
    "solve_mpacopf",
    "solve_qpsub",
    "solve_pf",
    "solve_acopf_mpec",
    "opf_loaddata",
    "AdmmEnv",
    "Parameters",
    "Solution",
    "Blocks",
    "save_solution",
    "load_solution",
]
