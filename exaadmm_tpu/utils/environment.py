"""Algorithm parameters, ADMM environment, and solution state pytrees.

Reworking of the reference ``src/utils/environment.jl``:

- ``Parameters`` mirrors the constants/defaults of environment.jl:6-76,
- ``Blocks`` replaces the flat interleaved nvar-vector
  ``[(pg,qg)_g | (pij,qij,pji,qji,wi,wj,thi,thj)_l]`` (acopf layout,
  docs/src/dev.md) with structured (ngen,2) + (nline,8) arrays — elementwise
  ADMM updates act identically, while the branch/bus kernels get natural
  batch axes instead of strided gathers,
- ``Solution`` mirrors environment.jl:177-226 as an immutable pytree carried
  through ``lax.while_loop`` (plus the per-line ALM multiplier state that the
  reference keeps in ``membuf`` rows 25-27,
  acopf_auglag_linelimit_kernel_cpu.jl:79-147),
- ``IterationInformation`` mirrors environment.jl:328-405 host-side.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .pytree import pytree_dataclass

# line-block column indices (order matches the reference layout)
PIJ, QIJ, PJI, QJI, WI, WJ, THI, THJ = range(8)


@dataclasses.dataclass
class Parameters:
    """Algorithm constants (reference environment.jl:43-75 defaults)."""

    mu_max: float = 1e8          # ALM penalty cap (branch kernel)
    max_auglag: int = 50         # max ALM rounds per branch solve
    ABSTOL: float = 1e-6
    RELTOL: float = 1e-5
    verbose: int = 1

    # two-level ADMM
    initial_beta: float = 1e3
    beta: float = 1e3
    inc_c: float = 6.0
    theta: float = 0.8
    outer_eps: float = 2e-4
    MAX_MULTIPLIER: float = 1e12
    DUAL_TOL: float = 1e-8

    outer_iterlim: int = 20
    inner_iterlim: int = 1000
    scale: float = 1e-4          # scales the branch objective (TRON evals)
    obj_scale: float = 1.0       # scales gen cost coefficients in kernels

    # TRON (reference acopf_auglag_linelimit_kernel_cpu.jl:95-116)
    tron_gtol: float = 1e-6
    tron_frtol: float = 1e-12
    tron_max_minor: int = 200
    # lockstep budget: total trust-region steps per batched branch solve.
    # The reference lets each CUDA block run to its own caps (200 minor x 50
    # ALM rounds); in the batched lockstep design one pathological lane would
    # stall the whole batch (or its kernel tile), so the loop is budgeted.
    # Lanes cut short are simply warm-started again next ADMM iteration
    # (inexact ADMM). None = reference behaviour (max_minor * max_auglag).
    # The fp32 production setting is 12: the per-ADMM-iteration subproblem
    # accuracy beyond ~12 lockstep steps is wasted because the prox targets
    # move next iteration anyway. bench.py defaults to 12.
    tron_step_cap: int | None = None

    # branch ALM termination (auglag kernel :128-137)
    alm_ctol: float = 1e-6

    # fixed-trip unrolled trial searches inside the TRON step
    # (k_interp, k_extrap, k_prsrch); None = reference while-loop searches.
    # (22, 10, 20) is bit-identical to None; smaller caps give uniform
    # per-step cost, but a capped projected search that fails changes
    # trajectories enough to cost convergence on sensitive fp32 cases
    # (synthetic 1354-bus regression) — keep None.
    # "auto" currently resolves to None on every backend.
    tron_trial_unroll: tuple[int, int, int] | str | None = "auto"

    # difficulty-sort lines between outer iterations so hard lanes cluster
    # into the same kernel tiles and easy tiles exit their lockstep loop
    # early (the per-lane step counts are heavily skewed: p50 ~3 steps,
    # stragglers ~30; random order puts a straggler in every tile). Exactly
    # permutation-equivariant up to reduction rounding. Default OFF: with
    # the two-pass compaction at pass-1 cap 2 the sort can only save one
    # lockstep step per easy tile, against a per-outer permutation cost.
    sort_lines: bool = False

    # two-pass branch solve: pass 1 runs every lane with a small lockstep
    # budget (branch_pass1_cap); the unfinished stragglers are then compacted
    # into a tail of branch_tail_lanes lanes and re-solved from
    # scratch with the full budget. A re-solved lane's trajectory is
    # identical to the single-pass solve (trajectories are independent of
    # tile composition); stragglers BEYOND the tail capacity keep their
    # pass-1 iterate and warm-start the next ADMM iteration — additional
    # deliberate inexactness on top of tron_step_cap, self-correcting the
    # same way. The per-dispatch stats `pass1_unfinished` (lanes that ran
    # out of pass-1 budget) and `tail_overflow` (lanes beyond tail capacity)
    # quantify the injected inexactness; convergence regressions in tests/
    # guard the quality. Applied when the line batch is at least four tail
    # capacities (B >= 4 * tail capacity).
    # branch_tail_lanes=None sizes the tail to 1/16 of the batch, rounded
    # up to whole 1024-lane blocks (so batches under 4096 lanes stay
    # single-pass).
    branch_two_pass: bool = True
    branch_pass1_cap: int = 2
    branch_tail_lanes: int | None = None

    # TRON/ALM batch solver (branch lines, mpacopf ramp generators, qpsub
    # reduced QPs). "auto" (the default and the production setting) runs
    # fp32 batches through the fused GPU kernel (ops/tron_pallas.py,
    # Pallas-Triton, each block of pallas_tile lanes with its own trip
    # count) when JAX's default backend is a GPU, and everything else
    # through "xla", the lockstep while loop over the full batch (any
    # dtype), which is also the kernel's reference.
    branch_backend: str = "auto"
    # lanes per kernel thread block (a power of two; one lane per thread,
    # tile // 32 warps)
    pallas_tile: int = 32
    # mixed precision: in an fp64 solve, run the branch TRON/ALM batch in
    # fp32 (kernel-eligible) and keep bus consensus / z / l / lz / residual
    # accumulation in fp64. No effect on fp32 solves.
    mixed_precision: bool = False
    # bus-update line->bus scatter backend: "segsum" (exact
    # jax.ops.segment_sum), "kr" (Khatri-Rao one-hot matmuls with a 3-term
    # bf16 split, ~1e-7 rel aggregation error; see kernels.kr_scatter) or
    # "kr_win" (the windowed KR form). "auto": see
    # models.acopf.model.resolve_bus_backend.
    bus_backend: str = "auto"


@dataclasses.dataclass
class AdmmEnv:
    """Top-level solve context (reference AdmmEnv, environment.jl:85-158).

    In this build most of AdmmEnv's role is absorbed by function arguments
    and the model dataclasses; this record exists for API parity and for
    callers who want to carry the full context around: case name, parsed
    data, rho seeds, feature flags, and the Parameters block. Each interface
    fills its own flags: solve_mpacopf sets load_specified/horizon_length,
    solve_acopf_mpec sets storage_ratio/droop. It is runnable, not just a
    record: ``interface.solve_acopf_from_env(env)`` re-solves from it.
    """

    case: str
    data: object                  # OPFData
    initial_rho_pq: float
    initial_rho_va: float
    params: "Parameters"
    tight_factor: float = 1.0
    use_linelimit: bool = True
    use_projection: bool = False
    load_specified: bool = False
    horizon_length: int = 1
    storage_ratio: float = 0.0
    droop: float = 0.04


@pytree_dataclass
class Blocks:
    """One ADMM-space vector, split by component class."""

    gen: jnp.ndarray   # (ngen, 2)  [pg, qg]
    line: jnp.ndarray  # (nline_padded, 8)  [pij,qij,pji,qji,wi,wj,thi,thj]

    @staticmethod
    def zeros(ngen: int, nline: int, dtype=jnp.float64) -> "Blocks":
        return Blocks(
            gen=jnp.zeros((ngen, 2), dtype=dtype),
            line=jnp.zeros((nline, 8), dtype=dtype),
        )

    @staticmethod
    def full(ngen: int, nline: int, val: float, dtype=jnp.float64) -> "Blocks":
        return Blocks(
            gen=jnp.full((ngen, 2), val, dtype=dtype),
            line=jnp.full((nline, 8), val, dtype=dtype),
        )


def blocks_map(fn, *blocks: Blocks) -> Blocks:
    """Elementwise op across corresponding gen/line arrays."""
    return Blocks(
        gen=fn(*(b.gen for b in blocks)),
        line=fn(*(b.line for b in blocks)),
    )


def blocks_sumsq(b: Blocks, line_mask: jnp.ndarray | None = None) -> jnp.ndarray:
    lsq = b.line * b.line
    if line_mask is not None:
        lsq = lsq * line_mask[:, None]
    return jnp.sum(b.gen * b.gen) + jnp.sum(lsq)


def blocks_norm(b: Blocks, line_mask: jnp.ndarray | None = None) -> jnp.ndarray:
    return jnp.sqrt(blocks_sumsq(b, line_mask))


def blocks_dot(a: Blocks, b: Blocks, line_mask: jnp.ndarray | None = None) -> jnp.ndarray:
    lprod = a.line * b.line
    if line_mask is not None:
        lprod = lprod * line_mask[:, None]
    return jnp.sum(a.gen * b.gen) + jnp.sum(lprod)


@pytree_dataclass
class BranchALMState:
    """Per-line ALM state persisted across inner iterations.

    Reference keeps these in membuf rows 25 (lambda1), 26 (lambda2), 27 (mu)
    (acopf_auglag_linelimit_kernel_cpu.jl:79-147); mu is reset to 10 at the
    first inner iteration of each outer loop, the lambdas warm-start forever.
    """

    lam1: jnp.ndarray  # (nline,)
    lam2: jnp.ndarray  # (nline,)
    mu: jnp.ndarray    # (nline,)

    @staticmethod
    def zeros(nline: int, dtype=jnp.float64) -> "BranchALMState":
        z = jnp.zeros((nline,), dtype=dtype)
        return BranchALMState(lam1=z, lam2=z, mu=jnp.full((nline,), 10.0, dtype=dtype))


@pytree_dataclass
class Solution:
    """ADMM state (reference Solution, environment.jl:177-226) as a pytree."""

    u: Blocks        # x (component variables)
    v: Blocks        # xbar (bus consensus copy)
    l: Blocks        # lambda for u - v + z = 0
    rho: Blocks
    z: Blocks        # artificial variable (two-level)
    z_prev: Blocks
    lz: Blocks       # outer multiplier on z = 0
    rp: Blocks       # primal residual u - v + z
    rd: Blocks       # dual residual z - z_prev
    branch_alm: BranchALMState

    @staticmethod
    def zeros(ngen: int, nline: int, dtype=jnp.float64) -> "Solution":
        z = lambda: Blocks.zeros(ngen, nline, dtype)  # noqa: E731
        return Solution(
            u=z(), v=z(), l=z(), rho=z(), z=z(), z_prev=z(), lz=z(),
            rp=z(), rd=z(),
            branch_alm=BranchALMState.zeros(nline, dtype),
        )


def permute_solution_lines(sol: Solution, ids) -> Solution:
    """Reorder every line-indexed row of a Solution by ``ids``.

    Packed into a single gather: the 12 line-indexed arrays are concatenated
    column-wise and gathered once."""
    blocks = (sol.u, sol.v, sol.l, sol.rho, sol.z, sol.z_prev, sol.lz,
              sol.rp, sol.rd)
    alm = sol.branch_alm
    pack = jnp.concatenate(
        [b.line for b in blocks]
        + [alm.lam1[:, None], alm.lam2[:, None], alm.mu[:, None]], axis=1)
    sub = pack[ids]
    new_blocks = [
        blocks[i].replace(line=sub[:, 8 * i:8 * (i + 1)]) for i in range(9)
    ]
    return sol.replace(
        u=new_blocks[0], v=new_blocks[1], l=new_blocks[2], rho=new_blocks[3],
        z=new_blocks[4], z_prev=new_blocks[5], lz=new_blocks[6],
        rp=new_blocks[7], rd=new_blocks[8],
        branch_alm=BranchALMState(
            lam1=sub[:, 72], lam2=sub[:, 73], mu=sub[:, 74]),
    )


@dataclasses.dataclass
class IterationInformation:
    """Host-side iteration counters and scalars (environment.jl:328-405)."""

    outer: int = 0
    inner: int = 0
    cumul: int = 0
    status: str = "NotSpecified"
    objval: float = 0.0
    auglag: float = 0.0
    primres: float = float("inf")
    dualres: float = float("inf")
    mismatch: float = float("inf")
    eps_pri: float = 0.0
    norm_z_curr: float = float("inf")
    norm_z_prev: float = float("inf")
    # solver health (last inner iteration): worst branch line-limit
    # constraint violation; two-pass stragglers beyond the tail capacity
    max_cviol: float = 0.0
    tail_overflow: int = 0
    # lanes that exceeded the two-pass pass-1 budget in the last inner
    # iteration (most were re-solved exactly by the tail; see
    # Parameters.branch_two_pass)
    pass1_unfinished: int = 0
    # wall-clock accounting
    time_overall: float = 0.0
    time_x_update: float = 0.0
    time_xbar_update: float = 0.0
    time_z_update: float = 0.0
    time_l_update: float = 0.0
    time_lz_update: float = 0.0
    time_projection: float = 0.0
