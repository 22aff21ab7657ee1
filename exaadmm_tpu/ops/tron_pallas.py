"""Fused GPU kernel (Pallas, Triton route) for the batched TRON/ALM solver.

The XLA path (:func:`exaadmm_tpu.ops.tron.tron_alm_batched`) runs the
lockstep state machine as nested ``lax.while_loop`` s over the FULL batch: on
a GPU every trip of every loop copies its predicate back to the host and
launches dozens of small fusions, and the trip count is the maximum over all
lanes. This kernel runs the same state machine on one small tile of lanes per
thread block instead:

- one lane per thread: the iterates, gradients and 6x6 Hessians live in
  registers, and device memory sees one load and one store per input and
  output row;
- each block runs its OWN trip count and exits when its own lanes are done,
  so a pathological line stalls only its tile — the reference's independent
  per-line CUDA blocks (acopf_admm_update_x_gpu.jl:26-32).

The kernel body calls :func:`exaadmm_tpu.ops.tron.tron_alm_rows` on the tile
— one algorithm, two execution strategies. Every input row (iterate bounds,
multipliers, each row of each parameter leaf) is passed as its own ``(B,)``
operand, so the body never slices or stacks inside the kernel.

fp32 only; fp64 solves use the XLA path.
"""

from __future__ import annotations

import itertools
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .tron import TronALMResult, tron_alm_batched, tron_alm_rows

# lanes per thread block: one warp, one lane per thread (the fastest of
# tiles 32..256 x 1..8 warps on the synth-9241 branch batch; PERF.md)
DEFAULT_TILE = 32


def _rows(a, pad, fill):
    """Pad the last axis of a (..., B) array and split it into flat rows."""
    if pad:
        a = jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, pad)],
                    constant_values=fill)
    return [a[idx] for idx in np.ndindex(a.shape[:-1])]


def _nest(shape, flat):
    """Rebuild nested tuples of rows for a leaf of lead ``shape``."""
    if not shape:
        return next(flat)
    return tuple(_nest(shape[1:], flat) for _ in range(shape[0]))


def tron_alm_batched_pallas(
    obj_fn: Callable,
    cons_fn: Callable,
    x0: jnp.ndarray,     # (n, B)
    xl: jnp.ndarray,
    xu: jnp.ndarray,
    params,              # pytree with (..., B) leaves
    lam0: jnp.ndarray,   # (ncon, B)
    mu0: jnp.ndarray,    # (B,)
    *,
    tile: int = DEFAULT_TILE,
    num_warps: int | None = None,
    active0: jnp.ndarray | None = None,
    interpret: bool = False,
    **opts,
) -> TronALMResult:
    """Same contract as :func:`~exaadmm_tpu.ops.tron.tron_alm_batched`; the
    batch is padded to whole tiles of ``tile`` lanes (a power of two) and
    each tile runs in its own thread block of ``num_warps`` warps (default
    ``tile // 32``, one lane per thread)."""
    n, B = x0.shape
    ncon = lam0.shape[0]
    dtype = x0.dtype
    if dtype != jnp.float32:
        raise ValueError(f"the fused TRON kernel is fp32-only, got {dtype}")
    if tile < 1 or tile & (tile - 1):
        raise ValueError(f"tile must be a power of two, got {tile}")
    if num_warps is None:
        num_warps = max(1, tile // 32)

    ntiles = -(-B // tile)
    pad = ntiles * tile - B
    if active0 is None:
        active0 = jnp.ones((B,), bool)

    leaves, treedef = jax.tree_util.tree_flatten(params)
    leaf_shapes = [leaf.shape[:-1] for leaf in leaves]
    # padded lanes: inactive, inside their unit box, well-scaled parameters
    inputs = (_rows(x0, pad, 0.5) + _rows(xl, pad, 0.0) + _rows(xu, pad, 1.0)
              + _rows(lam0, pad, 0.0) + _rows(mu0, pad, 1.0)
              # lane mask as int32 (bool blocks lower too, but only this form
              # has run on the card)
              + _rows(active0.astype(jnp.int32), pad, 0))
    for leaf in leaves:
        inputs += _rows(leaf, pad, 1.0)
    n_in = len(inputs)

    Bp = ntiles * tile
    f32 = jax.ShapeDtypeStruct((Bp,), dtype)
    i32 = jax.ShapeDtypeStruct((Bp,), jnp.int32)
    # x rows, lam rows, mu, minor, alm, cviol
    out_shapes = (f32,) * (n + ncon) + (f32, i32, i32, f32)
    spec = pl.BlockSpec((tile,), lambda i: (i,))

    def kernel(*refs):
        vals = iter([r[...] for r in refs[:n_in]])
        x = tuple(itertools.islice(vals, n))
        lo = tuple(itertools.islice(vals, n))
        hi = tuple(itertools.islice(vals, n))
        lam = tuple(itertools.islice(vals, ncon))
        mu = next(vals)
        act = next(vals) > 0
        params_tile = jax.tree_util.tree_unflatten(
            treedef, [_nest(s, vals) for s in leaf_shapes])
        res = tron_alm_rows(obj_fn, cons_fn, x, lo, hi, params_tile, lam, mu,
                            active0=act, **opts)
        outs = (*res.x, *res.lam, res.mu, res.minor_iters, res.alm_iters,
                res.cviol)
        for ref, v in zip(refs[n_in:], outs):
            ref[...] = v

    outs = pl.pallas_call(
        kernel,
        grid=(ntiles,),
        in_specs=[spec] * n_in,
        out_specs=(spec,) * len(out_shapes),
        out_shape=out_shapes,
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="tron_alm",
    )(*inputs)

    x = jnp.stack(outs[:n])[:, :B]
    lam = (jnp.stack(outs[n:n + ncon])[:, :B] if ncon
           else jnp.zeros((0, B), dtype))
    mu, minor, alm, cviol = (o[:B] for o in outs[n + ncon:])
    return TronALMResult(x=x, lam=lam, mu=mu, minor_iters=minor,
                         alm_iters=alm, cviol=cviol)


def select_tron_solver(par, dtype):
    """``(solver, extra kwargs)`` for a TRON/ALM batch in solve dtype
    ``dtype``, from ``Parameters.branch_backend``: the fused kernel for an
    fp32 batch under "auto" when JAX's default backend is a GPU; the XLA
    path otherwise."""
    backend = par.branch_backend
    if backend not in ("auto", "xla"):
        raise ValueError(f"unknown branch_backend {backend!r}")
    if (backend == "auto" and dtype == jnp.float32
            and jax.default_backend() == "gpu"):
        return tron_alm_batched_pallas, {"tile": par.pallas_tile}
    return tron_alm_batched, {}
