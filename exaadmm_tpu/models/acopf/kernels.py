"""Closed-form ACOPF component updates (generator, bus, z/l/lz, residual).

Batched jnp re-designs of the reference per-component CUDA kernels:

- generator update: reference ``generator_kernel_two_level``
  (acopf_generator_kernel_cpu.jl:11-16) — a box-projected proximal step per
  generator, here one fused elementwise op on the (ngen, 2) block.
- bus update: reference ``bus_kernel_two_level_alternative``
  (acopf_bus_kernel_cpu.jl:12-116) — per-bus aggregation over incident
  lines/generators + a hand-solved 2x2 KKT system; here the CSR loops become
  ``jax.ops.segment_sum`` over line/gen -> bus segment ids and the writeback
  becomes gathers.
- z / l / lz / residual updates: reference acopf_admm_update_{z,l,lz,residual}
  — pure elementwise on all blocks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import ops as jops

from ...utils.environment import Blocks, blocks_map, blocks_norm
from ...utils.grid_data import GridData


def generator_update(
    u_gen, v_gen, z_gen, l_gen, rho_gen,
    pgmin, pgmax, qgmin, qgmax, c2_eff, c1_eff, baseMVA,
):
    """One proximal generator step; returns the new (ngen, 2) u block.

    pg = clip((-(c1*B + l + rho*(z - v))) / (2 c2 B^2 + rho));  qg analogous
    without the cost terms (acopf_generator_kernel_cpu.jl:11-16).
    """
    lp, lq = l_gen[:, 0], l_gen[:, 1]
    rp_, rq = rho_gen[:, 0], rho_gen[:, 1]
    vp, vq = v_gen[:, 0], v_gen[:, 1]
    zp, zq = z_gen[:, 0], z_gen[:, 1]

    pg = (-(c1_eff * baseMVA + lp + rp_ * (-vp + zp))) / (2.0 * c2_eff * baseMVA**2 + rp_)
    qg = (-(lq + rq * (-vq + zq))) / rq
    pg = jnp.clip(pg, pgmin, pgmax)
    qg = jnp.clip(qg, qgmin, qgmax)
    return jnp.stack([pg, qg], axis=-1)


def kr_scatter(vals, ids, nbus: int):
    """Rows->segments scatter-add as matmuls (Khatri-Rao one-hot split).

    The same reduction as ``segment_sum`` is a dense contraction against the
    (N, nbus) one-hot, which factorizes as
    onehot(b) = onehot(b // 128) (x) onehot(b % 128):

        D[n, (h, c)] = onehot_hi[n, h] * vals[n, c]   (elementwise build)
        agg[(h, c), l] = D^T @ onehot_lo              ((H*C, N) @ (N, 128))

    The data operand is split into THREE bf16 terms (the one-hot side is
    exact in bf16), giving ~24 mantissa bits: max rel error ~1e-7, at fp32
    segment_sum's own accuracy, and deterministic (no atomics). One-hots are
    rebuilt from ``ids`` each call so dynamic line permutations (sort_lines)
    compose for free.
    """
    Lw = 128
    Hn = -(-nbus // Lw)
    dt = vals.dtype
    hi = ids // Lw
    lo = ids % Lw
    Ahi = (hi[:, None] == jnp.arange(Hn, dtype=ids.dtype)[None, :]).astype(
        jnp.bfloat16)
    Alo = (lo[:, None] == jnp.arange(Lw, dtype=ids.dtype)[None, :]).astype(
        jnp.bfloat16)
    n, W = vals.shape
    # Three-term bf16 split of the data (~24 mantissa bits, i.e. full fp32):
    # the 2-term split's ~3e-6 aggregation error is NOT benign — it acts as
    # persistent noise in the consensus step, floors the inner primal
    # residual, and measurably degrades full-solve convergence at 9241 scale
    # (mismatch 1.14 vs 0.13 at the 20-outer limit, with 1.4x the inner
    # iterations).
    # The split runs on the NARROW (n, W) data before the Khatri-Rao
    # expansion — numerically identical to splitting the expanded product
    # (the one-hot factor is exact 0/1 in bf16, multiplication by it is
    # exact), but the expansion then materializes three bf16 (n, Hn*W)
    # operands instead of one f32 + three bf16 (~2.3x less memory traffic;
    # the scatter is bandwidth-bound on the expansion).
    # optimization_barrier around each bf16 term: under jit, XLA's
    # excess-precision simplifier treats f32->bf16->f32 round-trips as
    # value-preserving and cancels `v - f32(bf16(v))` to zero, silently
    # collapsing the split to a single bf16 pass (observed: consensus error
    # jumped to bf16-grade ~2e-3, which the 2x2 bus solve amplifies by ~rho,
    # flooring the inner primal residual at ~5e-2 so eps_pri was never
    # reached again — eager/unfused runs don't fire the pass, which is why
    # standalone accuracy checks passed at 6e-8).
    v1 = jax.lax.optimization_barrier(vals.astype(jnp.bfloat16))
    r1 = vals - v1.astype(dt)
    v2 = jax.lax.optimization_barrier(r1.astype(jnp.bfloat16))
    v3 = (r1 - v2.astype(dt)).astype(jnp.bfloat16)

    def dot(v):
        D = (Ahi[:, :, None] * v[:, None, :]).reshape(n, Hn * W)
        return jax.lax.dot_general(D, Alo, (((0,), (0,)), ((), ())),
                                   preferred_element_type=jnp.float32)

    agg = dot(v1) + dot(v2) + dot(v3)
    agg = agg.reshape(Hn, W, Lw).transpose(0, 2, 1).reshape(Hn * Lw, W)
    return agg[:nbus].astype(dt)


def build_kr_window_setup(fr, to, nbus: int, *, A: int = 1024, S: int = 512):
    """Static setup for the WINDOWED KR scatter (large-grid variant).

    The dense KR contraction is O(N * nbus * C) MACs, which grows with the
    grid. Sorting the 2N line ENDS ("arcs") by bus id makes every A-arc tile
    touch a narrow bus window, so the contraction shrinks to O(N * W * C)
    with W the window width: per iteration one 2N-row permutation gather
    puts the contributions in arc order, then batched per-tile KR matmuls
    accumulate into slot-aligned (S = W/2) output slabs that combine with a
    single shifted add. Window starts are S-aligned so consecutive tiles
    write disjoint-or-identical slots.

    Returns None when a degree spike blows the largest window past 4096
    (caller falls back to segment_sum); otherwise a dict of static arrays.
    """
    import numpy as np

    fr_in, to_in = fr, to
    fr = np.asarray(fr)
    to = np.asarray(to)
    arcs = np.concatenate([fr, to])
    n2 = arcs.shape[0]
    order = np.argsort(arcs, kind="stable")
    bus_sorted = arcs[order]
    T = -(-n2 // A)
    pad = T * A - n2
    # padded arc slots read a dedicated all-zero row appended to the values
    order_p = np.concatenate([order, np.full(pad, n2, np.int64)])
    bus_p = np.concatenate([bus_sorted,
                            np.full(pad, bus_sorted[-1], bus_sorted.dtype)])
    starts = bus_p[np.arange(T) * A]
    ends = bus_p[np.minimum(np.arange(T) * A + A - 1, T * A - 1)]
    W = 2 * S
    while W <= 4096 and not (ends < (starts // S) * S + W).all():
        W *= 2
    if W > 4096:
        return None
    ws = (starts // S) * S
    slot = (ws // S).astype(np.int32)
    # shifted chunks j=0..W/S-1 land in slots slot..slot+W/S-1: size K so the
    # widest window fits (W can double past 2*S on degree spikes)
    K = int(slot.max()) + W // S
    local = bus_p.reshape(T, A) - ws[:, None]
    hi = (local // 128).astype(np.int32)          # [0, W/128)
    lo = (local % 128).astype(np.int32)
    Hw = W // 128
    # one-hot factors as static bf16 constants (exact for 0/1)
    Ahi = (hi[:, :, None] == np.arange(Hw)[None, None, :])
    Alo = (lo[:, :, None] == np.arange(128)[None, None, :])
    return {
        "order": jnp.asarray(order_p, jnp.int32),
        "Ahi": jnp.asarray(Ahi, jnp.bfloat16),
        "Alo": jnp.asarray(Alo, jnp.bfloat16),
        "slot": jnp.asarray(slot, jnp.int32),
        "T": T, "A": A, "S": S, "W": W, "Hw": Hw, "K": K,
        # identity of the arc arrays the static order was built from: the
        # call site must reject a setup whose grid was permuted since build
        # (stale arc order silently corrupts the bus aggregates)
        "_fr_ref": fr_in, "_to_ref": to_in,
    }


def kr_scatter_windowed(vals_fr, vals_to, setup, nbus: int):
    """segment_sum(vals_fr, fr) + segment_sum(vals_to, to) via windowed KR
    matmuls over bus-sorted arcs (see build_kr_window_setup)."""
    T, A, S, Hw, K = (setup["T"], setup["A"], setup["S"], setup["Hw"],
                      setup["K"])
    n, C = vals_fr.shape
    dt = vals_fr.dtype
    big = jnp.concatenate(
        [vals_fr, vals_to, jnp.zeros((1, C), dt)], axis=0)
    v = big[setup["order"]].reshape(T, A, C)
    Ahi, Alo = setup["Ahi"], setup["Alo"]

    # 3-term bf16 split with optimization barriers — same precision story as
    # kr_scatter (XLA would otherwise cancel the residuals under jit); the
    # split runs on the narrow (T, A, C) data before the KR expansion
    # (identical values: the one-hot factor is exact 0/1 in bf16)
    v1 = jax.lax.optimization_barrier(v.astype(jnp.bfloat16))
    r1 = v - v1.astype(dt)
    v2 = jax.lax.optimization_barrier(r1.astype(jnp.bfloat16))
    v3 = (r1 - v2.astype(dt)).astype(jnp.bfloat16)

    def dot(vk):
        # D[t, a, (c, h)] = vk[t, a, c] * Ahi[t, a, h], c-major columns
        D = (vk[:, :, :, None] * Ahi[:, :, None, :]).reshape(T, A, C * Hw)
        return jax.lax.dot_general(
            D, Alo, (((1,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32)

    out = dot(v1) + dot(v2) + dot(v3)               # (T, C*Hw, 128)
    slabs = jops.segment_sum(out.reshape(T, -1), setup["slot"],
                             num_segments=K).reshape(K, C, Hw, 128)
    # combine: each slab spans W = m*S buses starting at its slot; chunk j
    # (S buses wide, Hs = S/128 rows) therefore adds into output slot
    # slot+j — shift chunk j down by j slots and sum
    m = setup["W"] // S
    Hs = Hw // m
    block = slabs[:, :, :Hs, :]
    for j in range(1, m):
        chunk = slabs[:, :, j * Hs:(j + 1) * Hs, :]
        block = block + jnp.concatenate(
            [jnp.zeros_like(chunk[:j]), chunk[:-j]], axis=0)
    agg = block.transpose(0, 2, 3, 1).reshape(K * S, C)
    return agg[:nbus].astype(dt)


def bus_update(u: Blocks, z: Blocks, l: Blocks, rho: Blocks, gd: GridData,
               Pd=None, Qd=None, axis_name: str | None = None,
               ramp=None, bus_backend: str = "segsum",
               kr_win_setup=None) -> Blocks:
    """Bus consensus (xbar) update; returns the new v Blocks.

    Vectorised form of acopf_bus_kernel_cpu.jl:12-116. Per bus the optimality
    system for the two power-balance multipliers (mu1, mu2) is 2x2 linear
    (including shunt coupling through the shared w_i); solved in closed form
    with the same expression ordering as the reference (:85-93).

    Pd/Qd default to the static grid loads; pass per-period columns for
    multi-period / rolling-horizon models.

    Under ``shard_map`` with lines sharded on ``axis_name`` (gens/buses
    replicated), the per-shard line->bus segment sums are combined with a
    single ``psum`` — the replacement for the reference's MPI line partition
    that never shipped its collectives (SURVEY §2.7.3).

    ``ramp`` (optional): dict with per-generator arrays ``u/z/l/rho`` of the
    NEXT period's ramp-coupling solution; when given, the pg rows blend the
    current-period and ramp terms exactly as the reference ``bus_kernel_ramp``
    (mpacopf_bus_kernel_cpu.jl:56-64, 104-110). ``ramp=None`` (or all-zero
    rho/l/u/z) reduces to the plain bus kernel — the two reference kernels are
    one formula with r_rho = 0.
    """
    nbus = gd.nbus
    fr, to, gb = gd.line_from, gd.line_to, gd.gen_bus
    uL, zL, lL, rL = u.line, z.line, l.line, rho.line
    uG, zG, lG, rG = u.gen, z.gen, l.gen, rho.gen
    m = gd.line_mask  # zero out padded lines from every bus aggregate

    if Pd is None:
        Pd = gd.Pd
    if Qd is None:
        Qd = gd.Qd

    def seg(vals, ids):
        return jops.segment_sum(vals, ids, num_segments=nbus)

    # lam + rho*(u + z) for the bus-owned rows (wi, wj, thi, thj)
    uz = uL + zL
    acc_w_fr = (lL[:, 4] + rL[:, 4] * uz[:, 4]) * m
    acc_w_to = (lL[:, 5] + rL[:, 5] * uz[:, 5]) * m
    acc_t_fr = (lL[:, 6] + rL[:, 6] * uz[:, 6]) * m
    acc_t_to = (lL[:, 7] + rL[:, 7] * uz[:, 7]) * m

    # all line->bus aggregates in one stacked segment-sum (one psum under
    # shard_map instead of ten)
    line_contrib = jnp.stack(
        [
            acc_w_fr, acc_t_fr, rL[:, 4] * m, rL[:, 6] * m,
            m / rL[:, 0], m / rL[:, 1],
            (uz[:, 0] + lL[:, 0] / rL[:, 0]) * m,
            (uz[:, 1] + lL[:, 1] / rL[:, 1]) * m,
        ],
        axis=-1,
    )
    line_contrib_to = jnp.stack(
        [
            acc_w_to, acc_t_to, rL[:, 5] * m, rL[:, 7] * m,
            m / rL[:, 2], m / rL[:, 3],
            (uz[:, 2] + lL[:, 2] / rL[:, 2]) * m,
            (uz[:, 3] + lL[:, 3] / rL[:, 3]) * m,
        ],
        axis=-1,
    )
    if bus_backend == "kr_win":
        assert kr_win_setup is not None, "kr_win needs build_kr_window_setup"
        agg = kr_scatter_windowed(line_contrib, line_contrib_to,
                                  kr_win_setup, nbus)
    elif bus_backend == "kr":
        # one contraction over the 2N stacked arcs instead of two N-row
        # calls: halves the per-call one-hot/reshape overheads
        agg = kr_scatter(
            jnp.concatenate([line_contrib, line_contrib_to], axis=0),
            jnp.concatenate([fr, to], axis=0), nbus)
    elif getattr(gd, "fr_sorted", False):
        # statically fr-sorted lines (build_grid_data(sort_lines_static=
        # True)) let XLA take its sorted-indices scatter path; only the fr
        # side is sorted
        agg = (jops.segment_sum(line_contrib, fr, num_segments=nbus,
                                indices_are_sorted=True)
               + seg(line_contrib_to, to))
    else:
        agg = seg(line_contrib, fr) + seg(line_contrib_to, to)
    if axis_name is not None:
        agg = jax.lax.psum(agg, axis_name)
    common_wi = agg[:, 0]
    common_ti = agg[:, 1]
    rhosum_wi = agg[:, 2]
    rhosum_ti = agg[:, 3]
    inv_rho_p = agg[:, 4]
    inv_rho_q = agg[:, 5]
    flow_rhs1 = agg[:, 6]
    flow_rhs2 = agg[:, 7]

    # guard isolated buses (no incident line) against 0/0
    safe_rhosum_wi = jnp.where(rhosum_wi > 0, rhosum_wi, 1.0)
    safe_rhosum_ti = jnp.where(rhosum_ti > 0, rhosum_ti, 1.0)
    common_wi = common_wi / safe_rhosum_wi

    # generator contributions (gen block replicated across shards: no psum).
    # pg rows blend the next period's ramp consensus terms when present:
    #   (l + rho*(u+z) + r_l + r_rho*(r_u+r_z)) / (rho + r_rho)
    uzG = uG + zG
    gen_p_num = lG[:, 0] + rG[:, 0] * uzG[:, 0]
    gen_p_den = rG[:, 0]
    if ramp is not None:
        gen_p_num = gen_p_num + ramp["l"] + ramp["rho"] * (ramp["u"] + ramp["z"])
        gen_p_den = gen_p_den + ramp["rho"]
    rhs1 = seg(gen_p_num / gen_p_den, gb)
    rhs2 = seg((uzG[:, 1] + lG[:, 1] / rG[:, 1]), gb)
    inv_rho_pg = seg(1.0 / gen_p_den, gb)
    inv_rho_qg = seg(1.0 / rG[:, 1], gb)

    rhs1 = rhs1 - Pd / gd.baseMVA
    rhs2 = rhs2 - Qd / gd.baseMVA

    rhs1 = rhs1 - flow_rhs1
    rhs2 = rhs2 - flow_rhs2

    rhs1 = rhs1 - gd.YshR * common_wi
    rhs2 = rhs2 + gd.YshI * common_wi

    A11 = (inv_rho_pg + inv_rho_p) + (gd.YshR**2 / safe_rhosum_wi)
    A12 = -gd.YshR * (gd.YshI / safe_rhosum_wi)
    A22 = (inv_rho_qg + inv_rho_q) + (gd.YshI**2 / safe_rhosum_wi)
    # same elimination ordering as the reference (:90-92)
    safe_A11 = jnp.where(A11 != 0, A11, 1.0)
    mu2 = (rhs2 - (A12 / safe_A11) * rhs1) / (A22 - (A12 / safe_A11) * A12)
    mu1 = (rhs1 - A12 * mu2) / safe_A11

    wi = common_wi + (gd.YshR * mu1 - gd.YshI * mu2) / safe_rhosum_wi
    ti = common_ti / safe_rhosum_ti

    # writeback: consensus copies for every attached component. The four
    # bus quantities are packed into one (nbus, 4) array and gathered ONCE
    # per index set (fr/to/gen) instead of once per quantity — 3 gathers
    # instead of 10.
    wtm = jnp.stack([wi, ti, mu1, mu2], axis=-1)
    g_fr = wtm[fr]
    g_to = wtm[to]
    g_gb = wtm[gb]

    v_gen = jnp.stack(
        [
            (gen_p_num - g_gb[:, 2]) / gen_p_den,
            uzG[:, 1] + (lG[:, 1] - g_gb[:, 3]) / rG[:, 1],
        ],
        axis=-1,
    )
    v_line = jnp.stack(
        [
            uz[:, 0] + (lL[:, 0] + g_fr[:, 2]) / rL[:, 0],
            uz[:, 1] + (lL[:, 1] + g_fr[:, 3]) / rL[:, 1],
            uz[:, 2] + (lL[:, 2] + g_to[:, 2]) / rL[:, 2],
            uz[:, 3] + (lL[:, 3] + g_to[:, 3]) / rL[:, 3],
            g_fr[:, 0],
            g_to[:, 0],
            g_fr[:, 1],
            g_to[:, 1],
        ],
        axis=-1,
    )
    return Blocks(gen=v_gen, line=v_line)


def z_update(u: Blocks, v: Blocks, l: Blocks, rho: Blocks, lz: Blocks, beta) -> Blocks:
    """z = -(lz + l + rho*(u - v)) / (beta + rho) (acopf_admm_update_z_cpu.jl:10)."""
    return blocks_map(
        lambda uu, vv, ll, rr, zz: (-(zz + ll + rr * (uu - vv))) / (beta + rr),
        u, v, l, rho, lz,
    )


def l_update(z: Blocks, lz: Blocks, beta) -> Blocks:
    """l = -(lz + beta*z) (acopf_admm_update_l_cpu.jl:10)."""
    return blocks_map(lambda zz, ll: -(ll + beta * zz), z, lz)


def lz_update(z: Blocks, lz: Blocks, beta, max_multiplier) -> Blocks:
    """lz = clamp(lz + beta*z, +-MAX_MULTIPLIER) (acopf_admm_update_lz_cpu.jl:10)."""
    return blocks_map(
        lambda zz, ll: jnp.clip(ll + beta * zz, -max_multiplier, max_multiplier),
        z, lz,
    )


def compute_objval(u_gen, c2, c1, c0, baseMVA):
    """sum c2*(B*pg)^2 + c1*(B*pg) + c0 with RAW cost coefficients.

    The reference computes the reported objective from the unscaled
    coefficients even when obj_scale != 1 (acopf_admm_update_residual_cpu.jl).
    """
    pg = baseMVA * u_gen[:, 0]
    return jnp.sum(c2 * pg**2 + c1 * pg + c0)


def residual_update(sol, gd: GridData, beta, axis_name: str | None = None):
    """Residual blocks and scalar norms; returns (new rp, rd, scalars dict).

    rp = u - v + z; rd = z - z_prev; mismatch = ||u - v||
    (acopf_admm_update_residual_cpu.jl). The aug-Lagrangian value here sums
    over the full vector; the reference CPU code accidentally sums only the
    first entry (`for i=1:length(mod.nvar)` with nvar::Int — a no-op range of
    1) — auglag is display-only so we keep the correct formula.

    With lines sharded on ``axis_name``, per-shard line partial sums are
    combined with one stacked psum; gen-block terms are replicated.
    """
    m = gd.line_mask
    rp = blocks_map(lambda uu, vv, zz: uu - vv + zz, sol.u, sol.v, sol.z)
    rd = blocks_map(lambda zc, zp: zc - zp, sol.z, sol.z_prev)
    ax_by = blocks_map(lambda a, b: a - b, rp, sol.z)

    def line_sq(x):
        return jnp.sum(x * x * m[:, None])

    def line_dot(a, b):
        return jnp.sum(a * b * m[:, None])

    line_parts = jnp.stack([
        line_sq(rp.line),
        line_sq(rd.line),
        line_sq(sol.z.line),
        line_sq(ax_by.line),
        line_dot(sol.lz.line, sol.z.line),
        line_dot(sol.l.line, rp.line),
        line_dot(sol.rho.line, rp.line * rp.line),
    ])
    if axis_name is not None:
        line_parts = jax.lax.psum(line_parts, axis_name)

    primres = jnp.sqrt(jnp.sum(rp.gen**2) + line_parts[0])
    dualres = jnp.sqrt(jnp.sum(rd.gen**2) + line_parts[1])
    norm_z = jnp.sqrt(jnp.sum(sol.z.gen**2) + line_parts[2])
    mismatch = jnp.sqrt(jnp.sum(ax_by.gen**2) + line_parts[3])

    objval = compute_objval(sol.u.gen, gd.c2, gd.c1, gd.c0, gd.baseMVA)

    auglag = (
        objval
        + (jnp.sum(sol.lz.gen * sol.z.gen) + line_parts[4])
        + 0.5 * beta * (jnp.sum(sol.z.gen**2) + line_parts[2])
        + (jnp.sum(sol.l.gen * rp.gen) + line_parts[5])
        + 0.5 * (jnp.sum(sol.rho.gen * rp.gen**2) + line_parts[6])
    )

    scalars = {
        "primres": primres,
        "dualres": dualres,
        "norm_z_curr": norm_z,
        "mismatch": mismatch,
        "objval": objval,
        "auglag": auglag,
    }
    return rp, rd, scalars
