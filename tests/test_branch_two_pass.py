"""Two-pass branch solve (pass-1 budget + compacted straggler re-solve)
equals the single-pass solve lane-for-lane.

Per-lane TRON/ALM trajectories are independent of tile/batch composition
(lockstep masking never changes a lane's own updates), so re-solving an
unfinished lane from scratch with the full budget reproduces exactly what
the single full-budget pass would have produced for it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

from exaadmm_tpu.models.acopf import model as M
from exaadmm_tpu.models.acopf.branch import branch_update
from exaadmm_tpu.utils.environment import Parameters
from exaadmm_tpu.utils.synthetic import synthetic_case


def test_two_pass_matches_single_pass():
    data = synthetic_case(300, seed=3)
    # small tail so the two-pass gate (B >= 4 * tail capacity) opens on a
    # 300-bus case; xla backend keeps this exact on CPU fp64
    par = Parameters(verbose=0, tron_step_cap=24, branch_backend="xla",
                     branch_tail_lanes=64,
                     branch_pass1_cap=6, branch_two_pass=True)
    model = M.build_model(data, par, dtype=jnp.float64)
    sol = M.init_solution(model, 400.0, 40000.0)
    par.scale = 1e-4
    assert model.grid.nline_padded >= 4 * par.branch_tail_lanes

    # perturb the prox targets so a spread of lane difficulties exists
    rng = np.random.default_rng(0)
    v_line = sol.v.line + jnp.asarray(
        rng.normal(0, 0.05, sol.v.line.shape))
    sol = sol.replace(v=sol.v.replace(line=v_line))

    inner = jnp.asarray(2, jnp.int32)
    u2, alm2, st2 = branch_update(sol, model.grid, par, inner)

    par1 = dataclasses.replace(par, branch_two_pass=False)
    u1, alm1, st1 = branch_update(sol, model.grid, par1, inner)

    assert int(st2["tail_overflow"]) == 0
    np.testing.assert_allclose(np.asarray(u1), np.asarray(u2), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(alm1.lam1), np.asarray(alm2.lam1), atol=1e-12)
    np.testing.assert_allclose(np.asarray(alm1.mu), np.asarray(alm2.mu), atol=0)
    # identical per-lane effort accounting
    np.testing.assert_allclose(float(st1["avg_minor_it"]),
                               float(st2["avg_minor_it"]), atol=1e-9)
    np.testing.assert_array_equal(np.asarray(st1["lane_steps"]),
                                  np.asarray(st2["lane_steps"]))
