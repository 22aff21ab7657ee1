"""The benchmark workload must be a *converging* ADMM instance: solve a
smaller instance of the same synthetic family to the reference tolerance."""

from exaadmm_tpu.algorithms.admm_two_level import admm_two_level
from exaadmm_tpu.models.acopf import model as M
from exaadmm_tpu.utils.environment import IterationInformation, Parameters
from exaadmm_tpu.utils.synthetic import synthetic_case


def test_synthetic_admm_converges():
    data = synthetic_case(300, seed=0)
    par = Parameters(verbose=0, outer_iterlim=20, inner_iterlim=200,
                     tron_step_cap=48)
    model = M.build_model(data, par)
    sol = M.init_solution(model, 4e2, 4e4)
    sol, info = admm_two_level(model, sol, IterationInformation())
    assert info.status == "Solved"
    assert info.objval > 0


def test_synthetic_admm_converges_under_two_pass_truncation():
    """The production two-pass config truncates stragglers beyond the tail
    capacity (budgeted inexact ADMM). Force that regime on the small case
    (a 16-lane tail + the production pass-1 budget) and require
    convergence, with an endpoint objective close to the exact solve's.
    Both solves run to the tighter outer_eps 5e-5: at the default 2e-4
    the objective is still climbing steeply (~6.3k -> ~7.2k on this case),
    so where each trajectory stops there depends on last-bit rounding —
    the endpoints landed 2-10% apart under 0.25% changes of rho. At 5e-5
    both sit near the optimum and agree to ~0.2%."""
    data = synthetic_case(300, seed=0)
    par = Parameters(verbose=0, outer_iterlim=60, inner_iterlim=200,
                     outer_eps=5e-5, tron_step_cap=48,
                     branch_tail_lanes=16,
                     # the tiny 16-lane tail is a deliberate truncation stress
                     # (~3x beyond production); it needs the difficulty sort
                     # to cluster stragglers into the tail window
                     sort_lines=True,
                     branch_two_pass=True)  # pass-1 budget: production default
    model = M.build_model(data, par)
    assert model.grid.nline_padded >= 4 * 16  # two-pass gate open
    sol = M.init_solution(model, 4e2, 4e4)
    sol, info = admm_two_level(model, sol, IterationInformation())
    assert info.status == "Solved"

    par_exact = Parameters(verbose=0, outer_iterlim=60, inner_iterlim=200,
                           outer_eps=5e-5, tron_step_cap=48,
                           branch_two_pass=False)
    model_e = M.build_model(data, par_exact)
    sol_e = M.init_solution(model_e, 4e2, 4e4)
    sol_e, info_e = admm_two_level(model_e, sol_e, IterationInformation())
    assert info_e.status == "Solved"
    assert abs(info.objval - info_e.objval) <= 0.02 * abs(info_e.objval)
