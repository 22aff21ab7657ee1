"""Collective-count guard: one sharded inner ADMM iteration must lower to
EXACTLY the intended collectives (SURVEY.md §2.7.3's communication story:
one stacked bus psum + one residual psum + one branch-stats psum + the
max-cviol scalar psum), so future edits can't silently introduce
per-iteration all-gathers or extra reductions.
"""

import re

import jax
import jax.numpy as jnp
import pytest

from exaadmm_tpu.models.acopf import model as M
from exaadmm_tpu.parallel.sharding import make_mesh, make_sharded_inner_loop
from exaadmm_tpu.utils.environment import Parameters
from exaadmm_tpu.utils.opfdata import opf_loaddata


def test_sharded_inner_loop_collectives(case9_path):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    data = opf_loaddata(case9_path, verbose=0)
    par = Parameters(verbose=0, scale=1e-4)
    model = M.build_model(data, par, pad_lines_to=8, dtype=jnp.float64)
    sol = M.init_solution(model, 4e2, 4e4)
    mesh = make_mesh(8)
    run = make_sharded_inner_loop(model, mesh, 1000)
    gd = model.grid
    txt = run.lower(sol, 1e3, jnp.asarray(1.0), gd.Pd, gd.Qd,
                    gd.pgmin, gd.pgmax).as_text()

    shapes = sorted(
        m.group(1)
        for m in re.finditer(r'"stablehlo.all_reduce".*?->\s*tensor<([^>]*)>',
                             txt, re.S)
    )
    nb = gd.nbus
    assert shapes == sorted([
        "2xf64",          # branch-solver effort stats
        "2xi32",          # two-pass inexactness counters (stacked)
        "f64",            # max constraint violation (psum_max scalar)
        f"{nb}x8xf64",    # stacked bus consensus accumulators
        "7xf64",          # residual norms + objective + auglag partials
    ]), f"unexpected all_reduce set: {shapes}"

    for op in ("all_gather", "all_to_all", "collective_permute",
               "reduce_scatter"):
        assert len(re.findall(op, txt)) == 0, f"unexpected {op} in lowering"
