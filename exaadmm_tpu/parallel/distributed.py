"""Multi-host initialization and mesh construction.

The reference's multi-rank story is MPI scaffolding without collectives
(SURVEY.md §2.7.3): ``AdmmEnv.use_mpi``/``comm`` (environment.jl:98-113) and
rank-local ``shift_lines`` windows. Here the story is ``jax.distributed`` +
one global device mesh; the sharded solvers in
:mod:`exaadmm_tpu.parallel.sharding` then work unchanged — ``shard_map``
places each process's addressable line shards locally and the ``psum``s run
as NCCL collectives across processes and hosts.

Typical multi-host launch (same program on every host):

    from exaadmm_tpu.parallel import distributed
    mesh = distributed.initialize_and_make_mesh()   # all hosts' devices
    res = exaadmm_tpu.solve_acopf(case, mesh=mesh, verbose=0, ...)

On a single host this degenerates to ``make_mesh()`` over the local devices
(no ``jax.distributed`` needed), so the same script runs everywhere.
"""

from __future__ import annotations

import jax

from .sharding import AXIS, make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Initialize ``jax.distributed`` when running multi-process.

    With no arguments, reads the cluster environment (SLURM / Open MPI are
    auto-detected by jax; elsewhere pass ``coordinator_address``
    (``host:port``), ``num_processes`` and ``process_id``). Safe to call
    twice and on single-process runs (no-op when the backend is already
    initialized or there is nothing to join).
    """
    state = getattr(jax._src.distributed, "global_state", None)
    if state is not None and state.client is not None:
        return  # already initialized
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (ValueError, RuntimeError) as e:
        # single-process run with no cluster env (no coordinator to join, or
        # the local backend already came up): nothing to initialize
        if coordinator_address is not None or num_processes not in (None, 1):
            raise
        del e


def initialize_and_make_mesh(axis: str = AXIS, **init_kwargs):
    """Join the cluster (if any) and return a 1-D mesh over ALL devices.

    The line dimension shards over the full mesh; hosts only communicate
    through the psums inside the sharded solve. Models must be built with
    ``pad_lines_to=mesh.devices.size``.
    """
    initialize(**init_kwargs)
    return make_mesh(devices=jax.devices(), axis=axis)


def process_line_slice(nline_padded: int, mesh=None) -> slice:
    """This process's contiguous window of the global (padded) line batch —
    the analogue of the reference's rank-local ``shift_lines`` offset
    (environment.jl:22-23). Useful for feeding host-sharded inputs to
    ``jax.make_array_from_process_local_data``."""
    nproc = jax.process_count()
    assert nline_padded % nproc == 0, (nline_padded, nproc)
    per = nline_padded // nproc
    i = jax.process_index()
    return slice(i * per, (i + 1) * per)
