"""Device-resident grid data (jnp arrays, registered pytree).

Equivalent of the reference ``GridData`` SoA container
(``/root/reference/src/utils/grid_data.jl:3-89``) + the ``get_*_data``
flatteners (opfdata.jl:542-887). Differences by design:

- the CSR bus adjacency (FrStart/FrIdx, ToStart/ToIdx, GenStart/GenIdx) is
  replaced by plain segment ids (``line_from``/``line_to``/``gen_bus``): the
  bus consensus update becomes ``jax.ops.segment_sum`` + gathers instead of
  per-bus CSR loops (reference acopf_bus_kernel_cpu.jl:20-55),
- per-line Vm/Va bounds are (nline, 2) lo/hi arrays rather than interleaved
  flat vectors (reference ``FrVmBound`` et al., opfdata.jl:700-713),
- lines may be padded to a multiple of the device-mesh size (the reference
  pads for MPI ranks, acopf_model.jl:50-53); ``line_mask`` zeroes padded
  lanes out of every reduction.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .opfdata import OPFData
from .pytree import pytree_dataclass, static_field


@pytree_dataclass
class GridData:
    # static sizes
    nbus: int = static_field()
    ngen: int = static_field()
    nline: int = static_field()        # real line count
    nline_padded: int = static_field() # padded line count (arrays below use this)

    baseMVA: jnp.ndarray  # scalar

    # generators (ngen,)
    pgmin: jnp.ndarray
    pgmax: jnp.ndarray
    qgmin: jnp.ndarray
    qgmax: jnp.ndarray
    c2: jnp.ndarray  # raw $/MW^2h (obj_scale applied by the model, not here)
    c1: jnp.ndarray
    c0: jnp.ndarray
    ramp_rate: jnp.ndarray
    gen_bus: jnp.ndarray  # int32

    # lines (nline_padded,)
    YffR: jnp.ndarray
    YffI: jnp.ndarray
    YttR: jnp.ndarray
    YttI: jnp.ndarray
    YftR: jnp.ndarray
    YftI: jnp.ndarray
    YtfR: jnp.ndarray
    YtfI: jnp.ndarray
    rate_a: jnp.ndarray     # tight_factor * (rateA/baseMVA)^2, 1e3 if unlimited
    line_from: jnp.ndarray  # int32 bus index (padded lanes point at bus 0)
    line_to: jnp.ndarray    # int32
    fr_vm_bound: jnp.ndarray  # (nline_padded, 2) lo/hi
    to_vm_bound: jnp.ndarray
    fr_va_bound: jnp.ndarray
    to_va_bound: jnp.ndarray
    line_mask: jnp.ndarray  # 1.0 for real lines, 0.0 for padding

    # buses (nbus,)
    Pd: jnp.ndarray   # MW (divided by baseMVA inside the bus kernel)
    Qd: jnp.ndarray
    Vmin: jnp.ndarray
    Vmax: jnp.ndarray
    YshR: jnp.ndarray
    YshI: jnp.ndarray

    # lines statically sorted by from-bus at build (incl. padding pointing
    # at the last bus): the fr-side line->bus segment_sum may then use
    # XLA's indices_are_sorted fast path (~2.1x on the scatter at 70k
    # scale, tools/bus_bench.py). Cleared by permute_lines.
    fr_sorted: bool = static_field(default=False)


#: line-indexed GridData array fields (leading axis nline_padded)
LINE_ARRAY_FIELDS = (
    "YffR", "YffI", "YttR", "YttI", "YftR", "YftI", "YtfR", "YtfI",
    "rate_a", "line_from", "line_to",
    "fr_vm_bound", "to_vm_bound", "fr_va_bound", "to_va_bound", "line_mask",
)


def permute_lines(gd: GridData, ids) -> GridData:
    """Reorder every line-indexed array by ``ids``.

    The ADMM iteration is permutation-equivariant in the line batch (the
    reference's per-line CUDA blocks are order-free too); reordering only
    changes which lines share a kernel tile / device shard. All 16 arrays
    are packed column-wise and gathered ONCE; the int32 bus indices ride
    along as floats (exact below 2^23).
    """
    import dataclasses as _dc
    dtype = gd.YffR.dtype
    cols, spans, names = [], {}, []
    pos = 0
    for f in LINE_ARRAY_FIELDS:
        a = getattr(gd, f)
        col = a.astype(dtype)
        if col.ndim == 1:
            col = col[:, None]
        cols.append(col)
        spans[f] = (pos, pos + col.shape[1], a.dtype, a.ndim)
        pos += col.shape[1]
        names.append(f)
    sub = jnp.concatenate(cols, axis=1)[ids]
    out = {}
    for f in names:
        lo, hi, dt, nd = spans[f]
        col = sub[:, lo:hi]
        if nd == 1:
            col = col[:, 0]
        out[f] = col.astype(dt)
    # a dynamic permutation breaks the static from-bus ordering
    return _dc.replace(gd, fr_sorted=False, **out)


def build_grid_data(
    data: OPFData,
    *,
    tight_factor: float = 1.0,
    ramp_ratio: float = 0.02,
    pad_lines_to: int = 1,
    sort_lines_static: bool = False,
    dtype=jnp.float64,
) -> GridData:
    """Flatten an :class:`OPFData` into a device :class:`GridData`.

    - ``rate_a`` follows reference opfdata.jl:714: 1e3 when rateA==0, else
      ``tight_factor*(rateA/baseMVA)^2`` (limits are imposed on squared flows).
    - Va bounds are [-2pi, 2pi] except pinned to 0 at the reference bus
      (opfdata.jl:702-713).
    - ``ramp_rate = ramp_ratio * pgmax`` (acopf_model.jl:66-67).
    - ``pad_lines_to``: pad nline up to a multiple (for sharding).
    - ``sort_lines_static``: permanently order the line batch by from-bus
      (the ADMM iteration is permutation-equivariant in lines, like the
      reference's order-free per-line CUDA blocks) and mark ``fr_sorted``
      so the fr-side bus scatter can use XLA's sorted-indices fast path.
      Results come back in the sorted line order.
    """
    import dataclasses as _dc

    if sort_lines_static:
        perm = np.argsort(np.asarray(data.line_from), kind="stable")
        line_fields = ("line_from", "line_to", "YffR", "YffI", "YttR",
                       "YttI", "YftR", "YftI", "YtfR", "YtfI", "rateA")
        data = _dc.replace(
            data, **{f: np.asarray(getattr(data, f))[perm]
                     for f in line_fields})

    nline = data.nline
    npad = -(-nline // pad_lines_to) * pad_lines_to

    def padf(x, fill=0.0):
        x = np.asarray(x, dtype=np.float64)
        if npad == nline:
            return x
        return np.concatenate([x, np.full(npad - nline, fill)])

    def padi(x, fill=0):
        x = np.asarray(x, dtype=np.int32)
        if npad == nline:
            return x
        return np.concatenate([x, np.full(npad - nline, fill, dtype=np.int32)])

    rate_a = np.where(
        data.rateA == 0.0, 1.0e3, tight_factor * (data.rateA / data.baseMVA) ** 2
    )

    two_pi = 2.0 * np.pi
    fr_va_lo = np.where(data.line_from == data.bus_ref, 0.0, -two_pi)
    fr_va_hi = np.where(data.line_from == data.bus_ref, 0.0, two_pi)
    to_va_lo = np.where(data.line_to == data.bus_ref, 0.0, -two_pi)
    to_va_hi = np.where(data.line_to == data.bus_ref, 0.0, two_pi)

    fr_vm_lo = data.Vmin[data.line_from]
    fr_vm_hi = data.Vmax[data.line_from]
    to_vm_lo = data.Vmin[data.line_to]
    to_vm_hi = data.Vmax[data.line_to]

    def bound2(lo, hi, fill_lo=0.9, fill_hi=1.1):
        return np.stack([padf(lo, fill_lo), padf(hi, fill_hi)], axis=-1)

    mask = np.concatenate([np.ones(nline), np.zeros(npad - nline)])

    f = lambda x: jnp.asarray(x, dtype=dtype)  # noqa: E731
    fi = lambda x: jnp.asarray(x, dtype=jnp.int32)  # noqa: E731

    return GridData(
        nbus=data.nbus,
        ngen=data.ngen,
        nline=nline,
        nline_padded=npad,
        baseMVA=f(data.baseMVA),
        pgmin=f(data.pgmin),
        pgmax=f(data.pgmax),
        qgmin=f(data.qgmin),
        qgmax=f(data.qgmax),
        c2=f(data.c2),
        c1=f(data.c1),
        c0=f(data.c0),
        ramp_rate=f(ramp_ratio * data.pgmax),
        gen_bus=fi(data.gen_bus),
        YffR=f(padf(data.YffR)),
        YffI=f(padf(data.YffI)),
        YttR=f(padf(data.YttR)),
        YttI=f(padf(data.YttI)),
        YftR=f(padf(data.YftR)),
        YftI=f(padf(data.YftI)),
        YtfR=f(padf(data.YtfR)),
        YtfI=f(padf(data.YtfI)),
        rate_a=f(padf(rate_a, 1.0e3)),
        # sorted mode: padding must keep the ids non-decreasing (padded
        # lanes are masked out of every aggregate, their target bus is
        # arbitrary)
        line_from=fi(padi(data.line_from,
                          int(np.max(data.line_from))
                          if sort_lines_static and nline else 0)),
        line_to=fi(padi(data.line_to)),
        fr_vm_bound=f(bound2(fr_vm_lo, fr_vm_hi)),
        to_vm_bound=f(bound2(to_vm_lo, to_vm_hi)),
        fr_va_bound=f(bound2(fr_va_lo, fr_va_hi, -two_pi, two_pi)),
        to_va_bound=f(bound2(to_va_lo, to_va_hi, -two_pi, two_pi)),
        line_mask=f(mask),
        Pd=f(data.Pd),
        Qd=f(data.Qd),
        Vmin=f(data.Vmin),
        Vmax=f(data.Vmax),
        YshR=f(data.YshR),
        YshI=f(data.YshI),
        fr_sorted=sort_lines_static,
    )
