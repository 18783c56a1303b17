"""B3 and B4: the EnSRF body with weights streamed in per grid point.

Counterpart of two JAX kernels that share one computation and differ in
schedule and weight source:

* B3, ``efa_xray_tpu/ops/ensrf_pallas_fused.py``: ``_make_fused_grid_kernel``
  :784 and ``_fused_grid_impl`` :878.  Every obs block in one launch; exact
  chordal Gaspari-Cohn weights per grid point; a per-(group, ob) table of
  vertical factors (``_gc_poly``) times the optional cross-variable
  ``group_factor``.  Here :func:`grid_body`.
* B4, ``efa_xray_tpu/ops/ensrf_pallas.py``: ``_make_block_kernel`` :68,
  ``apply_obs_block_pallas`` :142 and ``ensrf_blocked_body_pallas`` :316.
  One launch per obs block; exact haversine (or chordal) weights per grid
  point; the vertical factor as a ``[VT, B]`` table when the state has
  VT > 1 groups, folded into per-row weights when VT = 1.  Here
  :func:`apply_obs_block` and :func:`blocked_body`.
* B4e, B4's instantiation for the stochastic EnKF (``apply_rows``, fp32):
  the solved columns are applied against the departure rows ``z = ye -
  eps``, ``ggt[j, i] = (z_i . y_j) sqrt_coef_i`` and ``X -= (sqrt_coef o
  U)^T Z`` (``ensrf_core.apply_obs_block(apply_rows=z)``, which the JAX
  package runs in plain XLA).  :func:`blocked_body` also takes
  ``varloc`` on a flat state, as a per-(ob, row) factor.

Any ensemble and any block run, by B2's two levers (:func:`plan`,
:func:`sub_blocks`; :mod:`efa_xray_tpu_torch.ops.ensrf_fused`): sub-blocks
swept in order where the block's layout does not fit a CTA, member slices
where no sub-block of 32 obs fits either.  Every shape whose layout fits
runs as it always did.

The weights and tables are built outside the kernel with torch ops, as the
JAX package builds them with XLA outside Pallas, except B4's exact
haversine weights of a flat state on the card: where nothing else
multiplies them (:func:`points_for_kernel`), B4 and B4e compute them per
(ob, point) from a :class:`Geometry` (``csrc/ensrf_grid.cu``
``gc_haversine``), bit for bit the torch weights, and no ``[B, G]`` weight
tensor is built.  :func:`grid_apply` and
:func:`block_apply` launch the CUDA kernel of
``efa_xray_tpu_torch/csrc/ensrf_grid.cu`` on CUDA tensors, or run
:func:`grid_apply_plain`, the same computation in plain torch, on CPU
tensors.  Rows are ``(group, grid point)``: ``StateStructure.row_latlon``
order, so the grid is the first ``ngrid`` rows' coordinates.

B3's weight array holds ``nobs x ngrid`` floats.  :func:`grid_body` builds
it, and launches the kernel, over chunks of blocks under
``GRID_WEIGHT_BUDGET_BYTES``: the body sweep composes exactly over blocks
(each block is a row-local update of the state the previous one left), so
the chunks give the one-launch result.

``precision`` (:mod:`efa_xray_tpu_torch.ops.precision`) is the mode of the
two large products, D0 = X Y^T and the apply X -= (sqrt_coef o U)^T Y:
``"ieee"`` (fp32), or ``"tf32"`` / ``"bf16"``, where the kernel runs them on
the tensor cores and the plain version rounds the same operands before an
fp32 product (B3: as the JAX kernel's ``mxu_bf16`` casts,
``ensrf_pallas_fused.py:821-828``, :868-874; B4: as the TPU's default
matmul precision makes of ``ensrf_pallas.py:87-90``, :127-131).  The
substitution, the weights and the mean stay fp32.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from efa_xray_tpu_torch.assimilation.ensrf_core import (
    ObsArrays,
    TailSolution,
    _pad,
)
from efa_xray_tpu_torch.observation.localization import (
    EARTH_RADIUS_KM,
    chordal_gc_weights,
    gaspari_cohn,
    haversine,
    latlon_to_unit,
)
from efa_xray_tpu_torch.ops import _build
from efa_xray_tpu_torch.ops.ensrf_fused import (
    MAX_SMEM_BYTES,
    PANEL,
    Plan,
    _gc_poly,
    diagonal_blocks,
    per_ob_blocks,
    staging_plan,
)
from efa_xray_tpu_torch.ops import precision as prec
from efa_xray_tpu_torch.ops.precision import MODES, round_inputs
from efa_xray_tpu_torch.utils import profiling

# Per-ob rows in the kernel's shared memory (csrc/ensrf_grid.cu kCoef).
COEF_ROWS = 3
# Slots of the kernel's ring of ggt and weight panels (kSlots).
RING_SLOTS = 2
# Shared memory of an SM, and what the system keeps of it for each CTA
# (kSmSmemBytes, kCtaReservedBytes).
SM_SMEM_BYTES = 233472
CTA_RESERVED_BYTES = 1024
# Bytes of B3 weights built at once (the temporaries of their build take
# several times this).
GRID_WEIGHT_BUDGET_BYTES = 1 << 29

# Launches of the CUDA kernel (not of the plain version), per entry point,
# and per entry point and product mode.
b3_launches = 0
b4_launches = 0
launches_by_mode = {k: dict.fromkeys(MODES, 0) for k in ("B3", "B4")}
# Launches of B4e (fp32 only).
b4e_launches = 0
# Launches of B4 and B4e by where their weights came from: computed in the
# kernel from a Geometry, read from a w operand, none (unlocalized).
b4_weight_source = dict.fromkeys(("kernel", "w", "none"), 0)
# Guards the counters against launches from several threads.
_count_lock = threading.Lock()


def smem_bytes(tile: int, block_size: int, nmems: int,
               precision: str = "ieee") -> int:
    """Shared memory of one CTA (mirrors ``make_layout`` in
    ``csrc/ensrf_grid.cu``, and ``make_mode_layout`` for the tensor-core
    modes ``precision``)."""
    t, b, m = tile, block_size, nmems
    ys = 4 * (-(-m // 4) | 1)        # row stride of X and Y: 4 x odd words
    bp = -(-b // PANEL) * PANEL      # obs rounded up to whole panels
    us = prec.u_stride(precision, t)  # row stride of U
    if precision != "ieee":
        ys = prec.mode_row_stride(precision, m)
    return 4 * (t * ys                           # X
                + bp * ys + bp // 2              # Y, panels skewed
                + bp * us                        # d0 / u columns
                + RING_SLOTS * bp * PANEL        # ring of ggt panel columns
                + RING_SLOTS * PANEL * t         # ring of weight panel rows
                + ((COEF_ROWS * b + 3) & ~3)     # per-ob rows
                + t)                             # mean


def ctas_per_sm(tile: int, block_size: int, nmems: int,
                precision: str = "ieee") -> int:
    """CTAs per SM the kernel plans for at this shape in product mode
    ``precision`` (mirrors ``ctas_per_sm`` in ``csrc/ensrf_grid.cu``):
    what fits by shared memory, at most 3 (from there on the kernel is
    compiled for 85 registers a thread); 0 when one CTA does not fit."""
    return min(3, SM_SMEM_BYTES // (
        smem_bytes(tile, block_size, nmems, precision) + CTA_RESERVED_BYTES))


def pick_tile(block_size: int, nmems: int, precision: str = "ieee") -> int:
    """Grid points per CTA: 64 where at least two such CTAs share an SM
    (fp32: three up to 36 members at blocks of 128, two up to 84: measured
    23-28% faster than the same number of CTAs of 32 points at 30 and at
    80 members), else 32 (two CTAs up to 128 members, one beyond).  The
    tensor-core modes' wider U keeps those counts at 30 and 80 members."""
    return (64 if ctas_per_sm(64, block_size, nmems, precision) >= 2
            else 32)


def plan(block_size: int, nmems: int, precision: str = "ieee",
         tile=None) -> Plan:
    """The launch's :class:`~efa_xray_tpu_torch.ops.ensrf_fused.Plan` at
    ``tile`` points (:func:`pick_tile`'s when None): ``ensrf_fused.
    staging_plan`` of this kernel's layout."""
    return staging_plan(
        lambda t, b, m: smem_bytes(t, b, m, precision),
        lambda b: pick_tile(b, nmems, precision), block_size, nmems, tile)


class Geometry(NamedTuple):
    """What B4 computes its exact haversine weights from, in place of
    ``w``: ``points [3, G]``, the grid points' latitude (radians),
    longitude (degrees) and cos(latitude); ``obs [nb, 4, B]`` (one block's
    ``[4, B]`` from :func:`block_operands`), the same three of each ob and
    its halfwidth (km) (both rows from :func:`point_geometry`).
    :func:`geometry_weights` gives the weights."""

    points: torch.Tensor
    obs: torch.Tensor


def point_geometry(lat, lon, dtype, radii=None) -> torch.Tensor:
    """:class:`Geometry`'s rows for places at ``lat``, ``lon`` (degrees):
    ``[3, n]`` for points, ``[4, n]`` with the obs' halfwidths
    ``radii``."""
    rad = torch.deg2rad(lat.to(dtype))
    return torch.stack([rad, lon.to(dtype), torch.cos(rad)]
                       + ([] if radii is None else [radii.to(dtype)]))


def geometry_weights(points, obs) -> torch.Tensor:
    """The weights ``[..., B, G]`` of a :class:`Geometry`'s ``points``
    and ``obs [..., 4, B]``, in torch, in the kernel's order of operations
    (``csrc/ensrf_grid.cu`` ``gc_haversine``), which is ``haversine``'s
    and ``gaspari_cohn``'s: on the same device and dtype, the weights
    :func:`block_operands` builds otherwise, bit for bit."""
    olat, olon, ocos, hw = (obs[..., i, :, None] for i in range(4))
    sl = torch.sin((points[0] - olat) / 2.0)
    sn = torch.sin(torch.deg2rad(points[1] - olon) / 2.0)
    a = sl ** 2 + ocos * points[2] * sn ** 2
    c = 2.0 * torch.atan2(torch.sqrt(a), torch.sqrt(1.0 - a))
    return gaspari_cohn(EARTH_RADIUS_KM * c, hw)


def points_for_kernel(lat, lon, dtype, *, on_card: bool, localize: bool,
                      fast_geometry: bool, vertical: bool, vt: int,
                      row_factor: bool = False):
    """The grid points' :func:`point_geometry` (``lat``, ``lon``: the
    ``G`` points') where B4 computes its blocks' weights itself, else None
    (the blocks read a ``w`` operand built in torch).  B4 computes them on
    the card for the exact haversine weights of a flat state (VT = 1) that
    nothing else multiplies: no per-(ob, row) factor (``row_factor``), no
    per-row vertical factor.  At VT > 1 each group's CTA over a grid tile
    would compute the tile's weights again, where torch builds them once
    for every group, so those blocks read ``w``; so does the CPU (the
    parity path)."""
    if not (on_card and localize and vt == 1 and not fast_geometry
            and not vertical and not row_factor):
        return None
    return point_geometry(lat, lon, dtype)


def as_blocks(w):
    """One block's weight operand (``[B, G]``, a :class:`Geometry` with
    ``obs [4, B]``, or None) as the blocks' (``nb`` = 1)."""
    if isinstance(w, Geometry):
        return Geometry(w.points, w.obs[None])
    return None if w is None else w[None]


def _sub_geometry(obs, sub: int):
    """``obs [nb, 4, B]`` as ``[nb * k, 4, sub]``, each block padded to
    whole sub-blocks with obs of infinite halfwidth (weight 1: the zero
    obs stay exact no-ops)."""
    nb, _, bsz = obs.shape
    k = -(-bsz // sub)
    fill = obs.new_zeros((nb, 4, k * sub - bsz))
    fill[:, 2] = 1.0
    fill[:, 3] = float("inf")
    return (torch.cat([obs, fill], dim=2).reshape(nb, 4, k, sub)
            .transpose(1, 2).reshape(nb * k, 4, sub).contiguous())


def sub_blocks(y_b, ggt_b, coef_b, w, table, z_b, sub: int):
    """Blocks of ``B`` obs (``y_b [nb, B, M]``, ``ggt_b [nb, B, B]``,
    ``coef_b [nb, 2, B]``, ``w [nb, B, G]``, a :class:`Geometry` or None,
    ``table [VT, nb, B]`` or None, ``z_b`` or None) as blocks of ``sub``
    obs, swept in the same order: each block padded to whole sub-blocks
    with zero obs (exact no-ops) and the Gram tables' diagonal blocks."""
    nb, bsz, _ = y_b.shape
    if sub >= bsz:
        return y_b, ggt_b, coef_b, w, table, z_b
    k = -(-bsz // sub)
    pad = k * sub - bsz
    rows = lambda t: None if t is None else torch.nn.functional.pad(
        t, (0, 0, 0, pad)).reshape(nb * k, sub, t.shape[-1]).contiguous()
    if table is not None:
        table = torch.nn.functional.pad(table, (0, pad)).reshape(
            table.shape[0], nb * k, sub).contiguous()
    w = (Geometry(w.points, _sub_geometry(w.obs, sub))
         if isinstance(w, Geometry) else rows(w))
    return (rows(y_b), diagonal_blocks(ggt_b, sub),
            per_ob_blocks(coef_b, sub), w, table, rows(z_b))


def _gram_tables(y_b, sqrtc_b, z_b=None):
    """``ggt[blk, j, i] = (a_i . y_j) sqrt_coef_i`` for ``y_b [nb, B, M]``,
    the rows ``a`` being ``y_b`` or B4e's ``z_b``."""
    gram = torch.bmm(y_b if z_b is None else z_b, y_b.transpose(1, 2))
    return (gram * sqrtc_b[:, :, None]).transpose(1, 2)


# ---------------------------------------------------------------------------
# The shared computation: plain version and CUDA launch
# ---------------------------------------------------------------------------


def grid_apply_plain(bm, bp, w, table, y_b, ggt_b, coef_b, vt: int,
                     precision: str = "ieee", operands: list | None = None,
                     z_b=None, sub=None, mslice=None):
    """Plain-torch body on prepared operands; returns ``(bm, bp)``.
    ``z_b [nb, B, M]`` (B4e): the rows the apply reads instead of Y.
    ``sub``/``mslice`` (:func:`plan`'s when None) are the kernel's order:
    sub-blocks swept in turn, D0 summed over slices of ``mslice`` members.

    ``bm [VT*G]``, ``bp [VT*G, M]``; ``w [nb, B, G]``, a
    :class:`Geometry` (its weights built here in torch) or None
    (unlocalized); ``table [VT, nb, B]`` or None (ones); ``y_b [nb, B,
    M]``; ``ggt_b [nb, B, B]``; ``coef_b [nb, 2, B]`` (gain, sqrt_coef).
    The two large products round their operands as mode ``precision``
    does.  A list ``operands`` receives each block's apply operands before
    rounding: ``(sqrt_coef o U [VT*G, B], Y [B, M])``.
    """
    rnd = lambda x: round_inputs(x, precision)
    nrows, nmems = bp.shape
    g = nrows // vt
    if isinstance(w, Geometry):
        w = geometry_weights(*w)
    if sub is None or mslice is None:
        _, sub, mslice = plan(y_b.shape[1], nmems, precision)
    y_b, ggt_b, coef_b, w, table, z_b = sub_blocks(y_b, ggt_b, coef_b, w,
                                                   table, z_b, sub)
    nblocks, bsz, _ = y_b.shape
    x = bp.reshape(vt, g, nmems)
    xm = bm.reshape(vt, g)
    for b in range(nblocks):
        y = y_b[b]
        d0 = rnd(x) @ rnd(y).T if mslice >= nmems else sum(  # [VT, G, B]
            rnd(x[..., m0:m0 + mslice]) @ rnd(y[:, m0:m0 + mslice]).T
            for m0 in range(0, nmems, mslice))
        u = torch.zeros_like(d0)
        for base in range(0, bsz, PANEL):
            width = min(PANEL, bsz - base)
            d_panel = d0[..., base:base + width]
            if base > 0:
                d_panel = d_panel - u[..., :base] @ ggt_b[b, base:base + width,
                                                         :base].T
            if w is not None:
                w_panel = w[b, base:base + width, :].T[None]  # [1, G, width]
                if table is not None:
                    w_panel = w_panel * table[:, b, None, base:base + width]
            for t in range(width):
                j = base + t
                d_j = d_panel[..., t]
                if t > 0:
                    d_j = d_j - u[..., base:j] @ ggt_b[b, j, base:j]
                if w is not None:
                    d_j = d_j * w_panel[..., t]
                u[..., j] = d_j
        xm = xm + u @ coef_b[b, 0]
        left = u * coef_b[b, 1]
        right = y if z_b is None else z_b[b]
        if operands is not None:
            operands.append((left.reshape(nrows, bsz), right))
        x = x - rnd(left) @ rnd(right)
    return xm.reshape(nrows), x.reshape(nrows, nmems)


def grid_apply_cuda(entry: str, bm, bp, w, table, y_b, ggt_b, coef_b,
                    vt: int, donate: bool = False, tile=None,
                    precision: str = "ieee", z_b=None):
    """Launch the kernel of ``csrc/ensrf_grid.cu`` for ``entry`` ("B3"
    or "B4"; "B4" with ``z_b`` is B4e) on CUDA float32 tensors, at
    ``tile`` grid points per CTA (:func:`pick_tile`'s when None), staged
    as :func:`plan` says there, its two large products in mode
    ``precision``; ``w`` a :class:`Geometry` (B4): the kernel computes the
    weights.  ``donate=True`` updates ``bm``/``bp`` in place."""
    if precision not in MODES:
        raise ValueError(f"unknown mode {precision!r}; expected one of "
                         f"{MODES}")
    if z_b is not None and (entry != "B4" or precision != "ieee"):
        raise ValueError("apply rows run through B4 in fp32 only (B4e)")
    geo = w if isinstance(w, Geometry) else None
    if geo is not None:
        if entry != "B4":
            raise ValueError("only B4 computes its weights in the kernel")
        w = None
    nrows, nmems = bp.shape
    nblocks, bsz, _ = y_b.shape
    dev = bp.device
    f32 = torch.float32
    ops = [t for t in (bm, bp, w, table, y_b, ggt_b, coef_b, z_b,
                       *(geo or ())) if t is not None]
    for t in ops:
        if t.device != dev or t.dtype != f32:
            raise ValueError(f"{entry} takes float32 tensors on one CUDA "
                             "device")
    if vt < 1 or nrows % vt:
        raise ValueError(f"{entry}: {nrows} rows are not {vt} groups")
    g = nrows // vt
    if (bm.shape != (nrows,) or ggt_b.shape != (nblocks, bsz, bsz)
            or coef_b.shape != (nblocks, 2, bsz)
            or (w is not None and w.shape != (nblocks, bsz, g))
            or (table is not None and table.shape != (vt, nblocks, bsz))
            or (z_b is not None and z_b.shape != y_b.shape)
            or (geo is not None and (geo.points.shape != (3, g) or
                                     geo.obs.shape != (nblocks, 4, bsz)))):
        raise ValueError(f"{entry} operand shapes disagree")
    tile, sub, mslice = plan(bsz, nmems, precision, tile)
    y_b, ggt_b, coef_b, w, table, z_b = sub_blocks(
        y_b, ggt_b, coef_b, geo or w, table, z_b, sub)
    if geo is not None:  # the geometry, cut as the blocks are
        geo, w = w, None
    nblocks, bsz, _ = y_b.shape
    if donate and bm.is_contiguous() and bp.is_contiguous():
        out_m, out_p = bm, bp
    else:
        out_m = torch.empty(nrows, dtype=f32, device=dev)
        out_p = torch.empty((nrows, nmems), dtype=f32, device=dev)
    if precision != "ieee":  # Y rounded once for every CTA
        y_b = prec.staged_y(y_b, precision)
    ins = [None if t is None else t.contiguous()
           for t in (bm, bp, w, table, y_b, z_b, ggt_b, coef_b,
                     *(geo or (None, None)))]
    ptrs = [None if t is None else t.data_ptr() for t in ins]
    lib = _build.lib()
    # The C entries set their attributes on, and launch onto, the current
    # device: make it the tensors' one.
    with torch.cuda.device(dev):
        err = lib.efa_grid_launch(
            *ptrs, vt, g, nmems, mslice, bsz, nblocks, tile,
            MODES.index(precision), out_m.data_ptr(), out_p.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if z_b is not None:
        _build.check(err, "B4e ensrf_grid launch")
        _count_enkf()
    else:
        _build.check(err, f"{entry} ensrf_grid launch ({precision})")
        _count(entry, precision)
    if entry == "B4":
        _count_weights("kernel" if geo is not None else
                       "none" if w is None else "w")
    return out_m, out_p


def _count_enkf() -> None:
    """One launch of B4e."""
    global b4e_launches
    with _count_lock:
        b4e_launches += 1


def _count_weights(source: str) -> None:
    """One launch of B4 or B4e, its weights from ``source`` (a key of
    :data:`b4_weight_source`)."""
    with _count_lock:
        b4_weight_source[source] += 1


def _count(entry: str, precision: str) -> None:
    """One launch through ``entry`` ("B3" or "B4") in mode ``precision``."""
    global b3_launches, b4_launches
    with _count_lock:
        if entry == "B3":
            b3_launches += 1
        else:
            b4_launches += 1
        launches_by_mode[entry][precision] += 1


def ctas_per_sm_on_card(tile: int, block_size: int, nmems: int,
                        device=None, precision: str = "ieee") -> int:
    """CTAs of the built kernel in product mode ``precision`` that the
    occupancy calculator of ``device`` (the current CUDA device when None)
    puts on one SM at this shape (registers and shared memory
    included)."""
    with torch.cuda.device(device):
        n = _build.lib().efa_grid_ctas_per_sm(nmems, block_size, tile,
                                              MODES.index(precision))
    _build.check(-n if n < 0 else 0, "ensrf_grid occupancy query")
    return n


def _dispatch(entry: str, bm, bp, w, table, y_b, ggt_b, coef_b, vt: int,
              donate: bool, precision: str, z_b=None):
    if bp.is_cuda:
        return grid_apply_cuda(entry, bm, bp, w, table, y_b, ggt_b, coef_b,
                               vt, donate, precision=precision, z_b=z_b)
    if bp.device.type != "cpu":
        raise ValueError(f"{entry} runs on CUDA or CPU, not {bp.device}")
    return grid_apply_plain(bm, bp, w, table, y_b, ggt_b, coef_b, vt,
                            precision, z_b=z_b)


def grid_apply(bm, bp, w, table, y_b, ggt_b, coef_b, vt: int,
               donate: bool = False, precision: str = "ieee"):
    """B3 dispatch: one launch over all the blocks of ``y_b`` on CUDA
    tensors, the plain version on CPU tensors."""
    return _dispatch("B3", bm, bp, w, table, y_b, ggt_b, coef_b, vt, donate,
                     precision)


def block_apply(bm, bp, w, table, y, ggt, coef, vt: int,
                donate: bool = False, precision: str = "ieee", z=None):
    """B4 dispatch for one block: ``w [B, G]``, a :class:`Geometry` (its
    ``obs [4, B]``) or None, ``table [VT, B]`` or None, ``y [B, M]``,
    ``ggt [B, B]``, ``coef [2, B]``; B4e with the apply rows ``z [B,
    M]``."""
    return _dispatch("B4", bm, bp, as_blocks(w),
                     None if table is None else table[:, None, :], y[None],
                     ggt[None], coef[None], vt, donate, precision,
                     z_b=None if z is None else z[None])


# ---------------------------------------------------------------------------
# B3: every block in one launch
# ---------------------------------------------------------------------------


def grid_prepare(body_perts, body_vert, tail: TailSolution, obs: ObsArrays,
                 ngrid: int, localize: bool = True, block_size: int = 128,
                 vertical: bool = False, group_factor=None):
    """B3's per-block operands, as ``_fused_grid_impl`` :921-973 builds
    them: a dict of ``y_b, ggt_b, coef_b, table, ob_xyz, radii, vt``
    (``ob_xyz``/``radii`` padded, for :func:`grid_weights`)."""
    dtype = body_perts.dtype
    nrows, nmems = body_perts.shape
    if ngrid <= 0 or nrows % ngrid:
        raise ValueError(f"{nrows} rows do not tile a grid of {ngrid}")
    vt = nrows // ngrid
    nobs = tail.ye.shape[0]
    bsz = block_size
    nblocks = max(1, -(-nobs // bsz))
    pad = nblocks * bsz - nobs
    obs = obs.with_default_verts()
    inf = float("inf")
    y_b = _pad(tail.ye.to(dtype), pad).reshape(nblocks, bsz, nmems)
    gain = _pad(tail.gain_coef.to(dtype), pad)
    sqrtc = _pad(tail.sqrt_coef.to(dtype), pad)
    radii = _pad(obs.radii.to(dtype), pad, inf)
    ob_xyz = _pad(latlon_to_unit(obs.lats, obs.lons).to(dtype), pad)
    ggt_b = _gram_tables(y_b, sqrtc.reshape(nblocks, bsz))
    coef_b = torch.stack([gain, sqrtc]).reshape(2, nblocks, bsz).transpose(0, 1)

    table = None
    if localize and vertical:
        group_vert = body_vert.to(dtype).reshape(vt, ngrid)[:, 0]
        overt = _pad(obs.verts.to(dtype), pad)
        ovrad = _pad(obs.vert_radii.to(dtype), pad, inf)
        off = torch.isinf(ovrad)
        inv = torch.where(off, torch.zeros_like(ovrad), 1.0 / torch.abs(ovrad))
        table = _gc_poly(torch.abs(group_vert[:, None] - overt[None, :])
                         * inv[None, :])
        table = torch.where(off[None, :], torch.ones_like(table), table)
    if group_factor is not None:
        if not localize:
            raise ValueError("group_factor needs localize=True (the kernel "
                             "applies the table inside the localization "
                             "branch)")
        gf = torch.cat([group_factor.to(dtype),
                        torch.ones((vt, pad), dtype=dtype,
                                   device=body_perts.device)], dim=1)
        table = gf if table is None else table * gf
    if table is not None:
        table = table.reshape(vt, nblocks, bsz).contiguous()
    return dict(y_b=y_b.contiguous(), ggt_b=ggt_b.contiguous(),
                coef_b=coef_b.contiguous(), table=table, ob_xyz=ob_xyz,
                radii=radii, vt=vt)


def grid_weights(grid_xyz, ob_xyz, radii):
    """Exact chordal Gaspari-Cohn weights ``[nobs, G]`` of the obs at every
    grid point (``_fused_grid_impl`` :939-945)."""
    return chordal_gc_weights(ob_xyz[:, None, :], grid_xyz[None, :, :],
                              radii[:, None]).to(grid_xyz.dtype)


def grid_body(body_mean, body_perts, body_lat, body_lon, tail: TailSolution,
              obs: ObsArrays, ngrid: int, body_vert=None,
              localize: bool = True, block_size: int = 128,
              vertical: bool = False, group_factor=None,
              donate: bool = False, precision: str = "ieee"):
    """Phase 2 through B3 for a state whose rows tile one grid of
    ``ngrid`` points over VT groups.  Drop-in for
    ``ensrf_core.ensrf_blocked_body`` with chordal geometry.
    ``group_factor [VT, No]`` multiplies ob j's gain on group v
    (cross-variable localization).  ``donate=True`` lets the kernel update
    the caller's buffers in place.  ``precision``: the mode of the two
    large products."""
    if tail.ye.shape[0] == 0:
        return body_mean, body_perts
    dtype = body_perts.dtype
    ops = grid_prepare(body_perts, body_vert, tail, obs, ngrid,
                       localize=localize, block_size=block_size,
                       vertical=vertical, group_factor=group_factor)
    nblocks = ops["y_b"].shape[0]
    grid_xyz = (latlon_to_unit(body_lat[:ngrid], body_lon[:ngrid]).to(dtype)
                if localize else None)
    per_block = block_size * ngrid * body_perts.element_size()
    chunk = max(1, GRID_WEIGHT_BUDGET_BYTES // per_block)
    bm, bp = body_mean.to(dtype), body_perts
    for lo in range(0, nblocks, chunk):
        hi = min(nblocks, lo + chunk)
        w = None
        if localize:
            sl = slice(lo * block_size, hi * block_size)
            w = grid_weights(grid_xyz, ops["ob_xyz"][sl], ops["radii"][sl])
            w = w.reshape(hi - lo, block_size, ngrid)
        table = None if ops["table"] is None else ops["table"][:, lo:hi]
        # Only the first launch may need fresh outputs; later ones update
        # the buffers this call owns.
        bm, bp = grid_apply(bm, bp, w, table, ops["y_b"][lo:hi],
                            ops["ggt_b"][lo:hi], ops["coef_b"][lo:hi],
                            ops["vt"], donate=donate or lo > 0,
                            precision=precision)
    return bm, bp


# ---------------------------------------------------------------------------
# B4: one block per launch
# ---------------------------------------------------------------------------


def _grid_of(nrows: int, ngrid):
    """``(G, VT)`` of ``nrows`` rows over a grid of ``ngrid`` points; an
    ``ngrid`` that does not divide the rows means a flat state (VT = 1)."""
    if ngrid is None or ngrid <= 0 or nrows % ngrid:
        return nrows, 1
    return ngrid, nrows // ngrid


@profiling.spanned(profiling.OPS_BLOCK_OPERANDS)
def block_operands(body_lat, body_lon, ye_block, sqrt_coef, ob_lat, ob_lon,
                   radii, nrows: int, localize: bool = True,
                   fast_geometry: bool = False, body_vert=None, ob_vert=None,
                   ob_vrad=None, vertical: bool = False, ngrid=None,
                   ob_row_factor=None, apply_rows=None, point_geo=None):
    """One block's operands, as ``apply_obs_block_pallas`` :176-245 builds
    them: ``(vt, w, table [VT, B] or None, ggt [B, B])``, ``ggt`` from
    B4e's ``apply_rows [B, M]`` where given.  ``w`` is the weights ``[B,
    G]``, or None (unlocalized), or, where the caller gives the grid's
    ``point_geo`` (:func:`points_for_kernel`), the :class:`Geometry` that
    B4 computes them from.  ``ngrid`` that does not divide the rows means a
    flat state (VT = 1).  ``ob_row_factor [B, rows]`` (flat states only)
    multiplies the weights per (ob, row), as cross-variable localization
    does on the tail rows; it is the weights when nothing else
    localizes."""
    dtype = ye_block.dtype
    g, vt = _grid_of(nrows, ngrid)
    ggt = _gram_tables(ye_block[None], sqrt_coef[None].to(dtype),
                       None if apply_rows is None
                       else apply_rows[None].to(dtype))[0]
    w = table = None
    if localize:
        grid_lat = body_lat[:g].to(dtype)
        grid_lon = body_lon[:g].to(dtype)
        rad = radii.to(dtype)
        if point_geo is not None:
            w = Geometry(point_geo, point_geometry(ob_lat, ob_lon, dtype, rad))
        elif fast_geometry:
            w = grid_weights(latlon_to_unit(grid_lat, grid_lon),
                             latlon_to_unit(ob_lat, ob_lon).to(dtype), rad)
        else:
            d = haversine((ob_lat[:, None].to(dtype), ob_lon[:, None].to(dtype)),
                          (grid_lat[None, :], grid_lon[None, :]))
            w = gaspari_cohn(d, rad[:, None]).to(dtype)
        if vertical and vt > 1:
            group_vert = body_vert.to(dtype).reshape(vt, g)[:, 0]
            table = gaspari_cohn(
                torch.abs(group_vert[:, None] - ob_vert[None, :].to(dtype)),
                ob_vrad[None, :].to(dtype)).to(dtype)
        elif vertical:  # vt == 1: levels vary per row
            w = w * gaspari_cohn(
                torch.abs(ob_vert[:, None].to(dtype)
                          - body_vert.to(dtype)[None, :]),
                ob_vrad[:, None].to(dtype)).to(dtype)
    if ob_row_factor is not None:
        if vt != 1:
            raise ValueError("ob_row_factor needs a flat state (VT = 1)")
        fac = ob_row_factor.to(dtype)
        w = fac if w is None else w * fac
    return vt, w, table, ggt


def apply_obs_block(body_mean, body_perts, body_lat, body_lon, ye_block,
                    gain_coef, sqrt_coef, ob_lat, ob_lon, radii,
                    localize: bool = True, fast_geometry: bool = False,
                    body_vert=None, ob_vert=None, ob_vrad=None,
                    vertical: bool = False, ngrid=None,
                    ob_row_factor=None, donate: bool = False,
                    precision: str = "ieee", apply_rows=None,
                    point_geo=None):
    """Apply one pre-solved obs block to the state body through B4 (the
    counterpart of ``apply_obs_block_pallas``), or through B4e against the
    stochastic EnKF's ``apply_rows [B, M]``; ``ob_row_factor`` and
    ``point_geo`` as in :func:`block_operands`; ``precision``: the mode of
    the two large products."""
    dtype = body_perts.dtype
    y = ye_block.to(dtype)
    z = None if apply_rows is None else apply_rows.to(dtype)
    vt, w, table, ggt = block_operands(
        body_lat, body_lon, y, sqrt_coef, ob_lat, ob_lon, radii,
        body_perts.shape[0], localize=localize, fast_geometry=fast_geometry,
        body_vert=body_vert, ob_vert=ob_vert, ob_vrad=ob_vrad,
        vertical=localize and vertical, ngrid=ngrid,
        ob_row_factor=ob_row_factor, apply_rows=z, point_geo=point_geo)
    coef = torch.stack([gain_coef.to(dtype), sqrt_coef.to(dtype)])
    return block_apply(body_mean.to(dtype), body_perts, w, table, y,
                       ggt.contiguous(), coef, vt, donate=donate,
                       precision=precision, z=z)


def blocked_body(body_mean, body_perts, body_lat, body_lon,
                 tail: TailSolution, obs: ObsArrays, localize: bool = True,
                 block_size: int = 128, fast_geometry: bool = False,
                 body_vert=None, vertical: bool = False, ngrid=None,
                 donate: bool = False, precision: str = "ieee",
                 apply_rows=None, varloc=None, row_var=None, ob_var=None):
    """Phase 2 through B4, one launch per obs block (the counterpart of
    ``ensrf_blocked_body_pallas``).  Same contract as
    ``ensrf_core.ensrf_blocked_body``; ``precision``: the mode of the two
    large products.  ``apply_rows [No, M]``: the stochastic EnKF's
    departure rows, through B4e.  ``varloc``/``row_var``/``ob_var`` (a
    flat state only) enter each block as the factor ``varloc[ob_var_j,
    row_var_r]`` on its weights (:func:`block_operands`'
    ``ob_row_factor``).  Where B4 computes the weights
    (:func:`points_for_kernel`), the grid's geometry is built once for
    every block."""
    nobs = tail.ye.shape[0]
    if nobs == 0:
        return body_mean, body_perts
    dtype = body_perts.dtype
    if varloc is not None:
        ngrid = None
    g, vt = _grid_of(body_perts.shape[0], ngrid)
    pgeo = points_for_kernel(
        body_lat[:g], body_lon[:g], dtype, on_card=body_perts.is_cuda,
        localize=localize, fast_geometry=fast_geometry,
        vertical=localize and vertical, vt=vt, row_factor=varloc is not None)
    nblocks = -(-nobs // block_size)
    pad = nblocks * block_size - nobs
    obs = obs.with_default_verts()
    inf = float("inf")
    ye = _pad(tail.ye.to(dtype), pad)
    gain = _pad(tail.gain_coef.to(dtype), pad)
    sqrtc = _pad(tail.sqrt_coef.to(dtype), pad)
    lat = _pad(obs.lats.to(dtype), pad)
    lon = _pad(obs.lons.to(dtype), pad)
    radii = _pad(obs.radii.to(dtype), pad, inf)
    overt = _pad(obs.verts.to(dtype), pad)
    ovrad = _pad(obs.vert_radii.to(dtype), pad, inf)
    z = None if apply_rows is None else _pad(apply_rows.to(dtype), pad)
    if varloc is not None:
        if row_var is None or ob_var is None:
            raise ValueError("varloc needs row_var and ob_var")
        vl = varloc.to(dtype)
        rvar = row_var.long()
        ovar = _pad(ob_var.long(), pad, 0)
    bm, bp = body_mean, body_perts
    for b in range(nblocks):
        sl = slice(b * block_size, (b + 1) * block_size)
        bm, bp = apply_obs_block(
            bm, bp, body_lat, body_lon, ye[sl], gain[sl], sqrtc[sl], lat[sl],
            lon[sl], radii[sl], localize=localize,
            fast_geometry=fast_geometry, body_vert=body_vert,
            ob_vert=overt[sl], ob_vrad=ovrad[sl], vertical=vertical,
            ngrid=ngrid,
            ob_row_factor=(None if varloc is None
                           else vl[ovar[sl]][:, rvar]),
            donate=donate or b > 0, precision=precision,
            apply_rows=None if z is None else z[sl], point_geo=pgeo)
    return bm, bp
