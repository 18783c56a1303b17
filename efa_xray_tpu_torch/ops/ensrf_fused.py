"""B2: the fused EnSRF body, every obs block applied while a row tile stays
on chip.

Counterpart of ``efa_xray_tpu/ops/ensrf_pallas_fused.py``: the polynomial
forms ``_asin2_poly_u`` :42, ``_arccos_poly`` :70, ``_gc_poly`` :86, the
kernel ``_make_fused_kernel`` :117-416 with its hybrid static-column
branch (B2h: :208-219, :288-297, :350-362, :393-400), ``cull_masks`` :425
and ``_fused_impl`` :493.

:func:`fused_body` prepares the kernel operands as ``_fused_impl`` does (the
per-block Gram tables, the per-ob table, the cull bits), then
:func:`fused_apply` launches the CUDA kernel of
``efa_xray_tpu_torch/csrc/ensrf_fused.cu`` on CUDA tensors, or runs
:func:`fused_apply_plain`, the same computation in plain torch, on CPU
tensors.  Weights are per row, which is exact for flat states and for
gridded (vt > 1) states alike.

Hybrid mode (``hybrid=True``) adds each ob's static column
``s_j = sigma_row GC(d_j / static_length)`` at the kernel's chordal
angle: the mean accumulates ``gain_j u_j + sgain_j s_j`` while the
columns solve, the stored columns are ``v_j = sqrt_coef_j u_j + ssqrt_j
s_j`` against the raw Gram matrix, and ``X -= V^T Y``.

B2e, the stochastic EnKF's instantiation (``apply_rows``, fp32), applies
the solved columns against the departure rows ``z = ye - eps``: ``D0 = X
Y^T`` as before, ``ggt[j, i] = (z_i . y_j) g_i`` and ``X -= (g o U)^T Z``
(``ensrf_core.apply_obs_block(apply_rows=z)``, which the JAX package runs
in plain XLA).  Its tile and cull bits are B2's.

Any ensemble and any block run (:func:`plan`): where a CTA's layout, a
row tile of X and the block's rows ``[tile + block, M]``, does not fit its
shared memory, the kernel sweeps sub-blocks of the block in order
(:func:`sub_blocks`; exact, as a smaller block is), or, where no
sub-block of 32 obs fits either, stages the members a slice at a time
(D0 summed over the slices).  Every shape whose layout fits runs as it
always did.  The cull bits stay those of the block the caller set.

``precision`` (:mod:`efa_xray_tpu_torch.ops.precision`) is the mode of the
two large products, D0 = X Y^T and the apply: ``"ieee"`` (fp32), or
``"tf32"`` / ``"bf16"``, where the kernel runs them on the tensor cores and
the plain version rounds the same operands (X and Y in D0; ``g o U``, or V,
and Y in the apply) before an fp32 product, as the JAX kernel's
``mxu_bf16`` casts do (``ensrf_pallas_fused.py:191-205``, :392-412).  The
mean update and everything else stay fp32.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from efa_xray_tpu_torch.assimilation.ensrf_core import (
    ObsArrays,
    TailSolution,
    _pad,
    sigma_rows,
)
from efa_xray_tpu_torch.observation.localization import (
    EARTH_RADIUS_KM,
    _arccos_as,
    latlon_to_unit,
)
from efa_xray_tpu_torch.ops import _build
from efa_xray_tpu_torch.ops import precision as prec
from efa_xray_tpu_torch.ops.precision import MODES, round_inputs
from efa_xray_tpu_torch.utils import profiling

PANEL = 8
# Rows of the per-ob table handed to the kernel (csrc/ensrf_fused.cu kTab);
# hybrid mode appends HYBRID_ROWS.
TABLE_ROWS = ("gain", "sqrt_coef", "ox", "oy", "oz", "invrad", "overt",
              "invvrad")
HYBRID_ROWS = ("sgain", "ssqrt", "invslen")
# Largest dynamic shared memory a CTA may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232448
# What a CTA may use when two are to share an SM: half of the SM's 228 KB,
# less the 1 KB the system keeps for each CTA.
TWO_CTA_SMEM_BYTES = 233472 // 2 - 1024
# Threads of a CTA (csrc/ensrf_fused.cu kThreads).
THREADS = 256
# Where a whole block does not fit a CTA: the sub-blocks the plan tries,
# in order (whole panels, so that a block's cull bits split between them),
# the block a member-sliced launch sweeps, and the unit of a member slice
# (whole bf16 k-steps: csrc/ensrf_fused.cu launch).  Measured on the card
# (PERF.md section 6, ``chip_smoke.lever_steps_phase``): sub-blocks of 64
# obs took B2 and B4 1.4-1.9x less time than sub-blocks of 256, and
# 1.1-1.6x less than 128, at 30 and 80 members (a sub-block's
# substitution is B^2 / 2 against its 2 B M products), and 1.1-1.3x less
# than 32 at 300 and 512 members; where 32 obs do not hold every member,
# slices in blocks of 128 matched or beat blocks of 64 (1024 members).
SUB_BLOCKS = (64, 32)
SLICED_BLOCK = 128
SLICE_UNIT = 32
# The series angle form is valid while every angle the kernel evaluates
# stays within 90 degrees: GC supports of 2 x 5000 km at most.
SERIES_MAX_RADIUS_KM = 5000.0
# The angle forms the kernel takes (its ``series`` argument): the
# half-angle arccos, the series, and B2e's chordal form (the polynomial
# arccos of the dot, as ``localization.chordal_gc_weights``).
ARCCOS_FORM, SERIES_FORM, CHORDAL_FORM = 0, 1, 2

# Launches of the CUDA kernel (not of the plain version): pure-ensemble
# B2, and its hybrid instantiation B2h; and each of them by product mode.
launches = 0
hybrid_launches = 0
launches_by_mode = {k: dict.fromkeys(MODES, 0) for k in ("B2", "B2h")}
# Launches of B2e (fp32 only).
enkf_launches = 0
# Guards the counters against launches from several threads.
_count_lock = threading.Lock()

_ASIN2 = (-0.0963332506, 0.1146914397, 0.0793335722, 0.1508451291,
          0.3333070474, 2.0000001309)
_ARCCOS = (0.0066700901, -0.0170881256, 0.0308918810, -0.0501743046,
           0.0889789874, -0.2145988016, 1.5707963050)
_GC_OUTER = (-0.0484752690, 0.1405191778, 0.0386425652, -0.3682243569,
             0.3440689601, -0.1255802356, 0.0164935268)


def _asin2_poly_u(u):
    """``2 asin(s) / s`` as a polynomial in ``u = s^2`` (s <= 0.71)."""
    p = torch.full_like(u, 0.1920979908)
    for c in _ASIN2:
        p = p * u + c
    return p


def _arccos_poly(x):
    """A&S 4.4.46 arccos for x in [0, 1]."""
    p = torch.full_like(x, -0.0012624911)
    for c in _ARCCOS:
        p = p * x + c
    return torch.sqrt(torch.clamp(1.0 - x, min=0.0)) * p


def _gc_poly(r, outer_form: str = "exact"):
    inner = ((((-0.25 * r + 0.5) * r + 0.625) * r - 5.0 / 3.0) * r**2) + 1.0
    if outer_form == "poly":
        t = r - 1.5
        outer = torch.full_like(r, 0.0332721029)
        for c in _GC_OUTER:
            outer = outer * t + c
    else:
        r_safe = torch.clamp(r, min=1e-12)
        outer = (((((r / 12.0 - 0.5) * r + 0.625) * r + 5.0 / 3.0) * r - 5.0)
                 * r + 4.0 - 2.0 / (3.0 * r_safe))
    zero = torch.zeros_like(r)
    return torch.where(r <= 1.0, inner, torch.where(r < 2.0, outer, zero))


def smem_bytes(tile: int, block_size: int, nmems: int,
               hybrid: bool = False, precision: str = "ieee") -> int:
    """Shared memory of one CTA (mirrors ``make_layout`` in
    ``csrc/ensrf_fused.cu``, and ``make_mode_layout`` for the tensor-core
    modes ``precision``)."""
    t, b, m = tile, block_size, nmems
    ys = 4 * (-(-m // 4) | 1)        # row stride of X and Y: 4 x odd words
    bp = -(-b // PANEL) * PANEL      # obs rounded up to whole panels
    ntab = len(TABLE_ROWS) + (len(HYBRID_ROWS) if hybrid else 0)
    round4 = lambda x: (x + 3) & ~3
    us = prec.u_stride(precision, t)  # row stride of U
    if precision != "ieee":
        ys = prec.mode_row_stride(precision, m)
    return 4 * (t * ys                           # X
            + bp * ys + bp // 2                  # Y, panels skewed
            + bp * us                            # d0 / u columns
            + 16 * THREADS                       # partial corrections
            + 2 * PANEL * bp                     # ring of ggt panel rows
            + PANEL * t * (2 if hybrid else 1)   # weights (, static columns)
            + round4(ntab * b)                   # per-ob table
            + (5 if hybrid else 4) * t           # row geometry (, sigma)
            + 2 * t                              # mean, its increment
            + round4(2 * (bp // PANEL)))         # alive-panel lists


def pick_tile(block_size: int, nmems: int, hybrid: bool = False,
              precision: str = "ieee") -> int:
    """Rows per CTA in product mode ``precision``: 32 where two such CTAs
    fit an SM (measured faster than one CTA of 64 rows: two CTAs hide
    each other's waits and the cull is finer); else 64, or 32 when 64
    would overflow shared memory.  The cull bits are computed at this
    tile."""
    smem = lambda t: smem_bytes(t, block_size, nmems, hybrid, precision)
    if smem(32) <= TWO_CTA_SMEM_BYTES:
        return 32
    return 64 if smem(64) <= MAX_SMEM_BYTES else 32


class Plan(NamedTuple):
    """How one launch stages its operands: ``tile`` rows a CTA, blocks of
    ``sub`` obs swept in order (the caller's block, or sub-blocks of it),
    ``mslice`` members staged at a time (all of them: unsliced)."""
    tile: int
    sub: int
    mslice: int


def plan(block_size: int, nmems: int, hybrid: bool = False,
         precision: str = "ieee", tile=None) -> Plan:
    """B2's :class:`Plan` at ``tile`` rows (:func:`pick_tile`'s when
    None): :func:`staging_plan` of its layout."""
    return staging_plan(
        lambda t, b, m: smem_bytes(t, b, m, hybrid, precision),
        lambda b: pick_tile(b, nmems, hybrid, precision), block_size, nmems,
        tile)


def staging_plan(smem, pick, block_size: int, nmems: int,
                 tile=None) -> Plan:
    """A body kernel's :class:`Plan` at ``tile`` (``pick(block)`` when
    None; ``smem(tile, block, members)`` the bytes of a CTA): the whole
    block with every member where that layout fits (the tile, layout and
    launch of every shape the kernel always took); else the first of
    ``SUB_BLOCKS`` below the block that fits with every member; else
    blocks of at most ``SLICED_BLOCK`` obs and the widest slice of
    ``SLICE_UNIT`` members that fits."""
    t = 32 if tile is None else tile
    fits = lambda b, m: smem(t, b, m) <= MAX_SMEM_BYTES
    if tile is not None:
        pick = lambda b: tile
    if fits(block_size, nmems):
        return Plan(pick(block_size), block_size, nmems)
    for sub in SUB_BLOCKS:
        if sub < block_size and fits(sub, nmems):
            return Plan(pick(sub), sub, nmems)
    sub = min(block_size, SLICED_BLOCK)
    m = SLICE_UNIT
    while m + SLICE_UNIT < nmems and fits(sub, m + SLICE_UNIT):
        m += SLICE_UNIT
    return Plan(t, sub, m)


def sub_blocks(y_b, ggt_b, tab_b, bits, z_b, sub: int):
    """Blocks of ``B`` obs (``y_b [nb, B, M]``, ``ggt_b [nb, B, B]``,
    ``tab_b [nb, ntab, B]``, ``bits [gtiles, nb]`` or None, ``z_b`` or
    None) as blocks of ``sub`` obs, swept in the same order: each block
    padded to whole sub-blocks with zero obs (exact no-ops), the Gram
    tables' diagonal blocks, and sub-block ``i``'s cull word the bits of
    its panels in the block's word (``sub`` a multiple of the panel)."""
    nb, bsz, _ = y_b.shape
    if sub >= bsz:
        return y_b, ggt_b, tab_b, bits, z_b
    k = -(-bsz // sub)
    pad = k * sub - bsz
    pad_obs = lambda t: torch.nn.functional.pad(t, (0, 0, 0, pad))
    rows = lambda t: pad_obs(t).reshape(nb * k, sub, t.shape[-1])
    if bits is not None:
        per = sub // PANEL
        word = bits.to(torch.int64) & 0xFFFFFFFF
        shifts = torch.arange(k, device=bits.device) * per
        parts = (word[:, :, None] >> shifts) & ((1 << per) - 1)
        parts = torch.where(parts >= 2**31, parts - 2**32, parts)
        bits = parts.reshape(bits.shape[0], nb * k).to(torch.int32)
    return (rows(y_b).contiguous(), diagonal_blocks(ggt_b, sub),
            per_ob_blocks(tab_b, sub), bits,
            None if z_b is None else rows(z_b).contiguous())


def diagonal_blocks(ggt_b, sub: int):
    """``[nb, B, B]`` tables as the ``[nb k, sub, sub]`` blocks on their
    diagonals, ``B`` padded with zeros to ``k`` whole sub-blocks."""
    nb, bsz, _ = ggt_b.shape
    k = -(-bsz // sub)
    pad = k * sub - bsz
    g = torch.nn.functional.pad(ggt_b, (0, pad, 0, pad)).reshape(
        nb, k, sub, k, sub)
    g = torch.diagonal(g, dim1=1, dim2=3).permute(0, 3, 1, 2)
    return g.reshape(nb * k, sub, sub).contiguous()


def per_ob_blocks(tab_b, sub: int):
    """``[nb, rows, B]`` per-ob rows as ``[nb k, rows, sub]``, ``B`` padded
    with zeros to ``k`` whole sub-blocks."""
    nb, nrow, bsz = tab_b.shape
    k = -(-bsz // sub)
    tab = torch.nn.functional.pad(tab_b, (0, k * sub - bsz))
    return tab.reshape(nb, nrow, k, sub).transpose(1, 2).reshape(
        nb * k, nrow, sub).contiguous()


def series_form(max_radius_km, static_length=None) -> bool:
    """Whether the cheaper series angle form is exact enough: every finite
    localization radius, and in hybrid mode the static length, at most
    5000 km.  The JAX package looks at the radii alone, so a static
    length above 5000 km evaluates its series outside the range it was
    fitted on (ROADMAP queue C)."""
    return (max_radius_km is not None
            and float(max_radius_km) <= SERIES_MAX_RADIUS_KM
            and (static_length is None
                 or float(static_length) <= SERIES_MAX_RADIUS_KM))


# Culling-bound slack (rad): covers f32 arccos conditioning in the bound
# against the kernel's polynomial angle (``ensrf_pallas_fused.py:422``).
_CULL_MARGIN_RAD = 2e-3
# Obs x tiles evaluated at once by the cull bound (bounds its memory).
_CULL_CHUNK_ELEMS = 1 << 26


def _tile_caps(body_xyz, tile):
    """Per row tile: the cap centre [gtiles, 3] and angular radius."""
    nrows = body_xyz.shape[0]
    gtiles = max(1, -(-nrows // tile))
    rpad = gtiles * tile - nrows
    if rpad:
        body_xyz = torch.cat([body_xyz, body_xyz[-1:].expand(rpad, 3)])
    txyz = body_xyz.reshape(gtiles, tile, 3)
    csum = torch.sum(txyz, dim=1)
    cnorm = torch.sqrt(torch.sum(csum * csum, dim=1, keepdim=True))
    # Made on the device (a copy from the host would wait on it).
    fallback = torch.eye(3, dtype=body_xyz.dtype, device=body_xyz.device)[0]
    center = torch.where(cnorm > 1e-6, csum / torch.clamp(cnorm, min=1e-6),
                         fallback[None, :])
    cosmin = torch.einsum("gtc,gc->gt", txyz, center).amin(dim=1)
    cap = torch.arccos(torch.clamp(cosmin, -1.0, 1.0))
    return center, cap


def _alive_panels(ob_xyz, radii, assim, center, cap, nblocks, block_size,
                  panel):
    """``[g, nblocks, npanels]`` bool: panel may hold a nonzero weight."""
    nobs = ob_xyz.shape[0]
    g = center.shape[0]
    ang = torch.arccos(torch.clamp(ob_xyz @ center.T, -1.0, 1.0))
    support = 2.0 * torch.abs(radii) / EARTH_RADIUS_KM
    alive = ang <= cap[None, :] + support[:, None] + _CULL_MARGIN_RAD
    alive = alive & assim[:, None]
    npanels = -(-block_size // panel)
    # obs padded to the block grid, each block padded to the panel grid
    full = torch.zeros((nblocks, npanels * panel, g), dtype=torch.bool,
                       device=alive.device)
    blocks = torch.zeros((nblocks * block_size, g), dtype=torch.bool,
                         device=alive.device)
    blocks[:nobs] = alive
    full[:, :block_size] = blocks.reshape(nblocks, block_size, g)
    return full.reshape(nblocks, npanels, panel, g).any(dim=2).permute(2, 0, 1)


def cull_masks(body_xyz, ob_xyz, radii, assim, tile, nblocks, block_size,
               panel: int = PANEL):
    """``(mask [gtiles, nblocks], pmask [gtiles, nblocks, npanels])`` int32:
    1 where a (row tile, obs block) pair, or one 8-ob panel of it, may have
    a nonzero Gaspari-Cohn weight.  Zeros are provably dead and skipped
    exactly (bound: ``ensrf_pallas_fused.cull_masks`` docstring)."""
    center, cap = _tile_caps(body_xyz, tile)
    pm = _alive_panels(ob_xyz, radii, assim, center, cap, nblocks,
                       block_size, panel)
    return pm.any(dim=2).to(torch.int32), pm.to(torch.int32)


def cull_bits(body_xyz, ob_xyz, radii, assim, tile, nblocks, block_size,
              panel: int = PANEL):
    """The kernel's cull control: ``bits [gtiles, nblocks]`` int32 with
    bit q set when panel q may be alive.  Same bound as :func:`cull_masks`,
    evaluated over chunks of tiles so that its ``[nobs, tiles]`` angle
    matrix stays bounded at any state size."""
    center, cap = _tile_caps(body_xyz, tile)
    gtiles = center.shape[0]
    npanels = -(-block_size // panel)
    shifts = torch.arange(npanels, device=center.device, dtype=torch.int64)
    chunk = max(1, _CULL_CHUNK_ELEMS // max(1, nblocks * block_size))
    out = []
    for s in range(0, gtiles, chunk):
        pm = _alive_panels(ob_xyz, radii, assim, center[s:s + chunk],
                           cap[s:s + chunk], nblocks, block_size, panel)
        v = torch.sum(pm.to(torch.int64) << shifts, dim=-1)
        # bit 31 set: wrap to the int32 the kernel reads
        out.append(torch.where(v >= 2**31, v - 2**32, v).to(torch.int32))
    return torch.cat(out)


def _dist_plain(tab, geom, lo, hi, series: int):
    """Distances (km) ``[rows, hi - lo]`` from every row to obs lo..hi-1
    of one block: the kernel's chordal angle forms."""
    ox, oy, oz = (tab[k, lo:hi][None, :] for k in (2, 3, 4))
    bx, by, bz = (geom[k][:, None] for k in range(3))
    dot = torch.clamp(ox * bx + oy * by + oz * bz, -1.0, 1.0)
    if series == CHORDAL_FORM:
        ang = _arccos_as(dot)
    elif series == SERIES_FORM:
        su = (1.0 - dot) * 0.5
        ang = torch.sqrt(su) * _asin2_poly_u(su)
    else:
        ang = 2.0 * _arccos_poly(torch.sqrt(torch.clamp((1.0 + dot) * 0.5,
                                                        0.0, 1.0)))
    return EARTH_RADIUS_KM * ang


def _weights_plain(tab, geom, lo, hi, dist, vertical: bool, series: int):
    """Localization weights ``[rows, hi - lo]`` at ``dist``: the kernel's
    Gaspari-Cohn forms, times the vertical factor."""
    invrad = tab[5, lo:hi][None, :]
    one = torch.ones_like(dist)
    w = torch.where(invrad > 0, _gc_poly(
        dist * invrad, "poly" if series == SERIES_FORM else "exact"), one)
    if vertical:
        ivr = tab[7, lo:hi][None, :]
        rv = torch.abs(geom[3][:, None] - tab[6, lo:hi][None, :]) * ivr
        w = w * torch.where(ivr > 0, _gc_poly(rv), one)
    return w


def fused_apply_plain(bm, bp, geom, y_b, ggt_b, tab_b, bits, tile: int,
                      localize: bool, vertical: bool, series: bool,
                      hybrid: bool = False, precision: str = "ieee",
                      operands: list | None = None, z_b=None, sub=None,
                      mslice=None):
    """Plain-torch B2 (B2h with ``hybrid``, B2e with the apply rows
    ``z_b``) on prepared operands; returns ``(bm, bp)``.  In hybrid mode
    ``u`` holds the V columns.  The two large products round their
    operands as mode ``precision`` does.  A list ``operands`` receives each
    (sub-)block's apply operands before rounding: ``(g o U or V [rows, B],
    Y (B2e: Z) [B, M])``.  ``sub``/``mslice`` (:func:`plan`'s at ``tile``
    when None) are the kernel's order: sub-blocks swept in turn, D0 summed
    over slices of ``mslice`` members."""
    rnd = lambda x: round_inputs(x, precision)
    nrows, nmems = bp.shape
    if sub is None or mslice is None:
        _, sub, mslice = plan(y_b.shape[1], nmems, hybrid, precision, tile)
    y_b, ggt_b, tab_b, bits, z_b = sub_blocks(y_b, ggt_b, tab_b, bits, z_b,
                                              sub)
    nblocks, bsz, _ = y_b.shape
    if bits is not None:
        row_tile = torch.arange(nrows, device=bp.device) // tile
    for b in range(nblocks):
        y = y_b[b]
        tab = tab_b[b]
        d0 = rnd(bp) @ rnd(y).T if mslice >= nmems else sum(
            rnd(bp[:, m0:m0 + mslice]) @ rnd(y[:, m0:m0 + mslice]).T
            for m0 in range(0, nmems, mslice))
        u = torch.zeros_like(d0)
        if hybrid:
            mean = torch.zeros_like(bm)
        bw = bits[row_tile, b].to(torch.int64) if bits is not None else None
        for base in range(0, bsz, PANEL):
            width = min(PANEL, bsz - base)
            alive = (((bw >> (base // PANEL)) & 1) != 0
                     if bw is not None else None)
            d_panel = d0[:, base:base + width]
            if base > 0:
                d_panel = d_panel - u[:, :base] @ ggt_b[b, base:base + width,
                                                       :base].T
            if localize or hybrid:
                dist = _dist_plain(tab, geom, base, base + width, series)
            if localize:
                w_panel = _weights_plain(tab, geom, base, base + width, dist,
                                         vertical, series)
            if hybrid:
                s_panel = geom[4][:, None] * _gc_poly(
                    dist * tab[10, base:base + width][None, :])
            for t in range(width):
                j = base + t
                d_j = d_panel[:, t]
                if t > 0:
                    d_j = d_j - u[:, base:j] @ ggt_b[b, j, base:j]
                if localize:
                    d_j = d_j * w_panel[:, t]
                if hybrid:
                    s_j = s_panel[:, t]
                    if alive is not None:
                        zero = torch.zeros_like(d_j)
                        d_j = torch.where(alive, d_j, zero)
                        s_j = torch.where(alive, s_j, zero)
                    mean = mean + tab[0, j] * d_j + tab[8, j] * s_j
                    d_j = tab[1, j] * d_j + tab[9, j] * s_j
                elif alive is not None:
                    d_j = torch.where(alive, d_j, torch.zeros_like(d_j))
                u[:, j] = d_j
        if hybrid:
            bm = bm + mean
            left = u
        else:
            bm = bm + u @ tab[0]
            left = u * tab[1][None, :]
        right = y if z_b is None else z_b[b]
        if operands is not None:
            operands.append((left, right))
        bp = bp - rnd(left) @ rnd(right)
    return bm, bp


def fused_apply_cuda(bm, bp, geom, y_b, ggt_b, tab_b, bits, tile: int,
                     localize: bool, vertical: bool, series: bool,
                     hybrid: bool = False, donate: bool = False,
                     precision: str = "ieee", z_b=None):
    """Launch B2 (B2h with ``hybrid``, B2e with ``z_b``) on CUDA float32
    tensors, its two large products in mode ``precision``, staged as
    :func:`plan` says at ``tile``.
    ``donate=True`` updates ``bm``/``bp`` in place (the JAX package donates
    these buffers)."""
    if precision not in MODES:
        raise ValueError(f"unknown mode {precision!r}; expected one of "
                         f"{MODES}")
    if z_b is not None and (hybrid or precision != "ieee"):
        raise ValueError("B2e (apply rows) runs pure-ensemble fp32 only")
    nrows, nmems = bp.shape
    nblocks, bsz, _ = y_b.shape
    dev = bp.device
    f32 = torch.float32
    for t in (bm, bp, geom, y_b, ggt_b, tab_b, z_b):
        if t is not None and (t.device != dev or t.dtype != f32):
            raise ValueError("B2 takes float32 tensors on one CUDA device")
    ntab = len(TABLE_ROWS) + (len(HYBRID_ROWS) if hybrid else 0)
    if (bm.shape != (nrows,) or geom.shape != (5 if hybrid else 4, nrows)
            or y_b.shape != (nblocks, bsz, nmems)
            or ggt_b.shape != (nblocks, bsz, bsz)
            or tab_b.shape != (nblocks, ntab, bsz)
            or (z_b is not None and z_b.shape != y_b.shape)):
        raise ValueError("B2 operand shapes disagree")
    gtiles = -(-nrows // tile)
    if bits is not None and (bits.device != dev or bits.dtype != torch.int32
                             or bits.shape != (gtiles, nblocks)):
        raise ValueError("B2 cull bits must be int32 [gtiles, nblocks]")
    if tile not in (32, 64):
        raise ValueError(f"B2 takes a tile of 32 or 64 rows, not {tile}")
    _, sub, mslice = plan(bsz, nmems, hybrid, precision, tile)
    y_b, ggt_b, tab_b, bits, z_b = sub_blocks(y_b, ggt_b, tab_b, bits, z_b,
                                              sub)
    nblocks, bsz, _ = y_b.shape
    if donate and bm.is_contiguous() and bp.is_contiguous():
        out_m, out_p = bm, bp
    else:
        out_m = torch.empty(nrows, dtype=f32, device=dev)
        out_p = torch.empty((nrows, nmems), dtype=f32, device=dev)
    if precision != "ieee":  # Y rounded once for every CTA
        y_b = prec.staged_y(y_b, precision)
    ins = [t.contiguous() for t in (bm, bp, geom, y_b, ggt_b, tab_b)]
    cbits = bits.contiguous() if bits is not None else None
    # The C entry sets its attributes on, and launches onto, the current
    # device: make it the tensors' one.
    with torch.cuda.device(dev):
        err = _build.lib().efa_fused_launch(
            *(t.data_ptr() for t in ins[:4]),
            None if z_b is None else z_b.contiguous().data_ptr(),
            *(t.data_ptr() for t in ins[4:]),
            None if cbits is None else cbits.data_ptr(),
            nrows, nmems, mslice, bsz, nblocks, tile, int(localize),
            int(vertical), int(series), int(hybrid), MODES.index(precision),
            out_m.data_ptr(), out_p.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if z_b is not None:
        _build.check(err, "B2e ensrf_fused launch")
        _count_enkf()
        return out_m, out_p
    _build.check(err, f"B2 ensrf_fused launch ({precision})")
    _count(hybrid, precision)
    return out_m, out_p


def _count(hybrid: bool, precision: str) -> None:
    """One launch of B2 (B2h with ``hybrid``) in mode ``precision``."""
    global launches, hybrid_launches
    with _count_lock:
        if hybrid:
            hybrid_launches += 1
        else:
            launches += 1
        launches_by_mode["B2h" if hybrid else "B2"][precision] += 1


def _count_enkf() -> None:
    """One launch of B2e."""
    global enkf_launches
    with _count_lock:
        enkf_launches += 1


def fused_apply(bm, bp, geom, y_b, ggt_b, tab_b, bits, tile: int,
                localize: bool, vertical: bool, series: bool,
                hybrid: bool = False, donate: bool = False,
                precision: str = "ieee", z_b=None):
    """B2 dispatch: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors, both in :func:`plan`'s order at ``tile``."""
    if bp.is_cuda:
        return fused_apply_cuda(bm, bp, geom, y_b, ggt_b, tab_b, bits, tile,
                                localize, vertical, series, hybrid, donate,
                                precision, z_b=z_b)
    if bp.device.type != "cpu":
        raise ValueError(f"B2 runs on CUDA or CPU, not {bp.device}")
    return fused_apply_plain(bm, bp, geom, y_b, ggt_b, tab_b, bits, tile,
                             localize, vertical, series, hybrid, precision,
                             z_b=z_b)


@profiling.spanned(profiling.OPS_PREPARE)
def prepare(body_perts, body_lat, body_lon, tail: TailSolution,
            obs: ObsArrays, body_vert=None, localize: bool = True,
            block_size: int = 128, cull: bool = True, max_radius_km=None,
            hybrid: bool = False, body_sigma=None, static_length=None,
            precision: str = "ieee", apply_rows=None):
    """Kernel operands for :func:`fused_apply`, as ``_fused_impl``
    :564-704 builds them: a dict of ``geom, y_b, ggt_b, tab_b, bits, tile,
    series, z_b``, the tile (and the cull bits) that of product mode
    ``precision``.  ``apply_rows [No, M]`` (B2e) are padded into ``z_b``
    and the Gram tables built from them (``(z_i . y_j) g_i``); ``z_b`` is
    None otherwise.  Hybrid mode (a hybrid ``tail``, ``body_sigma`` scalar or
    per row, ``static_length`` km) passes the raw Gram matrix, three more
    table rows (``sgain``, ``ssqrt``, ``1/static_length``), the sigma row
    as a fifth geometry row, and culls at ``max(radius, static_length)``
    so that no live static column is skipped."""
    if hybrid and (body_sigma is None or static_length is None
                   or tail.static_gain is None):
        raise ValueError("B2h needs body_sigma, static_length and a "
                         "hybrid-mode TailSolution")
    if hybrid and apply_rows is not None:
        raise ValueError("apply_rows (B2e) does not combine with hybrid "
                         "covariance")
    dtype = body_perts.dtype
    nrows, nmems = body_perts.shape
    nobs = tail.ye.shape[0]
    bsz = block_size
    nblocks = max(1, -(-nobs // bsz))
    pad = nblocks * bsz - nobs
    obs = obs.with_default_verts()
    inf = float("inf")
    ye = _pad(tail.ye.to(dtype), pad)
    gain = _pad(tail.gain_coef.to(dtype), pad)
    sqrtc = _pad(tail.sqrt_coef.to(dtype), pad)
    radii = _pad(obs.radii.to(dtype), pad, inf)
    ob_xyz_raw = latlon_to_unit(obs.lats, obs.lons).to(dtype)
    ob_xyz = _pad(ob_xyz_raw, pad)
    overt = _pad(obs.verts.to(dtype), pad)
    ovrad = _pad(obs.vert_radii.to(dtype), pad, inf)

    y_b = ye.reshape(nblocks, bsz, nmems)
    z_b = (None if apply_rows is None else
           _pad(apply_rows.to(dtype), pad).reshape(nblocks, bsz, nmems))
    gram = torch.bmm(y_b if z_b is None else z_b, y_b.transpose(1, 2))
    if hybrid:
        # The corrections run against the stored V columns, which already
        # carry g_j and the static term: the raw Gram matrix.
        ggt_b = gram.transpose(1, 2)
    else:
        # ggt[blk, j, i] = (y_i . y_j) g_i
        ggt_b = (gram * sqrtc.reshape(nblocks, bsz)[:, :, None]).transpose(
            1, 2)
    zero = torch.zeros_like(radii)
    invrad = torch.where(torch.isinf(radii), zero, 1.0 / torch.abs(radii))
    invvrad = torch.where(torch.isinf(ovrad), zero, 1.0 / torch.abs(ovrad))
    rows = [gain, sqrtc, ob_xyz[:, 0], ob_xyz[:, 1], ob_xyz[:, 2], invrad,
            overt, invvrad]
    if hybrid:
        rows += [_pad(tail.static_gain.to(dtype), pad),
                 _pad(tail.static_sqrt.to(dtype), pad),
                 torch.full_like(gain, 1.0 / float(static_length))]
    tab_b = torch.stack(rows).reshape(len(rows), nblocks, bsz).transpose(0, 1)

    body_xyz = latlon_to_unit(body_lat, body_lon).to(dtype)
    bvert = (torch.zeros(nrows, dtype=dtype, device=body_perts.device)
             if body_vert is None else body_vert.to(dtype))
    geo_rows = [body_xyz[:, 0], body_xyz[:, 1], body_xyz[:, 2], bvert]
    if hybrid:
        geo_rows.append(sigma_rows(body_sigma, bvert))
    geom = torch.stack(geo_rows)

    tile = plan(bsz, nmems, hybrid, precision).tile
    npanels = -(-bsz // PANEL)
    # An int32 holds 32 panel bits (block_size 256); larger blocks run
    # without culling, as in the JAX package.
    bits = None
    if cull and localize and npanels <= 32:
        cull_radii = obs.radii.to(dtype)
        if hybrid:
            # The static column's support ends at 2 x static_length.
            cull_radii = torch.clamp(cull_radii, min=float(static_length))
        bits = cull_bits(body_xyz, ob_xyz_raw, cull_radii, obs.assim,
                         tile, nblocks, bsz)
    series = series_form(max_radius_km, static_length if hybrid else None)
    if apply_rows is not None:
        # B2e evaluates the EnKF body's own chordal weights.
        series = CHORDAL_FORM
    return dict(geom=geom.contiguous(), y_b=y_b.contiguous(),
                ggt_b=ggt_b.contiguous(), tab_b=tab_b.contiguous(),
                bits=bits, tile=tile, series=series,
                z_b=None if z_b is None else z_b.contiguous())


def fused_body(body_mean, body_perts, body_lat, body_lon, tail: TailSolution,
               obs: ObsArrays, body_vert=None, localize: bool = True,
               block_size: int = 128, vertical: bool = False,
               cull: bool = True, max_radius_km=None, hybrid: bool = False,
               body_sigma=None, static_length=None, donate: bool = False,
               row_order=None, inv_order=None, precision: str = "ieee",
               apply_rows=None):
    """Phase 2 through B2 (B2h with ``hybrid``): apply the pre-solved obs
    sequence ``tail`` to the state body.  Drop-in for
    ``ensrf_core.ensrf_blocked_body`` with chordal geometry, the static
    column's included.  ``max_radius_km`` (host-known bound on the finite
    radii) selects the series angle form when it and ``static_length``
    are <= 5000 km.  ``donate=True`` lets the kernel update the caller's
    buffers in place, where the JAX package donates them
    (``ensrf_blocked_body_pallas_fused_donating``).  ``precision``: the
    mode of the two large products (:mod:`~efa_xray_tpu_torch.ops.
    precision`).  ``apply_rows [No, M]``: the stochastic EnKF's departure
    rows, applied through B2e (``ensrf_core.ensrf_blocked_body``'s
    argument of that name; fp32, no hybrid).

    ``row_order`` with its inverse ``inv_order`` permutes the rows before
    the kernel and back after it, as ``_fused_impl`` :643-660 and :776-779
    do for ``spatial_sort``: the update is row-local, so the result is the
    same, and rows in spatial order give the kernel's tiles compact caps
    for the cull.  The kernel then updates the permuted copies, never the
    caller's buffers."""
    if tail.ye.shape[0] == 0:
        return body_mean, body_perts
    if row_order is not None:
        take = lambda x: None if x is None else x[row_order]
        if hybrid:
            body_sigma = sigma_rows(body_sigma,
                                    body_mean.to(body_perts.dtype))
        bm, bp = fused_body(
            take(body_mean), take(body_perts), take(body_lat),
            take(body_lon), tail, obs, body_vert=take(body_vert),
            localize=localize, block_size=block_size, vertical=vertical,
            cull=cull, max_radius_km=max_radius_km, hybrid=hybrid,
            body_sigma=take(body_sigma), static_length=static_length,
            donate=True, precision=precision, apply_rows=apply_rows)
        return bm[inv_order], bp[inv_order]
    ops = prepare(body_perts, body_lat, body_lon, tail, obs,
                  body_vert=body_vert, localize=localize,
                  block_size=block_size, cull=cull,
                  max_radius_km=max_radius_km, hybrid=hybrid,
                  body_sigma=body_sigma, static_length=static_length,
                  precision=precision, apply_rows=apply_rows)
    return fused_apply(body_mean.to(body_perts.dtype), body_perts,
                       ops["geom"], ops["y_b"], ops["ggt_b"], ops["tab_b"],
                       ops["bits"], ops["tile"], localize,
                       localize and vertical, ops["series"], hybrid=hybrid,
                       donate=donate, precision=precision, z_b=ops["z_b"])
