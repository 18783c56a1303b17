"""Observation preprocessing: superobbing, distance thinning, spatial order.

Counterpart of ``efa_xray_tpu/observation/thinning.py``: ``superob`` :67,
``thin_by_distance`` :149, ``_morton3d_np`` :207 and ``sort_spatially``
:275, host-side NumPy on the port's
:class:`~efa_xray_tpu_torch.observation.observation.ObservationBatch`,
giving the JAX package's outputs on the same batches.  The Hilbert key
(``_hilbert3d_np`` :236 there) is
:func:`efa_xray_tpu_torch.observation.localization.hilbert3d_np`.

* :func:`superob` averages the obs of one obtype inside each lat/lon cell
  into one precision-weighted superobservation (combined error variance
  ``1 / sum(1/R_i)``, exact for independent errors);
* :func:`thin_by_distance` keeps a subset with pairwise great-circle
  separation >= ``min_km``, preferring lower-error obs (greedy on a 3-D
  cell hash: O(n) for uniform networks);
* :func:`sort_spatially` puts the obs in spherical Hilbert order.

Observations with a custom forward operator, or flagged
``assimilate_this=False``, pass through untouched.
"""

from __future__ import annotations

import numpy as np

from efa_xray_tpu_torch.observation.localization import EARTH_RADIUS_KM
from efa_xray_tpu_torch.observation.observation import ObservationBatch


def _passthrough_mask(batch: ObservationBatch) -> np.ndarray:
    """Obs that must never be merged/dropped: custom-H or QC'd-off."""
    return np.asarray(batch.custom_operator, bool) | ~np.asarray(
        batch.assimilate_flags, bool
    )


def _subset(batch: ObservationBatch, idx: np.ndarray) -> dict:
    return dict(
        values=np.asarray(batch.values, float)[idx],
        errors=np.asarray(batch.errors, float)[idx],
        lats=np.asarray(batch.lats, float)[idx],
        lons=np.asarray(batch.lons, float)[idx],
        times_s=np.asarray(batch.times_s)[idx],
        obtypes=[batch.obtypes[i] for i in idx],
        localize_radius=np.asarray(batch.localize_radius, float)[idx],
        assimilate_flags=np.asarray(batch.assimilate_flags, bool)[idx],
        verts=np.asarray(batch.verts, float)[idx],
        vert_radius=np.asarray(batch.vert_radius, float)[idx],
        descriptions=[batch.descriptions[i] for i in idx],
        custom_operator=np.asarray(batch.custom_operator, bool)[idx],
    )


def _concat_batches(parts: list) -> ObservationBatch:
    keys = parts[0].keys()
    out = {}
    for k in keys:
        if k in ("obtypes", "descriptions"):
            out[k] = sum((list(p[k]) for p in parts), [])
        else:
            out[k] = np.concatenate([np.asarray(p[k]) for p in parts])
    return ObservationBatch(**out)


def superob(batch: ObservationBatch, cell_deg: float) -> ObservationBatch:
    """Combine obs of the same obtype within each ``cell_deg`` lat/lon cell.

    Per cell: precision-weighted (1/R) means of value, position, time and
    vertical coordinate; combined error variance ``1/sum(1/R_i)``;
    localization radius = the cell minimum (the most conservative member);
    description records the member count.  Order of output: cells in
    first-appearance order, passthrough obs appended unchanged.
    """
    if cell_deg <= 0:
        raise ValueError("cell_deg must be positive")
    n = len(batch)
    if n == 0:
        return batch
    skip = _passthrough_mask(batch)
    work = np.nonzero(~skip)[0]
    if len(work) == 0:
        return batch

    lats = np.asarray(batch.lats, float)[work]
    lons = np.mod(np.asarray(batch.lons, float)[work], 360.0)
    cells = {}
    order = []
    for j, i in enumerate(work):
        key = (
            batch.obtypes[i],
            int(np.floor(lats[j] / cell_deg)),
            int(np.floor(lons[j] / cell_deg)),
        )
        if key not in cells:
            cells[key] = []
            order.append(key)
        cells[key].append(i)

    vals = np.asarray(batch.values, float)
    errs = np.asarray(batch.errors, float)
    blats = np.asarray(batch.lats, float)
    blons = np.asarray(batch.lons, float)
    times = np.asarray(batch.times_s, np.int64)
    radii = np.asarray(batch.localize_radius, float)
    verts = np.asarray(batch.verts, float)
    vrads = np.asarray(batch.vert_radius, float)

    merged = dict(values=[], errors=[], lats=[], lons=[], times_s=[],
                  obtypes=[], localize_radius=[], assimilate_flags=[],
                  verts=[], vert_radius=[], descriptions=[],
                  custom_operator=[])
    for key in order:
        idx = np.asarray(cells[key])
        w = 1.0 / errs[idx]
        wsum = w.sum()
        merged["values"].append(float((vals[idx] * w).sum() / wsum))
        merged["errors"].append(float(1.0 / wsum))
        merged["lats"].append(float((blats[idx] * w).sum() / wsum))
        # circular-safe longitude mean via unit vectors
        lam = np.radians(blons[idx])
        merged["lons"].append(
            float(np.degrees(np.arctan2((np.sin(lam) * w).sum(),
                                        (np.cos(lam) * w).sum())) % 360.0)
        )
        merged["times_s"].append(np.int64((times[idx] * w).sum() / wsum))
        merged["obtypes"].append(key[0])
        merged["localize_radius"].append(float(radii[idx].min()))
        merged["assimilate_flags"].append(True)
        vfin = np.isfinite(verts[idx])
        merged["verts"].append(
            float((verts[idx][vfin] * w[vfin]).sum() / w[vfin].sum())
            if vfin.any() else np.nan
        )
        merged["vert_radius"].append(float(vrads[idx].min()))
        merged["descriptions"].append(f"superob(n={len(idx)})")
        merged["custom_operator"].append(False)

    parts = [
        {k: (v if k in ("obtypes", "descriptions") else np.asarray(v))
         for k, v in merged.items()}
    ]
    if skip.any():
        parts.append(_subset(batch, np.nonzero(skip)[0]))
    return _concat_batches(parts)


def thin_by_distance(batch: ObservationBatch, min_km: float) -> ObservationBatch:
    """Greedy thinning: keep a subset whose pairwise great-circle distance
    is >= ``min_km``, visiting obs in ascending error order (the most
    accurate ob in a cluster wins).  Cell hashing keeps this O(n) for
    uniformly dense networks.  Passthrough obs (custom H / QC'd-off) are
    always kept and do not block others.
    """
    if min_km <= 0:
        raise ValueError("min_km must be positive")
    n = len(batch)
    if n == 0:
        return batch
    skip = _passthrough_mask(batch)
    work = np.nonzero(~skip)[0]
    if len(work) == 0:
        return batch

    lat = np.radians(np.asarray(batch.lats, float))
    lon = np.radians(np.asarray(batch.lons, float))
    xyz = np.stack(
        [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)],
        axis=1,
    )
    # chordal threshold equivalent to the great-circle min_km
    chord = 2.0 * np.sin(min(min_km / (2.0 * EARTH_RADIUS_KM), np.pi / 2))
    chord2 = chord**2

    # 3-D cell hash on the unit sphere (pole- and dateline-safe: a lat/lon
    # hash misses neighbors near the poles where lon cells shrink).  Cube
    # cells of side = chord guarantee any pair closer than chord shares a
    # 3x3x3 neighborhood.
    cells3 = np.floor(xyz / chord).astype(np.int64)
    errs = np.asarray(batch.errors, float)
    kept: list = []
    grid: dict = {}

    for i in work[np.argsort(errs[work], kind="stable")]:
        kx, ky, kz = cells3[i]
        ok = True
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    for j in grid.get((kx + dx, ky + dy, kz + dz), ()):
                        if ((xyz[i] - xyz[j]) ** 2).sum() < chord2:
                            ok = False
                            break
                    if not ok:
                        break
                if not ok:
                    break
            if not ok:
                break
        if ok:
            kept.append(i)
            grid.setdefault((kx, ky, kz), []).append(i)

    keep_idx = np.sort(np.concatenate([np.asarray(kept, int),
                                       np.nonzero(skip)[0]]).astype(int))
    return ObservationBatch(**_subset(batch, keep_idx))


def _morton3d_np(lats, lons, bits: int = 10) -> np.ndarray:
    """NumPy twin of ``localization.morton3d_keys`` on (lat, lon) degrees."""
    phi = np.radians(np.asarray(lats, float))
    lam = np.radians(np.asarray(lons, float))
    xyz = np.stack(
        [np.cos(phi) * np.cos(lam), np.cos(phi) * np.sin(lam), np.sin(phi)],
        axis=-1,
    )
    scale = (1 << bits) - 1
    q = np.clip((xyz + 1.0) * 0.5 * scale, 0, scale).astype(np.uint32)

    def spread(v):
        v = v & np.uint32(0x3FF)
        v = (v | (v << 16)) & np.uint32(0xFF0000FF)
        v = (v | (v << 8)) & np.uint32(0x0F00F00F)
        v = (v | (v << 4)) & np.uint32(0xC30C30C3)
        v = (v | (v << 2)) & np.uint32(0x49249249)
        return v

    return (
        spread(q[..., 0])
        | (spread(q[..., 1]) << np.uint32(1))
        | (spread(q[..., 2]) << np.uint32(2))
    )


def sort_spatially(batch: ObservationBatch) -> ObservationBatch:
    """Reorder observations into spherical Hilbert-curve order.

    Observation ORDER is part of the serial EnSRF's definition — the
    reference itself assimilates in arbitrary order and even shuffles it
    (``efa_demo.ipynb`` cell 11) — so this picks one valid order, the one
    that maximizes localization sparsity: consecutive obs become spatially
    adjacent, so the fused kernel's (row-tile, obs-panel) culling
    (``FilterConfig.cull`` + ``FilterConfig.spatial_sort``) can skip most
    of the provably-zero-weight work.  Without localization the analysis
    mean is order-independent (in exact arithmetic), making the sort free.

    Equivalent to ``batch.spatial_sort()[0]`` (which also returns the
    permutation, for inverting diagnostics) and to the zero-API-change
    form ``FilterConfig(obs_order="hilbert")``.
    """
    return batch.spatial_sort()[0]
