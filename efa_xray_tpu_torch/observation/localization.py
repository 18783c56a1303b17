"""Covariance localization and great-circle geometry on torch tensors.

Counterpart of ``efa_xray_tpu/observation/localization.py``:
``gaspari_cohn`` :27, ``haversine`` :51, ``distance_to_point`` :65,
``pairwise_distance`` :75, ``localization_weights`` :84,
``latlon_to_unit`` :95,
``_arccos_as`` :103, ``chordal_gc_weights`` :122, ``morton3d_keys`` /
``hilbert3d_keys`` :142-198, ``spatial_sort_order`` :216,
``EARTH_RADIUS_KM`` :24 and ``gaspari_cohn_np`` :232; plus the NumPy Hilbert
key of ``efa_xray_tpu/observation/thinning.py:236`` (``_hilbert3d_np``),
which ``ObservationBatch.spatial_sort`` and the benchmark workload use.

Every function keeps the dtype and device of its tensor inputs.  A
``halfwidth`` of ``inf`` gives weights identically 1 (``r = d / inf = 0``).
Space-filling-curve keys are int64 tensors (torch has no general uint32
arithmetic); their values equal the JAX package's uint32 keys.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EARTH_RADIUS_KM = 6371.0


def _as_tensor(x, like=None):
    """A tensor of ``x``: ``like``'s dtype and device when given, else
    NumPy's dtype (Python floats are float64, as in the JAX package with
    x64 on)."""
    if isinstance(x, torch.Tensor):
        return x
    if like is not None:
        if isinstance(x, (int, float)):
            # Filled on the device: a copy from the host would wait on it.
            return torch.full((), x, dtype=like.dtype, device=like.device)
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return torch.from_numpy(np.array(x))


def gaspari_cohn(distances, halfwidth):
    """Gaspari & Cohn (1999) eq. 4.10 compactly supported correlation;
    support vanishes beyond ``2 * |halfwidth|``.  ``halfwidth`` may be a
    tensor broadcastable against ``distances`` or ``inf``."""
    distances = _as_tensor(distances)
    halfwidth = _as_tensor(halfwidth, like=distances)
    r = distances / torch.abs(halfwidth)
    inner = ((((-0.25 * r + 0.5) * r + 0.625) * r - 5.0 / 3.0) * r**2) + 1.0
    r_safe = torch.where(r > 0, r, torch.ones_like(r))
    outer = (
        ((((r / 12.0 - 0.5) * r + 0.625) * r + 5.0 / 3.0) * r - 5.0) * r
        + 4.0
        - 2.0 / (3.0 * r_safe)
    )
    zero = torch.zeros_like(r)
    return torch.where(r <= 1.0, inner, torch.where(r < 2.0, outer, zero))


def haversine(loc1, loc2):
    """Great-circle distance (km) between (lat, lon) pairs in degrees;
    broadcasts elementwise."""
    lat1 = torch.deg2rad(_as_tensor(loc1[0]))
    lat2 = torch.deg2rad(_as_tensor(loc2[0], like=lat1))
    dlat = lat2 - lat1
    dlon = torch.deg2rad(_as_tensor(loc2[1], like=lat1)
                         - _as_tensor(loc1[1], like=lat1))
    a = (torch.sin(dlat / 2.0) ** 2
         + torch.cos(lat1) * torch.cos(lat2) * torch.sin(dlon / 2.0) ** 2)
    c = 2.0 * torch.atan2(torch.sqrt(a), torch.sqrt(1.0 - a))
    return EARTH_RADIUS_KM * c


def distance_to_point(grid_lat, grid_lon, lat, lon):
    """Haversine distance (km) from ``(lat, lon)`` to every grid point;
    broadcasts (batched points with leading dims included)."""
    return haversine((grid_lat, grid_lon), (lat, lon))


def pairwise_distance(lats1, lons1, lats2, lons2):
    """All-pairs haversine distances ``[len(1), len(2)]`` in km."""
    lats1 = _as_tensor(lats1)
    return haversine((lats1[:, None], _as_tensor(lons1, like=lats1)[:, None]),
                     (_as_tensor(lats2, like=lats1)[None, :],
                      _as_tensor(lons2, like=lats1)[None, :]))


def localization_weights(grid_lat, grid_lon, ob_lat, ob_lon, halfwidth):
    """Gaspari-Cohn weights from one ob to a field of points; a
    ``halfwidth`` of ``inf`` gives ones."""
    d = distance_to_point(grid_lat, grid_lon, ob_lat, ob_lon)
    return gaspari_cohn(d, halfwidth)


def latlon_to_unit(lat, lon):
    """(lat, lon) degrees -> unit vectors on the sphere, shape [..., 3]."""
    phi = torch.deg2rad(_as_tensor(lat))
    lam = torch.deg2rad(_as_tensor(lon, like=phi))
    cphi = torch.cos(phi)
    return torch.stack(
        [cphi * torch.cos(lam), cphi * torch.sin(lam), torch.sin(phi)], dim=-1
    )


_ARCCOS_AS = (0.0066700901, -0.0170881256, 0.0308918810, -0.0501743046,
              0.0889789874, -0.2145988016, 1.5707963050)


def _arccos_as(t):
    """arccos for t in [0, 1] via Abramowitz & Stegun 4.4.46 (|err| <= 2e-8
    rad); extended to [-1, 0) by pi - arccos(-t)."""
    x = torch.abs(t)
    p = torch.full_like(x, -0.0012624911)
    for c in _ARCCOS_AS:
        p = p * x + c
    a = torch.sqrt(torch.clamp(1.0 - x, min=0.0)) * p
    return torch.where(t >= 0, a, math.pi - a)


def chordal_gc_weights(row_xyz, ob_xyz, halfwidth):
    """Gaspari-Cohn weights from unit vectors (the fast-geometry path):
    a 3-term dot plus the polynomial arccos.  ``row_xyz`` [..., 3],
    ``ob_xyz`` broadcastable [..., 3], ``halfwidth`` broadcastable km."""
    dot = torch.clamp(torch.sum(row_xyz * ob_xyz, dim=-1), -1.0, 1.0)
    dist = EARTH_RADIUS_KM * _arccos_as(dot)
    return gaspari_cohn(dist, halfwidth)


def _quantize(xyz, bits: int):
    n = float((1 << bits) - 1)
    q = torch.clamp((_as_tensor(xyz) + 1.0) * 0.5 * n, 0.0, n)
    return q.to(torch.int64)


def morton3d_keys(xyz, bits: int = 10):
    """Morton (Z-order) keys for unit vectors, ``bits`` per axis (int64)."""
    q = torch.clamp(_quantize(xyz, bits), max=(1 << bits) - 1)

    def spread(v):
        v = v & 0x3FF
        v = (v | (v << 16)) & 0xFF0000FF
        v = (v | (v << 8)) & 0x0F00F00F
        v = (v | (v << 4)) & 0xC30C30C3
        v = (v | (v << 2)) & 0x49249249
        return v

    return spread(q[..., 0]) | (spread(q[..., 1]) << 1) | (spread(q[..., 2]) << 2)


def hilbert3d_keys(xyz, bits: int = 10):
    """Hilbert-curve keys for unit vectors (int64; Skilling's
    AxesToTranspose + MSB-first interleave, as the JAX package)."""
    q = _quantize(xyz, bits)
    X = [q[..., 0], q[..., 1], q[..., 2]]
    Q = 1 << (bits - 1)
    while Q > 1:
        P = Q - 1
        for i in range(3):
            m = (X[i] & Q) != 0
            X[0] = torch.where(m, X[0] ^ P, X[0])
            t = torch.where(m, torch.zeros_like(X[0]), (X[0] ^ X[i]) & P)
            X[0] = X[0] ^ t
            X[i] = X[i] ^ t
        Q >>= 1
    X[1] = X[1] ^ X[0]
    X[2] = X[2] ^ X[1]
    t = torch.zeros_like(X[0])
    Q = 1 << (bits - 1)
    while Q > 1:
        m = (X[2] & Q) != 0
        t = torch.where(m, t ^ (Q - 1), t)
        Q >>= 1
    X = [x ^ t for x in X]
    key = torch.zeros_like(X[0])
    for b in range(bits - 1, -1, -1):
        for i in range(3):
            key = (key << 1) | ((X[i] >> b) & 1)
    return key


def spatial_sort_order(lat, lon, bits: int = 10):
    """Permutation (int64 tensor) ordering points by spherical Hilbert key.
    State row order is a free, exact choice (the update is row-local);
    sorted rows give the body kernel's row tiles compact caps, so that its
    cull bites."""
    return torch.argsort(hilbert3d_keys(latlon_to_unit(lat, lon), bits=bits),
                         stable=True)


def hilbert3d_np(lats, lons, bits: int = 10) -> np.ndarray:
    """NumPy Hilbert keys on (lat, lon) degrees (uint32), the twin of
    ``efa_xray_tpu/observation/thinning.py:236`` ``_hilbert3d_np``."""
    phi = np.radians(np.asarray(lats, float))
    lam = np.radians(np.asarray(lons, float))
    xyz = np.stack(
        [np.cos(phi) * np.cos(lam), np.cos(phi) * np.sin(lam), np.sin(phi)],
        axis=-1,
    )
    scale = (1 << bits) - 1
    q = np.clip((xyz + 1.0) * 0.5 * scale, 0, scale).astype(np.uint32)
    X = [q[..., 0].copy(), q[..., 1].copy(), q[..., 2].copy()]
    Q = 1 << (bits - 1)
    while Q > 1:
        P = np.uint32(Q - 1)
        for i in range(3):
            m = (X[i] & np.uint32(Q)) != 0
            X[0] = np.where(m, X[0] ^ P, X[0])
            t = np.where(m, np.uint32(0), (X[0] ^ X[i]) & P)
            X[0] ^= t
            X[i] ^= t
        Q >>= 1
    X[1] ^= X[0]
    X[2] ^= X[1]
    t = np.zeros_like(X[0])
    Q = 1 << (bits - 1)
    while Q > 1:
        m = (X[2] & np.uint32(Q)) != 0
        t = np.where(m, t ^ np.uint32(Q - 1), t)
        Q >>= 1
    X = [x ^ t for x in X]
    key = np.zeros_like(X[0])
    for b in range(bits - 1, -1, -1):
        for i in range(3):
            key = (key << np.uint32(1)) | ((X[i] >> np.uint32(b))
                                           & np.uint32(1))
    return key



def gaspari_cohn_np(distances, halfwidth):
    """NumPy float64 twin of :func:`gaspari_cohn` for host-side use."""
    r = np.asarray(distances, dtype=np.float64) / abs(halfwidth)
    inner = ((((-0.25 * r + 0.5) * r + 0.625) * r - 5.0 / 3.0) * r**2) + 1.0
    r_safe = np.where(r > 0, r, 1.0)
    outer = (
        ((((r / 12.0 - 0.5) * r + 0.625) * r + 5.0 / 3.0) * r - 5.0) * r
        + 4.0
        - 2.0 / (3.0 * r_safe)
    )
    return np.where(r <= 1.0, inner, np.where(r < 2.0, outer, 0.0))
