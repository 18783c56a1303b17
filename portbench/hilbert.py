"""Spherical Hilbert keys on the device: a frozen copy of the key that
orders the rows and obs of the flat workload (``bench.py``
``build_workload``), so that the benchmark's inputs cannot change when
the program's own key does.

Skilling's AxesToTranspose on unit vectors quantized to ``bits`` per axis,
then an MSB-first interleave (the JAX package's ``_hilbert3d_np``, and
the port's ``observation.localization.hilbert3d_np``).
"""

from __future__ import annotations

import torch


def unit_vectors(lat, lon):
    """(lat, lon) degrees -> unit vectors ``[..., 3]`` in their dtype."""
    phi = torch.deg2rad(lat)
    lam = torch.deg2rad(lon)
    c = torch.cos(phi)
    return torch.stack([c * torch.cos(lam), c * torch.sin(lam),
                        torch.sin(phi)], dim=-1)


def keys(lat, lon, bits: int = 10):
    """int64 Hilbert keys of points in degrees, on their device."""
    xyz = unit_vectors(lat.double(), lon.double())
    n = float((1 << bits) - 1)
    q = torch.clamp((xyz + 1.0) * 0.5 * n, 0.0, n).to(torch.int64)
    x = [q[..., 0], q[..., 1], q[..., 2]]
    top = 1 << (bits - 1)
    b = top
    while b > 1:
        p = b - 1
        for i in range(3):
            m = (x[i] & b) != 0
            x[0] = torch.where(m, x[0] ^ p, x[0])
            t = torch.where(m, torch.zeros_like(x[0]), (x[0] ^ x[i]) & p)
            x[0] = x[0] ^ t
            x[i] = x[i] ^ t
        b >>= 1
    x[1] = x[1] ^ x[0]
    x[2] = x[2] ^ x[1]
    t = torch.zeros_like(x[0])
    b = top
    while b > 1:
        t = torch.where((x[2] & b) != 0, t ^ (b - 1), t)
        b >>= 1
    x = [v ^ t for v in x]
    key = torch.zeros_like(x[0])
    for bit in range(bits - 1, -1, -1):
        for i in range(3):
            key = (key << 1) | ((x[i] >> bit) & 1)
    return key


def order(lat, lon, bits: int = 10):
    """The stable permutation sorting points by Hilbert key."""
    return torch.argsort(keys(lat, lon, bits), stable=True)
