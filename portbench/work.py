"""The work an update needs, counted from its inputs.

A kernel's work is never counted from its own tiles, panels, cull bits or
sub-blocks: a kernel that culls or blocks otherwise is read against the
same work.  The unit is the (ob, row) pair within reach: an ob and a row
(a state row, or another ob's prior in the obs-space tail) whose
great-circle distance is under twice the ob's halfwidth, where
Gaspari-Cohn's support ends.

Operations per pair, from the serial algorithm (``reference/ensrf_serial``):
the covariance of the row with the ob's prior, ``2 M`` (M multiplies, M
adds); the perturbation update, ``2 M``; the gain and the mean update, 4
(weight times covariance, times the coefficient; one multiply-add); the
weight, 20 (the distance 10, Gaspari-Cohn's polynomial 10).  So
``4 M + 24`` operations a pair: 344 at 80 members.

Bytes, float32: each input read once and each output written once.

Which pairs belong to which kernel is the pair counter's to say: the
traffic mix names it (key ``pairs``), ``portbench/pairs/<name>.py``, and
the kernels' counts (``portbench/counts/<kernel>.py``) read its dict.
"""

from __future__ import annotations

import math

import torch

EARTH_RADIUS_KM = 6371.0
WEIGHT_OPS = 20
GAIN_OPS = 4
F4 = 4  # bytes of a float32


def ops_per_pair(nmems: int) -> int:
    return 4 * nmems + GAIN_OPS + WEIGHT_OPS


def _unit(lat, lon):
    phi, lam = torch.deg2rad(lat.double()), torch.deg2rad(lon.double())
    c = torch.cos(phi)
    return torch.stack([c * torch.cos(lam), c * torch.sin(lam),
                        torch.sin(phi)], dim=-1)


def reach_counts(row_lat, row_lon, ob_lat, ob_lon, radii,
                 chunk_elems: int = 1 << 28):
    """Per ob, the rows within twice its halfwidth ([No] int64): a
    brute-force count over every (ob, row) pair, by the dot of unit
    vectors against the cosine of the reach angle (float32 products)."""
    rows = _unit(row_lat, row_lon).float()
    obs = _unit(ob_lat, ob_lon).float()
    ang = torch.clamp(2.0 * radii.double() / EARTH_RADIUS_KM, max=math.pi)
    thr = torch.cos(ang).float()[:, None]
    counts = torch.zeros(obs.shape[0], dtype=torch.int64, device=obs.device)
    step = max(1, chunk_elems // max(1, obs.shape[0]))
    for s in range(0, rows.shape[0], step):
        counts += (obs @ rows[s:s + step].T > thr).sum(1)
    return counts


def panel_bytes(p: dict) -> int:
    """The panel solve: each ob prior (mean and members) read and written,
    its five parameters read, its six results written."""
    return p["nobs"] * ((p["nmems"] + 1) * 2 + 11) * F4


def apply_bytes(p: dict) -> int:
    """The tail apply and the body: per panel the ob priors outside it
    read and written and the panel's solved sequence (a member row, two
    coefficients, three of geometry) read; the state rows (mean, members,
    two coordinates) read and written once, and the whole sequence read."""
    m, no = p["nmems"], p["nobs"]
    tail = sum((no - k) * (m + 1) * 2 + k * (m + 5) for k in p["panel_sizes"])
    body = p["nstate"] * ((m + 1) * 2 + 2) + no * (m + 5)
    return (tail + body) * F4
