"""Plain reference of one LETKF update: the local ensemble transform Kalman
filter of Hunt, Kostelich & Szunyogh (2007, Physica D 230, eqs. 20-23) in
float64 torch, one local analysis per unit.

It imports nothing of the program and takes nothing the program made:
geometry, obs priors, neighbour sets and localization are worked out
again here from the inputs the benchmark hands to both sides
(``portbench.generate``).

* Units: a patch of ``letkf_patch_size`` consecutive rows (the
  configuration's), whose rows share the weights of its centroid, the
  normalised mean of its rows' unit vectors (a last, short patch padded
  with copies of the last row); and every ob as a unit of its own at its
  location, whose weights give the obs' posterior.
* Selection: each unit's ``letkf_k_obs`` nearest obs, by the chordal dot
  of unit vectors, descending, ties to the lower index.
* Localization: ``rho = GC(d, r)``, Gaspari-Cohn (1999, eq. 4.10) at the
  ob's halfwidth ``r``, ``d`` the great-circle distance from the chordal
  dot, ``R_E arccos(dot)`` with arccos by Abramowitz & Stegun 4.4.46 (the
  distance form the JAX package documents for the LETKF's weights,
  ``chordal_gc_weights``: within 2e-8 rad of the exact arc).
* Transform: ``A = (M - 1) I + Y^T diag(rho / R) Y`` over the unit's
  obs, ``Y`` their prior perturbations, solved by ``eigh``; ``wbar =
  A^{-1} Y^T diag(rho / R) d`` (``d`` the innovations) and ``W = sqrt(M -
  1) A^{-1/2}``.
* Posterior: ``xm + Xp wbar`` and ``Xp W`` on each of the unit's rows.
* Diagnostics: the obs-space posterior from each ob's own unit; the
  variances with the EnSRF's convention (``ddof`` 0 unless the
  configuration sets ``unbiased_variance``).

One departure from float64, on purpose: the unit vectors, the centroids
and the dots that rank the neighbours are computed in the filter's dtype
(the configuration's ``dtype``) with the filter's three products and two
sums, and rounded to float32: that is how the filter defines its
neighbour set (never a matrix product).  Ranked in float64, roughly one
64th/65th boundary in a thousand patches would fall otherwise, and a
patch whose neighbour set differs differs by a share of its increment,
not by rounding.  The centroids are formed over the whole state in one
reduction, as the filter forms them, so that each is the filter's bit for
bit.  Everything after the selection is float64.

Only the sampled rows' patches are carried: a unit's posterior depends
on its own rows and the obs alone, so a sample is exact for its rows.

``products`` computes the same analysis in a precision below the
configuration's float32, for the cell's control (``entries/letkf.py``):
``"tf32"`` or ``"bf16"``, everything after the selection in float32 and
each matrix product's operands rounded to that format, the sums kept in
float32, as a tensor core takes them.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import torch

F32 = torch.float32
F64 = torch.float64
EARTH_RADIUS_KM = 6371.0
# Abramowitz & Stegun 4.4.46: arccos(x) = sqrt(1 - x) sum_i a_i x^i on
# [0, 1], a_7 first.
_AS_4_4_46 = (-0.0012624911, 0.0066700901, -0.0170881256, 0.0308918810,
              -0.0501743046, 0.0889789874, -0.2145988016, 1.5707963050)
# Units a batch of the float64 solve and of the ranking.
BATCH = 1024
# The precisions of the analysis after the selection: the reference's,
# and the formats below float32 that the cell's control computes in.
PRODUCTS = ("float64", "tf32", "bf16")

# What ``portbench/check.py`` compares of an answer: as the EnSRF's
# reference (``ensrf_serial.py``), each part's gap as a share of what the
# update changed, means and spreads apart, each number taking in state
# and obs parts.
SCALES = dict(
    state_mean=("state_mean", "state_prior_mean"),
    state_perts=("state_perts", "state_prior_perts"),
    prior_mean=("post_mean", "prior_mean"),
    post_mean=("post_mean", "prior_mean"),
    prior_var=("prior_var", "post_var"),
    post_var=("prior_var", "post_var"),
    obs_mean=("obs_mean", "obs_prior_mean"),
    obs_perts=("obs_perts", "obs_prior_perts"))
NUMBERS = dict(
    mean_gap=("state_mean", "prior_mean", "post_mean", "obs_mean"),
    spread_gap=("state_perts", "prior_var", "post_var", "obs_perts"))
EXACT = dict(flag_gaps="assimilated")


def unit_vectors(lat, lon, dtype):
    """(lat, lon) degrees -> unit vectors ``[..., 3]``, computed in
    ``dtype``."""
    phi = torch.deg2rad(lat.to(dtype))
    lam = torch.deg2rad(lon.to(dtype))
    c = torch.cos(phi)
    return torch.stack([c * torch.cos(lam), c * torch.sin(lam),
                        torch.sin(phi)], dim=-1)


def centroids(xyz, patch_size: int):
    """The normalised mean of each patch's unit vectors, ``[P, 3]`` in
    ``xyz``'s dtype; a short last patch is padded with the last row."""
    n = xyz.shape[0]
    npatch = -(-n // patch_size)
    pad = npatch * patch_size - n
    if pad:
        xyz = torch.cat([xyz, xyz[-1:].expand(pad, 3)])
    c = xyz.reshape(npatch, patch_size, 3).mean(dim=1)
    return c / torch.clamp(torch.linalg.norm(c, dim=-1, keepdim=True),
                           min=1e-12)


def nearest(unit_xyz, obs_xyz, k: int, batch: int = BATCH):
    """Indices ``[U, k]`` of each unit's ``k`` nearest obs: the chordal
    dots (three products, two sums, in the inputs' dtype, rounded to
    float32) in descending order, ties to the lower index (a stable
    sort)."""
    out = []
    for s in range(0, unit_xyz.shape[0], batch):
        p = unit_xyz[s:s + batch]
        dots = (p[:, None, 0] * obs_xyz[None, :, 0]
                + p[:, None, 1] * obs_xyz[None, :, 1]
                + p[:, None, 2] * obs_xyz[None, :, 2]).to(F32)
        out.append(torch.sort(dots, dim=1, descending=True,
                              stable=True).indices[:, :k])
    return torch.cat(out)


def arccos_as(t):
    """arccos by Abramowitz & Stegun 4.4.46 on [0, 1], and ``pi -
    arccos(-t)`` below 0."""
    x = torch.abs(t)
    p = torch.zeros_like(x)
    for a in _AS_4_4_46:
        p = p * x + a
    a = torch.sqrt(torch.clamp(1.0 - x, min=0.0)) * p
    return torch.where(t >= 0, a, math.pi - a)


def gaspari_cohn(dist, halfwidth):
    r = dist / torch.abs(halfwidth)
    inner = (((-0.25 * r + 0.5) * r + 0.625) * r - 5.0 / 3.0) * r**2 + 1.0
    rs = torch.where(r > 0, r, torch.ones_like(r))
    outer = (((((rs / 12.0 - 0.5) * rs + 0.625) * rs + 5.0 / 3.0) * rs
              - 5.0) * rs + 4.0 - 2.0 / (3.0 * rs))
    return torch.where(r <= 1.0, inner,
                       torch.where(r < 2.0, outer, torch.zeros_like(r)))


def eigh(amat):
    """``torch.linalg.eigh`` of the batch ``amat`` on the host, each core
    this process may use taking a slice, LAPACK on one thread each; the
    results on ``amat``'s device.  On an H100's machine (8 cores), 1,024
    systems of 80 x 80: 0.12-0.13 s here against 1.08-1.18 s for
    ``torch.linalg.eigh`` on the card in float64 (0.08-0.09 s against
    1.49-1.51 s in float32)."""
    host = amat.cpu()
    cores = len(os.sched_getaffinity(0))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with ThreadPoolExecutor(cores) as pool:
            parts = list(pool.map(torch.linalg.eigh,
                                  host.split(-(-host.shape[0] // cores))))
    finally:
        torch.set_num_threads(threads)
    return (torch.cat([e for e, _ in parts]).to(amat.device),
            torch.cat([v for _, v in parts]).to(amat.device))


def rounded(x, products: str):
    """float32 ``x`` rounded to nearest even in ``products``' format:
    ``"tf32"`` keeps 10 bits of the mantissa, ``"bf16"`` 7."""
    if products == "bf16":
        return x.to(torch.bfloat16).to(F32)
    i = x.view(torch.int32)
    i = (i + (0xFFF + ((i >> 13) & 1))) & ~0x1FFF
    return i.view(F32)


def mm(a, b, products: str):
    """``a @ b``: in float64, or with both operands rounded to
    ``products``' format and the sums in float32."""
    if products == "float64":
        return a @ b
    return rounded(a, products) @ rounded(b, products)


def weights(unit_xyz, idx, yp, innov, rinv, obs_xyz, radii,
            batch: int = BATCH, products: str = "float64"):
    """``(wbar [U, M], W [U, M, M])`` of each unit (centroid ``unit_xyz``)
    over its obs ``idx [U, K]``, in the operands' dtype, each product as
    :func:`mm` takes it."""
    m = yp.shape[1]
    eye = torch.eye(m, dtype=yp.dtype, device=yp.device)
    wbars, ws = [], []
    for s in range(0, idx.shape[0], batch):
        ii = idx[s:s + batch]
        dot = torch.clamp((unit_xyz[s:s + batch, None, :]
                           * obs_xyz[ii]).sum(-1), -1.0, 1.0)
        a = rinv[ii] * gaspari_cohn(EARTH_RADIUS_KM * arccos_as(dot),
                                    radii[ii])
        y = yp[ii]  # [B, K, M]
        ya = y * a[..., None]
        amat = (m - 1) * eye + mm(ya.transpose(1, 2), y, products)
        b = mm(ya.transpose(1, 2), innov[ii][..., None], products)[..., 0]
        e, v = eigh(amat)
        vtb = mm(v.transpose(1, 2), b[..., None], products)[..., 0]
        wbars.append(mm(v, (vtb / e)[..., None], products)[..., 0])
        ws.append(math.sqrt(m - 1) * mm(v * e.rsqrt()[:, None, :],
                                        v.transpose(1, 2), products))
    return torch.cat(wbars), torch.cat(ws)


def letkf(grid_lat, grid_lon, sample, xm, xp, ym, yp, values, errors,
          ob_lat, ob_lon, radii, assim=None, *, patch_size: int, k_obs: int,
          dtype=F32, unbiased: bool = False,
          products: str = "float64") -> dict:
    """The LETKF update of the state rows ``sample`` (their prior ``xm
    [S]``, ``xp [S, M]``) and of the obs (priors ``ym [No]``, ``yp [No,
    M]``), ``grid_lat``/``grid_lon`` every row's coordinates (a patch's
    centroid needs its rows'), ``dtype`` the filter's (the selection's).
    Returns a dict of float64 tensors: the rows' posterior
    ``state_mean``/``state_perts``, the obs' ``obs_mean``/``obs_perts``,
    and per ob ``prior_mean``/``prior_var``, ``post_mean``/``post_var``
    and ``assimilated``, float64 (float32 where ``products`` is a
    format below float32: see the module's docstring)."""
    if products not in PRODUCTS:
        raise ValueError(f"products {products!r} is not one of {PRODUCTS}")
    # Only the rounding that ``products`` asks for: TF32 never takes a
    # float64 product, nor a float32 one here.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    real = F64 if products == "float64" else F32
    dev = xm.device
    no, m = yp.shape
    assim = (torch.ones(no, dtype=torch.bool, device=dev) if assim is None
             else assim.to(dev))
    ym, yp, xm, xp = (t.to(real) for t in (ym, yp, xm, xp))
    innov = values.to(real) - ym
    rinv = torch.where(assim, 1.0 / torch.clamp(
        errors.to(real), min=torch.finfo(real).tiny),
        torch.zeros((), dtype=real, device=dev))
    radii = radii.to(real)
    k = min(int(k_obs), no)
    # The neighbour sets, in the filter's dtype.
    obs_sel = unit_vectors(ob_lat, ob_lon, dtype)
    patch_of = torch.div(sample, patch_size, rounding_mode="floor")
    patches, inverse = torch.unique(patch_of, return_inverse=True)
    cen = centroids(unit_vectors(grid_lat, grid_lon, dtype), patch_size)
    idx_p = nearest(cen[patches], obs_sel, k)
    idx_o = nearest(obs_sel, obs_sel, k)
    del cen
    # Everything after the selection in float64 (or ``products``').
    obs_r = unit_vectors(ob_lat, ob_lon, real)
    cen_r = centroids(unit_vectors(grid_lat, grid_lon, real),
                      patch_size)[patches]
    wbar, w = weights(cen_r, idx_p, yp, innov, rinv, obs_r, radii,
                      products=products)
    post_m = xm + mm(xp[:, None, :], wbar[inverse][..., None],
                     products)[:, 0, 0]
    post_p = mm(xp[:, None, :], w[inverse], products)[:, 0, :]
    wbar, w = weights(obs_r, idx_o, yp, innov, rinv, obs_r, radii,
                      products=products)
    tm = ym + mm(yp[:, None, :], wbar[..., None], products)[:, 0, 0]
    tp = mm(yp[:, None, :], w, products)[:, 0, :]
    denom = (m - 1) if unbiased else m
    nan = torch.full((), float("nan"), dtype=real, device=dev)
    post_var = (tp ** 2).sum(1) / denom
    return dict(state_mean=post_m, state_perts=post_p, obs_mean=tm,
                obs_perts=tp, prior_mean=ym, prior_var=(yp ** 2).sum(1)
                / denom, post_mean=torch.where(assim, tm, nan),
                post_var=torch.where(assim, post_var, nan),
                assimilated=assim)


def expected(inputs, k: int, sample, products: str = "float64"):
    """The reference's answer to update ``k`` of a run (values set ``k``)
    at the state rows ``sample``: :func:`letkf` on the run's inputs, with
    the prior drawn again and the obs priors the state at the obs' rows,
    at the configuration's patch size, neighbour count and dtype, its
    products as ``products`` says."""
    cfg = inputs.config
    bm, bp = inputs.prior()
    xm, xp = bm[sample].to(F64), bp[sample].to(F64)
    ym = bm[inputs.ob_rows].to(F64)
    yp = bp[inputs.ob_rows].to(F64)
    del bm, bp
    out = letkf(inputs.row_lat, inputs.row_lon, sample, xm, xp, ym, yp,
                inputs.value_set(k), inputs.errors, inputs.ob_lat,
                inputs.ob_lon, inputs.radii,
                patch_size=int(cfg["letkf_patch_size"]),
                k_obs=int(cfg["letkf_k_obs"]),
                dtype=getattr(torch, cfg["dtype"]),
                unbiased=bool(cfg.get("unbiased_variance", False)),
                products=products)
    out["state_prior_mean"], out["state_prior_perts"] = xm, xp
    out["obs_prior_mean"], out["obs_prior_perts"] = ym, yp
    return out
