"""Frozen copy of the repository's independent NumPy oracle of the
serial EnSRF (``tests/oracle_numpy.py``), kept beside the benchmark so
that the test of its reference cannot change under it.

A from-scratch float64 implementation of the reference filter's
algorithm (``efa_xray/assimilation/ensrf.py:33-151`` and
``assimilation.py:120-154``: augmented state, Whitaker-Hamill serial
square-root update, Gaspari-Cohn localization) on raw arrays.
"""

from __future__ import annotations

import numpy as np


def gc_weights(dist, halfwidth):
    if np.isinf(halfwidth):
        return np.ones_like(dist)
    r = dist / abs(halfwidth)
    w = np.zeros_like(r)
    m1 = r <= 1.0
    m2 = (r > 1.0) & (r < 2.0)
    r1, r2 = r[m1], r[m2]  # evaluate branches only on their masks so the
    # outer-branch 1/r term never divides by zero
    w[m1] = (((-0.25 * r1 + 0.5) * r1 + 0.625) * r1 - 5.0 / 3.0) * r1**2 + 1.0
    w[m2] = (
        ((((r2 / 12.0 - 0.5) * r2 + 0.625) * r2 + 5.0 / 3.0) * r2 - 5.0) * r2
        + 4.0
        - 2.0 / (3.0 * r2)
    )
    return w


def haversine_np(lat1, lon1, lat2, lon2):
    R = 6371.0
    p1, p2 = np.radians(lat1), np.radians(lat2)
    dlat = p2 - p1
    dlon = np.radians(np.asarray(lon2) - np.asarray(lon1))
    a = np.sin(dlat / 2) ** 2 + np.cos(p1) * np.cos(p2) * np.sin(dlon / 2) ** 2
    return R * 2 * np.arctan2(np.sqrt(a), np.sqrt(1 - a))


def serial_ensrf(
    prior_vect,  # [Ns, M] float64 full prior (mean not yet removed)
    ob_priors,  # [No, M] ensemble obs-space priors (ye per ob)
    values,  # [No]
    errors,  # [No]
    ob_lats,
    ob_lons,
    radii,  # [No], np.inf = no localization for that ob
    row_lats,
    row_lons,  # [Ns]
    assim,  # bool [No]
    localize: bool,
    unbiased: bool = False,
    varloc=None,  # [nv(+1), nvars] cross-variable factors (extension)
    row_var=None,  # [Ns] int state-variable index per row
    ob_var=None,  # [No] int observed-variable index per ob
):
    """Returns (posterior_vect [Ns, M], diagnostics dict of [No] arrays)."""
    prior_vect = np.asarray(prior_vect, dtype=np.float64)
    ns, nens = prior_vect.shape
    nobs = len(values)

    # Augmented formulation (reference assimilation.py:146-150)
    xbm = prior_vect.mean(axis=1)
    Xbp = prior_vect - xbm[:, None]
    ob_means = ob_priors.mean(axis=1)
    xam = np.concatenate([xbm, ob_means])
    Xap = np.vstack([Xbp, ob_priors - ob_means[:, None]])

    aug_lats = np.concatenate([row_lats, ob_lats])
    aug_lons = np.concatenate([row_lons, ob_lons])

    diags = {
        "prior_mean": np.full(nobs, np.nan),
        "prior_var": np.full(nobs, np.nan),
        "post_mean": np.full(nobs, np.nan),
        "post_var": np.full(nobs, np.nan),
        "assimilated": np.zeros(nobs, dtype=bool),
    }

    for i in range(nobs):
        ye = Xap[ns + i].copy()
        mye = xam[ns + i]
        varye = np.var(ye, ddof=1 if unbiased else 0)  # reference ensrf.py:69
        diags["prior_mean"][i] = mye
        diags["prior_var"][i] = varye
        if not assim[i]:
            continue

        r_err = errors[i]
        innov = values[i] - mye
        kdenom = varye + r_err
        kcov = Xap @ ye / (nens - 1)
        if localize:
            d = haversine_np(aug_lats, aug_lons, ob_lats[i], ob_lons[i])
            kcov = kcov * gc_weights(d, radii[i])
        if varloc is not None:
            # Cross-variable factor on both the state rows and the
            # augmented obs tail (mirrors the library's extension).
            fr = np.asarray(varloc, np.float64)[ob_var[i]]
            kcov = kcov * np.concatenate([fr[row_var], fr[ob_var]])
        kmat = kcov / kdenom
        xam = xam + kmat * innov
        beta = 1.0 / (1.0 + np.sqrt(r_err / kdenom))
        Xap = Xap - np.outer(beta * kmat, ye)

        diags["post_mean"][i] = xam[ns + i]
        diags["post_var"][i] = np.var(Xap[ns + i], ddof=1 if unbiased else 0)
        diags["assimilated"][i] = True

    post = (xam[:, None] + Xap)[:ns]
    return post, diags
