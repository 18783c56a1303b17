"""The plain reference against the frozen float64 oracle, at tiny
sizes, and its forward operator against a brute-force NumPy search."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import spec
from portbench.tests import oracle_numpy as oracle

ref = spec.load_module("reference", "ensrf_serial")
ROOT = Path(__file__).resolve().parents[2]


def _case(seed, ns=60, no=25, m=8, radius=1500.0):
    rng = np.random.default_rng(seed)
    prior = rng.normal(280.0, 3.0, (ns, m))
    rlat, rlon = rng.uniform(-80, 80, ns), rng.uniform(0, 360, ns)
    olat, olon = rng.uniform(-80, 80, no), rng.uniform(0, 360, no)
    ye = rng.normal(280.0, 3.0, (no, m))
    values = rng.normal(280.0, 2.0, no)
    errors = rng.uniform(0.5, 2.0, no)
    radii = np.full(no, radius)
    assim = rng.uniform(size=no) > 0.2
    return prior, ye, values, errors, olat, olon, radii, rlat, rlon, assim


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_serial_update_matches_oracle(seed):
    (prior, ye, values, errors, olat, olon, radii, rlat, rlon,
     assim) = _case(seed)
    post, diags = oracle.serial_ensrf(prior, ye, values, errors, olat, olon,
                                      radii, rlat, rlon, assim,
                                      localize=True)
    t = lambda a: torch.tensor(a, dtype=torch.float64)
    xm, ym = prior.mean(1), ye.mean(1)
    out = ref.serial_update(t(xm), t(prior - xm[:, None]), t(ym),
                            t(ye - ym[:, None]), t(values), t(errors),
                            t(olat), t(olon), t(radii), t(rlat), t(rlon),
                            list(assim))
    got = (out["state_mean"][:, None] + out["state_perts"]).numpy()
    np.testing.assert_allclose(got, post, rtol=0, atol=1e-10)
    for k in ("prior_mean", "prior_var"):
        np.testing.assert_allclose(out[k].numpy(), diags[k], atol=1e-10)
    for k in ("post_mean", "post_var"):
        np.testing.assert_allclose(out[k].numpy()[assim],
                                   diags[k][assim], atol=1e-10)
    assert np.array_equal(out["assimilated"].numpy(), diags["assimilated"])


def test_nearest_taps_match_brute_force():
    rng = np.random.default_rng(3)
    lat1d, lon1d = np.linspace(-88, 88, 30), np.arange(60) * 6.0
    glat = np.repeat(lat1d, 60)
    glon = np.tile(lon1d, 30)
    olat, olon = rng.uniform(-85, 85, 40), rng.uniform(0, 360, 40)
    olat[0], olon[0] = glat[100] + 1e-3, glon[100]  # within 1 km
    rows, w = ref.nearest_taps(torch.tensor(glat), torch.tensor(glon),
                               torch.tensor(olat), torch.tensor(olon))
    d = oracle.haversine_np(olat[:, None], olon[:, None], glat[None, :],
                            glon[None, :])
    want = np.argsort(d, axis=1, kind="stable")[:, :4]
    assert np.array_equal(np.sort(rows.numpy(), 1), np.sort(want, 1))
    dsel = np.take_along_axis(d, rows.numpy(), 1)
    idw = (1 / dsel) / (1 / dsel).sum(1, keepdims=True)
    np.testing.assert_allclose(w.numpy()[1:], idw[1:], rtol=1e-12)
    assert w[0].tolist().count(1.0) == 1 and float(w[0].sum()) == 1.0


def test_reference_loads_nothing_of_the_program():
    """The reference, loaded alone, brings in nothing of the port, of the
    JAX package or of JAX."""
    code = ("import sys; sys.path.insert(0, '.');"
            "from portbench import spec;"
            "spec.load_module('reference', 'ensrf_serial');"
            "bad = {n.split('.')[0] for n in sys.modules} & "
            "{'efa_xray_tpu_torch', 'efa_xray_tpu', 'jax', 'jaxlib'};"
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
