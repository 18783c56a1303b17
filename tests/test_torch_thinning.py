"""Observation preprocessing in the port against the JAX package's.

Each case of ``tests/test_thinning.py`` (and a random network through the
whole pipeline) builds the same batch in both packages from NumPy, runs
``superob`` / ``thin_by_distance`` / ``sort_spatially`` in each, and holds
every field of the outputs equal; the case's own claim is checked on the
port's output.  A thinned batch then assimilates through both packages'
``EnSRF`` at 1e-9 (float64, CPU).
"""

import numpy as np
import pytest

from conftest import make_demo_state
from efa_xray_tpu.assimilation.ensrf import EnSRF as JEnSRF
from efa_xray_tpu.config import FilterConfig as JConfig
from efa_xray_tpu.observation import thinning as jthin
from efa_xray_tpu.observation.observation import ObservationBatch as JBatch
from efa_xray_tpu.utils import timeutil
from efa_xray_tpu_torch import EnSRF, FilterConfig, interop
from efa_xray_tpu_torch.observation import thinning
from efa_xray_tpu_torch.observation.localization import pairwise_distance
from efa_xray_tpu_torch.observation.observation import ObservationBatch

FIELDS = ("values", "errors", "lats", "lons", "times_s", "obtypes",
          "localize_radius", "assimilate_flags", "verts", "descriptions",
          "vert_radius", "custom_operator")


def _fields(lats, lons, values=None, errors=None, obtypes=None, assim=None,
            custom=None, times_s=None, verts=None):
    n = len(lats)
    t0 = timeutil.to_epoch_seconds(np.repeat(np.datetime64("2026-08-01"), n))
    return dict(
        values=np.asarray(values if values is not None else np.full(n, 280.0),
                          float),
        errors=np.asarray(errors if errors is not None else np.ones(n), float),
        lats=np.asarray(lats, float), lons=np.asarray(lons, float),
        times_s=t0 if times_s is None else np.asarray(times_s, np.int64),
        obtypes=list(obtypes) if obtypes is not None else ["T2m"] * n,
        localize_radius=np.full(n, 2000.0),
        assimilate_flags=np.asarray(assim if assim is not None
                                    else np.ones(n, bool)),
        verts=np.full(n, np.nan) if verts is None else np.asarray(verts,
                                                                  float),
        descriptions=[None] * n,
        custom_operator=(np.zeros(n, bool) if custom is None
                         else np.asarray(custom, bool)))


def _both(f):
    return (JBatch(**{k: (list(v) if isinstance(v, list) else v.copy())
                      for k, v in f.items()}),
            ObservationBatch(**{k: (list(v) if isinstance(v, list)
                                    else v.copy()) for k, v in f.items()}))


def _assert_same(got, want):
    for k in FIELDS:
        g, w = getattr(got, k), getattr(want, k)
        if isinstance(w, list):
            assert list(g) == list(w), k
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=k)


def _random_network(n=300, seed=3):
    rng = np.random.default_rng(seed)
    lats = rng.uniform(-80, 85, n)
    lons = rng.uniform(0, 360, n)
    dup = rng.random(n) < 0.3  # near-duplicates of the previous ob
    idx = np.maximum(np.nonzero(dup)[0] - 1, 0)
    lats[dup] = lats[idx] + rng.normal(0, 0.05, idx.size)
    lons[dup] = lons[idx] + rng.normal(0, 0.05, idx.size)
    t0 = timeutil.to_epoch_seconds(np.datetime64("2026-08-01"))
    return _fields(lats, lons, values=rng.normal(280, 3, n),
                   errors=rng.uniform(0.5, 2.0, n),
                   obtypes=rng.choice(["T2m", "Q2m"], n),
                   assim=rng.random(n) > 0.05, custom=rng.random(n) < 0.03,
                   times_s=t0 + rng.integers(0, 7200, n),
                   verts=np.where(rng.random(n) < 0.5,
                                  rng.uniform(100, 1000, n), np.nan))


CASES = {
    "superob merges colocated duplicates": (
        lambda: _fields([40.1, 40.2, 40.3, 40.4, 55.0],
                        [250.1, 250.2, 250.3, 250.4, 300.0],
                        values=[280.0, 281.0, 282.0, 283.0, 270.0]),
        lambda m, b: m.superob(b, cell_deg=1.0)),
    "superob is precision weighted": (
        lambda: _fields([40.0, 40.0], [250.0, 250.0], values=[280.0, 284.0],
                        errors=[1.0, 3.0]),
        lambda m, b: m.superob(b, cell_deg=2.0)),
    "superob separates obtypes and passes custom/QC'd obs": (
        lambda: _fields([40.0] * 4, [250.0] * 4,
                        obtypes=["T2m", "PS", "T2m", "T2m"],
                        assim=[True, True, False, True],
                        custom=[False, False, False, True]),
        lambda m, b: m.superob(b, cell_deg=5.0)),
    "superob longitude wraparound": (
        lambda: _fields([0.0, 0.0], [359.9, 0.1]),
        lambda m, b: m.superob(b, cell_deg=360.0)),
    "thin enforces separation, prefers accurate": (
        lambda: _fields([40.0, 40.05, 40.1, 45.0], [250.0] * 4,
                        errors=[3.0, 1.0, 2.0, 1.0]),
        lambda m, b: m.thin_by_distance(b, min_km=50.0)),
    "thin keeps passthrough obs": (
        lambda: _fields([40.0, 40.01, 40.02], [250.0] * 3,
                        errors=[1.0, 2.0, 3.0], assim=[True, False, True]),
        lambda m, b: m.thin_by_distance(b, min_km=50.0)),
    "thin is pole safe": (
        lambda: _fields(*np.random.default_rng(9).uniform(
            [85.0, 0.0], [90.0, 360.0], (200, 2)).T,
            errors=np.random.default_rng(10).uniform(0.5, 2.0, 200)),
        lambda m, b: m.thin_by_distance(b, min_km=80.0)),
    "random network: superob, thin, sort": (
        _random_network,
        lambda m, b: m.sort_spatially(m.thin_by_distance(
            m.superob(b, cell_deg=0.5), min_km=60.0))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_matches_jax(case):
    make, run = CASES[case]
    jb, tb = _both(make())
    got, want = run(thinning, tb), run(jthin, jb)
    assert isinstance(got, ObservationBatch)
    _assert_same(got, want)
    if case.startswith("superob merges"):
        assert len(got) == 2
        i = int(np.argmin(np.abs(got.lats - 40.25)))
        assert got.values[i] == pytest.approx(281.5)
        assert got.errors[i] == pytest.approx(0.25)
        assert got.descriptions[i] == "superob(n=4)"
    if case.startswith("superob is precision"):
        w = np.array([1.0, 1.0 / 3.0])
        assert got.values[0] == pytest.approx((280 * w[0] + 284 * w[1])
                                              / w.sum())
        assert got.errors[0] == pytest.approx(1.0 / w.sum())
    if case.startswith("superob separates"):
        assert sorted(got.obtypes) == ["PS", "T2m", "T2m", "T2m"]
        assert got.custom_operator.sum() == 1
        assert (~got.assimilate_flags).sum() == 1
    if case.startswith("superob longitude"):
        assert len(got) == 1
        assert min(got.lons[0], 360 - got.lons[0]) < 1.0
    if case.startswith("thin enforces"):
        assert sorted(got.errors) == [1.0, 1.0]
    if case.startswith("thin keeps"):
        assert len(got) == 2 and (~got.assimilate_flags).sum() == 1
    if case.startswith("thin is pole") or case.startswith("random"):
        kept = ~(got.custom_operator | ~got.assimilate_flags)
        d = pairwise_distance(got.lats[kept], got.lons[kept],
                              got.lats[kept], got.lons[kept]).numpy()
        np.fill_diagonal(d, np.inf)
        assert d.min() >= (80.0 if case.startswith("thin") else 60.0) - 1e-6


def test_morton_keys_match_jax():
    f = _random_network(n=500, seed=4)
    np.testing.assert_array_equal(thinning._morton3d_np(f["lats"], f["lons"]),
                                  jthin._morton3d_np(f["lats"], f["lons"]))


def test_empty_and_invalid_arguments():
    empty = ObservationBatch(**_fields([], []))
    assert len(thinning.superob(empty, 1.0)) == 0
    assert len(thinning.thin_by_distance(empty, 10.0)) == 0
    with pytest.raises(ValueError):
        thinning.superob(empty, 0.0)
    with pytest.raises(ValueError):
        thinning.thin_by_distance(empty, -1.0)


def test_thinned_batch_assimilates_like_jax():
    """``tests/test_thinning.py``'s preprocessed batch through both
    packages' ``EnSRF`` (float64)."""
    jstate = make_demo_state(ny=6, nx=8, nmems=12)
    s = jstate.structure
    rng = np.random.default_rng(5)
    n = 40
    f = _fields(rng.uniform(s.lat.min() + 0.5, s.lat.max() - 0.5, n),
                rng.uniform(s.lon.min() + 0.5, s.lon.max() - 0.5, n),
                values=rng.normal(280, 2, n),
                times_s=np.full(n, s.times_s[0]))
    jb, tb = _both(f)
    jsmall = jthin.superob(jthin.thin_by_distance(jb, 30.0), 1.0)
    tsmall = thinning.superob(thinning.thin_by_distance(tb, 30.0), 1.0)
    _assert_same(tsmall, jsmall)
    data = np.asarray(jstate.data)
    tstate = interop.state_from_numpy(
        {name: data[i] for i, name in enumerate(s.var_names)},
        {"validtime": s.times64(), "lat": s.lat, "lon": s.lon},
        dtype="float64", device="cpu")
    jpost, jout = JEnSRF(jstate, jsmall, config=JConfig(
        localization="GC", dtype="float64")).update()
    tpost, tout = EnSRF(tstate, tsmall, config=FilterConfig(
        localization="GC", dtype="float64"), verbose=False).update()
    np.testing.assert_allclose(interop.state_to_numpy(tpost),
                               np.asarray(jpost.data), rtol=1e-9, atol=1e-9)
    assert tout.assimilated.all()
    assert np.nanmean(tout.post_var) < np.nanmean(tout.prior_var)
