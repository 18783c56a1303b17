"""Ensemble sensitivity and observation impact (``postprocess/
sensitivity.py``) in the port against the JAX package (float64, CPU,
1e-9), and the identities ``test_sensitivity.py`` pins, on the port's own
EnSRF: the single-ob prediction and greedy's cumulative prediction equal
the serial update they predict."""

import numpy as np
import pandas as pd
import pytest
import torch

from conftest import make_demo_obs, make_demo_state
from efa_xray_tpu.observation.observation import Observation as JObservation
from efa_xray_tpu.observation.observation import ObservationBatch as JBatch
from efa_xray_tpu.postprocess import sensitivity as jsens
from efa_xray_tpu.utils import timeutil
from efa_xray_tpu_torch import EnSRF, FilterConfig, interop
from efa_xray_tpu_torch.postprocess import sensitivity as tsens

TOL = 1e-9
_BATCH_FIELDS = ("values", "errors", "lats", "lons", "times_s", "obtypes",
                 "localize_radius", "assimilate_flags", "verts",
                 "descriptions", "vert_radius")


def _state(**kw):
    """The same state as a JAX and a port object (float64, CPU)."""
    j = make_demo_state(**kw)
    s = j.structure
    data = np.asarray(j.data)
    t = interop.state_from_numpy(
        {n: data[i] for i, n in enumerate(s.var_names)},
        {"validtime": s.times64(), "lat": s.lat, "lon": s.lon},
        dtype="float64", device="cpu")
    return j, t


def _batch(obs):
    jb = JBatch.coerce(obs)
    return jb, interop.obs_batch_from_numpy(
        {k: getattr(jb, k) for k in _BATCH_FIELDS})


def _same_frame(got, want):
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    for c in want.columns:
        if pd.api.types.is_float_dtype(want[c]):
            np.testing.assert_allclose(got[c].to_numpy(), want[c].to_numpy(),
                                       rtol=TOL, atol=TOL, err_msg=c)
        else:
            assert got[c].tolist() == want[c].tolist(), c


def _metrics(s):
    box = dict(time_index=-1, lat_range=(43.0, 49.0),
               lon_range=(232.0, 242.0))
    return {
        "array": lambda mod, st: np.asarray(st.data[0, 1, 2, 3, :]) * 2.0,
        "region, all times": lambda mod, st: mod.region_mean_metric(
            s.var_names[-1]),
        "region box": lambda mod, st: mod.region_mean_metric(
            s.var_names[0], **box),
    }


@pytest.mark.parametrize("metric", ["array", "region, all times",
                                    "region box"])
@pytest.mark.parametrize("unbiased,confidence", [(True, 0.95),
                                                 (False, None)])
def test_ensemble_sensitivity_matches_jax(metric, unbiased, confidence):
    j, t = _state(nvars=2, ntimes=2, ny=5, nx=7, nmems=15, seed=2)
    make = _metrics(j.structure)[metric]
    jm, tm = make(jsens, j), make(tsens, t)
    np.testing.assert_allclose(tsens.metric_values(t, tm),
                               jsens.metric_values(j, jm), rtol=TOL, atol=TOL)
    want = jsens.ensemble_sensitivity(j, jm, unbiased=unbiased,
                                      confidence=confidence)
    got = tsens.ensemble_sensitivity(t, tm, unbiased=unbiased,
                                     confidence=confidence)
    assert got.keys() == want.keys()
    for v in want:
        assert got[v].keys() == want[v].keys()
        for k, w in want[v].items():
            assert got[v][k].shape == (2, 5, 7)
            if k == "significant":
                np.testing.assert_array_equal(got[v][k], w)
            else:
                np.testing.assert_allclose(got[v][k], w, rtol=TOL, atol=TOL,
                                           err_msg=f"{v} {k}")


def test_linear_metric_exact_recovery():
    """J = 2 x_p + 5: slope exactly 2 and correlation exactly 1 at p,
    significance fires, and a tensor metric is taken as it is."""
    _, t = _state(ntimes=2, ny=5, nx=7, nmems=25, seed=0)
    j = 2.0 * t.data[0, 1, 2, 3, :] + 5.0
    f = tsens.ensemble_sensitivity(t, j, confidence=0.95)[
        t.structure.var_names[0]]
    np.testing.assert_allclose(f["sensitivity"][1, 2, 3], 2.0, rtol=1e-10)
    np.testing.assert_allclose(f["correlation"][1, 2, 3], 1.0, rtol=1e-10)
    assert bool(f["significant"][1, 2, 3])
    assert np.all(np.abs(f["correlation"]) <= 1.0 + 1e-12)


def test_metric_validation():
    _, t = _state(nvars=2, nmems=15, seed=2)
    s = t.structure
    with pytest.raises(ValueError, match="one value per member"):
        tsens.metric_values(t, np.zeros(3))
    with pytest.raises(ValueError, match="no grid points"):
        tsens.region_mean_metric(s.var_names[0], lat_range=(99.0, 100.0))(t)
    j = tsens.region_mean_metric(s.var_names[0], time_index=1)(t)
    assert isinstance(j, np.ndarray) and j.shape == (15,)


def _candidates(j):
    """Candidate obs for ``j``'s grid: 9 inside its domain, a sharper copy
    of the first, and one outside its time range."""
    s = j.structure
    obs = make_demo_obs(j, nobs=9, seed=6, radius=1500.0)
    good = obs[0]
    obs.append(JObservation(
        value=good.value, obtype=good.obtype, time=good.time,
        error=good.error / 16.0, lat=good.lat, lon=good.lon,
        assimilate_this=True, localize_radius=good.localize_radius))
    obs.append(JObservation(
        value=280.0, obtype=s.var_names[0],
        time=timeutil.to_datetime64(int(s.times_s[-1]) + 10 * 86400),
        error=1.0, lat=float(s.lat.mean()), lon=float(s.lon.mean()),
        assimilate_this=True, localize_radius=2000.0))
    return obs


@pytest.mark.parametrize("unbiased", [True, False])
def test_observation_impact_matches_jax(unbiased):
    j, t = _state(nmems=16, seed=5)
    jb, tb = _batch(_candidates(j))
    name = j.structure.var_names[0]
    want = jsens.observation_impact(j, jb, jsens.region_mean_metric(name),
                                    unbiased=unbiased)
    got = tsens.observation_impact(t, tb, tsens.region_mean_metric(name),
                                   unbiased=unbiased)
    _same_frame(got, want)
    assert not got["qc_ok"].iloc[-1] and np.isnan(got["dJ_var_pred"].iloc[-1])
    assert got["dJ_var_pred"].iloc[9] <= got["dJ_var_pred"].iloc[0] + 1e-15


@pytest.mark.parametrize("unbiased", [True, False])
def test_greedy_selection_matches_jax(unbiased):
    j, t = _state(ntimes=2, ny=6, nx=8, nmems=20, seed=7)
    jb, tb = _batch(_candidates(j))
    name = j.structure.var_names[0]
    want = jsens.greedy_obs_selection(
        j, jb, jsens.region_mean_metric(name, time_index=1), nselect=5,
        unbiased=unbiased)
    got = tsens.greedy_obs_selection(
        t, tb, tsens.region_mean_metric(name, time_index=1), nselect=5,
        unbiased=unbiased)
    _same_frame(got, want)
    rank = tsens.observation_impact(
        t, tb, tsens.region_mean_metric(name, time_index=1),
        unbiased=unbiased)
    assert int(got["candidate"].iloc[0]) == int(rank["dJ_var_pred"].idxmin())
    with pytest.raises(ValueError, match="nselect"):
        tsens.greedy_obs_selection(
            t, tb, tsens.region_mean_metric(name), nselect=0)


@pytest.mark.parametrize("unbiased", [True, False])
def test_predictions_equal_the_serial_update(unbiased):
    """One unlocalized ob: the predicted mean change (and, with matched
    ddof, the variance change) is what the port's EnSRF realizes; greedy's
    cumulative prediction over 4 picks is what the EnSRF realizes on the
    picks in pick order."""
    _, t = _state(ntimes=2, ny=6, nx=8, nmems=20, seed=7)
    _, tb = _batch(make_demo_obs(make_demo_state(ntimes=2, ny=6, nx=8,
                                                 nmems=20, seed=7),
                                 nobs=12, seed=8))
    metric = tsens.region_mean_metric(t.structure.var_names[0], time_index=1)
    j0 = tsens.metric_values(t, metric)
    cfg = FilterConfig(localization=None, dtype="float64",
                       unbiased_variance=unbiased)

    one = tsens.observation_impact(t, tb.take([0]), metric, unbiased=unbiased)
    post, _ = EnSRF(t, tb.take([0]), config=cfg, verbose=False).update()
    j1 = tsens.metric_values(post, metric)
    np.testing.assert_allclose(one["dJ_mean_pred"].iloc[0],
                               j1.mean() - j0.mean(), rtol=1e-9, atol=1e-12)

    sel = tsens.greedy_obs_selection(t, tb, metric, nselect=4,
                                     unbiased=unbiased)
    assert sel["candidate"].is_unique and (sel["dJ_var_step"] <= 1e-15).all()
    post, _ = EnSRF(t, tb.take(sel["candidate"].to_numpy()), config=cfg,
                    verbose=False).update()
    j4 = tsens.metric_values(post, metric)
    np.testing.assert_allclose(sel["dJ_mean_cum"].iloc[-1],
                               j4.mean() - j0.mean(), rtol=1e-9, atol=1e-12)
    if unbiased:
        np.testing.assert_allclose(one["dJ_var_pred"].iloc[0],
                                   np.var(j1, ddof=1) - np.var(j0, ddof=1),
                                   rtol=1e-9, atol=1e-14)
        np.testing.assert_allclose(sel["dJ_var_cum"].iloc[-1],
                                   np.var(j4, ddof=1) - np.var(j0, ddof=1),
                                   rtol=1e-9, atol=1e-14)


def test_reductions_stay_on_the_state_device(monkeypatch):
    """Only [M], [Ns] and [No] vectors leave the state's device: the
    state's [Ns, M] tensor is never copied to the host."""
    _, t = _state(nmems=16, seed=5)
    big = t.data.numel()
    moved = []
    real = torch.Tensor.cpu

    def spy(self, *a, **k):
        moved.append(self.numel())
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    metric = tsens.region_mean_metric(t.structure.var_names[0])
    tsens.ensemble_sensitivity(t, metric)
    assert moved and max(moved) < big
