"""The port's plotting and demo utilities, headless (Agg): the
interactive viewer (``postprocess/viewer.py``) against the JAX viewer on
the same point forecast, ``Observation.map_localization`` with the
built-in and user coastlines, and the copies ``utils/coastlines.py``,
``utils/demo_data.py``, ``utils/xarray_shim.py`` with ``utils/demo.py`` and
``utils/profiling.py``.  Mirrors ``test_localization.py``'s and
``test_postprocess.py``'s plot tests."""

import argparse
import importlib.util
import json
import os

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")

from efa_xray_tpu.postprocess.viewer import AssimilationViewer as JViewer
from efa_xray_tpu.utils import coastlines as jcoast
from efa_xray_tpu.utils import demo_data as jdemo
from efa_xray_tpu_torch import Observation
from efa_xray_tpu_torch.postprocess.viewer import (
    AssimilationViewer,
    assimilation_viewer,
)
from efa_xray_tpu_torch.utils import coastlines as tcoast
from efa_xray_tpu_torch.utils import demo, profiling, xarray_shim
from efa_xray_tpu_torch.utils import demo_data as tdemo


@pytest.fixture(autouse=True)
def _close_figures():
    """pyplot keeps every figure open; the process runs other files'
    plot tests too."""
    yield
    import matplotlib.pyplot as plt

    plt.close("all")


def test_viewer_headless_matches_jax(tmp_path):
    """update() reruns the assimilation; 0 obs gives the prior back; a
    smaller R pulls harder; the posterior is the JAX viewer's (the port
    in float32 by default, so at float32's tolerance) and a PNG saves."""
    v = assimilation_viewer(n_obs=5, device="cpu")
    assert isinstance(v, AssimilationViewer)
    post5 = v.result["post"].copy()
    j = JViewer(n_obs=5)
    np.testing.assert_allclose(post5, j.result["post"], rtol=2e-6, atol=0)
    np.testing.assert_allclose(v.result["prior"], j.result["prior"],
                               rtol=1e-7)
    v.update(n_obs=0)
    np.testing.assert_allclose(v.result["post"], v.result["prior"],
                               atol=1e-10)
    v.update(n_obs=5, ob_error=0.2)
    assert v.result["post"].var(axis=1).mean() < post5.var(axis=1).mean()
    v.save(str(tmp_path / "viewer.png"))
    assert os.path.getsize(tmp_path / "viewer.png") > 0


def _state_and_ob():
    st, _ = tdemo.gefs_like_state(ntimes=2, ny=8, nx=10, nmems=6,
                                  lat_range=(42.0, 50.0),
                                  lon_range=(230.0, 244.0), device="cpu")
    s = st.structure
    ob = Observation(value=1.0, obtype=s.var_names[0], time=s.times64()[0],
                     error=1.0, lat=float(s.lat[4, 5]),
                     lon=float(s.lon[4, 5]), localize_radius=300.0,
                     description="footprint")
    return st, ob


def test_map_localization_plot(tmp_path):
    """Peaks at the ob, reaches zero on the domain, takes a projection,
    draws the built-in coastlines wrapped to the grid's 0-360 longitudes
    with the view kept on the data, and saves a PNG."""
    st, ob = _state_and_ob()
    ax = ob.map_localization(st)
    w = np.asarray(ax.collections[0].get_array()).reshape(-1)
    assert w.max() > 0.99 and w.min() == 0.0
    np.testing.assert_allclose(np.sort(w), np.sort(ob.localize(st).ravel()))
    xd = ax.lines[0].get_xdata()
    assert np.nanmin(xd) >= 0.0 and np.nanmax(xd) < 360.0
    lo, hi = ax.get_xlim()
    assert lo >= 229.0 and hi <= 245.0
    ax.figure.savefig(str(tmp_path / "footprint.png"))
    assert os.path.getsize(tmp_path / "footprint.png") > 0
    assert len(ob.map_localization(st, coastlines=False).lines) == 0
    ax2 = ob.map_localization(st, projection=lambda lon, lat: (2 * lon,
                                                               2 * lat))
    assert ax2 is not ax


def test_map_localization_user_segments(tmp_path):
    seg = np.array([[231.0, 43.0], [240.0, 47.0], [np.nan, np.nan],
                    [235.0, 44.0], [238.0, 49.0]])
    np.savez(tmp_path / "seg.npz", lonlat=seg)
    np.testing.assert_allclose(tcoast.load_segments(str(tmp_path / "seg.npz")),
                               seg)
    st, ob = _state_and_ob()
    (line,) = ob.map_localization(st, coastlines=str(tmp_path / "seg.npz")
                                  ).lines
    assert np.nansum(line.get_ydata()) > 0
    (line2,) = ob.map_localization(
        st, projection=lambda lon, lat: (lon * 2.0, lat * 3.0),
        coastlines=seg).lines
    y = line2.get_ydata()
    np.testing.assert_allclose(y[np.isfinite(y)],
                               seg[np.isfinite(seg[:, 1]), 1] * 3.0)


def test_coastlines_copy():
    np.testing.assert_array_equal(tcoast.COARSE_WORLD_LONLAT,
                                  jcoast.COARSE_WORLD_LONLAT)
    for lon360 in (False, True):
        np.testing.assert_array_equal(
            tcoast.wrap_segments(tcoast.COARSE_WORLD_LONLAT, lon360),
            jcoast.wrap_segments(jcoast.COARSE_WORLD_LONLAT, lon360))


def test_demo_data_copy():
    """The generators draw the JAX package's numbers; the state is built
    on the device asked for, in the dtype asked for."""
    st, truth = tdemo.gefs_like_state(nvars=2, ntimes=3, ny=5, nx=7,
                                      nmems=4, dtype="float64", device="cpu")
    jst, jtruth = jdemo.gefs_like_state(nvars=2, ntimes=3, ny=5, nx=7,
                                        nmems=4, dtype="float64")
    assert st.device.type == "cpu" and st.data.dtype == torch.float64
    np.testing.assert_array_equal(st.data.numpy(), np.asarray(jst.data))
    np.testing.assert_array_equal(truth, jtruth)
    pt, jpt = tdemo.get_ensemble_point(), jdemo.get_ensemble_point()
    assert pt.keys() == jpt.keys()
    for k in pt:
        np.testing.assert_array_equal(pt[k], jpt[k])
    obs = tdemo.observations_from_truth(st, truth, nobs=4)
    jobs = jdemo.observations_from_truth(jst, jtruth, nobs=4)
    assert isinstance(obs[0], Observation)
    assert [(o.value, o.lat, o.lon, o.time) for o in obs] == \
        [(o.value, o.lat, o.lon, o.time) for o in jobs]


def test_demo_device_argument(monkeypatch):
    ap = argparse.ArgumentParser()
    demo.add_device_arg(ap)
    assert ap.parse_args([]).device == "cuda"
    assert demo.apply_device(ap.parse_args(["--device", "cpu"])) == \
        torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        demo.apply_device(ap.parse_args([]))


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    st, ob = _state_and_ob()
    logdir = str(tmp_path / "trace")
    with profiling.trace(logdir) as prof:
        with profiling.annotate("localize"):
            ob.localize(st)
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "localize" for e in events)
    assert prof.key_averages() is not None


def test_xarray_shim_gated():
    st, _ = _state_and_ob()
    if importlib.util.find_spec("xarray") is None:
        with pytest.raises(ImportError, match="xarray"):
            xarray_shim.to_xarray(st)
        with pytest.raises(ImportError, match="xarray"):
            xarray_shim.from_xarray(None, device="cpu")
    else:
        back = xarray_shim.from_xarray(xarray_shim.to_xarray(st),
                                       device="cpu")
        np.testing.assert_array_equal(back.data.numpy(), st.data.numpy())
