"""The port's examples (``efa_xray_tpu_torch.examples``) against the JAX
package's scripts (``examples/``), on the CPU.

Each case runs the JAX script through its ``main()`` (``sys.argv`` set,
its standard output captured) and the port's counterpart through
``main([..., "--device", "cpu"])``, from the same inputs:

* the NumPy-seeded ones (``gefs_like_state``, the obs, the point
  forecast) are built by each package from the same seeds; the JAX script
  builds its states in float32 here too, as it does when run on its own
  (the test process runs JAX with x64 enabled, which would make them
  float64);
* where the JAX script draws with ``jax.random`` the port's ``inputs`` is
  replaced by the JAX draws: the Lorenz-96 spin-up (``cycling_*``) and the
  shallow-water members (``multivariate_swe``); the EnKF's perturbation
  table is patched in as ``tests/test_torch_enkf.py`` does.

The JAX script's numbers are read from what its library calls return
(spies on them), the port's from ``run``.  The float64 examples
(sensitivity targeting, both cycling scripts) agree at 1e-9 on every
number; the float32 ones at the f32 gate of ``tests/test_pallas_kernel.py``
(rtol 2e-5 / atol 2e-4) on the states, the obs-space tables and every
printed number.  The printed lines agree text for text outside their
numbers; the timing line is left out, and the reprs of the state and the
mesh are the port's own (a torch dtype and the device; the mesh's devices).
"""

import copy
import dataclasses
import functools
import re
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efa_xray_tpu.assimilation import enkf as jenkf
from efa_xray_tpu.assimilation.enkf import EnKF as JEnKF
from efa_xray_tpu.assimilation.ensrf import EnSRF as JEnSRF
from efa_xray_tpu.assimilation.letkf import LETKF as JLETKF
from efa_xray_tpu.postprocess import desroziers_diagnostics as jdesroziers
from efa_xray_tpu.postprocess import obs_assimilation_statistics as jstats
from efa_xray_tpu.utils import demo_data as jdemo
from efa_xray_tpu_torch.assimilation import enkf as tenkf
from efa_xray_tpu_torch.examples import (
    cycling_adaptive,
    cycling_smoother,
    efa_demo,
    gridded_assimilation,
    interactive_viewer,
    multivariate_swe,
    obs_pipeline,
    real_data_ingest,
    sensitivity_targeting,
)
from efa_xray_tpu_torch.interop import to_host
from efa_xray_tpu_torch.utils import demo_data as tdemo

RTOL32, ATOL32 = 2e-5, 2e-4
TOL64 = 1e-9
PORT = {m.__name__.rsplit(".", 1)[1]: m for m in (
    cycling_adaptive, cycling_smoother, efa_demo, gridded_assimilation,
    interactive_viewer, multivariate_swe, obs_pipeline, real_data_ingest,
    sensitivity_targeting)}


def _jax_script(name):
    import os

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import importlib

    return importlib.import_module(f"examples.{name}")


def _spy(monkeypatch, owner, attr, keep):
    """Wrap ``owner.attr`` so that each call's result is appended to
    ``keep``."""
    fn = getattr(owner, attr)

    @functools.wraps(fn)
    def wrapped(*a, **k):
        out = fn(*a, **k)
        keep.append(out)
        return out

    monkeypatch.setattr(owner, attr, wrapped)
    return keep


def _spy_method(monkeypatch, cls, attr, keep):
    """As :func:`_spy` on a method, recording ``(self, result)``."""
    fn = getattr(cls, attr)

    def wrapped(self, *a, **k):
        out = fn(self, *a, **k)
        keep.append((self, out))
        return out

    monkeypatch.setattr(cls, attr, wrapped)
    return keep


def _run_jax(monkeypatch, capsys, name, argv):
    jmod = _jax_script(name)
    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    capsys.readouterr()
    rc = jmod.main()
    return rc, capsys.readouterr().out


def _run_port(monkeypatch, capsys, name, argv, inputs=None):
    """The port's ``main`` on the CPU: ``(rc, stdout, run's result)``;
    ``inputs`` replaces the port's ``inputs`` function."""
    pmod = PORT[name]
    if inputs is not None:
        monkeypatch.setattr(pmod, "inputs", inputs)
    got = _spy(monkeypatch, pmod, "run", []) if hasattr(pmod, "run") else []
    capsys.readouterr()
    rc = pmod.main(list(argv) + ["--device", "cpu"])
    return rc, capsys.readouterr().out, (got[-1] if got else None)


_NUMBER = re.compile(r"[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?")
_REPRS = ((re.compile(r"dtype=torch\."), "dtype="),
          (re.compile(r", device=[\w:]+\)"), ")"),
          (re.compile(r"^mesh: .*$"), "mesh:"))


def _text(out, drop=("update: ",)):
    """Printed lines without their numbers (runs of blanks as one, the
    reprs of the state and mesh reduced to what both packages print),
    timing lines dropped."""
    lines = []
    for line in out.splitlines():
        if any(line.startswith(p) for p in drop):
            continue
        for pat, rep in _REPRS:
            line = pat.sub(rep, line)
        lines.append(" ".join(_NUMBER.sub("#", line).split()))
    return lines


def _same_text(jout, pout, **kw):
    assert _text(jout, **kw) == _text(pout, **kw)
    assert _text(pout, **kw), "nothing printed"


def _close(got, want, tol, what):
    got = np.asarray(to_host(got), dtype=np.float64)
    want = np.asarray(to_host(want), dtype=np.float64)
    assert got.shape == want.shape, what
    rtol, atol = (RTOL32, ATOL32) if tol == 32 else (TOL64, TOL64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _same_table(got, want, tol, what):
    """Two DataFrames: the same columns, index and text columns, numeric
    columns at ``tol``."""
    assert list(got.columns) == list(want.columns), what
    assert list(got.index) == list(want.index), what
    for col in got.columns:
        g, w = got[col].to_numpy(), want[col].to_numpy()
        if g.dtype.kind in "fi" and w.dtype.kind in "fi":
            _close(g, w, tol, f"{what}: {col}")
        else:
            assert list(g) == list(w), f"{what}: {col}"


def _float32_states(monkeypatch, jmod):
    """The JAX script's ``gefs_like_state`` in float32 unless it asks for
    a dtype (what it builds when run on its own, without x64)."""
    monkeypatch.setattr(jmod, "gefs_like_state",
                        functools.partial(jdemo.gefs_like_state,
                                          dtype="float32"))


def _jax_letkf_float64(monkeypatch):
    """Record how the JAX script builds its LETKF; the function returned
    runs that LETKF again in float64 on the same inputs (state, obs,
    options): ``(prior, posterior, batch)``."""
    made = []
    init = JLETKF.__init__

    def record(self, state, obs, *a, **k):
        made.append((state, copy.deepcopy(obs), a, dict(k)))
        init(self, state, obs, *a, **k)

    monkeypatch.setattr(JLETKF, "__init__", record)

    def float64():
        state, obs, a, k = made[0]
        k.update(config=dataclasses.replace(k["config"], dtype="float64"),
                 mesh=None)
        state = state.astype(jnp.float64)
        return (state,) + JLETKF(state, obs, *a, **k).update()

    return float64


def _letkf_close(got, want, exact, what):
    """A float32 LETKF result against the JAX package's.  The
    Newton-Schulz inverse square root leaves each package's float32
    posterior up to ~5e-2 K from the float64 LETKF (``exact``) in a few
    patches, not the same ones in both, which the f32 gate cannot hold;
    so the port's is held no farther from the float64 LETKF than the JAX
    package's: in max abs (plus the gate's atol) and, over an array, in
    RMS unless it is inside the f32 gate of the float64 LETKF
    everywhere."""
    g, w, x = (np.asarray(to_host(v), np.float64) for v in (got, want, exact))
    assert g.shape == w.shape == x.shape, what
    eg, ew = np.abs(g - x), np.abs(w - x)
    assert eg.max() <= ew.max() + ATOL32, (what, eg.max(), ew.max())
    if g.size > 1:
        rg, rw = np.sqrt(np.mean(eg ** 2)), np.sqrt(np.mean(ew ** 2))
        assert rg <= rw or (eg <= ATOL32 + RTOL32 * np.abs(x)).all(), (
            what, rg, rw)


def _same_letkf_table(got, want, exact, post_columns, what):
    """:func:`_same_table` with the columns that depend on the posterior
    held by :func:`_letkf_close`."""
    _same_table(got.drop(columns=post_columns),
                want.drop(columns=post_columns), 32, what)
    for col in post_columns:
        _letkf_close(got[col].to_numpy(), want[col].to_numpy(),
                     exact[col].to_numpy(), f"{what}: {col}")


@pytest.mark.parametrize("kw", [
    dict(), dict(ny=40, nx=60, nmems=30, ntimes=1),
    dict(ntimes=8, nmems=21, seed=3, dtype="float64"),
    dict(ny=361, nx=720, nmems=2, ntimes=2)],
    ids=["gridded", "pipeline", "sensitivity", "config 2's grid"])
def test_gefs_like_state_is_the_jax_package_s_bit_for_bit(kw):
    """The port's ``gefs_like_state`` takes each mode's sines on the 1-D
    axes (the JAX package's on the 2-D grid): the same truth and members,
    bit for bit, at the examples' shapes and on config 2's grid."""
    kw = dict({"dtype": "float32"}, **kw)
    jstate, jtruth = jdemo.gefs_like_state(**kw)
    state, truth = tdemo.gefs_like_state(device="cpu", **kw)
    np.testing.assert_array_equal(truth, jtruth)
    np.testing.assert_array_equal(state.data.numpy(),
                                  np.asarray(jstate.data))


# --- 1. gridded_assimilation ------------------------------------------------

@pytest.mark.parametrize("opts", [[], ["--solver", "letkf"], ["--mesh"]],
                         ids=["ensrf", "letkf", "mesh"])
def test_gridded_assimilation_matches_jax(monkeypatch, capsys, opts):
    """The default network (33 x 49 x 8 leads x 21 members, 200 obs) through
    the EnSRF, the LETKF and a mesh (the JAX side on its 8 virtual CPU
    devices, the port's a mesh of the CPU): the posterior, the statistics
    table and the four RMSEs; the LETKF's posterior terms by
    :func:`_letkf_close`."""
    jmod = _jax_script("gridded_assimilation")
    float64 = _jax_letkf_float64(monkeypatch)
    _float32_states(monkeypatch, jmod)
    states = _spy(monkeypatch, jmod, "gefs_like_state", [])
    updates = []
    for cls in (JEnSRF, JLETKF):
        _spy_method(monkeypatch, cls, "update", updates)
    tables = _spy(monkeypatch, jmod, "obs_assimilation_statistics", [])
    _, jout = _run_jax(monkeypatch, capsys, "gridded_assimilation", opts)
    _, pout, res = _run_port(monkeypatch, capsys, "gridded_assimilation",
                             opts)
    _same_text(jout, pout)
    (jstate, truth), = states
    (_, (jpost, _)), = updates
    df, = tables
    tr = np.transpose(truth, (3, 0, 1, 2))

    def numbers(state, post, df):
        rmse = lambda a, b: np.sqrt(np.mean((a - b) ** 2))
        return dict(
            obs_rmse_prior=rmse(df["value"], df["prior mean"]),
            obs_rmse_post=rmse(df["value"], df["post mean"]),
            field_rmse_prior=rmse(np.asarray(state.ensemble_mean()), tr),
            field_rmse_post=rmse(np.asarray(post.ensemble_mean()), tr))

    want = numbers(jstate, jpost, df)
    if "letkf" in opts:
        state64, post64, batch64 = float64()
        exact = numbers(state64, post64, jstats(state64, post64, batch64))
        _letkf_close(res["post"].data, jpost.data, post64.data, "posterior")
        _same_letkf_table(res["stats"], df, jstats(state64, post64, batch64),
                          ["post mean", "post variance"], "statistics")
        for k in ("obs_rmse_post", "field_rmse_post"):
            _letkf_close(res[k], want.pop(k), exact[k], k)
    else:
        _close(res["post"].data, jpost.data, 32, "posterior")
        _same_table(res["stats"], df, 32, "statistics")
    for k, v in want.items():
        _close(res[k], v, 32, k)
    assert (res["mesh"] is not None) == ("--mesh" in opts)


# --- 2. obs_pipeline --------------------------------------------------------

@pytest.mark.parametrize("solver", ["ensrf", "enkf", "letkf"])
def test_obs_pipeline_matches_jax(monkeypatch, capsys, solver):
    """600 raw obs with duplicate clusters, superob + thinning + the
    spatial sort, then each solver with ``fast_geometry`` and
    ``spatial_sort`` in float32; the EnKF with the JAX perturbation table
    (its threefry draws cannot be matched): the thinned batch, the
    posterior, its obs diagnostics and the Desroziers table, and the
    netCDF round trip; the LETKF's posterior terms by
    :func:`_letkf_close`."""
    def draw(seed, errors, nmems, scale=True):
        eps = jenkf.draw_ob_perturbations(
            jax.random.PRNGKey(seed), jnp.asarray(to_host(errors)), nmems,
            scale=scale)
        return torch.as_tensor(np.array(eps), dtype=errors.dtype,
                               device=errors.device)

    monkeypatch.setattr(tenkf, "draw_ob_perturbations", draw)
    jmod = _jax_script("obs_pipeline")
    float64 = _jax_letkf_float64(monkeypatch)
    _float32_states(monkeypatch, jmod)
    updates = []
    for cls in (JEnSRF, JEnKF, JLETKF):
        _spy_method(monkeypatch, cls, "update", updates)
    tables = _spy(monkeypatch, jmod, "desroziers_diagnostics", [])
    argv = ["--solver", solver]
    _, jout = _run_jax(monkeypatch, capsys, "obs_pipeline", argv)
    _, pout, res = _run_port(monkeypatch, capsys, "obs_pipeline", argv)
    _same_text(jout, pout)
    (_, (jpost, jout_batch)), = updates
    out = res["out"]
    for f in ("values", "lats", "lons", "errors"):
        _close(getattr(out, f), getattr(jout_batch, f), 64, f)
    for f in ("prior_mean", "prior_var"):
        _close(getattr(out, f), getattr(jout_batch, f), 32, f)
    assert np.array_equal(out.assimilated, jout_batch.assimilated)
    assert res["nobs_thinned"] == jout_batch.nobs
    if solver == "letkf":
        state64, post64, batch64 = float64()
        _letkf_close(res["post"].data, jpost.data, post64.data, "posterior")
        for f in ("post_mean", "post_var"):
            _letkf_close(getattr(out, f), getattr(jout_batch, f),
                         getattr(batch64, f), f)
        _same_letkf_table(
            res["desroziers"], tables[0],
            jdesroziers(jstats(state64, post64, batch64)),
            ["R_estimated", "R_ratio"], "Desroziers")
    else:
        _close(res["post"].data, jpost.data, 32, "posterior")
        for f in ("post_mean", "post_var"):
            _close(getattr(out, f), getattr(jout_batch, f), 32, f)
        _same_table(res["desroziers"], tables[0], 32, "Desroziers")


# --- 3. sensitivity_targeting -----------------------------------------------

def test_sensitivity_targeting_matches_jax(monkeypatch, capsys):
    """The float64 workflow at its defaults (8 leads x 33 x 49 x 21
    members, 200 candidates): the metric, the sensitivity map and its mask,
    the impact table, the pick, and the realized change in J, at 1e-9."""
    jmod = _jax_script("sensitivity_targeting")
    metrics = []

    def metric(*a, **k):
        J = jmod_region_mean_metric(*a, **k)
        return lambda state: metrics.append(J(state)) or metrics[-1]

    jmod_region_mean_metric = jmod.region_mean_metric
    monkeypatch.setattr(jmod, "region_mean_metric", metric)
    sens = _spy(monkeypatch, jmod, "ensemble_sensitivity", [])
    impact = _spy(monkeypatch, jmod, "observation_impact", [])
    updates = _spy_method(monkeypatch, JEnSRF, "update", [])
    _, jout = _run_jax(monkeypatch, capsys, "sensitivity_targeting", [])
    _, pout, res = _run_port(monkeypatch, capsys, "sensitivity_targeting", [])
    _same_text(jout, pout)
    j0, j1 = metrics[0], metrics[-1]
    imp = impact[0]
    best = int(imp["dJ_var_pred"].idxmin())
    row = imp.iloc[best]
    jsens = sens[0]["T2m"]
    assert res["best"] == best
    _same_table(res["impact"], imp, 64, "impact")
    for k in ("sensitivity", "covariance", "correlation"):
        _close(res["sens"][k], jsens[k], 64, k)
    assert np.array_equal(res["sens"]["significant"], jsens["significant"])
    want = dict(j0_mean=j0.mean(), j0_spread=j0.std(ddof=1),
                frac_sig=jsens["significant"].mean(axis=(1, 2)),
                best_lat=row["lat"], best_lon=row["lon"],
                dj_var_pred=row["dJ_var_pred"],
                dj_mean_pred=row["dJ_mean_pred"],
                dj_realized=j1.mean() - j0.mean(),
                var_j0=np.var(j0, ddof=1), var_j1=np.var(j1, ddof=1))
    for k, v in want.items():
        _close(res[k], v, 64, k)
    (_, (jpost, _)), = updates
    assert np.asarray(jpost.data).dtype == np.float64


# --- 8. efa_demo ------------------------------------------------------------

def test_efa_demo_matches_jax(monkeypatch, capsys, tmp_path):
    """The one-location trajectory update over 5 early-lead obs,
    unlocalized: the posterior trajectory and both variance rows, and the
    figure written."""
    updates = _spy_method(monkeypatch, JEnSRF, "update", [])
    _, jout = _run_jax(monkeypatch, capsys, "efa_demo",
                       ["--out", str(tmp_path / "jax.png")])
    _, pout, res = _run_port(monkeypatch, capsys, "efa_demo",
                             ["--out", str(tmp_path / "port.png")])
    _same_text(jout.replace("jax.png", "x.png"),
               pout.replace("port.png", "x.png"))
    (jfilt, (jpost, _)), = updates
    var = efa_demo.VAR
    jprior = np.asarray(jfilt.prior[var])[:, 0, 0, :]
    jpost_arr = np.asarray(jpost[var])[:, 0, 0, :]
    _close(res["prior_arr"], jprior, 32, "prior")
    _close(res["post_arr"], jpost_arr, 32, "posterior")
    _close(res["prior_var"], jprior.var(axis=1)[:7].round(3), 32, "prior var")
    _close(res["post_var"], jpost_arr.var(axis=1)[:7].round(3), 32,
           "post var")
    assert (tmp_path / "port.png").stat().st_size > 0


# --- 9. interactive_viewer --------------------------------------------------

def test_interactive_viewer_matches_jax(monkeypatch, capsys, tmp_path):
    """One headless frame at the defaults: the trajectories it draws."""
    from efa_xray_tpu.postprocess import viewer as jviewer
    from efa_xray_tpu_torch.postprocess import viewer as tviewer

    jdrawn = _spy(monkeypatch, jviewer, "_run_point_efa", [])
    tdrawn = _spy(monkeypatch, tviewer, "_run_point_efa", [])
    _, jout = _run_jax(monkeypatch, capsys, "interactive_viewer",
                       ["--save", str(tmp_path / "v.png")])
    _, pout, _ = _run_port(monkeypatch, capsys, "interactive_viewer",
                           ["--save", str(tmp_path / "v.png")])
    _same_text(jout, pout)
    (jt, jprior, jpost, jot, jov), = jdrawn
    (tt, tprior, tpost, tot, tov), = tdrawn
    assert np.array_equal(np.asarray(tt), np.asarray(jt))
    _close(tprior, jprior, 32, "prior")
    _close(tpost, jpost, 32, "posterior")
    _close(tov, jov, 64, "obs")


# --- no silent CPU fallback ---------------------------------------------------

@pytest.mark.parametrize("name", sorted(PORT))
def test_examples_raise_without_a_card(name, tmp_path, monkeypatch):
    """Without ``--device cpu`` every example asks for the card, and on a
    host without one it raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"real_data_ingest": ["--workdir", str(tmp_path / "w")],
            "efa_demo": ["--out", str(tmp_path / "x.png")],
            "interactive_viewer": ["--save", str(tmp_path / "x.png")]}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT[name].main(argv.get(name, []))
    assert not (tmp_path / "w").exists()
