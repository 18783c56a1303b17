"""The slice end to end: the port's public API against the JAX package's on
the same NumPy inputs (float64, CPU, where the kernels' plain versions
run), the paths that must refuse, and the package's independence from
JAX."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from conftest import make_demo_obs, make_demo_state
from efa_xray_tpu.assimilation.ensrf import EnSRF as JEnSRF
from efa_xray_tpu.config import FilterConfig as JConfig
from efa_xray_tpu.observation import forward as jfwd
from efa_xray_tpu.observation.observation import ObservationBatch as JBatch
from efa_xray_tpu.postprocess.postprocess import (
    obs_assimilation_statistics as j_stats,
)
from efa_xray_tpu.state.structure import StateStructure as JStructure
from efa_xray_tpu_torch import EnSRF, FilterConfig, interop
from efa_xray_tpu_torch import obs_assimilation_statistics as t_stats
from efa_xray_tpu_torch.observation import forward as tfwd
from efa_xray_tpu_torch.ops import ensrf_fused, tail_solve
from efa_xray_tpu_torch.state.structure import StateStructure

TOL = 1e-9
_BATCH_FIELDS = ("values", "errors", "lats", "lons", "times_s", "obtypes",
                 "localize_radius", "assimilate_flags", "verts",
                 "descriptions", "vert_radius")


def _pair(ntimes=1, nobs=19, seed=5, nvars=1, all_assim=False):
    """The same state and obs, as JAX objects and as port objects."""
    jstate = make_demo_state(nvars=nvars, ntimes=ntimes, ny=9, nx=11,
                             nmems=12, seed=seed)
    jbatch = JBatch.coerce(make_demo_obs(jstate, nobs=nobs, seed=seed + 1,
                                         radius=600.0, all_assim=all_assim))
    s = jstate.structure
    data = np.asarray(jstate.data)
    tstate = interop.state_from_numpy(
        {name: data[i] for i, name in enumerate(s.var_names)},
        {"validtime": s.times64(), "lat": s.lat, "lon": s.lon},
        dtype="float64", device="cpu")
    tbatch = interop.obs_batch_from_numpy(
        {k: getattr(jbatch, k) for k in _BATCH_FIELDS})
    return jstate, jbatch, tstate, tbatch


def _compare_updates(jcfg, tcfg, **pair_kw):
    jstate, jbatch, tstate, tbatch = _pair(**pair_kw)
    jpost, jobs = JEnSRF(jstate, jbatch, config=jcfg, verbose=False).update()
    tpost, tobs = EnSRF(tstate, tbatch, config=tcfg, verbose=False).update()
    np.testing.assert_allclose(interop.state_to_numpy(tpost),
                               np.asarray(jpost.data), rtol=TOL, atol=TOL)
    jobs.materialize_diagnostics()
    for name in ("prior_mean", "prior_var", "post_mean", "post_var"):
        a, b = getattr(tobs, name), np.asarray(getattr(jobs, name))
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a[~np.isnan(a)], b[~np.isnan(b)],
                                   rtol=TOL, atol=TOL, err_msg=name)
    np.testing.assert_array_equal(tobs.assimilated, jobs.assimilated)
    return jpost, jobs, tpost, tobs, tstate


@pytest.mark.parametrize("tail_panel,block_size", [(8, 4), (16, 3)])
def test_update_kernel_route_matches_jax_pallas(tail_panel, block_size):
    """vt = 1, blocked, fast geometry: the port's B1/B2 route (plain
    versions on the CPU) against the JAX Pallas route (interpret mode)."""
    kw = dict(localization="GC", dtype="float64", fast_geometry=True,
              tail_panel=tail_panel, block_size=block_size)
    jpost, jobs, tpost, tobs, tstate = _compare_updates(
        JConfig(use_pallas=True, tail_pallas=True, **kw), FilterConfig(**kw))
    assert tail_solve.launches == 0 and ensrf_fused.launches == 0
    # obs-space statistics agree too
    jdf = j_stats(make_demo_state(ntimes=1, ny=9, nx=11, nmems=12, seed=5),
                  jpost, jobs)
    tdf = t_stats(tstate, tpost, tobs)
    for col in ("prior mean", "post mean", "prior variance", "post variance"):
        np.testing.assert_allclose(tdf[col].to_numpy(), jdf[col].to_numpy(),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("method", ["serial", "blocked"])
def test_update_plain_paths_match_jax(method):
    """Serial, and exact-haversine blocked (the plain path on the CPU), on
    a gridded vt > 1 state."""
    kw = dict(localization="GC", dtype="float64", method=method,
              block_size=5)
    _compare_updates(JConfig(use_pallas=False, **kw), FilterConfig(**kw),
                     ntimes=2, nvars=2)


def test_update_with_inflation_and_outlier_check_matches_jax():
    kw = dict(localization="GC", dtype="float64", fast_geometry=True,
              tail_panel=8, block_size=4, outlier_threshold=1.5)
    jstate, jbatch, tstate, tbatch = _pair(all_assim=True)
    jpost, jobs = JEnSRF(jstate, jbatch, inflation=1.3, verbose=False,
                         config=JConfig(use_pallas=True, tail_pallas=True,
                                        **kw)).update()
    tpost, tobs = EnSRF(tstate, tbatch, inflation=1.3, verbose=False,
                        config=FilterConfig(**kw)).update()
    np.testing.assert_allclose(interop.state_to_numpy(tpost),
                               np.asarray(jpost.data), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tobs.qc_outlier, jobs.qc_outlier)
    assert tobs.qc_outlier.any()


@pytest.mark.parametrize("kw", [
    dict(config=FilterConfig(dtype="float64",
                             matmul_precision="tensorfloat32")),
    dict(config=FilterConfig(dtype="float64", matmul_precision="bfloat16")),
    dict(config=FilterConfig(dtype="float64", matmul_precision="high")),
])
def test_unported_paths_raise(kw):
    """What raised until the product modes were ported now runs: products
    below fp32 leave a float64 update on the CPU in fp32, the default
    config's posterior bit for bit (every value and solver:
    ``tests/test_torch_precision_modes.py``).  Nothing of the EnSRF's
    configuration raises ``NotImplementedError`` any more (RTPS/RTPP,
    ``obs_order``, ``spatial_sort`` and ``obs_chunk``:
    ``tests/test_torch_ensrf_options.py``; inflation from a file:
    ``tests/test_torch_inflation_files.py``; ``mesh=``:
    ``tests/test_torch_sharded.py``)."""
    _, _, tstate, tbatch = _pair()
    post, _ = EnSRF(tstate, tbatch, verbose=False, **kw).update()
    ref, _ = EnSRF(tstate, tbatch, verbose=False,
                   config=FilterConfig(dtype="float64")).update()
    np.testing.assert_array_equal(interop.state_to_numpy(post),
                                  interop.state_to_numpy(ref))


def test_exact_haversine_raises_on_cuda_and_mesh_raises():
    """Exact haversine on CUDA no longer raises: a CUDA-routed default
    config selects B4, with the kernel tail (B1, then B4) (routing only;
    nothing runs).  ``mesh=`` runs (``tests/test_torch_sharded.py``) and
    raises only with a positive ``obs_chunk``, as in the JAX package."""
    from efa_xray_tpu_torch.parallel import make_mesh

    _, _, tstate, tbatch = _pair()
    filt = EnSRF(tstate, tbatch, verbose=False,
                 config=FilterConfig(dtype="float32", fast_geometry=False))
    filt.device = torch.device("cuda")
    assert filt._route(tstate.structure.nstate) == "B4"
    assert filt._tail_kernels()
    with pytest.raises(ValueError, match="single-device"):
        EnSRF(tstate, tbatch, mesh=make_mesh(["cpu"] * 2), verbose=False,
              config=FilterConfig(dtype="float64", obs_chunk=4)).update()


@pytest.mark.parametrize("dtype,cuda,route", [
    ("float64", True, "plain"), ("float32", True, "B4"),
    ("float64", False, "B4")])
def test_float64_on_the_card_routes_to_the_plain_update(dtype, cuda, route):
    """The kernels take float32 only: a float64 update on the card runs
    the plain blocked update, as the JAX package runs its kernels for
    float32 only; on CPU tensors float64 keeps the kernel route, whose
    plain versions the parity tests drive (routing only; nothing runs)."""
    _, _, tstate, tbatch = _pair()
    filt = EnSRF(tstate, tbatch, verbose=False,
                 config=FilterConfig(dtype=dtype, localization="GC"))
    if cuda:
        filt.device = torch.device("cuda")
    assert filt._route(tstate.structure.nstate) == route
    assert filt._tail_kernels() == (route != "plain")


@pytest.mark.parametrize("precision", [
    None, "highest", "float32", "default", "high", "bfloat16",
    "tensorfloat32"])
def test_matmul_precision_runs_fp32_and_refuses_lower(precision):
    """Every setting runs; on the CPU every one is fp32, as the JAX
    package's CPU ignores the hint, and matches the default bit for bit
    (the lower settings, which raised until the product modes were
    ported, reach the tensor cores only on the card:
    ``ops/precision.product_mode``)."""
    _, _, tstate, tbatch = _pair()
    cfg = FilterConfig(dtype="float64", localization="GC",
                       matmul_precision=precision)
    filt = EnSRF(tstate, tbatch, verbose=False, config=cfg)
    post, _ = filt.update()
    ref, _ = EnSRF(tstate, tbatch, verbose=False,
                   config=FilterConfig(dtype="float64",
                                       localization="GC")).update()
    np.testing.assert_array_equal(interop.state_to_numpy(post),
                                  interop.state_to_numpy(ref))


def test_nproc_is_the_third_positional_argument():
    """``EnSRF(state, obs, 1)`` is the reference's ``nproc=1``: accepted
    and unused, so ``inflation`` stays None and the update is the
    uninflated one."""
    jstate, jbatch, tstate, tbatch = _pair()
    filt = EnSRF(tstate, tbatch, 1, verbose=False,
                 config=FilterConfig(dtype="float64", localization="GC"))
    assert filt.inflation is None and filt.nproc == 1
    jfilt = JEnSRF(jstate, jbatch, 1, verbose=False)
    assert jfilt.inflation is None and jfilt.nproc == 1
    post, _ = filt.update()
    ref, _ = EnSRF(tstate, tbatch, verbose=False,
                   config=FilterConfig(dtype="float64",
                                       localization="GC")).update()
    np.testing.assert_array_equal(interop.state_to_numpy(post),
                                  interop.state_to_numpy(ref))


@pytest.mark.parametrize("grid", ["separable", "curvilinear"])
def test_taps_match_jax(grid):
    """Host separable search, and the exact full search (torch.topk) on a
    grid that is not a lat x lon product."""
    rng = np.random.default_rng(9)
    lat1, lon1 = np.linspace(30, 50, 12), np.linspace(230, 250, 14)
    lon, lat = np.meshgrid(lon1, lat1)
    if grid == "curvilinear":
        lat = lat + 0.3 * np.sin(np.radians(lon) * 7)
    times = np.datetime64("2026-08-01T00") + np.arange(3) * np.timedelta64(6, "h")
    args = (("T2m", "U"), times, lat, lon, 5)
    js, ts = JStructure.build(*args), StateStructure.build(*args)
    n = 17
    olat, olon = rng.uniform(31, 49, n), rng.uniform(231, 249, n)
    t0 = int((times[0] - np.datetime64("1970-01-01T00")) / np.timedelta64(1, "s"))
    ot = t0 + rng.integers(-3600, 14 * 3600, n)
    var = rng.integers(0, 2, n)
    jt = jfwd.build_taps(js, olat, olon, ot, var)
    tt = tfwd.build_taps(ts, olat, olon, ot, var)
    np.testing.assert_array_equal(tt.rows, np.asarray(jt.rows))
    np.testing.assert_allclose(tt.weights, np.asarray(jt.weights), rtol=TOL,
                               atol=TOL)
    np.testing.assert_array_equal(tt.qc_ok, jt.qc_ok)
    assert not tt.qc_ok.all()  # some obs fall outside the time range


def test_interop_roundtrip():
    _, jbatch, tstate, tbatch = _pair()
    o = dict(values=jbatch.values, errors=jbatch.errors, lats=jbatch.lats,
             lons=jbatch.lons, radii=jbatch.localize_radius,
             assim=jbatch.assimilate_flags)
    back = interop.obs_arrays_to_numpy(
        interop.obs_arrays_from_numpy(**o, device="cpu"))
    for k, v in o.items():
        np.testing.assert_array_equal(back[k], v)
    assert back["verts"] is None
    rng = np.random.default_rng(0)
    fields = dict(ye=rng.normal(size=(4, 3)), gain_coef=rng.normal(size=4),
                  sqrt_coef=rng.normal(size=4), tail_mean=rng.normal(size=4),
                  tail_perts=rng.normal(size=(4, 3)),
                  prior_mean=rng.normal(size=4), prior_var=rng.random(4),
                  post_mean=rng.normal(size=4), post_var=rng.random(4),
                  assimilated=rng.random(4) > 0.5)
    back = interop.tail_solution_to_numpy(
        interop.tail_solution_from_numpy(**fields, device="cpu"))
    for k, v in fields.items():
        np.testing.assert_array_equal(back[k], v)
    assert tstate.data.dtype == torch.float64
    assert tstate.structure.nstate == 9 * 11
    assert tbatch.nobs == jbatch.nobs


def test_port_imports_without_jax(tmp_path):
    """Every module of ``efa_xray_tpu_torch`` imports with JAX blocked, and
    none touches JAX or the JAX package, not even lazily: the CLI, whose
    commands import inside their bodies, runs ``assimilate`` end to end
    in the same process."""
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import pkgutil
        import numpy as np
        import efa_xray_tpu_torch
        from efa_xray_tpu_torch import EnsembleState, cli

        names = [m.name for m in pkgutil.walk_packages(
            efa_xray_tpu_torch.__path__, "efa_xray_tpu_torch.")]
        for name in names:
            __import__(name)
        assert "efa_xray_tpu_torch.cli" in names
        assert "efa_xray_tpu_torch.models.cycling" in names
        assert "efa_xray_tpu_torch.parallel.sharded" in names
        assert {f"efa_xray_tpu_torch.examples.{n}" for n in (
            "gridded_assimilation", "obs_pipeline", "sensitivity_targeting",
            "cycling_adaptive", "cycling_smoother", "multivariate_swe",
            "real_data_ingest", "efa_demo", "interactive_viewer")
        } <= set(names)
        rng = np.random.default_rng(0)
        lon, lat = np.meshgrid(np.linspace(230, 240, 6),
                               np.linspace(40, 48, 5))
        EnsembleState.from_vardict(
            {"T2m": rng.normal(280, 2, (1, 5, 6, 8))},
            {"validtime": np.array([np.datetime64("2026-08-01T00")]),
             "lat": lat, "lon": lon}, device="cpu").save_to_disk("prior.nc")
        with open("obs.csv", "w") as f:
            f.write("value,lat,lon,time,obtype,radius\\n"
                    "281.0,44.0,235.0,2026-08-01T00,T2m,800\\n"
                    "279.0,46.0,238.0,2026-08-01T00,T2m,800\\n")
        assert cli.main(["assimilate", "--state", "prior.nc", "--obs",
                         "obs.csv", "--out", "post.nc", "--stats",
                         "stats.csv", "--device", "cpu"]) == 0
        bad = [m for m, v in sys.modules.items() if v is not None
               and m.split(".")[0] in ("jax", "efa_xray_tpu")]
        assert not bad, bad
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
