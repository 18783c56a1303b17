"""The stochastic EnKF's kernel route against the JAX package, in float64
on the CPU (the kernels' plain versions): B1e, the EnKF instantiation of
the tail panel solve, driven panel by panel through ``tail_scan_blocked``
with the draws, against the JAX ``enkf_tail_scan`` given the same draws
(1e-9); B2e and B4e, the body kernels with the departure rows ``z`` as a
second row operand, against ``ensrf_blocked_body(apply_rows=z)`` (1e-10); and the
whole ``EnKF(...).update()`` on that route against the JAX class with the
same draws (1e-9), and against its own serial method."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import make_demo_obs, make_demo_state
from efa_xray_tpu.assimilation import enkf as jenkf
from efa_xray_tpu.assimilation import ensrf_core as jcore
from efa_xray_tpu.config import FilterConfig as JConfig
from efa_xray_tpu.observation.observation import ObservationBatch as JBatch
from efa_xray_tpu_torch import EnKF, FilterConfig, interop
from efa_xray_tpu_torch.assimilation import enkf as tenkf
from efa_xray_tpu_torch.assimilation import ensrf_core as tcore
from efa_xray_tpu_torch.ops import ensrf_fused, ensrf_grid, tail_solve
from test_torch_varloc import _SPEC, _level_pair

TOL = 1e-9
BODY_TOL = 1e-10
VARLOC = np.array([[1.0, 0.4, 0.0], [0.4, 1.0, 0.7], [0.0, 0.7, 1.0],
                   [0.5, 0.5, 0.5]])


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)],
                               rtol=tol, atol=tol)


def _case(nobs, seed, nstate=80, nmems=12, vertical=False, varloc=False):
    """A scattered toy as NumPy: the body, the obs' tail (drawn from body
    rows), the obs (some not assimilated, one unlocalized), the draws, and
    the vertical and cross-variable inputs."""
    rng = np.random.default_rng(seed)
    lat = rng.uniform(30, 60, nstate)
    lon = rng.uniform(200, 260, nstate)
    prior = rng.normal(280, 3, (nstate, nmems))
    rows = rng.integers(0, nstate, nobs)
    ye = prior[rows] + rng.normal(0, 0.3, (nobs, nmems))
    radii = rng.uniform(800, 2500, nobs)
    radii[0] = np.inf
    o = dict(values=ye.mean(1) + rng.normal(0, 1, nobs),
             errors=rng.uniform(0.5, 2.0, nobs), lats=lat[rows],
             lons=lon[rows], radii=radii, assim=rng.random(nobs) > 0.15)
    if vertical:
        o.update(verts=rng.uniform(100, 900, nobs),
                 vert_radii=rng.choice([300.0, np.inf], nobs))
    eps = rng.normal(0, 1, (nobs, nmems))
    eps = (eps - eps.mean(1, keepdims=True)) * np.sqrt(o["errors"])[:, None]
    return dict(
        bm=prior.mean(1), bp=prior - prior.mean(1, keepdims=True),
        tm=ye.mean(1), tp=ye - ye.mean(1, keepdims=True), lat=lat, lon=lon,
        obs=o, eps=eps,
        bvert=rng.uniform(100, 900, nstate) if vertical else None,
        row_var=rng.integers(0, 3, nstate) if varloc else None,
        ob_var=rng.integers(0, 3, nobs) if varloc else None)


def _jobs(c):
    return jcore.ObsArrays(**{k: jnp.asarray(v) for k, v in c["obs"].items()})


def _tobs(c):
    return interop.obs_arrays_from_numpy(**c["obs"], dtype="float64",
                                         device="cpu")


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _vl(c, port: bool):
    if c["ob_var"] is None:
        return {}
    cv = (lambda x: _t(x)) if port else (lambda x: jnp.asarray(x))
    return dict(varloc=cv(VARLOC), ob_var=cv(c["ob_var"]))


TAIL_CASES = [
    dict(localize=True),
    dict(localize=False),
    dict(localize=True, fast_geometry=True),
    dict(localize=True, vertical=True),
    dict(localize=True, fast_geometry=True, vertical=True),
    dict(localize=True, varloc=True),
    dict(localize=True, unbiased=True),
]


@pytest.mark.parametrize("panel,nobs", [(4, 9), (8, 25), (8, 8)])
@pytest.mark.parametrize("kw", TAIL_CASES)
def test_b1e_tail_matches_jax_enkf_tail_scan(kw, panel, nobs):
    """The kernel route's tail (B1e per panel, B2e or B4e out of panel,
    their plain versions here) meets the JAX per-ob scan with the same
    draws, diagnostics and departure rows included."""
    kw = dict(kw)
    varloc = kw.pop("varloc", False)
    c = _case(nobs, seed=nobs + panel, vertical=kw.get("vertical", False),
              varloc=varloc)
    jt, jz = jenkf.enkf_tail_scan(jnp.asarray(c["tm"]), jnp.asarray(c["tp"]),
                                  _jobs(c), jnp.asarray(c["eps"]), **kw,
                                  **_vl(c, False))
    tt = tcore.tail_scan_blocked(_t(c["tm"]), _t(c["tp"]), _tobs(c),
                                 panel=panel, kernels=True,
                                 eps=_t(c["eps"]), **kw, **_vl(c, True))
    for name in ("ye", "gain_coef", "sqrt_coef", "tail_mean", "tail_perts"):
        _close(getattr(tt, name), getattr(jt, name))
    for f in range(4):
        _close(tt.diags[f], jt.diags[f])
    _close(tt.apply_rows, jz)


@pytest.mark.parametrize("unbiased", [False, True])
def test_b1e_subpanel_order_equals_serial(unbiased):
    """B1e in the kernel's order of operations (sub-panels of 8, a rank-8
    update of the other rows against ``Z Y^T``) equals its serial plain
    version; ``eps = 0`` is not B1 (no beta)."""
    c = _case(20, seed=3)
    pob = _tobs(c)
    w = tcore.panel_weights(None, pob, False, torch.float64)
    args = (_t(c["tm"]), _t(c["tp"]), pob.values, pob.errors, pob.assim, w)
    serial = tail_solve.tail_panel_solve_plain(*args, unbiased=unbiased,
                                               eps=_t(c["eps"]))
    sub = tail_solve.tail_panel_solve_subpanel_plain(
        *args, unbiased=unbiased, eps=_t(c["eps"]))
    assert len(serial) == len(sub) == 10
    for a, b in zip(sub, serial):
        _close(a, b.numpy())
    zero = tail_solve.tail_panel_solve_plain(
        *args, eps=torch.zeros_like(_t(c["eps"])))
    srf = tail_solve.tail_panel_solve_plain(*args)
    _close(zero[2][0], srf[2][0].numpy())  # the first ob sees the prior
    assert not np.allclose(zero[1].numpy(), srf[1].numpy())


def _jax_body(c, tail, jz, **kw):
    return jcore.ensrf_blocked_body(
        jnp.asarray(c["bm"]), jnp.asarray(c["bp"]), jnp.asarray(c["lat"]),
        jnp.asarray(c["lon"]), tail, _jobs(c), apply_rows=jz, **kw)


@pytest.mark.parametrize("kw", [
    dict(localize=True, fast_geometry=True, cull=True),
    dict(localize=True, fast_geometry=True, cull=False),
    dict(localize=True, fast_geometry=True, cull=True, vertical=True),
    dict(localize=False, cull=False),
])
def test_b2e_plain_matches_apply_rows_body(kw):
    """B2e's plain version (chordal weights, the cull on or off) against
    the blocked body with ``apply_rows = z``, in the port and in the JAX
    package."""
    kw = dict(kw)
    cull = kw.pop("cull")
    vertical = kw.get("vertical", False)
    c = _case(21, seed=5, nstate=301, vertical=vertical)
    jt, jz = jenkf.enkf_tail_scan(jnp.asarray(c["tm"]), jnp.asarray(c["tp"]),
                                  _jobs(c), jnp.asarray(c["eps"]),
                                  localize=kw["localize"],
                                  fast_geometry=kw.get("fast_geometry",
                                                       False),
                                  vertical=vertical)
    tt, tz = tenkf.enkf_tail_scan(_t(c["tm"]), _t(c["tp"]), _tobs(c),
                                  _t(c["eps"]), localize=kw["localize"],
                                  fast_geometry=kw.get("fast_geometry",
                                                       False),
                                  vertical=vertical)
    bkw = dict(body_vert=_t(c["bvert"])) if vertical else {}
    got = ensrf_fused.fused_body(
        _t(c["bm"]), _t(c["bp"]), _t(c["lat"]), _t(c["lon"]), tt, _tobs(c),
        localize=kw["localize"], block_size=8, vertical=vertical, cull=cull,
        apply_rows=tz, **bkw)
    want = tcore.ensrf_blocked_body(
        _t(c["bm"]), _t(c["bp"]), _t(c["lat"]), _t(c["lon"]), tt, _tobs(c),
        block_size=8, apply_rows=tz, **kw, **bkw)
    jwant = _jax_body(c, jt, jz, block_size=8, **kw,
                      **({"body_vert": jnp.asarray(c["bvert"])}
                         if vertical else {}))
    for a, b, j in zip(got, want, jwant):
        _close(a, b.numpy(), BODY_TOL)
        _close(a, j, BODY_TOL)
    assert ensrf_fused.launches == ensrf_fused.enkf_launches == 0


@pytest.mark.parametrize("kw", [
    dict(localize=True),
    dict(localize=True, fast_geometry=True),
    dict(localize=True, vertical=True),
    dict(localize=True, varloc=True),
])
def test_b4e_plain_matches_apply_rows_body(kw):
    """B4e's plain version (one launch per block, exact haversine or
    chordal weights, vertical folded per row, ``varloc`` as a per-(ob,
    row) factor) against the blocked body with ``apply_rows = z``."""
    kw = dict(kw)
    varloc = kw.pop("varloc", False)
    vertical = kw.get("vertical", False)
    c = _case(19, seed=8, nstate=150, vertical=vertical, varloc=varloc)
    tt, tz = tenkf.enkf_tail_scan(_t(c["tm"]), _t(c["tp"]), _tobs(c),
                                  _t(c["eps"]), **kw, **_vl(c, True))
    extra = {}
    if vertical:
        extra["body_vert"] = _t(c["bvert"])
    if varloc:
        extra.update(_vl(c, True), row_var=_t(c["row_var"]))
    args = (_t(c["bm"]), _t(c["bp"]), _t(c["lat"]), _t(c["lon"]), tt,
            _tobs(c))
    got = ensrf_grid.blocked_body(*args, block_size=8, apply_rows=tz, **kw,
                                  **extra)
    want = tcore.ensrf_blocked_body(*args, block_size=8, apply_rows=tz,
                                    **kw, **extra)
    for a, b in zip(got, want):
        _close(a, b.numpy(), BODY_TOL)
    assert ensrf_grid.b4_launches == ensrf_grid.b4e_launches == 0


def _pair(nmems=14, seed=8, nobs=21, radius=1500.0, **state_kw):
    jstate = make_demo_state(nmems=nmems, seed=seed, **state_kw)
    jbatch = JBatch.coerce(make_demo_obs(jstate, nobs=nobs, seed=seed + 1,
                                         radius=radius))
    s = jstate.structure
    data = np.asarray(jstate.data)
    tstate = interop.state_from_numpy(
        {name: data[i] for i, name in enumerate(s.var_names)},
        {"validtime": s.times64(), "lat": s.lat, "lon": s.lon},
        dtype="float64", device="cpu")
    fields = ("values", "errors", "lats", "lons", "times_s", "obtypes",
              "localize_radius", "assimilate_flags", "verts",
              "descriptions", "vert_radius")
    tbatch = interop.obs_batch_from_numpy(
        {k: getattr(jbatch, k) for k in fields})
    return jstate, jbatch, tstate, tbatch


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's EnKF draws the JAX package's table for its seed."""
    def draw(seed, errors, nmems, scale=True):
        return torch.from_numpy(np.array(jenkf.draw_ob_perturbations(
            jax.random.PRNGKey(seed), jnp.asarray(errors.numpy()), nmems,
            scale=scale)))
    monkeypatch.setattr(tenkf, "draw_ob_perturbations", draw)


CLASS_CASES = {
    "fast_geometry": (dict(fast_geometry=True), False, "B2"),
    "haversine": (dict(), False, "B4"),
    "vertical": (dict(), True, "B4"),
    "varloc": (dict(variable_localization=_SPEC), True, "B4"),
    "varloc, fast_geometry": (dict(variable_localization=_SPEC,
                                   fast_geometry=True), True, "B4"),
}


@pytest.mark.parametrize("case", sorted(CLASS_CASES))
def test_enkf_kernel_route_matches_jax_class(case, jax_draws, monkeypatch):
    """``EnKF(...).update()`` on its kernel route (B1e in panels of 8,
    B2e or B4e; plain versions on the CPU) meets the JAX class with the
    same draws, and the port's serial method.  The level-stacked cases
    (three pressure levels, obs with vertical radii) localize vertically."""
    cfg_kw, levels, route = CLASS_CASES[case]
    if levels:
        jstate, jbatch, tstate, tbatch = _level_pair(nobs=20)
    else:
        jstate, jbatch, tstate, tbatch = _pair(ntimes=2)
    kw = dict(localization="GC", dtype="float64", tail_panel=8,
              block_size=8, **cfg_kw)
    seen = []
    real = tenkf.enkf_kernel_update
    monkeypatch.setattr(tenkf, "enkf_kernel_update",
                        lambda r, *a, **k: seen.append(r) or real(r, *a, **k))
    filt = EnKF(tstate, tbatch, config=FilterConfig(**kw), verbose=False,
                seed=21)
    assert filt._vertical_active() == levels
    tpost, tobs = filt.update()
    assert seen == [route]
    jpost, jobs = jenkf.EnKF(jstate, jbatch, config=JConfig(**kw),
                             verbose=False, seed=21).update()
    _close(interop.state_to_numpy(tpost), jpost.data)
    jobs.materialize_diagnostics()
    for name in ("prior_mean", "prior_var", "post_mean", "post_var"):
        _close(getattr(tobs, name), getattr(jobs, name))
    spost, _ = EnKF(tstate, tbatch, verbose=False, seed=21,
                    config=FilterConfig(**dict(kw, method="serial"))).update()
    _close(interop.state_to_numpy(tpost), interop.state_to_numpy(spost))


def test_enkf_route_choice():
    """B2 with ``fast_geometry`` or unlocalized and no varloc, B4
    elsewhere, the plain route for float64 on the card only, serial for
    ``method="serial"``."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    f32, f64 = torch.float32, torch.float64
    r = tenkf.enkf_route
    assert r("blocked", True, True, False, cpu, f64) == "B2"
    assert r("blocked", False, False, False, cpu, f64) == "B2"
    assert r("blocked", True, False, False, cpu, f32) == "B4"
    assert r("blocked", True, True, True, cpu, f64) == "B4"
    assert r("blocked", True, True, False, cuda, f32) == "B2"
    assert r("blocked", True, True, False, cuda, f64) == "plain"
    assert r("serial", True, True, False, cuda, f32) == "serial"
