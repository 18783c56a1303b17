"""The tail through B1 on every kernel route: B1's plain version with
exact-haversine, vertical, cross-variable and hybrid (B1h) weights against
``tail_scan`` (the port's and the JAX package's), the sub-panel order of
the CUDA kernel against the serial plain version, and
``tail_scan_blocked(kernels=True)`` (B1 or B1h, then B2, B4 or the plain
hybrid apply) against the plain panel scan and the JAX package, in
float64 on the CPU, where the kernels' plain versions run."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from efa_xray_tpu.assimilation import ensrf_core as jcore
from efa_xray_tpu_torch.assimilation import ensrf_core as tcore
from efa_xray_tpu_torch.ops import ensrf_grid, tail_solve

F64 = torch.float64
EXACT = 1e-10  # the same algebra in the port, another order of sums
TOL = 1e-9  # against the JAX package


def _obs(p=24, m=12, seed=0, nvars=3):
    """A panel of obs near one another (so the weights are not all zero),
    with levels, vertical radii, variables, per-ob static sigmas, and a
    tail slab of centred perturbations."""
    rng = np.random.default_rng(seed)
    ye = rng.normal(280, 3, (p, m))
    tm = ye.mean(1)
    obs = dict(values=tm + rng.normal(0, 1.5, p),
               errors=rng.uniform(0.5, 2.0, p),
               lats=rng.uniform(20, 50, p), lons=rng.uniform(250, 290, p),
               radii=rng.choice([900.0, 2500.0, np.inf], p),
               assim=rng.random(p) > 0.25,
               verts=rng.uniform(200, 1000, p),
               vert_radii=rng.choice([400.0, np.inf], p))
    obs["assim"][0] = True
    extra = dict(ob_var=rng.integers(0, nvars, p),
                 varloc=rng.uniform(0.0, 1.0, (nvars + 1, nvars)),
                 sigma=rng.uniform(1.0, 3.0, p))
    return tm, ye - tm[:, None], obs, extra


def _tobs(obs):
    return tcore.ObsArrays(**{k: torch.tensor(v) for k, v in obs.items()})


def _jobs(obs):
    return jcore.ObsArrays(**{k: jnp.asarray(v) for k, v in obs.items()})


def _same(got, want, tol, names=None):
    for k, (g, w) in enumerate(zip(got, want)):
        g = np.asarray(g, dtype=np.float64)
        w = np.asarray(w, dtype=np.float64)
        name = names[k] if names and k < len(names) else str(k)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
        np.testing.assert_allclose(g[~np.isnan(g)], w[~np.isnan(w)],
                                   rtol=tol, atol=tol, err_msg=name)


SOL_NAMES = ("ye", "gain_coef", "sqrt_coef", "tail_mean", "tail_perts")


def _sol_arrays(sol, hybrid=False):
    out = [getattr(sol, n) for n in SOL_NAMES] + list(sol.diags[:4])
    if hybrid:
        out += [sol.static_gain, sol.static_sqrt]
    return [np.asarray(x) for x in out]


# ---------------------------------------------------------------------------
# B1's plain version with the weights of every route
# ---------------------------------------------------------------------------

WEIGHT_CASES = {
    "haversine": dict(localize=True),
    "haversine + vertical": dict(localize=True, vertical=True),
    "haversine + varloc": dict(localize=True, varloc=True),
    "chordal + vertical + varloc": dict(localize=True, fast_geometry=True,
                                        vertical=True, varloc=True),
    "varloc, unlocalized": dict(localize=False, varloc=True),
}


@pytest.mark.parametrize("unbiased", [False, True])
@pytest.mark.parametrize("case", list(WEIGHT_CASES))
def test_b1_plain_with_route_weights_matches_tail_scan(case, unbiased):
    """``tail_panel_solve_plain`` with ``panel_weights`` is the port's
    ``tail_scan`` (1e-10) and the JAX package's (1e-9)."""
    kw = WEIGHT_CASES[case]
    tm, tp, obs, ex = _obs(seed=1)
    pob = _tobs(obs)
    use_vl = kw.get("varloc", False)
    fast = kw.get("fast_geometry", False)
    vertical = kw.get("vertical", False)
    pxyz = tcore.latlon_to_unit(pob.lats, pob.lons) if fast else None
    vkw = (dict(varloc=torch.tensor(ex["varloc"]),
                ob_var=torch.tensor(ex["ob_var"])) if use_vl else {})
    w = tcore.panel_weights(pxyz, pob, vertical, F64,
                            localize=kw["localize"], **vkw)
    got = tail_solve.tail_panel_solve_plain(
        torch.tensor(tm), torch.tensor(tp), pob.values, pob.errors,
        pob.assim, w, unbiased=unbiased)
    # (tm, tp, ye, gain, sqrt, pm, pv, om, ov) in SOL_NAMES + diags order
    got = [got[2], got[3], got[4], got[0], got[1], *got[5:9]]
    skw = dict(localize=kw["localize"], unbiased=unbiased,
               fast_geometry=fast, vertical=vertical)
    port = tcore.tail_scan(torch.tensor(tm), torch.tensor(tp), pob, **skw,
                           **vkw)
    _same(got, _sol_arrays(port), EXACT)
    jvkw = (dict(varloc=jnp.asarray(ex["varloc"]),
                 ob_var=jnp.asarray(ex["ob_var"].astype(np.int32)))
            if use_vl else {})
    want = jcore.tail_scan(jnp.asarray(tm), jnp.asarray(tp), _jobs(obs),
                           **skw, **jvkw)
    _same(got, _sol_arrays(want), TOL)


@pytest.mark.parametrize("geometry", ["haversine", "chordal", "vertical",
                                      "unlocalized"])
def test_b1h_plain_matches_jax_tail_scan(geometry):
    """B1h's plain version (alpha 0.5, a sigma per row, the static
    correlation at exact haversine) is the JAX ``tail_scan`` in hybrid
    mode, static-column scalars and the diagnostics' NaN pattern
    included."""
    tm, tp, obs, ex = _obs(seed=2)
    pob = _tobs(obs)
    localize = geometry != "unlocalized"
    fast = geometry == "chordal"
    vertical = geometry == "vertical"
    pxyz = tcore.latlon_to_unit(pob.lats, pob.lons) if fast else None
    w = tcore.panel_weights(pxyz, pob, vertical, F64, localize=localize)
    got = tail_solve.tail_panel_solve_plain(
        torch.tensor(tm), torch.tensor(tp), pob.values, pob.errors,
        pob.assim, w, alpha=0.5, sigma=torch.tensor(ex["sigma"]),
        static_gc=tcore.static_weights(pob, 1500.0, F64))
    assert len(got) == 11
    got = [got[2], got[3], got[4], got[0], got[1], *got[5:11]]
    want = jcore.tail_scan(jnp.asarray(tm), jnp.asarray(tp), _jobs(obs),
                           localize=localize, fast_geometry=fast,
                           vertical=vertical, hybrid_alpha=0.5,
                           tail_sigma=jnp.asarray(ex["sigma"]),
                           static_length=1500.0)
    assert np.isnan(np.asarray(want.diags.post_mean)).any()
    _same(got, _sol_arrays(want, hybrid=True), TOL)


@pytest.mark.parametrize("hybrid", [False, True])
@pytest.mark.parametrize("sub,p", [(1, 24), (8, 37), (16, 37), (16, 48)])
def test_subpanel_plain_matches_serial(sub, p, hybrid):
    """The kernel's order (a serial solve per sub-panel, then a rank-sub
    update of every other row) is the serial solve, at sub-panels of 1,
    8 and 16 and a panel that is not a multiple of them."""
    tm, tp, obs, ex = _obs(p=p, m=10, seed=3)
    pob = _tobs(obs)
    w = tcore.panel_weights(None, pob, True, F64,
                            varloc=torch.tensor(ex["varloc"]),
                            ob_var=torch.tensor(ex["ob_var"]))
    hkw = (dict(alpha=0.6, sigma=torch.tensor(ex["sigma"]),
                static_gc=tcore.static_weights(pob, 1200.0, F64))
           if hybrid else {})
    args = (torch.tensor(tm), torch.tensor(tp), pob.values, pob.errors,
            pob.assim, w)
    want = tail_solve.tail_panel_solve_plain(*args, **hkw)
    got = tail_solve.tail_panel_solve_subpanel_plain(*args, sub=sub, **hkw)
    assert len(got) == len(want) == (11 if hybrid else 9)
    _same(got, want, EXACT)


# ---------------------------------------------------------------------------
# tail_scan_blocked(kernels=True) on every route
# ---------------------------------------------------------------------------

BLOCKED_CASES = {
    "haversine": (dict(), "B4"),
    "haversine + vertical": (dict(vertical=True), "B4"),
    "haversine + varloc": (dict(varloc=True), "B4"),
    "chordal + varloc": (dict(fast_geometry=True, varloc=True), "B4"),
    "hybrid, haversine": (dict(hybrid=True), "plain"),
    "hybrid, chordal + vertical": (dict(hybrid=True, fast_geometry=True,
                                        vertical=True), "plain"),
    "chordal": (dict(fast_geometry=True), "B2"),
}


@pytest.mark.parametrize("panel", [8, 32])
@pytest.mark.parametrize("case", list(BLOCKED_CASES))
def test_kernel_tail_matches_plain_and_jax(monkeypatch, case, panel):
    """The kernel tail equals the plain panel scan (1e-10; not on the B2
    route, whose chordal polynomials are its own) and the JAX package's
    ``tail_scan_blocked`` (1e-9; its plain branch, or its Pallas branch in
    interpret mode on the B2 route); B1 (B1h)
    solves every panel, and B4 carries the exact-haversine and varloc
    applies.  A 32-ob panel covers the one-panel path."""
    kw, apply = BLOCKED_CASES[case]
    nobs = 21
    tm, tp, obs, ex = _obs(p=nobs, m=12, seed=4)
    hybrid = kw.get("hybrid", False)
    use_vl = kw.get("varloc", False)
    base = dict(localize=True, fast_geometry=kw.get("fast_geometry", False),
                vertical=kw.get("vertical", False), panel=panel)
    extra = {}
    if hybrid:
        extra = dict(hybrid_alpha=0.5, static_length=1500.0)
    calls = {"tail_panel_solve": 0, "block_apply": 0}

    def spy(module, name):
        real = getattr(module, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return real(*a, **k)

        monkeypatch.setattr(module, name, wrapped)

    spy(tail_solve, "tail_panel_solve")
    spy(ensrf_grid, "block_apply")
    tkw = dict(**base, **extra)
    if hybrid:
        tkw["tail_sigma"] = torch.tensor(ex["sigma"])
    if use_vl:
        tkw.update(varloc=torch.tensor(ex["varloc"]),
                   ob_var=torch.tensor(ex["ob_var"]))
    run = lambda kernels: tcore.tail_scan_blocked(
        torch.tensor(tm), torch.tensor(tp), _tobs(obs), kernels=kernels,
        **tkw)
    got = run(True)
    npanels = -(-nobs // panel)
    assert calls["tail_panel_solve"] == npanels
    assert tcore.tail_apply_route(True, base["fast_geometry"], use_vl,
                                  hybrid) == apply
    # One B4 launch per panel (blocks of up to 128 obs) where panels apply.
    assert calls["block_apply"] == (npanels if apply == "B4"
                                    and npanels > 1 else 0)
    plain = run(False)
    assert calls["tail_panel_solve"] == npanels
    if apply != "B2":  # B2's chordal polynomials sit ~1e-8 off the plain
        _same(_sol_arrays(got, hybrid), _sol_arrays(plain, hybrid), EXACT,
              SOL_NAMES)
    jkw = dict(**base, **extra)
    if hybrid:
        jkw["tail_sigma"] = jnp.asarray(ex["sigma"])
    if use_vl:
        jkw.update(varloc=jnp.asarray(ex["varloc"]),
                   ob_var=jnp.asarray(ex["ob_var"].astype(np.int32)))
    if apply == "B2":
        jkw.update(pallas_apply=True, interpret=True)
    want = jcore.tail_scan_blocked(jnp.asarray(tm), jnp.asarray(tp),
                                   _jobs(obs), **jkw)
    _same(_sol_arrays(got, hybrid), _sol_arrays(want, hybrid), TOL,
          SOL_NAMES)
