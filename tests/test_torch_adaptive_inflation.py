"""Adaptive inflation (Anderson 2009) in the port against the JAX package:
the Anderson updates, the per-ob scan and the colored form, the coloring,
and ``AdaptiveInflation`` (float64, CPU), plus the reference's faults that
the port pins instead of copying.

One departure is deliberate: the JAX package takes the posterior mode as
``(-b +- sqrt(b^2 - 4c)) / 2``, which cancels where ``|b|`` is huge (an ob
at the edge of its Gaspari-Cohn support), and the port takes the root near
the prior mean as ``c / q`` from the other root ``q``.  The tests that
compare whole fields patch the JAX package's ``_anderson_update`` with
:func:`stable_jax_anderson_update`, the JAX function with only that line
changed, so that everything else of the JAX package is held at 1e-9;
:func:`test_anderson_root_at_the_support_edge_matches_an_exact_oracle`
holds both roots against an exact evaluation.
"""

import collections

import jax
import jax.numpy as jnp
import mpmath
import numpy as np
import pytest
import torch

from conftest import make_demo_state
from efa_xray_tpu.assimilation import adaptive_inflation as JA
from efa_xray_tpu_torch import AdaptiveInflation, interop
from efa_xray_tpu_torch.assimilation import adaptive_inflation as TA

TOL = 1e-9


def stable_jax_anderson_update(lam_mean, lam_sd, gamma, innov2, sigma_p2,
                               sigma_o2, lambda_min=1.0, lambda_max=1e6):
    """``efa_xray_tpu.assimilation.adaptive_inflation._anderson_update``
    with its root taken without cancellation, as the port takes it."""
    sqrt_lam = jnp.sqrt(jnp.maximum(lam_mean, 1e-12))
    lam_loc = (1.0 + gamma * (sqrt_lam - 1.0)) ** 2
    theta2 = lam_loc * sigma_p2 + sigma_o2
    theta = jnp.sqrt(theta2)
    l_bar = jnp.exp(-0.5 * innov2 / theta2) / (jnp.sqrt(2.0 * jnp.pi) * theta)
    dtheta_dlam = (0.5 * gamma * sigma_p2 * (1.0 + gamma * (sqrt_lam - 1.0))
                   / (theta * sqrt_lam))
    l_prime = l_bar * (innov2 / theta2 - 1.0) / theta * dtheta_dlam
    safe = jnp.abs(l_prime) > 1e-30
    lp = jnp.where(safe, l_prime, 1.0)
    b = l_bar / lp - 2.0 * lam_mean
    c = lam_mean ** 2 - lam_sd ** 2 - l_bar * lam_mean / lp
    disc_raw = b ** 2 - 4.0 * c
    sq = jnp.sqrt(jnp.maximum(disc_raw, 0.0))
    pos = b >= 0.0
    q = -0.5 * (b + jnp.where(pos, sq, -sq))
    other = jnp.where(disc_raw > 0.0, c / q, q)
    r1 = jnp.where(pos, other, q)
    r2 = jnp.where(pos, q, other)
    new_lam = jnp.where(jnp.abs(r1 - lam_mean) < jnp.abs(r2 - lam_mean),
                        r1, r2)
    new_lam = jnp.where(safe & (gamma > 0.0), new_lam, lam_mean)
    return jnp.clip(new_lam, lambda_min, lambda_max)


@pytest.fixture
def jax_stable_root(monkeypatch):
    """The JAX package with :func:`stable_jax_anderson_update` traced into
    its jitted updates (caches dropped before and after)."""
    jax.clear_caches()
    monkeypatch.setattr(JA, "_anderson_update",
                        jax.jit(stable_jax_anderson_update))
    yield
    monkeypatch.undo()
    jax.clear_caches()


def _t(x):
    return torch.as_tensor(np.array(x))


def _network(seed=0, nrows=700, nobs=40):
    rng = np.random.default_rng(seed)
    return dict(
        rlat=rng.uniform(-70, 70, nrows), rlon=rng.uniform(0, 360, nrows),
        olat=rng.uniform(-65, 65, nobs), olon=rng.uniform(0, 360, nobs),
        radii=rng.choice([400.0, 900.0], nobs),
        innov=rng.normal(0, 2.0, nobs), pvar=rng.uniform(0.5, 3.0, nobs),
        ovar=np.ones(nobs), assim=rng.random(nobs) > 0.2,
        lam0=rng.uniform(1.0, 1.5, (2, 1, nrows)),
        sd_evolved=rng.uniform(0.2, 0.6, (2, 1, nrows)))


def _sd(net, evolve):
    return net["sd_evolved"] if evolve else np.full((2, 1, 1), 0.6)


# Well-conditioned regimes (gamma >= 0.05): the two roots agree there.
REGIMES = [(4.0, 1.0, 1.0), (0.1, 2.0, 1.0), (30.0, 0.5, 1.0),
           (1e-4, 3.0, 0.5)]


@pytest.mark.parametrize("d2,sp2,so2", REGIMES)
def test_anderson_updates_match_jax(d2, sp2, so2):
    rng = np.random.default_rng(1)
    lam = rng.uniform(1.0, 1.8, 500)
    sd = rng.uniform(0.1, 0.8, 500)
    gamma = rng.uniform(0.05, 1.0, 500)
    gamma[::7] = 0.0
    want = JA._anderson_update(jnp.asarray(lam), jnp.asarray(sd),
                               jnp.asarray(gamma), d2, sp2, so2,
                               lambda_min=1.0, lambda_max=1.6)
    got = TA._anderson_update(_t(lam), _t(sd), _t(gamma), d2, sp2, so2,
                              lambda_min=1.0, lambda_max=1.6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    want_sd = JA._anderson_sd_update(want, jnp.asarray(lam),
                                     jnp.asarray(sd), jnp.asarray(gamma), d2,
                                     sp2, so2, sd_min=0.15)
    got_sd = TA._anderson_sd_update(got, _t(lam), _t(sd), _t(gamma), d2,
                                    sp2, so2, sd_min=0.15)
    np.testing.assert_allclose(got_sd.numpy(), np.asarray(want_sd),
                               rtol=TOL, atol=TOL)


def _oracle_update(lam, sd, gamma, d2, sp2, so2, digits=60):
    """The Anderson posterior mode (before clipping) in ``digits``-digit
    arithmetic, by the reference's own formula."""
    mp = mpmath.mp
    mp.dps = digits
    lam, sd, gamma, d2, sp2, so2 = (mpmath.mpf(float(x))
                                    for x in (lam, sd, gamma, d2, sp2, so2))
    sl = mpmath.sqrt(lam)
    theta2 = (1 + gamma * (sl - 1)) ** 2 * sp2 + so2
    theta = mpmath.sqrt(theta2)
    lb = mpmath.exp(-d2 / (2 * theta2)) / (mpmath.sqrt(2 * mpmath.pi) * theta)
    dth = gamma * sp2 * (1 + gamma * (sl - 1)) / (2 * theta * sl)
    lpr = lb * (d2 / theta2 - 1) / theta * dth
    b = lb / lpr - 2 * lam
    c = lam ** 2 - sd ** 2 - lb * lam / lpr
    sq = mpmath.sqrt(max(b * b - 4 * c, mpmath.mpf(0)))
    r1, r2 = (-b + sq) / 2, (-b - sq) / 2
    return float(r1 if abs(r1 - lam) < abs(r2 - lam) else r2)


def test_anderson_root_at_the_support_edge_matches_an_exact_oracle():
    """Fault of the reference, pinned: at the edge of an ob's support
    (gamma -> 0) the JAX package's root ``(-b + sqrt(b^2 - 4c)) / 2``
    cancels, and its lambda is off by up to ~0.5 at gamma ~ 1e-15 (values
    that the field's cap then clips); the port's root meets a 60-digit
    evaluation of the same formula at every gamma."""
    gammas = np.array([1e-15, 3.6e-15, 1e-13, 1e-11, 1e-9, 1e-7, 1e-5,
                       1e-3, 0.1, 0.9])
    lam, sd, d2, sp2, so2 = 1.252860111612753, 0.497, 2.2, 0.77, 1.0
    lam_v = np.full(gammas.shape, lam)
    want = np.array([_oracle_update(lam, sd, g, d2, sp2, so2)
                     for g in gammas])
    got = TA._anderson_update(_t(lam_v), sd, _t(gammas), d2, sp2, so2,
                              lambda_max=1e6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)
    jax_got = np.asarray(JA._anderson_update(
        jnp.asarray(lam_v), sd, jnp.asarray(gammas), d2, sp2, so2,
        lambda_max=1e6))
    assert np.abs(jax_got - want)[:3].max() > 1e-2


@pytest.mark.parametrize("evolve", [False, True])
def test_scan_matches_jax(evolve, jax_stable_root):
    n = _network()
    sd = _sd(n, evolve)
    kw = dict(lambda_min=1.0, lambda_max=2.0, evolve_sd=evolve, sd_min=0.1)
    keys = ("rlat", "rlon", "olat", "olon", "radii", "innov", "pvar", "ovar",
            "assim")
    want = JA.update_inflation_rows(
        jnp.asarray(n["lam0"]), jnp.asarray(sd),
        *(jnp.asarray(n[k]) for k in keys), **kw)
    got = TA.update_inflation_rows(_t(n["lam0"]), _t(sd),
                                   *(_t(n[k]) for k in keys), **kw)
    for g, w in zip(got if evolve else (got,), want if evolve else (want,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)


def test_obs_coloring_matches_jax():
    n = _network()
    args = (n["rlat"], n["rlon"], n["olat"], n["olon"], n["radii"])
    jorder, jsizes, jrow_ob = JA.build_obs_coloring(*args)
    order, sizes, row_ob = TA.build_obs_coloring(*args, device="cpu")
    np.testing.assert_array_equal(order, jorder)
    np.testing.assert_array_equal(sizes, jsizes)
    np.testing.assert_array_equal(row_ob.numpy(), np.asarray(jrow_ob))
    # every ob once, colors ascending
    assert sorted(order.tolist()) == list(range(len(n["olat"])))
    # no coloring with a non-finite radius (the scan takes those)
    radii = n["radii"].copy()
    radii[3] = np.inf
    assert TA.build_obs_coloring(*args[:4], radii, device="cpu") is None
    # nor when the supports overlap too densely to batch
    dense = (n["rlat"], n["rlon"], n["olat"][:8] * 0.01, n["olon"][:8] * 0.01,
             n["radii"][:8])
    assert TA.build_obs_coloring(*dense, device="cpu") is None
    assert JA.build_obs_coloring(*dense) is None


@pytest.mark.parametrize("evolve", [False, True])
def test_colored_update_matches_jax_and_the_scan_in_color_order(
        evolve, jax_stable_root):
    """The colored form against the JAX package's, and against the port's
    own scan fed the batch in color order (the order it runs in)."""
    n = _network()
    sd = _sd(n, evolve)
    kw = dict(lambda_min=1.0, lambda_max=2.0, evolve_sd=evolve, sd_min=0.1)
    order, sizes, row_ob = TA.build_obs_coloring(
        n["rlat"], n["rlon"], n["olat"], n["olon"], n["radii"], device="cpu")
    attrs, use = TA.pack_color_tables(order, sizes, n["olat"], n["olon"],
                                      n["radii"], n["innov"], n["pvar"],
                                      n["ovar"], n["assim"])
    jattrs, juse = JA.pack_color_tables(order, sizes, n["olat"], n["olon"],
                                        n["radii"], n["innov"], n["pvar"],
                                        n["ovar"], n["assim"])
    np.testing.assert_array_equal(attrs, jattrs)
    np.testing.assert_array_equal(use, juse)
    got = TA.update_inflation_rows_colored(
        _t(n["lam0"]), _t(sd), _t(n["rlat"]), _t(n["rlon"]), row_ob,
        _t(attrs), _t(use), **kw)
    want = JA.update_inflation_rows_colored(
        jnp.asarray(n["lam0"]), jnp.asarray(sd), jnp.asarray(n["rlat"]),
        jnp.asarray(n["rlon"]), jnp.asarray(row_ob.numpy().astype(np.int32)),
        jnp.asarray(attrs), jnp.asarray(use), **kw)
    perm = lambda k: _t(np.asarray(n[k])[order])
    scan = TA.update_inflation_rows(
        _t(n["lam0"]), _t(sd), _t(n["rlat"]), _t(n["rlon"]),
        *(perm(k) for k in ("olat", "olon", "radii", "innov", "pvar", "ovar",
                            "assim")), **kw)
    for g, w, s in zip(*((x,) if not evolve else x
                         for x in (got, want, scan))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(g.numpy(), s.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_radius_zero_ob_weighs_zero_in_both_forms():
    """Fault of the reference, pinned: an ob with radius 0 weighs 0 in the
    scan (GC of d / 0), but the JAX package's colored form maps radius 0
    to inf and updates the points its coloring assigns it (those within
    the 2 km slack) with weight 1.  In the port both forms leave them."""
    n = _network(seed=4, nrows=300, nobs=12)
    n["olat"][5], n["olon"][5] = n["rlat"][17], n["rlon"][17]
    n["radii"][:] = 300.0
    n["radii"][5] = 0.0
    n["innov"][5] = 6.0
    n["assim"][5] = True
    kw = dict(lambda_min=1.0, lambda_max=5.0)
    sd = np.full((2, 1, 1), 0.6)
    order, sizes, row_ob = TA.build_obs_coloring(
        n["rlat"], n["rlon"], n["olat"], n["olon"], n["radii"], device="cpu")
    assert (row_ob[:, 17] >= 0).any()
    attrs, use = TA.pack_color_tables(order, sizes, n["olat"], n["olon"],
                                      n["radii"], n["innov"], n["pvar"],
                                      n["ovar"], n["assim"])
    got = TA.update_inflation_rows_colored(
        _t(n["lam0"]), _t(sd), _t(n["rlat"]), _t(n["rlon"]), row_ob,
        _t(attrs), _t(use), **kw)
    perm = lambda k: _t(np.asarray(n[k])[order])
    scan = TA.update_inflation_rows(
        _t(n["lam0"]), _t(sd), _t(n["rlat"]), _t(n["rlon"]),
        *(perm(k) for k in ("olat", "olon", "radii", "innov", "pvar", "ovar",
                            "assim")), **kw)
    np.testing.assert_allclose(got.numpy(), scan.numpy(), rtol=1e-12,
                               atol=1e-12)
    # the JAX package's colored form moves the point its scan leaves
    jrow_ob = jnp.asarray(row_ob.numpy().astype(np.int32))
    jcol = JA.update_inflation_rows_colored(
        jnp.asarray(n["lam0"]), jnp.asarray(sd), jnp.asarray(n["rlat"]),
        jnp.asarray(n["rlon"]), jrow_ob, jnp.asarray(attrs),
        jnp.asarray(use), **kw)
    assert abs(float(jcol[0, 0, 17]) - float(scan[0, 0, 17])) > 1e-3


def _tiny_network(k):
    rlat = np.linspace(-10, 10, 20)
    rlon = np.linspace(0, 40, 20)
    return (rlat, rlon, np.array([0.0, 5.0 + k]), np.array([10.0, 30.0]),
            np.array([100.0, 100.0 + k]))


def test_coloring_cache_evicts_after_caching_none(monkeypatch):
    """Fault of the reference, pinned: the JAX package's coloring cache
    skips its eviction when it caches a ``None`` (too many colors), so it
    grows past its bound; the port's evicts its oldest entry then too."""
    monkeypatch.setattr(TA, "_COLOR_CACHE", collections.OrderedDict())
    monkeypatch.setattr(JA, "_COLOR_CACHE", collections.OrderedDict())
    first = _tiny_network(0)
    for k in range(TA.COLOR_CACHE_MAX):
        assert TA.build_obs_coloring(*_tiny_network(k), device="cpu")
        assert JA.build_obs_coloring(*_tiny_network(k)) is not None
    dense = (first[0], first[1], np.zeros(4), np.zeros(4),
             np.full(4, 500.0))
    assert TA.build_obs_coloring(*dense, device="cpu") is None
    assert JA.build_obs_coloring(*dense) is None
    assert len(TA._COLOR_CACHE) == TA.COLOR_CACHE_MAX
    assert len(JA._COLOR_CACHE) == JA._COLOR_CACHE_MAX + 1
    # the oldest entry (the first network's) went
    key_digests = [k[0] for k in TA._COLOR_CACHE]
    TA.build_obs_coloring(*first, device="cpu")
    assert [k[0] for k in TA._COLOR_CACHE][-1] not in key_digests


def test_coloring_cache_is_keyed_on_the_device(monkeypatch):
    """A row map built for one device never serves another: each device
    gets its own entry, with ``row_ob`` on that device."""
    monkeypatch.setattr(TA, "_COLOR_CACHE", collections.OrderedDict())
    net = _tiny_network(1)
    cpu = TA.build_obs_coloring(*net, device="cpu")
    meta = TA.build_obs_coloring(*net, device="meta")
    assert cpu[2].device.type == "cpu" and meta[2].device.type == "meta"
    assert len(TA._COLOR_CACHE) == 2
    assert TA.build_obs_coloring(*net, device="cpu") is cpu


def _pair_inflation(mean0=1.1, std0=0.4, seed=7):
    jstate = make_demo_state(nmems=10, ny=9, nx=11, ntimes=2, seed=seed)
    s = jstate.structure
    data = np.asarray(jstate.data)
    tstate = interop.state_from_numpy(
        {name: data[i] for i, name in enumerate(s.var_names)},
        {"validtime": s.times64(), "lat": s.lat, "lon": s.lon},
        dtype="float64", device="cpu")
    jad = JA.AdaptiveInflation(jstate, ("adaptive", "/nonexistent.nc",
                                        (mean0, std0)))
    tad = AdaptiveInflation(tstate, ("adaptive", "/nonexistent.nc",
                                     (mean0, std0)))
    return jstate, tstate, jad, tad


def _obs_stats(seed, nobs, radius):
    rng = np.random.default_rng(seed)
    return dict(obs_lats=rng.uniform(42.5, 49.5, nobs),
                obs_lons=rng.uniform(230.5, 243.5, nobs),
                obs_radii=np.full(nobs, radius),
                innovations=rng.normal(0, 3.0, nobs),
                prior_vars=rng.uniform(0.5, 2.0, nobs),
                ob_err_vars=rng.uniform(0.5, 1.5, nobs),
                assimilated=rng.random(nobs) > 0.2)


@pytest.mark.parametrize("radius,kw", [
    (40.0, dict()),
    (40.0, dict(evolve_sd=True, sd_min=0.15)),
    (40.0, dict(evolve_sd=True, sd_min=0.15, damp=0.7, lambda_max=1.7)),
    (np.inf, dict(evolve_sd=True, sd_min=0.1, damp=0.9, lambda_max=2.5)),
])
def test_adaptive_inflation_update_matches_jax(radius, kw, jax_stable_root):
    """``AdaptiveInflation.update_inflation`` with the std held and
    evolved, damping and a cap; through the colored form (finite radii
    that color sparsely) and the scan (infinite radii)."""
    _, _, jad, tad = _pair_inflation()
    s = tad.structure
    for seed in (1, 2):
        stats = _obs_stats(seed, 16, radius)
        colored = TA.build_obs_coloring(
            s.lat.ravel(), s.lon.ravel(), stats["obs_lats"],
            stats["obs_lons"], stats["obs_radii"]) is not None
        assert colored == np.isfinite(radius)
        jad.update_inflation(**stats, **kw)
        tad.update_inflation(**stats, **kw)
        for k in ("mean", "std"):
            for v in jad.mean:
                np.testing.assert_allclose(getattr(tad, k)[v],
                                           getattr(jad, k)[v], rtol=TOL,
                                           atol=TOL, err_msg=k)
    v = next(iter(tad.mean))
    assert not np.allclose(tad.mean[v], 1.1)
    assert tad.mean[v].max() <= kw.get("lambda_max", 1e6)


def test_an_empty_batch_leaves_the_fields():
    """An update from no obs is a no-op (the JAX package's coloring takes
    the max of an empty color list and raises)."""
    _, _, jad, tad = _pair_inflation()
    empty = {k: v[:0] for k, v in _obs_stats(1, 4, 80.0).items()}
    with pytest.raises(ValueError):
        jad.update_inflation(**empty)
    before = {v: f.copy() for v, f in tad.mean.items()}
    tad.update_inflation(**empty, evolve_sd=True)
    for v in before:
        np.testing.assert_array_equal(tad.mean[v], before[v])


def test_inflate_state_matches_jax():
    jstate, tstate, jad, tad = _pair_inflation(mean0=1.0)
    rng = np.random.default_rng(3)
    for v in jad.mean:
        field = rng.uniform(1.0, 2.0, jad.mean[v].shape)
        jad.mean[v] = field
        tad.mean[v] = field.copy()
    want = np.asarray(jad.inflate_state(jstate).data)
    got = tad.inflate_state(tstate).data.numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.mean(-1),
                               tstate.data.numpy().mean(-1), rtol=1e-12)


def test_missing_file_builds_fields_and_an_existing_file_raises(tmp_path):
    """A missing inflation file builds the initial fields, as in the JAX
    package; an existing one that cannot be read (here an empty file)
    raises rather than fall back to the initial fields, as the JAX
    package does (``tests/test_torch_inflation_files.py`` pins that); a
    saved one loads back."""
    _, tstate, jad, tad = _pair_inflation(mean0=1.3, std0=0.2)
    for v in jad.mean:
        np.testing.assert_array_equal(tad.mean[v], jad.mean[v])
        np.testing.assert_array_equal(tad.std[v], jad.std[v])
    path = tmp_path / "prior_inflation.nc"
    path.write_bytes(b"")
    with pytest.raises(OSError):
        AdaptiveInflation(tstate, ("adaptive", str(path), (1.0, 0.5)))
    tad.save_to_disk(str(tmp_path / "out.nc"))
    back = AdaptiveInflation(tstate, ("adaptive", str(tmp_path / "out.nc"),
                                      (1.0, 0.5)))
    for v in tad.mean:
        np.testing.assert_array_equal(back.mean[v], tad.mean[v])
        np.testing.assert_array_equal(back.std[v], tad.std[v])


def test_fields_cross_from_the_jax_package():
    """Fields from the JAX package's ``AdaptiveInflation`` mid-cycle become
    the port's through ``interop.adaptive_inflation_from_numpy``."""
    _, tstate, jad, _ = _pair_inflation()
    jad.update_inflation(**_obs_stats(5, 6, 300.0), evolve_sd=True)
    tad = interop.adaptive_inflation_from_numpy(
        tstate, {v: np.asarray(f) for v, f in jad.mean.items()},
        {v: np.asarray(f) for v, f in jad.std.items()})
    assert tad.device == tstate.device
    for v in jad.mean:
        np.testing.assert_array_equal(tad.mean[v], jad.mean[v])
        np.testing.assert_array_equal(tad.std[v], jad.std[v])
        assert tad.mean[v].dtype == np.float64
