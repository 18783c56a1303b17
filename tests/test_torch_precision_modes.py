"""The body kernels' product modes (``efa_xray_tpu_torch/ops/precision.py``):
what ``matmul_precision`` and ``mxu_bf16`` compute in the port, on the CPU.

* Every ``matmul_precision`` value leaves a float64 update in fp32, in all
  three solvers and on a mesh: the ``None`` posterior bit for bit, and the
  JAX package's (whose CPU ignores the hint) at 1e-9.
* ``mxu_bf16`` casts B2, B2h and B3's two large products on the CPU too:
  the plain versions meet the JAX kernels' ``mxu_bf16`` branches in
  interpret mode, and the EnSRF meets the JAX EnSRF on its Pallas route.
* The plain bodies in ``"tf32"`` and ``"bf16"`` meet a NumPy float64
  evaluation of the same rounded operands (rounded by bit operations here,
  independently of the port's rounding).
* ``product_mode`` implements the table of the README, and the route hands
  the mode to the body's wrappers and never to B1 or the tail's applies.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import make_demo_obs, make_demo_state
from efa_xray_tpu.assimilation import enkf as jenkf
from efa_xray_tpu.assimilation import ensrf_core as jcore
from efa_xray_tpu.assimilation.ensrf import EnSRF as JEnSRF
from efa_xray_tpu.assimilation.letkf import LETKF as JLETKF
from efa_xray_tpu.config import FilterConfig as JConfig
from efa_xray_tpu.observation.observation import ObservationBatch as JBatch
from efa_xray_tpu.observation.thinning import _hilbert3d_np
from efa_xray_tpu.ops import ensrf_pallas_fused as jfused
from efa_xray_tpu_torch import EnKF, EnSRF, FilterConfig, LETKF, interop
from efa_xray_tpu_torch.assimilation import enkf as tenkf
from efa_xray_tpu_torch.assimilation import ensrf as tensrf
from efa_xray_tpu_torch.ops import ensrf_fused, ensrf_grid, precision
from efa_xray_tpu_torch.ops import tail_solve
from efa_xray_tpu_torch.parallel import make_mesh
from test_pallas_kernel import _scatter_setup, _setup

TOL = 1e-9  # float64, same algebra in another summation order
# The plain bf16 bodies against the JAX kernels' mxu_bf16 branches, both
# in float32: the same bf16 operands and f32 accumulation, so what is left
# is f32 summation order and the rare ob whose f32 U column (computed in
# another order) rounds to the other bf16 neighbour.  A share of the
# largest increment, 50x tighter than the JAX package's own contract for
# the flag (0.05 of it, tests/test_pallas_kernel.py:688-738).
BF16_GATE = 1e-3
MATMUL_PRECISIONS = (None, "default", "high", "highest", "bfloat16",
                     "tensorfloat32", "float32")
_BATCH_FIELDS = ("values", "errors", "lats", "lons", "times_s", "obtypes",
                 "localize_radius", "assimilate_flags", "verts",
                 "descriptions", "vert_radius")


def _pair(dtype="float64", nvars=1, ntimes=1, nmems=12, nobs=19, seed=5):
    """The same state and obs, as JAX objects and as port objects."""
    jstate = make_demo_state(nvars=nvars, ntimes=ntimes, ny=9, nx=11,
                             nmems=nmems, seed=seed)
    jbatch = JBatch.coerce(make_demo_obs(jstate, nobs=nobs, seed=seed + 1,
                                         radius=900.0))
    s = jstate.structure
    data = np.asarray(jstate.data)
    tstate = interop.state_from_numpy(
        {name: data[i] for i, name in enumerate(s.var_names)},
        {"validtime": s.times64(), "lat": s.lat, "lon": s.lon},
        dtype=dtype, device="cpu")
    tbatch = interop.obs_batch_from_numpy(
        {k: getattr(jbatch, k) for k in _BATCH_FIELDS})
    return jstate, jbatch, tstate, tbatch


# ---------------------------------------------------------------------------
# 1. matmul_precision on the CPU: fp32 (float64 here) in every solver
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's EnKF draws the JAX package's table for its seed."""
    def draw(seed, errors, nmems, scale=True):
        return torch.from_numpy(np.array(jenkf.draw_ob_perturbations(
            jax.random.PRNGKey(seed), jnp.asarray(errors.numpy()), nmems,
            scale=scale)))
    monkeypatch.setattr(tenkf, "draw_ob_perturbations", draw)


def _solve(solver, pkg, state, batch, mesh=None, **cfg):
    kw = dict(localization="GC", dtype="float64", **cfg)
    if pkg == "jax":
        cls = {"EnSRF": JEnSRF, "EnKF": jenkf.EnKF, "LETKF": JLETKF}[solver]
        config = JConfig(**kw)
    else:
        cls = {"EnSRF": EnSRF, "EnKF": EnKF, "LETKF": LETKF}[solver]
        config = FilterConfig(**kw)
    extra = {"EnKF": dict(seed=21), "LETKF": {}}.get(solver, {})
    if solver != "LETKF":
        extra["verbose"] = False
    if mesh is not None:
        extra["mesh"] = mesh
    post, _ = cls(state, batch, config=config, **extra).update()
    return (interop.state_to_numpy(post) if pkg == "port"
            else np.asarray(post.data))


@pytest.mark.parametrize("value", MATMUL_PRECISIONS)
@pytest.mark.parametrize("solver", ["EnSRF", "EnKF", "LETKF"])
def test_every_matmul_precision_is_fp32_on_the_cpu(solver, value, jax_draws):
    """Each value runs, on one device and on a mesh of two: the ``None``
    posterior bit for bit and the JAX package's at the same value at 1e-9
    (``tests/test_precision.py:46-58`` pins that the JAX CPU ignores the
    hint).  The EnSRF takes its kernel route (B1 + B4 at the default
    config).  The EnKF, which has no body kernel, is held against JAX on
    the serial method (each value is a new JAX trace, and the serial one
    compiles in a tenth of the blocked one's time) and bit for bit on
    both methods."""
    jstate, jbatch, tstate, tbatch = _pair()
    methods = ["serial", "blocked"] if solver == "EnKF" else [None]
    for method in methods:
        kw = {} if method is None else dict(method=method)
        base = _solve(solver, "port", tstate, tbatch, **kw)
        got = _solve(solver, "port", tstate, tbatch, matmul_precision=value,
                     **kw)
        np.testing.assert_array_equal(got, base)
        mesh = make_mesh(["cpu"] * 2)
        on_mesh = _solve(solver, "port", tstate, tbatch, mesh=mesh,
                         matmul_precision=value, **kw)
        np.testing.assert_array_equal(
            on_mesh, _solve(solver, "port", tstate, tbatch, mesh=mesh, **kw))
        if method == "blocked":
            continue
        want = _solve(solver, "jax", jstate, jbatch, matmul_precision=value,
                      **kw)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(on_mesh, want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# 2. mxu_bf16: the plain bodies against the JAX kernels' bf16 branches
# ---------------------------------------------------------------------------


def _np(x):
    return np.array(x, dtype=np.float32)


def _port_tail(jt):
    fields = {k: np.asarray(v) for k, v in jt._asdict().items()
              if k != "diags" and v is not None}
    fields.update({k: np.asarray(v) for k, v in jt.diags._asdict().items()})
    return interop.tail_solution_from_numpy(**fields, dtype="float32",
                                            device="cpu")


def _port_obs(jobs):
    return interop.obs_arrays_from_numpy(
        **{k: None if v is None else np.asarray(v)
           for k, v in jobs._asdict().items()}, dtype="float32", device="cpu")


def _assert_bf16_pair(got, want, ieee, prior):
    """``got`` (the port's bf16 body) within ``BF16_GATE`` x the largest
    increment of ``want`` (the JAX kernel's), per output; both differ from
    the fp32 body ``ieee`` by more than that (the mode took effect)."""
    for g, w, f, p in zip(got, want, ieee, prior):
        g, w, f = g.numpy(), _np(w), f.numpy()
        inc = np.abs(w - _np(p)).max()
        assert inc > 1e-3
        assert np.abs(g - w).max() <= BF16_GATE * inc, (
            np.abs(g - w).max(), inc)
        assert np.abs(g - f).max() > BF16_GATE * inc


@pytest.mark.parametrize("hybrid", [False, True])
def test_b2_plain_bf16_matches_jax_mxu_bf16(hybrid):
    """B2 (and B2h's branch) on ``tests/test_pallas_kernel.py``'s
    scattered workload (:688-713), in float32: the plain body in
    ``"bf16"`` against ``ensrf_blocked_body_pallas_fused(...,
    mxu_bf16=True, interpret=True)``."""
    bm, bp, tm, tp, blat, blon, obs = _scatter_setup()
    kw, tkw, tail_kw = {}, {}, {}
    if hybrid:
        rng = np.random.default_rng(31)
        bsig = rng.uniform(1.0, 3.0, bm.shape[0]).astype(np.float32)
        tsig = rng.uniform(1.0, 3.0, tm.shape[0]).astype(np.float32)
        kw = dict(hybrid=True, body_sigma=jnp.asarray(bsig),
                  static_length=600.0)
        tkw = dict(hybrid=True, body_sigma=torch.from_numpy(bsig),
                   static_length=600.0)
        tail_kw = dict(hybrid_alpha=0.5, tail_sigma=jnp.asarray(tsig),
                       static_length=600.0)
    tail = jcore.tail_scan(tm, tp, obs, localize=True, fast_geometry=True,
                           **tail_kw)
    want = jfused.ensrf_blocked_body_pallas_fused(
        bm, bp, blat, blon, tail, obs, localize=True, block_size=8, tile=64,
        interpret=True, mxu_bf16=True, **kw)
    args = [torch.from_numpy(_np(x)) for x in (bm, bp, blat, blon)]
    tt, to = _port_tail(tail), _port_obs(obs)
    got = ensrf_fused.fused_body(*args, tt, to, localize=True, block_size=8,
                                 precision="bf16", **tkw)
    ieee = ensrf_fused.fused_body(*args, tt, to, localize=True,
                                  block_size=8, **tkw)
    _assert_bf16_pair(got, want, ieee, (bm, bp))


def test_b3_plain_bf16_matches_jax_mxu_bf16():
    """B3 on ``tests/test_pallas_kernel.py``'s grid workload (:716-738),
    in float32: the plain body in ``"bf16"`` against
    ``ensrf_blocked_body_pallas_fused_grid(..., mxu_bf16=True)``."""
    bm, bp, tm, tp, blat, blon, obs = _setup(nobs=9, nmems=12, seed=14)
    ngrid = 64
    tail = jcore.tail_scan(tm, tp, obs, localize=True)
    want = jfused.ensrf_blocked_body_pallas_fused_grid(
        bm, bp, blat, blon, tail, obs, localize=True, block_size=3, tile=48,
        interpret=True, ngrid=ngrid, mxu_bf16=True)
    args = [torch.from_numpy(_np(x)) for x in (bm, bp, blat, blon)]
    tt, to = _port_tail(tail), _port_obs(obs)
    got = ensrf_grid.grid_body(*args, tt, to, ngrid=ngrid, block_size=3,
                               precision="bf16")
    ieee = ensrf_grid.grid_body(*args, tt, to, ngrid=ngrid, block_size=3)
    _assert_bf16_pair(got, want, ieee, (bm, bp))


def test_ensrf_mxu_bf16_matches_jax_pallas_route():
    """``EnSRF`` with ``mxu_bf16`` and ``fast_geometry`` in float32 on the
    CPU (B1, B2's tail applies and the B2 body as plain versions, the body
    in bf16) against the JAX EnSRF on its Pallas route in interpret mode
    with the same flag (the pattern of ``tests/test_torch_ensrf.py``'s
    kernel-route test).  The tail is fp32 in both packages; the posterior
    differs from the fp32 one."""
    kw = dict(localization="GC", dtype="float32", fast_geometry=True,
              tail_panel=8, block_size=4)
    jstate, jbatch, tstate, tbatch = _pair(dtype="float32", nmems=16,
                                           nobs=40)
    jpost, _ = JEnSRF(jstate, jbatch, verbose=False, config=JConfig(
        use_pallas=True, tail_pallas=True, mxu_bf16=True, **kw)).update()
    tpost, _ = EnSRF(tstate, tbatch, verbose=False,
                     config=FilterConfig(mxu_bf16=True, **kw)).update()
    fpost, _ = EnSRF(tstate, tbatch, verbose=False,
                     config=FilterConfig(**kw)).update()
    got, want = interop.state_to_numpy(tpost), np.asarray(jpost.data)
    inc = np.abs(want - np.asarray(jstate.data)).max()
    assert inc > 0.1
    assert np.abs(got - want).max() <= BF16_GATE * inc
    assert (np.abs(got - interop.state_to_numpy(fpost)).max()
            > BF16_GATE * inc)


# ---------------------------------------------------------------------------
# 3. The plain bodies in tf32 and bf16 against NumPy float64
# ---------------------------------------------------------------------------


def _np_round(x, mode):
    """``x`` rounded through float32 to TF32 (ties away from zero) or bf16
    (ties to even) by bit operations, back in float64."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    if mode == "tf32":
        bits = (bits + 0x1000) & ~np.uint64(0x1FFF)
    else:
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & ~np.uint64(0xFFFF)
    return (bits & 0xFFFFFFFF).astype(np.uint32).view(np.float32).astype(
        np.float64)


def _np_b2(bm, bp, y_b, ggt_b, tab_b, w_b, s_b, sigma, alive_b, mode,
           hybrid):
    """B2 (B2h) ob by ob in float64, its two products on operands rounded
    by ``_np_round``: ``w_b`` the weights and ``s_b`` the static GC
    factors per block ``[rows, B]``, ``alive_b`` the live (row, ob)
    pairs."""
    r = lambda x: _np_round(x, mode)
    for b in range(y_b.shape[0]):
        y, ggt, tab = y_b[b], ggt_b[b], tab_b[b]
        d0 = r(bp) @ r(y).T
        u = np.zeros_like(d0)
        mean = np.zeros_like(bm)
        for j in range(y.shape[0]):
            d = (d0[:, j] - u[:, :j] @ ggt[j, :j]) * w_b[b][:, j]
            if hybrid:
                s = sigma * s_b[b][:, j] * alive_b[b][:, j]
                d = d * alive_b[b][:, j]
                mean += tab[0, j] * d + tab[8, j] * s
                d = tab[1, j] * d + tab[9, j] * s
            else:
                d = d * alive_b[b][:, j]
                mean += tab[0, j] * d
            u[:, j] = d
        bm = bm + mean
        bp = bp - r(u if hybrid else u * tab[1][None, :]) @ r(y)
    return bm, bp


def _np_grid(bm, bp, w, table, y_b, ggt_b, coef_b, vt, mode):
    """B3/B4 ob by ob in float64 on ``_np_round``-ed product operands."""
    r = lambda x: _np_round(x, mode)
    g = bp.shape[0] // vt
    x, xm = bp.reshape(vt, g, -1), bm.reshape(vt, g)
    for b in range(y_b.shape[0]):
        y = y_b[b]
        d0 = r(x) @ r(y).T
        u = np.zeros_like(d0)
        for j in range(y.shape[0]):
            d = d0[..., j] - u[..., :j] @ ggt_b[b, j, :j]
            if w is not None:
                d = d * w[b, j][None, :] * (1.0 if table is None
                                            else table[:, b, j][:, None])
            u[..., j] = d
        xm = xm + u @ coef_b[b, 0]
        x = x - r(u * coef_b[b, 1]) @ r(y)
    return xm.reshape(-1), x.reshape(bp.shape)


def _scattered(nstate=203, nmems=13, nobs=21, seed=9):
    """Scattered rows in Hilbert order and obs, in float64 (an odd member
    count, a ragged last block and tile), some obs unlocalized and some
    not assimilated."""
    rng = np.random.default_rng(seed)
    lat = rng.uniform(-60, 60, nstate)
    lon = rng.uniform(0, 360, nstate)
    ro = np.argsort(_hilbert3d_np(lat, lon), kind="stable")
    lat, lon = lat[ro], lon[ro]
    prior = rng.normal(280, 3, (nstate, nmems))
    rows = rng.integers(0, nstate, nobs)
    ye = prior[rows] + rng.normal(0, 0.5, (nobs, nmems))
    obs = dict(values=ye.mean(1) + rng.normal(0, 1, nobs),
               errors=rng.uniform(0.5, 2.0, nobs), lats=lat[rows],
               lons=lon[rows],
               radii=np.where(rng.random(nobs) < 0.1, np.inf,
                              rng.uniform(300, 900, nobs)),
               assim=rng.random(nobs) > 0.15)
    tm = ye.mean(1)
    jt = jcore.tail_scan(jnp.asarray(tm), jnp.asarray(ye - tm[:, None]),
                         jcore.ObsArrays(**{k: jnp.asarray(v)
                                            for k, v in obs.items()}),
                         localize=True, fast_geometry=True,
                         hybrid_alpha=0.5,
                         tail_sigma=jnp.asarray(rng.uniform(1, 2, nobs)),
                         static_length=1200.0)
    fields = {k: np.asarray(v) for k, v in jt._asdict().items()
              if k != "diags" and v is not None}
    fields.update({k: np.asarray(v) for k, v in jt.diags._asdict().items()})
    tail = interop.tail_solution_from_numpy(**fields, device="cpu")
    sigma = rng.uniform(1.0, 3.0, nstate)
    return (prior.mean(1), prior - prior.mean(1, keepdims=True), lat, lon,
            tail, interop.obs_arrays_from_numpy(**obs, device="cpu"), sigma)


@pytest.mark.parametrize("mode", ["tf32", "bf16"])
@pytest.mark.parametrize("hybrid", [False, True])
def test_b2_plain_modes_match_numpy(mode, hybrid):
    """``fused_apply_plain`` (B2, B2h) in each tensor-core mode, float64
    inputs, against ``_np_b2`` on the same prepared operands, at 1e-9:
    the weights and static factors are the port's (``_weights_plain``,
    ``_gc_poly``), the products, the rounding, the substitution and the
    cull NumPy's."""
    bm, bp, lat, lon, tail, obs, sigma = _scattered()
    t = torch.from_numpy
    if not hybrid:
        tail = tail._replace(static_gain=None, static_sqrt=None)
    ops = ensrf_fused.prepare(
        t(bp), t(lat), t(lon), tail, obs, block_size=16, cull=True,
        max_radius_km=900.0, hybrid=hybrid, body_sigma=t(sigma),
        static_length=1200.0 if hybrid else None)
    geom, tab_b = ops["geom"], ops["tab_b"]
    nb, bsz, _ = ops["y_b"].shape
    tile_of_row = np.arange(len(bm)) // ops["tile"]
    w_b, s_b, alive_b = [], [], []
    for b in range(nb):
        dist = ensrf_fused._dist_plain(tab_b[b], geom, 0, bsz, ops["series"])
        w_b.append(ensrf_fused._weights_plain(
            tab_b[b], geom, 0, bsz, dist, False, ops["series"]).numpy())
        s_b.append(ensrf_fused._gc_poly(dist * tab_b[b, 10][None, :])
                   .numpy() if hybrid else None)
        bits = ops["bits"][:, b].numpy().astype(np.int64)[tile_of_row]
        alive_b.append((bits[:, None] >> (np.arange(bsz) // 8)[None, :]) & 1)
    assert ops["bits"] is not None and any((a == 0).any() for a in alive_b)
    got = ensrf_fused.fused_apply_plain(
        t(bm), t(bp), geom, ops["y_b"], ops["ggt_b"], tab_b, ops["bits"],
        ops["tile"], True, False, ops["series"], hybrid=hybrid,
        precision=mode)
    want = _np_b2(bm, bp, ops["y_b"].numpy(), ops["ggt_b"].numpy(),
                  tab_b.numpy(), w_b, s_b, sigma, alive_b, mode, hybrid)
    ieee = ensrf_fused.fused_apply_plain(
        t(bm), t(bp), geom, ops["y_b"], ops["ggt_b"], tab_b, ops["bits"],
        ops["tile"], True, False, ops["series"], hybrid=hybrid)
    for g, w, f in zip(got, want, ieee):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)
        assert float((g - f).abs().max()) > 1e-6  # the rounding took effect


@pytest.mark.parametrize("mode", ["tf32", "bf16"])
@pytest.mark.parametrize("entry", ["B3", "B4"])
def test_grid_plain_modes_match_numpy(entry, mode):
    """``grid_apply_plain`` in each tensor-core mode, float64, against
    ``_np_grid``: B3's operands over 3 groups and ragged blocks (weights
    and a table), B4's one block on a flat state."""
    bm, bp, lat, lon, tail, obs, _ = _scattered(nstate=3 * 41)
    t = torch.from_numpy
    if entry == "B3":
        ops = ensrf_grid.grid_prepare(t(bp), None, tail, obs, ngrid=41,
                                      block_size=16)
        w = ensrf_grid.grid_weights(
            ensrf_grid.latlon_to_unit(t(lat[:41]), t(lon[:41])),
            ops["ob_xyz"], ops["radii"]).reshape(-1, 16, 41)
        table = torch.rand((3,) + ops["y_b"].shape[:2], dtype=torch.float64,
                           generator=torch.Generator().manual_seed(4))
        args = (w, table, ops["y_b"], ops["ggt_b"], ops["coef_b"], 3)
    else:
        sl = slice(0, 16)
        vt, w, table, ggt = ensrf_grid.block_operands(
            t(lat), t(lon), tail.ye[sl], tail.sqrt_coef[sl], obs.lats[sl],
            obs.lons[sl], obs.radii[sl], len(bm))
        coef = torch.stack([tail.gain_coef[sl], tail.sqrt_coef[sl]])
        args = (w[None], None, tail.ye[sl][None], ggt[None], coef[None], vt)
    got = ensrf_grid.grid_apply_plain(t(bm), t(bp), *args, precision=mode)
    want = _np_grid(bm, bp, *(a.numpy() if torch.is_tensor(a) else a
                              for a in args), mode)
    ieee = ensrf_grid.grid_apply_plain(t(bm), t(bp), *args)
    for g, w_, f in zip(got, want, ieee):
        np.testing.assert_allclose(g.numpy(), w_, rtol=TOL, atol=TOL)
        assert float((g - f).abs().max()) > 1e-6


def test_numpy_rounding_is_the_ports():
    """The bit-operation rounding of this file and the port's
    ``round_inputs`` agree on random values and on the ties of each
    mode."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(4000) * 10.0 ** rng.integers(
        -6, 6, 4000), [1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                       1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -1.0 - 2.0 ** -8,
                       0.0, -0.0]]).astype(np.float32)
    for mode in ("tf32", "bf16"):
        want = _np_round(x, mode)
        got = precision.round_inputs(torch.from_numpy(x), mode)
        np.testing.assert_array_equal(got.double().numpy(), want)
        got64 = precision.round_inputs(torch.from_numpy(x.astype(np.float64)),
                                       mode)
        assert got64.dtype == torch.float64
        np.testing.assert_array_equal(got64.numpy(), want)
    ties = np.array([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8],
                    np.float32)
    # TF32 ties away from zero; bf16 ties to even.
    np.testing.assert_array_equal(_np_round(ties[:1], "tf32"),
                                  [1.0 + 2.0 ** -10])
    np.testing.assert_array_equal(_np_round(ties[1:], "bf16"),
                                  [1.0, 1.0 + 2.0 ** -6])


# ---------------------------------------------------------------------------
# 4. product_mode, and where the route hands the mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("value,mode", [
    (None, "ieee"), ("highest", "ieee"), ("float32", "ieee"),
    ("high", "tf32"), ("tensorfloat32", "tf32"), ("default", "bf16"),
    ("bfloat16", "bf16")])
def test_product_mode_table(value, mode):
    """``matmul_precision`` on the card, for every body kernel; the CPU,
    float64, B1/B1h and the tail stay fp32; ``mxu_bf16`` wins on B2, B2h
    and B3 on every device but not on B4."""
    for kernel in precision.BODY_KERNELS:
        cfg = FilterConfig(dtype="float32", matmul_precision=value)
        assert precision.product_mode(cfg, kernel, "cuda") == mode
        assert precision.product_mode(cfg, kernel, "cuda:1") == mode
        assert precision.product_mode(cfg, kernel, "cpu") == "ieee"
        f64 = FilterConfig(dtype="float64", matmul_precision=value,
                           mxu_bf16=True)
        assert precision.product_mode(f64, kernel, "cuda") == "ieee"
        mxu = FilterConfig(dtype="float32", matmul_precision=value,
                           mxu_bf16=True)
        for dev in ("cuda", "cpu"):
            want = ("bf16" if kernel in ("B2", "B2h", "B3")
                    else mode if dev == "cuda" else "ieee")
            assert precision.product_mode(mxu, kernel, dev) == want
    for kernel in ("B1", "B1h", "tail"):
        cfg = FilterConfig(dtype="float32", matmul_precision=value,
                           mxu_bf16=True)
        assert precision.product_mode(cfg, kernel, "cuda") == "ieee"


@pytest.fixture
def plain_spies(monkeypatch):
    """Records ``(rows, precision)`` of every call of the B2/B2h and B3/B4
    plain versions and counts B1's plain solves."""
    calls = {"B2": [], "grid": [], "B1": 0}

    def wrap(mod, name, key, at):
        real = getattr(mod, name)

        def spy(*a, **k):
            mode = k.get("precision", a[at] if len(a) > at else "ieee")
            calls[key].append((a[1].shape[0], mode))
            return real(*a, **k)
        monkeypatch.setattr(mod, name, spy)

    def count_b1(*a, **k):
        calls["B1"] += 1
        return real_b1(*a, **k)
    # ``precision``'s place among the positional arguments.
    wrap(ensrf_fused, "fused_apply_plain", "B2", 12)
    wrap(ensrf_grid, "grid_apply_plain", "grid", 8)
    real_b1 = tail_solve.tail_panel_solve_plain
    monkeypatch.setattr(tail_solve, "tail_panel_solve_plain", count_b1)
    return calls


@pytest.mark.parametrize("route,cfg,card,body", [
    ("B2", dict(fast_geometry=True, mxu_bf16=True), False, "bf16"),
    ("B2h", dict(fast_geometry=True, mxu_bf16=True, hybrid_alpha=0.5,
                 static_b_sigma=1.0, static_b_length=800.0), False, "bf16"),
    ("B3", dict(fast_geometry=True, mxu_bf16=True), False, "bf16"),
    ("B4", dict(mxu_bf16=True), False, "ieee"),
    ("B2", dict(fast_geometry=True, matmul_precision="tensorfloat32"), True,
     "tf32"),
    ("B4", dict(matmul_precision="bfloat16"), True, "bf16"),
    ("B4", dict(matmul_precision="bfloat16"), False, "ieee"),
])
def test_route_hands_the_mode_to_the_body_only(route, cfg, card, body,
                                               plain_spies, monkeypatch):
    """Each kernel route's body wrapper gets ``product_mode``'s mode (with
    ``card``, as on a CUDA device: the mode the card would run, here on
    the plain versions), B1 (B1h) solves the tail's panels and the tail's
    applies (B2 or B4 on the tail rows; B2h's tail applies in plain
    torch) stay ``"ieee"``."""
    if card:
        real = precision.product_mode
        monkeypatch.setattr(tensrf, "product_mode",
                            lambda c, k, d: real(c, k, "cuda"))
    nvars = 2 if route == "B3" else 1
    _, _, tstate, tbatch = _pair(dtype="float32", nvars=nvars, nobs=40)
    filt = EnSRF(tstate, tbatch, verbose=False, config=FilterConfig(
        localization="GC", dtype="float32", tail_panel=16, block_size=8,
        **cfg))
    assert filt._route(tstate.structure.nstate) == route
    filt.update()
    nrows = tstate.structure.nstate
    key = "grid" if route in ("B3", "B4") else "B2"
    body_calls = [p for n, p in plain_spies[key] if n == nrows]
    tail_calls = [p for k in ("B2", "grid") for n, p in plain_spies[k]
                  if n != nrows]
    assert body_calls and set(body_calls) == {body}
    assert set(tail_calls) == ({"ieee"} if route != "B2h" else set())
    assert plain_spies["B1"] == -(-tbatch.nobs // 16)


@pytest.mark.parametrize("route,cfg", [
    ("B2", dict(fast_geometry=True)),
    ("B2h", dict(fast_geometry=True, hybrid_alpha=0.5, static_b_sigma=1.0,
                 static_b_length=800.0)),
])
def test_mxu_bf16_reaches_every_shard(route, cfg, plain_spies):
    """``mxu_bf16`` in float32 on a mesh of two CPU shards: each shard's
    body gets ``"bf16"`` (the tail's applies ``"ieee"``), and the
    posterior is the single-device ``mxu_bf16`` one at 1e-6 (the body is
    row-local) and not the fp32 mesh one."""
    _, _, tstate, tbatch = _pair(dtype="float32", nmems=16, nobs=40)
    kw = dict(localization="GC", dtype="float32", tail_panel=16,
              block_size=8, **cfg)
    mesh = make_mesh(["cpu"] * 2)

    def run(m, **extra):
        filt = EnSRF(tstate, tbatch, verbose=False, mesh=m,
                     config=FilterConfig(**kw, **extra))
        return interop.state_to_numpy(filt.update()[0])

    single = run(None, mxu_bf16=True)
    fp32 = run(mesh)
    plain_spies["B2"].clear()
    got = run(mesh, mxu_bf16=True)
    shard_rows = -(-tstate.structure.nstate // 2)
    body = [p for n, p in plain_spies["B2"] if n == shard_rows]
    tail = [p for n, p in plain_spies["B2"] if n != shard_rows]
    assert body == ["bf16", "bf16"]
    assert set(tail) == ({"ieee"} if route == "B2" else set())
    np.testing.assert_allclose(got, single, rtol=1e-6, atol=1e-6)
    inc = np.abs(single - interop.state_to_numpy(tstate)).max()
    assert np.abs(got - fp32).max() > BF16_GATE * inc


@pytest.mark.parametrize("kernel", ["B2", "B2h", "B3"])
def test_plain_operands_are_the_apply_operands(kernel):
    """``operands=`` hands out each block's apply operands before
    rounding, ``(g o U or V [rows, B], Y [B, M])``: the perturbations move
    by exactly minus their rounded product, block after block, and the
    list changes nothing."""
    bm, bp, lat, lon, tail, obs, sigma = _scattered(nstate=3 * 41)
    t = torch.from_numpy
    if kernel == "B3":
        ops = ensrf_grid.grid_prepare(t(bp), None, tail, obs, ngrid=41,
                                      block_size=16)
        w = ensrf_grid.grid_weights(
            ensrf_grid.latlon_to_unit(t(lat[:41]), t(lon[:41])),
            ops["ob_xyz"], ops["radii"]).reshape(-1, 16, 41)
        args = (w, None, ops["y_b"], ops["ggt_b"], ops["coef_b"], 3)
        run = ensrf_grid.grid_apply_plain
    else:
        hybrid = kernel == "B2h"
        if not hybrid:
            tail = tail._replace(static_gain=None, static_sqrt=None)
        ops = ensrf_fused.prepare(
            t(bp), t(lat), t(lon), tail, obs, block_size=16, cull=True,
            max_radius_km=900.0, hybrid=hybrid, body_sigma=t(sigma),
            static_length=1200.0 if hybrid else None)
        args = (ops["geom"], ops["y_b"], ops["ggt_b"], ops["tab_b"],
                ops["bits"], ops["tile"], True, False, ops["series"], hybrid)
        run = ensrf_fused.fused_apply_plain
    x = t(bp)
    for b in range(ops["y_b"].shape[0]):
        blk = list(args)
        if kernel == "B3":
            blk[0], blk[2:5] = args[0][b:b + 1], [a[b:b + 1]
                                                  for a in args[2:5]]
        else:
            blk[1:4] = [a[b:b + 1] for a in args[1:4]]
            blk[4] = args[4][:, b:b + 1]
        seen = []
        _, out = run(t(bm), x, *blk, precision="bf16", operands=seen)
        (left, y), = seen
        assert left.shape == (len(bm), 16) and torch.equal(y, blk[
            2 if kernel == "B3" else 1][0])
        want = x - (precision.round_inputs(left, "bf16")
                    @ precision.round_inputs(y, "bf16"))
        torch.testing.assert_close(out, want, rtol=1e-12, atol=1e-12)
        x = out
    whole = run(t(bm), t(bp), *args, precision="bf16")
    torch.testing.assert_close(whole[1], x, rtol=0, atol=0)
