"""The EnSRF options of the cycled production filter in the port against
the JAX package (float64, CPU, where the kernels' plain versions run):
RTPS/RTPP, ``obs_order="hilbert"``, ``spatial_sort`` and ``obs_chunk`` on
every route, with the reference's stale ``_obs_unsort`` pinned rather than
copied."""

import numpy as np
import pytest
import torch

from efa_xray_tpu.assimilation import adaptive_inflation as JA
from efa_xray_tpu.assimilation.ensrf import EnSRF as JEnSRF
from efa_xray_tpu.config import FilterConfig as JConfig
from efa_xray_tpu_torch import EnSRF, FilterConfig, interop
from efa_xray_tpu_torch.assimilation import adaptive_inflation as TA
from efa_xray_tpu_torch.assimilation import ensrf as ensrf_mod
from efa_xray_tpu_torch.ops import ensrf_fused, ensrf_grid, tail_solve
from test_torch_ensrf import _compare_updates, _pair

TOL = 1e-9
DIAGS = ("prior_mean", "prior_var", "post_mean", "post_var")
B2_KW = dict(localization="GC", dtype="float64", fast_geometry=True,
             tail_panel=8, block_size=4)


def _jax_kernel_cfg(**kw):
    """The JAX package's kernel route (Pallas in interpret mode)."""
    return JConfig(use_pallas=True, tail_pallas=True, **kw)


def _assert_same_update(a, b, tol):
    (post_a, obs_a), (post_b, obs_b) = a, b
    np.testing.assert_allclose(interop.state_to_numpy(post_a),
                               interop.state_to_numpy(post_b), rtol=tol,
                               atol=tol)
    for k in DIAGS:
        x, y = getattr(obs_a, k), getattr(obs_b, k)
        np.testing.assert_array_equal(np.isnan(x), np.isnan(y))
        np.testing.assert_allclose(x[~np.isnan(x)], y[~np.isnan(y)],
                                   rtol=tol, atol=tol, err_msg=k)
    np.testing.assert_array_equal(obs_a.assimilated, obs_b.assimilated)


# --- RTPS / RTPP -----------------------------------------------------------


@pytest.mark.parametrize("alpha", [0.0, 0.3, 1.0])
def test_relaxation_functions_match_jax(alpha):
    rng = np.random.default_rng(2)
    prior = rng.normal(0, 2.0, (50, 12))
    post = 0.6 * prior + rng.normal(0, 0.3, (50, 12))
    post[7] = 0.0  # a collapsed row: RTPS leaves it
    t = lambda x: torch.from_numpy(x.copy())
    sb = TA.row_spread(t(prior))
    np.testing.assert_allclose(sb.numpy(), np.asarray(JA.row_spread(prior)),
                               rtol=1e-12)
    got = TA.rtps(sb, t(post), alpha).numpy()
    np.testing.assert_allclose(
        got, np.asarray(JA.rtps(JA.row_spread(prior), post, alpha)),
        rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        TA.rtpp(t(prior), t(post), alpha).numpy(),
        np.asarray(JA.rtpp(prior, post, alpha)), rtol=1e-12, atol=1e-12)
    # the endpoints: no-op at 0; at 1 the prior spread (RTPS) or the prior
    # perturbations (RTPP) come back
    if alpha == 0.0:
        np.testing.assert_array_equal(got, post)
    if alpha == 1.0:
        live = np.arange(50) != 7
        np.testing.assert_allclose(
            TA.row_spread(torch.from_numpy(got)).numpy()[live],
            sb.numpy()[live], rtol=1e-12)
        np.testing.assert_array_equal(got[7], 0.0)
        np.testing.assert_allclose(TA.rtpp(t(prior), t(post), 1.0).numpy(),
                                   prior, rtol=1e-12)


@pytest.mark.parametrize("relax", [dict(rtps_alpha=0.5),
                                   dict(rtpp_alpha=0.5)])
def test_relaxation_through_update_matches_jax(relax):
    kw = dict(B2_KW, **relax)
    _compare_updates(_jax_kernel_cfg(**kw), FilterConfig(**kw))


def test_rtpp_copies_the_prior_before_the_body_updates_it(monkeypatch):
    """The body kernels update the prior in place (``donate=True``); RTPP
    must blend with a copy of the prior taken before.  Here B2's plain
    version is made to write in place as the CUDA kernel does: the body's
    input buffer ends up holding the posterior, and RTPP still meets the
    JAX package."""
    real = ensrf_mod.fused_body
    seen = []

    def in_place(bm, bp, *a, donate=False, **k):
        out_m, out_p = real(bm, bp, *a, donate=donate, **k)
        if not donate:
            return out_m, out_p
        bm.copy_(out_m)
        bp.copy_(out_p)
        seen.append(bp)
        return bm, bp

    monkeypatch.setattr(ensrf_mod, "fused_body", in_place)
    kw = dict(B2_KW, rtpp_alpha=0.5)
    jpost, _, tpost, _, _ = _compare_updates(_jax_kernel_cfg(**kw),
                                             FilterConfig(**kw))
    assert len(seen) == 1
    # The body's buffer holds the unrelaxed posterior perturbations, which
    # is what RTPP would have blended with had it taken no copy
    # ((1 - a) X_a + a X_a = X_a): the relaxed posterior differs from it.
    data = interop.state_to_numpy(tpost)
    relaxed = (data - data.mean(-1, keepdims=True)).reshape(seen[0].shape)
    assert not np.allclose(relaxed, seen[0].numpy(), rtol=1e-3, atol=1e-3)


# --- obs_order --------------------------------------------------------------


def test_obs_order_matches_jax_in_the_callers_order():
    kw = dict(B2_KW, obs_order="hilbert")
    _, _, _, tobs, _ = _compare_updates(_jax_kernel_cfg(**kw),
                                        FilterConfig(**kw))
    _, jbatch, _, tbatch = _pair()
    np.testing.assert_array_equal(tobs.values, tbatch.values)
    np.testing.assert_array_equal(tobs.lats, tbatch.lats)
    assert tobs.obtypes == list(tbatch.obtypes)
    # the sort did reorder the batch
    _, order = tbatch.spatial_sort()
    assert not np.array_equal(order, np.arange(len(order)))


def test_obs_order_second_update_of_one_filter():
    """Fault of the reference, pinned: the JAX package restores the
    caller's order from ``self.obs`` (``assimilation.py:641-645``), which
    its first ``update()`` already restored, so a second ``update()`` of
    one filter pairs the caller-order values with the sorted taps and
    reorders them again.  The port keeps the sorted batch apart: every
    ``update()`` of a filter gives the same result, in the caller's
    order."""
    kw = dict(B2_KW, obs_order="hilbert")
    jstate, jbatch, tstate, tbatch = _pair()
    filt = EnSRF(tstate, tbatch, config=FilterConfig(**kw), verbose=False)
    first = filt.update()
    second = filt.update()
    _assert_same_update(first, second, 1e-12)
    np.testing.assert_array_equal(second[1].values, tbatch.values)
    jfilt = JEnSRF(jstate, jbatch, config=_jax_kernel_cfg(**kw),
                   verbose=False)
    _, jfirst = jfilt.update()
    jfirst.materialize_diagnostics()
    pm = np.array(jfirst.prior_mean)
    _, jsecond = jfilt.update()
    jsecond.materialize_diagnostics()
    assert not np.allclose(np.asarray(jsecond.prior_mean), pm)
    np.testing.assert_allclose(first[1].prior_mean, pm, rtol=TOL, atol=TOL)


# --- spatial_sort -----------------------------------------------------------


def test_spatial_sort_equals_no_sort_on_the_b2_route():
    """A row permutation around B2's plain version, undone after it: the
    same update, and the JAX package's spatial-sort update."""
    _, _, tstate, tbatch = _pair(nobs=23, seed=8)
    cfgs = [FilterConfig(spatial_sort=s, **B2_KW) for s in (False, True)]
    filt = EnSRF(tstate, tbatch, config=cfgs[1], verbose=False)
    assert filt._route(tstate.structure.nstate) == "B2"
    runs = [EnSRF(tstate, tbatch, config=c, verbose=False).update()
            for c in cfgs]
    _assert_same_update(runs[0], runs[1], 1e-12)
    _compare_updates(_jax_kernel_cfg(spatial_sort=True, **B2_KW),
                     FilterConfig(spatial_sort=True, **B2_KW), nobs=23,
                     seed=8)


def test_spatial_order_is_a_cached_permutation_per_device():
    _, _, tstate, _ = _pair()
    st = tstate.structure
    order, inv = st.spatial_order_device("cpu")
    n = st.nstate
    assert sorted(order.tolist()) == list(range(n))
    np.testing.assert_array_equal(order[inv].numpy(), np.arange(n))
    assert st.spatial_order_device("cpu")[0] is order
    assert st.spatial_order_device("meta")[0].device.type == "meta"


# --- obs_chunk --------------------------------------------------------------


ROUTES = {
    "B2": (dict(B2_KW), dict(ntimes=1)),
    "B3": (dict(localization="GC", dtype="float64", fast_geometry=True,
                block_size=4, tail_panel=8), dict(ntimes=2)),
    "B4": (dict(localization="GC", dtype="float64", block_size=4,
                tail_panel=8), dict(ntimes=1)),
    "plain": (dict(localization="GC", dtype="float64", block_size=4),
              dict(ntimes=2)),
    "serial": (dict(localization="GC", dtype="float64", method="serial"),
               dict(ntimes=1)),
}


@pytest.mark.parametrize("route,chunk", [
    ("B2", 4), ("B2", 7), ("B3", 5), ("B4", 6), ("plain", 4),
    ("serial", 5)])
def test_obs_chunk_equals_one_shot(route, chunk, monkeypatch):
    """The chunked driver (tail once over the padded batch, body chunk by
    chunk along the route) against the one-shot update, with a ragged
    last chunk and obs that are not assimilated (mirrors
    ``tests/test_ensrf.py:486``).  The plain route is taken by switching
    the kernel route off, as ``dtype="float64"`` on the card does."""
    cfg_kw, pair_kw = ROUTES[route]
    if route == "plain":
        monkeypatch.setattr(EnSRF, "_use_kernels", lambda self: False)
    _, _, tstate, tbatch = _pair(nobs=19, **pair_kw)
    one = EnSRF(tstate, tbatch, config=FilterConfig(**cfg_kw), verbose=False)
    assert one._route(tstate.structure.nstate) == route
    many = FilterConfig(obs_chunk=chunk, **cfg_kw)
    calls = []
    real = EnSRF._body_apply

    def spy(self, r, *a, **k):
        calls.append(r)
        return real(self, r, *a, **k)

    monkeypatch.setattr(EnSRF, "_body_apply", spy)
    got = EnSRF(tstate, tbatch, config=many, verbose=False).update()
    want = one.update()
    # the chunks' sweeps, then the one-shot body of a kernel route
    one_shot = [] if route in ("plain", "serial") else [route]
    assert calls == [route] * -(-19 // chunk) + one_shot
    _assert_same_update(got, want, 1e-10)
    assert not tbatch.assimilate_flags.all()


def test_obs_chunk_matches_jax_on_the_b2_route():
    kw = dict(B2_KW, obs_chunk=6)
    _compare_updates(_jax_kernel_cfg(**kw), FilterConfig(**kw))
    assert tail_solve.launches == 0 and ensrf_fused.launches == 0
    assert ensrf_grid.b3_launches == 0 and ensrf_grid.b4_launches == 0


@pytest.mark.parametrize("extra", [
    dict(hybrid_alpha=0.5, static_b_sigma=1.0, static_b_length=500.0),
    dict(variable_localization={"T2m:T1_2m": 0.5}),
])
def test_obs_chunk_refuses_hybrid_and_varloc(extra):
    _, _, tstate, tbatch = _pair(nvars=2)
    cfg = FilterConfig(obs_chunk=4, **dict(B2_KW, **extra))
    with pytest.raises(ValueError, match="obs_chunk"):
        EnSRF(tstate, tbatch, config=cfg, verbose=False).update()


def test_obs_order_composes_with_obs_chunk():
    kw = dict(B2_KW, obs_order="hilbert", obs_chunk=5)
    _, _, _, tobs, _ = _compare_updates(_jax_kernel_cfg(**kw),
                                        FilterConfig(**kw))
    _, _, _, tbatch = _pair()
    np.testing.assert_array_equal(tobs.values, tbatch.values)
