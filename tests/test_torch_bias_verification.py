"""Observation bias correction and obs-space verification in the port
against the JAX package (float64, CPU): ``BiasCorrection`` over a few
batches and its JSON state, ``crps``, ``rank_histogram`` and
``innovation_consistency``."""

import dataclasses

import numpy as np
import pytest

from efa_xray_tpu.assimilation.ensrf import EnSRF as JEnSRF
from efa_xray_tpu.config import FilterConfig as JConfig
from efa_xray_tpu.observation.bias import BiasCorrection as JBias
from efa_xray_tpu.postprocess import verification as jver
from efa_xray_tpu_torch import EnSRF, FilterConfig
from efa_xray_tpu_torch.observation.bias import BiasCorrection
from efa_xray_tpu_torch.postprocess import verification as tver
from test_torch_ensrf import _pair

TOL = 1e-9


def _with_types(batch, rng):
    """Two obtypes, a few outliers flagged, one non-finite prior."""
    n = batch.nobs
    b = dataclasses.replace(
        batch, obtypes=["T2m" if i % 3 else "Td" for i in range(n)],
        assimilate_flags=rng.random(n) > 0.2)
    b.prior_mean = b.values - rng.normal(0.4, 1.0, n)
    b.prior_mean[4] = np.nan
    b.qc_outlier = rng.random(n) > 0.85
    return b


@pytest.mark.parametrize("alpha,min_count", [(0.2, 2), (1.0, 1), (0.5, 5)])
def test_bias_correction_matches_jax(alpha, min_count, tmp_path):
    _, jbatch, _, tbatch = _pair(nobs=19, seed=3)
    jb, tb = JBias(alpha=alpha, min_count=min_count), BiasCorrection(
        alpha=alpha, min_count=min_count)
    rng = np.random.default_rng(4)
    for _ in range(4):
        state = rng.bit_generator.state
        jbatch_i = _with_types(jbatch, rng)
        rng.bit_generator.state = state
        tbatch_i = _with_types(tbatch, rng)
        assert tb.update(tbatch_i) == pytest.approx(jb.update(jbatch_i),
                                                    rel=TOL, abs=TOL)
        np.testing.assert_allclose(tb.correct(tbatch_i).values,
                                   jb.correct(jbatch_i).values, rtol=TOL,
                                   atol=TOL)
        for t in ("T2m", "Td", "unseen"):
            assert tb.offset_for(t) == pytest.approx(jb.offset_for(t),
                                                     rel=TOL, abs=TOL)
    assert tb.to_dict() == jb.to_dict()
    tb.save(str(tmp_path / "bias.json"))
    assert BiasCorrection.load(str(tmp_path / "bias.json")).to_dict() == \
        JBias.load(str(tmp_path / "bias.json")).to_dict()
    with pytest.raises(ValueError):
        BiasCorrection(alpha=0.0)


def _posteriors():
    kw = dict(localization="GC", dtype="float64", fast_geometry=True,
              tail_panel=8, block_size=4)
    jstate, jbatch, tstate, tbatch = _pair(nobs=19, seed=6)
    jpost, jobs = JEnSRF(jstate, jbatch, verbose=False,
                         config=JConfig(use_pallas=True, tail_pallas=True,
                                        **kw)).update()
    tpost, tobs = EnSRF(tstate, tbatch, verbose=False,
                        config=FilterConfig(**kw)).update()
    return jpost, jobs, tpost, tobs


@pytest.mark.parametrize("fair", [False, True])
def test_crps_matches_jax(fair):
    jpost, jobs, tpost, tobs = _posteriors()
    jper, jmean = jver.crps(jpost, jobs, fair=fair)
    tper, tmean = tver.crps(tpost, tobs, fair=fair)
    np.testing.assert_allclose(tper, jper, rtol=TOL, atol=TOL)
    assert tmean == pytest.approx(jmean, rel=TOL, abs=TOL)
    assert np.isfinite(tper).all() and tmean > 0


def test_rank_histogram_and_innovation_consistency_match_jax():
    jpost, jobs, tpost, tobs = _posteriors()
    got = tver.rank_histogram(tpost, tobs)
    np.testing.assert_array_equal(got, jver.rank_histogram(jpost, jobs))
    assert got.shape == (tpost.structure.nmems + 1,)
    assert got.sum() == tobs.nobs
    want = jver.innovation_consistency(jobs)
    got = tver.innovation_consistency(tobs)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=TOL, abs=TOL), k
    with pytest.raises(ValueError):
        tver.innovation_consistency(_pair()[3])
