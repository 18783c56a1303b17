"""The port's Lorenz-96 cycling examples against the JAX package's
scripts, on the CPU (``examples/cycling_adaptive.py`` and
``cycling_smoother.py``; the conventions of
``tests/test_torch_examples.py``).  The JAX scripts draw their spin-ups
with ``jax.random``; the port's ``run`` gets those draws.  Both run in
float64 and agree at 1e-9 on every cycle.
"""

import numpy as np
import pytest
import torch

from efa_xray_tpu.models import lorenz96 as jl96
from efa_xray_tpu.models.cycling import CyclingHarness as JHarness
from test_torch_adaptive_inflation import jax_stable_root  # noqa: F401
from test_torch_examples import (
    _close,
    _run_jax,
    _run_port,
    _same_text,
    _spy_method,
)


# --- the Lorenz-96 scripts the Lorenz-96 cycling scripts -------------------------------------

def _l96_inputs(seed, nvars=40, nmems=20):
    """The JAX script's spin-up (``jax.random``) for the port's ``run``."""
    truth, ens = jl96.spinup_ensemble(nvars=nvars, nmems=nmems, seed=seed)
    return lambda args: dict(truth=torch.from_numpy(np.array(truth)),
                             ens=torch.from_numpy(np.array(ens)))


def _same_stats(got, want, tol):
    assert [s.cycle for s in got] == [s.cycle for s in want]
    for f in ("analysis_rmse", "background_rmse", "mean_spread",
              "obs_prior_rmse", "obs_post_rmse", "analysis_crps"):
        _close([getattr(s, f) for s in got], [getattr(s, f) for s in want],
               tol, f)


def test_cycling_adaptive_matches_jax(monkeypatch, capsys, jax_stable_root):
    """40 cycles at the defaults from the JAX spin-up, float64, the JAX
    package's Anderson root taken without its cancellation (the
    ``jax_stable_root`` fixture): every cycle's statistics, the learned
    inflation field and the final ensemble at 1e-9."""
    runs = _spy_method(monkeypatch, JHarness, "run", [])
    _, jout = _run_jax(monkeypatch, capsys, "cycling_adaptive", [])
    _, pout, res = _run_port(monkeypatch, capsys, "cycling_adaptive", [],
                             inputs=_l96_inputs(7))
    _same_text(jout, pout)
    (jh, jstats), = runs
    _same_stats(res["stats"], jstats, 64)
    lam = jh.inflation_field()
    _close(res["harness"].inflation_field(), lam, 64, "inflation field")
    _close(res["harness"]._final_ensemble, jh._final_ensemble, 64,
           "final ensemble")
    want = dict(lam_mean=lam.mean(), lam_max=lam.max(),
                tail_rmse=np.mean([s.analysis_rmse for s in jstats[-8:]]))
    for k, v in want.items():
        _close(res[k], v, 64, k)


@pytest.mark.parametrize("opts", [[], ["--iau", "4"]], ids=["lag3", "iau4"])
def test_cycling_smoother_matches_jax(monkeypatch, capsys, opts):
    """40 cycles with ``smoother_lag`` 3, with and without ``iau_steps`` 4,
    from the JAX spin-up, float64: every cycle's statistics, the smoothed
    RMSEs and their means at 1e-9."""
    runs = _spy_method(monkeypatch, JHarness, "run", [])
    _, jout = _run_jax(monkeypatch, capsys, "cycling_smoother", opts)
    _, pout, res = _run_port(monkeypatch, capsys, "cycling_smoother", opts,
                             inputs=_l96_inputs(13))
    _same_text(jout, pout)
    (jh, jstats), = runs
    _same_stats(res["stats"], jstats, 64)
    smoothed = jh.smoothed_rmse()
    got = res["harness"].smoothed_rmse()
    assert [c for c, _ in got] == [c for c, _ in smoothed]
    _close([r for _, r in got], [r for _, r in smoothed], 64, "smoothed")
    filt = {s.cycle: s.analysis_rmse for s in jstats}
    pairs = [(c, r) for c, r in smoothed if c >= 10]
    _close(res["filter_mean"], np.mean([filt[c] for c, _ in pairs]), 64,
           "filter mean")
    _close(res["smoothed_mean"], np.mean([r for _, r in pairs]), 64,
           "smoothed mean")
