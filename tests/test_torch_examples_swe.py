"""The port's multivariate shallow-water example against the JAX
package's script (``examples/multivariate_swe.py``), on the CPU, with the
conventions of ``tests/test_torch_examples.py``.  The JAX script draws
its members' noise from NumPy and pins JAX to the CPU; the port's members
come from a ``torch.Generator``, so its ``run`` gets the JAX spin-up.
Float32: the f32 gate.
"""

import unittest.mock as mock

import numpy as np
import torch

from efa_xray_tpu.models import swe as jswe
from efa_xray_tpu.models.cycling import CyclingHarness as JHarness
from efa_xray_tpu_torch.examples import multivariate_swe
from test_torch_examples import (
    _close,
    _jax_script,
    _run_jax,
    _run_port,
    _same_text,
    _spy_method,
)
from test_torch_examples_cycling import _same_stats

# The script spins the channel up for 2500 + 400 steps (about 2 min in
# the JAX package on the CPU, most of it compiling an integration per
# length); the test cuts both to 200, the forecast-impact length, so that
# the JAX package compiles each integration once.  Nothing in the script
# depends on the lengths but the state it starts from, which both
# packages get from the JAX spin-up.
SWE_CUT = dict(spinup_steps=200, member_steps=200)


def test_multivariate_swe_matches_jax(monkeypatch, capsys):
    """The single height-only analysis, the 200-step forecast impact and 5
    cycles on the 16 x 32 channel, 12 members, from the JAX spin-up (cut,
    ``SWE_CUT``): the analysis, every per-variable RMSE and the cycles'
    statistics at the f32 gate; and the port's own spin-up."""
    jmod = _jax_script("multivariate_swe")
    spin = jswe.spinup_ensemble
    spun = []

    def spinup(*a, **k):
        k.update(SWE_CUT)
        spun.append(spin(*a, **k))
        return spun[-1]

    monkeypatch.setattr(jswe, "spinup_ensemble", spinup)
    integrate = jswe.integrate
    forecasts = []

    def integrate_spy(state, ny, nsteps=1, **k):
        out = integrate(state, ny, nsteps, **k)
        if nsteps == multivariate_swe.FORECAST_STEPS:
            forecasts.append(out)  # the spin-up's two, then the script's
        return out

    monkeypatch.setattr(jswe, "integrate", integrate_spy)
    analyses = _spy_method(monkeypatch, JHarness, "analysis_step", [])
    runs = _spy_method(monkeypatch, JHarness, "run", [])
    _, jout = _run_jax(monkeypatch, capsys, "multivariate_swe", [])

    def inputs(args):
        (truth, ens), = spun
        t = lambda d: {k: torch.tensor(np.asarray(v), dtype=torch.float32)
                       for k, v in d.items()}
        return dict(truth=t(truth), ens=t(ens))

    _, pout, res = _run_port(monkeypatch, capsys, "multivariate_swe", [],
                             inputs=inputs)
    _same_text(jout, pout)
    _, (jpost, _) = analyses[0]  # then one per cycle of run()
    _close(res["post"], jpost, 32, "analysis")
    (truth, ens), = spun
    ny, nx, n = 16, 32, 16 * 32
    flat = lambda d: np.asarray(jswe.pack(d, ny, nx))
    tr_fc, pri_fc, pos_fc = forecasts[-3:]
    want = dict(
        background_rmse=jmod.per_var_rmse(flat(ens), flat(truth), n),
        analysis_rmse=jmod.per_var_rmse(np.asarray(jpost), flat(truth), n),
        forecast_background_rmse=jmod.per_var_rmse(
            flat(pri_fc), flat(tr_fc), n),
        forecast_analysis_rmse=jmod.per_var_rmse(
            flat(pos_fc), flat(tr_fc), n))
    for key, rmse in want.items():
        for v, x in rmse.items():
            _close(res[key][v], x, 32, f"{key} {v}")
    (_, jstats), = runs
    _same_stats(res["stats"], jstats, 32)

    # The port's own spin-up (``inputs``, cut alike): the truth is
    # NumPy-seeded and integrated alike in both packages; the members
    # come from a ``torch.Generator``, spun up, finite.
    args = multivariate_swe.parse_args(["--device", "cpu"])
    with mock.patch.multiple(multivariate_swe,
                             SPINUP_STEPS=SWE_CUT["spinup_steps"],
                             MEMBER_STEPS=SWE_CUT["member_steps"]):
        inp = multivariate_swe.inputs(args)
    for k in jswe.VAR_ORDER:
        _close(inp["truth"][k], truth[k], 32, k)
        assert inp["ens"][k].shape == (12, 16, 32)
        assert torch.isfinite(inp["ens"][k]).all()
