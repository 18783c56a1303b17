"""A mini BASELINE config 13 (the cycled production filter of
``benchmarks/cycled_production.py``) in the JAX package and in the port,
from the same initial ensemble: the L96-2d forecast, synthetic biased obs,
online bias correction, ``EnSRF.update()`` with ``fast_geometry``, the
outlier check and Anderson adaptive inflation with the evolved std,
damping and a cap, and the obs-space CRPS, cycle after cycle (float64,
CPU; the port's B1/B2 route runs its plain versions).

The JAX package runs with its Anderson root taken without cancellation
(the ``jax_stable_root`` fixture of ``test_torch_adaptive_inflation.py``),
the one place where the port departs from it on purpose: with the
reference's root, an ob at the edge of its support puts errors of up to
~0.5 into lambda (pinned there), which the next cycles carry.  Everything
is then held at 1e-9.
"""

import dataclasses

import numpy as np
import torch

import jax.numpy as jnp

from efa_xray_tpu.assimilation.adaptive_inflation import (
    AdaptiveInflation as JAdaptive,
)
from efa_xray_tpu.assimilation.ensrf import EnSRF as JEnSRF
from efa_xray_tpu.config import FilterConfig as JConfig
from efa_xray_tpu.models import l96_2d as jl96
from efa_xray_tpu.observation import forward as jfwd
from efa_xray_tpu.observation.bias import BiasCorrection as JBias
from efa_xray_tpu.observation.observation import ObservationBatch as JBatch
from efa_xray_tpu.postprocess.verification import crps as jcrps
from efa_xray_tpu.state.ensemble import EnsembleState as JState
from efa_xray_tpu.state.structure import StateStructure as JStructure
from efa_xray_tpu.utils import timeutil
from efa_xray_tpu_torch import (
    AdaptiveInflation,
    EnSRF,
    FilterConfig,
    interop,
)
from efa_xray_tpu_torch.models import l96_2d
from efa_xray_tpu_torch.observation.bias import BiasCorrection
from efa_xray_tpu_torch.observation.observation import ObservationBatch
from efa_xray_tpu_torch.postprocess.verification import crps
from efa_xray_tpu_torch.state.ensemble import EnsembleState
from efa_xray_tpu_torch.state.structure import StateStructure
from test_torch_adaptive_inflation import jax_stable_root  # noqa: F401

TOL = 1e-9
NY, NX, NMEMS, NOBS, NCYCLES = 16, 32, 12, 120, 3
RADIUS, OB_BIAS = 1500.0, 0.3
# The production flags of benchmarks/cycled_production.py.
FLAGS = dict(localization="GC", dtype="float64", fast_geometry=True,
             outlier_threshold=4.0, adaptive_sd_evolve=True,
             adaptive_sd_min=0.15, adaptive_damp=0.7, adaptive_max=1.7)


def _batch(cls, values, lats, lons, times_s):
    n = len(values)
    return cls(values=values, errors=np.ones(n), lats=lats, lons=lons,
               times_s=times_s, obtypes=["X"] * n,
               localize_radius=np.full(n, RADIUS),
               assimilate_flags=np.ones(n, bool), verts=np.full(n, np.nan),
               descriptions=[None] * n)


def _setup():
    """Both packages' cycle objects, from the same spun-up ensemble and
    the same stationary off-grid network."""
    truth0, ens0 = jl96.spinup_ensemble(ny=NY, nx=NX, nmems=NMEMS, seed=3,
                                        spinup_steps=80)
    truth0, ens0 = np.array(truth0), np.array(ens0)
    lat, lon = jl96.grid_latlon(NY, NX)
    tlat, tlon = l96_2d.grid_latlon(NY, NX)
    np.testing.assert_array_equal(tlat, lat)
    np.testing.assert_array_equal(tlon, lon)
    times = np.datetime64("2026-08-01T00:00:00") + np.arange(1)
    jst = JStructure.build(["X"], times, lat, lon, NMEMS)
    tst = StateStructure.build(["X"], times, lat, lon, NMEMS)
    rng = np.random.default_rng(11)
    olat = rng.uniform(-58.0, 58.0, NOBS)
    olon = rng.uniform(0.0, 360.0, NOBS)
    times_s = timeutil.to_epoch_seconds(np.repeat(times[0], NOBS))
    x = dict(
        olat=olat, olon=olon, times_s=times_s,
        taps=jfwd.build_taps(jst, olat, olon, times_s,
                             np.zeros(NOBS, dtype=np.int32)),
        noise=rng.normal(0.0, 1.0, (NCYCLES, NOBS)),
        # The JAX package's kernel route (its Pallas kernels in interpret
        # mode), as on a TPU: the port's B1/B2 route takes the kernels'
        # angle forms.
        jcfg=JConfig(use_pallas=True, tail_pallas=True, **FLAGS),
        tcfg=FilterConfig(**FLAGS),
        as_j=lambda e: JState(jnp.transpose(jnp.asarray(e), (1, 2, 0))[
            None, None], jst),
        as_t=lambda e: EnsembleState(torch.from_numpy(np.ascontiguousarray(
            np.transpose(e, (1, 2, 0))[None, None])), tst),
        jtruth=jnp.asarray(truth0), jens=jnp.asarray(ens0),
        ttruth=torch.from_numpy(truth0), tens=torch.from_numpy(ens0),
        jbias=JBias(alpha=0.2), tbias=BiasCorrection(alpha=0.2))
    x["jadapt"] = JAdaptive(x["as_j"](ens0), ("adaptive", "/nonexistent.nc",
                                              (1.0, 0.6)))
    x["tadapt"] = AdaptiveInflation(x["as_t"](ens0),
                                    ("adaptive", "/nonexistent.nc",
                                     (1.0, 0.6)))
    return x


def _raw_obs(x, c):
    """Cycle ``c``'s biased synthetic obs of the (JAX) truth."""
    ye_t = np.asarray(jfwd.apply_taps_obj(x["jtruth"].reshape(-1, 1),
                                          x["taps"]))[:, 0]
    return ye_t + x["noise"][c] + OB_BIAS


def _jax_cycle(x, c):
    """One cycle of the JAX package: forecast, obs, bias-correct, update
    (learning the inflation), learn the bias, CRPS."""
    x["jtruth"] = jl96.integrate(x["jtruth"], nsteps=4)
    x["jens"] = jl96.integrate(x["jens"], nsteps=4)
    raw = _raw_obs(x, c)
    jb = x["jbias"].correct(_batch(JBatch, raw, x["olat"], x["olon"],
                                   x["times_s"]))
    post, out = JEnSRF(x["as_j"](x["jens"]), jb, inflation=x["jadapt"],
                       config=x["jcfg"], verbose=False).update()
    out.materialize_diagnostics()
    x["jbias"].update(dataclasses.replace(out, values=raw))
    x["jens"] = jnp.transpose(post.data[0, 0], (2, 0, 1))
    return dict(batch=jb, post=np.asarray(post.data), out=out,
                crps=jcrps(post, jb)[1])


def _port_cycle(x, c):
    """The same cycle through the port."""
    x["ttruth"] = l96_2d.integrate(x["ttruth"], nsteps=4)
    x["tens"] = l96_2d.integrate(x["tens"], nsteps=4)
    raw = _raw_obs(x, c)
    tb = x["tbias"].correct(_batch(ObservationBatch, raw, x["olat"],
                                   x["olon"], x["times_s"]))
    post, out = EnSRF(x["as_t"](x["tens"].numpy()), tb, inflation=x["tadapt"],
                      config=x["tcfg"], verbose=False).update()
    x["tbias"].update(dataclasses.replace(out, values=raw))
    x["tens"] = post.data[0, 0].permute(2, 0, 1).contiguous()
    return dict(batch=tb, post=post.data.numpy(), out=out,
                crps=crps(post, tb)[1])


def _assert_cycles_match(x, j, t):
    close = lambda a, b, msg: np.testing.assert_allclose(
        a, b, rtol=TOL, atol=TOL, err_msg=msg)
    close(x["tens"].numpy(), np.asarray(x["jens"]), "posterior ensemble")
    close(t["post"], j["post"], "posterior state")
    close(t["batch"].values, j["batch"].values, "bias-corrected obs")
    np.testing.assert_array_equal(t["out"].qc_outlier, j["out"].qc_outlier)
    np.testing.assert_array_equal(t["out"].assimilated, j["out"].assimilated)
    for k in ("prior_mean", "prior_var", "post_mean", "post_var"):
        a, b = getattr(t["out"], k), getattr(j["out"], k)
        ok = ~np.isnan(b)
        np.testing.assert_array_equal(np.isnan(a), ~ok)
        close(a[ok], b[ok], k)
    for k in ("mean", "std"):
        close(getattr(x["tadapt"], k)["X"], getattr(x["jadapt"], k)["X"],
              f"inflation {k}")
    close(x["tbias"].offset_for("X"), x["jbias"].offset_for("X"), "bias")
    close(t["crps"], j["crps"], "CRPS")


def test_mini_config13_cycles_match_jax(jax_stable_root):
    x = _setup()
    for c in range(NCYCLES):
        _assert_cycles_match(x, _jax_cycle(x, c), _port_cycle(x, c))
    # the cycle learned: inflation left its initial value, within its cap
    lam = x["tadapt"].mean["X"]
    assert lam.max() > 1.0 + 1e-3 and lam.max() <= 1.7 + 1e-12
    assert x["tbias"].offset_for("X") != 0.0


def test_port_takes_over_the_jax_cycle_midway(jax_stable_root):
    """The cycle's state crosses mid-cycle: after two JAX cycles, the port
    starts from the JAX package's ensemble, truth, inflation fields
    (``interop.adaptive_inflation_from_numpy``) and bias estimate
    (``to_dict`` / ``from_dict``), and its next cycle matches the JAX
    package's."""
    x = _setup()
    for c in range(NCYCLES - 1):
        _jax_cycle(x, c)
    x["tens"] = torch.from_numpy(np.array(x["jens"]))
    x["ttruth"] = torch.from_numpy(np.array(x["jtruth"]))
    jad = x["jadapt"]
    x["tadapt"] = interop.adaptive_inflation_from_numpy(
        x["as_t"](x["tens"].numpy()),
        {v: np.asarray(f) for v, f in jad.mean.items()},
        {v: np.asarray(f) for v, f in jad.std.items()})
    x["tbias"] = BiasCorrection.from_dict(x["jbias"].to_dict())
    assert x["tbias"].offset_for("X") == x["jbias"].offset_for("X") != 0.0
    c = NCYCLES - 1
    _assert_cycles_match(x, _jax_cycle(x, c), _port_cycle(x, c))
