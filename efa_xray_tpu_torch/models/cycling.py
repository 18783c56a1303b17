"""Generic cycling data-assimilation harness on a flat-state ensemble.

Counterpart of ``efa_xray_tpu/models/cycling.py``: ``_crps_mean`` :25,
``CycleStats`` :38 and ``CyclingHarness`` :52 with every field and
method: the accessors :162-183, ``_apply_prior_inflation`` :185 (static,
Anderson-adaptive, additive white or bank), ``analysis_step`` :212 (the
fixed-lag smoother's augmented rows), ``_analysis_core`` :253 (the
``letkf`` :284, ``enkf`` :297 and ``ensrf`` :319 solvers, RTPS/RTPP
:328-338, the adaptive inflation update :339-373 and Desroziers
``adaptive_r`` :374-390), ``save_checkpoint`` / ``load_checkpoint``
:402-446 and ``run`` :448 (IAU, ``adaptive_bias`` and the smoother).

The ensemble ``[nmems, nvars]`` lives on the harness's ``device`` (the
card unless the caller asks for another) in ``config.dtype``.  The EnSRF
analysis takes the route ``EnSRF.update()`` gives a flat state
(:class:`~efa_xray_tpu_torch.assimilation.ensrf.FlatRoute`): on CUDA
float32 the tail through B1 and the body through B4 at exact haversine,
or through B2 with ``fast_geometry`` or without localization; on the CPU,
and in float64, the plain versions.  Like the JAX harness, which calls
the plain ``ensrf_blocked``, it ignores ``method``, ``hybrid_alpha``,
``variable_localization``, ``matmul_precision`` and ``mxu_bf16``, so
every config takes the kernels on CUDA float32, in fp32.  The JAX harness
also ignores ``fast_geometry`` (exact haversine); the port honours it
(B2), so the two compute the same function unless ``fast_geometry`` is
set.

The synthetic obs noise and the additive draws come from NumPy's
``default_rng``, as in the JAX package, so both packages draw the same
numbers.  The EnKF's perturbations come from
``enkf.draw_ob_perturbations``, seeded per cycle from ``enkf_seed`` and
the cycle number (JAX folds the cycle into its key; its threefry draws
cannot be matched).  Checkpoints are pickles of NumPy arrays; a resumed
run reproduces the uninterrupted one bit for bit.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Callable, List, Optional

import numpy as np
import torch

from efa_xray_tpu_torch.assimilation import adaptive_inflation as _ai
from efa_xray_tpu_torch.assimilation import enkf as _enkf
from efa_xray_tpu_torch.assimilation import letkf_core
from efa_xray_tpu_torch.assimilation.ensrf import FlatRoute
from efa_xray_tpu_torch.assimilation.ensrf_core import ObsArrays
from efa_xray_tpu_torch.config import FilterConfig
from efa_xray_tpu_torch.interop import to_host
from efa_xray_tpu_torch.state.ensemble import _torch_dtype, default_device


def _crps_mean(ens, truth) -> float:
    """Mean exact ensemble CRPS of ``ens [M, nvars]`` against ``truth
    [nvars]`` (sorted-pair identity), in float64 on their device."""
    ens = torch.as_tensor(ens).double()
    truth = torch.as_tensor(truth, device=ens.device).double()
    m = ens.shape[0]
    mae = torch.mean(torch.abs(ens - truth[None, :]))
    srt = torch.sort(ens, dim=0).values
    w = 2.0 * torch.arange(m, dtype=torch.float64, device=ens.device) + 1.0 - m
    pair = 2.0 * torch.mean(w @ srt) / (m * m)
    return float(mae - 0.5 * pair)


@dataclasses.dataclass
class CycleStats:
    cycle: int
    analysis_rmse: float  # vs truth
    background_rmse: float
    mean_spread: float
    obs_prior_rmse: float
    obs_post_rmse: float
    # state-space mean ensemble CRPS of the analysis vs truth
    analysis_crps: float = float("nan")


@dataclasses.dataclass
class CyclingHarness:
    """Cycle a flat-state ensemble ``[nmems, nvars]`` through forecast and
    analysis steps (the JAX harness's fields and defaults; see its module
    for what each option does).

    ``forecast``: ensemble tensor -> ensemble tensor (vectorized over
    members; it gets the truth ``[nvars]`` too).  ``obs_operator_rows``:
    the observed rows (identity-pick H); for a general H pass
    ``obs_operator`` (ensemble ``[M, nvars]`` -> ``[nobs, M]``).
    ``device``: where the ensemble lives and the analysis runs; the card
    when None.
    """

    forecast: Callable
    state_lats: np.ndarray  # [nvars]
    state_lons: np.ndarray  # [nvars]
    ob_error: float = 1.0
    localize_radius: float = 2000.0
    solver: str = "ensrf"  # "ensrf", "letkf" or "enkf"
    enkf_seed: int = 0
    config: FilterConfig = dataclasses.field(default_factory=FilterConfig)
    obs_operator: Optional[Callable] = None
    obs_operator_rows: Optional[np.ndarray] = None
    inflation: Optional[float] = None
    adaptive_inflation: bool = False
    adaptive_sd: float = 0.6
    adaptive_min: float = 1.0
    adaptive_sd_evolve: bool = False
    adaptive_sd_min: float = 0.05
    adaptive_damp: float = 1.0
    adaptive_max: float = 1e6
    additive_sigma: float = 0.0
    additive_bank: Optional[np.ndarray] = None
    adaptive_r: bool = False
    adaptive_r_rho: float = 0.2
    adaptive_r_floor: float = 1e-6
    iau_steps: int = 0
    adaptive_bias: bool = False
    adaptive_bias_rho: float = 0.1
    smoother_lag: int = 0
    device: Optional[object] = None

    def __post_init__(self):
        self.device = default_device(self.device)

    @property
    def dtype(self) -> torch.dtype:
        return _torch_dtype(self.config.dtype)

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        """``x`` on the harness's device: a tensor keeps its dtype unless
        ``dtype`` is given, NumPy data keeps its own."""
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
        return t.to(device=self.device, dtype=dtype)

    def inflation_field(self) -> Optional[np.ndarray]:
        """Current adaptive variance-inflation field (None before first
        use)."""
        lam = getattr(self, "_lam", None)
        return None if lam is None else to_host(lam)

    def estimated_r(self) -> Optional[float]:
        """Current working obs-error variance under ``adaptive_r``."""
        r = getattr(self, "_r_work", None)
        return None if r is None else float(r)

    def estimated_bias(self) -> Optional[np.ndarray]:
        """Current per-observation-row bias under ``adaptive_bias``."""
        b = getattr(self, "_bias_work", None)
        return None if b is None else np.asarray(b)

    def smoothed_rmse(self) -> List[tuple]:
        """``(cycle, rmse)`` of each state that aged out of the smoother
        window."""
        return list(getattr(self, "_smoothed_rmse", []))

    def _apply_prior_inflation(self, ens):
        """Static, adaptive and additive prior inflation on a flat ``[M,
        nvars]`` ensemble; returns ``(ensemble, lambda_or_None)``."""
        lam = None
        if self.inflation is not None:
            mean = ens.mean(dim=0)
            ens = mean + self.inflation * (ens - mean)
        if self.adaptive_inflation:
            lam = getattr(self, "_lam", None)
            if lam is None:
                lam = torch.ones(ens.shape[1], dtype=ens.dtype,
                                 device=ens.device)
            mean = ens.mean(dim=0)
            ens = mean + torch.sqrt(lam)[None, :] * (ens - mean)
        if self.additive_sigma > 0.0:
            rng = getattr(self, "_rng", None)
            if rng is None:
                rng = self._rng = np.random.default_rng(0)
            if self.additive_bank is not None:
                bank = np.asarray(self.additive_bank, dtype=np.float64)
                pick = rng.integers(0, bank.shape[0], ens.shape[0])
                noise = self.additive_sigma * bank[pick]
            else:
                noise = rng.normal(0.0, self.additive_sigma, tuple(ens.shape))
            noise -= noise.mean(axis=0, keepdims=True)  # mean-preserving
            ens = ens + self._tensor(noise, ens.dtype)
        return ens, lam

    def analysis_step(self, ensemble, values, ob_lats, ob_lons):
        """One analysis on a flat ensemble ``[nmems, nvars]``; returns
        ``(analysis, diags)``.  With ``smoother_lag > 0`` and a non-empty
        lag window the lagged analyses ride along as extra rows and are
        re-analyzed by the same obs; the current-time analysis is
        returned."""
        ens = self._tensor(ensemble, self.dtype)
        ens, lam = self._apply_prior_inflation(ens)
        lagged = (list(getattr(self, "_lag_buffer", []))
                  if self.smoother_lag > 0 else [])
        if lagged:
            if self.obs_operator is not None:
                raise ValueError(
                    "smoother_lag requires identity-pick obs_operator_rows "
                    "(a custom obs_operator sees only the current-time "
                    "ensemble)")
            nv = int(ens.shape[1])
            ens_full = torch.cat(
                [ens] + [self._tensor(l, self.dtype) for l in lagged], dim=1)
            lats = np.tile(np.asarray(self.state_lats), 1 + len(lagged))
            lons = np.tile(np.asarray(self.state_lons), 1 + len(lagged))
        else:
            ens_full, lats, lons = ens, self.state_lats, self.state_lons
        out, diags = self._analysis_core(ens_full, lam, values, ob_lats,
                                         ob_lons, lats, lons)
        if lagged:
            self._lag_buffer = [out[:, (i + 1) * nv:(i + 2) * nv]
                                for i in range(len(lagged))]
            out = out[:, :nv]
        return out, diags

    def _obs_arrays(self, values, ob_lats, ob_lons, nobs: int, r_work):
        dt, dev = self.dtype, self.device
        f = lambda x: torch.tensor(np.asarray(x, np.float64), device=dev
                                   ).to(dt)
        return ObsArrays(values=self._tensor(values, dt),
                         errors=torch.full((nobs,), float(r_work), dtype=dt,
                                           device=dev),
                         lats=f(ob_lats), lons=f(ob_lons),
                         radii=torch.full((nobs,), float(self.localize_radius),
                                          dtype=dt, device=dev),
                         assim=torch.ones(nobs, dtype=torch.bool, device=dev))

    def _analysis_core(self, ens, lam, values, ob_lats, ob_lons, state_lats,
                       state_lons):
        """One solver pass on an (possibly lag-augmented) flat ensemble."""
        cfg = self.config
        dt, dev = self.dtype, self.device
        sv = ens.T  # [nvars, nmems]
        bm = sv.mean(dim=1)
        bp = (sv - bm[:, None]).contiguous()
        if self.obs_operator is not None:
            ye = self._tensor(self.obs_operator(ens), dt)
        else:
            ye = sv[self._tensor(np.asarray(self.obs_operator_rows),
                                 torch.int64)]
        tm = ye.mean(dim=1)
        tp = ye - tm[:, None]
        nobs = ye.shape[0]
        r_work = (getattr(self, "_r_work", self.ob_error) if self.adaptive_r
                  else self.ob_error)
        obs = self._obs_arrays(values, ob_lats, ob_lons, nobs, r_work)
        lat_t = torch.tensor(np.asarray(state_lats, np.float64),
                             device=dev).to(dt)
        lon_t = torch.tensor(np.asarray(state_lons, np.float64),
                             device=dev).to(dt)
        # The body kernels update bp in place: RTPS/RTPP read the prior
        # first.
        prior_spread = _ai.row_spread(bp) if cfg.rtps_alpha > 0.0 else None
        prior_perts = bp.clone() if cfg.rtpp_alpha > 0.0 else None
        if self.solver == "letkf":
            bm2, bp2, _, _, diags = letkf_core.letkf_update(
                bm, bp, tm, tp, lat_t, lon_t, obs, ngrid=int(bm.shape[0]),
                patch_size=cfg.letkf_patch_size, k_obs=cfg.letkf_k_obs,
                localize=cfg.localize, sqrt_method=cfg.letkf_sqrt,
                ns_iters=cfg.letkf_ns_iters, chunk=cfg.letkf_chunk)
        elif self.solver == "enkf":
            cycle_no = getattr(self, "_enkf_cycle", 0)
            self._enkf_cycle = cycle_no + 1
            seed = int(np.random.SeedSequence(
                [int(self.enkf_seed), cycle_no]).generate_state(1)[0])
            eps = _enkf.draw_ob_perturbations(seed, obs.errors, sv.shape[1])
            bm2, bp2, _, _, diags = _enkf.enkf_serial(
                bm, bp, tm, tp, lat_t, lon_t, obs, eps,
                localize=cfg.localize, unbiased=cfg.unbiased_variance)
        elif self.solver == "ensrf":
            # The JAX harness runs the pure-ensemble blocked update whatever
            # method, hybrid_alpha, variable_localization, matmul_precision
            # and mxu_bf16 say (it passes no hybrid or cross-variable
            # inputs, and no precision): so does the route here.
            route_cfg = dataclasses.replace(
                cfg, block_size=min(cfg.block_size, max(nobs, 1)),
                method="blocked", hybrid_alpha=1.0,
                variable_localization=None, matmul_precision=None,
                mxu_bf16=False)
            radius = (float(self.localize_radius)
                      if np.isfinite(self.localize_radius) else None)
            bm2, bp2, _, _, diags = FlatRoute(route_cfg, dev, radius).solve(
                bm, bp, tm, tp, lat_t, lon_t, obs)
        else:
            raise ValueError(f"unknown solver {self.solver!r}")
        if prior_spread is not None:
            bp2 = _ai.rtps(prior_spread, bp2, cfg.rtps_alpha)
        if prior_perts is not None:
            bp2 = _ai.rtpp(prior_perts, bp2, cfg.rtpp_alpha)
        if self.adaptive_inflation:
            lam_sd = (getattr(self, "_lam_sd", None)
                      if self.adaptive_sd_evolve else None)
            if lam_sd is None:
                lam_sd = torch.tensor(self.adaptive_sd, dtype=dt, device=dev)
            out = _ai.update_inflation_rows(
                lam, lam_sd,
                torch.tensor(np.asarray(self.state_lats, np.float64),
                             device=dev).to(dt),
                torch.tensor(np.asarray(self.state_lons, np.float64),
                             device=dev).to(dt),
                obs.lats, obs.lons, obs.radii,
                obs.values - diags.prior_mean.to(dt),
                diags.prior_var.to(dt), obs.errors, obs.assim,
                lambda_min=self.adaptive_min, lambda_max=self.adaptive_max,
                evolve_sd=self.adaptive_sd_evolve, sd_min=self.adaptive_sd_min)
            if self.adaptive_sd_evolve:
                self._lam, self._lam_sd = out
            else:
                self._lam = out
            if self.adaptive_damp < 1.0:
                self._lam = 1.0 + self.adaptive_damp * (self._lam - 1.0)
        if self.adaptive_r:
            # Desroziers: E[d_a d_b] estimates R; blended in per cycle.
            y = np.asarray(to_host(values), np.float64)
            d_b = y - to_host(diags.prior_mean).astype(np.float64)
            d_a = y - to_host(diags.post_mean).astype(np.float64)
            r_est = float(np.mean(d_a * d_b))
            if np.isfinite(r_est) and r_est > 0:
                self._r_work = max(
                    (1.0 - self.adaptive_r_rho) * float(r_work)
                    + self.adaptive_r_rho * r_est, self.adaptive_r_floor)
        return (bm2[:, None] + bp2).T, diags

    # Transient per-run state, reset by a fresh ``run()`` and persisted by
    # ``save_checkpoint``/``load_checkpoint``.
    _TRANSIENT = (
        "_lam", "_lam_sd", "_r_work", "_bias_work", "_enkf_cycle",
        "_iau_increment",
        "_lag_buffer", "_truth_history", "_smoothed_rmse", "_cycle_offset",
        "_final_ensemble", "_final_truth",
    )
    # The transient fields that are tensors during a run (lists of them
    # for the lag window).
    _TENSORS = ("_lam", "_lam_sd", "_iau_increment", "_lag_buffer",
                "_final_ensemble", "_final_truth")

    def save_checkpoint(self, path) -> None:
        """Persist the cycling state after a ``run()`` segment (ensemble,
        truth, RNG state, adaptive fields, IAU increment, smoother window)
        as NumPy in a pickle; ``load_checkpoint`` into an identically
        configured harness, then ``run(None, None, n, resume=True)``,
        reproduces an uninterrupted run bit for bit."""
        state = {"rng_state": self._rng.bit_generator.state}
        for k in self._TRANSIENT:
            if hasattr(self, k):
                state[k] = to_host(getattr(self, k))
        with open(path, "wb") as f:
            pickle.dump(state, f)

    def load_checkpoint(self, path) -> None:
        """Restore the state written by :meth:`save_checkpoint`; its arrays
        go back onto the harness's device in the dtype they were saved
        in."""
        with open(path, "rb") as f:
            state = pickle.load(f)
        rng = np.random.default_rng()
        rng.bit_generator.state = state.pop("rng_state")
        self._rng = rng
        for k in self._TRANSIENT:
            if k not in state:
                if hasattr(self, k):
                    delattr(self, k)
                continue
            v = state[k]
            if k in self._TENSORS and v is not None:
                v = ([self._tensor(x) for x in v] if isinstance(v, list)
                     else self._tensor(v))
            setattr(self, k, v)

    def _rmse(self, ens, truth) -> float:
        return float(torch.sqrt(torch.mean((ens.mean(dim=0) - truth) ** 2)))

    def run(self, ensemble, truth, ncycles: int,
            obs_every: Optional[np.ndarray] = None, seed: int = 0,
            obs_noise_var: Optional[float] = None, obs_bias: float = 0.0,
            resume: bool = False) -> List[CycleStats]:
        """Cycle against a known truth: forecast both, observe the truth
        with noise (true variance ``obs_noise_var``, default ``ob_error``,
        plus ``obs_bias``), assimilate, record statistics.  ``resume=True``
        continues a previous segment (in memory or restored by
        :meth:`load_checkpoint`); ``ensemble``/``truth`` may then be None.
        A fresh run resets every transient field."""
        if resume:
            if not hasattr(self, "_rng"):
                raise ValueError(
                    "resume=True needs a previous run() segment or "
                    "load_checkpoint()")
            rng = self._rng
            if ensemble is None:
                ensemble = self._final_ensemble
            if truth is None:
                truth = self._final_truth
            offset = getattr(self, "_cycle_offset", 0)
        else:
            rng = np.random.default_rng(seed)
            offset = 0
            for k in self._TRANSIENT:
                if hasattr(self, k):
                    delattr(self, k)
        self._rng = rng
        if obs_every is None and self.obs_operator_rows is None:
            raise ValueError(
                "run() synthesizes observations by sampling the truth at "
                "identity-pick rows; provide obs_operator_rows (or "
                "obs_every).  A general obs_operator can be used for the "
                "ensemble side via analysis_step(), but truth sampling "
                "still needs row indices.")
        rows = np.asarray(obs_every if obs_every is not None
                          else self.obs_operator_rows)
        rows_t = self._tensor(rows, torch.int64)
        ensemble, truth = self._tensor(ensemble), self._tensor(truth)
        noise_sd = np.sqrt(self.ob_error if obs_noise_var is None
                           else obs_noise_var)
        stats: List[CycleStats] = []
        for c in range(offset, offset + ncycles):
            if self.iau_steps > 0:
                # IAU: the previous increment spread evenly over this
                # window's substeps (the truth is never forced).
                inc = getattr(self, "_iau_increment", None)
                frac = None if inc is None else inc / self.iau_steps
                for _ in range(self.iau_steps):
                    truth = self.forecast(truth)
                    ensemble = self.forecast(ensemble)
                    if frac is not None:
                        ensemble = ensemble + frac
            else:
                truth = self.forecast(truth)
                ensemble = self.forecast(ensemble)
            bg_rmse = self._rmse(ensemble, truth)
            if not np.isfinite(bg_rmse):
                raise RuntimeError(
                    f"forecast diverged at cycle {c}: non-finite background "
                    "ensemble.  Reduce inflation (adaptive_sd / inflation / "
                    "additive_sigma) or the cycle length.")
            yobs = (obs_bias + to_host(truth[rows_t])
                    + rng.normal(0, noise_sd, len(rows)))
            self.obs_operator_rows = rows
            y_in = yobs
            if self.adaptive_bias:
                bias = getattr(self, "_bias_work", np.zeros(len(rows)))
                y_in = yobs - bias
            analysis, diags = self.analysis_step(
                ensemble, y_in, self.state_lats[rows], self.state_lons[rows])
            pm = to_host(diags.prior_mean).astype(np.float64)
            om = to_host(diags.post_mean).astype(np.float64)
            if self.adaptive_bias:
                # Running-mean innovation against the raw obs.
                self._bias_work = ((1.0 - self.adaptive_bias_rho) * bias
                                   + self.adaptive_bias_rho
                                   * (np.asarray(yobs, np.float64) - pm))
            if self.iau_steps > 0:
                # Per-member increments, absorbed over the next window;
                # the stats report the analysis target at this time.
                self._iau_increment = analysis - ensemble.to(analysis.dtype)
            else:
                ensemble = analysis
            if self.smoother_lag > 0:
                # This cycle's analysis enters the lag window; a state
                # leaving it is final and scored against its own truth.
                buf = [analysis] + list(getattr(self, "_lag_buffer", []))
                hist = [to_host(truth).copy()] + list(
                    getattr(self, "_truth_history", []))
                if len(buf) > self.smoother_lag:
                    done, truth_done = buf.pop(), hist.pop()
                    rmse = float(np.sqrt(np.mean(
                        (np.mean(to_host(done), axis=0) - truth_done) ** 2)))
                    self._smoothed_rmse = getattr(
                        self, "_smoothed_rmse", []) + [
                            (c - self.smoother_lag, rmse)]
                self._lag_buffer = buf
                self._truth_history = hist
            stats.append(CycleStats(
                cycle=c,
                analysis_rmse=self._rmse(analysis, truth),
                background_rmse=bg_rmse,
                mean_spread=float(analysis.std(dim=0, unbiased=False).mean()),
                obs_prior_rmse=float(np.sqrt(np.mean((yobs - pm) ** 2))),
                obs_post_rmse=float(np.sqrt(np.mean((yobs - om) ** 2))),
                analysis_crps=_crps_mean(analysis, truth)))
        self._final_ensemble = ensemble
        self._final_truth = truth
        self._cycle_offset = offset + ncycles
        return stats
