"""Assimilation driver layer: priors, inflation, state formatting.

Counterpart of ``efa_xray_tpu/assimilation/assimilation.py``:
``inflate_state`` :75 (scalar, file, per-dimension / per-variable dict
and ``AdaptiveInflation`` forms), and the ``Assimilation`` base class with the
``obs_order`` sort :201-208, ``max_finite_radius`` :212, ``build_taps``
:224, ``obs_arrays`` :245, ``apply_outlier_check`` :297,
``_vertical_active`` :348, ``format_prior_state`` :492 (the fused
``_format_prior_jit`` :48), ``format_posterior_state`` :526,
``varloc_kwargs`` :539, ``maybe_update_adaptive_inflation`` :576 and
``record_diagnostics`` :611, ``compute_ob_priors`` with the custom forward
operators ``_custom_operators`` :452-482, and the module-level ``update``
:650.

Everything runs on one explicit device, the filter's: by default the
prior state's; with ``mesh=`` the solvers split the state body over the
mesh's devices and gather the posterior back onto the filter's device.
With ``obs_order="hilbert"`` the filter assimilates a sorted copy of the
batch (``_batch``) and every update hands back the caller's order: the
JAX package restores it from ``self.obs``, which its first update has
already restored, so that a second ``update()`` of one filter reorders a
batch that is no longer sorted (ROADMAP C, faults of the reference);
here the sorted copy is never reordered.  A custom
forward operator's row is put where its ob sits in the sorted batch (the
JAX package puts it at the ob's index in the caller's order).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from efa_xray_tpu_torch.assimilation.ensrf_core import ObsArrays, ObsDiagnostics
from efa_xray_tpu_torch.config import FilterConfig
from efa_xray_tpu_torch.observation import forward as _fwd
from efa_xray_tpu_torch.observation.observation import (
    Observation,
    ObservationBatch,
)
from efa_xray_tpu_torch.state.ensemble import EnsembleState, _torch_dtype
from efa_xray_tpu_torch.utils import profiling
from efa_xray_tpu_torch.utils.validation import ValidationError

InflationSpec = Union[None, float, str, dict, "AdaptiveInflation"]

def inflate_state(state: EnsembleState, inflation: InflationSpec,
                  verbose: bool = False) -> EnsembleState:
    """Multiplicative prior-perturbation inflation (reference
    ``efa_xray/assimilation/assimilation.py:52-118``).

    * float: every variable's perturbations scaled by the factor;
    * str: the name of an inflation file (netCDF/HDF5, e.g. written with
      ``utils.ncio.write_dataset``): each state variable found in it is a
      factor field broadcast to ``[ntimes, ny, nx]`` on that variable's
      perturbations (variables not in the file keep 1);
    * dict: dimension names (``validtime``/``lat``/``lon``/``x``/``y``)
      map to 1-D per-element factors along that dimension; variable names
      map to scalar factors for that variable (unknown ones are skipped);
    * an ``AdaptiveInflation``: its mean field, as ``sqrt(lambda)`` on the
      perturbations.

    Returns a new state.
    """
    if inflation is None:
        return state
    from efa_xray_tpu_torch.assimilation.adaptive_inflation import (
        AdaptiveInflation,
    )

    if isinstance(inflation, AdaptiveInflation):
        if verbose:
            print("Applying adaptive inflation mean field")
        return inflation.inflate_state(state)
    s = state.structure
    data = state.data
    if isinstance(inflation, (int, float)) and not isinstance(inflation, bool):
        if verbose:
            print(f"Inflating all variables by factor: {float(inflation):3.2f}")
        mean = data.mean(dim=-1, keepdim=True)
        return state.replace_data((data - mean) * float(inflation) + mean)
    if isinstance(inflation, dict):
        dim_axis = {"validtime": 1, "y": 2, "lat": 2, "x": 3, "lon": 3}
        for k, v in inflation.items():
            mean = data.mean(dim=-1, keepdim=True)
            perts = data - mean
            if k in dim_axis:
                if verbose:
                    print(f"Inflating all variables along {k} dimension")
                arr = np.asarray(v, dtype=np.float64)
                axis = dim_axis[k]
                if arr.shape[0] != data.shape[axis]:
                    raise ValidationError(
                        f"inflation along {k} has length {arr.shape[0]}, "
                        f"dimension has {data.shape[axis]}")
                shape = [1] * 5
                shape[axis] = arr.shape[0]
                factor = torch.tensor(arr, dtype=data.dtype,
                                      device=data.device).reshape(shape)
                data = perts * factor + mean
            else:
                if not isinstance(v, (int, float)) or isinstance(v, bool):
                    raise TypeError(
                        f"Per-variable inflation for {k!r} must be a number, "
                        f"got {type(v).__name__}")
                if k not in s.var_names:
                    print(f"Unable to find variable {k} to inflate.  Skipping...")
                    continue
                if verbose:
                    print(f"Inflating variable {k} by factor: {float(v):3.2f}")
                vi = s.var_index(k)
                data = data.clone()
                data[vi] = perts[vi] * float(v) + mean[vi]
        return state.replace_data(data)
    if isinstance(inflation, str):
        from efa_xray_tpu_torch.utils import ncio

        if verbose:
            print(f"Loading inflation from file: {inflation}")
        ds = ncio.read_dataset(inflation)
        factor = np.ones((s.nvars, s.ntimes, s.ny, s.nx), dtype=np.float64)
        for vi, name in enumerate(s.var_names):
            if name in ds.variables:
                factor[vi] = np.broadcast_to(
                    np.asarray(ds[name]), (s.ntimes, s.ny, s.nx))
        mean = data.mean(dim=-1, keepdim=True)
        factor = torch.tensor(factor, dtype=data.dtype, device=data.device)
        return state.replace_data((data - mean) * factor[..., None] + mean)
    raise TypeError(f"Unsupported inflation spec: {type(inflation)!r}")


class Assimilation:
    """Base driver: holds the prior and obs, computes obs-space priors,
    formats the state for the solver and back."""

    @profiling.spanned(profiling.ENTRY_INIT)
    def __init__(self, state: EnsembleState, obs, nproc: int = 1,
                 inflation: InflationSpec = None, verbose: bool = False,
                 config: Optional[FilterConfig] = None, device=None,
                 mesh=None):
        from efa_xray_tpu_torch.utils.logging import verbose_logger
        from efa_xray_tpu_torch.utils.validation import (
            validate_obs,
            validate_state,
        )

        self.log = verbose_logger(verbose)
        self.device = state.device if device is None else torch.device(device)
        self.prior = (state if state.device == self.device
                      else state.to(self.device))
        self._user_obs = obs if isinstance(obs, (list, tuple)) else None
        self.obs = ObservationBatch.coerce(obs)
        validate_state(state)
        validate_obs(self.obs, state.structure)
        self.verbose = verbose
        # Accepted for the reference's signature; unused (parallelism
        # comes from ``mesh``).
        self.nproc = nproc
        # A parallel.mesh.Mesh: the solvers split the state over it.
        self.mesh = mesh
        self.inflation = inflation
        self.config = config or FilterConfig(verbose=verbose)
        # The batch in assimilation order: obs_order="hilbert" sorts it
        # once; record_diagnostics hands the caller's order back as
        # self.obs on every update.
        self._obs_unsort = None
        if self.config.obs_order == "hilbert" and self.obs.nobs > 1:
            self.obs, order = self.obs.spatial_sort()
            self._obs_unsort = np.argsort(order)
        self._batch = self.obs
        self.is_inflated = False
        self._taps = None

    @property
    def dtype(self) -> torch.dtype:
        return _torch_dtype(self.config.dtype)

    def max_finite_radius(self):
        """Host-known bound on the finite per-ob radii (km) after the
        ``default_radius`` substitution; None when no ob is localized."""
        r = np.asarray(self._batch.localize_radius, dtype=np.float64)
        if self.config.default_radius is not None:
            r = np.where(np.isinf(r), float(self.config.default_radius), r)
        finite = r[np.isfinite(r)]
        return float(finite.max()) if finite.size else None

    @profiling.spanned(profiling.OBS_TAPS)
    def build_taps(self) -> _fwd.ObsTaps:
        if self._taps is None:
            cfg, b = self.config, self._batch
            self._taps = _fwd.build_taps_cached(
                self.prior.structure, b.lats, b.lons, b.times_s,
                b.var_indices(self.prior.structure),
                npt=cfg.npt, exact_match_km=cfg.exact_match_km,
                metric=cfg.nearest_metric, time_weighting=cfg.time_weighting,
                search=cfg.taps_search, device=self.device,
                topk_method=cfg.taps_topk,
            )
        return self._taps

    @profiling.spanned(profiling.ENTRY_OBS_ARRAYS)
    def obs_arrays(self) -> ObsArrays:
        """Per-ob tensors on the filter's device, in one transfer.
        QC-failed obs (out of the state's time range) are masked out."""
        taps = self.build_taps()
        b = self._batch
        radii = np.asarray(b.localize_radius, dtype=np.float64).copy()
        if self.config.default_radius is not None:
            radii[np.isinf(radii)] = float(self.config.default_radius)
        qc = np.asarray(taps.qc_ok) | np.asarray(b.custom_operator)
        assim = np.asarray(b.assimilate_flags) & qc
        # Vertical localization only for obs with a finite vertical
        # coordinate; others get an infinite vertical radius.
        verts = np.asarray(b.verts, dtype=np.float64).copy()
        vrad = np.asarray(b.vert_radius, dtype=np.float64).copy()
        vrad[~np.isfinite(verts)] = np.inf
        verts[~np.isfinite(verts)] = 0.0
        packed = np.stack([
            np.asarray(b.values, dtype=np.float64),
            np.asarray(b.errors, dtype=np.float64),
            np.asarray(b.lats, dtype=np.float64),
            np.asarray(b.lons, dtype=np.float64),
            radii, verts, vrad, assim.astype(np.float64),
        ])
        p = torch.tensor(packed, device=self.device)
        f = p.to(self.dtype)
        return ObsArrays(values=f[0], errors=f[1], lats=f[2], lons=f[3],
                         radii=f[4], assim=p[7] != 0, verts=f[5],
                         vert_radii=f[6])

    @profiling.spanned(profiling.ENTRY_OUTLIER_CHECK)
    def apply_outlier_check(self, oa: ObsArrays, tail_mean, tail_perts):
        """Innovation-based gross-error QC (``FilterConfig.outlier_threshold``):
        flag obs with ``innov^2 > t^2 (var(ye) + R)`` under the forecast
        prior, then reject them or inflate their R to put the innovation
        at t sigma (``outlier_action``)."""
        t = self.config.outlier_threshold
        if t is None:
            return oa
        ddof = 1 if self.config.unbiased_variance else 0
        m = tail_perts.shape[1]
        varye = torch.sum(tail_perts * tail_perts, dim=1) / (m - ddof)
        innov = oa.values - tail_mean
        bad = innov * innov > (t * t) * (varye + oa.errors)
        flagged = (oa.assim & bad).cpu().numpy().astype(bool)
        self._batch.qc_outlier = flagged
        n = int(flagged.sum())
        action = self.config.outlier_action
        if n and self.verbose:
            self.log.info("Outlier check (t=%.2f) %s %d/%d obs", t,
                          "rejected" if action == "reject" else "R-inflated",
                          n, len(flagged))
        if action == "inflate":
            r_infl = torch.maximum(oa.errors, innov * innov / (t * t) - varye)
            return oa._replace(errors=torch.where(bad, r_infl, oa.errors))
        return oa._replace(assim=oa.assim & ~bad)

    def _vertical_active(self) -> bool:
        """Vertical localization is on when the state has per-variable
        vertical coordinates and some ob asks for a finite vertical
        radius."""
        if self.prior.structure.var_verts is None:
            return False
        vr = np.asarray(self._batch.vert_radius, dtype=np.float64)
        verts = np.asarray(self._batch.verts, dtype=np.float64)
        return bool(np.any(np.isfinite(vr) & np.isfinite(verts)))

    @profiling.spanned(profiling.OBS_PRIORS)
    def compute_ob_priors(self, state: Optional[EnsembleState] = None):
        """Obs-space priors ``(means [No], perts [No, M])`` of ``state``
        (the prior by default), in the assimilation order: one gather
        through the taps, then each custom ``forward_operator``'s row
        (reference ``assimilation.py:36-49``)."""
        state = self.prior if state is None else state
        ye = _fwd.apply_taps_obj(state.to_vect(), self.build_taps())
        custom = self._custom_operators()
        if custom:
            ye = ye.clone()
            for i, fn in custom:
                ye[i] = torch.as_tensor(fn(state), dtype=ye.dtype,
                                        device=ye.device)
        means = ye.mean(dim=1)
        return means, ye - means[:, None]

    def _custom_operators(self):
        """``(row, forward_operator)`` of every ob passed as an
        ``Observation`` with a custom operator, the row being its place in
        the assimilation order."""
        if self._user_obs is None:
            return []
        pos = (np.arange(len(self._user_obs)) if self._obs_unsort is None
               else self._obs_unsort)
        return [(int(pos[i]), ob.forward_operator)
                for i, ob in enumerate(self._user_obs)
                if getattr(ob, "forward_operator", None) is not None]

    def inflate_state(self) -> None:
        if self.is_inflated:
            self.log.warning("State already inflated.  Skipping additional "
                             "inflation.")
            return
        self.prior = inflate_state(self.prior, self.inflation,
                                   verbose=self.verbose)
        self.is_inflated = True

    @profiling.spanned(profiling.ENTRY_FORMAT_PRIOR)
    def format_prior_state(self):
        """``(body_mean [Ns], body_perts [Ns, M], tail_mean [No],
        tail_perts [No, M])`` in the config dtype: the state vector split
        into mean and perturbations, and the obs-space priors (the tail)
        from the taps."""
        if self.inflation is not None:
            if self.verbose:
                self.log.info("Inflating Prior State")
            self.inflate_state()
        if self.verbose:
            self.log.info("Computing observation priors")
        tail_mean, tail_perts = self.compute_ob_priors()
        tail_perts = tail_perts.to(self.dtype)
        vect = self.prior.to_vect()
        body_mean = vect.mean(dim=1)
        body_perts = (vect - body_mean[:, None]).to(self.dtype)
        return (body_mean.to(self.dtype), body_perts,
                tail_mean.to(self.dtype), tail_perts)

    @profiling.spanned(profiling.ENTRY_FORMAT_POSTERIOR)
    def format_posterior_state(self, body_mean, body_perts):
        """Rebuild an EnsembleState (prior dtype) from posterior mean and
        perturbations."""
        if self.verbose:
            self.log.info("Formatting posterior")
        data = (body_mean[:, None] + body_perts).to(self.prior.data.dtype)
        return (EnsembleState(data.reshape(self.prior.structure.shape),
                              self.prior.structure), self.obs)

    def varloc_kwargs(self) -> dict:
        """Cross-variable localization inputs from
        ``FilterConfig.variable_localization`` (empty dict when off), as
        tensors on the filter's device: the ``[nvars+1, nvars]`` factor
        matrix (the extra all-ones row serves custom-operator obs, whose
        observed variable is undefined), the state-variable index of each
        row (rows are var-major) and the observed-variable index of each
        ob."""
        spec = self.config.variable_localization
        if not spec:
            return {}
        st = self.prior.structure
        names = list(st.var_names)
        nv = len(names)
        fac = np.ones((nv + 1, nv), dtype=np.float64)
        for key, val in spec.items():
            a, b = key.split(":") if isinstance(key, str) else key
            for n in (a, b):
                if n not in names:
                    raise KeyError(
                        f"variable_localization names unknown variable "
                        f"{n!r} (state has {names})")
            fac[names.index(a), names.index(b)] = float(val)
        ob_var = self._batch.var_indices(st).astype(np.int64)
        ob_var[np.asarray(self._batch.custom_operator, dtype=bool)] = nv
        row_var = np.repeat(np.arange(nv, dtype=np.int64),
                            st.ntimes * st.ngrid)
        dev = self.device
        return dict(
            varloc=torch.tensor(fac, dtype=self.dtype, device=dev),
            row_var=torch.from_numpy(row_var).to(dev),
            ob_var=torch.from_numpy(ob_var).to(dev),
        )

    @profiling.spanned(profiling.ENTRY_INFLATION)
    def maybe_update_adaptive_inflation(self) -> None:
        """Learn the ``AdaptiveInflation`` fields from this batch's
        innovations (Anderson 2009) on the filter's device, when
        ``FilterConfig.adaptive_inflation_update`` asks for it.  Call after
        :meth:`record_diagnostics`: it reads the recorded prior means and
        variances, in the caller's order."""
        from efa_xray_tpu_torch.assimilation.adaptive_inflation import (
            AdaptiveInflation,
        )

        cfg = self.config
        if not (cfg.adaptive_inflation_update
                and isinstance(self.inflation, AdaptiveInflation)):
            return
        b = self.obs
        self.inflation.update_inflation(
            b.lats, b.lons, b.localize_radius, b.values - b.prior_mean,
            b.prior_var, b.errors, assimilated=b.assimilated,
            lambda_min=cfg.adaptive_min, lambda_max=cfg.adaptive_max,
            evolve_sd=cfg.adaptive_sd_evolve, sd_min=cfg.adaptive_sd_min,
            damp=cfg.adaptive_damp, device=self.device)

    @profiling.spanned(profiling.ENTRY_DIAGNOSTICS)
    def record_diagnostics(self, diags: ObsDiagnostics) -> None:
        """Write the per-ob diagnostics onto the ObservationBatch as host
        NumPy (one transfer), hand it back in the caller's order as
        ``self.obs``, and write it onto the caller's Observation objects
        when it passed those."""
        host = [d.detach().cpu().numpy() for d in diags]
        b = self._batch
        b.prior_mean = host[0].astype(np.float64)
        b.prior_var = host[1].astype(np.float64)
        b.post_mean = host[2].astype(np.float64)
        b.post_var = host[3].astype(np.float64)
        b.assimilated = host[4].astype(bool)
        self.obs = b if self._obs_unsort is None else b.take(self._obs_unsort)
        if self._user_obs is not None and all(
                isinstance(o, Observation) for o in self._user_obs):
            self.obs.writeback(self._user_obs)


def update(prior_state: EnsembleState, obs, inflate: InflationSpec = None,
           loc=False, nproc: int = 1, verbose: bool = False, mesh=None,
           config: Optional[FilterConfig] = None, solver: str = "ensrf",
           device=None):
    """One-call update (the reference's ``assimilation.py:176-230``):
    ``(posterior, observations)`` from ``solver`` ``"ensrf"`` (default),
    ``"letkf"`` or ``"enkf"``.  ``nproc`` is accepted for the reference's
    signature; ``mesh`` (a :class:`~efa_xray_tpu_torch.parallel.mesh.Mesh`)
    splits the state body over its devices.  ``device``: the filter's (the
    state's by default)."""
    from efa_xray_tpu_torch.assimilation.enkf import EnKF
    from efa_xray_tpu_torch.assimilation.ensrf import EnSRF
    from efa_xray_tpu_torch.assimilation.letkf import LETKF

    try:
        cls = {"ensrf": EnSRF, "letkf": LETKF, "enkf": EnKF}[solver]
    except KeyError:
        raise ValueError(f"unknown solver {solver!r}") from None
    if config is None:
        config = FilterConfig(
            localization="GC" if loc not in (None, False) else None,
            verbose=verbose)
    kwargs = dict(inflation=inflate, verbose=verbose, loc=loc, config=config,
                  mesh=mesh, device=device)
    if cls is EnSRF:
        kwargs["nproc"] = nproc
    return cls(prior_state, obs, **kwargs).update()
