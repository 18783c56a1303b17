"""Converters between NumPy data and the port's objects.

No JAX counterpart.  The system has no weights: what crosses between the
JAX package and this one is data, so both are fed the same NumPy arrays.
These functions take NumPy arrays and plain dicts, build the port's
objects on a device, the card unless ``device`` names another (without a
card, ``device="cpu"`` must be given), and turn results back into NumPy.
A cycle's state crosses too: adaptive-inflation fields through
:func:`adaptive_inflation_from_numpy`, a ``BiasCorrection`` through its
own ``to_dict`` / ``from_dict``, the shallow-water model's dicts and a
cycling harness's flat ensembles through :func:`fields_from_numpy` and
:func:`flat_ensemble_from_numpy`, and a harness's transient fields back to
NumPy through :func:`harness_transients_to_numpy` (:func:`to_host`).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from efa_xray_tpu_torch.assimilation.adaptive_inflation import (
    AdaptiveInflation,
)
from efa_xray_tpu_torch.assimilation.ensrf_core import (
    ObsArrays,
    ObsDiagnostics,
    TailSolution,
)
from efa_xray_tpu_torch.observation.observation import ObservationBatch
from efa_xray_tpu_torch.state.ensemble import (
    EnsembleState,
    _torch_dtype,
    default_device,
)


def _tensor(x, dtype, device: torch.device) -> torch.Tensor:
    arr = np.array(x)  # a copy: torch refuses read-only NumPy buffers
    t = torch.from_numpy(arr).to(device)
    return t if dtype is None or t.dtype == torch.bool else t.to(dtype)


def state_from_numpy(data: Dict[str, np.ndarray], coords: Dict, dtype=None,
                     device=None, attrs: Optional[Dict] = None
                     ) -> EnsembleState:
    """``{var: (ntimes, ny, nx, nmems)}`` and ``{validtime, lat, lon,
    mem}`` -> :class:`EnsembleState` on ``device``."""
    fields = {k: torch.from_numpy(np.array(v)) for k, v in data.items()}
    return EnsembleState.from_vardict(fields, coords, dtype=dtype,
                                      device=device, attrs=attrs)


def state_to_numpy(state: EnsembleState) -> np.ndarray:
    """Dense ``[nvars, ntimes, ny, nx, nmems]`` NumPy array."""
    return state.data.detach().cpu().numpy()


def obs_batch_from_numpy(fields: Dict) -> ObservationBatch:
    """An :class:`ObservationBatch` from a dict of its fields.  Required:
    ``values, errors, lats, lons, times_s, obtypes``; the rest default
    (unlocalized, assimilated, no vertical coordinate)."""
    n = len(fields["values"])
    f = dict(fields)
    f.setdefault("localize_radius", np.full(n, np.inf))
    f.setdefault("assimilate_flags", np.ones(n, bool))
    f.setdefault("verts", np.full(n, np.nan))
    f.setdefault("descriptions", [None] * n)
    for k in ("values", "errors", "lats", "lons", "localize_radius", "verts"):
        f[k] = np.asarray(f[k], dtype=np.float64)
    f["assimilate_flags"] = np.asarray(f["assimilate_flags"], dtype=bool)
    f["times_s"] = np.asarray(f["times_s"], dtype=np.int64)
    f["obtypes"] = list(f["obtypes"])
    return ObservationBatch(**f)


def obs_arrays_from_numpy(values, errors, lats, lons, radii, assim,
                          verts=None, vert_radii=None, dtype="float64",
                          device=None) -> ObsArrays:
    """:class:`ObsArrays` on ``device``; ``assim`` stays bool."""
    dt = _torch_dtype(dtype)
    device = default_device(device)
    t = lambda x: None if x is None else _tensor(x, dt, device)
    return ObsArrays(values=t(values), errors=t(errors), lats=t(lats),
                     lons=t(lons), radii=t(radii),
                     assim=_tensor(np.asarray(assim, bool), None, device),
                     verts=t(verts), vert_radii=t(vert_radii))


def obs_arrays_to_numpy(obs: ObsArrays) -> Dict[str, np.ndarray]:
    return {k: None if v is None else v.detach().cpu().numpy()
            for k, v in obs._asdict().items()}


def tail_solution_from_numpy(ye, gain_coef, sqrt_coef, tail_mean,
                             tail_perts, prior_mean, prior_var, post_mean,
                             post_var, assimilated, dtype="float64",
                             device=None, static_gain=None,
                             static_sqrt=None) -> TailSolution:
    """:class:`TailSolution` on ``device`` from its NumPy fields (the
    static-column scalars only in hybrid mode)."""
    dt = _torch_dtype(dtype)
    device = default_device(device)
    t = lambda x: _tensor(x, dt, device)
    return TailSolution(
        ye=t(ye), gain_coef=t(gain_coef), sqrt_coef=t(sqrt_coef),
        tail_mean=t(tail_mean), tail_perts=t(tail_perts),
        diags=ObsDiagnostics(t(prior_mean), t(prior_var), t(post_mean),
                             t(post_var),
                             _tensor(np.asarray(assimilated, bool), None,
                                     device)),
        static_gain=None if static_gain is None else t(static_gain),
        static_sqrt=None if static_sqrt is None else t(static_sqrt))


def tail_solution_to_numpy(tail: TailSolution) -> Dict[str, np.ndarray]:
    """Flat dict of every field, diagnostics included (the keyword
    arguments of :func:`tail_solution_from_numpy`)."""
    out = {k: getattr(tail, k).detach().cpu().numpy()
           for k in ("ye", "gain_coef", "sqrt_coef", "tail_mean",
                     "tail_perts", "static_gain", "static_sqrt")
           if getattr(tail, k) is not None}
    for k, v in tail.diags._asdict().items():
        out[k] = v.detach().cpu().numpy()
    return out


def adaptive_inflation_from_numpy(state: EnsembleState, mean: Dict,
                                  std: Dict,
                                  device=None) -> AdaptiveInflation:
    """An :class:`AdaptiveInflation` on ``state``'s grid from ``{var:
    [ntimes, ny, nx]}`` mean and std fields (e.g. ``np.asarray`` of a JAX
    ``AdaptiveInflation``'s dicts mid-cycle), updating on ``device``
    (``state``'s unless given)."""
    return AdaptiveInflation.from_fields(
        state.structure, mean, std,
        device=state.device if device is None else device)



def fields_from_numpy(fields: Dict[str, np.ndarray], dtype=None,
                      device=None) -> Dict[str, torch.Tensor]:
    """A dict of arrays (e.g. ``np.asarray`` of a JAX shallow-water state's
    ``{"eta", "u", "v"}``) as tensors on ``device``; ``dtype`` None keeps
    each array's."""
    device = default_device(device)
    dt = None if dtype is None else _torch_dtype(dtype)
    return {k: _tensor(v, dt, device) for k, v in fields.items()}


def flat_ensemble_from_numpy(x, dtype=None, device=None) -> torch.Tensor:
    """A flat ensemble ``[nmems, nvars]`` (or a truth ``[nvars]``) as a
    tensor on ``device``; ``dtype`` None keeps the array's."""
    return _tensor(x, None if dtype is None else _torch_dtype(dtype),
                   default_device(device))


def to_host(x):
    """Tensors as NumPy, lists and tuples of them element by element, other
    arrays (a JAX array) through ``np.asarray``; NumPy values, scalars,
    None and anything else as they are."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    if hasattr(x, "__array__") and not isinstance(x, (np.ndarray,
                                                      np.generic)):
        return np.asarray(x)
    return x


def harness_transients_to_numpy(harness) -> Dict[str, object]:
    """Every transient field a cycling harness holds after ``run()`` (its
    ``_TRANSIENT`` names: inflation, R, bias, IAU increment, smoother
    window, final ensemble and truth, ...) through :func:`to_host`.  Takes
    the port's harness or the JAX package's, so two runs compare field by
    field."""
    return {k: to_host(getattr(harness, k)) for k in harness._TRANSIENT
            if hasattr(harness, k)}
