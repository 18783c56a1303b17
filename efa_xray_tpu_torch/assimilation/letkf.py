"""LETKF: the user-facing local ensemble transform Kalman filter.

Counterpart of ``efa_xray_tpu/assimilation/letkf.py``: the host-certified
selection cache ``_host_selection_cached`` :61 (with
``SEL_CACHE_MAX_PER_STRUCTURE`` and the ``sel_build_count`` counter of
actual builds) and the ``LETKF`` class :129.  Same construction and
update contract as :class:`~efa_xray_tpu_torch.assimilation.ensrf.EnSRF`:
``LETKF(state, obs, config=..., device=...).update()`` returns
``(posterior, observations)`` with per-ob diagnostics recorded.  All
observations are analysed at once (:mod:`letkf_core`); localization is
horizontal (rows of a column share one solve) or horizontal x vertical
(solves per level group), and ``variable_localization`` multiplies rho
per (analysed variable, observed variable).

The selection cache is keyed on the structure, the obs network and the
selection geometry, and on the torch device the candidates live on, so a
cycling workload re-observing one network on one device builds the host
kd-tree certificates once.  ``mesh=`` splits the grid over the mesh's
devices (``parallel.sharded.letkf_update_sharded``, JAX ``letkf.py:
210-250``); the host selection is then built per shard (``ndev``).
"""

from __future__ import annotations

import collections
import hashlib
import threading
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from efa_xray_tpu_torch.assimilation import letkf_core
from efa_xray_tpu_torch.assimilation.adaptive_inflation import (
    row_spread,
    rtpp,
    rtps,
)
from efa_xray_tpu_torch.assimilation.assimilation import Assimilation
from efa_xray_tpu_torch.config import FilterConfig
from efa_xray_tpu_torch.observation.observation import ObservationBatch
from efa_xray_tpu_torch.state.ensemble import EnsembleState
from efa_xray_tpu_torch.utils import profiling

_SEL_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
SEL_CACHE_MAX_PER_STRUCTURE = 8
# Host kd-tree builds (cache misses), and the lock that guards the count.
sel_build_count = 0
_count_lock = threading.Lock()


def _host_selection_cached(structure, obs_lats, obs_lons, k: int,
                           patch_size: int, chunk: int, device,
                           ndev: int = 0):
    """``(cand, mask, group)`` for this (grid, obs network, selection
    geometry, device): :func:`letkf_core.host_select_candidates` built on
    the host on first use, its candidates uploaded to ``device`` once.

    ``ndev = 0``: the single-device layout.  ``ndev > 0``: the sharded
    layout of ``letkf_update_sharded``, which pads the grid to a multiple
    of ``ndev * patch_size`` and runs each shard's own patch and chunk
    partition: the candidates are built per shard (with one common width
    S and one bundle size, the smallest the shards pick) and stacked along
    the group axis, which the driver splits like the grid."""
    global sel_build_count
    device = torch.device(device)
    h = hashlib.sha256()
    for a in (obs_lats, obs_lons):
        h.update(np.ascontiguousarray(np.asarray(a, np.float64)).tobytes())
    h.update(repr((k, patch_size, chunk, str(device), ndev)).encode())
    key = h.hexdigest()
    per = _SEL_CACHE.get(structure)
    if per is not None and key in per:
        per.move_to_end(key)
        return per[key]
    glat = np.asarray(structure.lat.ravel(), np.float64)
    glon = np.asarray(structure.lon.ravel(), np.float64)
    ngrid = structure.ngrid
    if ndev == 0:
        cand, mask, geff = letkf_core.host_select_candidates(
            glat, glon, ngrid, patch_size, obs_lats, obs_lons, k,
            chunk=chunk)
    else:
        from efa_xray_tpu_torch.parallel.mesh import pad_to_multiple

        g_pad = pad_to_multiple(ngrid, ndev * patch_size)
        glat = np.concatenate([glat, np.repeat(glat[-1:], g_pad - ngrid)])
        glon = np.concatenate([glon, np.repeat(glon[-1:], g_pad - ngrid)])
        g_local = g_pad // ndev
        chunk_local = min(chunk, max(1, -(-g_local // patch_size)))

        def shard(s, **kw):
            return letkf_core.host_select_candidates(
                glat[s * g_local:(s + 1) * g_local],
                glon[s * g_local:(s + 1) * g_local], g_local, patch_size,
                obs_lats, obs_lons, k, chunk=chunk_local, **kw)

        parts = [shard(s) for s in range(ndev)]
        # Each shard picks its own bundle size (g0, g0 / 4 or g0 / 16), so
        # the smallest pick divides the others: the shards that picked
        # otherwise are rebuilt at it, still certified exact, so that
        # every shard has one group layout.
        geff = min(p[2] for p in parts)
        parts = [p if p[2] == geff else shard(s, group=geff, auto_group=False)
                 for s, p in enumerate(parts)]
        width = max(p[0].shape[1] for p in parts)
        cand, mask = (np.concatenate([
            np.pad(p[i], ((0, 0), (0, width - p[i].shape[1])))
            for p in parts]) for i in (0, 1))
    entry = (torch.from_numpy(cand).to(device),
             torch.from_numpy(mask).to(device), geff)
    with _count_lock:
        sel_build_count += 1
    if per is None:
        per = collections.OrderedDict()
        _SEL_CACHE[structure] = per
    per[key] = entry
    while len(per) > SEL_CACHE_MAX_PER_STRUCTURE:
        per.popitem(last=False)
    return entry


class LETKF(Assimilation):
    """The arguments and their defaults are the JAX package's
    (``letkf.py:130-139``), plus ``device`` (the state's by default)."""

    def __init__(self, state: EnsembleState, obs, inflation=None,
                 verbose: bool = False, loc="GC",
                 config: Optional[FilterConfig] = None, mesh=None,
                 device=None):
        if config is None:
            config = FilterConfig(
                localization="GC" if loc not in (None, False) else None,
                verbose=verbose)
        super().__init__(state, obs, inflation=inflation, verbose=verbose,
                         config=config, device=device, mesh=mesh)

    @profiling.spanned(profiling.ENTRY_UPDATE)
    def update(self) -> Tuple[EnsembleState, ObservationBatch]:
        """Assimilate all observations simultaneously; return
        ``(posterior, observations)`` with the observations in the
        caller's order."""
        cfg = self.config
        if cfg.hybrid_alpha < 1.0:
            raise ValueError(
                "hybrid covariance (hybrid_alpha < 1) is implemented for "
                "the EnSRF solver only; the LETKF would silently ignore "
                "the static-B blend")
        if cfg.variable_localization and cfg.letkf_topk == "host":
            raise ValueError(
                "variable_localization forces the per-(group, patch) "
                "solve layout, which letkf_topk='host' does not support; "
                "use letkf_topk='exact' or 'approx'")
        if self.verbose:
            self.log.info("Beginning LETKF update (all obs at once)")
        body_mean, body_perts, tail_mean, tail_perts = self.format_prior_state()
        obs = self.obs_arrays()
        obs = self.apply_outlier_check(obs, tail_mean, tail_perts)
        st = self.prior.structure
        dtype = self.dtype
        grid_lat, grid_lon = st.grid_latlon_device(dtype, self.device)
        vertical = cfg.localize and self._vertical_active()
        body_vert = (torch.tensor(st.row_vert(), dtype=dtype,
                                  device=self.device) if vertical else None)
        vl_kw = {}
        if cfg.variable_localization:
            # The R-localization analog of the EnSRF's factor, per
            # (analysed variable, observed variable): VT-fold solves.
            base = self.varloc_kwargs()
            group_var = np.repeat(np.arange(st.nvars), st.ntimes)
            vl_kw = dict(varloc=base["varloc"], ob_var=base["ob_var"],
                         group_var=torch.from_numpy(group_var).to(
                             self.device))
        sel_kw = {}
        if cfg.letkf_topk == "host" and cfg.localize:
            if vertical:
                raise ValueError(
                    "letkf_topk='host' supports horizontal-only "
                    "localization; use 'exact' or 'approx' with vertical "
                    "localization")
            cand, mask, geff = _host_selection_cached(
                st, self._batch.lats, self._batch.lons, cfg.letkf_k_obs,
                cfg.letkf_patch_size, cfg.letkf_chunk, self.device,
                ndev=0 if self.mesh is None else self.mesh.size)
            sel_kw = dict(sel_cand=cand, sel_mask=mask, sel_group=geff)
        prior_spread = row_spread(body_perts) if cfg.rtps_alpha > 0.0 else None
        # The update does not touch the prior in place: a reference
        # suffices.
        prior_perts = body_perts if cfg.rtpp_alpha > 0.0 else None
        kw = dict(ngrid=st.ngrid, patch_size=cfg.letkf_patch_size,
                  k_obs=cfg.letkf_k_obs, localize=cfg.localize,
                  sqrt_method=cfg.letkf_sqrt, ns_iters=cfg.letkf_ns_iters,
                  chunk=cfg.letkf_chunk, topk_method=cfg.letkf_topk,
                  vertical=vertical, body_vert=body_vert,
                  unbiased=cfg.unbiased_variance,
                  solve_precision=cfg.letkf_solve_precision, **sel_kw,
                  **vl_kw)
        if self.mesh is not None:
            from efa_xray_tpu_torch.parallel.sharded import (
                letkf_update_sharded,
            )

            bm, bp, _, _, diags = letkf_update_sharded(
                body_mean, body_perts, tail_mean, tail_perts, grid_lat,
                grid_lon, obs, mesh=self.mesh, **kw)
        else:
            bm, bp, _, _, diags = letkf_core.letkf_update(
                body_mean, body_perts, tail_mean, tail_perts, grid_lat,
                grid_lon, obs, **kw)
        if prior_spread is not None:
            bp = rtps(prior_spread, bp, cfg.rtps_alpha)
        if prior_perts is not None:
            bp = rtpp(prior_perts, bp, cfg.rtpp_alpha)
        self.record_diagnostics(diags)
        self.maybe_update_adaptive_inflation()
        self.post, _ = self.format_posterior_state(bm, bp)
        return self.post, self.obs
