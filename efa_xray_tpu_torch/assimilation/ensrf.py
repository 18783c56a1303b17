"""EnSRF: the user-facing serial ensemble square-root filter.

Counterpart of ``efa_xray_tpu/assimilation/ensrf.py``: the ``EnSRF`` class
:42, its kernel selection ``_use_pallas`` :85 and ``_tail_pallas`` :129
(here :meth:`EnSRF._use_kernels`), ``_update_impl`` :187 and the one-shot
``_solve_once`` :338.

Routing of ``method="blocked"`` with ``fast_geometry=True`` or without
localization, for any row layout: the panel-blocked tail
(``ensrf_core.tail_scan_blocked``: B1 panel solves, B2 out-of-panel
applies), then the body through B2.  On CUDA tensors those are the CUDA
kernels; on CPU tensors their plain versions.  ``method="serial"`` runs
the plain serial loop on any device (the JAX serial path has no kernel
either).  Exact-haversine localization (``fast_geometry=False``) runs the
plain blocked update on the CPU and raises on CUDA until its kernel (B4)
is ported.  Paths whose kernels or modules are not ported raise
``NotImplementedError`` rather than run a plain path on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from efa_xray_tpu_torch.assimilation import ensrf_core as core
from efa_xray_tpu_torch.assimilation.assimilation import Assimilation
from efa_xray_tpu_torch.config import FilterConfig
from efa_xray_tpu_torch.observation.observation import ObservationBatch
from efa_xray_tpu_torch.ops.ensrf_fused import fused_body
from efa_xray_tpu_torch.state.ensemble import EnsembleState


class EnSRF(Assimilation):
    """``EnSRF(state, obs, config=..., device=...).update()`` returns
    ``(posterior_state, observations)`` with per-ob diagnostics recorded
    (reference ``efa_xray/assimilation/ensrf.py:8-151``).  ``device``
    defaults to the state's device."""

    def __init__(self, state: EnsembleState, obs, inflation=None,
                 verbose: bool = True, loc=False,
                 config: Optional[FilterConfig] = None, device=None,
                 mesh=None):
        if config is None:
            config = FilterConfig(
                localization="GC" if loc not in (None, False) else None,
                verbose=verbose)
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (multi-device row sharding) is not ported yet "
                "(ROADMAP A10)")
        super().__init__(state, obs, inflation=inflation, verbose=verbose,
                         config=config, device=device)
        self.loc = loc if loc not in (None, False) else (config.localization
                                                         or False)

    def _use_kernels(self) -> bool:
        """The B1/B2 route: blocked method with chordal geometry or no
        localization.  Its kernels run on CUDA tensors, their plain
        versions on CPU tensors."""
        cfg = self.config
        return cfg.method == "blocked" and (cfg.fast_geometry
                                            or not cfg.localize)

    def _check_ported(self) -> None:
        cfg = self.config
        missing = []
        if cfg.hybrid_alpha < 1.0:
            missing.append("hybrid_alpha < 1 (the B2 hybrid static-column "
                           "branch, ROADMAP queue B)")
        if cfg.variable_localization:
            missing.append("variable_localization (kernel B3, ROADMAP "
                           "queue B)")
        if cfg.obs_chunk:
            missing.append("obs_chunk (the obs-chunked driver, ROADMAP A6)")
        if cfg.obs_order is not None or cfg.spatial_sort:
            missing.append("obs_order / spatial_sort (ROADMAP A7)")
        if cfg.rtps_alpha > 0.0 or cfg.rtpp_alpha > 0.0:
            missing.append("RTPS/RTPP relaxation (ROADMAP A7)")
        if (self.device.type == "cuda" and cfg.method == "blocked"
                and cfg.localize and not cfg.fast_geometry):
            missing.append("fast_geometry=False on CUDA (exact-haversine "
                           "kernel B4, ROADMAP queue B)")
        if missing:
            raise NotImplementedError("not ported yet: " + "; ".join(missing))

    def update(self) -> Tuple[EnsembleState, ObservationBatch]:
        """Assimilate all observations; return ``(posterior, observations)``."""
        self._check_ported()
        cfg = self.config
        if self.verbose:
            self.log.info("Beginning update sequence")
        body_mean, body_perts, tail_mean, tail_perts = self.format_prior_state()
        obs = self.obs_arrays()
        obs = self.apply_outlier_check(obs, tail_mean, tail_perts)
        body_lat, body_lon = self.prior.structure.row_latlon_device(
            self.dtype, self.device)
        vertical = cfg.localize and self._vertical_active()
        body_vert = None
        if vertical:
            body_vert = torch.tensor(self.prior.structure.row_vert(),
                                     dtype=self.dtype, device=self.device)
        if self.verbose:
            self.log.info("Beginning observation loop (%s)", cfg.method)
        bm, bp, tm, tp, diags = self._solve_once(
            body_mean, body_perts, tail_mean, tail_perts, body_lat, body_lon,
            obs, body_vert, vertical)
        self.record_diagnostics(diags)
        self.post, _ = self.format_posterior_state(bm, bp)
        return self.post, self.obs

    def _solve_once(self, body_mean, body_perts, tail_mean, tail_perts,
                    body_lat, body_lon, obs, body_vert, vertical: bool):
        """One full update (tail + body); ``(bm, bp, tm, tp, diags)``."""
        cfg = self.config
        if cfg.method == "serial":
            return core.ensrf_serial(
                body_mean, body_perts, tail_mean, tail_perts, body_lat,
                body_lon, obs, localize=cfg.localize,
                unbiased=cfg.unbiased_variance,
                fast_geometry=cfg.fast_geometry, body_vert=body_vert,
                vertical=vertical)
        if not self._use_kernels():
            return core.ensrf_blocked(
                body_mean, body_perts, tail_mean, tail_perts, body_lat,
                body_lon, obs, localize=cfg.localize,
                block_size=cfg.block_size, unbiased=cfg.unbiased_variance,
                fast_geometry=cfg.fast_geometry, body_vert=body_vert,
                vertical=vertical)
        max_radius = self.max_finite_radius()
        tail = core.tail_scan_blocked(
            tail_mean, tail_perts, obs, localize=cfg.localize,
            unbiased=cfg.unbiased_variance, fast_geometry=cfg.fast_geometry,
            vertical=vertical, panel=cfg.tail_panel, kernels=True,
            max_radius_km=max_radius)
        # The filter owns the formatted prior: B2 updates it in place,
        # where the JAX package donates it
        # (ensrf_blocked_body_pallas_fused_donating).
        bm, bp = fused_body(
            body_mean, body_perts, body_lat, body_lon, tail, obs,
            body_vert=body_vert if vertical else None,
            localize=cfg.localize, block_size=cfg.block_size,
            vertical=vertical, cull=cfg.cull, max_radius_km=max_radius,
            donate=True)
        return bm, bp, tail.tail_mean, tail.tail_perts, tail.diags
