"""EnSRF: the user-facing serial ensemble square-root filter.

Counterpart of ``efa_xray_tpu/assimilation/ensrf.py``: the ``EnSRF`` class
:42, its kernel selection ``_grid_kernel_ok`` :70, ``_use_pallas`` :85 and
``_tail_pallas`` :129 (here :meth:`KernelRoute._grid_kernel_ok`,
:meth:`KernelRoute._use_kernels` and :meth:`KernelRoute._tail_kernels`),
``_hybrid_kwargs`` :150, ``_update_impl`` :187 (with RTPS/RTPP
:208-223, :324-331, and the adaptive-inflation learning :334), the
one-shot ``_solve_once`` :338 (here :meth:`KernelRoute.solve`), the
obs-chunked ``_solve_obs_chunked`` :522 and ``_body_apply`` :618.

The route and its solve live in :class:`KernelRoute`, which ``EnSRF``
takes on for its state and :class:`FlatRoute` for a flat ensemble: the
cycling harness (``models/cycling.py``) runs its EnSRF analysis through
``FlatRoute``, so that it takes the kernels the same way.

Routing, branch for branch as the JAX package routes a TPU run
(:meth:`KernelRoute._route`):

* ``method="serial"``: the plain serial loop on any device (the JAX serial
  path has no kernel either);
* ``method="blocked"``, gridded state with vt = nvars * ntimes > 1,
  ``fast_geometry``, localization and no hybrid: the body through B3,
  with ``variable_localization`` carried in its per-(group, ob) table;
* otherwise with ``fast_geometry`` or without localization: the body
  through B2, or through its hybrid instantiation B2h when
  ``hybrid_alpha < 1`` (gridded states too, with per-row weights);
* otherwise (exact haversine, the default ``FilterConfig``): the body
  through B4, one launch per obs block;
* ``variable_localization`` where B3 cannot carry it (a flat state, or
  exact haversine), hybrid with exact haversine, and ``dtype="float64"``
  on the card: the plain blocked update, as the JAX package runs no kernel
  there either (its tail is the plain per-ob panel scan; ROADMAP C).

On every kernel route the tail's panels are solved by B1 (B1h in hybrid
mode) with weights built per panel, and applied out of panel by B2
(chordal or unlocalized, no ``variable_localization``), by B4 (exact
haversine or ``variable_localization``) or, in hybrid mode, by the plain
apply with its static columns (``ensrf_core.tail_scan_blocked``).  The
JAX package takes its tail kernel on the chordal runs only; the port's
B1 carries the others' weights, the same function.  On CUDA tensors the
kernels run; on CPU tensors their plain versions.

``spatial_sort`` hands B2 (B2h) the structure's Hilbert row order (a flat
state's, from its rows' coordinates).
``obs_chunk`` solves the tail once over the whole batch, padded to whole
chunks with no-op obs, then sweeps the body chunk by chunk along the same
route; it refuses hybrid covariance and ``variable_localization`` with a
``ValueError``, as the JAX package does.  The JAX package's automatic
chunking of batches over 131072 obs on a TPU is left out: ``obs_chunk=None``
is one shot.

``matmul_precision`` and ``mxu_bf16`` set the mode of the body kernel's
two large products (:func:`~efa_xray_tpu_torch.ops.precision.product_mode`:
TF32 or bf16 tensor cores on the card; ``mxu_bf16`` casts B2, B2h and B3
on every device), passed at the body call sites where the JAX package
passes ``mxu_bf16`` (its ``ensrf.py:310``, :435, :479, :648, :668).  The
tail's launches, the plain route and a float64 update stay fp32.

``mesh=`` (a :class:`~efa_xray_tpu_torch.parallel.mesh.Mesh`, JAX
``ensrf.py:257-301``) runs the update through
:func:`~efa_xray_tpu_torch.parallel.sharded.ensrf_update_sharded`: the
rows split over the mesh's devices, the tail solved once per distinct
device, each shard along the JAX sharded route (B1 tail, then B2, B2h or
B4 as a flat state; never B3), the shards gathered.  It refuses a
positive ``obs_chunk`` with the JAX package's message.  The JAX package's
refusal of more than 131072 obs on a mesh guards a TPU worker crash and is
left out: the card ran 160,000 obs in one shot.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from efa_xray_tpu_torch.assimilation import ensrf_core as core
from efa_xray_tpu_torch.assimilation.adaptive_inflation import (
    row_spread,
    rtpp,
    rtps,
)
from efa_xray_tpu_torch.assimilation.assimilation import Assimilation
from efa_xray_tpu_torch.config import FilterConfig
from efa_xray_tpu_torch.observation import forward as _fwd
from efa_xray_tpu_torch.observation.observation import ObservationBatch
from efa_xray_tpu_torch.ops import ensrf_grid
from efa_xray_tpu_torch.ops.ensrf_fused import fused_body
from efa_xray_tpu_torch.ops.precision import product_mode
from efa_xray_tpu_torch.state.ensemble import EnsembleState
from efa_xray_tpu_torch.utils import profiling


class KernelRoute:
    """The EnSRF's route and its solve, shared by :class:`EnSRF` and by
    :class:`~efa_xray_tpu_torch.models.cycling.CyclingHarness` (through
    :class:`FlatRoute`), so that both take one route for one state.

    A subclass provides ``config``, ``device``, ``dtype``,
    :meth:`max_finite_radius` and :meth:`_route_structure`: the state's
    ``StateStructure``, or None for a flat state (rows with coordinates
    and nothing else; never B3, B4 as one group, ``spatial_sort`` from the
    rows' own coordinates)."""

    def _route_structure(self):
        return None

    def _grid_kernel_ok(self) -> bool:
        """B3 eligibility: rows tile one spatial grid over vt > 1 groups,
        chordal localization, no hybrid."""
        cfg = self.config
        st = self._route_structure()
        if st is None:
            return False
        vt = st.nvars * st.ntimes
        return (cfg.localize and cfg.fast_geometry and vt > 1
                and st.ngrid > 0 and st.nstate == vt * st.ngrid
                and cfg.hybrid_alpha >= 1.0)

    def _use_kernels(self) -> bool:
        """The kernel route (``_use_pallas`` on a TPU): the blocked method,
        float32 on the card (the kernels' type; float64 runs them only as
        their plain versions, on CPU tensors); hybrid only with chordal
        geometry or no localization; with ``variable_localization`` only
        where B3 carries it.  Its kernels run on CUDA tensors, their plain
        versions on CPU tensors."""
        cfg = self.config
        ok = cfg.method == "blocked" and (self.device.type != "cuda"
                                          or self.dtype == torch.float32)
        if cfg.hybrid_alpha < 1.0:
            ok = ok and (cfg.fast_geometry or not cfg.localize)
        if cfg.variable_localization:
            ok = ok and self._grid_kernel_ok()
        return ok

    def _tail_kernels(self) -> bool:
        """The kernel tail (B1 or B1h, then B2, B4 or the plain hybrid
        apply): on every kernel route."""
        return self._use_kernels()

    def _route(self, nrows: int) -> str:
        """The body path of an update on ``nrows`` state rows: ``"serial"``,
        ``"plain"`` (the plain blocked update), ``"B3"``, ``"B2"``,
        ``"B2h"`` or ``"B4"``."""
        cfg = self.config
        if cfg.method == "serial":
            return "serial"
        if not self._use_kernels():
            return "plain"
        st = self._route_structure()
        if (self._grid_kernel_ok()
                and nrows == st.nvars * st.ntimes * st.ngrid):
            return "B3"
        if cfg.fast_geometry or not cfg.localize:
            return "B2h" if cfg.hybrid_alpha < 1.0 else "B2"
        return "B4"

    def _row_order(self, body_lat, body_lon):
        """``spatial_sort``'s ``(order, inverse)`` of the body rows: the
        structure's cached Hilbert order, or for a flat state the order of
        ``body_lat``/``body_lon`` (float32, as the structure builds it)."""
        st = self._route_structure()
        if st is not None:
            return st.spatial_order_device(self.device)
        from efa_xray_tpu_torch.observation.localization import (
            spatial_sort_order,
        )

        order = spatial_sort_order(body_lat.float(), body_lon.float())
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.shape[0], device=order.device)
        return order, inv

    def _kernel_tail(self, tail_mean, tail_perts, obs, vertical: bool,
                     hkw: dict, vl: dict) -> core.TailSolution:
        """Phase 1 of a kernel route: ``tail_scan_blocked(kernels=True)``."""
        cfg = self.config
        return core.tail_scan_blocked(
            tail_mean, tail_perts, obs, localize=cfg.localize,
            unbiased=cfg.unbiased_variance, fast_geometry=cfg.fast_geometry,
            vertical=vertical, panel=cfg.tail_panel,
            kernels=self._tail_kernels(),
            max_radius_km=self.max_finite_radius(),
            **{k: v for k, v in hkw.items() if k != "body_sigma"},
            **({k: vl[k] for k in ("varloc", "ob_var")} if vl else {}))

    @profiling.spanned(profiling.ROUTE_SOLVE)
    def solve(self, body_mean, body_perts, tail_mean, tail_perts, body_lat,
              body_lon, obs, body_vert=None, vertical: bool = False,
              hkw: Optional[dict] = None, vl: Optional[dict] = None):
        """One full update (tail + body) along :meth:`_route`; ``(bm, bp,
        tm, tp, diags)``.  ``hkw``: hybrid inputs
        (:meth:`EnSRF._hybrid_kwargs`), ``vl``: cross-variable ones
        (``Assimilation.varloc_kwargs``).  The body kernels update
        ``body_mean``/``body_perts`` in place."""
        cfg = self.config
        hkw = hkw or {}
        vl = vl or {}
        route = self._route(int(body_mean.shape[0]))
        if route == "serial":
            return core.ensrf_serial(
                body_mean, body_perts, tail_mean, tail_perts, body_lat,
                body_lon, obs, localize=cfg.localize,
                unbiased=cfg.unbiased_variance,
                fast_geometry=cfg.fast_geometry, body_vert=body_vert,
                vertical=vertical, **hkw, **vl)
        if route == "plain":
            return core.ensrf_blocked(
                body_mean, body_perts, tail_mean, tail_perts, body_lat,
                body_lon, obs, localize=cfg.localize,
                block_size=cfg.block_size, unbiased=cfg.unbiased_variance,
                fast_geometry=cfg.fast_geometry, body_vert=body_vert,
                vertical=vertical, **hkw, **vl)
        tail = self._kernel_tail(tail_mean, tail_perts, obs, vertical, hkw,
                                 vl)
        bm, bp = self._body_apply(route, body_mean, body_perts, body_lat,
                                  body_lon, tail, obs, body_vert, vertical,
                                  hkw, vl)
        return bm, bp, tail.tail_mean, tail.tail_perts, tail.diags

    @profiling.spanned(profiling.ROUTE_BODY)
    def _body_apply(self, route: str, bm, bp, body_lat, body_lon, tail, obs,
                    body_vert, vertical: bool, hkw: dict, vl: dict):
        """Phase 2: apply a pre-solved obs sequence to the state body along
        ``route`` (B3, B2/B2h, B4, or the plain blocked body for the
        ``"plain"`` and ``"serial"`` routes), the kernel's two large
        products in the configuration's mode.  The caller owns the
        formatted prior: the body kernels update it in place, where the
        JAX package donates it."""
        cfg = self.config
        st = self._route_structure()
        bvert = body_vert if vertical else None
        mode = product_mode(cfg, route, self.device)
        if route in ("plain", "serial"):
            return core.ensrf_blocked_body(
                bm, bp, body_lat, body_lon, tail, obs, localize=cfg.localize,
                block_size=cfg.block_size, fast_geometry=cfg.fast_geometry,
                body_vert=body_vert, vertical=vertical, hybrid=bool(hkw),
                body_sigma=hkw.get("body_sigma"),
                static_length=hkw.get("static_length"), **vl)
        if route == "B3":
            group_factor = None
            if vl:
                vt = st.nvars * st.ntimes
                varg = torch.arange(vt, device=self.device) // st.ntimes
                group_factor = vl["varloc"][vl["ob_var"]][:, varg].T
            return ensrf_grid.grid_body(
                bm, bp, body_lat, body_lon, tail, obs, ngrid=st.ngrid,
                body_vert=bvert, localize=cfg.localize,
                block_size=cfg.block_size, vertical=vertical,
                group_factor=group_factor, donate=True, precision=mode)
        if route in ("B2", "B2h"):
            row_order = inv_order = None
            if cfg.spatial_sort:
                row_order, inv_order = self._row_order(body_lat, body_lon)
            return fused_body(
                bm, bp, body_lat, body_lon, tail, obs, body_vert=bvert,
                localize=cfg.localize, block_size=cfg.block_size,
                vertical=vertical, cull=cfg.cull,
                max_radius_km=self.max_finite_radius(),
                hybrid=route == "B2h", body_sigma=hkw.get("body_sigma"),
                static_length=hkw.get("static_length"), donate=True,
                row_order=row_order, inv_order=inv_order, precision=mode)
        return ensrf_grid.blocked_body(
            bm, bp, body_lat, body_lon, tail, obs, localize=cfg.localize,
            block_size=cfg.block_size, fast_geometry=cfg.fast_geometry,
            body_vert=body_vert, vertical=vertical,
            ngrid=None if st is None else st.ngrid, donate=True,
            precision=mode)


class FlatRoute(KernelRoute):
    """:class:`KernelRoute` over a flat state: ``config``, the device and
    the radius bound of the obs (km, None when none is localized)."""

    def __init__(self, config: FilterConfig, device,
                 max_radius_km: Optional[float] = None):
        self.config = config
        self.device = torch.device(device)
        self._max_radius_km = max_radius_km

    @property
    def dtype(self) -> torch.dtype:
        from efa_xray_tpu_torch.state.ensemble import _torch_dtype

        return _torch_dtype(self.config.dtype)

    def max_finite_radius(self):
        return self._max_radius_km


class EnSRF(Assimilation, KernelRoute):
    """``EnSRF(state, obs, config=..., device=...).update()`` returns
    ``(posterior_state, observations)`` with per-ob diagnostics recorded
    (reference ``efa_xray/assimilation/ensrf.py:8-151``).  ``device``
    defaults to the state's device."""

    def __init__(self, state: EnsembleState, obs, nproc: int = 1,
                 inflation=None, verbose: bool = True, loc=False,
                 config: Optional[FilterConfig] = None, device=None,
                 mesh=None):
        if config is None:
            config = FilterConfig(
                localization="GC" if loc not in (None, False) else None,
                verbose=verbose)
        super().__init__(state, obs, nproc, inflation=inflation,
                         verbose=verbose, config=config, device=device,
                         mesh=mesh)
        self.loc = loc if loc not in (None, False) else (config.localization
                                                         or False)

    def _route_structure(self):
        return self.prior.structure

    def _hybrid_kwargs(self, body_mean) -> dict:
        """Static-B inputs for ``hybrid_alpha < 1`` (empty dict otherwise):
        the per-row sigma (``static_b_sigma``, a scalar or one value per
        state row) and its interpolation to the obs with the state's
        forward-operator taps."""
        cfg = self.config
        if cfg.hybrid_alpha >= 1.0:
            return {}
        bsig = core.sigma_rows(cfg.static_b_sigma, body_mean)
        tsig = _fwd.apply_taps_obj(bsig[:, None], self.build_taps())[:, 0]
        return dict(hybrid_alpha=float(cfg.hybrid_alpha), body_sigma=bsig,
                    tail_sigma=tsig,
                    static_length=float(cfg.static_b_length))

    @profiling.spanned(profiling.ENTRY_UPDATE)
    def update(self) -> Tuple[EnsembleState, ObservationBatch]:
        """Assimilate all observations; return ``(posterior, observations)``
        with the observations in the caller's order."""
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
        # The body kernels update the prior in place: RTPS takes the prior
        # spread and RTPP a copy of the prior perturbations first.
        prior_spread = (row_spread(body_perts) if cfg.rtps_alpha > 0.0
                        else None)
        prior_perts = body_perts.clone() if cfg.rtpp_alpha > 0.0 else None
        nobs = int(obs.values.shape[0])
        chunk = int(cfg.obs_chunk or 0)
        if self.mesh is not None:
            bm, bp, tm, tp, diags = self._solve_sharded(
                body_mean, body_perts, tail_mean, tail_perts, body_lat,
                body_lon, obs, body_vert, vertical)
        elif chunk and nobs > chunk:
            if cfg.hybrid_alpha < 1.0 or cfg.variable_localization:
                raise ValueError(
                    "obs_chunk does not combine with hybrid covariance or "
                    "variable localization (the chunked body sweep carries "
                    "no per-row static/var inputs)")
            bm, bp, tm, tp, diags = self._solve_obs_chunked(
                body_mean, body_perts, tail_mean, tail_perts, body_lat,
                body_lon, obs, body_vert, vertical, chunk)
        else:
            bm, bp, tm, tp, diags = self._solve_once(
                body_mean, body_perts, tail_mean, tail_perts, body_lat,
                body_lon, obs, body_vert, vertical)
        if prior_spread is not None:
            bp = rtps(prior_spread, bp, cfg.rtps_alpha)
        if prior_perts is not None:
            bp = rtpp(prior_perts, bp, cfg.rtpp_alpha)
        self.record_diagnostics(diags)
        self.maybe_update_adaptive_inflation()
        self.post, _ = self.format_posterior_state(bm, bp)
        return self.post, self.obs

    def _solve_once(self, body_mean, body_perts, tail_mean, tail_perts,
                    body_lat, body_lon, obs, body_vert, vertical: bool):
        """One full update (tail + body) along :meth:`_route`, with the
        state's hybrid and cross-variable inputs; ``(bm, bp, tm, tp,
        diags)``."""
        return self.solve(body_mean, body_perts, tail_mean, tail_perts,
                          body_lat, body_lon, obs, body_vert=body_vert,
                          vertical=vertical,
                          hkw=self._hybrid_kwargs(body_mean),
                          vl=self.varloc_kwargs())

    def _solve_sharded(self, body_mean, body_perts, tail_mean, tail_perts,
                       body_lat, body_lon, obs, body_vert, vertical: bool):
        """The update over ``self.mesh`` (JAX ``ensrf.py:257-301``); the
        sharded driver has no chunked mode, so a positive ``obs_chunk``
        raises."""
        from efa_xray_tpu_torch.parallel import sharded

        cfg = self.config
        if cfg.obs_chunk is not None and cfg.obs_chunk > 0:
            raise ValueError(
                "obs_chunk is a single-device driver; it does not "
                "combine with mesh=. Pre-split the batch into "
                "sequential EnSRF.update() calls, or pass obs_chunk=0 "
                "to force the one-shot sharded update.")
        return sharded.ensrf_update_sharded(
            body_mean, body_perts, tail_mean, tail_perts, body_lat,
            body_lon, obs, mesh=self.mesh, localize=cfg.localize,
            method=cfg.method, block_size=cfg.block_size,
            unbiased=cfg.unbiased_variance, fast_geometry=cfg.fast_geometry,
            body_vert=body_vert, vertical=vertical, donate=True,
            tail_panel=cfg.tail_panel, cull=cfg.cull,
            spatial_sort=cfg.spatial_sort,
            max_radius_km=self.max_finite_radius(),
            matmul_precision=cfg.matmul_precision, mxu_bf16=cfg.mxu_bf16,
            **self._hybrid_kwargs(body_mean), **self.varloc_kwargs())

    def _solve_obs_chunked(self, body_mean, body_perts, tail_mean,
                           tail_perts, body_lat, body_lon, obs, body_vert,
                           vertical: bool, chunk: int):
        """The batch padded to whole chunks of ``chunk`` obs: phase 1 once
        over all of it (the kernel tail on kernel routes, the plain per-ob
        scan on the plain and serial routes, as the JAX package), then
        phase 2 chunk by chunk along :meth:`_route`.  The padding obs have
        an infinite radius, unit error and ``assim=False``: their
        coefficients are 0, the body cull never keeps them alive and the
        angle form reads the finite radii only, so they are exact no-ops.
        Equal to the one-shot update up to fp reassociation;
        ``(bm, bp, tm, tp, diags)`` over the caller's obs."""
        cfg = self.config
        dtype = self.dtype
        nobs = int(obs.values.shape[0])
        nchunks = -(-nobs // chunk)
        pad = nchunks * chunk - nobs
        obs_p = core._pad_obs(obs, pad, dtype)
        tm_p = core._pad(tail_mean.to(dtype), pad)
        tp_p = core._pad(tail_perts.to(dtype), pad)
        route = self._route(int(body_mean.shape[0]))
        if route in ("plain", "serial"):
            tail = core.tail_scan(
                tm_p, tp_p, obs_p, localize=cfg.localize,
                unbiased=cfg.unbiased_variance,
                fast_geometry=cfg.fast_geometry, vertical=vertical)
        else:
            tail = self._kernel_tail(tm_p, tp_p, obs_p, vertical, {}, {})
        bm, bp = body_mean, body_perts
        for lo in range(0, nchunks * chunk, chunk):
            sl = slice(lo, lo + chunk)
            tail_i = tail._replace(
                ye=tail.ye[sl], gain_coef=tail.gain_coef[sl],
                sqrt_coef=tail.sqrt_coef[sl])
            obs_i = core.ObsArrays(*(x[sl] for x in obs_p))
            bm, bp = self._body_apply(route, bm, bp, body_lat, body_lon,
                                      tail_i, obs_i, body_vert, vertical,
                                      {}, {})
        diags = core.ObsDiagnostics(*(d[:nobs] for d in tail.diags))
        return (bm, bp, tail.tail_mean[:nobs], tail.tail_perts[:nobs],
                diags)
