"""Typed configuration for the filter.

Copy of ``efa_xray_tpu/config.py`` (``FilterConfig`` :17-504) without the
knobs that exist only for the TPU and its remote link: the host fast path
(``small_host``, ``small_host_threshold``), the Pallas selections
(``use_pallas``, ``tail_pallas``: here the device decides, see
``EnSRF._use_kernels``) and the TPU row tile (``pallas_tile``);
:meth:`FilterConfig.load` still reads a file that names them (see
:data:`TPU_ROUTE_FIELDS`).  ``matmul_precision`` and ``mxu_bf16`` choose
the body kernels' product modes (:mod:`efa_xray_tpu_torch.ops.precision`).
The LETKF knobs (``letkf_*``, :183-227) and ``taps_topk`` (:55) are here:
``letkf_solve_precision`` and ``taps_topk="approx"`` are accepted and run
true fp32 and the exact search (what the JAX package runs off the TPU).
The adaptive-inflation knobs (``adaptive_*``, :262-291) are here.
``obs_chunk`` has no automatic threshold: None runs the batch in one
shot.

The reference configures everything through loose kwargs and a polymorphic
``inflation`` argument (``efa_xray/assimilation/ensrf.py:28``,
``efa_xray/assimilation/assimilation.py:15-25``); per-ob knobs ride on the
Observation objects.  Here the run-level knobs live in one dataclass, while
per-ob overrides (``localize_radius``, ``assimilate_this``) remain arrays on
the :class:`~efa_xray_tpu_torch.observation.observation.ObservationBatch`.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Union

# Fields of the JAX package's FilterConfig (efa_xray_tpu/config.py:42-142)
# that choose a route or a tile on the TPU, not the function computed:
# ``load`` reads them from a file and drops them with a warning.
TPU_ROUTE_FIELDS = ("use_pallas", "tail_pallas", "small_host",
                    "small_host_threshold", "pallas_tile")


@dataclasses.dataclass
class FilterConfig:
    # Covariance localization: "GC" (Gaspari-Cohn) or None/False for off
    # (reference ``loc`` kwarg, ensrf.py:28,99).
    localization: Optional[str] = "GC"
    # Default GC halfwidth (km) for obs without a per-ob radius; None means
    # such obs are not localized (weights = 1).
    default_radius: Optional[float] = None
    # Execution strategy: "blocked" (exact two-phase form: tail, then the
    # body in blocks; default, and the path of the CUDA kernels) or
    # "serial" (one observation at a time, the literal reference loop).
    method: str = "blocked"
    # Observations applied to the state body per phase-2 block.
    block_size: int = 128
    # Panel size for the hierarchical phase-1 tail solve
    # (ensrf_core.tail_scan_blocked): beyond ~10k obs the plain per-ob tail
    # scan dominates the update; panels keep the sequential part on tiny
    # [panel, M] slices.  Identical results up to fp reassociation.
    tail_panel: int = 512
    # Forward-operator knobs (reference: efa_xray/state/ensemble.py:170-239).
    npt: int = 4
    exact_match_km: float = 1.0
    nearest_metric: str = "haversine"  # or "reference_proxy"
    # Nearest-point candidate selection of the device search in
    # build_taps: "exact" or "approx".  The JAX package lowers "approx" to
    # jax.lax.approx_max_k at recall 0.99 on a TPU; off the TPU that is
    # the exact top-k, and here both run the exact chunked torch.topk
    # (recall 1.0).
    taps_topk: str = "exact"
    # Nearest-point search strategy: "auto" (default) detects separable
    # lat x lon product grids and resolves the search as exact host-side
    # index arithmetic with a per-ob exactness certificate — no device
    # dispatch at all (observation/forward.py:_nearest_separable);
    # "device" forces the full search (torch.topk on the device) even on
    # separable grids.  Selected points (and hence ye) are identical
    # either way, with one measure-zero caveat: among grid points at
    # EXACTLY equal distance from an ob, the host paths break ties by
    # lowest flat grid index (so "auto", its full-search fallback, and
    # the single-stage device top_k all agree), while the two-stage
    # chordal device search resolves such ties by its own fp rounding —
    # an ob exactly midway between grid points may select a different
    # (equally correct, equidistant) point there.
    taps_search: str = "auto"
    time_weighting: str = "linear"  # or "reference" (reproduces swapped weights)
    # Working dtype of the update ("float32" on the card, where the kernels
    # run; "float64" for parity studies on the CPU).
    dtype: str = "float32"
    # Process the observation batch in sequential chunks of this many obs
    # (EnSRF, single device; efa_xray_tpu/assimilation/ensrf.py:522): the
    # tail is solved once over the whole batch, then the body is swept
    # chunk by chunk through the kernel of the update's route.  Exact up to
    # fp reassociation.  None or 0 runs the batch in one shot (the JAX
    # package's automatic 131072-ob threshold on a TPU is not carried
    # over).  Raises ValueError with hybrid covariance or
    # variable_localization.
    obs_chunk: Optional[int] = None
    # Assimilation-order policy for the observation batch.  None =
    # caller's order (reference parity: the localized serial analysis is
    # weakly order-dependent, so the framework never silently reorders).
    # "hilbert" = assimilate in spherical-Hilbert spatial-locality order
    # and return diagnostics/writeback in the CALLER's order: spatially
    # compact obs panels are what lets the fused kernels' localization
    # culling engage.  Equivalent to the caller pre-sorting with
    # ``ObservationBatch.spatial_sort()`` (the reference demo shuffles
    # its obs order, ``efa_demo.ipynb`` cell 11 — order is a free
    # choice).
    obs_order: Optional[str] = None
    # bf16 inputs (f32 accumulation) on the two large products of the
    # B2, B2h and B3 body kernels (D0 and the rank-B apply), on every
    # device: the JAX package's explicit casts on its fused kernels.  B4
    # and the tail do not take it (ops/precision.product_mode).
    mxu_bf16: bool = False
    # What the body kernels' two large products mean on CUDA (the JAX
    # package's jax.default_matmul_precision hint): None, "highest",
    # "float32": fp32 FMA; "high", "tensorfloat32": TF32 tensor cores;
    # "default", "bfloat16": bf16 tensor cores; f32 accumulation.  The
    # CPU runs fp32 whatever it says, as JAX's CPU does; every other
    # product (tail, corrections, the EnKF and LETKF, torch products)
    # stays fp32, and a float64 update ignores it
    # (ops/precision.product_mode).
    matmul_precision: Optional[str] = None
    # Fast chordal geometry for localization weights (unit-vector dot +
    # polynomial arccos; ~2e-8 rad error) instead of the exact haversine.
    # Off by default to keep bit-level reference parity.
    fast_geometry: bool = False
    # Localization culling in the B2 body kernel: skip (row-tile,
    # obs-block) pairs — and individual 8-ob panels — whose Gaspari-Cohn
    # weights are provably all zero.  EXACT (the skipped work is
    # multiplication by zero); on by default.
    cull: bool = True
    # Permute state rows into spherical Morton order around the fused
    # kernel (exact — the update is row-local; the inverse permutation is
    # applied on the way out) so row tiles cover compact caps and culling
    # bites.  Pays off when the observation ORDER is also spatially
    # coherent; obs order is part of the serial algorithm's definition, so
    # sorting obs is left to the caller (see
    # observation.localization.spatial_sort_order and
    # observation.thinning.sort_spatially).  The permutation is cached on
    # the state structure per device (StateStructure.spatial_order_device).
    spatial_sort: bool = False
    # False reproduces the reference's np.var (ddof=0) in the gain
    # denominator against a ddof=1 covariance (ensrf.py:69,95) — weakly
    # observation-order dependent.  True uses ddof=1 throughout (textbook
    # Whitaker-Hamill; analysis mean exactly order-invariant when
    # unlocalized).
    unbiased_variance: bool = False
    # --- LETKF solver knobs (efa_xray_tpu_torch.assimilation.letkf) ---
    # Grid points per local patch sharing one ensemble-space solve (weights
    # at the patch centroid).  1 = textbook per-point LETKF (exact).
    letkf_patch_size: int = 1
    # Max observations entering each local solve (nearest-k truncation;
    # only binds when a localization footprint holds more than k obs).
    letkf_k_obs: int = 64
    # Batched SPD inverse-sqrt backend: "newton_schulz" (coupled
    # Newton-Schulz, pure matrix products, exits when the whole chunk has
    # converged) or "eigh" (torch.linalg.eigh, the exact reference).
    letkf_sqrt: str = "newton_schulz"
    # Newton-Schulz iteration cap (quadratically convergent once the
    # linear phase ~log2(cond) is past; 30 covers cond ~ 1e4 in f32).
    letkf_ns_iters: int = 30
    # Patches solved per step of the chunk loop (bounds the [chunk, k, M]
    # gather and the [chunk, M, M] transforms).
    letkf_chunk: int = 512
    # Nearest-k obs selection: "exact" (top-k over all obs), "approx"
    # (the JAX package's approx_max_k on a TPU; here the exact top-k), or
    # "host" (EXACT: a host kd-tree emits certified candidate sets per
    # group of patches -- ball(centroid, r_k + 2 * group_radius) covers
    # every member patch's true top-k -- and the device ranks only those;
    # cached per (structure, obs network, device).  Horizontal-only
    # localization).
    letkf_topk: str = "exact"
    # Matmul precision of the LETKF's ensemble-space solve chain in the
    # JAX package ("default", "high", "highest").  Every setting runs
    # true fp32 here (no TF32), as the JAX package does off the TPU: the
    # LETKF has no body kernel, and only those take a lower mode.
    letkf_solve_precision: str = "default"
    # --- Hybrid ensemble-static background covariance (Hamill & Snyder
    # 2000).  hybrid_alpha = 1 is the pure ensemble filter (reference
    # parity); 0 is classic Optimal Interpolation with a Gaspari-Cohn
    # covariance model.  The static part is
    # sigma_s(x) sigma_s(y) GC(d, static_b_length), held fixed over the
    # batch (standard hybrid-gain simplification).  With fast_geometry, or
    # without localization, the blocked body runs kernel B2h (the static
    # column inside B2); with exact haversine the plain blocked update.
    hybrid_alpha: float = 1.0
    # Static background std: scalar, or per-state-row array of nstate.
    static_b_sigma: Union[float, object, None] = None
    # GC halfwidth (km) of the static covariance model.
    static_b_length: Optional[float] = None
    # Relaxation-to-prior-spread posterior inflation (Whitaker & Hamill
    # 2012): after the analysis, each row's posterior spread relaxes toward
    # the background spread by this fraction.  0 = off (reference parity);
    # 1 = restore prior spread exactly.
    rtps_alpha: float = 0.0
    # Relaxation-to-prior-perturbations posterior inflation (Zhang, Snyder
    # & Sun 2004): posterior perturbations blend member-wise with the prior
    # ones, X_a' = (1-a) X_a + a X_b.  0 = off (reference parity); 1 =
    # restore prior perturbations exactly.  Mutually exclusive with
    # rtps_alpha (operationally one relaxation scheme is chosen, and
    # composing them has no established semantics).  Note: RTPP keeps a
    # copy of the prior perturbation matrix alive through the update, so
    # on the buffer-donating paths peak HBM gains one [Nstate, Nmems]
    # buffer.
    rtpp_alpha: float = 0.0
    # When ``inflation`` is an AdaptiveInflation instance, update its mean
    # field from this batch's innovations after the analysis (Anderson
    # 2009), on the filter's device, so the next cycle's prior inflation
    # has learned from the data.
    adaptive_inflation_update: bool = True
    # Evolve the inflation std alongside the mean (Anderson 2009 section 4
    # posterior-density refit, floored at ``adaptive_sd_min``).  Off =
    # the std held fixed.
    adaptive_sd_evolve: bool = False
    adaptive_sd_min: float = 0.05
    # Per-update relaxation of the learned inflation mean toward 1 (DART's
    # inflation damping): lambda <- 1 + damp (lambda - 1).  1.0 = off.
    # Residual ob bias or model error makes innovations exceed their
    # expected variance systematically, and an undamped field ratchets
    # upward there.
    adaptive_damp: float = 1.0
    # Bounds on the learned inflation mean (DART's inf_lower_bound /
    # inf_upper_bound): points that no ob tests closely integrate the
    # network's excess innovations multiplicatively, which damping alone
    # does not contain.
    adaptive_min: float = 1.0
    adaptive_max: float = 1e6
    # Innovation-based gross-error QC ("background check" / first-guess
    # check; DART's ``outlier_threshold``, GSI's gross check — standard
    # operational-DA QC the reference never had: its only gate is the
    # user-set ``assimilate_this``, efa_xray/assimilation/ensrf.py:74-76).
    # When set to ``t``, an observation is rejected — not assimilated,
    # prior stats still recorded, flagged in
    # ``ObservationBatch.qc_outlier`` — when its squared innovation
    # exceeds ``t**2`` times the expected innovation variance under the
    # prior: ``(y - mean(ye))^2 > t^2 * (var(ye) + R)``.  The test uses
    # the FORECAST prior ye statistics (before any ob of the batch is
    # assimilated), matching DART's definition, so the mask is identical
    # across serial/blocked/Pallas/mesh paths and all three solvers.
    # Typical operational values: 3-4.  None = off (reference parity).
    outlier_threshold: Optional[float] = None
    # What to do with a flagged outlier: "reject" (DART semantics — the ob
    # is skipped entirely) or "inflate" (adaptive observation error
    # inflation, Minamide & Zhang 2017 MWR: R is raised to exactly
    # ``innov^2 / t^2 - var(ye)`` so the innovation sits at t sigma and
    # the ob is still assimilated with proportionally weakened impact —
    # the all-sky-radiance treatment where rejecting every cloud-affected
    # ob would discard the most informative data).  Flagged obs are
    # recorded in ``qc_outlier`` either way; the batch keeps the ORIGINAL
    # measurement R (the inflation is an assimilation-time treatment, not
    # a revised error estimate).
    outlier_action: str = "reject"
    # --- Cross-variable localization (DART-style "variable localization";
    # an extension — the reference localizes spatially only,
    # efa_xray/assimilation/ensrf.py:99-115).  Dict mapping
    # (observed_var, state_var) pairs — tuple keys or "OBSVAR:STATEVAR"
    # strings — to multiplicative gain factors >= 0 (unlisted pairs
    # default to 1.0).  0 blocks the update entirely: e.g.
    # {"T2m:PS": 0.0} stops temperature obs from ever touching surface
    # pressure through spurious sample covariances.  The factor enters
    # the gain exactly like a Gaspari-Cohn weight (per (row, ob)), works
    # with or without spatial localization, and composes with vertical
    # localization.  Not combinable with hybrid covariance (the static
    # column would be untapered).  On gridded states with fast_geometry
    # it rides kernel B3's per-(group, ob) table; elsewhere the plain
    # blocked update carries it, as in the JAX package.
    variable_localization: Optional[dict] = None
    verbose: bool = False

    @property
    def localize(self) -> bool:
        return self.localization not in (None, False)

    # -- persistence (reproducible-run config files; the reference has no
    # config system at all — loose kwargs, SURVEY.md §5.6) ----------------
    def to_dict(self, full: bool = False) -> dict:
        """JSON-ready dict.  ``full=False`` (default) keeps only fields
        that differ from the dataclass defaults, so saved configs stay
        readable and forward-compatible (new knobs keep their defaults on
        load).  Non-JSON values are converted: array ``static_b_sigma``
        becomes a list, tuple ``variable_localization`` keys become
        ``"OBSVAR:STATEVAR"`` strings."""
        out = {}
        for f in dataclasses.fields(self):
            val = getattr(self, f.name)
            if not full:
                try:
                    is_default = val is f.default or (
                        type(val) is type(f.default) and val == f.default
                    )
                except Exception:
                    is_default = False
                if is_default:
                    continue
            if f.name == "static_b_sigma" and val is not None and not isinstance(
                val, (int, float)
            ):
                import numpy as _np

                val = _np.asarray(val, dtype=float).tolist()
            if f.name == "variable_localization" and isinstance(val, dict):
                val = {
                    (k if isinstance(k, str) else f"{k[0]}:{k[1]}"): float(v)
                    for k, v in val.items()
                }
            out[f.name] = val
        return out

    def save(self, path: str) -> None:
        """Write the config as JSON (only non-default fields)."""
        import json

        with open(path, "w") as fh:
            json.dump(self.to_dict(), fh, indent=2, sort_keys=True)
            fh.write("\n")

    @classmethod
    def load(cls, path: str, **overrides) -> "FilterConfig":
        """Read a JSON config written by :meth:`save`, by the JAX
        package's ``FilterConfig.save`` or by hand.  Unknown keys raise
        (typo safety); :data:`TPU_ROUTE_FIELDS` are dropped with one
        warning naming them; ``overrides`` are applied on top.
        Validation runs through the normal constructor."""
        import json

        with open(path) as fh:
            data = json.load(fh)
        if not isinstance(data, dict):
            raise ValueError(f"{path}: expected a JSON object")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - known - set(TPU_ROUTE_FIELDS))
        if unknown:
            raise ValueError(
                f"{path}: unknown FilterConfig field(s): {', '.join(unknown)}"
            )
        dropped = sorted(set(data) - known)
        if dropped:
            warnings.warn(
                f"{path}: dropped FilterConfig field(s) {', '.join(dropped)}"
                ": they choose a route or a tile on the TPU, not the "
                "function computed", stacklevel=2)
        data = {k: v for k, v in data.items() if k in known}
        data.update(overrides)
        return cls(**data)

    def __post_init__(self):
        if self.localization not in (None, False, "GC"):
            raise ValueError(f"Unknown localization {self.localization!r}")
        if self.method not in ("blocked", "serial"):
            raise ValueError(f"Unknown method {self.method!r}")
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        if self.letkf_sqrt not in ("newton_schulz", "eigh"):
            raise ValueError(f"Unknown letkf_sqrt {self.letkf_sqrt!r}")
        if self.letkf_topk not in ("exact", "approx", "host"):
            raise ValueError(f"Unknown letkf_topk {self.letkf_topk!r}")
        if self.obs_order not in (None, "hilbert"):
            raise ValueError(f"Unknown obs_order {self.obs_order!r}")
        if self.letkf_solve_precision not in ("default", "high", "highest"):
            raise ValueError(
                f"Unknown letkf_solve_precision "
                f"{self.letkf_solve_precision!r}"
            )
        if self.variable_localization is not None:
            if not isinstance(self.variable_localization, dict):
                raise ValueError("variable_localization must be a dict of "
                                 "(obs_var, state_var) -> factor")
            for key, val in self.variable_localization.items():
                if isinstance(key, str):
                    if key.count(":") != 1:
                        raise ValueError(
                            f"variable_localization string keys must be "
                            f"'OBSVAR:STATEVAR', got {key!r}")
                elif not (isinstance(key, tuple) and len(key) == 2):
                    raise ValueError(
                        f"variable_localization keys must be 2-tuples or "
                        f"'A:B' strings, got {key!r}")
                if not (isinstance(val, (int, float)) and val >= 0):
                    raise ValueError(
                        f"variable_localization factors must be numbers "
                        f">= 0, got {key!r}: {val!r}")
            if self.hybrid_alpha < 1.0:
                raise ValueError(
                    "variable_localization does not combine with hybrid "
                    "covariance (the static column would be untapered)")
        if self.taps_topk not in ("exact", "approx"):
            raise ValueError(f"Unknown taps_topk {self.taps_topk!r}")
        if self.taps_search not in ("auto", "device"):
            raise ValueError(f"Unknown taps_search {self.taps_search!r}")
        if self.matmul_precision not in (
            None, "default", "high", "highest", "bfloat16",
            "tensorfloat32", "float32",
        ):
            raise ValueError(
                f"Unknown matmul_precision {self.matmul_precision!r}"
            )
        if self.letkf_patch_size < 1 or self.letkf_k_obs < 1:
            raise ValueError("letkf_patch_size and letkf_k_obs must be >= 1")
        if self.outlier_threshold is not None and not (
            isinstance(self.outlier_threshold, (int, float))
            and self.outlier_threshold > 0
        ):
            raise ValueError("outlier_threshold must be a number > 0 or None")
        if self.outlier_action not in ("reject", "inflate"):
            raise ValueError(
                f"Unknown outlier_action {self.outlier_action!r} "
                "(expected 'reject' or 'inflate')"
            )
        if not 0.0 <= self.rtps_alpha <= 1.0:
            raise ValueError("rtps_alpha must be in [0, 1]")
        if not 0.0 <= self.rtpp_alpha <= 1.0:
            raise ValueError("rtpp_alpha must be in [0, 1]")
        if self.rtps_alpha > 0.0 and self.rtpp_alpha > 0.0:
            raise ValueError(
                "rtps_alpha and rtpp_alpha are mutually exclusive — pick "
                "one relaxation scheme"
            )
        if not 0.0 <= self.hybrid_alpha <= 1.0:
            raise ValueError("hybrid_alpha must be in [0, 1]")
        if self.hybrid_alpha < 1.0:
            if self.static_b_sigma is None or self.static_b_length is None:
                raise ValueError(
                    "hybrid_alpha < 1 needs static_b_sigma and "
                    "static_b_length"
                )
